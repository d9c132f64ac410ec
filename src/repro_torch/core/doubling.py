"""Progressive feature doubling — grow D online without redrawing (port of
``repro.core.doubling``).

The adaptive-accuracy loop needs the feature budget to be a dial: when the
drift monitor reports an (eps, delta) violation, the serving or training
loop buys more accuracy without invalidating the features it already
computed. A :class:`GrowableFeatureMap` holds:

    * one per-generation plan of ``base_features`` columns (the same
      hashable plan for every generation);
    * generation g's params, drawn by the family's ``init_params`` from
      :func:`generation_generator` ``(seed, g, device)``;
    * ``Z(x) = concat_g Z_g(x) / sqrt(G)``: each generation is an unbiased
      estimator of the kernel, so the concatenation at ``1/sqrt(G)`` is the
      unbiased G-fold average. The raw (unscaled) prefix is bitwise equal
      across growth; the scaled output differs from the old one only by
      the global ``sqrt(G_old / G_new)`` factor.

The keying rule. The reference draws generation g from ``fold_in(key,
g)``. PyTorch has no ``fold_in``, so generation g draws from a
``torch.Generator`` on the map's device seeded with ``mix_seed(seed, g)``
(``common.seeds``: a fixed 63-bit mix of the two integers). Generation
g's params therefore depend only on (seed, g) and the device, never on
when g was drawn: growing from G to 2G generations appends draws and
leaves generations [0, G) untouched (the same tensors), and 1 -> 4 equals
1 -> 2 -> 4 bit for bit. A CPU generator and a CUDA generator give
different streams from one seed; a map made on one device and moved to the
other keeps its draws. The rule is the one sharded maps will reuse with the
shard index in place of g: growth and sharding are one contract.

Application runs one registry ``apply`` a generation, as in the
reference: for ``"rm"`` on a CUDA tensor one launch of kernel B1 a
generation (B6, B7 or B8 for ``"tensor_sketch"``, ``"ctr"``,
``"structured"``), each generation's features copied into its columns of
one output allocated once. ``estimate_gram`` sums the per-generation Grams
at ``1/G``.

``eps_at`` tightens monotonically in the generation count (Theorem 12's
certified error at the current total budget), so ``obs.DriftMonitor.
recommend()`` -> :meth:`GrowableFeatureMap.grow` -> ``DriftMonitor.rebind``
is a control loop: every doubling multiplies the certified eps by about
``1/sqrt(2)``.

A reference map's params cannot be redrawn here (a JAX key is not a
torch seed): ``repro_torch.convert.growable_from_jax`` hands them across
generation by generation instead, and ``to_json`` / ``from_json`` round
trip the port's own maps.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.common.seeds import mix_seed
from repro_torch.core import registry
from repro_torch.core.bounds import HoeffdingConstants, constants_for
from repro_torch.core.maclaurin import DotProductKernel

__all__ = ["GrowableFeatureMap", "make_growable_feature_map",
           "generation_generator"]

Params = Dict[str, torch.Tensor]


def generation_generator(seed: int, generation: int,
                         device) -> torch.Generator:
    """The generator generation ``generation`` of a map seeded ``seed``
    draws from, on ``device`` (the module docstring's keying rule)."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(mix_seed(seed, generation))
    return gen


def _draw(est, plan, seed: int, start: int, stop: int, dtype,
          device) -> List[Params]:
    """Params of generations [start, stop), each from its own generator."""
    return [est.init_params(plan, generation_generator(seed, g, device),
                            dtype)
            for g in range(start, stop)]


@dataclasses.dataclass
class GrowableFeatureMap:
    """A feature map whose budget doubles in place, prefix-preserving.

    Carries (estimator name, one per-generation plan, one params dict a
    generation, the seed every generation's generator mixes in, the
    device the draws live on, and the bound context). Duck-types the other
    map objects (``apply`` / ``__call__`` / ``output_dim`` /
    ``estimate_gram`` / ``truncation_bias``).
    """

    estimator: str
    plan: Any
    params: List[Params]               # one dict per generation
    n_generations: int
    seed: int
    kernel: Optional[DotProductKernel] = None
    radius: float = 1.0
    measure: str = "geometric"
    p: float = 2.0
    omega_dtype: Any = torch.float32
    device: Any = "cuda"

    # -- metadata ------------------------------------------------------------
    @property
    def input_dim(self) -> int:
        return self.plan.input_dim

    @property
    def generation_output_dim(self) -> int:
        return registry.get(self.estimator).output_dim(self.plan)

    @property
    def output_dim(self) -> int:
        return self.n_generations * self.generation_output_dim

    def truncation_bias(self, radius: float) -> float:
        """Generations share one plan, so the dropped-degree mass of the
        concatenation equals any single generation's."""
        return registry.get(self.estimator).truncation_bias(self.plan,
                                                            radius)

    # -- bound side ----------------------------------------------------------
    def constants(self) -> HoeffdingConstants:
        if self.kernel is None:
            raise ValueError(
                "this GrowableFeatureMap carries no kernel (e.g. it was "
                "rebuilt via from_json without one); pass kernel= to "
                "from_json to restore eps_at/required_generations")
        return constants_for(self.kernel, self.radius, self.input_dim,
                             self.p)

    def eps_at(self, delta: float,
               num_features: Optional[int] = None) -> float:
        """Theorem 12's certified uniform error at ``num_features``
        (default: the current total budget); monotone non-increasing in
        the generation count."""
        d = self.output_dim if num_features is None else num_features
        return self.constants().eps_at(d, delta, self.measure)

    def required_generations(self, eps: float, delta: float) -> int:
        """Smallest generation count whose total budget certifies eps."""
        d_req = self.constants().required_d(eps, delta, self.measure)
        per_gen = self.generation_output_dim
        return max(-(-d_req // per_gen), 1)

    # -- growth --------------------------------------------------------------
    def grow(self, factor: int = 2) -> "GrowableFeatureMap":
        """Multiply the generation count by ``factor`` without redrawing:
        the new map holds the same params for generations [0, G) and new
        draws, keyed by their index alone, for [G, factor * G)."""
        if factor < 2:
            raise ValueError(f"growth factor must be >= 2, got {factor}")
        return self.grow_to_generations(self.n_generations * factor)

    def grow_to_generations(self, n_generations: int
                            ) -> "GrowableFeatureMap":
        if n_generations < self.n_generations:
            raise ValueError(
                f"cannot shrink: have {self.n_generations} generations, "
                f"asked for {n_generations}")
        if n_generations == self.n_generations:
            return self
        new = _draw(registry.get(self.estimator), self.plan, self.seed,
                    self.n_generations, n_generations, self.omega_dtype,
                    self.device)
        return dataclasses.replace(self, params=self.params + new,
                                   n_generations=n_generations)

    def grow_to(self, num_features: int) -> "GrowableFeatureMap":
        """Grow until ``output_dim >= num_features`` (whole generations)."""
        per_gen = self.generation_output_dim
        return self.grow_to_generations(
            max(-(-num_features // per_gen), self.n_generations))

    def to(self, device) -> "GrowableFeatureMap":
        """The same draws on ``device``; later generations draw there."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, device=dev,
            params=[{k: v.to(dev) for k, v in p.items()}
                    for p in self.params])

    # -- application ---------------------------------------------------------
    def apply(self, x: torch.Tensor, *, rescale: bool = True,
              precision=None) -> torch.Tensor:
        """Featurize ``x [..., d] -> [..., output_dim]`` fp32, one registry
        apply a generation (one B1 launch each for ``"rm"`` on the card).

        Generation g's columns are ``[g * generation_output_dim, (g + 1) *
        generation_output_dim)``. ``rescale=False`` returns the raw
        concatenation (no ``1/sqrt(G)``), the quantity that is bitwise
        equal across :meth:`grow`; the scaled output is exactly ``raw *
        (1/sqrt(G))``, one multiply.
        """
        est = registry.get(self.estimator)
        per_gen = self.generation_output_dim
        out = torch.empty(x.shape[:-1] + (self.output_dim,),
                          dtype=torch.float32, device=x.device)
        for g, params in enumerate(self.params):
            out[..., g * per_gen:(g + 1) * per_gen] = est.apply(
                self.plan, params, x, precision=precision)
        if not rescale:
            return out
        return out.mul_(1.0 / math.sqrt(self.n_generations))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def estimate_gram(self, X: torch.Tensor,
                      Y: Optional[torch.Tensor] = None, *,
                      row_chunk: int = 4096,
                      precision=None) -> torch.Tensor:
        """Kernel-matrix estimate without materializing the concatenation:
        per-generation Grams summed at ``1/G``, in generation order."""
        est = registry.get(self.estimator)
        inv_g = 1.0 / self.n_generations

        def _apply_fn(params):
            return lambda Z: est.apply(self.plan, params, Z,
                                       precision=precision)

        parts = [registry.estimate_gram(_apply_fn(p), X, Y,
                                        row_chunk=row_chunk) * inv_g
                 for p in self.params]
        return sum(parts[1:], parts[0])

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        """Growth state as JSON: the per-generation plan (the plans' own
        serialization, with the port's plan type), the seed and the
        generation count. The params are not stored: they are a function
        of (plan, seed, G, device), redrawn bitwise by ``from_json`` on the
        same device."""
        ptype = type(self.plan)
        return json.dumps({
            "estimator": self.estimator,
            "plan_type": [ptype.__module__, ptype.__qualname__],
            "plan": json.loads(self.plan.to_json()),
            "n_generations": self.n_generations,
            "seed": int(self.seed),
            "radius": self.radius,
            "measure": self.measure,
            "p": self.p,
        })

    @classmethod
    def from_json(cls, s: str, kernel: Optional[DotProductKernel] = None,
                  omega_dtype=torch.float32,
                  device="cuda") -> "GrowableFeatureMap":
        """Redraw a map from :meth:`to_json` on ``device`` (the card unless
        the caller asks for the CPU).

        Raises:
            ValueError: the JSON names a plan type outside this package
                (a reference map's JSON: hand its params across with
                ``convert.growable_from_jax`` instead).
        """
        d = json.loads(s)
        mod, qual = d["plan_type"]
        if not mod.startswith("repro_torch."):
            raise ValueError(
                f"plan type {mod}.{qual} is not the port's; a reference "
                "map's draws cannot be redrawn here (use "
                "repro_torch.convert.growable_from_jax)")
        plan = getattr(importlib.import_module(mod), qual).from_json(
            json.dumps(d["plan"]))
        dev = resolve_device(device)
        est = registry.get(d["estimator"])
        return cls(
            estimator=d["estimator"], plan=plan,
            params=_draw(est, plan, d["seed"], 0, d["n_generations"],
                         omega_dtype, dev),
            n_generations=d["n_generations"], seed=d["seed"], kernel=kernel,
            radius=d["radius"], measure=d["measure"], p=d["p"],
            omega_dtype=omega_dtype, device=dev)


def make_growable_feature_map(
    kernel: DotProductKernel,
    input_dim: int,
    seed: int = 0,
    *,
    base_features: int = 64,
    n_generations: int = 1,
    eps: Optional[float] = None,
    delta: Optional[float] = None,
    estimator: str = "rm",
    p: float = 2.0,
    measure: str = "geometric",
    h01: bool = False,
    n_max: int = 24,
    radius: float = 1.0,
    omega_dtype=torch.float32,
    stratified: bool = True,
    precision=None,
    device="cuda",
) -> GrowableFeatureMap:
    """Build a growable map of any registry family, its draws on
    ``device`` (the card unless the caller asks for the CPU).

    ``seed`` takes the place of the reference's ``key``. Either start from
    an explicit ``n_generations`` of ``base_features`` each, or pass
    ``eps`` / ``delta`` and get the smallest generation count whose total
    budget Theorem 12 certifies at (eps, delta). ``precision`` ("fp32" |
    "bf16") stores the draws in that policy's compute dtype.

    Raises:
        ValueError: only one of ``eps`` and ``delta`` given.
    """
    if precision is not None:
        from repro_torch.common.dtypes import resolve_precision

        omega_dtype = resolve_precision(precision).compute_dtype
    elif omega_dtype is None:
        omega_dtype = torch.float32
    dev = resolve_device(device)
    est = registry.get(estimator)
    plan = est.make_plan(kernel, input_dim, base_features, p=p,
                         measure=measure, h01=h01, n_max=n_max,
                         radius=radius, stratified=stratified)
    fm = GrowableFeatureMap(
        estimator=estimator, plan=plan,
        params=_draw(est, plan, seed, 0, 1, omega_dtype, dev),
        n_generations=1, seed=int(seed), kernel=kernel, radius=radius,
        measure=measure, p=p, omega_dtype=omega_dtype, device=dev)
    if eps is not None or delta is not None:
        if eps is None or delta is None:
            raise ValueError("pass BOTH eps and delta (or neither)")
        n_generations = fm.required_generations(eps, delta)
    return fm.grow_to_generations(max(n_generations, 1))
