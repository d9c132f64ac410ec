"""Algorithm 1 — Random Maclaurin (RM) feature maps for dot product kernels
(port of ``repro.core.feature_map``).

Paper construction (Kar & Karnick, AISTATS 2012): for each output feature i,
sample a degree ``N ~ P[N=n] = p^-(n+1)`` and ``N`` Rademacher vectors
``w_1..w_N in {-1,+1}^d``, and emit

    Z_i(x) = sqrt(a_N * p^(N+1)) * prod_j <w_j, x>.

``Z = (Z_1..Z_D)/sqrt(D)`` is an unbiased, uniformly-convergent estimator of
``K(x,y) = f(<x,y>)`` (paper Lemmas 6-8, Theorem 12). Degrees are drawn once
at construction and the map is lowered to a ``core.plan.FeaturePlan``; the
map object carries ``(plan, omegas)`` and featurizes through
``core.plan.apply_plan``: ONE launch of kernel B1 for a CUDA tensor, B1's
plain version for a CPU tensor. The per-degree views ``bucket_omegas`` feed
the per-bucket path (``kernels.rm_feature.ops.apply_feature_map_bucketed``,
one launch of kernel B9 a degree).

The other registry families (``"tensor_sketch"``, ``"ctr"``,
``"structured"``) share the carrier :class:`EstimatorFeatureMap` of
``(plan, params)``; their thin subclasses live beside their plans
(``sketch/``, ``ctr/``, ``structured/feature_map.py``) and featurize through
their registry entry's ``apply`` (kernels B6, B7, B8 on the card).

Draws come from a ``torch.Generator``, never from ``jax.random``, so a map
made here from a seed is not the reference's map from that seed; the
tests hand the reference's plans and draws across instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.maclaurin import DotProductKernel, degree_measure
from repro_torch.core.plan import FeaturePlan, init_omegas, make_feature_plan

__all__ = [
    "RMFeatureMap",
    "EstimatorFeatureMap",
    "make_feature_map",
    "make_estimator_map",
    "degree_measure",
]


class _MapSurface:
    """The surface every map object shares: metadata, ``apply`` through
    the family's registry entry, ``__call__`` (the same path) and
    ``estimate_gram``. Subclasses give ``plan``, ``params`` and the
    registry name ``estimator``."""

    estimator: ClassVar[str]
    plan: Any

    @property
    def input_dim(self) -> int:
        return self.plan.input_dim

    @property
    def num_random(self) -> int:
        return self.plan.num_random

    @property
    def output_dim(self) -> int:
        return self.plan.output_dim

    def truncation_bias(self, radius: float) -> float:
        """Worst-case dropped-degree mass ``sum a_n R^{2n}`` (paper §4.2)
        over the degrees the plan allocates no feature, the tail window
        beyond n_max included."""
        return self.plan.truncation_bias(radius)

    def apply(self, x: torch.Tensor, *, precision=None) -> torch.Tensor:
        """Featurize ``x [..., d] -> [..., output_dim]`` (fp32) through the
        family's registry ``apply``: its CUDA kernel for a CUDA tensor,
        the kernel's plain version for a CPU tensor. ``precision`` ("fp32"
        | "bf16") is the dtype x and the packed weights enter the kernel
        in; accumulation is fp32 either way."""
        from repro_torch.core import registry

        return registry.get(self.estimator).apply(self.plan, self.params, x,
                                                  precision=precision)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def estimate_gram(self, X: torch.Tensor, Y: Optional[torch.Tensor] = None,
                      *, row_chunk: int = 4096, precision=None
                      ) -> torch.Tensor:
        """Kernel-matrix estimate ``Z(X) Z(Y)^T``, featurizing
        ``row_chunk`` rows at a time; the product itself stays fp32."""
        from repro_torch.core import registry

        return registry.estimate_gram(
            lambda Z: self.apply(Z, precision=precision), X, Y,
            row_chunk=row_chunk)


@dataclasses.dataclass
class RMFeatureMap(_MapSurface):
    """A materialized Random Maclaurin feature map: the ``FeaturePlan``
    (degrees, counts, scales, const, H0/1 block) and the flat
    ``[plan.total_rows, d]`` Rademacher draws that instantiate it. The
    per-bucket views (``degrees``/``counts``/``scales``/``const``) are
    properties, as in the reference."""

    plan: FeaturePlan
    omegas: torch.Tensor
    estimator: ClassVar[str] = "rm"

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {"omegas": self.omegas}

    @property
    def degrees(self) -> Tuple[int, ...]:
        return self.plan.degrees

    @property
    def counts(self) -> Tuple[int, ...]:
        return self.plan.counts

    @property
    def scales(self) -> Tuple[float, ...]:
        return self.plan.scales

    @property
    def const(self) -> Optional[float]:
        return self.plan.const if self.plan.const != 0.0 else None

    @property
    def h01(self) -> bool:
        return self.plan.h01

    @property
    def h01_coefs(self) -> Optional[Tuple[float, float]]:
        if not self.plan.h01:
            return None
        return (self.plan.h01_a0, self.plan.h01_a1)

    @property
    def coefs_host(self) -> Tuple[float, ...]:
        return self.plan.coefs_host

    def bucket_omegas(self) -> List[torch.Tensor]:
        """Per-degree views into the flat draws: one ``[c_n * n, d]`` block
        each, feature-major (row ``i * n + j`` is slot j of feature i)."""
        out, off = [], 0
        for n, c in zip(self.plan.degrees, self.plan.counts):
            out.append(self.omegas[off: off + c * n])
            off += c * n
        return out


@dataclasses.dataclass
class EstimatorFeatureMap(_MapSurface):
    """``(plan, params)`` of one map of a registry family other than rm;
    a subclass names the family in ``estimator``."""

    plan: Any
    params: Dict[str, torch.Tensor]


def make_estimator_map(map_cls, kernel: DotProductKernel, input_dim: int,
                       num_features: int, key: torch.Generator, *,
                       p: float = 2.0, measure: str = "geometric",
                       h01: bool = False, n_max: int = 24,
                       radius: float = 1.0, omega_dtype=torch.float32,
                       stratified: bool = True, seed: int = 0,
                       device="cuda") -> EstimatorFeatureMap:
    """Build a ``map_cls`` (an :class:`EstimatorFeatureMap` subclass):
    its family's plan, then its params drawn from ``key`` and placed on
    ``device`` (the card unless the caller asks for the CPU). ``seed`` is
    the plan's degree-allocation seed (used when ``stratified=False``)."""
    from repro_torch.core import registry

    if not isinstance(key, torch.Generator):
        raise TypeError(f"key must be a torch.Generator, got {type(key)}")
    dev = resolve_device(device)
    entry = registry.get(map_cls.estimator)
    plan = entry.make_plan(kernel, input_dim, num_features, p=p,
                           measure=measure, h01=h01, n_max=n_max,
                           radius=radius, stratified=stratified, seed=seed)
    params = entry.init_params(plan, key, omega_dtype)
    return map_cls(plan=plan, params={k: v.to(dev) for k, v in params.items()})


def make_feature_map(
    kernel: DotProductKernel,
    input_dim: int,
    num_features: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    *,
    eps: Optional[float] = None,
    delta: Optional[float] = None,
    p: float = 2.0,
    measure: str = "geometric",
    h01: bool = False,
    n_max: int = 24,
    radius: float = 1.0,
    omega_dtype=None,
    stratified: bool = True,
    estimator: str = "rm",
    mesh=None,
    num_shards: Optional[int] = None,
    precision=None,
    seed: Optional[int] = None,
    device="cuda",
):
    """Build a feature map (Algorithm 1 / §6.1 H0/1 / beyond-paper measures).

    ``key`` is a ``torch.Generator`` (the reference takes a ``jax.random``
    key there); ``seed=`` instead makes one on ``device``. One of them is
    required. The draws land on ``device``, the card unless the caller
    asks for the CPU.

    ``estimator`` selects the family from the registry: ``"rm"`` (default)
    returns an :class:`RMFeatureMap`; any other name delegates to that
    entry's ``make_map`` (``SketchFeatureMap``, ``CtrFeatureMap``,
    ``StructuredFeatureMap``) with the same arguments.

    * ``stratified=False`` — the paper's Algorithm 1: iid degree draws from
      q (the plan's seed drawn from ``key``), per-feature scale
      ``sqrt(a_n / q_n) / sqrt(D)``. Exactly unbiased for the full kernel.
    * ``stratified=True`` (default) — counts ``c_n = round(D q_n)`` with
      per-degree weights ``sqrt(a_n / c_n)``: no degree-sampling variance;
      the dropped-degree mass is ``RMFeatureMap.truncation_bias``.

    ``precision`` ("fp32" | "bf16") sets the storage dtype of the draws to
    the policy's compute dtype (lossless: they are {0, +-1}); an explicit
    ``omega_dtype`` wins. Accuracy-target mode: pass ``eps=``/``delta=``
    instead of ``num_features`` and the budget is Theorem 12's
    ``required_num_features`` (``core.bounds``).

    Raises:
        TypeError: neither ``key`` nor ``seed`` (or both) given.
        ValueError: the budget is given both ways, or neither.
        NotImplementedError: ``mesh`` / ``num_shards`` (the sharded
            construction is ROADMAP queue A12).
        RuntimeError: ``device`` is CUDA and there is none.
    """
    if (key is None) == (seed is None):
        raise TypeError("make_feature_map requires key= (a torch.Generator) "
                        "or seed=, not both")
    if (eps is None) != (delta is None):
        raise ValueError("pass BOTH eps and delta (or neither); got "
                         f"eps={eps!r}, delta={delta!r}")
    if eps is not None:
        if num_features is not None:
            raise ValueError(
                "pass either num_features or (eps, delta), not both")
        from repro_torch.core.bounds import required_num_features

        bound_measure = ("proportional" if measure == "proportional"
                         else "geometric")
        num_features = required_num_features(
            kernel, radius, input_dim, eps, delta, p=p,
            measure=bound_measure)
    elif num_features is None:
        raise ValueError("pass num_features or accuracy targets "
                         "(eps=..., delta=...)")
    if mesh is not None or num_shards is not None:
        raise NotImplementedError(
            "sharded feature maps (mesh= / num_shards=) are not ported yet "
            "(ROADMAP queue A12)")
    if omega_dtype is None:
        from repro_torch.common.dtypes import resolve_precision

        omega_dtype = (resolve_precision(precision).compute_dtype
                       if precision is not None else torch.float32)
    dev = resolve_device(device)
    if key is None:
        key = torch.Generator(device=dev).manual_seed(seed)
    if estimator != "rm":
        from repro_torch.core import registry

        return registry.get(estimator).make_map(
            kernel, input_dim, num_features, key,
            p=p, measure=measure, h01=h01, n_max=n_max, radius=radius,
            omega_dtype=omega_dtype, stratified=stratified, device=dev,
        )
    plan_seed = 0
    if not stratified:
        plan_seed = int(torch.randint(0, 2**31 - 1, (), generator=key,
                                      device=key.device))
    plan = make_feature_plan(
        kernel,
        input_dim,
        num_features,
        p=p,
        measure=measure,
        h01=h01,
        n_max=n_max,
        radius=radius,
        stratified=stratified,
        seed=plan_seed,
    )
    return RMFeatureMap(plan=plan,
                        omegas=init_omegas(plan, key, omega_dtype).to(dev))
