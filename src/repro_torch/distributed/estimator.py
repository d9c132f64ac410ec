"""Feature-sharded estimator execution over a device mesh (port of
``repro.distributed.estimator``).

The paper's embedding makes dot-product kernels linear: after featurizing,
``K(x, y) ~= <Z(x), Z(y)>``, and an inner product shards with no
coupling. This module splits the random-feature budget over the
``"rm_features"`` mesh axis, the same way for every registry family:

    * a budget of D features over S shards is S independent sub-maps of
      D/S features, built from ONE per-shard plan and per-shard params:
      shard s draws from a ``torch.Generator`` seeded with
      ``common.seeds.mix_seed(seed, s)`` (the reference folds s into its
      key; ``core.doubling`` keys its generations the same way), so shard
      s's draws depend only on (seed, s) and the device type, never on
      which rank holds them;
    * ``Z(x) = concat_s Z_s(x) / sqrt(S)``: each sub-map is an unbiased
      estimator of the kernel, so their concatenation at ``1/sqrt(S)`` is
      the unbiased S-fold average;
    * ``estimate_gram`` never builds the concatenation: each shard
      computes ``Z_s(X) Z_s(Y)^T``, and ONE ``all_reduce`` over the
      feature axis sums them (then ``1/S``).

One process per rank. Where the reference's ``shard_map`` sees every
shard from one controller, the port's mesh path runs the same code on
every rank of a ``DeviceMesh``: rank s draws, holds and applies shard s
only. Its params are DTensors of global shape ``[S, ...]``, the leading dim
placed ``Shard`` on the feature axis (``distributed.sharding.
estimator_param_specs`` and ``placements``), and an apply gathers the
ranks' columns in shard order with one ``all_gather``.

Bit-identity contract, as the reference's: the mesh path and the host loop
(``mesh=None``) run the same per-shard computation from the same seeds in
the same concatenation order, so their applies are bitwise equal and a
rank's draw is bitwise the host loop's shard s; the Gram's ``all_reduce``
sums the partials in another order than the host loop's serial sum, so
the two Grams agree to about 1e-5 in fp32.

Each shard's featurize is one registry ``apply``: for a CUDA tensor one
launch of kernel B1 (``"rm"``), B6, B7 or B8; the host loop launches S a
featurize, a rank one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.common.seeds import mix_seed
from repro_torch.core import registry
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    FEATURE_AXIS,
    estimator_param_specs,
    mesh_axes,
    placements,
)

__all__ = [
    "FEATURE_AXIS",
    "shard_generator",
    "shard_init_params",
    "sharded_apply",
    "sharded_estimate_gram",
    "ShardedFeatureMap",
    "make_sharded_feature_map",
]

Params = Dict[str, Any]


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """The generator shard ``shard`` of a map seeded ``seed`` draws from, on
    ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(mix_seed(seed, shard))
    return gen


def _num_shards(params: Params) -> int:
    return int(next(iter(params.values())).shape[0])


def _stacked(params: Params) -> Params:
    """Every shard's params, ``[S, ...]`` leaves (a DTensor is gathered:
    every rank of its mesh must call this)."""
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in params.items()}


def _take(params: Params, s: int) -> Params:
    return {k: v[s] for k, v in params.items()}


def _local(params: Params, mesh, axis: str) -> Params:
    """This rank's shard's params, without the shard dim."""
    s = mesh.get_local_rank(axis)
    return {k: v.to_local()[0] if hasattr(v, "to_local") else v[s]
            for k, v in params.items()}


def _check_axis(mesh, axis: str, num_shards: int) -> None:
    size = mesh_axes(mesh).get(axis)
    if size != num_shards:
        raise ValueError(f"mesh axis {axis!r} has size {size}, expected "
                         f"num_shards={num_shards}")


def _place(local: Params, mesh, axis: str, num_shards: int) -> Params:
    """``[1, ...]`` local leaves -> DTensors of global ``[S, ...]``, placed
    by ``estimator_param_specs``."""
    from torch.distributed.tensor import DTensor

    shapes = {k: torch.empty((num_shards,) + tuple(v.shape[1:]),
                             device="meta") for k, v in local.items()}
    specs = estimator_param_specs(shapes, mesh, axis)
    return {k: DTensor.from_local(v, mesh, placements(specs[k], mesh),
                                  run_check=False)
            for k, v in local.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def shard_init_params(name: str, plan: Any, seed: int, num_shards: int, *,
                      dtype=torch.float32, mesh=None,
                      axis: str = FEATURE_AXIS, device="cuda") -> Params:
    """Stacked per-shard params: leaves ``[num_shards, ...]``.

    Shard s's params are ``init_params(plan, shard_generator(seed, s))``.
    With ``mesh=None`` one process draws every shard on ``device``; with a
    mesh, each rank draws only its own shard on its own device, bitwise
    the host loop's shard s, and the result is a dict of DTensors.

    Raises:
        ValueError: the mesh's ``axis`` does not have ``num_shards`` ranks.
    """
    est = registry.get(name)
    if mesh is None:
        dev = resolve_device(device)
        chunks = [est.init_params(plan, shard_generator(seed, s, dev), dtype)
                  for s in range(num_shards)]
        return {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    from repro_torch.launch.mesh import mesh_device

    _check_axis(mesh, axis, num_shards)
    s = mesh.get_local_rank(axis)
    own = est.init_params(plan, shard_generator(seed, s, mesh_device(mesh)),
                          dtype)
    return _place({k: v[None] for k, v in own.items()}, mesh, axis,
                  num_shards)


# ---------------------------------------------------------------------------
# apply: features partitioned on the "rm_features" axis
# ---------------------------------------------------------------------------
def _reference_apply(est, plan, params: Params, x: torch.Tensor, *,
                     precision=None) -> torch.Tensor:
    """One process: loop the shards, scale, concatenate in shard order."""
    stacked = _stacked(params)
    s = _num_shards(stacked)
    scale = 1.0 / math.sqrt(s)
    return torch.cat([est.apply(plan, _take(stacked, i), x,
                                precision=precision) * scale
                      for i in range(s)], dim=-1)


def sharded_apply(name: str, plan: Any, params: Params, x: torch.Tensor,
                  mesh, *, axis: str = FEATURE_AXIS,
                  precision=None) -> torch.Tensor:
    """Featurize ``x [..., d] -> [..., S * output_dim(plan)]`` (fp32).

    ``x`` is the same on every rank; rank s computes its sub-map's columns
    and one ``all_gather`` concatenates them in shard order, the layout
    the host loop (``mesh=None``) makes in one process.
    """
    est = registry.get(name)
    if mesh is None:
        return _reference_apply(est, plan, params, x, precision=precision)
    s = _num_shards(params)
    _check_axis(mesh, axis, s)
    z = est.apply(plan, _local(params, mesh, axis), x,
                  precision=precision) * (1.0 / math.sqrt(s))
    return torch.cat(collectives.all_gather(z, mesh.get_group(axis)),
                     dim=-1)


# ---------------------------------------------------------------------------
# Gram: partial per-shard Grams, ONE all_reduce over the feature axis
# ---------------------------------------------------------------------------
def sharded_estimate_gram(name: str, plan: Any, params: Params,
                          X: torch.Tensor, Y: Optional[torch.Tensor] = None,
                          *, mesh=None, axis: str = FEATURE_AXIS,
                          row_chunk: int = 4096,
                          precision=None) -> torch.Tensor:
    """Kernel-matrix estimate ``Z(X) Z(Y)^T`` without gathering features.

    Each shard featurizes the rows through its own sub-map, row-chunked as
    the single-device path is, and contributes ``Z_s(X) Z_s(Y)^T``; one
    ``all_reduce`` over ``axis`` is the only communication, then ``1/S``.
    ``mesh=None`` sums the ``1/S``-scaled partials serially.
    """
    est = registry.get(name)

    def _apply_fn(p_shard):
        return lambda Z: est.apply(plan, p_shard, Z, precision=precision)

    s = _num_shards(params)
    inv_s = 1.0 / s
    if mesh is None:
        stacked = _stacked(params)
        parts = [registry.estimate_gram(_apply_fn(_take(stacked, i)), X, Y,
                                        row_chunk=row_chunk) * inv_s
                 for i in range(s)]
        return sum(parts[1:], parts[0])
    _check_axis(mesh, axis, s)
    return registry.estimate_gram(
        _apply_fn(_local(params, mesh, axis)), X, Y, row_chunk=row_chunk,
        group=mesh.get_group(axis)) * inv_s


# ---------------------------------------------------------------------------
# the sharded map object
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedFeatureMap:
    """A feature map whose columns live on the ``"rm_features"`` mesh axis.

    Carries (estimator name, per-shard plan, stacked params, mesh) and
    duck-types the single-device maps (``apply`` / ``__call__`` /
    ``output_dim`` / ``estimate_gram`` / ``truncation_bias``);
    ``sharded=False`` (or ``mesh=None``) runs the host loop, bitwise the
    mesh path's apply.
    """

    estimator: str
    plan: Any
    params: Params                    # [S, ...] leaves (DTensors on a mesh)
    num_shards: int
    mesh: Any = None
    axis: str = FEATURE_AXIS

    @property
    def input_dim(self) -> int:
        return self.plan.input_dim

    @property
    def shard_output_dim(self) -> int:
        return registry.get(self.estimator).output_dim(self.plan)

    @property
    def output_dim(self) -> int:
        return self.num_shards * self.shard_output_dim

    def truncation_bias(self, radius: float) -> float:
        """The shards share one plan, so the dropped-degree mass of the
        concatenation equals any one shard's."""
        return registry.get(self.estimator).truncation_bias(self.plan,
                                                            radius)

    def apply(self, x: torch.Tensor, *, sharded: Optional[bool] = None,
              precision=None) -> torch.Tensor:
        """Featurize ``x [..., d] -> [..., output_dim]`` (fp32): every
        shard's columns in shard order at ``1/sqrt(S)``. ``sharded``
        defaults to "a mesh is present"."""
        if sharded is None:
            sharded = self.mesh is not None
        return sharded_apply(self.estimator, self.plan, self.params, x,
                             self.mesh if sharded else None, axis=self.axis,
                             precision=precision)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The host loop (``sharded=False``), as the reference's."""
        return self.apply(x, sharded=False)

    def estimate_gram(self, X: torch.Tensor,
                      Y: Optional[torch.Tensor] = None, *,
                      sharded: Optional[bool] = None, row_chunk: int = 4096,
                      precision=None) -> torch.Tensor:
        """``Z(X) Z(Y)^T`` from per-shard partial Grams and, on a mesh, one
        ``all_reduce``."""
        if sharded is None:
            sharded = self.mesh is not None
        return sharded_estimate_gram(
            self.estimator, self.plan, self.params, X, Y,
            mesh=self.mesh if sharded else None, axis=self.axis,
            row_chunk=row_chunk, precision=precision)


def _draw_seed(key: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (), generator=key,
                             device=key.device))


def make_sharded_feature_map(
    kernel,
    input_dim: int,
    num_features: int,
    key: Optional[torch.Generator] = None,
    *,
    seed: Optional[int] = None,
    mesh=None,
    num_shards: Optional[int] = None,
    estimator: str = "rm",
    axis: str = FEATURE_AXIS,
    omega_dtype=torch.float32,
    device=None,
    **plan_kwargs,
) -> ShardedFeatureMap:
    """A feature map of any registry family with its budget split over
    ``num_shards`` (default: the mesh's ``axis`` size) sub-maps of D/S
    features.

    ``key`` is a ``torch.Generator``; ``seed=`` makes one on the map's
    device instead. From it, in this order: the degree-allocation seed
    (``stratified=False`` without a ``seed`` plan argument, as the
    reference splits ``key_deg`` off first), then the base seed every
    shard mixes its index into. On a mesh each rank draws only its own
    shard. The map lives on ``device`` (default ``"cuda"``), or on a mesh
    on the rank's device.

    Raises:
        TypeError: neither ``key`` nor ``seed`` (or both) given.
        ValueError: neither ``mesh`` nor ``num_shards``; D does not divide
            over the shards; ``device`` is not the mesh's device type.
    """
    if (key is None) == (seed is None):
        raise TypeError("make_sharded_feature_map requires key= (a "
                        "torch.Generator) or seed=, not both")
    if num_shards is None:
        if mesh is None:
            raise ValueError("pass mesh= and/or num_shards=")
        num_shards = mesh_axes(mesh).get(axis)
        if num_shards is None:
            raise ValueError(f"the mesh has no {axis!r} axis")
    if num_features % num_shards:
        raise ValueError(f"num_features={num_features} must divide evenly "
                         f"over {num_shards} feature shards")
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_device

        dev = mesh_device(mesh)
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device {device!r} is not the mesh's "
                             f"{mesh.device_type!r}")
    else:
        dev = resolve_device("cuda" if device is None else device)
    if key is None:
        key = torch.Generator(device=dev).manual_seed(seed)
    if (not plan_kwargs.get("stratified", True)
            and "seed" not in plan_kwargs):
        plan_kwargs["seed"] = _draw_seed(key)
    base_seed = _draw_seed(key)
    est = registry.get(estimator)
    plan = est.make_plan(kernel, input_dim, num_features // num_shards,
                         **plan_kwargs)
    params = shard_init_params(estimator, plan, base_seed, num_shards,
                               dtype=omega_dtype, mesh=mesh, axis=axis,
                               device=dev)
    return ShardedFeatureMap(estimator=estimator, plan=plan, params=params,
                             num_shards=num_shards, mesh=mesh, axis=axis)
