"""Estimator registry (port of ``repro.core.registry``): the ``"rm"``
(Random Maclaurin), ``"tensor_sketch"`` (Pham & Pagh), ``"ctr"``
(complex-to-real, Wacker et al.) and ``"structured"`` (Hadamard,
Choromanski & Sindhwani) entries — the reference's four families.

Each family is a set of functions behind one name:

    make_plan(kernel, input_dim, num_features, *, p, measure, h01, n_max,
              radius, stratified, seed)          -> plan (hashable)
    init_params(plan, generator, dtype)          -> {name: Tensor}
    apply(plan, params, x, *, precision, packed) -> features [..., F] fp32
    output_dim(plan)                             -> int
    truncation_bias(plan, radius)                -> float
    make_map(kernel, input_dim, num_features, generator, *, p, measure,
             h01, n_max, radius, omega_dtype, stratified,
             device)                             -> the family's map object
    pack(plan, params, dtype)                    -> the packed weights
                                                    ``apply`` takes as
                                                    ``packed=``
    pack_fused(plan, params)                     -> (w, col_deg, col_scale)
                                                    (tensors on w's device)

``pack`` is the port's addition: the model packs each layer's weights once
per weight set (``models.attention.rm_packed_weights``) instead of once
per call. ``fused_attention_supported`` marks families whose map is the
packed masked-running-product layout the fused attention kernel takes
(``pack_fused``); the others run attention through the two-launch path
(featurize, then kernel B5): ``tensor_sketch``, ``ctr`` and
``structured``, as in the reference. ``get`` raises on an unknown name,
naming what exists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "Estimator",
    "get",
    "list_estimators",
    "featurize_chunked",
    "estimate_gram",
]


@dataclasses.dataclass(frozen=True)
class Estimator:
    name: str
    make_plan: Callable[..., Any]
    init_params: Callable[..., Dict[str, torch.Tensor]]
    apply: Callable[..., torch.Tensor]
    make_map: Callable[..., Any]
    output_dim: Callable[[Any], int]
    pack: Callable[..., Any]
    truncation_bias: Callable[[Any, float], float]
    fused_attention_supported: bool = False
    pack_fused: Optional[Callable[..., Any]] = None


def featurize_chunked(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                      X: torch.Tensor, row_chunk: int = 4096) -> torch.Tensor:
    """Apply a feature map over row chunks of ``X [N, d]``, so the live
    intermediate never exceeds ``row_chunk`` rows."""
    n = X.shape[0]
    if n <= row_chunk:
        return apply_fn(X)
    return torch.cat([apply_fn(X[i:i + row_chunk])
                      for i in range(0, n, row_chunk)], dim=0)


def estimate_gram(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                  X: torch.Tensor, Y: Optional[torch.Tensor] = None,
                  row_chunk: int = 4096) -> torch.Tensor:
    """Kernel-matrix estimate ``Z(X) Z(Y)^T`` via chunked featurization
    (the reference's ``axis_name`` reduction comes with the sharded
    slice)."""
    zx = featurize_chunked(apply_fn, X, row_chunk=row_chunk)
    zy = zx if Y is None else featurize_chunked(apply_fn, Y,
                                                row_chunk=row_chunk)
    return zx @ zy.T


def _plan_output_dim(plan) -> int:
    return plan.output_dim


def _plan_truncation_bias(plan, radius: float) -> float:
    """Worst-case dropped-degree kernel mass ``sum a_n radius^{2n}`` over
    the degrees the plan leaves out (paper section 4.2): the plan's own
    ``truncation_bias``, as the reference's ``_plan_truncation_bias``."""
    return plan.truncation_bias(radius)


def _rm_init_params(plan, generator: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``{"omegas": [total_rows, d]}`` Rademacher draws from ``generator``
    (on its device)."""
    from repro_torch.core.plan import init_omegas

    return {"omegas": init_omegas(plan, generator, dtype)}


def _rm_apply(plan, params, x, *, precision=None,
              packed=None) -> torch.Tensor:
    from repro_torch.core.plan import apply_plan

    return apply_plan(plan, params["omegas"], x, precision=precision,
                      packed=packed)


def _rm_pack(plan, params, dtype=torch.float32) -> torch.Tensor:
    """The packed ``[max_degree, F, d]`` omegas in ``dtype`` (lossless:
    the omegas are +-1)."""
    from repro_torch.core.plan import pack_omegas

    return pack_omegas(plan, params["omegas"]).to(dtype)


def _rm_pack_fused(plan, params) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Packed ``[max_degree, F, d]`` omegas plus the per-column degree
    (int32) and scale (fp32) vectors, on the omegas' device (the reference
    returns the vectors as host numpy; here they are memoized device
    tensors, so a decode step copies nothing from the host). The omegas
    are :func:`_rm_pack`'s, so one function decides their layout."""
    from repro_torch.core.plan import plan_columns

    w = _rm_pack(plan, params, params["omegas"].dtype)
    return (w, *plan_columns(plan, w.device))


def _make_rm_entry() -> Estimator:
    from repro_torch.core.feature_map import make_feature_map
    from repro_torch.core.plan import make_feature_plan

    return Estimator(
        name="rm",
        make_plan=make_feature_plan,
        init_params=_rm_init_params,
        apply=_rm_apply,
        make_map=make_feature_map,
        output_dim=_plan_output_dim,
        truncation_bias=_plan_truncation_bias,
        pack=_rm_pack,
        fused_attention_supported=True,
        pack_fused=_rm_pack_fused,
    )


def _ts_apply(plan, params, x, *, precision=None,
              packed=None) -> torch.Tensor:
    """``x [..., d] -> [..., plan.output_dim]`` through
    ``sketch.plan.apply_sketch_plan`` (one kernel-B6 launch)."""
    from repro_torch.sketch.plan import apply_sketch_plan

    return apply_sketch_plan(plan, params, x, precision=precision,
                             packed=packed)


def _ts_pack(plan, params, dtype=torch.float32):
    """``[wr, wi, mr, mi]`` packed in fp32 from the hash tables, then
    rounded once to ``dtype``. The reference re-packs per call from the
    stored tables for exactly this reason (its ``_ts_apply`` docstring):
    cos/sin tensors stored in the bf16 compute dtype would be degraded, so
    the model keeps them out of the compute cast
    (``models.transformer.cast_params_to_compute``)."""
    from repro_torch.sketch.plan import pack_sketch

    return [t.to(dtype) for t in pack_sketch(plan, params)]


def _make_ts_entry() -> Estimator:
    from repro_torch.sketch.feature_map import make_sketch_feature_map
    from repro_torch.sketch.plan import init_sketch_params, make_sketch_plan

    return Estimator(
        name="tensor_sketch",
        make_plan=make_sketch_plan,
        init_params=init_sketch_params,
        apply=_ts_apply,
        make_map=make_sketch_feature_map,
        output_dim=_plan_output_dim,
        truncation_bias=_plan_truncation_bias,
        pack=_ts_pack,
    )


def _ctr_apply(plan, params, x, *, precision=None,
               packed=None) -> torch.Tensor:
    """``x [..., d] -> [..., plan.output_dim]`` through
    ``ctr.plan.apply_ctr_plan`` (one kernel-B7 launch)."""
    from repro_torch.ctr.plan import apply_ctr_plan

    return apply_ctr_plan(plan, params, x, precision=precision,
                          packed=packed)


def _ctr_pack(plan, params, dtype=torch.float32):
    """``[wr, wi]`` packed, in ``dtype``: lossless, the values are {0,
    +-1}, so unlike tensor_sketch's cos/sin tensors they may take the bf16
    compute cast."""
    from repro_torch.ctr.plan import pack_ctr

    return [t.to(dtype) for t in pack_ctr(plan, params)]


def _make_ctr_entry() -> Estimator:
    from repro_torch.ctr.feature_map import make_ctr_feature_map
    from repro_torch.ctr.plan import init_ctr_params, make_ctr_plan

    return Estimator(
        name="ctr",
        make_plan=make_ctr_plan,
        init_params=init_ctr_params,
        apply=_ctr_apply,
        make_map=make_ctr_feature_map,
        output_dim=_plan_output_dim,
        truncation_bias=_plan_truncation_bias,
        pack=_ctr_pack,
    )


def _structured_apply(plan, params, x, *, precision=None,
                      packed=None) -> torch.Tensor:
    """``x [..., d] -> [..., plan.output_dim]`` through
    ``structured.plan.apply_structured_plan`` (one kernel-B8 launch)."""
    from repro_torch.structured.plan import apply_structured_plan

    return apply_structured_plan(plan, params, x, precision=precision,
                                 packed=packed)


def _structured_pack(plan, params, dtype=torch.float32):
    """``[d1, d2]`` packed, in ``dtype``: lossless, the signs are +-1."""
    from repro_torch.structured.plan import pack_structured

    return [t.to(dtype) for t in pack_structured(plan, params)]


def _make_structured_entry() -> Estimator:
    """As in the reference, no ``pack_fused``: the family never
    materializes dense ``[max_degree, F, d]`` rows, so attention takes the
    two-launch path."""
    from repro_torch.structured.feature_map import (
        make_structured_feature_map,
    )
    from repro_torch.structured.plan import (
        init_structured_params,
        make_structured_plan,
    )

    return Estimator(
        name="structured",
        make_plan=make_structured_plan,
        init_params=init_structured_params,
        apply=_structured_apply,
        make_map=make_structured_feature_map,
        output_dim=_plan_output_dim,
        truncation_bias=_plan_truncation_bias,
        pack=_structured_pack,
    )


# Built on the first ``get`` / ``list_estimators``, not at import: each
# family's package imports ``repro_torch.core`` (this module with it), so
# building the entries here would import a family package half-loaded
# whenever that package is the first one imported.
_ENTRIES: Dict[str, Estimator] = {}


def _entries() -> Dict[str, Estimator]:
    if not _ENTRIES:
        _ENTRIES.update(rm=_make_rm_entry(), tensor_sketch=_make_ts_entry(),
                        ctr=_make_ctr_entry(),
                        structured=_make_structured_entry())
    return _ENTRIES


def list_estimators() -> Tuple[str, ...]:
    return tuple(sorted(_entries()))


def get(name: str) -> Estimator:
    """Resolve an estimator family by name.

    Raises:
        KeyError: unknown name, naming the available ones.
    """
    try:
        return _entries()[name]
    except KeyError:
        raise KeyError(
            f"unknown estimator {name!r}; available: {list_estimators()}"
        ) from None
