"""Estimator registry (port of ``repro.core.registry``), ``"rm"`` entry only.

Each family is a set of functions behind one name:

    make_plan(kernel, input_dim, num_features, *, p, measure, h01, n_max,
              radius, stratified, seed)          -> plan (hashable)
    init_params(plan, generator, dtype)          -> {"omegas": Tensor}
    apply(plan, params, x, *, precision)         -> features
    output_dim(plan)                             -> int
    pack_fused(plan, params)                     -> (w, col_deg, col_scale)
                                                    (tensors on w's device)

``fused_attention_supported`` marks families whose map is the packed
masked-running-product layout the fused attention kernel takes. The other
reference families (tensor_sketch, ctr, structured) are not ported yet
(ROADMAP.md queue A); ``get`` raises on them, naming what exists.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["Estimator", "get", "list_estimators"]


@dataclasses.dataclass(frozen=True)
class Estimator:
    name: str
    make_plan: Callable[..., Any]
    init_params: Callable[..., Dict[str, torch.Tensor]]
    apply: Callable[..., torch.Tensor]
    output_dim: Callable[[Any], int]
    fused_attention_supported: bool = False
    pack_fused: Optional[Callable[..., Any]] = None


def _rm_init_params(plan, generator: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``{"omegas": [total_rows, d]}`` Rademacher draws from ``generator``
    (on its device)."""
    from repro_torch.core.plan import init_omegas

    return {"omegas": init_omegas(plan, generator, dtype)}


def _rm_apply(plan, params, x, *, precision=None) -> torch.Tensor:
    from repro_torch.core.plan import apply_plan

    return apply_plan(plan, params["omegas"], x, precision=precision)


def _rm_pack_fused(plan, params) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Packed ``[max_degree, F, d]`` omegas plus the per-column degree
    (int32) and scale (fp32) vectors, on the omegas' device (the reference
    returns the vectors as host numpy; here they are memoized device
    tensors, so a decode step copies nothing from the host)."""
    from repro_torch.core.plan import pack_omegas, plan_columns

    w = pack_omegas(plan, params["omegas"])
    return (w, *plan_columns(plan, w.device))


def _plan_output_dim(plan) -> int:
    return plan.output_dim


def _make_rm_entry() -> Estimator:
    from repro_torch.core.plan import make_feature_plan

    return Estimator(
        name="rm",
        make_plan=make_feature_plan,
        init_params=_rm_init_params,
        apply=_rm_apply,
        output_dim=_plan_output_dim,
        fused_attention_supported=True,
        pack_fused=_rm_pack_fused,
    )


_ENTRIES: Dict[str, Estimator] = {"rm": _make_rm_entry()}


def list_estimators() -> Tuple[str, ...]:
    return tuple(sorted(_ENTRIES))


def get(name: str) -> Estimator:
    """Resolve an estimator family by name.

    Raises:
        KeyError: unknown or not-yet-ported name, naming the available ones.
    """
    try:
        return _ENTRIES[name]
    except KeyError:
        raise KeyError(
            f"unknown estimator {name!r}; available: {list_estimators()}"
        ) from None
