"""Static (hashable) RM feature-map plans for the models (port of
``repro.core.static_plan``).

Compatibility shim: the plan subsystem lives in ``core.plan``
(``FeaturePlan`` is the single source of truth for allocation, scales and
the fused packed layout). Every layer of a model shares the SAME plan
*structure* while carrying its OWN Rademacher draws as (non-trainable)
parameters:

  * ``PlanMeta``    — alias of ``FeaturePlan`` (hashable),
  * ``init_omegas`` — per-layer parameter initialization ([total_rows, d]),
  * ``apply_plan``  — the fused application (ONE launch of kernel B1 on a
                      CUDA tensor, its plain version on a CPU tensor).
"""
from __future__ import annotations

from repro_torch.core.maclaurin import DotProductKernel
from repro_torch.core.plan import (
    FeaturePlan,
    apply_plan,
    init_omegas,
    make_feature_plan,
    plan_output_dim,
)

__all__ = ["PlanMeta", "make_plan_meta", "init_omegas", "apply_plan",
           "plan_output_dim"]

PlanMeta = FeaturePlan


def make_plan_meta(
    kernel: DotProductKernel,
    input_dim: int,
    num_features: int,
    *,
    p: float = 2.0,
    measure: str = "proportional",
    stratified: bool = True,
    n_max: int = 16,
    radius: float = 1.0,
    seed: int = 0,
) -> FeaturePlan:
    """Host-side plan construction (thin wrapper over ``core.plan``), with
    the reference's defaults: the proportional measure, n_max 16, no H0/1
    block."""
    return make_feature_plan(kernel, input_dim, num_features, p=p,
                             measure=measure, h01=False, n_max=n_max,
                             radius=radius, stratified=stratified, seed=seed)
