"""repro_torch.ctr — the complex-to-real estimator family (port of
``repro.ctr``), registered as ``"ctr"`` in ``repro_torch.core.registry``."""
from repro_torch.ctr.feature_map import (
    CtrFeatureMap,
    make_ctr_feature_map,
)
from repro_torch.ctr.plan import (
    CtrPlan,
    apply_ctr_plan,
    init_ctr_params,
    make_ctr_plan,
    pack_ctr,
)
from repro_torch.ctr.ref import ctr_blocks_ref, ctr_feature_fused_ref

__all__ = [
    "CtrFeatureMap",
    "make_ctr_feature_map",
    "CtrPlan",
    "apply_ctr_plan",
    "init_ctr_params",
    "make_ctr_plan",
    "pack_ctr",
    "ctr_blocks_ref",
    "ctr_feature_fused_ref",
]
