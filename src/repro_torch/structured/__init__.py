"""repro_torch.structured — the Hadamard-structured estimator family (port
of ``repro.structured``), registered as ``"structured"`` in
``repro_torch.core.registry``."""
from repro_torch.structured.feature_map import (
    StructuredFeatureMap,
    make_structured_feature_map,
)
from repro_torch.structured.plan import (
    StructuredPlan,
    apply_structured_plan,
    init_structured_params,
    make_structured_plan,
    pack_structured,
)
from repro_torch.structured.ref import (
    hadamard_matrix,
    structured_blocks_ref,
    structured_feature_fused_ref,
)

__all__ = [
    "StructuredFeatureMap",
    "make_structured_feature_map",
    "StructuredPlan",
    "apply_structured_plan",
    "init_structured_params",
    "make_structured_plan",
    "pack_structured",
    "hadamard_matrix",
    "structured_blocks_ref",
    "structured_feature_fused_ref",
]
