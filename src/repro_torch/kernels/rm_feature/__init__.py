from repro_torch.kernels.rm_feature.ops import (
    apply_feature_map,
    apply_feature_map_bucketed,
    rm_feature_bucket,
    rm_feature_fused,
)
from repro_torch.kernels.rm_feature.ref import (
    rm_feature_bucket_ref,
    rm_feature_fused_ref,
)

__all__ = [
    "rm_feature_fused",
    "rm_feature_fused_ref",
    "rm_feature_bucket",
    "rm_feature_bucket_ref",
    "apply_feature_map",
    "apply_feature_map_bucketed",
]
