from repro_torch.kernels.rm_feature.ops import rm_feature_fused
from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

__all__ = ["rm_feature_fused", "rm_feature_fused_ref"]
