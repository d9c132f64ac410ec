from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused

__all__ = ["ctr_feature_fused"]
