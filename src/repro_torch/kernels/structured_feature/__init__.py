from repro_torch.kernels.structured_feature.ops import structured_feature_fused

__all__ = ["structured_feature_fused"]
