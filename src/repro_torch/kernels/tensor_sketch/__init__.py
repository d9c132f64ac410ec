from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused

__all__ = ["tensor_sketch_fused"]
