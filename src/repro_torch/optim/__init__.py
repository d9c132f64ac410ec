"""repro_torch.optim — AdamW, learning-rate schedules and int8 gradient
quantization (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    mask_frozen,
)
from repro_torch.optim.compression import (
    compressed_psum_with_feedback,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "mask_frozen",
    "warmup_cosine",
    "warmup_linear",
    "quantize_int8",
    "dequantize_int8",
    "compressed_psum_with_feedback",
]
