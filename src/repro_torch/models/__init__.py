from repro_torch.models.config import ModelConfig, RMAttentionConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_cache,
    init_model,
    loss_fn,
    prefill,
)

__all__ = [
    "ModelConfig",
    "RMAttentionConfig",
    "decode_step",
    "forward",
    "init_decode_cache",
    "init_model",
    "loss_fn",
    "prefill",
]
