from repro_torch.kernels.rm_attention.ops import (
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_prefill,
    rm_fused_causal,
)

__all__ = [
    "rm_attention_fused_causal",
    "rm_attention_fused_decode_step",
    "rm_attention_fused_prefill",
    "rm_fused_causal",
]
