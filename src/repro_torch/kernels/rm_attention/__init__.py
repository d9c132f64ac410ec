from repro_torch.kernels.rm_attention.ops import (
    rm_attention_causal,
    rm_attention_chunked,
    rm_attention_decode_step,
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_noncausal,
    rm_attention_fused_prefill,
    rm_attention_noncausal,
    rm_attention_prefill_final_state,
    rm_fused_apply,
    rm_fused_causal,
    rm_fused_state,
)

__all__ = [
    "rm_attention_causal",
    "rm_attention_chunked",
    "rm_attention_decode_step",
    "rm_attention_fused_causal",
    "rm_attention_fused_decode_step",
    "rm_attention_fused_noncausal",
    "rm_attention_fused_prefill",
    "rm_attention_noncausal",
    "rm_attention_prefill_final_state",
    "rm_fused_apply",
    "rm_fused_causal",
    "rm_fused_state",
]
