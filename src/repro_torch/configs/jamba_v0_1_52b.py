"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave, MoE every
other layer. [arXiv:2403.19887; hf]

Pattern period 8 = 1 attention + 7 mamba mixers; MoE on alternating layers
(4 of 8), dense SwiGLU on the rest.

Port of ``repro.configs.jamba_v0_1_52b``. FULL is about 51.6 B
parameters, about 96 GiB in bf16: more than one 80 GB card, so the card
serves one pattern period (8 layers, about 13.3 B parameters) of it.
"""
from repro_torch.models.config import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RMAttentionConfig,
)

_PATTERN = (
    "attn_moe",
    "mamba_mlp",
    "mamba_moe",
    "mamba_mlp",
    "mamba_moe",
    "mamba_mlp",
    "mamba_moe",
    "mamba_mlp",
)

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    max_seq_len=524288,
    block_pattern=_PATTERN,
    rope_theta=10000.0,
    pos_embedding="none",          # Jamba uses no positional encoding
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, scan_chunk=64),
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=_PATTERN,
    pos_embedding="none",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, scan_chunk=16),
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
