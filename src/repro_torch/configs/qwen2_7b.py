"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671; hf] (port of
``repro.configs.qwen2_7b``)."""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    max_seq_len=524288,
    block_pattern=("attn_mlp",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    num_layers=2,
    d_model=56,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    qkv_bias=True,
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
