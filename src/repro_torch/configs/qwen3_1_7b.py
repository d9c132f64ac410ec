"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA (port of ``repro.configs.qwen3_1_7b``)."""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    max_seq_len=524288,
    block_pattern=("attn_mlp",),
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    tie_embeddings=True,
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    qk_norm=True,
    tie_embeddings=True,
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
