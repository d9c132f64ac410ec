"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT frontend (STUB: precomputed patch embeddings) +
Qwen2-0.5B-family backbone. [arXiv:2404.16821; hf] (port of
``repro.configs.internvl2_1b``)."""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    max_seq_len=524288,
    block_pattern=("attn_mlp",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    tie_embeddings=True,
    frontend="vision_stub",        # input_specs supplies patch embeddings
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=56,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vision_stub",
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
