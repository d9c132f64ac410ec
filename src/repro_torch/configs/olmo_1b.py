"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=8192
vocab=50304 — non-parametric LN. [arXiv:2402.00838; hf] (port of
``repro.configs.olmo_1b``)."""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    max_seq_len=524288,
    block_pattern=("attn_mlp",),
    norm_kind="nonparametric_ln",   # OLMo: LN without learnable params
    mlp_kind="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    norm_kind="nonparametric_ln",
    tie_embeddings=True,
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
