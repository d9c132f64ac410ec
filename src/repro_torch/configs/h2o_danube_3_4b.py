"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA. [arXiv:2401.16818; unverified] (port of
``repro.configs.h2o_danube_3_4b``)."""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    max_seq_len=524288,
    block_pattern=("attn_mlp",),
    sliding_window=4096,          # mistral-style SWA
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="danube3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    sliding_window=16,
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
