"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf] (port of
``repro.configs.mixtral_8x7b``). FULL is about 47 B parameters, 93 GB in
bf16: it does not fit one 80 GB card and waits for meshes (ROADMAP.md
queue A item 7); SMOKE runs anywhere."""
from repro_torch.models.config import ModelConfig, MoEConfig, RMAttentionConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=524288,
    block_pattern=("attn_moe",),
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25),
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=("attn_moe",),
    sliding_window=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
