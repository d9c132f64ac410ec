"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H (kv=16) d_ff=1408
(expert) vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed top-6,
first layer dense (d_ff=10944). [arXiv:2405.04434; hf] (port of
``repro.configs.deepseek_v2_lite_16b``). FULL is about 15.7 B parameters,
31 GB in bf16: it is served on one card with ``param_dtype="bfloat16"``
(fp32 masters would not fit beside the compute copy)."""
from repro_torch.models.config import (
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RMAttentionConfig,
)

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                    # the single dense layer's FFN
    vocab_size=102400,
    max_seq_len=524288,
    attention_kind="mla",
    block_pattern=("mla_moe",),
    first_k_dense=1,
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, capacity_factor=1.25),
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
    attention_kind="mla",
    block_pattern=("mla_moe",),
    first_k_dense=1,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared_experts=2),
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
