"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (3:1 interleave; blocks carry their own projections, no separate FFN).
[arXiv:2405.04517; unverified]

Attention-free: the paper's RM attention mode is N/A for this arch
(DESIGN.md §6 Arch-applicability); `long_500k` runs natively (O(1) decode
state).

Port of ``repro.configs.xlstm_350m``; ``configs.get_config`` refuses
``attention_mode="rm"`` for it.
"""
from repro_torch.models.config import ModelConfig, XLSTMConfig

_PATTERN = ("mlstm", "mlstm", "mlstm", "slstm")

FULL = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=524288,
    block_pattern=_PATTERN,
    pos_embedding="none",
    norm_kind="layernorm",
    mlp_kind="gelu",              # unused (no ffn blocks) but must be valid
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    max_seq_len=256,
    block_pattern=_PATTERN,
    pos_embedding="none",
    norm_kind="layernorm",
    mlp_kind="gelu",
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4),
    tie_embeddings=True,
)
