"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 —
encoder-only (same arch as wav2vec2); the conv frontend is a STUB: the
model takes precomputed frame embeddings ``batch["embeds"]`` (port of
``repro.configs.hubert_xlarge``).

Encoder-only: no decode step and no serving engine; the entry points are
``repro_torch.train.steps.make_prefill_step`` (a full bidirectional
encode) and ``make_eval_step``.
"""
from repro_torch.models.config import ModelConfig, RMAttentionConfig

FULL = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    max_seq_len=32768,
    block_pattern=("attn_mlp",),
    causal=False,                  # bidirectional encoder
    pos_embedding="sinusoidal",
    norm_kind="layernorm",
    mlp_kind="gelu",
    frontend="audio_stub",
    rm=RMAttentionConfig(num_features=256),
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    max_seq_len=256,
    block_pattern=("attn_mlp",),
    causal=False,
    pos_embedding="sinusoidal",
    norm_kind="layernorm",
    mlp_kind="gelu",
    frontend="audio_stub",
    rm=RMAttentionConfig(num_features=64, n_max=6),
)
