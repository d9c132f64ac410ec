"""Model configuration (port of ``repro.models.config``).

The reference's frozen dataclasses and field names, restricted to the
fields the port reads, so a config reads the same in both packages: every
field but ``remat`` and ``scan_unroll``, which only the reference's jit and
scan machinery reads. The MoE, MLA, Mamba and xLSTM sub-configs are read
by ``models/moe.py``, ``models/mla.py``, ``models/mamba.py`` and
``models/xlstm.py``. ``frontend`` is ``"none"`` (token inputs),
``"audio_stub"`` (precomputed frame embeddings, the HuBERT encoder) or
``"vision_stub"`` (precomputed patch embeddings put before the tokens,
InternVL2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["RMAttentionConfig", "MoEConfig", "MLAConfig", "MambaConfig",
           "XLSTMConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class RMAttentionConfig:
    """The paper's technique as an attention mode (reference DESIGN.md §2).

    q/k are l2-normalized per head, scaled by softplus(``rm_scale``) (or
    ``qk_scale``) and mapped through a feature plan of the ``estimator``
    family (``"rm"`` or ``"tensor_sketch"``) for exp(<q,k>/sigma2);
    attention becomes linear in the features. ``fuse_featurize``: ``"auto"``
    and ``"on"`` take the fused featurize+attention ops (the Hopper kernels
    on a CUDA device) where the family supports them; ``"off"``, and every
    family without the fused capability, take the two-launch path
    (featurize, then the chunked causal attention kernel).
    """

    estimator: str = "rm"
    precision: str = "fp32"
    fuse_featurize: str = "auto"
    num_features: int = 256
    sigma2: float = 1.0
    qk_scale: float = 1.0
    p: float = 2.0
    measure: str = "proportional"
    stratified: bool = True
    n_max: int = 8
    chunk: int = 128
    eps: float = 1e-4
    learnable_scale: bool = True


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0           # per-expert hidden dim
    num_shared_experts: int = 0    # DeepSeek shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # "local": sorted-rank dispatch into per-expert capacity buffers
    #          (default; the reference runs it per data-parallel shard);
    # "einsum": GShard one-hot dispatch, O(G*E*C*d) — toy scale / ablation.
    dispatch: str = "local"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = no query compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 = ceil(d_model / 16)
    scan_chunk: int = 64


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0       # mLSTM up-projection
    conv_kernel: int = 4
    slstm_ff_factor: float = 1.3333
    chunk: int = 64                # mLSTM chunkwise parallel size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"

    # trunk dims
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0              # 0 = d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192

    # block structure
    block_pattern: Tuple[str, ...] = ("attn_mlp",)
    first_k_dense: int = 0
    causal: bool = True            # False => encoder-only (hubert)
    frontend: str = "none"         # none | vision_stub | audio_stub

    # attention flavor
    attention_kind: str = "gqa"    # gqa | mla
    attention_mode: str = "exact"  # exact | rm  (rm = the paper's technique)
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention (exact mode)
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"    # rope | sinusoidal | none

    # norms / mlp
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm | nonparametric_ln
    mlp_kind: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # sub-configs
    rm: RMAttentionConfig = RMAttentionConfig()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # init / precision
    init_std: float = 0.02
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def num_scanned_groups(self) -> int:
        n = self.num_layers - self.first_k_dense
        period = len(self.block_pattern)
        if n % period:
            raise ValueError(
                f"{self.name}: {n} scanned layers not divisible by pattern "
                f"period {period}")
        return n // period

    def validate(self) -> "ModelConfig":
        if self.frontend not in ("none", "vision_stub", "audio_stub"):
            raise ValueError(
                f"{self.name}: unknown frontend={self.frontend!r} ('none', "
                "'vision_stub' or 'audio_stub')")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} is not a multiple "
                f"of num_kv_heads={self.num_kv_heads}")
        if self.attention_kind == "mla" and self.mla is None:
            raise ValueError(f"{self.name}: attention_kind='mla' needs an "
                             "mla config")
        if any("moe" in b for b in self.block_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: a moe block needs a moe config")
        if any("mamba" in b for b in self.block_pattern) and \
                self.mamba is None:
            raise ValueError(f"{self.name}: a mamba block needs a mamba "
                             "config")
        if any(b in ("mlstm", "slstm") for b in self.block_pattern) and \
                self.xlstm is None:
            raise ValueError(f"{self.name}: an xlstm block needs an xlstm "
                             "config")
        _ = self.num_scanned_groups
        return self
