"""Model configuration (port of ``repro.models.config``).

The reference's frozen dataclasses and field names, restricted to the
fields the port reads, so a config reads the same in both packages. The
MoE and MLA sub-configs and ``attention_kind`` are ported with
``models/moe.py`` and ``models/mla.py``; the Mamba and xLSTM sub-configs
and the fields only the jit/scan machinery reads (``remat``,
``scan_unroll``) come with the modules that read them (ROADMAP.md queue
A). ``frontend`` is ported for ``"none"``
(token inputs) and ``"audio_stub"`` (precomputed frame embeddings, the
HuBERT encoder); the vision stub waits for its model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["RMAttentionConfig", "MoEConfig", "MLAConfig", "ModelConfig"]


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
    frontend: str = "none"         # none | audio_stub

    # attention flavor
    attention_kind: str = "gqa"    # gqa | mla
    attention_mode: str = "exact"  # exact | rm  (rm = the paper's technique)
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention (exact mode)
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"    # rope | sinusoidal | none

    # norms / mlp
    norm_kind: str = "rmsnorm"
    mlp_kind: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # sub-configs
    rm: RMAttentionConfig = RMAttentionConfig()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

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
        if self.frontend not in ("none", "audio_stub"):
            raise NotImplementedError(
                f"{self.name}: frontend={self.frontend!r} is not ported yet "
                "('none' or 'audio_stub')")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} is not a multiple "
                f"of num_kv_heads={self.num_kv_heads}")
        if self.attention_kind == "mla" and self.mla is None:
            raise ValueError(f"{self.name}: attention_kind='mla' needs an "
                             "mla config")
        if any("moe" in b for b in self.block_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: a moe block needs a moe config")
        _ = self.num_scanned_groups
        return self
