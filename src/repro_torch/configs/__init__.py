"""Architecture registry (port of ``repro.configs``): ``--arch <id>``,
the reference's ten ids.

Dense decoders ``qwen3-1.7b``, ``h2o-danube-3-4b`` (sliding window),
``olmo-1b`` (parameter-free layernorm) and ``qwen2-7b`` (QKV bias); the
VLM backbone ``internvl2-1b`` (precomputed patch embeddings before the
tokens); the MoE models ``mixtral-8x7b`` (GQA) and
``deepseek-v2-lite-16b`` (MLA); the audio encoder ``hubert-xlarge``
(non-causal; encoded through ``repro_torch.train.steps``); the hybrid
``jamba-v0.1-52b`` (one attention + seven Mamba mixers a period, MoE on
alternate layers) and the attention-free ``xlstm-350m`` (mLSTM + sLSTM).
Each module holds ``FULL`` (the published config) and ``SMOKE`` (a small
config of the same family). ``get_config`` takes the reference's
overrides: ``attention_mode`` (``"rm"`` is refused for an attention-free
arch) and ``estimator`` (the feature family of RM attention, validated
against the port's registry: ``"rm"``, ``"tensor_sketch"``, ``"ctr"`` or
``"structured"``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "list_archs", "supports_rm",
           "launcher_attention_mode"]

_ARCH_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False,
               attention_mode: Optional[str] = None,
               estimator: Optional[str] = None) -> ModelConfig:
    """Resolve an arch id (``FULL``, or ``SMOKE`` with ``smoke=True``),
    with optional attention-mode and estimator overrides.

    Raises:
        KeyError: an unknown arch id, or an estimator name the registry
            does not have (the message names the available ones).
        ValueError: ``attention_mode="rm"`` for an attention-free arch, or
            ``estimator`` given for a config whose attention mode is not
            ``"rm"``.
    """
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if attention_mode is not None and attention_mode != cfg.attention_mode:
        if attention_mode == "rm" and not supports_rm(cfg):
            raise ValueError(
                f"{arch} is attention-free; the paper's RM attention mode "
                "does not apply (DESIGN.md §6).")
        cfg = dataclasses.replace(cfg, attention_mode=attention_mode)
    if estimator is not None:
        if cfg.attention_mode != "rm":
            raise ValueError(
                f"estimator={estimator!r} requested but {arch} resolves to "
                f"attention_mode={cfg.attention_mode!r}; estimators only "
                "apply to the paper's RM linear attention (pass "
                "attention_mode='rm').")
        from repro_torch.core import registry

        registry.get(estimator)   # raises with the available names
        if estimator != cfg.rm.estimator:
            cfg = dataclasses.replace(
                cfg, rm=dataclasses.replace(cfg.rm, estimator=estimator))
    return cfg.validate()


def supports_rm(cfg: ModelConfig) -> bool:
    """Whether the config has a layer that attends (GQA or MLA), where the
    paper's RM attention applies."""
    return any(b.split("_")[0] in ("attn", "mla")
               for b in cfg.block_pattern) or cfg.first_k_dense > 0


def launcher_attention_mode(arch: str, requested: Optional[str]
                            ) -> Optional[str]:
    """The launchers' ``--attention-mode``: ``requested`` where given,
    else ``"rm"`` (the paper's technique) for an arch that attends and
    ``None`` (its config's own mode) for an attention-free one."""
    if requested is not None:
        return requested
    return "rm" if supports_rm(get_config(arch, smoke=True)) else None
