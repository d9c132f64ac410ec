"""Architecture registry (port of ``repro.configs``): ``--arch <id>``.

Ported: ``qwen3-1.7b`` (dense decoder, served), ``hubert-xlarge`` (audio
encoder, non-causal; encoded through ``repro_torch.train.steps``),
``deepseek-v2-lite-16b`` (MLA + MoE, served) and ``mixtral-8x7b`` (GQA +
MoE; its FULL config needs more than one card).
Every other reference arch id raises ``NotImplementedError`` naming where
its port is queued. ``get_config``
takes the reference's overrides: ``attention_mode`` and ``estimator`` (the
feature family of RM attention, validated against the port's registry:
``"rm"``, ``"tensor_sketch"``, ``"ctr"`` or ``"structured"``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "list_archs"]

_ARCH_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
}

# reference arch ids whose port is queued (ROADMAP.md queue A)
_NOT_PORTED = (
    "h2o-danube-3-4b", "olmo-1b", "qwen2-7b", "internvl2-1b",
    "jamba-v0.1-52b", "xlstm-350m",
)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False,
               attention_mode: Optional[str] = None,
               estimator: Optional[str] = None) -> ModelConfig:
    """Resolve an arch id (``FULL``, or ``SMOKE`` with ``smoke=True``),
    with optional attention-mode and estimator overrides.

    Raises:
        NotImplementedError: a reference arch whose port is still queued.
        KeyError: an unknown arch id, or an estimator name the registry
            does not have (the message names the available ones).
        ValueError: ``estimator`` given for a config whose attention mode
            is not ``"rm"``.
    """
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet (ported: "
            f"{list_archs()}); its modules are queued in ROADMAP.md queue A "
            "(items 6 and 11)")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if attention_mode is not None and attention_mode != cfg.attention_mode:
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
