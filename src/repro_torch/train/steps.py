"""Step functions (port of ``repro.train.steps``, the forward-only part).

``make_prefill_step(cfg, max_len)`` and ``make_eval_step(cfg)`` return
callables with the reference's signatures. For an encoder (``causal=False``)
"prefill" is a full bidirectional encode: ``(logits, None)``; for a decoder
it is ``transformer.prefill``: ``(logits, decode cache)``. The eval step
returns ``loss_fn``'s metrics. Each callable runs where the params it is
given lie: ``init_params(cfg, seed)`` builds them on the card (``device``
defaults to ``"cuda"`` and raises without one, as everywhere in the port);
``device="cpu"`` runs the plain PyTorch path on the CPU.

    cfg = get_config("hubert-xlarge", smoke=True, attention_mode="rm")
    params = init_params(cfg, seed=0, device="cpu")
    logits, _ = make_prefill_step(cfg, cfg.max_seq_len)(
        params, {"embeds": torch.randn(2, 100, cfg.d_model)})

Nothing here records gradients (``torch.inference_mode``): the fused
attention ops have no backward yet, so ``make_train_step`` and the
optimizer wait for the training slice (ROADMAP.md queue A).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    forward,
    init_model,
    loss_fn,
    prefill,
)

__all__ = ["init_params", "make_eval_step", "make_prefill_step"]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random fp32 master weights of ``cfg`` from ``seed``, on ``device``.

    Raises:
        RuntimeError: ``device`` is CUDA (the default) and there is none.
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return init_model(cfg, gen)


def make_eval_step(cfg: ModelConfig):
    """``eval_step(params, batch) -> metrics`` (``ce``, ``z_loss``,
    ``tokens``, ``loss``; ``batch["targets"]`` as ``loss_fn`` takes it)."""
    def eval_step(params, batch: Dict[str, Any]):
        with torch.inference_mode():
            _, metrics = loss_fn(params, cfg, batch)
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``prefill_step(params, batch) -> (logits [B, T, V] fp32, cache)``;
    the cache is ``None`` for an encoder."""
    def prefill_step(params, batch: Dict[str, Any]):
        with torch.inference_mode():
            if not cfg.causal:
                # encoder: "prefill" is a full (bidirectional) encode
                logits, _ = forward(params, cfg, batch)
                return logits, None
            return prefill(params, cfg, batch, max_len)

    return prefill_step
