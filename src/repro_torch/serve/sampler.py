"""Token sampling: greedy / temperature / top-k (port of
``repro.serve.sampler``)."""
from __future__ import annotations

from typing import Optional

import torch


def sample_token(
    logits: torch.Tensor,                  # [B, V] fp32
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:                         # [B] int64
    """Greedy at ``temperature <= 0``; otherwise a categorical draw from
    ``softmax(logits / temperature)`` (restricted to the top ``top_k``
    when ``top_k > 0``) using ``generator``, which must live on the logits'
    device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
