"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step, in fp32 as the reference computes them. ``step``
is an int or a tensor; the result is a 0-dim fp32 tensor on the step's
device (the CPU for an int)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_linear"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``."""
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_linear(step, peak_lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then linear down to 0."""
    step = _step(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    lin = peak_lr * (1.0 - prog).clamp(0.0, 1.0)
    return torch.where(step < warmup_steps, warm, lin)
