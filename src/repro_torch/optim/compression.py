"""Gradient compression for cross-pod links (port of
``repro.optim.compression``): symmetric per-tensor int8 quantization.

``compressed_psum_with_feedback`` (the int8 all-reduce with error
feedback) reduces over a mesh axis; the port has no mesh yet, so it
raises until the distributed slice (ROADMAP.md queue A item 7).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8",
           "compressed_psum_with_feedback"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 -> ``(q int8, scale fp32 0-dim)``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_with_feedback(grads: Any, residuals: Any,
                                  axis_name: str):
    """Not ported: it all-reduces over a mesh axis.

    Raises:
        NotImplementedError: always, until meshes are ported.
    """
    raise NotImplementedError(
        f"compressed_psum_with_feedback reduces over the mesh axis "
        f"{axis_name!r}; the port has no mesh yet (ROADMAP.md queue A "
        "item 7, distributed and launch)")
