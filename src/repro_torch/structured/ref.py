"""Plain PyTorch paths for the structured (Hadamard) estimator (port of
``repro.structured.ref``).

* ``hadamard_matrix`` — the unnormalized Sylvester matrix (numpy, +-1).
* ``structured_blocks_ref`` — the oracle: per bucket, slot j of every
  stack is ``(x ∘ d1_j) @ H * d2_j`` with the dense H, then the slots
  multiply. The tests hold the fused map against it.
* ``structured_feature_fused_ref`` — the plain version of kernel B8: the
  masked running product on the ``pack_structured`` tensors, each
  transform by butterflies (``wht``: stages h = 1, 2, ..., d_pad / 2 in
  Sylvester order, the kernel's own order), in fp32, at any power-of-two
  d_pad.

Both emit the PADDED random section (``total_stacks * d_pad`` columns,
surplus columns at scale 0); ``apply_structured_plan`` adds the prefix
columns and drops the surplus.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.structured.plan import StructuredPlan

__all__ = [
    "hadamard_matrix",
    "wht",
    "structured_blocks_ref",
    "structured_feature_fused_ref",
]


@functools.lru_cache(maxsize=None)
def hadamard_matrix(m: int) -> np.ndarray:
    """Unnormalized Sylvester Walsh-Hadamard matrix ``[m, m]`` (+-1
    float32, symmetric). ``m`` must be a power of two."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {m}")
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < m:
        h = np.block([[h, h], [h, -h]])
    return h


def wht(v: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform along the last axis (a power
    of two) by butterflies: stage h = 1, 2, ... maps each pair (i, i + h)
    with ``i & h == 0`` to (a + b, a - b). Equals ``v @ H`` in exact
    arithmetic, in O(m log m) and without the ``[m, m]`` matrix."""
    shape = v.shape
    m = shape[-1]
    if m < 1 or m & (m - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {m}")
    h = 1
    while h < m:
        v = v.reshape(*shape[:-1], m // (2 * h), 2, h)
        a, b = v[..., 0, :], v[..., 1, :]
        v = torch.cat([a + b, a - b], dim=-1)
        h *= 2
    return v.reshape(shape)


def _hmat(m: int, device) -> torch.Tensor:
    return torch.from_numpy(hadamard_matrix(m)).to(device)


def structured_blocks_ref(plan: StructuredPlan,
                          params: Dict[str, torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
    """All degree buckets via dense WHT products: ``x [B, d] -> [B,
    plan.padded_num_cols]`` fp32; stack i of bucket n emits
    ``scale_n prod_{j<n} (d2_ij ∘ H (d1_ij ∘ x_pad))``."""
    m = plan.d_pad
    xf = torch.nn.functional.pad(x.float(), (0, m - plan.input_dim))
    if plan.padded_num_cols == 0:
        return torch.zeros((xf.shape[0], 0), dtype=torch.float32,
                           device=x.device)
    hmat = _hmat(m, x.device)
    cols, off = [], 0
    for n, s in zip(plan.degrees, plan.stacks_per_bucket):
        d1 = params["d1"][off: off + s * n].float().reshape(s, n, m)
        d2 = params["d2"][off: off + s * n].float().reshape(s, n, m)
        off += s * n
        u = xf[:, None, None, :] * d1[None]               # [B, s, n, m]
        v = (u @ hmat) * d2[None]                         # H symmetric
        cols.append(torch.prod(v, dim=2).reshape(xf.shape[0], s * m))
    scale = torch.from_numpy(plan.padded_column_scales()).to(x.device)
    return torch.cat(cols, dim=-1) * scale[None, :]


def structured_feature_fused_ref(
    x: torch.Tensor,          # [B, d], d <= d_pad (zero-padded here)
    d1: torch.Tensor,         # [max_degree, S, d_pad] (pack_structured)
    d2: torch.Tensor,         # [max_degree, S, d_pad]
    col_deg: torch.Tensor,    # [S * d_pad] int32 per-column product depth
    col_scale: torch.Tensor,  # [S * d_pad] per-column scale (0 on surplus)
) -> torch.Tensor:            # [B, S * d_pad] fp32
    """Plain version of kernel B8; every operand is upcast to fp32.

    Column f is ``col_scale[f] prod_{j < col_deg[f]} (d2[j] ∘ H (d1[j] ∘
    x_pad))_f``, x zero-padded to d_pad as the reference pads it, each
    transform by :func:`wht`.
    """
    k, s, m = d1.shape
    xf = torch.nn.functional.pad(x.float(), (0, m - x.shape[-1]))
    acc = torch.ones((xf.shape[0], s * m), dtype=torch.float32,
                     device=x.device)
    deg = col_deg.to(x.device)
    for j in range(k):
        u = xf[:, None, :] * d1[j].float()[None]          # [B, S, m]
        p = (wht(u) * d2[j].float()[None]).reshape(xf.shape[0], s * m)
        acc = torch.where((j < deg)[None, :], acc * p, acc)
    return acc * col_scale.float()[None, :]
