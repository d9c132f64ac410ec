"""Gradient compression for cross-pod links (port of
``repro.optim.compression``): int8 quantization with error feedback.

The cross-pod link is the scarcest bandwidth at multi-pod scale, and the
data-parallel gradient all-reduce over the "pod" axis its largest user.
``compressed_psum_with_feedback`` runs on every rank of a pod process
group (a ``DeviceMesh``'s ``"pod"`` dim):

    q, scale = quantize(g + residual);  q_sum = all_reduce(q);
    g' = dequant(q_sum) / n;  residual' = (g + residual) - dequant(q)

The scale is shared (the max over the group of ``max|g + r| / 127``), so
every rank encodes with one codebook and the int payloads sum exactly as
``int32``. The error feedback re-injects step t's quantization error at
step t + 1, so the compression is unbiased over time (Karimireddy et al.,
2019).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compress_leaf",
           "compressed_psum_with_feedback"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 -> ``(q int8, scale fp32 0-dim)``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, r: torch.Tensor, group,
                  scale_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf of :func:`compressed_psum_with_feedback`: ``(mean-reduced
    fp32 gradient, new residual)``, in the reference's order: the shared
    scale (one ``all_reduce(MAX)``; a leaf cut over ``scale_group``, an
    FSDP data slice, takes the max over its slices first, so the whole
    leaf has one codebook), ``q = clip(round(corrected / scale), -127,
    127)``, the residual ``corrected - q * scale``, the ``int32`` sum of
    ``q`` (one ``all_reduce(SUM)``), then ``sum * scale / n``. Neither
    input is modified; the temporaries are updated in place, so at most
    four leaf-sized ones live at once."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import all_reduce

    corrected = g.float() + r
    local_scale = torch.clamp_min(corrected.abs().max(), 1e-12) / 127.0
    if scale_group is not None:
        local_scale = all_reduce(local_scale.reshape(1), scale_group,
                                 "max")[0]
    shared = all_reduce(local_scale.reshape(1), group, "max")[0]
    q = torch.round(corrected / shared).clamp_(-127, 127)
    new_r = corrected.sub_(q * shared)
    summed = all_reduce(q.to(torch.int32), group)
    del q
    return (summed.float().mul_(shared).div_(dist.get_world_size(group)),
            new_r)


def compressed_psum_with_feedback(grads: Any, residuals: Any,
                                  group) -> Tuple[Any, Any]:
    """All-reduce ``grads`` over ``group`` in int8 with error feedback ->
    ``(mean-reduced fp32 grads, new residuals)``, trees of ``grads``'
    layout, one :func:`compress_leaf` a leaf. As in the reference, ``q``
    holds int8 values but is summed as ``int32``, so the reduction itself
    moves as many bytes as fp32."""
    from repro_torch.common.tree import tree_get, tree_map_with_path

    out = tree_map_with_path(
        lambda path, g: compress_leaf(g, tree_get(residuals, path), group),
        grads)
    return (tree_map_with_path(lambda _, pair: pair[0], out),
            tree_map_with_path(lambda _, pair: pair[1], out))
