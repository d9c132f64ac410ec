"""Public wrapper of the structured kernel (port of
``repro.kernels.structured_feature.ops.structured_feature_fused``).

``structured_feature_fused`` applies the whole padded random section of a
``StructuredPlan`` (the packed sign tensors of
``structured.plan.pack_structured``) in ONE launch of
``csrc/structured_feature.cu`` (kernel B8). x comes at its true width ``d
<= d_pad``: the kernel reads columns past d as zero, the plain version
pads them, so no padded copy is made on the card. By default the result is
the reference function's ``[..., S * d_pad]``; given ``out`` and ``keep``
(a :class:`StructuredKeep`), each stack writes only its kept columns into
its place in ``out`` and nothing else is written
(``structured.plan.apply_structured_plan`` passes its final map that way).
Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``structured.ref.structured_feature_fused_ref``), and the same routing of
its columns; a CUDA tensor launches the kernel or raises — there is no
fallback. The kernel masks the ragged row edge itself. Past d_pad 8192
the kernel's split path takes an fp32 scratch, which the wrapper
allocates (``kernels.common.structured_split_rows`` rows at a time).
``structured_feature_fused.launches`` counts kernel launches and
``structured_feature_fused.last_schedule`` holds the last launch's
``kernels.common.StructuredSchedule``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.common import (
    PLAIN_DEVICES,
    check_structured_d_pad,
    structured_schedule,
    structured_split_rows,
)
from repro_torch.obs.trace import kernel_scope as _kernel_scope
from repro_torch.structured.ref import structured_feature_fused_ref

__all__ = ["StructuredKeep", "structured_feature_fused"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


class StructuredKeep(NamedTuple):
    """Where each stack's kept columns go: stack s writes its columns
    ``c < count[s]`` to ``out[:, first[s] + c]``."""
    first: Tuple[int, ...]
    count: Tuple[int, ...]


def full_width_keep(stacks: int, m: int) -> StructuredKeep:
    """Every column of every stack, in place: the ``[rows, stacks * m]``
    result of the reference function."""
    return StructuredKeep(tuple(s * m for s in range(stacks)),
                          (m,) * stacks)


# (keep, device) -> (first, count) int32 tensors: made once, since a fresh
# host-to-device copy on every featurize would synchronize the stream
_KEEP_CACHE: Dict[Tuple[StructuredKeep, str],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


def _keep_tensors(keep: StructuredKeep, device):
    key = (keep, str(device))
    cached = _KEEP_CACHE.get(key)
    if cached is None:
        cached = tuple(torch.tensor(v, dtype=torch.int32, device=device)
                       for v in (keep.first, keep.count))
        _KEEP_CACHE[key] = cached
    return cached


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("structured_feature")
    fn = lib.structured_feature_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(xf, d1, d2, col_deg, col_scale):
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"structured kernel takes fp32 or bf16 x, got "
                        f"{xf.dtype}")
    for name, t in (("d1", d1), ("d2", d2)):
        if t.dtype != xf.dtype:
            raise TypeError(f"{name} must match x's dtype {xf.dtype}, got "
                            f"{t.dtype}")
    if col_deg.dtype != torch.int32 or col_scale.dtype != torch.float32:
        raise TypeError("col_deg must be int32 and col_scale float32, got "
                        f"{col_deg.dtype} and {col_scale.dtype}")
    _, s, m = d1.shape
    if d2.shape != d1.shape or col_deg.shape != (s * m,) or \
            col_scale.shape != (s * m,):
        raise ValueError(
            f"shape mismatch: x {tuple(xf.shape)}, d1 {tuple(d1.shape)}, "
            f"d2 {tuple(d2.shape)}, col_deg {tuple(col_deg.shape)}, "
            f"col_scale {tuple(col_scale.shape)}")
    for name, t in (("x", xf), ("d1", d1), ("d2", d2), ("col_deg", col_deg),
                    ("col_scale", col_scale)):
        if t.device != xf.device:
            raise ValueError(f"{name} is on {t.device}, x on {xf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_destination(out, keep, b, s, m, device):
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[0] != b \
            or out.stride(1) != 1 or out.device != device:
        raise ValueError(
            f"out must be fp32 [{b}, width] on {device} with unit column "
            f"stride, got {out.dtype} {tuple(out.shape)} strides "
            f"{out.stride()} on {out.device}")
    if len(keep.first) != s or len(keep.count) != s or any(
            not 0 <= c <= m or f < 0 or f + c > out.shape[1]
            for f, c in zip(keep.first, keep.count)):
        raise ValueError(f"keep {keep} does not place {s} stacks of "
                         f"{m} columns within out's {out.shape[1]} columns")


def _route(z, out, keep, m):
    """The plain version's routing: stack s's first count[s] columns of
    the full-width ``z`` into ``out`` at ``first[s]``."""
    for s, (first, count) in enumerate(zip(keep.first, keep.count)):
        out[:, first: first + count] = z[:, s * m: s * m + count]
    return out


def structured_feature_fused(
    x: torch.Tensor,          # [..., d] fp32 or bf16, d <= d_pad
    d1: torch.Tensor,         # [max_degree, S, d_pad] (pack_structured)
    d2: torch.Tensor,         # [max_degree, S, d_pad]
    col_deg: torch.Tensor,    # [S * d_pad] int32 per-column product depth
    col_scale: torch.Tensor,  # [S * d_pad] fp32 per-column scale
    *,
    out: Optional[torch.Tensor] = None,     # [rows, width] fp32
    keep: Optional[StructuredKeep] = None,  # each stack's place in out
) -> torch.Tensor:            # [..., S * d_pad] fp32, or out
    """Apply the packed structured stacks: one kernel launch for every
    column. Without ``out`` the result is ``[..., S * d_pad]`` (surplus
    columns at scale 0 come out 0); with ``out`` (rows = x's rows
    flattened) and ``keep``, stack s writes its first ``keep.count[s]``
    columns to ``out[:, keep.first[s]:]``, no other element of ``out`` is
    touched, and ``out`` is returned.

    Raises:
        ValueError: d_pad is not a power of two, or x is wider than it
            (on either device, so the CPU path refuses what the kernel
            would); ``out`` or ``keep`` do not fit.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, d1, d2)):
        raise NotImplementedError(
            "structured_feature_fused has no backward: the reference "
            "defines no VJP for kernel B8, and two-launch training is an "
            "open question (ROADMAP.md queue C)")
    if (out is None) != (keep is None):
        raise ValueError("out and keep go together")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    k, s, m = d1.shape
    check_structured_d_pad(m)
    if not 1 <= d <= m:
        raise ValueError(f"x's width {d} must lie in [1, d_pad={m}]")
    cols = s * m
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    if out is not None:
        _check_destination(out, keep, b, s, m, x.device)
    # Shapes with nothing to compute return their arithmetic result: no
    # rows or stacks give an empty output, and with no slots every column
    # is the empty product 1 times its scale.
    if b == 0 or s == 0:
        if out is not None:
            return out
        return torch.zeros((*batch_shape, cols), dtype=torch.float32,
                           device=x.device)
    if k == 0:
        z = col_scale.to(device=x.device, dtype=torch.float32)
        z = z.expand(b, cols).clone()
        if out is not None:
            return _route(z, out, keep, m)
        return z.reshape(*batch_shape, cols)
    with _kernel_scope("structured_feature", x=x,
                       cost=dict(batch=b, d=m, depth=k, f=cols,
                                 itemsize=x.element_size())):
        if x.device.type in PLAIN_DEVICES:
            z = structured_feature_fused_ref(xf, d1, d2, col_deg, col_scale)
            if out is not None:
                return _route(z, out, keep, m)
            return z.reshape(*batch_shape, cols)
        if x.device.type != "cuda":
            raise ValueError(f"structured_feature_fused runs on cpu, meta or "
                             f"cuda tensors, got {x.device}")
        _check_cuda_operands(xf, d1, d2, col_deg, col_scale)
        xf = xf.contiguous()
        sched = structured_schedule(m, b, s)
        dest = out
        if out is None:
            keep = full_width_keep(s, m)
            dest = torch.empty((b, cols), dtype=torch.float32, device=x.device)
        first, count = _keep_tensors(keep, x.device)
        depth_ptr = scratch_ptr = chunk = 0
        if sched.passes:
            # the split path: each stack's depth, and a scratch of every slot
            # of every stack for a chunk of rows
            depth = col_deg.view(s, m).amax(dim=1).clamp_(max=k)
            depth = depth.to(torch.int32)
            chunk = structured_split_rows(b, m, s, k)
            scratch = torch.empty(chunk * k * s * m, dtype=torch.float32,
                                  device=x.device)
            depth_ptr, scratch_ptr = depth.data_ptr(), scratch.data_ptr()
        err = _library()(
            xf.data_ptr(), d1.data_ptr(), d2.data_ptr(), col_deg.data_ptr(),
            col_scale.data_ptr(), dest.data_ptr(), dest.stride(0),
            first.data_ptr(), count.data_ptr(), b, d, s, m.bit_length() - 1,
            k,
            sched.warps, max(sched.lanes_per_row, 1).bit_length() - 1,
            depth_ptr, scratch_ptr, chunk, _DTYPE_CODE[xf.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"structured_feature kernel launch failed: "
                               f"CUDA error {err}")
        structured_feature_fused.launches += 1
        structured_feature_fused.last_schedule = sched
        if out is not None:
            return out
        return dest.reshape(*batch_shape, cols)


structured_feature_fused.launches = 0
structured_feature_fused.last_schedule = None
