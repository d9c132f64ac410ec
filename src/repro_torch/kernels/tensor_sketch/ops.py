"""Public wrapper of the tensor_sketch kernel (port of
``repro.kernels.tensor_sketch.ops.tensor_sketch_fused``).

``tensor_sketch_fused`` applies the whole sketch-block section of a
``SketchPlan`` (the packed frequency-domain layout of
``sketch.plan.pack_sketch``) in ONE launch of ``csrc/tensor_sketch.cu``
(kernel B6, on the tensor cores; its warps and output groups come from
``kernels.common.sketch_schedule``, memoized per shape, and its work items
live in a device array made once per schedule). Dispatch follows the
tensor: a CPU tensor takes the plain PyTorch version
(``sketch.ref.tensor_sketch_fused_ref``); a CUDA tensor launches the kernel
or raises — there is no fallback. The kernel masks the ragged row edge
itself, so the wrapper pads nothing.
``tensor_sketch_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels.common import sketch_schedule
from repro_torch.sketch.ref import tensor_sketch_fused_ref

__all__ = ["tensor_sketch_fused"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library():
    from repro_torch.kernels import _build

    fn = _build.load("tensor_sketch").tensor_sketch_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _items_on(items, device):
    """A schedule's items as the int32 device array the kernel reads (made
    once per schedule and device)."""
    return torch.tensor(items, dtype=torch.int32, device=device)


def _check_cuda_operands(xf, wr, wi, col_deg, mr, mi, col_scale, starts):
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"tensor_sketch kernel takes fp32 or bf16 x, got "
                        f"{xf.dtype}")
    for name, t in (("wr", wr), ("wi", wi), ("mr", mr), ("mi", mi)):
        if t.dtype != xf.dtype:
            raise TypeError(f"{name} must match x's dtype {xf.dtype}, got "
                            f"{t.dtype}")
    if col_deg.dtype != torch.int32 or col_scale.dtype != torch.float32:
        raise TypeError("col_deg must be int32 and col_scale float32, got "
                        f"{col_deg.dtype} and {col_scale.dtype}")
    k, fs, d = wr.shape
    if wi.shape != wr.shape or xf.shape[1] != d or mr.shape != (fs, fs) \
            or mi.shape != (fs, fs) or col_deg.shape != (fs,) \
            or col_scale.shape != (fs,):
        raise ValueError(
            f"shape mismatch: x {tuple(xf.shape)}, wr {tuple(wr.shape)}, "
            f"wi {tuple(wi.shape)}, mr {tuple(mr.shape)}, "
            f"mi {tuple(mi.shape)}, col_deg {tuple(col_deg.shape)}, "
            f"col_scale {tuple(col_scale.shape)}")
    if starts[-1] != fs:
        raise ValueError(f"degree blocks must end at Fs={fs}, got "
                         f"{tuple(starts)}")
    for name, t in (("x", xf), ("wr", wr), ("wi", wi), ("col_deg", col_deg),
                    ("mr", mr), ("mi", mi), ("col_scale", col_scale)):
        if t.device != xf.device:
            raise ValueError(f"{name} is on {t.device}, x on {xf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tensor_sketch_fused(
    x: torch.Tensor,          # [..., d] fp32 or bf16
    wr: torch.Tensor,         # [max_degree, Fs, d] (pack_sketch)
    wi: torch.Tensor,         # [max_degree, Fs, d]
    col_deg: torch.Tensor,    # [Fs] int32 per-column product depth
    mr: torch.Tensor,         # [Fs, Fs] block-diagonal inverse DFT, real
    mi: torch.Tensor,         # [Fs, Fs] imag
    col_scale: torch.Tensor,  # [Fs] fp32 per-column scale
    blocks: Sequence[int],    # SketchPlan.block_starts(): (0, ..., Fs)
) -> torch.Tensor:            # [..., Fs] fp32
    """Apply the packed sketch blocks: one kernel launch for every column.

    ``blocks`` are the degree blocks on whose diagonal ``mr``/``mi`` live;
    the kernel multiplies by those diagonal blocks only, the plain version
    by the whole dense matrices (so a wrong bound shows in a comparison).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wr, wi, mr, mi)):
        raise NotImplementedError(
            "tensor_sketch_fused has no backward: the reference defines "
            "no VJP for kernel B6, and two-launch training is an open "
            "question (ROADMAP.md queue C)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    k, fs, _ = wr.shape
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    if b == 0 or fs == 0:
        return torch.zeros((*batch_shape, fs), dtype=torch.float32,
                           device=x.device)
    if x.device.type == "cpu":
        return tensor_sketch_fused_ref(xf, wr, wi, col_deg, mr, mi,
                                       col_scale).reshape(*batch_shape, fs)
    if x.device.type != "cuda":
        raise ValueError(f"tensor_sketch_fused runs on cpu or cuda tensors, "
                         f"got {x.device}")
    starts = tuple(int(s) for s in blocks)
    _check_cuda_operands(xf, wr, wi, col_deg, mr, mi, col_scale, starts)
    sched = sketch_schedule(starts, b, d)
    out = torch.empty((b, fs), dtype=torch.float32, device=x.device)
    items = _items_on(sched.items, x.device)
    err = _library()(
        xf.data_ptr(), wr.data_ptr(), wi.data_ptr(), col_deg.data_ptr(),
        mr.data_ptr(), mi.data_ptr(), col_scale.data_ptr(), out.data_ptr(),
        items.data_ptr(), sched.n_items, sched.group, b, fs, d, k, sched.warps,
        _DTYPE_CODE[xf.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tensor_sketch kernel launch failed: CUDA error "
                           f"{err}")
    tensor_sketch_fused.launches += 1
    return out.reshape(*batch_shape, fs)


tensor_sketch_fused.launches = 0
