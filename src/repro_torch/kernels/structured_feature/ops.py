"""Public wrapper of the structured kernel (port of
``repro.kernels.structured_feature.ops.structured_feature_fused``).

``structured_feature_fused`` applies the whole padded random section of a
``StructuredPlan`` (the packed sign tensors of
``structured.plan.pack_structured``) in ONE launch of
``csrc/structured_feature.cu`` (kernel B8). x comes at its true width ``d
<= d_pad``: the kernel reads columns past d as zero, the plain version
pads them, so no padded copy is made on the card. Dispatch follows the
tensor: a CPU tensor takes the plain PyTorch version
(``structured.ref.structured_feature_fused_ref``); a CUDA tensor launches
the kernel or raises — there is no fallback. The kernel masks the ragged
row edge itself. ``structured_feature_fused.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_structured_d_pad,
    pick_structured_rows,
)
from repro_torch.structured.ref import structured_feature_fused_ref

__all__ = ["structured_feature_fused"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def structured_feature_fused(
    x: torch.Tensor,          # [..., d] fp32 or bf16, d <= d_pad
    d1: torch.Tensor,         # [max_degree, S, d_pad] (pack_structured)
    d2: torch.Tensor,         # [max_degree, S, d_pad]
    col_deg: torch.Tensor,    # [S * d_pad] int32 per-column product depth
    col_scale: torch.Tensor,  # [S * d_pad] fp32 per-column scale
) -> torch.Tensor:            # [..., S * d_pad] fp32
    """Apply the packed structured stacks: one kernel launch for every
    column.

    Raises:
        ValueError: d_pad is not a power of two or exceeds
            ``kernels.common.STRUCTURED_MAX_DPAD``, or x is wider than it
            (on either device, so the CPU path refuses what the kernel
            would).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, d1, d2)):
        raise NotImplementedError(
            "structured_feature_fused has no backward (the signs are model "
            "constants; serving only)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    k, s, m = d1.shape
    check_structured_d_pad(m)
    if not 1 <= d <= m:
        raise ValueError(f"x's width {d} must lie in [1, d_pad={m}]")
    cols = s * m
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    # Shapes with nothing to compute return their arithmetic result: no
    # rows or stacks give an empty output, and with no slots every column
    # is the empty product 1 times its scale.
    if b == 0 or s == 0:
        return torch.zeros((*batch_shape, cols), dtype=torch.float32,
                           device=x.device)
    if k == 0:
        out = col_scale.to(device=x.device, dtype=torch.float32)
        return out.expand(b, cols).clone().reshape(*batch_shape, cols)
    if x.device.type == "cpu":
        return structured_feature_fused_ref(
            xf, d1, d2, col_deg, col_scale).reshape(*batch_shape, cols)
    if x.device.type != "cuda":
        raise ValueError(f"structured_feature_fused runs on cpu or cuda "
                         f"tensors, got {x.device}")
    _check_cuda_operands(xf, d1, d2, col_deg, col_scale)
    rows = pick_structured_rows(m, b, s)
    out = torch.empty((b, cols), dtype=torch.float32, device=x.device)
    launch = _library()
    err = launch(xf.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                 col_deg.data_ptr(), col_scale.data_ptr(), out.data_ptr(), b,
                 d, s, m.bit_length() - 1, rows, k, _DTYPE_CODE[xf.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"structured_feature kernel launch failed: CUDA "
                           f"error {err}")
    structured_feature_fused.launches += 1
    return out.reshape(*batch_shape, cols)


structured_feature_fused.launches = 0
