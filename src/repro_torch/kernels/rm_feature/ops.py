"""Public wrapper of the rm_feature kernel (port of
``repro.kernels.rm_feature.ops.rm_feature_fused``).

``rm_feature_fused`` applies a whole packed feature map in ONE launch of
``csrc/rm_feature.cu``. Dispatch follows the tensor: a CPU tensor takes the
plain PyTorch version (``ref.rm_feature_fused_ref``); a CUDA tensor
launches the kernel or raises — there is no fallback. The kernel masks the
ragged edges itself (rows past B load as zero and are never stored; a
column past F acts as a padding column of degree 0 and scale 0), so the
wrapper pads nothing. ``rm_feature_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

__all__ = ["rm_feature_fused"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library():
    from repro_torch.kernels import _build

    lib = _build.load("rm_feature")
    fn = lib.rm_feature_fused_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(xf, w, col_deg, col_scale):
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"rm_feature kernel takes fp32 or bf16 x, got "
                        f"{xf.dtype}")
    if w.dtype != xf.dtype:
        raise TypeError(f"w must match x's dtype {xf.dtype}, got {w.dtype}")
    if col_deg.dtype != torch.int32 or col_scale.dtype != torch.float32:
        raise TypeError("col_deg must be int32 and col_scale float32, got "
                        f"{col_deg.dtype} and {col_scale.dtype}")
    f = w.shape[1]
    if w.shape[2] != xf.shape[1] or col_deg.shape != (f,) or \
            col_scale.shape != (f,):
        raise ValueError(
            f"shape mismatch: x {tuple(xf.shape)}, w {tuple(w.shape)}, "
            f"col_deg {tuple(col_deg.shape)}, "
            f"col_scale {tuple(col_scale.shape)}")
    for name, t in (("x", xf), ("w", w), ("col_deg", col_deg),
                    ("col_scale", col_scale)):
        if t.device != xf.device:
            raise ValueError(f"{name} is on {t.device}, x on {xf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rm_feature_fused(
    x: torch.Tensor,          # [..., d] fp32 or bf16
    w: torch.Tensor,          # [max_degree, F, d] packed (pack_omegas)
    col_deg: torch.Tensor,    # [F] int32 per-column product depth
    col_scale: torch.Tensor,  # [F] fp32 per-column scale
) -> torch.Tensor:            # [..., F] fp32
    """Apply a packed feature map: one kernel launch for every column."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "rm_feature_fused has no backward yet (serving only; the "
            "training slice is queued in ROADMAP.md)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    k, f, _ = w.shape
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    # Shapes with nothing to compute return their arithmetic result: no
    # rows or no columns give an empty output, and with no degree slots
    # every column is an empty product (1) times its scale.
    if b == 0 or f == 0:
        return torch.zeros((*batch_shape, f), dtype=torch.float32,
                           device=x.device)
    if k == 0:
        out = col_scale.to(device=x.device, dtype=torch.float32)
        return out.expand(b, f).clone().reshape(*batch_shape, f)
    if x.device.type == "cpu":
        return rm_feature_fused_ref(xf, w, col_deg,
                                    col_scale).reshape(*batch_shape, f)
    if x.device.type != "cuda":
        raise ValueError(f"rm_feature_fused runs on cpu or cuda tensors, "
                         f"got {x.device}")
    _check_cuda_operands(xf, w, col_deg, col_scale)
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    launch = _library()
    err = launch(xf.data_ptr(), w.data_ptr(), col_deg.data_ptr(),
                 col_scale.data_ptr(), out.data_ptr(), b, f, d, k,
                 _DTYPE_CODE[xf.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_feature kernel launch failed: CUDA error "
                           f"{err}")
    rm_feature_fused.launches += 1
    return out.reshape(*batch_shape, f)


rm_feature_fused.launches = 0
