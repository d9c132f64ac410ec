"""Public wrapper of the ctr kernel (port of
``repro.kernels.ctr_feature.ops.ctr_feature_fused``).

``ctr_feature_fused`` applies the whole complex-bucket section of a
``CtrPlan`` (the packed layout of ``ctr.plan.pack_ctr``) in ONE launch of
``csrc/ctr_feature.cu`` (kernel B7, on the tensor cores), writing ``[Re |
Im]`` straight into one ``[B, 2 Fc]`` output. Dispatch follows the tensor:
a CPU tensor takes the plain PyTorch version
(``ctr.ref.ctr_feature_fused_ref``); a CUDA tensor launches the kernel or
raises — there is no fallback. The kernel
masks the ragged row and column edges itself, so the wrapper pads nothing.
``ctr_feature_fused.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.ctr.ref import ctr_feature_fused_ref

__all__ = ["ctr_feature_fused"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    from repro_torch.kernels import _build

    fn = _build.load("ctr_feature").ctr_feature_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(xf, wr, wi, col_deg, col_scale):
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"ctr kernel takes fp32 or bf16 x, got {xf.dtype}")
    for name, t in (("wr", wr), ("wi", wi)):
        if t.dtype != xf.dtype:
            raise TypeError(f"{name} must match x's dtype {xf.dtype}, got "
                            f"{t.dtype}")
    if col_deg.dtype != torch.int32 or col_scale.dtype != torch.float32:
        raise TypeError("col_deg must be int32 and col_scale float32, got "
                        f"{col_deg.dtype} and {col_scale.dtype}")
    fc = wr.shape[1]
    if wi.shape != wr.shape or wr.shape[2] != xf.shape[1] or \
            col_deg.shape != (fc,) or col_scale.shape != (fc,):
        raise ValueError(
            f"shape mismatch: x {tuple(xf.shape)}, wr {tuple(wr.shape)}, "
            f"wi {tuple(wi.shape)}, col_deg {tuple(col_deg.shape)}, "
            f"col_scale {tuple(col_scale.shape)}")
    for name, t in (("x", xf), ("wr", wr), ("wi", wi), ("col_deg", col_deg),
                    ("col_scale", col_scale)):
        if t.device != xf.device:
            raise ValueError(f"{name} is on {t.device}, x on {xf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ctr_feature_fused(
    x: torch.Tensor,          # [..., d] fp32 or bf16
    wr: torch.Tensor,         # [max_degree, Fc, d] (pack_ctr)
    wi: torch.Tensor,         # [max_degree, Fc, d]
    col_deg: torch.Tensor,    # [Fc] int32 per-column product depth
    col_scale: torch.Tensor,  # [Fc] fp32 per-complex-column scale
) -> torch.Tensor:            # [..., 2 Fc] fp32, [Re | Im]
    """Apply the packed complex buckets: one kernel launch for every
    column."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wr, wi)):
        raise NotImplementedError(
            "ctr_feature_fused has no backward: the reference defines no "
            "VJP for kernel B7, and two-launch training is an open "
            "question (ROADMAP.md queue C)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    k, fc, _ = wr.shape
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    # Shapes with nothing to compute return their arithmetic result: no
    # rows or columns give an empty output, and with no slots every column
    # is the empty product (1, 0) times its scale.
    if b == 0 or fc == 0:
        return torch.zeros((*batch_shape, 2 * fc), dtype=torch.float32,
                           device=x.device)
    if k == 0:
        sc = col_scale.to(device=x.device, dtype=torch.float32)
        out = torch.cat([sc, torch.zeros_like(sc)]).expand(b, 2 * fc)
        return out.clone().reshape(*batch_shape, 2 * fc)
    if x.device.type == "cpu":
        return ctr_feature_fused_ref(xf, wr, wi, col_deg,
                                     col_scale).reshape(*batch_shape, 2 * fc)
    if x.device.type != "cuda":
        raise ValueError(f"ctr_feature_fused runs on cpu or cuda tensors, "
                         f"got {x.device}")
    _check_cuda_operands(xf, wr, wi, col_deg, col_scale)
    out = torch.empty((b, 2 * fc), dtype=torch.float32, device=x.device)
    err = _library()(xf.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                     col_deg.data_ptr(), col_scale.data_ptr(), out.data_ptr(),
                     b, fc, d, k, _DTYPE_CODE[xf.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctr_feature kernel launch failed: CUDA error "
                           f"{err}")
    ctr_feature_fused.launches += 1
    return out.reshape(*batch_shape, 2 * fc)


ctr_feature_fused.launches = 0
