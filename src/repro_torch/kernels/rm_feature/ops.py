"""Public wrappers of the rm_feature kernels (port of
``repro.kernels.rm_feature.ops``).

``rm_feature_fused`` applies a whole packed feature map in ONE launch of
``csrc/rm_feature.cu`` (kernel B1, on the tensor cores; it reads the packed
``w [kdeg, F, d]`` as it is, so nothing is packed per call);
``apply_feature_map`` is the same path on a map object.
``rm_feature_bucket`` applies one degree bucket in one launch of
``csrc/rm_feature_bucket.cu`` (kernel B9, on the tensor cores; it reads the
bucket's feature-major omega rows in place), into a new ``[..., count]``
tensor or into given columns of a map; ``apply_feature_map_bucketed`` is
the per-bucket path built on it, the baseline the fused path is compared
with: the map allocated once, its prefix columns written in place, then
one launch a degree bucket writing that bucket's columns. Dispatch follows
the tensor: a CPU tensor takes the plain PyTorch version
(``ref.rm_feature_fused_ref``, ``ref.rm_feature_bucket_ref``); a CUDA
tensor launches the kernel or raises — there is no fallback. Both kernels
mask the ragged edges themselves, so the wrappers pad nothing.
``rm_feature_fused.launches`` and ``rm_feature_bucket.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import bucket_schedule, pick_feature_tiles
from repro_torch.kernels.rm_feature.ref import (
    rm_feature_bucket_ref,
    rm_feature_fused_ref,
)

__all__ = [
    "rm_feature_fused",
    "rm_feature_bucket",
    "apply_feature_map",
    "apply_feature_map_bucketed",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BUCKET_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 4 + [ctypes.c_float]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_BUCKET_KERNEL_CODE = {"chain": 0, "tile": 1}


@functools.lru_cache(maxsize=None)
def _library():
    from repro_torch.kernels import _build

    lib = _build.load("rm_feature")
    fn = lib.rm_feature_fused_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bucket_library():
    from repro_torch.kernels import _build

    fn = _build.load("rm_feature_bucket").rm_feature_bucket_launch
    fn.argtypes = _BUCKET_ARGTYPES
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
            "rm_feature_fused has no backward: the reference defines no "
            "VJP for kernel B1, and two-launch training is an open "
            "question (ROADMAP.md queue C)")
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
                 *pick_feature_tiles(b, f, d, xf.element_size()),
                 _DTYPE_CODE[xf.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_feature kernel launch failed: CUDA error "
                           f"{err}")
    rm_feature_fused.launches += 1
    return out.reshape(*batch_shape, f)


rm_feature_fused.launches = 0


def _check_bucket_operands(xf, omega):
    if xf.dtype not in _DTYPE_CODE:
        raise TypeError(f"rm_feature_bucket kernel takes fp32 or bf16 x, got "
                        f"{xf.dtype}")
    if omega.dtype != xf.dtype:
        raise TypeError(f"omega must match x's dtype {xf.dtype}, got "
                        f"{omega.dtype}")
    if omega.device != xf.device:
        raise ValueError(f"omega is on {omega.device}, x on {xf.device}")
    for name, t in (("x", xf), ("omega", omega)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_bucket_out(out, xf, col, count):
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError(f"out must be a 2-D fp32 map, got {out.dtype} "
                        f"{tuple(out.shape)}")
    if out.device != xf.device:
        raise ValueError(f"out is on {out.device}, x on {xf.device}")
    if out.shape[0] != xf.shape[0] or col < 0 or \
            out.shape[1] < col + count or out.stride(1) != 1 or \
            out.stride(0) < out.shape[1]:
        raise ValueError(
            f"out {tuple(out.shape)} (strides {out.stride()}) has no "
            f"{xf.shape[0]} rows of columns [{col}, {col + count})")


def _bucket_launch(xf, omega, out, col, degree, scale, sched):
    """One launch of B9 on ``xf [B, d]`` and ``omega [count * degree, d]``
    (CUDA, checked), writing columns ``[col, col + count)`` of the fp32 map
    ``out`` (rows at its row stride) under the schedule ``sched``
    (``kernels.common.bucket_schedule``)."""
    b, d = xf.shape
    count = omega.shape[0] // degree
    err = _bucket_library()(
        xf.data_ptr(), omega.data_ptr(),
        out.data_ptr() + col * out.element_size(), out.stride(0),
        b, count, d, degree, float(scale), _BUCKET_KERNEL_CODE[sched.kernel],
        sched.ct_per_warp, sched.runs, max(sched.buffers, 1),
        _DTYPE_CODE[xf.dtype],
        torch.cuda.current_stream(xf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_feature_bucket kernel launch failed: CUDA "
                           f"error {err}")
    rm_feature_bucket.launches += 1


def rm_feature_bucket(
    x: torch.Tensor,          # [..., d] fp32 or bf16
    omega: torch.Tensor,      # [count * degree, d] feature-major rows
    degree: int,
    scale: float,
    *,
    out: torch.Tensor = None,  # [B, >= col + count] fp32 map
    col: int = 0,
) -> torch.Tensor:            # [..., count] fp32
    """Apply one degree bucket in one launch: feature i is ``scale *
    prod_{j < degree} <omega[i * degree + j], x>``. On a CUDA tensor
    ``omega`` must have x's dtype.

    With ``out`` (a 2-D fp32 map on x's device, one row for each row of
    x, unit column stride) the bucket is written in place into its columns
    ``[col, col + count)`` and those columns are returned (a view of
    ``out``); otherwise into a new tensor.

    Raises:
        ValueError: ``degree < 1`` (the reference dies there on a division
            by zero), omega's rows are not a multiple of ``degree`` or its
            width is not x's, ``out`` has not the rows or the columns, or
            the operands are on another device or not contiguous.
        TypeError: a dtype the kernel does not take.
        NotImplementedError: called with inputs that require grad.
    """
    if degree < 1:
        raise ValueError(f"rm_feature_bucket takes degree >= 1, got {degree}")
    if torch.is_grad_enabled() and (x.requires_grad or omega.requires_grad):
        raise NotImplementedError(
            "rm_feature_bucket has no backward: the reference defines no "
            "VJP for kernel B9 (the per-bucket path is a baseline for "
            "featurizing, not for training; ROADMAP.md queue C)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    if omega.shape[0] % degree or omega.shape[-1] != d:
        raise ValueError(f"omega {tuple(omega.shape)} is not count * "
                         f"{degree} rows of width {d}")
    count = omega.shape[0] // degree
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    if out is not None:
        _check_bucket_out(out, xf, col, count)
        target = out[:, col: col + count]
    if b == 0 or count == 0:
        if out is None:
            return torch.zeros((*batch_shape, count), dtype=torch.float32,
                               device=x.device)
        return target.reshape(*batch_shape, count)
    if x.device.type == "cpu":
        z = rm_feature_bucket_ref(xf, omega, degree, scale)
        if out is None:
            return z.reshape(*batch_shape, count)
        target.copy_(z)
        return target.reshape(*batch_shape, count)
    if x.device.type != "cuda":
        raise ValueError(f"rm_feature_bucket runs on cpu or cuda tensors, "
                         f"got {x.device}")
    _check_bucket_operands(xf, omega)
    if out is None:
        out, col = torch.empty((b, count), dtype=torch.float32,
                               device=x.device), 0
        target = out
    _bucket_launch(xf, omega, out, col, degree, scale,
                   bucket_schedule(b, count, d, degree, xf.element_size()))
    return target.reshape(*batch_shape, count)


rm_feature_bucket.launches = 0


def apply_feature_map(fmap, x: torch.Tensor, *, precision=None
                      ) -> torch.Tensor:
    """``RMFeatureMap.apply`` as a function: the whole map in ONE launch of
    kernel B1 (``core.plan.apply_plan``)."""
    from repro_torch.core.plan import apply_plan

    return apply_plan(fmap.plan, fmap.omegas, x, precision=precision)


def apply_feature_map_bucketed(fmap, x: torch.Tensor) -> torch.Tensor:
    """The per-bucket path, in place: the map ``[..., output_dim]`` (fp32)
    is allocated once, the H0/1 block and the const column are exact fills
    written into their columns, then each degree bucket's columns come from
    one launch of kernel B9 (``rm_feature_bucket(..., out=, col=)``), in the
    fused path's column order; nothing is concatenated. x enters the kernel
    in its own dtype; each bucket's omega rows are cast to it (lossless:
    they are +-1)."""
    from repro_torch.core.plan import prefix_columns

    plan = fmap.plan
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, plan.input_dim)
    z = torch.empty((xf.shape[0], plan.output_dim), dtype=torch.float32,
                    device=x.device)
    off = 0
    for col in prefix_columns(plan, xf.float(), xf.dtype):
        z[:, off: off + col.shape[1]] = col
        off += col.shape[1]
    for deg, scale, omega in zip(plan.degrees, plan.scales,
                                 fmap.bucket_omegas()):
        rm_feature_bucket(xf, omega.to(xf.dtype), deg, float(scale), out=z,
                          col=off)
        off += omega.shape[0] // deg
    return z.reshape(*batch_shape, plan.output_dim)
