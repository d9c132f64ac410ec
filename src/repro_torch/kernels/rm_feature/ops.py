"""Public wrappers of the rm_feature kernels (port of
``repro.kernels.rm_feature.ops``).

``rm_feature_fused`` applies a whole packed feature map in ONE launch of
``csrc/rm_feature.cu`` (kernel B1, on the tensor cores; it reads the packed
``w [kdeg, F, d]`` as it is, so nothing is packed per call);
``apply_feature_map`` is the same path on a map object. ``rm_feature_bucket`` applies one degree bucket in one
launch of ``csrc/rm_feature_bucket.cu`` (kernel B9), and
``apply_feature_map_bucketed`` is the per-bucket path built on it: one
launch a degree bucket plus a concatenate, the baseline the fused path is
compared with. Dispatch follows the tensor: a CPU tensor takes the plain
PyTorch version (``ref.rm_feature_fused_ref``, ``ref.rm_feature_bucket_ref``);
a CUDA tensor launches the kernel or raises — there is no fallback. Both
kernels mask the ragged edges themselves, so the wrappers pad nothing.
``rm_feature_fused.launches`` and ``rm_feature_bucket.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import pick_feature_tiles
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
_BUCKET_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


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


def rm_feature_bucket(
    x: torch.Tensor,          # [..., d] fp32 or bf16
    omega: torch.Tensor,      # [count * degree, d] feature-major rows
    degree: int,
    scale: float,
) -> torch.Tensor:            # [..., count] fp32
    """Apply one degree bucket in one launch: feature i is ``scale *
    prod_{j < degree} <omega[i * degree + j], x>``. On a CUDA tensor
    ``omega`` must have x's dtype.

    Raises:
        ValueError: ``degree < 1`` (the reference dies there on a division
            by zero), omega's rows are not a multiple of ``degree`` or its
            width is not x's, or the operands are on another device or not
            contiguous.
        NotImplementedError: called with inputs that require grad.
    """
    if degree < 1:
        raise ValueError(f"rm_feature_bucket takes degree >= 1, got {degree}")
    if torch.is_grad_enabled() and (x.requires_grad or omega.requires_grad):
        raise NotImplementedError(
            "rm_feature_bucket has no backward (the per-bucket path is a "
            "baseline for featurizing, not for training)")
    batch_shape = x.shape[:-1]
    d = x.shape[-1]
    if omega.shape[0] % degree or omega.shape[-1] != d:
        raise ValueError(f"omega {tuple(omega.shape)} is not count * "
                         f"{degree} rows of width {d}")
    count = omega.shape[0] // degree
    xf = x.reshape(-1, d)
    b = xf.shape[0]
    if b == 0 or count == 0:
        return torch.zeros((*batch_shape, count), dtype=torch.float32,
                           device=x.device)
    if x.device.type == "cpu":
        return rm_feature_bucket_ref(xf, omega, degree,
                                     scale).reshape(*batch_shape, count)
    if x.device.type != "cuda":
        raise ValueError(f"rm_feature_bucket runs on cpu or cuda tensors, "
                         f"got {x.device}")
    _check_bucket_operands(xf, omega)
    out = torch.empty((b, count), dtype=torch.float32, device=x.device)
    launch = _bucket_library()
    err = launch(xf.data_ptr(), omega.data_ptr(), out.data_ptr(), b, count, d,
                 degree, float(scale), _DTYPE_CODE[xf.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_feature_bucket kernel launch failed: CUDA "
                           f"error {err}")
    rm_feature_bucket.launches += 1
    return out.reshape(*batch_shape, count)


rm_feature_bucket.launches = 0


def apply_feature_map(fmap, x: torch.Tensor, *, precision=None
                      ) -> torch.Tensor:
    """``RMFeatureMap.apply`` as a function: the whole map in ONE launch of
    kernel B1 (``core.plan.apply_plan``)."""
    from repro_torch.core.plan import apply_plan

    return apply_plan(fmap.plan, fmap.omegas, x, precision=precision)


def apply_feature_map_bucketed(fmap, x: torch.Tensor) -> torch.Tensor:
    """The per-bucket path: the H0/1 block and the const column as exact
    fills, then one launch of kernel B9 a degree bucket, concatenated in
    the fused path's column order. x enters the kernel in its own dtype;
    each bucket's omega rows are cast to it (lossless: they are +-1)."""
    from repro_torch.core.plan import prefix_columns

    plan = fmap.plan
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, plan.input_dim)
    feats = prefix_columns(plan, xf.float(), xf.dtype)
    for deg, scale, omega in zip(plan.degrees, plan.scales,
                                 fmap.bucket_omegas()):
        feats.append(rm_feature_bucket(xf, omega.to(xf.dtype), deg,
                                       float(scale)))
    z = torch.cat(feats, dim=-1)
    return z.reshape(*batch_shape, z.shape[-1])
