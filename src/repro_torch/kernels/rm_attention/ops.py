"""Public RM attention ops (port of ``repro.kernels.rm_attention.ops``).

Two-launch ops, over features ``Z`` computed beforehand by any estimator:

* ``rm_attention_causal`` — pass A (per-chunk key states) and their
  exclusive prefix sums in PyTorch, then pass B in one launch of
  ``csrc/rm_attention_chunked.cu`` (kernel B5, ``rm_attention_chunked``).
* ``rm_attention_noncausal``, ``rm_attention_decode_step`` and
  ``rm_attention_prefill_final_state`` — plain PyTorch einsums, as in the
  reference (they were never TPU kernels).

Fused ops, over RAW pre-scaled q/k rows plus the packed RM layout (``w
[max_degree, F, d]`` and per-column degrees and scales from
``core.plan``); featurization happens inside the attention kernels, so the
``O(T * F)`` Z tensors never reach device memory:

* ``rm_attention_fused_causal`` — causal outputs (training forward).
* ``rm_attention_fused_prefill`` — causal outputs AND the decode state
  ``(S, n)`` from the same call of ``csrc/rm_fused_attention.cu`` (kernel
  B2, ``rm_fused_causal``: three kernels on the tensor cores, each chunk's
  own key state, their prefix, the outputs; one counted launch).
* ``rm_attention_fused_noncausal`` — bidirectional outputs (the encoder):
  the key state ``(S, n)`` of the whole sequence in one launch of
  ``csrc/rm_fused_state.cu`` (kernel B3, ``rm_fused_state``), then the
  queries against it in one launch of ``csrc/rm_fused_apply.cu`` (kernel
  B4, ``rm_fused_apply``).
* ``rm_attention_fused_decode_step`` — ONE rm_feature launch for the new
  q and k rows together, then the O(1) state update in PyTorch.

Dispatch follows the tensor: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches ``csrc/rm_fused_attention.cu`` (B2),
``csrc/rm_attention_chunked.cu`` (B5), ``csrc/rm_fused_state.cu`` (B3) or
``csrc/rm_fused_apply.cu`` (B4), or raises. ``rm_fused_causal.launches``,
``rm_attention_chunked.launches``, ``rm_fused_state.launches`` and
``rm_fused_apply.launches`` count kernel launches.

Gradients (the reference's ``jax.custom_vjp`` ops). ``rm_attention_causal``
(B5), ``rm_attention_fused_causal`` (B2) and ``rm_attention_fused_noncausal``
(B3 + B4) are ``torch.autograd.Function``s: the forward launches the
kernel (one counted launch; B3 and B4 one each), the backward recomputes
and differentiates the port of the XLA formulation the reference's
backward differentiates (``_causal_chunked_formulation``,
``_fused_causal_formulation``, ``_fused_noncausal_formulation``) in fp32
PyTorch ops and launches no RM kernel. The serving-only prefill and the
raw kernel wrappers (``rm_fused_causal``, ``rm_attention_chunked``,
``rm_fused_state``, ``rm_fused_apply``) have no VJP, as in the reference,
and raise with autograd recording on a tensor that requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (
    PLAIN_DEVICES,
    causal_schedule,
    chunked_schedule,
    noncausal_schedule,
)
from repro_torch.kernels.rm_attention.noncausal import (
    NoncausalPack,
    pack_noncausal,
)
from repro_torch.kernels.rm_attention.ref import (
    causal_chunked,
    causal_chunked_ref,
    featurize_ref4,
    rm_attention_chunked_ref,
    rm_attention_decode_ref,
    rm_attention_noncausal_ref,
    rm_attention_prefill_final_state,
    rm_fused_apply_ref,
    rm_fused_causal_ref,
    rm_fused_noncausal_ref,
    rm_fused_state_ref,
)
from repro_torch.kernels.rm_feature.ops import rm_feature_fused
from repro_torch.obs.trace import kernel_scope as _kernel_scope

__all__ = [
    "rm_attention_chunked",
    "rm_attention_causal",
    "rm_attention_decode_step",
    "rm_attention_noncausal",
    "rm_attention_prefill_final_state",
    "rm_attention_fused_causal",
    "rm_attention_fused_prefill",
    "rm_attention_fused_noncausal",
    "rm_attention_fused_decode_step",
    "rm_fused_causal",
    "rm_fused_state",
    "rm_fused_apply",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SCHED = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = ((ctypes.c_void_p,) * 12
             + (_SCHED, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p))
_CHUNKED_ARGTYPES = ((ctypes.c_void_p,) * 6
                     + (_SCHED, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                        ctypes.c_void_p))
_STATE_ARGTYPES = ((ctypes.c_void_p,) * 12
                   + (_SCHED, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
_APPLY_ARGTYPES = ((ctypes.c_void_p,) * 9
                   + (_SCHED, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p))


@functools.lru_cache(maxsize=None)
def _launcher(library: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``library`` (built on first use), its
    argument types set once: a call's host time goes to the launch."""
    from repro_torch.kernels import _build

    fn = getattr(_build.load(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def rm_attention_chunked(zq, zk, v, s_prev, n_prev, *, chunk: int,
                         eps: float) -> torch.Tensor:
    """Pass B of the causal attention (kernel B5) — the kernel on a CUDA
    tensor, ``ref.rm_attention_chunked_ref`` on a CPU tensor.

    ``zq, zk [BH, T, F]`` fp32 or bf16 with T a multiple of ``chunk``,
    ``v [BH, T, dv]``, ``s_prev [BH, T/C, F, dv]``, ``n_prev [BH, T/C, F]``
    (``ref.chunk_states``) -> ``out [BH, T, dv]`` fp32. The kernel's
    query tiles and value groups are ``rm_attention_chunked.last_schedule``
    (``kernels.common.chunked_schedule``).
    """
    _no_grad_check("rm_attention_chunked", zq, zk, v, s_prev, n_prev)
    bh, t, f = zq.shape
    dv = v.shape[-1]
    dev = zq.device
    with _kernel_scope("rm_attention", x=zq, chunk=chunk):
        if dev.type in PLAIN_DEVICES:
            return rm_attention_chunked_ref(zq, zk, v, s_prev, n_prev,
                                            chunk=chunk, eps=eps)
        if dev.type != "cuda":
            raise ValueError(f"rm_attention_chunked runs on cpu, meta or cuda "
                             f"tensors, got {dev}")
        if zq.dtype not in _DTYPE_CODE or zk.dtype != zq.dtype:
            raise TypeError(f"zq and zk must share one of fp32/bf16, got "
                            f"{zq.dtype} and {zk.dtype}")
        n = t // chunk if chunk > 0 else 0
        if chunk < 1 or t % chunk or zk.shape != zq.shape or \
                v.shape[:2] != (bh, t) or s_prev.shape != (bh, n, f, dv) or \
                n_prev.shape != (bh, n, f):
            raise ValueError(
                f"shape mismatch: zq {tuple(zq.shape)}, zk {tuple(zk.shape)}, "
                f"v {tuple(v.shape)}, s_prev {tuple(s_prev.shape)}, n_prev "
                f"{tuple(n_prev.shape)}, chunk {chunk}")
        for name, x in (("zk", zk), ("v", v), ("s_prev", s_prev),
                        ("n_prev", n_prev)):
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, zq on {dev}")
        out = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
        if out.numel() == 0:
            return out
        # v and the prefixes enter in fp32 (a lossless upcast of bf16)
        zq, zk = zq.contiguous(), zk.contiguous()
        vf = v.float().contiguous()
        sp = s_prev.float().contiguous()
        np_ = n_prev.float().contiguous()
        sched = chunked_schedule(bh, t, f, dv, chunk, zq.element_size())
        err = _launcher("rm_attention_chunked", "rm_attention_chunked_launch",
                        _CHUNKED_ARGTYPES)(
            zq.data_ptr(), zk.data_ptr(), vf.data_ptr(), sp.data_ptr(),
            np_.data_ptr(), out.data_ptr(), _sched_array(sched), len(sched),
            float(eps), _DTYPE_CODE[zq.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rm_attention_chunked kernel launch failed: "
                               f"CUDA error {err}")
        rm_attention_chunked.launches += 1
        rm_attention_chunked.last_schedule = sched
        return out


rm_attention_chunked.launches = 0
rm_attention_chunked.last_schedule = None


def rm_attention_causal(
    zq: torch.Tensor,         # [B, H, T, F] features
    zk: torch.Tensor,         # [B, H, T, F] (padded keys already zeroed)
    v: torch.Tensor,          # [B, H, T, dv]
    *,
    chunk: int = 128,
    eps: float = 1e-4,
) -> torch.Tensor:            # [B, H, T, dv] fp32
    """Causal linear attention over precomputed features, O(T * F * (C +
    dv)) work: T padded to ``min(chunk, T)``, pass A and the exclusive
    prefixes in PyTorch, then ONE launch of kernel B5 (its plain version on
    a CPU tensor). Differentiable: the backward differentiates
    :func:`_causal_chunked_formulation` (reference ``_causal_pallas_bwd``)."""
    return _CausalChunked.apply(zq, zk, v, chunk, eps)


def _causal_chunked_formulation(zq, zk, v, chunk: int,
                                eps: float) -> torch.Tensor:
    """Port of the reference's ``_causal_chunked_jnp``: the chunked causal
    formulation its custom VJP differentiates (``_causal_pallas_bwd``). It is
    the port's backward formulation, not a fallback: the forward value on
    the card comes from kernel B5, and this runs only to be differentiated,
    on the card too, as the reference runs it in XLA on the TPU."""
    return causal_chunked_ref(zq, zk, v, chunk, eps)


def _vjp(label, formulation, inputs, needs, g):
    """Cotangents of ``formulation(*inputs)`` for the inputs ``needs``
    marks (``None`` for the others), recomputed with autograd in fp32: the
    cotangent is cast to fp32, as the reference casts it. The work runs in
    a ``torch.profiler`` span named ``label``, from which a profile reads
    the backward's device time apart from the kernels'."""
    with torch.profiler.record_function(label), torch.enable_grad():
        xs = [x.detach().requires_grad_(bool(need))
              for x, need in zip(inputs, needs)]
        out = formulation(*xs)
        wrt = [x for x, need in zip(xs, needs) if need]
        # an empty shape gives an output that no input reaches
        grads = iter(torch.autograd.grad(out, wrt, g.float(),
                                         allow_unused=True)
                     if wrt and out.requires_grad else [None] * len(wrt))
    result = []
    for x, need in zip(xs, needs):
        gx = next(grads) if need else None
        if need and gx is None:          # an input the output ignores
            gx = torch.zeros_like(x)
        result.append(gx)
    return tuple(result)


class _CausalChunked(torch.autograd.Function):
    """Kernel B5 under autograd (reference ``_causal_pallas``)."""

    @staticmethod
    def forward(ctx, zq, zk, v, chunk, eps):
        ctx.save_for_backward(zq, zk, v)
        ctx.chunk, ctx.eps = chunk, eps
        return causal_chunked(zq, zk, v, chunk, eps, rm_attention_chunked)

    @staticmethod
    def backward(ctx, g):
        grads = _vjp(
            "rm_attention_causal.backward",
            lambda zq, zk, v: _causal_chunked_formulation(
                zq, zk, v, ctx.chunk, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return grads + (None, None)


# O(1)-memory decode over precomputed features (rank-1 state update and
# two GEMVs; returns ``(out [B,H,dv], new_s, new_n)``) and bidirectional
# attention over precomputed features (two einsums each way): the
# reference's ops are plain code, so the port's are their plain versions
# under the reference's names.
rm_attention_decode_step = rm_attention_decode_ref
rm_attention_noncausal = rm_attention_noncausal_ref


def _columns(col_deg, col_scale, device) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Per-column degrees and scales as int32 / fp32 tensors on device
    (host arrays, as the reference passes them, are copied across)."""
    if not torch.is_tensor(col_deg):
        col_deg = torch.from_numpy(np.asarray(col_deg, dtype=np.int32))
    if not torch.is_tensor(col_scale):
        col_scale = torch.from_numpy(np.asarray(col_scale, dtype=np.float32))
    return (col_deg.to(device=device, dtype=torch.int32),
            col_scale.to(device=device, dtype=torch.float32))


def _no_grad_check(op: str, *tensors):
    """Raise where autograd records on a tensor that requires grad: the
    raw kernel wrappers and the prefill have no VJP (nor in the
    reference); the differentiable ops wrap the kernels in a
    ``torch.autograd.Function``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op} has no backward (a raw kernel wrapper or the "
            "serving-only prefill, as in the reference); differentiate "
            "rm_attention_causal, rm_attention_fused_causal or "
            "rm_attention_fused_noncausal")


def _check_cuda_operands(op: str, x, others, w):
    """Raise unless ``x`` and ``w`` share fp32 or bf16 and every tensor of
    ``others`` (name -> tensor) lies on ``x``'s device."""
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on cpu, meta or cuda tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"{op}: rows and w must share one of fp32/bf16, got "
                        f"{x.dtype} and {w.dtype}")
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{op}: {name} is on {t.device}, the rows on "
                             f"{x.device}")


def rm_fused_causal(q, k, v, kvalid, w, col_deg, col_scale, eps: float, *,
                    plain_chunk: int = 128):
    """The fused causal op (kernel B2): ``(out [B,H,T,dv], S [B,H,F,dv], n
    [B,H,F])`` — the kernel on a CUDA tensor, the plain version on a CPU
    tensor. ``plain_chunk`` is the plain version's chunk; the kernel takes
    64-position chunks and tiles F and d (``kernels.common.causal_schedule``,
    the call's plan in ``rm_fused_causal.last_schedule``), so it takes any
    shape the plain version does. One call counts one launch, though the
    kernel runs as three (chunk states, their prefix, the outputs) on each
    segment of at most 32 chunks (2048 positions). Beside its outputs a
    call allocates a scratch of chunk states, ``4 * B*H * min(ceil(T / 64),
    32) * F * (dv + 1)`` bytes (``last_schedule.scratch_bytes``): 5.4 MB at
    B*H 16, T 256, F 163, dv 128, and 43 MB there from T 2048 on."""
    _no_grad_check("rm_fused_causal", q, k, v, w)
    b, h, t, d = q.shape
    dv = v.shape[-1]
    kdeg, f, _ = w.shape
    dev = q.device
    if kvalid is None:
        kvalid = torch.ones((b, t), dtype=torch.float32, device=dev)
    # Shapes with nothing to compute return their arithmetic result: no
    # rows give empty outputs; with no feature columns every score and
    # denominator is 0, so out = 0 / clamp(0) = 0 and the state is empty.
    if b * h == 0 or t == 0 or f == 0:
        return (torch.zeros((b, h, t, dv), dtype=torch.float32, device=dev),
                torch.zeros((b, h, f, dv), dtype=torch.float32, device=dev),
                torch.zeros((b, h, f), dtype=torch.float32, device=dev))
    col_deg, col_scale = _columns(col_deg, col_scale, dev)
    with _kernel_scope("rm_attn_fused", x=q,
                       cost=dict(batch=b * h, t=t, d=d, depth=kdeg,
                                 f=f, dv=dv, itemsize=q.element_size())):
        if dev.type in PLAIN_DEVICES:
            return rm_fused_causal_ref(q, k, v, kvalid, w, col_deg, col_scale,
                                       chunk=plain_chunk, eps=eps)
        if dev.type != "cuda":
            raise ValueError(f"fused RM attention runs on cpu, meta or cuda "
                             f"tensors, got {dev}")
        if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
                w.dtype != q.dtype:
            raise TypeError(f"q, k and w must share one of fp32/bf16, got "
                            f"{q.dtype}, {k.dtype}, {w.dtype}")
        if k.shape != q.shape or v.shape[:3] != q.shape[:3] or \
                w.shape[2] != d or kvalid.shape != (b, t):
            raise ValueError(
                f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)}, w {tuple(w.shape)}, "
                f"kvalid {tuple(kvalid.shape)}")
        for name, x in (("k", k), ("v", v), ("kvalid", kvalid), ("w", w)):
            if x.device != dev:
                raise ValueError(f"{name} is on {x.device}, q on {dev}")
        bh = b * h
        sched = causal_schedule(bh, h, t, d, dv, f)
        tp = sched.t
        if kdeg == 0:
            # no degree slots: every column is its scale (an empty product)
            w = torch.zeros((1, f, d), dtype=w.dtype, device=dev)
            kdeg = 1

        def rows(x, width):
            # T padded to the chunk (padded keys carry kvalid 0), laid out as
            # contiguous [B*H, T, width]; a copy only where one is needed
            if tp != t:
                x = F.pad(x, (0, 0, 0, tp - t))
            return x.reshape(bh, tp, width).contiguous()

        # v enters in fp32 (a lossless upcast of bf16); the kernels read
        # kvalid [B, T] by batch row
        qf, kf, vf = rows(q, d), rows(k, d), rows(v.float(), dv)
        kval = kvalid.float()
        if tp != t:
            kval = F.pad(kval, (0, tp - t))
        kval = kval.contiguous()
        wc = w.contiguous()
        out = torch.empty((bh, tp, dv), dtype=torch.float32, device=dev)
        s = torch.empty((bh, f, dv), dtype=torch.float32, device=dev)
        n = torch.empty((bh, f), dtype=torch.float32, device=dev)
        # each chunk's own state, then (in place) the state before each chunk,
        # for one segment at a time
        ds = torch.empty((bh, sched.seg_chunks, f, dv), dtype=torch.float32,
                         device=dev)
        dn = torch.empty((bh, sched.seg_chunks, f), dtype=torch.float32,
                         device=dev)
        err = _launcher("rm_fused_attention", "rm_fused_causal_launch",
                        _ARGTYPES)(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), kval.data_ptr(),
            wc.data_ptr(), col_deg.data_ptr(), col_scale.data_ptr(),
            out.data_ptr(), s.data_ptr(), n.data_ptr(), ds.data_ptr(),
            dn.data_ptr(), _sched_array(sched), len(sched), kdeg, float(eps),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rm_fused_attention kernel launch failed: "
                               f"CUDA error {err}")
        rm_fused_causal.launches += 1
        rm_fused_causal.last_schedule = sched
        return (out.reshape(b, h, tp, dv)[:, :, :t], s.reshape(b, h, f, dv),
                n.reshape(b, h, f))


rm_fused_causal.launches = 0
rm_fused_causal.last_schedule = None


def rm_attention_fused_causal(
    q: torch.Tensor,          # [B, H, T, d]  pre-scaled queries (NOT features)
    k: torch.Tensor,          # [B, H, T, d]
    v: torch.Tensor,          # [B, H, T, dv]
    w: torch.Tensor,          # [max_degree, F, d] packed omegas
    col_deg,                  # [F] int32 tensor or host array
    col_scale,                # [F] fp32 tensor or host array
    *,
    kvalid: Optional[torch.Tensor] = None,   # [B, T] 1.0 real / 0.0 padded
    chunk: int = 128,
    eps: float = 1e-4,
) -> torch.Tensor:            # [B, H, T, dv] fp32
    """Fused causal RM attention: ``rm_attention_causal(Z(q), Z(k) *
    kvalid, v)`` without writing Z. ``chunk`` is read by the plain version
    (CPU tensors) and the backward; the kernel takes 64-position chunks.
    The chunk changes the order of the sums, not the result.

    Differentiable (the training forward): one B2 launch forward, and the
    backward differentiates :func:`_fused_causal_formulation` (reference
    ``_fused_causal_bwd``) for q, k, v, and for kvalid and w where they
    require grad (the model's ``w`` is frozen and does not)."""
    if kvalid is None:
        kvalid = torch.ones(q.shape[:1] + q.shape[2:3], dtype=torch.float32,
                            device=q.device)
    col_deg, col_scale = _columns(col_deg, col_scale, q.device)
    return _FusedCausal.apply(q, k, v, kvalid, w, col_deg, col_scale, chunk,
                              eps)


def _fused_causal_formulation(q, k, v, kvalid, w, col_deg, col_scale,
                              chunk: int, eps: float) -> torch.Tensor:
    """Port of the reference's ``_fused_causal_jnp``, the formulation its
    custom VJP differentiates (``_fused_causal_bwd``): featurize q and k
    (``featurize_ref4``), mask the keys by ``kvalid``, then the chunked
    causal attention, in fp32. The port's backward formulation, not a
    fallback: the forward value on the card comes from kernel B2."""
    zq = featurize_ref4(q, w, col_deg, col_scale)
    zk = featurize_ref4(k, w, col_deg, col_scale) \
        * kvalid.float()[:, None, :, None]
    return causal_chunked_ref(zq, zk, v, chunk, eps)


class _FusedCausal(torch.autograd.Function):
    """Kernel B2 under autograd (reference ``_fused_causal``)."""

    @staticmethod
    def forward(ctx, q, k, v, kvalid, w, col_deg, col_scale, chunk, eps):
        ctx.save_for_backward(q, k, v, kvalid, w, col_deg, col_scale)
        ctx.chunk, ctx.eps = chunk, eps
        out, _, _ = rm_fused_causal(q, k, v, kvalid, w, col_deg, col_scale,
                                    eps, plain_chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kvalid, w, col_deg, col_scale = ctx.saved_tensors
        grads = _vjp(
            "rm_attention_fused_causal.backward",
            lambda q, k, v, kvalid, w: _fused_causal_formulation(
                q, k, v, kvalid, w, col_deg, col_scale, ctx.chunk, ctx.eps),
            (q, k, v, kvalid, w), ctx.needs_input_grad[:5], g)
        return grads + (None,) * 4


def rm_attention_fused_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    col_deg,
    col_scale,
    *,
    kvalid: Optional[torch.Tensor] = None,
    chunk: int = 128,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused prefill: causal outputs AND the final decode state ``(S [B,H,F,
    dv], n [B,H,F])`` from the SAME call. ``chunk`` as in
    :func:`rm_attention_fused_causal` (plain version only)."""
    return rm_fused_causal(q, k, v, kvalid, w, col_deg, col_scale, eps,
                           plain_chunk=chunk)


def _slab_for(op: str, x, w, col_deg, col_scale,
              pack: Optional[NoncausalPack]) -> NoncausalPack:
    """The non-causal kernels' slab: ``pack`` as given (made once per
    weight set by ``models.attention.rm_packed_weights``), else made from
    ``w`` now."""
    if pack is None:
        pack = pack_noncausal(w, col_deg, col_scale)
    if pack.slab.dtype != x.dtype or pack.slab.device != x.device or \
            pack.slab.shape[1] != x.shape[-1] or \
            pack.num_features != w.shape[1]:
        raise ValueError(
            f"{op}: the slab ({pack.slab.dtype}, {pack.slab.device}, d "
            f"{pack.slab.shape[1]}, F {pack.num_features}) does not match "
            f"the rows ({x.dtype}, {x.device}, d {x.shape[-1]}) and w "
            f"{tuple(w.shape)}")
    return pack


def _sched_array(sched):
    return (ctypes.c_int * len(sched))(*sched)


def _slab_code(x, pack: NoncausalPack) -> int:
    """The non-causal launchers' dtype code: 0 fp32, 1 bf16, 2 fp32 rows
    with a slab of TF32 numbers (one 3xTF32 term fewer)."""
    if x.dtype == torch.float32 and pack.tf32_exact:
        return 2
    return _DTYPE_CODE[x.dtype]


def rm_fused_state(k, v, kvalid, w, col_deg, col_scale, *,
                   pack: Optional[NoncausalPack] = None):
    """The key state of non-causal attention (kernel B3): ``(S [BH, F,
    dv], n [BH, F])`` of ``zk = Z(k) * kvalid`` over all T keys — the
    kernel on a CUDA tensor, ``ref.rm_fused_state_ref`` on a CPU tensor.

    ``k [BH, T, d]`` pre-scaled rows (fp32 or bf16, ``w``'s type), ``v
    [BH, T, dv]``, ``kvalid [BH, T]`` (1.0 real key, 0.0 padding), packed
    ``w [kdeg, F, d]``, ``col_deg``/``col_scale [F]``; ``pack`` the slab
    of ``w`` (``noncausal.pack_noncausal``), made here when not given. The
    kernel's split of the keys is ``rm_fused_state.last_schedule``
    (``kernels.common.noncausal_schedule``).

    """
    _no_grad_check("rm_fused_state", k, v, w)
    bh, t, d = k.shape
    dv = v.shape[-1]
    kdeg, f, _ = w.shape
    dev = k.device
    if v.shape[:2] != (bh, t) or kvalid.shape != (bh, t) or w.shape[2] != d:
        raise ValueError(f"shape mismatch: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, kvalid {tuple(kvalid.shape)}, "
                         f"w {tuple(w.shape)}")
    # nothing to sum: an empty state
    if bh == 0 or t == 0 or f == 0:
        return (torch.zeros((bh, f, dv), dtype=torch.float32, device=dev),
                torch.zeros((bh, f), dtype=torch.float32, device=dev))
    col_deg, col_scale = _columns(col_deg, col_scale, dev)
    if dev.type in PLAIN_DEVICES:
        return rm_fused_state_ref(k, v, kvalid, w, col_deg, col_scale)
    _check_cuda_operands("rm_fused_state", k, {"v": v, "kvalid": kvalid},
                         w)
    pack = _slab_for("rm_fused_state", k, w, col_deg, col_scale, pack)
    sched = noncausal_schedule("state", bh, t, d, dv, f, pack.tile_rows,
                               k.element_size())
    # v and kvalid enter in fp32 (a lossless upcast of bf16)
    kc = k.contiguous()
    vf = v.float().contiguous()
    kval = kvalid.float().contiguous()
    s = torch.empty((bh, f, dv), dtype=torch.float32, device=dev)
    n = torch.empty((bh, f), dtype=torch.float32, device=dev)
    s_part = n_part = None
    if sched.splits > 1:
        # the splits' partial states, summed in split order by the kernel's
        # second pass
        s_part = torch.empty((bh, sched.splits, f, dv), dtype=torch.float32,
                             device=dev)
        n_part = torch.empty((bh, sched.splits, f), dtype=torch.float32,
                             device=dev)
    err = _launcher("rm_fused_state", "rm_fused_state_launch",
                    _STATE_ARGTYPES)(
        kc.data_ptr(), vf.data_ptr(), kval.data_ptr(), pack.slab.data_ptr(),
        pack.tile_row0.data_ptr(), pack.class_tiles.data_ptr(),
        pack.col_deg.data_ptr(),
        pack.col_scale.data_ptr(), s.data_ptr(), n.data_ptr(),
        None if s_part is None else s_part.data_ptr(),
        None if n_part is None else n_part.data_ptr(),
        _sched_array(sched), len(sched), _slab_code(k, pack),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_fused_state kernel launch failed: CUDA "
                           f"error {err}")
    rm_fused_state.launches += 1
    rm_fused_state.last_schedule = sched
    return s, n


rm_fused_state.launches = 0
rm_fused_state.last_schedule = None


def rm_fused_apply(q, s, n, w, col_deg, col_scale, eps: float, *,
                   pack: Optional[NoncausalPack] = None):
    """Non-causal outputs from a key state (kernel B4): ``Z(q) S /
    clamp(Z(q) n)`` ``[BH, T, dv]`` fp32 — the kernel on a CUDA tensor,
    ``ref.rm_fused_apply_ref`` on a CPU tensor.

    ``q [BH, T, d]`` pre-scaled rows (fp32 or bf16, ``w``'s type), ``s [BH,
    F, dv]`` and ``n [BH, F]`` from :func:`rm_fused_state`, packed ``w
    [kdeg, F, d]``, ``col_deg``/``col_scale [F]``; ``pack`` as for
    :func:`rm_fused_state`. The kernel's split of the queries is
    ``rm_fused_apply.last_schedule``.

    """
    _no_grad_check("rm_fused_apply", q, s, n, w)
    bh, t, d = q.shape
    kdeg, f, _ = w.shape
    dv = s.shape[-1]
    dev = q.device
    if s.shape != (bh, f, dv) or n.shape != (bh, f) or w.shape[2] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, s "
                         f"{tuple(s.shape)}, n {tuple(n.shape)}, w "
                         f"{tuple(w.shape)}")
    # no rows give an empty output; with no feature columns every numerator
    # and denominator is 0, so out = 0 / clamp(0) = 0
    if bh == 0 or t == 0 or f == 0:
        return torch.zeros((bh, t, dv), dtype=torch.float32, device=dev)
    col_deg, col_scale = _columns(col_deg, col_scale, dev)
    if dev.type in PLAIN_DEVICES:
        return rm_fused_apply_ref(q, s, n, w, col_deg, col_scale, eps)
    _check_cuda_operands("rm_fused_apply", q, {"s": s, "n": n}, w)
    pack = _slab_for("rm_fused_apply", q, w, col_deg, col_scale, pack)
    sched = noncausal_schedule("apply", bh, t, d, dv, f, pack.tile_rows,
                               q.element_size())
    qc = q.contiguous()
    sf, nf = s.float().contiguous(), n.float().contiguous()
    out = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
    err = _launcher("rm_fused_apply", "rm_fused_apply_launch",
                    _APPLY_ARGTYPES)(
        qc.data_ptr(), sf.data_ptr(), nf.data_ptr(), pack.slab.data_ptr(),
        pack.tile_row0.data_ptr(), pack.class_tiles.data_ptr(),
        pack.col_deg.data_ptr(),
        pack.col_scale.data_ptr(), out.data_ptr(), _sched_array(sched),
        len(sched), float(eps), _slab_code(q, pack),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rm_fused_apply kernel launch failed: CUDA "
                           f"error {err}")
    rm_fused_apply.launches += 1
    rm_fused_apply.last_schedule = sched
    return out


rm_fused_apply.launches = 0
rm_fused_apply.last_schedule = None


def rm_attention_fused_noncausal(
    q: torch.Tensor,          # [B, H, T, d]  pre-scaled queries (NOT features)
    k: torch.Tensor,          # [B, H, T, d]
    v: torch.Tensor,          # [B, H, T, dv]
    w: torch.Tensor,          # [max_degree, F, d] packed omegas
    col_deg,                  # [F] int32 tensor or host array
    col_scale,                # [F] fp32 tensor or host array
    *,
    kvalid: Optional[torch.Tensor] = None,   # [B, T] 1.0 real / 0.0 padded
    chunk: int = 128,
    eps: float = 1e-4,
    pack: Optional[NoncausalPack] = None,    # the slab of w, if made already
) -> torch.Tensor:            # [B, H, T, dv] fp32
    """Fused bidirectional RM attention: ``rm_attention_noncausal(Z(q),
    Z(k) * kvalid, v)`` without writing Z — kernel B3 for the key state,
    then kernel B4 for the outputs (their plain versions on CPU tensors).
    Both kernels read the omegas from one slab (``pack``; made here from
    ``w`` when not given).

    Neither T nor F is padded. The reference pads T to its chunk (keys
    with kvalid 0, query rows sliced off) and F to its feature block
    (degree-0, scale-0 columns); both kernels mask a ragged 64-row key or
    query tile and give every column past F in their last 8-column tile
    degree 0 and scale 0, so neither padding changes the result and both
    kernels take the rows as they are. ``chunk`` is kept for the
    reference's signature and not read.

    Differentiable (the encoder's training forward): one B3 and one B4
    launch forward, and the backward differentiates
    :func:`_fused_noncausal_formulation` (reference
    ``_fused_noncausal_bwd``) for q, k, v, and for kvalid and w where they
    require grad.
    """
    if kvalid is None:
        kvalid = torch.ones(q.shape[:1] + q.shape[2:3], dtype=torch.float32,
                            device=q.device)
    col_deg, col_scale = _columns(col_deg, col_scale, q.device)
    return _FusedNoncausal.apply(q, k, v, kvalid, w, col_deg, col_scale,
                                 eps, pack)


def _fused_noncausal_formulation(q, k, v, kvalid, w, col_deg, col_scale,
                                 eps: float) -> torch.Tensor:
    """Port of the reference's ``_fused_noncausal_jnp``, the formulation its
    custom VJP differentiates (``_fused_noncausal_bwd``): featurize q and k,
    mask the keys by ``kvalid``, then the bidirectional attention in fp32
    (``ref.rm_fused_noncausal_ref``). The port's backward formulation, not
    a fallback: the forward value on the card comes from kernels B3 and
    B4."""
    return rm_fused_noncausal_ref(q, k, v, kvalid, w, col_deg, col_scale,
                                  eps=eps)


class _FusedNoncausal(torch.autograd.Function):
    """Kernels B3 + B4 under autograd (reference ``_fused_noncausal``)."""

    @staticmethod
    def forward(ctx, q, k, v, kvalid, w, col_deg, col_scale, eps, pack):
        ctx.save_for_backward(q, k, v, kvalid, w, col_deg, col_scale)
        ctx.eps = eps
        b, h, t, d = q.shape
        dv = v.shape[-1]
        dev = q.device
        if b * h == 0 or t == 0:
            return torch.zeros((b, h, t, dv), dtype=torch.float32,
                               device=dev)
        if dev.type == "cuda" and pack is None and w.shape[1]:
            pack = pack_noncausal(w, col_deg, col_scale)
        with _kernel_scope("rm_attn_fused", x=q, mode="noncausal",
                           cost=dict(batch=b * h, t=t, d=d,
                                     depth=w.shape[0], f=w.shape[1],
                                     dv=dv, itemsize=q.element_size())):
            kval = kvalid.float()[:, None, :].expand(b, h, t).reshape(b * h, t)
            s, n = rm_fused_state(k.reshape(b * h, t, d),
                                  v.reshape(b * h, t, dv), kval, w, col_deg,
                                  col_scale, pack=pack)
            out = rm_fused_apply(q.reshape(b * h, t, d), s, n, w, col_deg,
                                 col_scale, eps, pack=pack)
            return out.reshape(b, h, t, dv)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kvalid, w, col_deg, col_scale = ctx.saved_tensors
        grads = _vjp(
            "rm_attention_fused_noncausal.backward",
            lambda q, k, v, kvalid, w: _fused_noncausal_formulation(
                q, k, v, kvalid, w, col_deg, col_scale, ctx.eps),
            (q, k, v, kvalid, w), ctx.needs_input_grad[:5], g)
        return grads + (None,) * 4


def rm_attention_fused_decode_step(
    q: torch.Tensor,        # [B, H, d]  pre-scaled query (NOT features)
    k: torch.Tensor,        # [B, H, d]
    v: torch.Tensor,        # [B, H, dv]
    state_s: torch.Tensor,  # [B, H, F, dv]
    state_n: torch.Tensor,  # [B, H, F]
    w: torch.Tensor,        # [max_degree, F, d]
    col_deg,
    col_scale,
    *,
    eps: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step: ONE featurize launch for q and k stacked along rows,
    then the rank-1 state update and two GEMVs in PyTorch (they were never
    a TPU kernel). Returns ``(out [B,H,dv], new_s, new_n)``."""
    b, h, d = q.shape
    f = w.shape[1]
    col_deg, col_scale = _columns(col_deg, col_scale, q.device)
    x2 = torch.cat([q.reshape(b * h, d), k.reshape(b * h, d)], dim=0)
    z2 = rm_feature_fused(x2, w, col_deg, col_scale)
    zq = z2[:b * h].reshape(b, h, f)
    zk = z2[b * h:].reshape(b, h, f)
    return rm_attention_decode_ref(zq, zk, v, state_s, state_n, eps=eps)
