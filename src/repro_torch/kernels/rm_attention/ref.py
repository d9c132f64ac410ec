"""Plain PyTorch versions for RM linear attention (port of
``repro.kernels.rm_attention.ref`` and the jnp formulations in
``repro.kernels.rm_attention.ops``).

Given features ``zq, zk [B, H, T, F]`` and values ``v [B, H, T, dv]``,

    out_t = (sum_{s <= t} (zq_t . zk_s) v_s) / clamp(sum_{s <= t} zq_t . zk_s)

(causal), or the same sums over every key s (non-causal: ``zq_t S / clamp(
zq_t n)`` with the key state ``S = zk^T v``, ``n = colsum(zk)``).

RM features are signed, so the denominator can pass through zero; it is
clamped to ``sign(den) * max(|den|, eps)`` with ``den >= 0 -> +eps``.
Everything is computed in fp32; the chunked path (``chunk_states``,
``rm_attention_chunked_ref``, ``causal_chunked_ref``) keeps float64 inputs
in float64, the yardstick the kernel tests hold B5 to where fp32 itself
loses digits (denominators near zero).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

__all__ = [
    "clamp_den",
    "featurize_ref4",
    "chunk_states",
    "rm_attention_chunked_ref",
    "causal_chunked",
    "causal_chunked_ref",
    "rm_attention_ref",
    "rm_fused_causal_ref",
    "rm_attention_prefill_final_state",
    "rm_attention_decode_ref",
    "rm_attention_noncausal_ref",
    "rm_fused_state_ref",
    "rm_fused_apply_ref",
    "rm_fused_noncausal_ref",
]


def clamp_den(den: torch.Tensor, eps: float) -> torch.Tensor:
    sign_eps = torch.where(den >= 0, torch.full_like(den, eps),
                           torch.full_like(den, -eps))
    return torch.where(den.abs() < eps, sign_eps, den)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in float64 where it is float64."""
    return x if x.dtype == torch.float64 else x.float()


def featurize_ref4(x, w, col_deg, col_scale) -> torch.Tensor:
    """[B, H, T, d] -> [B, H, T, F] through the rm_feature plain version."""
    b, h, t, d = x.shape
    z = rm_feature_fused_ref(x.reshape(b * h * t, d), w, col_deg, col_scale)
    return z.reshape(b, h, t, w.shape[1])


def chunk_states(zk_p, v_p, chunk: int) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Pass A plus the exclusive chunk prefixes (reference
    ``ops._chunk_states``): for ``zk_p [B,H,T,F]``, ``v_p [B,H,T,dv]`` with
    T a multiple of ``chunk``, ``s_prev [B,H,T/C,F,dv]`` and ``n_prev
    [B,H,T/C,F]`` — the key state of all chunks BEFORE each chunk."""
    b, h, t, f = zk_p.shape
    dv = v_p.shape[-1]
    n = t // chunk
    zk_c = _wide(zk_p).reshape(b, h, n, chunk, f)
    v_c = _wide(v_p).reshape(b, h, n, chunk, dv)
    s_chunk = torch.einsum("bhncf,bhncd->bhnfd", zk_c, v_c)
    n_chunk = zk_c.sum(dim=3)
    return (torch.cumsum(s_chunk, dim=2) - s_chunk,
            torch.cumsum(n_chunk, dim=2) - n_chunk)


def rm_attention_chunked_ref(zq, zk, v, s_prev, n_prev, *, chunk: int,
                             eps: float) -> torch.Tensor:
    """Plain version of kernel B5 (reference ``_rm_attn_kernel``): pass B
    over ``zq, zk [BH,T,F]``, ``v [BH,T,dv]``, ``s_prev [BH,T/C,F,dv]``,
    ``n_prev [BH,T/C,F]`` with T a multiple of ``chunk``; fp32 out
    (float64 for float64 inputs)."""
    bh, t, f = zq.shape
    dv = v.shape[-1]
    n = t // chunk
    zq_c = _wide(zq).reshape(bh, n, chunk, f)
    zk_c = _wide(zk).reshape(bh, n, chunk, f)
    v_c = _wide(v).reshape(bh, n, chunk, dv)
    scores = torch.einsum("bnqf,bnkf->bnqk", zq_c, zk_c)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=zq.device).tril()
    scores = torch.where(mask, scores, torch.zeros_like(scores))
    num = torch.einsum("bnqk,bnkd->bnqd", scores, v_c)
    num = num + torch.einsum("bnqf,bnfd->bnqd", zq_c, _wide(s_prev))
    den = scores.sum(dim=-1)
    den = den + torch.einsum("bnqf,bnf->bnq", zq_c, _wide(n_prev))
    out = num / clamp_den(den, eps)[..., None]
    return out.reshape(bh, t, dv)


def causal_chunked(zq, zk, v, chunk: int, eps: float,
                   pass_b) -> torch.Tensor:
    """Chunk-parallel causal linear attention over ``[B,H,T,F]`` features:
    pad T to the chunk (``chunk = min(chunk, T)``), pass A and the prefixes
    (:func:`chunk_states`), then ``pass_b`` — :func:`rm_attention_chunked_ref`
    or the kernel wrapper with the same signature — and crop."""
    b, h, t, f = zq.shape
    dv = v.shape[-1]
    if t == 0:
        return torch.zeros((b, h, 0, dv), dtype=torch.float32,
                           device=zq.device)
    chunk = min(chunk, t)
    pad = -t % chunk
    tp = t + pad
    n = tp // chunk

    def _pad(x):
        return F.pad(x, (0, 0, 0, pad))

    zq_p, zk_p, v_p = _pad(zq), _pad(zk), _pad(_wide(v))
    s_prev, n_prev = chunk_states(zk_p, v_p, chunk)
    out = pass_b(zq_p.reshape(b * h, tp, f), zk_p.reshape(b * h, tp, f),
                 v_p.reshape(b * h, tp, dv), s_prev.reshape(b * h, n, f, dv),
                 n_prev.reshape(b * h, n, f), chunk=chunk, eps=eps)
    return out.reshape(b, h, tp, dv)[:, :, :t]


def causal_chunked_ref(zq, zk, v, chunk: int, eps: float) -> torch.Tensor:
    """Plain chunked causal linear attention (reference
    ``ops._causal_chunked_jnp``): intra-chunk ``tril(zq zk^T) v`` plus the
    exclusive prefix state of earlier chunks."""
    return causal_chunked(zq, zk, v, chunk, eps, rm_attention_chunked_ref)


def rm_attention_ref(zq, zk, v, causal: bool = True,
                     eps: float = 1e-4) -> torch.Tensor:
    """The O(T^2) direct evaluation (reference ``ref.rm_attention_ref``),
    the cross-check of the chunked formulation."""
    zq, zk, v = zq.float(), zk.float(), v.float()
    w = torch.einsum("bhtf,bhsf->bhts", zq, zk)
    if causal:
        t = zq.shape[2]
        mask = torch.ones(t, t, dtype=torch.bool, device=zq.device).tril()
        w = torch.where(mask, w, torch.zeros_like(w))
    num = torch.einsum("bhts,bhsd->bhtd", w, v)
    return num / clamp_den(w.sum(dim=-1), eps)[..., None]


def rm_attention_prefill_final_state(zk, v) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The state after a whole prefix: ``S = zk^T v [B,H,F,dv]``,
    ``n = sum_t zk [B,H,F]``."""
    zk = zk.float()
    return torch.einsum("bhsf,bhsd->bhfd", zk, v.float()), zk.sum(dim=2)


def rm_fused_causal_ref(q, k, v, kvalid, w, col_deg, col_scale, *,
                        chunk: int, eps: float):
    """Plain version of the fused causal kernel: (out, S, n).

    ``q, k [B, H, T, d]`` pre-scaled rows (not features), ``v [B, H, T,
    dv]``, ``kvalid [B, T]`` (1.0 real key, 0.0 padding), packed ``w``.
    ``out`` is the reference's ``_fused_causal_jnp``; ``(S, n)`` its
    ``rm_attention_prefill_final_state`` of the masked keys.
    """
    zq = featurize_ref4(q, w, col_deg, col_scale)
    zk = featurize_ref4(k, w, col_deg, col_scale) \
        * kvalid.float()[:, None, :, None]
    out = causal_chunked_ref(zq, zk, v, chunk, eps)
    s, n = rm_attention_prefill_final_state(zk, v)
    return out, s, n


def rm_attention_decode_ref(zq, zk, v, state_s, state_n, eps: float = 1e-4):
    """One decode step: rank-1 state update and two GEMVs; returns
    ``(out [B,H,dv], new_s, new_n)``."""
    s = state_s + zk[..., None] * v[..., None, :]
    n = state_n + zk
    zq = zq.float()
    num = torch.einsum("bhf,bhfd->bhd", zq, s)
    den = clamp_den(torch.einsum("bhf,bhf->bh", zq, n), eps)
    return num / den[..., None], s, n


def rm_attention_noncausal_ref(zq, zk, v, eps: float = 1e-4) -> torch.Tensor:
    """Bidirectional linear attention over features (reference
    ``ops.rm_attention_noncausal``): the key state ``S = zk^T v``, ``n =
    colsum(zk)``, then ``zq S / clamp(zq n)`` — two einsums each way, fp32.
    ``zq, zk [B, H, T, F]``, ``v [B, H, T, dv]`` -> ``[B, H, T, dv]``."""
    zq, zk, v = zq.float(), zk.float(), v.float()
    s = torch.einsum("bhsf,bhsd->bhfd", zk, v)
    n = zk.sum(dim=2)
    num = torch.einsum("bhtf,bhfd->bhtd", zq, s)
    den = clamp_den(torch.einsum("bhtf,bhf->bht", zq, n), eps)
    return num / den[..., None]


def rm_fused_state_ref(k, v, kvalid, w, col_deg,
                       col_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B3 (reference ``_fused_state_kernel``): the
    whole-sequence key state of ``zk = Z(k) * kvalid``.

    ``k [BH, T, d]`` pre-scaled rows, ``v [BH, T, dv]``, ``kvalid [BH, T]``
    (1.0 real key, 0.0 padding), packed ``w [kdeg, F, d]`` -> ``S [BH, F,
    dv]``, ``n [BH, F]``, fp32.
    """
    bh, t, d = k.shape
    zk = rm_feature_fused_ref(k.reshape(bh * t, d), w, col_deg, col_scale)
    zk = zk.reshape(bh, t, -1) * kvalid.float()[..., None]
    return torch.einsum("bsf,bsd->bfd", zk, v.float()), zk.sum(dim=1)


def rm_fused_apply_ref(q, s, n, w, col_deg, col_scale,
                       eps: float) -> torch.Tensor:
    """Plain version of kernel B4 (reference ``_fused_apply_kernel``):
    ``Z(q) S / clamp(Z(q) n)``.

    ``q [BH, T, d]`` pre-scaled rows, ``s [BH, F, dv]``, ``n [BH, F]``,
    packed ``w [kdeg, F, d]`` -> ``out [BH, T, dv]`` fp32.
    """
    bh, t, d = q.shape
    zq = rm_feature_fused_ref(q.reshape(bh * t, d), w, col_deg, col_scale)
    zq = zq.reshape(bh, t, -1)
    num = torch.einsum("btf,bfd->btd", zq, s.float())
    den = clamp_den(torch.einsum("btf,bf->bt", zq, n.float()), eps)
    return num / den[..., None]


def rm_fused_noncausal_ref(q, k, v, kvalid, w, col_deg, col_scale, *,
                           eps: float) -> torch.Tensor:
    """The fused non-causal op composed from its plain parts (reference
    ``ops._fused_noncausal_jnp``): ``q, k [B, H, T, d]`` pre-scaled rows,
    ``v [B, H, T, dv]``, ``kvalid [B, T]`` -> ``out [B, H, T, dv]`` fp32."""
    zq = featurize_ref4(q, w, col_deg, col_scale)
    zk = featurize_ref4(k, w, col_deg, col_scale) \
        * kvalid.float()[:, None, :, None]
    return rm_attention_noncausal_ref(zq, zk, v, eps)
