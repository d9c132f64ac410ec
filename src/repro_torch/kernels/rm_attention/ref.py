"""Plain PyTorch versions for RM linear attention (port of
``repro.kernels.rm_attention.ref`` and the jnp formulations in
``repro.kernels.rm_attention.ops``).

Given features ``zq, zk [B, H, T, F]`` and values ``v [B, H, T, dv]``,

    out_t = (sum_{s <= t} (zq_t . zk_s) v_s) / clamp(sum_{s <= t} zq_t . zk_s)

RM features are signed, so the denominator can pass through zero; it is
clamped to ``sign(den) * max(|den|, eps)`` with ``den >= 0 -> +eps``.
Everything is computed in fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

__all__ = [
    "clamp_den",
    "featurize_ref4",
    "causal_chunked_ref",
    "rm_fused_causal_ref",
    "rm_attention_prefill_final_state",
    "rm_attention_decode_ref",
]


def clamp_den(den: torch.Tensor, eps: float) -> torch.Tensor:
    sign_eps = torch.where(den >= 0, torch.full_like(den, eps),
                           torch.full_like(den, -eps))
    return torch.where(den.abs() < eps, sign_eps, den)


def featurize_ref4(x, w, col_deg, col_scale) -> torch.Tensor:
    """[B, H, T, d] -> [B, H, T, F] through the rm_feature plain version."""
    b, h, t, d = x.shape
    z = rm_feature_fused_ref(x.reshape(b * h * t, d), w, col_deg, col_scale)
    return z.reshape(b, h, t, -1)


def causal_chunked_ref(zq, zk, v, chunk: int, eps: float) -> torch.Tensor:
    """Chunk-parallel causal linear attention (reference
    ``ops._causal_chunked_jnp``): intra-chunk ``tril(zq zk^T) v`` plus the
    exclusive prefix state of earlier chunks."""
    b, h, t, f = zq.shape
    dv = v.shape[-1]
    chunk = min(chunk, t)
    pad = -t % chunk
    n = (t + pad) // chunk

    def _chunks(x, width):
        return F.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, n, chunk,
                                                        width)

    zq_c, zk_c, v_c = _chunks(zq, f), _chunks(zk, f), _chunks(v, dv)
    s_chunk = torch.einsum("bhncf,bhncd->bhnfd", zk_c, v_c)
    n_chunk = zk_c.sum(dim=3)
    s_prev = torch.cumsum(s_chunk, dim=2) - s_chunk
    n_prev = torch.cumsum(n_chunk, dim=2) - n_chunk

    scores = torch.einsum("bhnqf,bhnkf->bhnqk", zq_c, zk_c)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=zq.device).tril()
    scores = torch.where(mask, scores, torch.zeros_like(scores))
    num = torch.einsum("bhnqk,bhnkd->bhnqd", scores, v_c)
    num = num + torch.einsum("bhnqf,bhnfd->bhnqd", zq_c, s_prev)
    den = scores.sum(dim=-1)
    den = den + torch.einsum("bhnqf,bhnf->bhnq", zq_c, n_prev)
    out = num / clamp_den(den, eps)[..., None]
    return out.reshape(b, h, t + pad, dv)[:, :, :t]


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
