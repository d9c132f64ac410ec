"""Attention: exact softmax GQA and the paper's Random-Maclaurin linear
mode (port of ``repro.models.attention``).

``attention_mode="exact"``: softmax attention in plain PyTorch (einsum,
``torch.where`` with the reference's ``NEG_INF`` mask, softmax), as the
reference's is plain jnp; it has no TPU kernel, so it has no CUDA kernel
either, and no library attention kernel stands in for it. Keys at negative
positions are padding (bucketed prefill) and never attended to; above
``_BLOCKWISE_THRESHOLD`` positions the forward runs the blockwise
online-softmax loop over 1024-wide query and key blocks. Decode keeps a
ring-buffer KV cache (sized by ``sliding_window`` when there is one).

``attention_mode="rm"``: q/k are per-head l2-normalized, scaled by
softplus(``rm_scale``) and featurized with a static plan of the estimator
family ``cfg.rm.estimator`` (``"rm"``, ``"tensor_sketch"``, ``"ctr"`` or
``"structured"``) for the exponential dot product kernel; attention is linear in the features and
decode keeps an O(1) state (``S [F, dv]``, ``n [F]``) instead of a KV cache.

Two paths (``rm_fuse_enabled``):

* fused (family ``"rm"``, ``fuse_featurize`` ``"auto"``/``"on"``): the
  featurize runs inside the attention kernels — B2 for causal prefill and
  forward, B3 (key state) then B4 (queries) for the non-causal forward of
  an encoder — or in one rm_feature launch for q and k together (decode);
* two-launch (``fuse_featurize="off"``, or a family without the fused
  capability): each of q and k is featurized by its family's map (B1 for
  ``"rm"``, B6 for ``"tensor_sketch"``, B7 for ``"ctr"``, B8 for
  ``"structured"``), then kernel B5 runs the causal
  attention over the features (prefill, forward), two einsums run the
  non-causal attention (encoder forward), or the O(1) state update runs in
  PyTorch (decode).

The fused path trains: ``rm_attention_fused_causal`` and
``rm_attention_fused_noncausal`` differentiate (their backward
differentiates the reference's XLA formulation in PyTorch), while the
two-launch path's featurize kernels have no backward, as in the reference.

A non-causal config (an encoder) has a forward and its gradient only, in
either mode: the prefill-cache and decode paths raise ``ValueError``
("encoder-only").
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.dtypes import resolve_precision
from repro_torch.core import registry
from repro_torch.core.maclaurin import ExponentialDotProductKernel
from repro_torch.core.plan import plan_columns
from repro_torch.kernels.rm_attention.noncausal import pack_noncausal
from repro_torch.kernels.rm_attention.ops import (
    rm_attention_causal,
    rm_attention_decode_step,
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_noncausal,
    rm_attention_fused_prefill,
    rm_attention_noncausal,
    rm_attention_prefill_final_state,
)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.collectives import all_gather
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    normal_init,
    rms_norm_headwise,
)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30
_INT32_MAX = 2**31 - 1


def _require_decoder(cfg: ModelConfig) -> None:
    if not cfg.causal:
        raise ValueError(
            f"{cfg.name} is encoder-only: non-causal attention has a "
            "forward (a full encode) but no prefill cache or decode step")


def rm_estimator(cfg: ModelConfig) -> registry.Estimator:
    return registry.get(cfg.rm.estimator)


@functools.lru_cache(maxsize=None)
def rm_plan_for(cfg: ModelConfig, input_dim: int):
    """The (hashable) feature plan of a config — the reference's
    arguments, so both packages build the same plan."""
    rm = cfg.rm
    kernel = ExponentialDotProductKernel(rm.sigma2)
    return rm_estimator(cfg).make_plan(
        kernel,
        input_dim,
        rm.num_features,
        p=rm.p,
        measure=rm.measure,
        stratified=rm.stratified,
        n_max=rm.n_max,
        radius=rm.qk_scale,
        seed=0,
    )


def rm_fuse_enabled(cfg: ModelConfig) -> bool:
    """Whether the rm attention path runs the fused featurize+attention ops.

    ``"off"`` -> never; ``"auto"`` and ``"on"`` -> wherever the estimator
    family has the ``fused_attention_supported`` capability (the reference's
    ``"auto"`` also checks for a TPU; here the fused ops run the Hopper
    kernel on a CUDA tensor and their plain version on a CPU tensor). A
    family without the capability always takes the two-launch path.

    Raises:
        ValueError: an unknown mode.
    """
    mode = cfg.rm.fuse_featurize
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"cfg.rm.fuse_featurize must be 'auto', 'on' or 'off'; "
            f"got {mode!r}")
    return mode != "off" and rm_estimator(cfg).fused_attention_supported


def rm_valid_mask(z: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Zero featurized keys at padded positions (position < 0), so bucket
    padding reaches neither the prefix sums nor the decode state.
    ``z [B, H, T, F]``, ``positions [B, T]``."""
    valid = (positions >= 0).to(z.dtype)
    return z * valid[:, None, :, None]


def _rm_scaled_qk(params: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, dh] -> [B, H, T, dh] fp32: l2-normalize, then scale by
    softplus(rm_scale) (or the fixed qk_scale)."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    xhat = xf / torch.clamp_min(norm, 1e-6)
    if cfg.rm.learnable_scale:
        # every model rank scales its own heads: the gradient sums
        scale = F.softplus(tp.copy_to_model(params["rm_scale"])).float()
    else:
        scale = torch.tensor(cfg.rm.qk_scale, dtype=torch.float32)
    return (xhat * scale).transpose(1, 2)


def _rm_featurize(params: Params, cfg: ModelConfig, meta,
                  x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, dh] -> [B, H, T, F] fp32: l2-normalize, scale, then ONE
    launch of the family's map (``registry.get(cfg.rm.estimator).apply``)
    on the packed weights ``rm_w`` where the params hold them."""
    xs = _rm_scaled_qk(params, cfg, x)
    return rm_estimator(cfg).apply(meta, params["rm_est"], xs,
                                   precision=cfg.rm.precision,
                                   packed=params.get("rm_w"))


def rm_packed_weights(params: Params, cfg: ModelConfig,
                      input_dim: Optional[int] = None) -> Params:
    """The attention params plus ``rm_w``: the family's packed weights in
    the precision policy's compute dtype (``registry`` ``pack``): for
    ``"rm"`` the omegas ``[max_degree, F, dh]`` that every fused op and the
    rm map read, for ``"tensor_sketch"`` the list ``[wr, wi, mr, mi]``
    packed in fp32 from the hash tables and then rounded once, for
    ``"ctr"`` the list ``[wr, wi]`` and for ``"structured"`` ``[d1, d2]``
    (values {0, +-1}, exact in either dtype). A fused non-causal config (an
    encoder) also gets ``rm_slab``: the same omegas laid out as the slab of
    kernels B3 and B4 (``kernels.rm_attention.noncausal.pack_noncausal``).
    ``input_dim`` is the plan's width (default: the head width; MLA's q/k
    are ``nope + rope`` wide). Worked out once per weight set
    (``transformer.cast_params_to_compute`` calls this); params that
    already hold them come back unchanged."""
    if cfg.attention_mode != "rm":
        return params
    slab = not cfg.causal and rm_fuse_enabled(cfg)
    if "rm_w" in params and (not slab or "rm_slab" in params):
        return params
    meta = rm_plan_for(cfg, input_dim or cfg.resolved_head_dim)
    out = dict(params)
    if "rm_w" not in out:
        dt = resolve_precision(cfg.rm.precision).compute_dtype
        out["rm_w"] = rm_estimator(cfg).pack(meta, params["rm_est"], dt)
    if slab:
        out["rm_slab"] = pack_noncausal(out["rm_w"], meta.column_degrees(),
                                        meta.column_scales())
    return out


def _rm_fused_operands(params: Params, cfg: ModelConfig, meta, q, k):
    """``(qs, ks, w, col_deg, col_scale)``: pre-scaled q/k ``[B,H,T,dh]``
    in the precision policy's compute dtype, the packed omegas ``rm_w``
    (:func:`rm_packed_weights`) and the plan's column vectors as device
    tensors."""
    w = params["rm_w"]
    qs = _rm_scaled_qk(params, cfg, q).to(w.dtype)
    ks = _rm_scaled_qk(params, cfg, k).to(w.dtype)
    return (qs, ks, w, *plan_columns(meta, w.device))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, generator, dtype, device) -> Params:
    """The projections (and biases / qk-norm scales), plus, in rm mode, the
    estimator draws ``rm_est`` and ``rm_scale``; exact mode has neither."""
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    std = cfg.init_std
    params: Params = {
        "wq": normal_init(generator, (d, h * dh), std, dtype),
        "wk": normal_init(generator, (d, hkv * dh), std, dtype),
        "wv": normal_init(generator, (d, hkv * dh), std, dtype),
        "wo": normal_init(generator, (h * dh, d), std, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            params[name] = torch.zeros((width,), dtype=dtype, device=device)
    if cfg.qk_norm:
        params["q_norm_scale"] = torch.ones((dh,), dtype=dtype, device=device)
        params["k_norm_scale"] = torch.ones((dh,), dtype=dtype, device=device)
    if cfg.attention_mode != "rm":
        return params
    meta = rm_plan_for(cfg, dh)
    params["rm_est"] = rm_estimator(cfg).init_params(meta, generator)
    if cfg.rm.learnable_scale:
        # softplus^-1(qk_scale)
        params["rm_scale"] = torch.tensor(
            math.log(math.expm1(cfg.rm.qk_scale)), dtype=torch.float32,
            device=device)
    return params


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """q, k, v ``[B, T, heads, dh]`` at ``cfg``'s head counts (a model
    rank's own heads under a model-parallel view, where the qk-norm
    scales enter through ``tensor_parallel.copy_to_model``; x has entered
    the block through ``tensor_parallel.enter_block``)."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, tp.copy_to_model(params["q_norm_scale"]),
                              cfg.norm_eps)
        k = rms_norm_headwise(k, tp.copy_to_model(params["k_norm_scale"]),
                              cfg.norm_eps)
    return q, k, v


def _out_proj(params: Params, out: torch.Tensor) -> torch.Tensor:
    """``out [.., heads * dh] @ wo``; under a model-parallel view ``wo``
    holds this rank's head rows and one all-reduce sums the ranks'
    parts."""
    return tp.exit_block(out @ params["wo"])


def _apply_positional(cfg: ModelConfig, q, k, positions):
    """RoPE on q and k; any other ``pos_embedding`` (``"sinusoidal"`` is
    added to the inputs, ``"none"``) leaves them unchanged."""
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: [B, T, Hkv, dh] -> [B, T, Hkv * rep, dh], each kv head
    repeated for its ``rep`` query heads."""
    if rep == 1:
        return x
    return torch.repeat_interleave(x, rep, dim=2)


def _kv_for_queries(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GQA: kv heads ``[B, T, Hkv, dh]`` -> one a query head of ``cfg``
    ``[B, T, H, dh]``. Where a model rank holds every kv head but only its
    own query heads (``LocalConfig.kv_group``, the ``"kv_heads"`` rule
    None), each query head takes the kv head its global index reads."""
    group = getattr(cfg, "kv_group", 0)
    if not group:
        return _repeat_kv(x, cfg.q_per_kv)
    first = tp.model_view().model_rank * cfg.num_heads
    heads = torch.arange(first, first + cfg.num_heads, device=x.device)
    return x.index_select(2, heads // group)


# ---------------------------------------------------------------------------
# exact softmax attention (the reference's plain jnp, in plain PyTorch)
# ---------------------------------------------------------------------------
# Above this sequence length the forward switches to the blockwise
# online-softmax loop (peak score memory [B, H, 1024, 1024] instead of
# [B, H, T, T]); below it the one einsum is plenty small.
_BLOCKWISE_THRESHOLD = 2048
_BLOCK_Q = 1024
_BLOCK_K = 1024


def _mask_block(cfg: ModelConfig, qp: torch.Tensor,
                kp: torch.Tensor) -> torch.Tensor:
    """qp: [.., bq], kp: [.., bk] -> bool [.., bq, bk]. Keys at negative
    positions are padding (bucketed prefill) and are never attended to."""
    m = (kp[..., None, :] >= 0).expand(qp.shape + kp.shape[-1:])
    if cfg.causal:
        m = m & (qp[..., :, None] >= kp[..., None, :])
    if cfg.sliding_window > 0:
        m = m & ((qp[..., :, None] - kp[..., None, :]) < cfg.sliding_window)
    return m


def _softmax_attention_small(cfg: ModelConfig, q, k, v, q_positions,
                             k_positions) -> torch.Tensor:
    """One einsum of every score: q [B,Tq,H,dh], k/v [B,Tk,H,*] ->
    [B,Tq,H,dv] in v's dtype (scores and softmax in fp32)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(dh)
    mask = _mask_block(cfg, q_positions, k_positions)[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _pad_positions(pos: torch.Tensor, pad: int, value: int) -> torch.Tensor:
    if not pad:
        return pos
    fill = torch.full(pos.shape[:-1] + (pad,), value, dtype=pos.dtype,
                      device=pos.device)
    return torch.cat([pos, fill], dim=-1)


def _softmax_attention_blockwise(cfg: ModelConfig, q, k, v, q_positions,
                                 k_positions) -> torch.Tensor:
    """Memory-efficient exact attention: for each 1024-wide query block, a
    loop over 1024-wide key blocks with the online softmax (running max
    and sum). T is padded to the block widths: padded queries sit at
    position 0 and are sliced off, padded keys carry the sentinel position
    ``2**31 - 1`` and are masked out. Fully masked blocks are still
    computed, then zeroed, as in the reference."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    dv = v.shape[-1]
    bq, bk = min(_BLOCK_Q, tq), min(_BLOCK_K, tk)
    pad_q, pad_k = (-tq) % bq, (-tk) % bk
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    qpos = _pad_positions(q_positions, pad_q, 0)
    kpos = _pad_positions(k_positions, pad_k, _INT32_MAX)
    nq, nk = (tq + pad_q) // bq, (tk + pad_k) // bk
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for i in range(nq):
        q_i = qp[:, i * bq:(i + 1) * bq].float()
        qpos_i = qpos[:, i * bq:(i + 1) * bq]
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, bq, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            k_j = kp[:, j * bk:(j + 1) * bk].float()
            v_j = vp[:, j * bk:(j + 1) * bk].float()
            kpos_j = kpos[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j) * scale
            mask = _mask_block(cfg, qpos_i, kpos_j)[:, None]
            # padded keys carry the sentinel position: always invalid
            mask = mask & (kpos_j < _INT32_MAX)[:, None, None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                       v_j)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))        # [B, bq, H, dv]
    out = torch.cat(outs, dim=1)[:, :tq]
    return out.to(v.dtype)


def _softmax_attention(cfg: ModelConfig, q, k, v, q_positions,
                       k_positions) -> torch.Tensor:
    """q: [B,Tq,H,dh]; k, v: [B,Tk,H,*] (kv heads already repeated);
    positions give the mask."""
    if max(q.shape[1], k.shape[1]) > _BLOCKWISE_THRESHOLD:
        return _softmax_attention_blockwise(cfg, q, k, v, q_positions,
                                            k_positions)
    return _softmax_attention_small(cfg, q, k, v, q_positions, k_positions)


def attention_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (training forward, or an encoder's encode;
    causal or not as ``cfg.causal`` says). x: [B, T, d]."""
    x = tp.enter_block(x)
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions)
    k = _kv_for_queries(k, cfg)
    v = _kv_for_queries(v, cfg)
    if cfg.attention_mode != "rm":
        out = _softmax_attention(cfg, q, k, v, positions, positions)
        return _out_proj(params, out.reshape(b, t, h * dh))
    meta = rm_plan_for(cfg, dh)
    v_t = v.transpose(1, 2)
    if rm_fuse_enabled(cfg):
        qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, k)
        if cfg.causal:
            out = rm_attention_fused_causal(qs, ks, v_t, w, cd, cs,
                                            chunk=cfg.rm.chunk,
                                            eps=cfg.rm.eps)
        else:
            out = rm_attention_fused_noncausal(
                qs, ks, v_t, w, cd, cs, chunk=cfg.rm.chunk, eps=cfg.rm.eps,
                pack=params.get("rm_slab"))
    else:
        zq = _rm_featurize(params, cfg, meta, q)
        zk = _rm_featurize(params, cfg, meta, k)
        if cfg.causal:
            out = rm_attention_causal(zq, zk, v_t, chunk=cfg.rm.chunk,
                                      eps=cfg.rm.eps)
        else:
            out = rm_attention_noncausal(zq, zk, v_t, eps=cfg.rm.eps)
    out = out.transpose(1, 2).to(x.dtype)
    return _out_proj(params, out.reshape(b, t, h * dh))


def init_attention_cache(cfg: ModelConfig, batch: int, device,
                         max_len: Optional[int] = None,
                         dtype=None) -> Dict[str, torch.Tensor]:
    """One layer's decode cache for ``batch`` lanes: the O(1) rm state
    (fp32), or exact attention's ring-buffer KV cache ``k``/``v [batch,
    size, Hkv, dh]`` in ``dtype``, ``size = max_len`` (at most
    ``sliding_window`` when the config has one; a model rank's ``size /
    model_shards`` slots where ``cfg.kv_seq`` cuts the cache by
    sequence); exact mode needs both.

    Raises:
        ValueError: exact mode without ``max_len`` or ``dtype``; a ring
            buffer the model axis does not divide under ``kv_seq``.
    """
    _require_decoder(cfg)
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.attention_mode != "rm":
        if max_len is None or dtype is None:
            raise ValueError("exact attention's KV cache needs max_len and "
                             "dtype")
        size = seq_cut(cfg, ring_size(cfg, max_len), "the KV ring buffer")
        return {
            "k": torch.zeros((batch, size, hkv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, size, hkv, dh), dtype=dtype,
                             device=device),
        }
    f = rm_plan_for(cfg, dh).output_dim
    return {
        "rm_s": torch.zeros((batch, h, f, dh), dtype=torch.float32,
                            device=device),
        "rm_n": torch.zeros((batch, h, f), dtype=torch.float32,
                            device=device),
    }


def ring_size(cfg: ModelConfig, max_len: int) -> int:
    """The exact KV cache's slots: ``max_len``, at most the sliding
    window."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def seq_cut(cfg: ModelConfig, size: int, what: str) -> int:
    """A model rank's share of a decode cache's ``size`` positions where
    ``cfg.kv_seq`` cuts it by sequence over ``"model"``, else ``size``.

    Raises:
        ValueError: the model axis does not divide ``size``.
    """
    m = tp.shards_of(cfg) if getattr(cfg, "kv_seq", False) else 1
    if size % m:
        raise ValueError(f"{cfg.name}: {what} of {size} positions (from "
                         f"max_len) is not divisible by the mesh's model "
                         f"axis of {m} ('kv_seq' rule)")
    return size // m


def attention_decode(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                 # [B, 1, d]
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,         # [B] position of the new token
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a lane. rm: the O(1) state update. exact: the new key and
    value are written into the ring buffer IN PLACE at slot ``positions %
    size`` (the returned cache holds the same tensors), then the query
    attends to every slot whose absolute position is in range."""
    _require_decoder(cfg)
    x = tp.enter_block(x)
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions[:, None])
    if cfg.attention_mode != "rm":
        return _exact_decode(params, cfg, q, k, v, cache, positions)
    meta = rm_plan_for(cfg, dh)
    k = _kv_for_queries(k, cfg)
    v = _kv_for_queries(v, cfg)
    v0 = v[:, 0]                                         # [B, H, dv]
    if rm_fuse_enabled(cfg):
        qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, k)
        out, s_new, n_new = rm_attention_fused_decode_step(
            qs[:, :, 0], ks[:, :, 0], v0, cache["rm_s"], cache["rm_n"], w,
            cd, cs, eps=cfg.rm.eps)
    else:
        zq = _rm_featurize(params, cfg, meta, q)[:, :, 0]   # [B, H, F]
        zk = _rm_featurize(params, cfg, meta, k)[:, :, 0]
        out, s_new, n_new = rm_attention_decode_step(
            zq, zk, v0, cache["rm_s"], cache["rm_n"], eps=cfg.rm.eps)
    y = _out_proj(params, out.reshape(b, 1, h * dh).to(x.dtype))
    return y, {"rm_s": s_new, "rm_n": n_new}


def attention_prefill_cache(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,           # [B, T, d] prompt
    positions: torch.Tensor,   # [B, T]; -1 marks bucket padding
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill AND the decode cache. rm: one fused launch, or (two-launch
    path) the featurize launches, kernel B5 and the whole-prompt state;
    padded prompt positions are masked out of the keys (``kvalid`` /
    :func:`rm_valid_mask`). exact: the softmax attention, then the prompt's
    keys and values written into a fresh ring buffer of ``max_len`` (or the
    sliding window) slots; ``max_len`` is required there."""
    _require_decoder(cfg)
    x = tp.enter_block(x)
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions)
    kr = _kv_for_queries(k, cfg)
    vr = _kv_for_queries(v, cfg)
    if cfg.attention_mode != "rm":
        if max_len is None:
            raise ValueError("exact attention's prefill cache needs max_len "
                             "(the ring buffer's length)")
        out = _softmax_attention(cfg, q, kr, vr, positions, positions)
        y = _out_proj(params, out.reshape(b, t, h * dh))
        return y, _exact_prefill_cache(cfg, k, v, positions, max_len)
    meta = rm_plan_for(cfg, dh)
    v_t = vr.transpose(1, 2)
    if rm_fuse_enabled(cfg):
        qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, kr)
        kvalid = (positions >= 0).float()
        out, s, n = rm_attention_fused_prefill(
            qs, ks, v_t, w, cd, cs, kvalid=kvalid, chunk=cfg.rm.chunk,
            eps=cfg.rm.eps)
    else:
        zq = _rm_featurize(params, cfg, meta, q)
        zk = rm_valid_mask(_rm_featurize(params, cfg, meta, kr), positions)
        out = rm_attention_causal(zq, zk, v_t, chunk=cfg.rm.chunk,
                                  eps=cfg.rm.eps)
        s, n = rm_attention_prefill_final_state(zk, v_t)
    y = _out_proj(params, out.transpose(1, 2).to(x.dtype)
                  .reshape(b, t, h * dh))
    return y, {"rm_s": s, "rm_n": n}


def _exact_decode(params: Params, cfg: ModelConfig, q, k, v,
                  cache: Dict[str, torch.Tensor], positions: torch.Tensor):
    """Exact decode: ring-buffer write at slot ``positions % size``, then
    softmax over the slots. Slot s holds the largest absolute position p
    <= ``positions`` with p % size == s; slots with p < 0 (not written
    yet) or out of the sliding window are masked. Under ``kv_seq`` a model
    rank holds slots ``[r * size / m, (r + 1) * size / m)`` of the buffer
    (every kv head), writes only the lanes whose slot it owns and runs the
    split-K decode (:func:`split_k_combine`)."""
    b = q.shape[0]
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    view = tp.kv_seq_view(cfg)
    local = k_cache.shape[1]
    size = local * (view.model_size if view is not None else 1)
    first = view.model_rank * local if view is not None else 0
    pos = positions.long()
    bidx = torch.arange(b, device=k_cache.device)
    slots = pos % size - first
    if view is None:
        k_cache[bidx, slots] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, slots] = v[:, 0].to(v_cache.dtype)
    else:
        own = (slots >= 0) & (slots < local)
        write_owned(k_cache, slots, own, k[:, 0])
        write_owned(v_cache, slots, own, v[:, 0])
    slot_ids = first + torch.arange(local, device=k_cache.device)[None, :]
    abs_pos = pos[:, None] - ((pos[:, None] - slot_ids) % size)
    valid = abs_pos >= 0
    if cfg.sliding_window > 0:
        valid = valid & ((pos[:, None] - abs_pos) < cfg.sliding_window)
    if view is not None:
        # every query head against this rank's slots, then the combine
        q_all = tp.gather_heads(q[:, 0])                   # [B, H, dh]
        rep = q_all.shape[1] // k_cache.shape[2]
        kk = _repeat_kv(k_cache, rep).float()
        scores = torch.einsum("bhd,bshd->bhs", q_all.float(),
                              kk) / math.sqrt(dh)
        vv = _repeat_kv(v_cache, rep).float()
        out = split_k_combine(
            scores, valid, lambda p: torch.einsum("bhs,bshd->bhd", p, vv),
            view, h).to(v_cache.dtype)
    else:
        kk = _kv_for_queries(k_cache, cfg)
        vv = _kv_for_queries(v_cache, cfg)
        scores = torch.einsum("bhd,bshd->bhs", q[:, 0].float(),
                              kk.float()) / math.sqrt(dh)
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhs,bshd->bhd", probs.to(vv.dtype), vv)
    y = _out_proj(params, out.reshape(b, 1, h * dh))
    return y, {"k": k_cache, "v": v_cache}


def write_owned(cache: torch.Tensor, slots: torch.Tensor, own: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slots[b]] = new[b]`` in place for the lanes ``own``
    marks (the slots this rank holds); the other lanes rewrite what they
    hold (no mask-sized index, so it runs on ``meta`` tensors too)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    at = slots.clamp(0, cache.shape[1] - 1)
    keep = cache[bidx, at]
    mask = own.reshape((-1,) + (1,) * (keep.ndim - 1))
    cache[bidx, at] = torch.where(mask, new.to(cache.dtype), keep)


def split_k_combine(scores: torch.Tensor, valid: torch.Tensor, weigh,
                    view, heads: int) -> torch.Tensor:
    """FlashDecoding's split-K over the model ranks' cache slots: from
    this rank's ``scores [B, H, S_r]`` of every query head (fp32; ``valid
    [B, S_r]`` masks the slots) and ``weigh(p)``, its values weighted by
    ``p [B, H, S_r]`` (``[B, H, dv]`` fp32), the partials ``[B, H, dv +
    2]`` (the weighted values, the max and the sum of the exponentials
    over its slots) are all-gathered over ``"model"`` and combined by
    their log-sum-exp into the softmax attention of this rank's ``heads``
    query heads (all of them in a part every rank holds whole) -> ``[B,
    heads, dv]`` fp32."""
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    mx = scores.amax(dim=-1)
    p = torch.where(valid[:, None, :], torch.exp(scores - mx[..., None]),
                    0.0)
    acc = weigh(p)
    parts = torch.cat([acc, mx[..., None], p.sum(dim=-1)[..., None]], -1)
    every = torch.stack(all_gather(parts.contiguous(), view.model_group))
    if heads != every.shape[2]:
        every = every[:, :, view.model_rank * heads:
                      (view.model_rank + 1) * heads]
    acc, mx, l = every[..., :-2], every[..., -2], every[..., -1]
    w = torch.exp(mx - mx.amax(dim=0))
    num = (acc * w[..., None]).sum(dim=0)
    return num / torch.clamp_min((l * w).sum(dim=0), 1e-30)[..., None]


def _exact_prefill_cache(cfg: ModelConfig, k, v, positions: torch.Tensor,
                         max_len: int) -> Dict[str, torch.Tensor]:
    """A fresh ring buffer holding the prompt's keys and values: slots
    ``[0, T)`` when the prompt fits, else its last ``size`` tokens at slot
    ``position % size``. Under ``kv_seq`` a model rank keeps its own
    slots of the buffer."""
    b, t = k.shape[:2]
    local = init_attention_cache(cfg, b, k.device, max_len, k.dtype)
    size = ring_size(cfg, max_len)
    cache = local if local["k"].shape[1] == size else {
        name: torch.zeros((b, size) + leaf.shape[2:], dtype=leaf.dtype,
                          device=leaf.device)
        for name, leaf in local.items()}
    if t <= size:
        cache["k"][:, :t] = k
        cache["v"][:, :t] = v
    else:
        slots = positions[:, -size:].long() % size
        bidx = torch.arange(b, device=k.device)[:, None]
        cache["k"][bidx, slots] = k[:, -size:]
        cache["v"][bidx, slots] = v[:, -size:]
    if cache is local:
        return cache
    width = local["k"].shape[1]
    first = tp.kv_seq_view(cfg).model_rank * width
    return {name: leaf.narrow(1, first, width).clone()
            for name, leaf in cache.items()}
