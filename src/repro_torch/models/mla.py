"""DeepSeek-V2 Multi-head Latent Attention (port of ``repro.models.mla``).

Queries are ``x @ w_q`` (no query compression, as V2-Lite), split into a
``qk_nope_head_dim`` part and a ``qk_rope_head_dim`` part that takes RoPE.
Keys and values decompress from a latent: ``x @ w_dkv`` gives the latent
``c_kv`` (``kv_lora_rank`` wide, RMS-normed) and one shared rope key
``k_pe`` for every head; ``c_kv @ w_ukv`` gives each head's nope key and
its value. So q and k are ``nope + rope`` wide (192 in DeepSeek-V2-Lite)
against values of ``v_head_dim`` (128).

``attention_mode="rm"`` featurizes the decompressed q/k with the config's
plan at width ``nope + rope`` and keeps the O(1) linear-attention state
``rm_s [B, H, F, dv]`` / ``rm_n [B, H, F]`` instead of a latent cache:

* fused (``rm_fuse_enabled``): forward and prefill through one launch of
  kernel B2 (``rm_attention_fused_causal`` / ``rm_attention_fused_prefill``,
  which also returns the decode state), decode through one launch of B1
  for the stacked q and k (``rm_attention_fused_decode_step``);
* two-launch: the family's featurize (B1, B6, B7 or B8), then kernel B5
  (forward, prefill) or the O(1) state update (decode).

``attention_mode="exact"`` runs the port's softmax attention (small or
blockwise, plain PyTorch) over the decompressed heads, caches the latent
``c_kv`` and ``k_pe`` and decodes with the absorbed projections: the nope
query goes through ``w_uk`` into latent space, scores against the cached
latents, and the attended latent comes back through ``w_uv``. The exact
cache is written in place at each lane's position.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.rm_attention.ops import (
    rm_attention_causal,
    rm_attention_decode_step,
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_prefill,
    rm_attention_prefill_final_state,
)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.attention import (
    NEG_INF,
    _rm_featurize,
    _rm_fused_operands,
    _softmax_attention,
    rm_estimator,
    rm_fuse_enabled,
    rm_plan_for,
    rm_valid_mask,
    seq_cut,
    split_k_combine,
    write_owned,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    normal_init,
    rms_norm_headwise,
)

Params = Dict[str, torch.Tensor]

__all__ = ["init_mla", "mla_qk_dim", "mla_forward", "init_mla_cache",
           "mla_prefill_cache", "mla_decode"]


def mla_qk_dim(cfg: ModelConfig) -> int:
    """The width of MLA's queries and keys, the rm plan's input width."""
    return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim


def init_mla(cfg: ModelConfig, generator: torch.Generator, dtype,
             device) -> Params:
    """The projections and the latent's norm scale, plus, in rm mode, the
    estimator draws ``rm_est`` (at width ``nope + rope``) and
    ``rm_scale``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_dim = mla_qk_dim(cfg)
    std = cfg.init_std
    params: Params = {
        "w_q": normal_init(generator, (d, h * qk_dim), std, dtype),
        "w_dkv": normal_init(generator,
                             (d, m.kv_lora_rank + m.qk_rope_head_dim), std,
                             dtype),
        "kv_norm_scale": torch.ones((m.kv_lora_rank,), dtype=dtype,
                                    device=device),
        "w_ukv": normal_init(
            generator,
            (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)), std,
            dtype),
        "w_o": normal_init(generator, (h * m.v_head_dim, d), std, dtype),
    }
    if cfg.attention_mode == "rm":
        meta = rm_plan_for(cfg, qk_dim)
        params["rm_est"] = rm_estimator(cfg).init_params(meta, generator)
        if cfg.rm.learnable_scale:
            params["rm_scale"] = torch.tensor(
                math.log(math.expm1(cfg.rm.qk_scale)), dtype=torch.float32,
                device=device)
    return params


def _mla_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """Decompressed q, k ``[B, T, H, nope + rope]``, v ``[B, T, H, dv]``,
    the normed latent ``c_kv [B, T, lora]`` and the roped shared key
    ``k_pe [B, T, 1, rope]``. Under a model-parallel view H is this rank's
    heads (``w_q``, ``w_ukv`` column slices); the latent and the shared key
    are computed whole on every rank and enter the per-head region through
    ``tensor_parallel.copy_to_model``."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    nope, rope, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = (tp.copy_to_model(x) @ params["w_q"]).reshape(b, t, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    ckv = x @ params["w_dkv"]
    c_kv, k_pe = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c_kv = rms_norm_headwise(c_kv, params["kv_norm_scale"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)

    kv = (tp.copy_to_model(c_kv) @ params["w_ukv"]).reshape(b, t, h,
                                                             nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, tp.copy_to_model(k_pe).expand(b, t, h, rope)],
                  dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    return q_full, k, v, c_kv, k_pe


def _out_proj(params: Params, cfg: ModelConfig, out: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, dv]`` attention output -> ``[B, T, d]`` (the model
    ranks' parts summed by one all-reduce)."""
    b, _, t, dv = out.shape
    out = out.transpose(1, 2).to(x.dtype)
    return tp.reduce_from_model(out.reshape(b, t, cfg.num_heads * dv)
                                @ params["w_o"])


def mla_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA. x: [B, T, d] -> [B, T, d]."""
    b, t, _ = x.shape
    q, k, v, _, _ = _mla_qkv(params, cfg, x, positions)
    if cfg.attention_mode != "rm":
        out = _softmax_attention(cfg, q, k, v, positions, positions)
        return tp.reduce_from_model(
            out.reshape(b, t, cfg.num_heads * cfg.mla.v_head_dim)
            @ params["w_o"])
    meta = rm_plan_for(cfg, mla_qk_dim(cfg))
    v_t = v.transpose(1, 2)
    if rm_fuse_enabled(cfg):
        qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, k)
        out = rm_attention_fused_causal(qs, ks, v_t, w, cd, cs,
                                        chunk=cfg.rm.chunk, eps=cfg.rm.eps)
    else:
        zq = _rm_featurize(params, cfg, meta, q)
        zk = _rm_featurize(params, cfg, meta, k)
        out = rm_attention_causal(zq, zk, v_t, chunk=cfg.rm.chunk,
                                  eps=cfg.rm.eps)
    return _out_proj(params, cfg, out, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """One layer's decode cache: the rm state (fp32), or exact's latent
    ``c_kv [batch, max_len, lora]`` and ``k_pe [batch, max_len, rope]`` in
    ``dtype`` (a model rank's ``max_len / model_shards`` positions where
    ``cfg.kv_seq`` cuts them by sequence).

    Raises:
        ValueError: under ``kv_seq``, a ``max_len`` the model axis does not
            divide.
    """
    m = cfg.mla
    if cfg.attention_mode == "rm":
        f = rm_plan_for(cfg, mla_qk_dim(cfg)).output_dim
        return {
            "rm_s": torch.zeros((batch, cfg.num_heads, f, m.v_head_dim),
                                dtype=torch.float32, device=device),
            "rm_n": torch.zeros((batch, cfg.num_heads, f),
                                dtype=torch.float32, device=device),
        }
    size = seq_cut(cfg, max_len, "the latent cache")
    return {
        "c_kv": torch.zeros((batch, size, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, size, m.qk_rope_head_dim),
                            dtype=dtype, device=device),
    }


def mla_prefill_cache(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill AND the decode cache (latent or RM state). The fused rm
    path gives the outputs and the state from one B2 launch, padded
    prompt positions masked out of the keys (``kvalid``); the two-launch
    path masks them out of the featurized keys (``rm_valid_mask``)."""
    b, t, _ = x.shape
    q, k, v, c_kv, k_pe = _mla_qkv(params, cfg, x, positions)
    if cfg.attention_mode == "rm":
        meta = rm_plan_for(cfg, mla_qk_dim(cfg))
        v_t = v.transpose(1, 2)
        if rm_fuse_enabled(cfg):
            qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, k)
            out, s, n = rm_attention_fused_prefill(
                qs, ks, v_t, w, cd, cs, kvalid=(positions >= 0).float(),
                chunk=cfg.rm.chunk, eps=cfg.rm.eps)
        else:
            zq = _rm_featurize(params, cfg, meta, q)
            zk = rm_valid_mask(_rm_featurize(params, cfg, meta, k),
                               positions)
            out = rm_attention_causal(zq, zk, v_t, chunk=cfg.rm.chunk,
                                      eps=cfg.rm.eps)
            s, n = rm_attention_prefill_final_state(zk, v_t)
        return _out_proj(params, cfg, out, x), {"rm_s": s, "rm_n": n}
    out = _softmax_attention(cfg, q, k, v, positions, positions)
    y = tp.reduce_from_model(
        out.reshape(b, t, cfg.num_heads * cfg.mla.v_head_dim) @ params["w_o"])
    cache = init_mla_cache(cfg, b, max_len, x.dtype, x.device)
    view = tp.kv_seq_view(cfg)
    if view is None:
        cache["c_kv"][:, :t] = c_kv
        cache["k_pe"][:, :t] = k_pe[:, :, 0]
        return y, cache
    # this rank's positions of the prompt
    size = cache["c_kv"].shape[1]
    first = view.model_rank * size
    n = max(0, min(t, first + size) - first)
    cache["c_kv"][:, :n] = c_kv[:, first:first + n]
    cache["k_pe"][:, :n] = k_pe[:, first:first + n, 0]
    return y, cache


def mla_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, 1, d], positions [B]. rm: the O(1) state update. exact: the
    new latent written into the cache in place at ``positions``, then the
    absorbed-latent attention over every cached position <= it."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    nope, rope, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q, k, v, c_kv_t, k_pe_t = _mla_qkv(params, cfg, x, positions[:, None])

    if cfg.attention_mode == "rm":
        meta = rm_plan_for(cfg, nope + rope)
        v0 = v[:, 0]                                       # [B, H, dv]
        if rm_fuse_enabled(cfg):
            # q and k share one featurize launch a decoded token
            qs, ks, w, cd, cs = _rm_fused_operands(params, cfg, meta, q, k)
            out, s_new, n_new = rm_attention_fused_decode_step(
                qs[:, :, 0], ks[:, :, 0], v0, cache["rm_s"], cache["rm_n"],
                w, cd, cs, eps=cfg.rm.eps)
        else:
            zq = _rm_featurize(params, cfg, meta, q)[:, :, 0]
            zk = _rm_featurize(params, cfg, meta, k)[:, :, 0]
            out, s_new, n_new = rm_attention_decode_step(
                zq, zk, v0, cache["rm_s"], cache["rm_n"], eps=cfg.rm.eps)
        y = tp.reduce_from_model(out.reshape(b, 1, h * dv).to(x.dtype)
                                 @ params["w_o"])
        return y, {"rm_s": s_new, "rm_n": n_new}

    c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
    view = tp.kv_seq_view(cfg)
    size = c_cache.shape[1]
    first = view.model_rank * size if view is not None else 0
    pos = positions.long()
    bidx = torch.arange(b, device=x.device)
    if view is None:
        c_cache[bidx, pos] = c_kv_t[:, 0].to(c_cache.dtype)
        pe_cache[bidx, pos] = k_pe_t[:, 0, 0].to(pe_cache.dtype)
    else:
        at = pos - first
        own = (at >= 0) & (at < size)
        write_owned(c_cache, at, own, c_kv_t[:, 0])
        write_owned(pe_cache, at, own, k_pe_t[:, 0, 0])

    # absorbed scores: the nope query through w_uk into latent space
    w_ukv = params["w_ukv"].reshape(m.kv_lora_rank, h, nope + dv)
    w_uk, w_uv = w_ukv[..., :nope].float(), w_ukv[..., nope:].float()
    q_nope, q_pe = q[:, 0, :, :nope].float(), q[:, 0, :, nope:].float()
    c_f, pe_f = c_cache.float(), pe_cache.float()
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope, w_uk)
    valid = first + torch.arange(size, device=x.device)[None, :] \
        <= pos[:, None]
    if view is not None:
        # split-K: every head's latent query against this rank's positions
        q_all = tp.gather_heads(torch.cat([q_lat, q_pe], dim=-1))
        q_lat, q_pe = q_all[..., :m.kv_lora_rank], q_all[..., m.kv_lora_rank:]
    scores = torch.einsum("bhl,bsl->bhs", q_lat, c_f)
    scores = scores + torch.einsum("bhr,bsr->bhs", q_pe, pe_f)
    scores = scores / math.sqrt(nope + rope)
    if view is not None:
        o_lat = split_k_combine(
            scores, valid, lambda p: torch.einsum("bhs,bsl->bhl", p, c_f),
            view, h)
    else:
        scores = torch.where(valid[:, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", probs, c_f)
    out = torch.einsum("bhl,lhv->bhv", o_lat, w_uv)
    y = tp.reduce_from_model(out.reshape(b, 1, h * dv).to(x.dtype)
                             @ params["w_o"])
    return y, {"c_kv": c_cache, "k_pe": pe_cache}
