"""Attention, RM linear mode only (port of ``repro.models.attention``).

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

A non-causal config (an encoder) has a forward and its gradient only: the
prefill-cache and decode paths raise ``ValueError`` ("encoder-only"). Not
ported yet (ROADMAP.md queue A): ``attention_mode="exact"``, which raises
``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

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
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    normal_init,
    rms_norm_headwise,
)

Params = Dict[str, torch.Tensor]


def _require_decoder(cfg: ModelConfig) -> None:
    if not cfg.causal:
        raise ValueError(
            f"{cfg.name} is encoder-only: non-causal attention has a "
            "forward (a full encode) but no prefill cache or decode step")


def _require_rm(cfg: ModelConfig) -> None:
    if cfg.attention_mode != "rm":
        raise NotImplementedError(
            f"attention_mode={cfg.attention_mode!r} is not ported yet: the "
            "port has the RM linear attention mode only (exact softmax "
            "attention is queued in ROADMAP.md)")


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
        scale = F.softplus(params["rm_scale"]).float()
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


def rm_packed_weights(params: Params, cfg: ModelConfig) -> Params:
    """The attention params plus ``rm_w``: the family's packed weights in
    the precision policy's compute dtype (``registry`` ``pack``): for
    ``"rm"`` the omegas ``[max_degree, F, dh]`` that every fused op and the
    rm map read, for ``"tensor_sketch"`` the list ``[wr, wi, mr, mi]``
    packed in fp32 from the hash tables and then rounded once, for
    ``"ctr"`` the list ``[wr, wi]`` and for ``"structured"`` ``[d1, d2]``
    (values {0, +-1}, exact in either dtype). A fused non-causal config (an
    encoder) also gets ``rm_slab``: the same omegas laid out as the slab of
    kernels B3 and B4 (``kernels.rm_attention.noncausal.pack_noncausal``).
    Worked out once per weight set (``transformer.cast_params_to_compute``
    calls this); params that already hold them come back unchanged."""
    slab = not cfg.causal and rm_fuse_enabled(cfg)
    if "rm_w" in params and (not slab or "rm_slab" in params):
        return params
    meta = rm_plan_for(cfg, cfg.resolved_head_dim)
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
    _require_rm(cfg)
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
    meta = rm_plan_for(cfg, dh)
    params["rm_est"] = rm_estimator(cfg).init_params(meta, generator)
    if cfg.rm.learnable_scale:
        # softplus^-1(qk_scale)
        params["rm_scale"] = torch.tensor(
            math.log(math.expm1(cfg.rm.qk_scale)), dtype=torch.float32,
            device=device)
    return params


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor):
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
        q = rms_norm_headwise(q, params["q_norm_scale"], cfg.norm_eps)
        k = rms_norm_headwise(k, params["k_norm_scale"], cfg.norm_eps)
    return q, k, v


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


def attention_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (training forward, or an encoder's encode;
    causal or not as ``cfg.causal`` says). x: [B, T, d]."""
    _require_rm(cfg)
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions)
    k = _repeat_kv(k, cfg.q_per_kv)
    v = _repeat_kv(v, cfg.q_per_kv)
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
    return out.reshape(b, t, h * dh) @ params["wo"]


def init_attention_cache(cfg: ModelConfig, batch: int,
                         device) -> Dict[str, torch.Tensor]:
    """The O(1) rm decode state of one layer for ``batch`` lanes."""
    _require_rm(cfg)
    _require_decoder(cfg)
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    f = rm_plan_for(cfg, dh).output_dim
    return {
        "rm_s": torch.zeros((batch, h, f, dh), dtype=torch.float32,
                            device=device),
        "rm_n": torch.zeros((batch, h, f), dtype=torch.float32,
                            device=device),
    }


def attention_decode(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                 # [B, 1, d]
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,         # [B] position of the new token
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    _require_rm(cfg)
    _require_decoder(cfg)
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions[:, None])
    meta = rm_plan_for(cfg, dh)
    k = _repeat_kv(k, cfg.q_per_kv)
    v = _repeat_kv(v, cfg.q_per_kv)
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
    y = out.reshape(b, 1, h * dh).to(x.dtype) @ params["wo"]
    return y, {"rm_s": s_new, "rm_n": n_new}


def attention_prefill_cache(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,           # [B, T, d] prompt
    positions: torch.Tensor,   # [B, T]; -1 marks bucket padding
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill AND the decode state: one fused launch, or (two-launch path)
    the featurize launches, kernel B5 and the whole-prompt state. Padded
    prompt positions are masked out of the keys (``kvalid`` /
    :func:`rm_valid_mask`)."""
    _require_rm(cfg)
    _require_decoder(cfg)
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q, k = _apply_positional(cfg, q, k, positions)
    meta = rm_plan_for(cfg, dh)
    kr = _repeat_kv(k, cfg.q_per_kv)
    vr = _repeat_kv(v, cfg.q_per_kv)
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
    y = out.transpose(1, 2).to(x.dtype).reshape(b, t, h * dh) @ params["wo"]
    return y, {"rm_s": s, "rm_n": n}
