"""xLSTM blocks (port of ``repro.models.xlstm``): the mLSTM (matrix
memory, chunkwise parallel) and the sLSTM (scalar memory, strictly
sequential, with memory mixing).

The mLSTM runs the stabilized chunkwise form: inside a ``cfg.xlstm.chunk``
slice the (t, s) weights are a bounded ``[C, C]`` matrix, and the matrix
memory (C, n, m) recurs across chunks in order. Every weight's exp is
taken relative to the per-step max ``m_t = max(intra-chunk max, b_t +
m_state)``, as in the sequential recurrence, so the chunked form equals
``mlstm_decode`` rolled T times. The reference's sentinels stay: ``m0 =
-1e30``, padded steps take ``i_log = -1e30``, and ``den = max(|den|,
exp(-m_t))`` reaches inf at a padded row whose stabilizer is the sentinel,
whose output is then 0 and sliced away. Its prefill cache is the closed
form ``m_T = max_s (i_s + F_T - F_s)``, ``C_T = sum_s exp(i_s + F_T - F_s -
m_T) k_s v_s^T`` (n likewise), F the cumulative log-forget sums.

The sLSTM is a loop over T of one cell step each (the reference's
``lax.scan``): in eager PyTorch, T host steps of small kernels a layer.

Both are attention-free: the paper's RM attention does not apply, and
``configs.get_config`` refuses ``attention_mode="rm"`` for xlstm. The
reference computes both in XLA, outside any Pallas kernel; the port
computes them in plain PyTorch. Caches: ``conv`` in the compute dtype,
every other state fp32. ``r_rec`` is fp32 in the masters and arrives in the
compute dtype (``cast_params_to_compute`` casts every fp32 leaf); the
recurrent product upcasts it to fp32, as the reference's mixed-dtype
einsum does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, normal_init

Params = Dict[str, torch.Tensor]

__all__ = ["init_mlstm", "mlstm_forward", "mlstm_prefill_cache",
           "init_mlstm_cache", "mlstm_decode", "init_slstm", "slstm_forward",
           "slstm_prefill_cache", "init_slstm_cache", "slstm_decode"]

SENTINEL = -1e30    # the reference's stand-in for log(0)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(cfg: ModelConfig, generator: torch.Generator,
               dtype) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    d_up = int(cfg.xlstm.proj_factor * d)
    std = cfg.init_std
    device = generator.device
    return {
        "w_up": normal_init(generator, (d, 2 * d_up), std, dtype),
        "conv_w": normal_init(generator, (cfg.xlstm.conv_kernel, d_up), std,
                              dtype),
        "conv_b": torch.zeros((d_up,), dtype=dtype, device=device),
        "wq": normal_init(generator, (d_up, d_up), std, dtype),
        "wk": normal_init(generator, (d_up, d_up), std, dtype),
        "wv": normal_init(generator, (d_up, d_up), std, dtype),
        "w_if": normal_init(generator, (d_up, 2 * h), std, dtype),
        # the forget gate's bias starts high
        "b_if": torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 3.0, device=device)]).to(dtype),
        "gn_scale": torch.ones((d_up,), dtype=dtype, device=device),
        "w_down": normal_init(generator, (d_up, d), std, dtype),
    }


def _mlstm_qkv_gates(params: Params, cfg: ModelConfig, xu: torch.Tensor,
                     conv_state: Optional[torch.Tensor] = None):
    """xu ``[B, T, d_up]`` -> q, k, v ``[B, T, H, dh]`` (compute dtype, k
    over sqrt(dh)), the input and forget gate logits ``[B, T, H]`` fp32,
    and the conv window."""
    h = cfg.num_heads
    xc, new_conv = causal_conv(params["conv_w"], params["conv_b"], xu,
                               conv_state)
    xc = F.silu(xc)
    b, t, d_up = xu.shape
    dh = d_up // h
    q = (xc @ params["wq"]).reshape(b, t, h, dh)
    k = (xc @ params["wk"]).reshape(b, t, h, dh) / math.sqrt(dh)
    v = (xu @ params["wv"]).reshape(b, t, h, dh)
    gates = (xc @ params["w_if"] + params["b_if"].to(xu.dtype)).float()
    return q, k, v, gates[..., :h], gates[..., h:], new_conv


def _mlstm_cell_chunked(cfg: ModelConfig, q, k, v, i_log, f_log):
    """The stabilized chunkwise mLSTM -> out ``[B, T, H, dh]`` fp32."""
    b, t, h, dh = q.shape
    chunk = min(cfg.xlstm.chunk, t)
    pad = (-t) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=SENTINEL)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    tp = t + pad
    dev = q.device
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))[None, :, :, None]
    c_state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    n_state = torch.zeros((b, h, dh), dtype=torch.float32, device=dev)
    m_state = torch.full((b, h), SENTINEL, dtype=torch.float32, device=dev)
    outs = []
    for j in range(tp // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        qq, kk, vv = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ii = i_log[:, sl].float()
        logf = F.logsigmoid(f_log[:, sl].float())                # [B,C,H]
        bcum = torch.cumsum(logf, dim=1)                         # inclusive
        btot = bcum[:, -1]                                       # [B,H]

        # per-step stabilizer: the intra max over s <= t of (b_t - b_s +
        # i_s), the inter term b_t + m_state
        lw_intra = (bcum[:, :, None, :] - bcum[:, None, :, :]
                    + ii[:, None, :, :])                         # [B,Ct,Cs,H]
        lw_intra = torch.where(mask, lw_intra,
                               torch.full_like(lw_intra, SENTINEL))
        m_intra = lw_intra.max(dim=2).values                     # [B,Ct,H]
        m_inter = bcum + m_state[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)

        w_intra = torch.exp(lw_intra - m_t[:, :, None, :])
        scores = torch.einsum("bqhd,bshd->bqsh", qq, kk) * w_intra
        num = torch.einsum("bqsh,bshd->bqhd", scores, vv)
        den = scores.sum(dim=2)                                  # [B,Ct,H]

        w_inter = torch.exp(m_inter - m_t)
        q_eff = qq * w_inter[..., None]
        num = num + torch.einsum("bqhd,bhdv->bqhv", q_eff, c_state)
        den = den + torch.einsum("bqhd,bhd->bqh", q_eff, n_state)

        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])                        # [B,C,H,dh]

        # the state at the end of the chunk
        lw_st = btot[:, None] - bcum + ii                        # [B,C,H]
        m_new = torch.maximum(m_state + btot, lw_st.max(dim=1).values)
        w_st = torch.exp(lw_st - m_new[:, None])
        decay = torch.exp(m_state + btot - m_new)
        c_state = (decay[..., None, None] * c_state
                   + torch.einsum("bsh,bshd,bshv->bhdv", w_st, kk, vv))
        n_state = (decay[..., None] * n_state
                   + torch.einsum("bsh,bshd->bhd", w_st, kk))
        m_state = m_new
    return torch.cat(outs, dim=1)[:, :t]


def _group_norm(x: torch.Tensor, scale: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    """Per-head group norm over the feature dim (population variance).
    x ``[..., D]`` fp32 -> fp32."""
    shape = x.shape
    xg = x.reshape(*shape[:-1], groups, shape[-1] // groups)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(shape) * scale.to(x.dtype)


def _mlstm_core(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """-> (y ``[B, T, d]``, k, v, the gate logits, the conv window)."""
    b, t, _ = x.shape
    xu, z = torch.chunk(x @ params["w_up"], 2, dim=-1)
    q, k, v, i_log, f_log, conv = _mlstm_qkv_gates(params, cfg, xu)
    out = _mlstm_cell_chunked(cfg, q, k, v, i_log, f_log).reshape(b, t, -1)
    out = _group_norm(out, params["gn_scale"], cfg.num_heads, cfg.norm_eps)
    out = out * F.silu(z.float())
    return out.to(x.dtype) @ params["w_down"], k, v, i_log, f_log, conv


def mlstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions=None) -> torch.Tensor:
    """Chunkwise-parallel stabilized mLSTM. x ``[B, T, d]``."""
    return _mlstm_core(params, cfg, x)[0]


def mlstm_prefill_cache(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions=None, max_len: Optional[int] = None):
    """Forward + the closed-form final (C, n, m) state and conv window."""
    y, k, v, i_log, f_log, conv = _mlstm_core(params, cfg, x)
    f_cum = torch.cumsum(F.logsigmoid(f_log), dim=1)            # [B,T,H]
    lw = i_log + f_cum[:, -1:] - f_cum
    m = lw.max(dim=1).values                                    # [B,H]
    w = torch.exp(lw - m[:, None, :])
    kf, vf = k.float(), v.float()
    c_state = torch.einsum("bth,bthd,bthv->bhdv", w, kf, vf)
    n_state = torch.einsum("bth,bthd->bhd", w, kf)
    return y, {"conv": conv, "c": c_state, "n": n_state, "m": m}


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero state: ``conv`` in ``dtype``, ``c [batch, H, dh, dh]``, ``n``
    and ``m`` (the sentinel) fp32."""
    h = cfg.num_heads
    d_up = int(cfg.xlstm.proj_factor * cfg.d_model)
    dh = d_up // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, d_up),
                            dtype=dtype, device=device),
        "c": torch.zeros((batch, h, dh, dh), **f32),
        "n": torch.zeros((batch, h, dh), **f32),
        "m": torch.full((batch, h), SENTINEL, **f32),
    }


def mlstm_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], positions=None):
    """x ``[B, 1, d]``: one step of the stabilized recurrence."""
    b = x.shape[0]
    xu, z = torch.chunk(x @ params["w_up"], 2, dim=-1)
    q, k, v, i_log, f_log, conv = _mlstm_qkv_gates(
        params, cfg, xu, conv_state=cache["conv"])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                         # [B,H,dh]
    i_log, f_log = i_log[:, 0], f_log[:, 0]                     # [B,H]
    logf = F.logsigmoid(f_log)
    m_new = torch.maximum(logf + cache["m"], i_log)
    f_eff = torch.exp(logf + cache["m"] - m_new)
    i_eff = torch.exp(i_log - m_new)
    c_new = (f_eff[..., None, None] * cache["c"]
             + i_eff[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = f_eff[..., None] * cache["n"] + i_eff[..., None] * k
    qf = q.float()
    num = torch.einsum("bhd,bhdv->bhv", qf, c_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new).abs()
    den = torch.maximum(den, torch.exp(-m_new))
    out = (num / den[..., None]).reshape(b, 1, -1)
    out = _group_norm(out, params["gn_scale"], cfg.num_heads, cfg.norm_eps)
    out = out * F.silu(z.float())
    y = out.to(x.dtype) @ params["w_down"]
    return y, {"conv": conv, "c": c_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(cfg: ModelConfig, generator: torch.Generator,
               dtype) -> Params:
    """The input weights for (z, i, f, o), the block-diagonal recurrent
    mixing ``r_rec [4, H, dh, dh]`` (fp32 whatever ``dtype`` is, as in the
    reference), the group norm's scale and the post-cell GELU FFN."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    std = cfg.init_std
    d_ff = int(cfg.xlstm.slstm_ff_factor * d)
    device = generator.device
    return {
        "w_in": normal_init(generator, (d, 4 * d), std, dtype),
        "b_in": torch.cat([torch.zeros((2 * d,), device=device),
                           torch.full((d,), 3.0, device=device),
                           torch.zeros((d,), device=device)]).to(dtype),
        "r_rec": normal_init(generator, (4, h, dh, dh), std / math.sqrt(dh),
                             torch.float32),
        "gn_scale": torch.ones((d,), dtype=dtype, device=device),
        "ff_up": normal_init(generator, (d, d_ff), std, dtype),
        "ff_down": normal_init(generator, (d_ff, d), std, dtype),
    }


def _slstm_cell(params: Params, cfg: ModelConfig, wx: torch.Tensor, state):
    """wx ``[B, 4, H, dh]``, the input's contribution; one time step of
    the fp32 state (h, c, n, m), each ``[B, H, dh]``."""
    h_prev, c_prev, n_prev, m_prev = state
    rec = torch.einsum("bhd,ghde->bghe", h_prev, params["r_rec"].float())
    pre = wx.float() + rec                                      # [B,4,H,dh]
    z_t = torch.tanh(pre[:, 0])
    i_log = pre[:, 1]
    f_log = F.logsigmoid(pre[:, 2])
    o_t = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_log + m_prev, i_log)
    i_eff = torch.exp(i_log - m_new)
    f_eff = torch.exp(f_log + m_prev - m_new)
    c_new = f_eff * c_prev + i_eff * z_t
    n_new = f_eff * n_prev + i_eff
    h_new = o_t * c_new / torch.clamp_min(n_new, 1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_out(params: Params, cfg: ModelConfig, hs: torch.Tensor,
               dtype) -> torch.Tensor:
    """The cells' outputs ``[B, T, d]`` fp32 -> group norm -> the block's
    GELU feed-forward (the reference's ``jax.nn.gelu``: tanh form)."""
    out = _group_norm(hs, params["gn_scale"], cfg.num_heads, cfg.norm_eps)
    y = out.to(dtype)
    return F.gelu(y @ params["ff_up"], approximate="tanh") @ params["ff_down"]


def _slstm_scan(params: Params, cfg: ModelConfig, x: torch.Tensor, state):
    b, t, d = x.shape
    h = cfg.num_heads
    wx = (x @ params["w_in"] + params["b_in"].to(x.dtype)).reshape(
        b, t, 4, h, d // h)
    hs = []
    for i in range(t):
        state = _slstm_cell(params, cfg, wx[:, i], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1).reshape(b, t, d), state


def _slstm_state0(cfg: ModelConfig, batch: int, device):
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return (zeros, zeros, zeros,
            torch.full(shape, SENTINEL, dtype=torch.float32, device=device))


def slstm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions=None) -> torch.Tensor:
    hs, _ = _slstm_scan(params, cfg, x,
                        _slstm_state0(cfg, x.shape[0], x.device))
    return _slstm_out(params, cfg, hs, x.dtype)


def slstm_prefill_cache(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions=None, max_len: Optional[int] = None):
    """Forward + the final recurrent state (the scan's carry)."""
    hs, (h_f, c_f, n_f, m_f) = _slstm_scan(
        params, cfg, x, _slstm_state0(cfg, x.shape[0], x.device))
    y = _slstm_out(params, cfg, hs, x.dtype)
    return y, {"h": h_f, "c": c_f, "n": n_f, "m": m_f}


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero state (h, c, n zeros, m the sentinel), each ``[batch, H,
    dh]`` fp32 (``dtype`` is unused: no sLSTM state is in the compute
    dtype)."""
    h_, c_, n_, m_ = _slstm_state0(cfg, batch, device)
    return {"h": h_, "c": c_.clone(), "n": n_.clone(), "m": m_}


def slstm_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], positions=None):
    b, _, d = x.shape
    h = cfg.num_heads
    wx = (x @ params["w_in"] + params["b_in"].to(x.dtype)).reshape(
        b, 4, h, d // h)
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    h_new, c, n, m = _slstm_cell(params, cfg, wx, state)
    y = _slstm_out(params, cfg, h_new.reshape(b, 1, d), x.dtype)
    return y, {"h": h_new, "c": c, "n": n, "m": m}
