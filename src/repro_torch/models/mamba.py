"""Mamba-1 selective SSM block, Jamba's 7-of-8 layers (port of
``repro.models.mamba``).

Forward and prefill scan the sequence in ``scan_chunk`` slices: inside a
chunk an inclusive scan under the operator ``(a1, u1) o (a2, u2) = (a1 a2,
a2 u1 + u2)``, taken for every chunk at once in log2(C) doubling steps
(the reference's ``jax.lax.associative_scan``; a cumulative product
divided out would underflow), then the carry crosses the chunks in order
(the reference's ``lax.scan``). Padded steps take ``a_bar = 1``, ``bx =
0``, so the carry passes them unchanged. Decode is the O(1) recurrence
with (conv window, ssm state) in the cache: ``conv`` in the compute dtype,
``ssm`` fp32.

The reference computes all of this in XLA, outside any Pallas kernel, and
the port computes it in plain PyTorch. The SSM dynamics run in fp32 from
the compute-dtype projections, at the reference's cast points: ``a_log``
and ``d_skip`` arrive in the compute dtype (``cast_params_to_compute``
casts every fp32 leaf) and are upcast where they are read.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv, normal_init

Params = Dict[str, torch.Tensor]

__all__ = ["init_mamba", "mamba_forward", "mamba_prefill_cache",
           "init_mamba_cache", "mamba_decode"]


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or math.ceil(cfg.d_model / 16)


def init_mamba(cfg: ModelConfig, generator: torch.Generator,
               dtype) -> Params:
    """The reference's leaves on the generator's device; ``a_log`` (the
    S4D-real init ``log(1..N)``) and ``d_skip`` are fp32 whatever
    ``dtype`` is, as in the reference."""
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    n = mc.d_state
    r = _dt_rank(cfg)
    std = cfg.init_std
    device = generator.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float64,
                                   device=device)).float().expand(
                                       d_in, n).clone()
    return {
        "w_in": normal_init(generator, (d, 2 * d_in), std, dtype),
        "conv_w": normal_init(generator, (mc.d_conv, d_in), std, dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": normal_init(generator, (d_in, r + 2 * n), std, dtype),
        "dt_proj": normal_init(generator, (r, d_in), std, dtype),
        "dt_bias": torch.full((d_in,), math.log(math.expm1(0.01)),
                              dtype=dtype, device=device),
        "a_log": a_log,
        "d_skip": torch.ones((d_in,), dtype=torch.float32, device=device),
        "w_out": normal_init(generator, (d_in, d), std, dtype),
    }


def _ssm_coeffs(params: Params, cfg: ModelConfig, xc: torch.Tensor):
    """xc ``[B, T, d_in]`` (after the conv) -> ``a_bar``, ``bx`` ``[B, T,
    d_in, N]`` and ``c`` ``[B, T, N]``, all fp32."""
    n = cfg.mamba.d_state
    r = _dt_rank(cfg)
    proj = xc @ params["x_proj"]                              # [B,T,r+2n]
    dt, b_in, c_in = torch.split(proj, [r, n, n], dim=-1)
    # the softplus in the projections' dtype, as the reference takes it
    dt = F.softplus(dt @ params["dt_proj"]
                    + params["dt_bias"].to(dt.dtype)).float()  # [B,T,d_in]
    a = -torch.exp(params["a_log"].float())                   # [d_in, N]
    a_bar = torch.exp(dt[..., None] * a)
    # Euler-discretized input: dt * B * x
    bx = dt[..., None] * b_in[:, :, None, :].float() * xc[..., None].float()
    return a_bar, bx, c_in.float()


def _chunk_scan(a: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Inclusive scan along dim 2 of ``[B, nch, C, d_in, N]`` under ``(a1,
    u1) o (a2, u2) = (a1 a2, a2 u1 + u2)``, log2(C) doubling steps (out of
    place, so autograd sees every step)."""
    c = a.shape[2]
    off = 1
    while off < c:
        u = torch.cat([u[:, :, :off],
                       a[:, :, off:] * u[:, :, :-off] + u[:, :, off:]], dim=2)
        a = torch.cat([a[:, :, :off], a[:, :, off:] * a[:, :, :-off]], dim=2)
        off *= 2
    return a, u


def _mamba_core(params: Params, cfg: ModelConfig, x: torch.Tensor):
    """The chunked-scan forward -> (y ``[B, T, d]``, the pre-conv input xs
    ``[B, T, d_in]``, the final ssm state ``[B, d_in, N]`` fp32)."""
    mc = cfg.mamba
    b, t, _ = x.shape
    xs, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    xc, _ = causal_conv(params["conv_w"], params["conv_b"], xs)
    xc = F.silu(xc)
    a_bar, bx, c = _ssm_coeffs(params, cfg, xc)
    d_in, n = a_bar.shape[2], a_bar.shape[3]

    chunk = min(mc.scan_chunk, t)
    pad = (-t) % chunk
    if pad:
        a_bar = F.pad(a_bar, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
    nch = (t + pad) // chunk
    cum_a, cum_u = _chunk_scan(a_bar.reshape(b, nch, chunk, d_in, n),
                               bx.reshape(b, nch, chunk, d_in, n))
    # the carry into each chunk, chunk by chunk
    h = torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device)
    starts = []
    for j in range(nch):
        starts.append(h)
        h = cum_a[:, j, -1] * h + cum_u[:, j, -1]
    hs = cum_a * torch.stack(starts, dim=1)[:, :, None] + cum_u
    hs = hs.reshape(b, nch * chunk, d_in, n)[:, :t]

    y = torch.einsum("btdn,btn->btd", hs, c)
    y = y + params["d_skip"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["w_out"], xs, h


def mamba_forward(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions=None) -> torch.Tensor:
    """x ``[B, T, d]`` -> ``[B, T, d]``."""
    return _mamba_core(params, cfg, x)[0]


def mamba_prefill_cache(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions=None, max_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + the final (conv window, ssm state) for the decode
    handoff: the same scan as ``mamba_forward``, keeping its carry."""
    kk = cfg.mamba.d_conv
    y, xs, h = _mamba_core(params, cfg, x)
    xs_pad = F.pad(xs, (0, 0, kk - 1, 0))
    return y, {"conv": xs_pad[:, xs_pad.shape[1] - (kk - 1):], "ssm": h}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero state for ``batch`` lanes: ``conv [batch, d_conv - 1, d_in]``
    in ``dtype`` (the compute dtype), ``ssm [batch, d_in, N]`` fp32."""
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, mc.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], positions=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x ``[B, 1, d]``: the O(1) per-token recurrence."""
    xs, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    xc, conv_state = causal_conv(params["conv_w"], params["conv_b"], xs,
                                 cache["conv"])
    xc = F.silu(xc)
    a_bar, bx, c = _ssm_coeffs(params, cfg, xc)
    h = cache["ssm"] * a_bar[:, 0] + bx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None]
    y = y + params["d_skip"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["w_out"], {"conv": conv_state, "ssm": h}
