"""Common layers (port of ``repro.models.layers``): rmsnorm, layernorm,
the parameter-free layernorm (OLMo) and the headwise qk-norm, RoPE and
the sinusoidal position table, the SwiGLU and the biased GELU MLPs, and
the embedding / unembed.

Plain functions on dicts of tensors, with the reference's parameter names,
so a reference parameter tree maps across one leaf at a time
(``repro_torch.convert``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def normal_init(generator: torch.Generator, shape, std: float,
                dtype) -> torch.Tensor:
    """A weight drawn from ``generator``: N(0, std^2) in ``dtype``. Inside
    :func:`drawing` the active hook makes it instead."""
    hook = getattr(_draws, "hook", None)
    if hook is not None:
        return hook(generator, shape, std, dtype)
    return draw_normal(generator, shape, std, dtype)


def draw_normal(generator: torch.Generator, shape, std: float,
                dtype) -> torch.Tensor:
    """:func:`normal_init`'s own draw."""
    return (torch.randn(shape, generator=generator, device=generator.device)
            * std).to(dtype)


_draws = threading.local()


@contextlib.contextmanager
def drawing(hook):
    """Inside: every :func:`normal_init` returns ``hook(generator, shape,
    std, dtype)`` (``tensor_parallel.init_local_params`` cuts each weight
    as it is drawn; a ``meta`` stand-in for a dry run's shapes)."""
    prev = getattr(_draws, "hook", None)
    _draws.hook = hook
    try:
        yield
    finally:
        _draws.hook = prev


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, dim: int, dtype, device) -> Params:
    """rmsnorm: a scale; layernorm: a scale and a bias;
    ``nonparametric_ln`` (OLMo): no parameters, an empty dict."""
    if cfg.norm_kind == "nonparametric_ln":
        return {}
    params = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm_kind == "rmsnorm":
        return params
    if cfg.norm_kind == "layernorm":
        params["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
        return params
    raise ValueError(f"unknown norm_kind={cfg.norm_kind!r} (rmsnorm, "
                     "layernorm or nonparametric_ln)")


def apply_norm(params: Params, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm in fp32, cast back to the input dtype.
    LayerNorm takes the population variance, ``norm_eps`` inside the
    rsqrt, then the scale and the bias where ``params`` has them (the
    parameter-free norm has neither), as the reference does."""
    xf = x.float()
    if cfg.norm_kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * params["scale"].float()
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        if "scale" in params:
            out = out * params["scale"].float()
        if "bias" in params:
            out = out + params["bias"].float()
    return out.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Per-head qk-norm (Qwen3): normalize the trailing head_dim."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, generator, d_ff: int, dtype) -> Params:
    d, std = cfg.d_model, cfg.init_std
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": normal_init(generator, (d, d_ff), std, dtype),
            "w_up": normal_init(generator, (d, d_ff), std, dtype),
            "w_down": normal_init(generator, (d_ff, d), std, dtype),
        }
    if cfg.mlp_kind == "gelu":
        device = generator.device
        return {
            "w_up": normal_init(generator, (d, d_ff), std, dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": normal_init(generator, (d_ff, d), std, dtype),
            "b_down": torch.zeros((d,), dtype=dtype, device=device),
        }
    raise ValueError(f"unknown mlp_kind={cfg.mlp_kind!r} (swiglu or gelu)")


def apply_mlp(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or the biased GELU MLP. The reference's ``jax.nn.gelu`` is
    the tanh approximation by default (PyTorch's default is the exact erf
    form, up to ~1e-3 away), so the port asks for ``approximate="tanh"``.

    Under a model-parallel view (``distributed.tensor_parallel``)
    ``w_gate`` / ``w_up`` hold this rank's ff columns and ``w_down`` its ff
    rows: one all-reduce completes the block, and ``b_down`` is added once,
    after it."""
    x = tp.enter_block(x)
    if cfg.mlp_kind == "swiglu":
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        return tp.exit_block((F.silu(gate) * up) @ params["w_down"])
    up = x @ params["w_up"] + params["b_up"]
    return tp.exit_block(F.gelu(up, approximate="tanh")
                         @ params["w_down"]) + tp.sequence_params(
                             params["b_down"])


# ---------------------------------------------------------------------------
# depthwise causal conv (the Mamba and mLSTM front convs)
# ---------------------------------------------------------------------------
def causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor, x: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over T in x's dtype: x ``[B, T, C]``, taps
    ``conv_w [K, C]``, bias ``conv_b [C]``, ``state`` the previous call's
    last ``K - 1`` inputs (zeros when None) -> (out ``[B, T, C]``, the last
    ``K - 1`` inputs: the next call's window). The taps add in order, as
    the reference's Python ``sum`` adds them."""
    kk = conv_w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * conv_w[0].to(x.dtype)
    for i in range(1, kk):
        out = out + xp[:, i:i + t] * conv_w[i].to(x.dtype)
    return out + conv_b.to(x.dtype), xp[:, xp.shape[1] - (kk - 1):]


# ---------------------------------------------------------------------------
# rotary position embedding (half-rotation / llama style)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, T, H, Dh]; positions: [B, T] int.

    Padded prompt positions carry the sentinel -1 and are rotated like any
    other position, as in the reference: what keeps them out of the
    attention sums is the key mask (``positions >= 0``), not RoPE.
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs          # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, T] -> [B, T, dim] fp32: the classic table ``concat[sin, cos]``
    (halves, not interleaved) at frequencies ``10000^(-i / half)``.

    The power is taken in fp64 and rounded once to fp32, as the reference's
    XLA ``pow`` rounds it; PyTorch's fp32 ``pow`` is one ulp off for some
    exponents, which moves the angle at position 1500 by ~3e-5.
    """
    half = dim // 2
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (10000.0 ** expo.double()).float()
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def init_embedding(cfg: ModelConfig, generator, dtype) -> Params:
    params = {"embedding": normal_init(
        generator, (cfg.vocab_size, cfg.d_model), cfg.init_std, dtype)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal_init(
            generator, (cfg.d_model, cfg.vocab_size), cfg.init_std, dtype)
    return params


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """The tokens' rows; under a model-parallel view the table is this
    rank's vocab slice (``tensor_parallel.vocab_parallel_embed``) unless
    the local config keeps the vocabulary whole."""
    table = params["embedding"].to(compute_dtype)
    if tp.model_view() is not None and not tp.is_whole(cfg, "vocab"):
        return tp.vocab_parallel_embed(table, tokens)
    return table[tokens]


def unembed(params: Params, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (the matmul runs in the activations' dtype); under a
    model-parallel view, this rank's vocab columns (every column where the
    local config keeps the vocabulary whole), each softcapped (x this
    rank's slice of the sequence inside ``tensor_parallel.
    sequence_sharding``: it is gathered first)."""
    with tp.whole_part(cfg, "vocab"):
        x = tp.enter_block(x)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    logits = logits.float()
    if cfg.logits_softcap > 0.0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits
