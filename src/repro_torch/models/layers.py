"""Common layers (port of ``repro.models.layers``, the parts the dense
qwen3 path uses): rmsnorm and the headwise qk-norm, RoPE, the SwiGLU MLP,
and the tied embedding / unembed.

Plain functions on dicts of tensors, with the reference's parameter names,
so a reference parameter tree maps across one leaf at a time
(``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def normal_init(generator: torch.Generator, shape, std: float,
                dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=generator.device)
            * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, dim: int, dtype, device) -> Params:
    if cfg.norm_kind != "rmsnorm":
        raise NotImplementedError(
            f"norm_kind={cfg.norm_kind!r} is not ported yet (rmsnorm only)")
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def apply_norm(params: Params, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + cfg.norm_eps) * params["scale"].float()
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
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind={cfg.mlp_kind!r} is not ported yet (swiglu only)")
    d, std = cfg.d_model, cfg.init_std
    return {
        "w_gate": normal_init(generator, (d, d_ff), std, dtype),
        "w_up": normal_init(generator, (d, d_ff), std, dtype),
        "w_down": normal_init(generator, (d_ff, d), std, dtype),
    }


def apply_mlp(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    return (F.silu(gate) * up) @ params["w_down"]


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
    return params["embedding"].to(compute_dtype)[tokens]


def unembed(params: Params, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (the matmul runs in the activations' dtype)."""
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    logits = logits.float()
    if cfg.logits_softcap > 0.0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits
