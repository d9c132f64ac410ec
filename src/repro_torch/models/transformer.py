"""Model assembly, dense path (port of ``repro.models.transformer``).

The reference scans a stacked ``params["groups"]`` over layers; the port
keeps one parameter dict per layer in ``params["layers"]`` and loops over
them (PyTorch runs eagerly, there is no compile to keep small). Block kind
``"attn_mlp"`` only; MoE, MLA and SSM blocks are not ported yet. Inputs
are tokens, precomputed frame embeddings (``frontend="audio_stub"``, the
HuBERT encoder), or both; an encoder (``causal=False``) has ``forward`` and
``loss_fn`` but no prefill cache or decode step. ``loss_fn`` is
differentiable end to end on the fused rm path (the attention ops are
``torch.autograd.Function``s) and on the exact path (plain PyTorch, through
autograd); the two-launch path's featurize kernels have no backward
(ROADMAP.md queue C).

Parameters are plain nested dicts of tensors with the reference's leaf
names; the fp32 master weights get a compute-dtype copy, with each
layer's estimator weights packed for the kernels, through
``cast_params_to_compute`` (a no-op on params it has already returned, so
a caller that casts once — the serving executor — pays nothing per step).
The copies are differentiable casts: gradients reach the fp32 masters. The
packed ``rm_w`` / ``rm_slab`` live only in the compute copy, never in the
masters a train state holds.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.dtypes import canonical_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_embedding,
    init_mlp,
    init_norm,
    sinusoidal_positions,
    unembed,
)

Params = Dict[str, Any]

__all__ = [
    "init_model",
    "cast_params_to_compute",
    "forward",
    "loss_fn",
    "prefill",
    "init_decode_cache",
    "decode_step",
    "layer_kinds",
]


def layer_kinds(cfg: ModelConfig):
    """Block kind of every layer, in order (``first_k_dense`` leading
    blocks, then the pattern repeated)."""
    kinds = []
    if cfg.first_k_dense:
        kinds.extend(["attn_mlp"] * cfg.first_k_dense)
    kinds.extend(list(cfg.block_pattern) * cfg.num_scanned_groups)
    for kind in kinds:
        if kind != "attn_mlp":
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (dense attn_mlp "
                "only; MoE, MLA and SSM blocks are queued in ROADMAP.md)")
    return kinds


def init_model(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters from ``generator``, on the generator's device."""
    cfg.validate()
    device = generator.device
    dtype = canonical_dtype(cfg.param_dtype)
    params: Params = {"embed": init_embedding(cfg, generator, dtype)}
    params["layers"] = [
        {
            "norm1": init_norm(cfg, cfg.d_model, dtype, device),
            "attn": attn_mod.init_attention(cfg, generator, dtype, device),
            "norm2": init_norm(cfg, cfg.d_model, dtype, device),
            "mlp": init_mlp(cfg, generator, cfg.d_ff, dtype),
        }
        for _ in layer_kinds(cfg)
    ]
    params["final_norm"] = init_norm(cfg, cfg.d_model, dtype, device)
    return params


def cast_params_to_compute(params: Params, cfg: ModelConfig) -> Params:
    """Mixed precision: every fp32 leaf gets a compute-dtype copy (modules
    re-upcast where fp32 matters: norms, RM feature products), and each
    layer's attention gets its estimator's packed weights ``rm_w`` in the
    RM precision policy's dtype (``attention.rm_packed_weights``). ``rm_w``
    is never cast to the compute dtype: the packed sketch tensors are cos
    and sin values that bf16 would round while ``rm.precision`` is fp32.
    On params this has already returned it copies no tensor."""
    cdtype = canonical_dtype(cfg.compute_dtype)

    def _cast(p):
        if isinstance(p, dict):
            # rm_w (a tensor or a list of them) and rm_slab are already in
            # the dtype their kernels take
            return {k: v if k in ("rm_w", "rm_slab") else _cast(v)
                    for k, v in p.items()}
        if isinstance(p, list):
            return [_cast(v) for v in p]
        return p.to(cdtype) if p.dtype == torch.float32 else p

    out = _cast(params)
    out["layers"] = [{**layer, "attn": attn_mod.rm_packed_weights(
        layer["attn"], cfg)} for layer in out["layers"]]
    return out


def _prepare_inputs(params: Params, cfg: ModelConfig,
                    batch: Dict[str, Any]):
    """tokens and/or precomputed embeds -> x [B, T, d] in the compute
    dtype, positions [B, T].

    ``batch["embeds"] [B, Te, d]`` (the modality frontend stub's frame
    embeddings) is cast to the compute dtype and put before the embedded
    ``batch["tokens"] [B, Tt]`` where both are given; a sinusoidal config
    adds its position table in x's dtype.

    Raises:
        ValueError: the batch holds neither; the message names the input
            ``cfg.frontend`` expects.
    """
    cdtype = canonical_dtype(cfg.compute_dtype)
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(cdtype))
    if batch.get("tokens") is not None:
        parts.append(embed_tokens(params["embed"], cfg, batch["tokens"],
                                  cdtype))
    if not parts:
        want = "embeds" if cfg.frontend == "audio_stub" else "tokens"
        raise ValueError(f"{cfg.name} (frontend {cfg.frontend!r}) takes "
                         f"batch[{want!r}]; the batch holds neither embeds "
                         "nor tokens")
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b, t = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x, positions


def _mlp_residual(layer: Params, cfg: ModelConfig, x: torch.Tensor):
    return x + apply_mlp(layer["mlp"], cfg, apply_norm(layer["norm2"], cfg,
                                                       x))


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits [B, T, V] fp32, aux losses {})."""
    params = cast_params_to_compute(params, cfg)
    x, positions = _prepare_inputs(params, cfg, batch)
    for layer in params["layers"]:
        h = apply_norm(layer["norm1"], cfg, x)
        x = x + attn_mod.attention_forward(layer["attn"], cfg, h, positions)
        x = _mlp_residual(layer, cfg, x)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params["embed"], cfg, x), {}


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            z_loss_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """Causal-LM (or framewise, for encoders) cross entropy plus z-loss ->
    (loss, metrics ``ce``, ``z_loss``, ``tokens``, ``loss``), all fp32.

    ``batch["targets"] [B, Tt]`` aligns with the LAST Tt positions of the
    model input; targets < 0 are ignored. Differentiable on the fused rm
    path: the loss reaches every master leaf but the frozen ``rm_est``
    (whose packed ``rm_w`` feeds the kernels as a constant) and reaches
    ``rm_scale`` through its softplus. The two-launch path raises under
    autograd at its featurize kernel (no VJP in the reference either).
    """
    logits, _ = forward(params, cfg, batch)
    targets = batch["targets"]
    logits = logits[:, -targets.shape[1]:, :].float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          targets.clamp_min(0).long()[..., None])[..., 0]
    mask = (targets >= 0).float()
    denom = mask.sum().clamp_min(1.0)
    ce = ((lse - picked) * mask).sum() / denom
    z_loss = (lse ** 2 * mask).sum() / denom * z_loss_weight
    total = ce + z_loss
    return total, {"ce": ce, "z_loss": z_loss, "tokens": mask.sum(),
                   "loss": total}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """Consume a prompt; return (logits [B, T, V], decode cache).

    ``max_len`` sizes exact attention's ring-buffer KV cache; the rm decode
    state does not grow with the sequence.
    """
    params = cast_params_to_compute(params, cfg)
    x, positions = _prepare_inputs(params, cfg, batch)
    caches = []
    for layer in params["layers"]:
        h = apply_norm(layer["norm1"], cfg, x)
        y, cache = attn_mod.attention_prefill_cache(layer["attn"], cfg, h,
                                                    positions, max_len)
        x = _mlp_residual(layer, cfg, x + y)
        caches.append(cache)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params["embed"], cfg, x), {"layers": caches}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Params:
    """Zero decode cache for ``batch`` lanes, one entry per layer: the rm
    state, or exact attention's KV ring buffer in the compute dtype."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    dtype = canonical_dtype(cfg.compute_dtype)
    return {"layers": [attn_mod.init_attention_cache(cfg, batch, device,
                                                     max_len, dtype)
                       for _ in layer_kinds(cfg)]}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor,      # [B, 1] int
                positions: torch.Tensor,   # [B] position of this token
                ) -> Tuple[torch.Tensor, Params]:
    """One autoregressive step -> (logits [B, 1, V] fp32, new cache).
    Exact attention writes the new keys and values into the cache's ring
    buffers in place."""
    params = cast_params_to_compute(params, cfg)
    cdtype = canonical_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], cfg, tokens, cdtype)
    new_caches = []
    for layer, layer_cache in zip(params["layers"], cache["layers"]):
        h = apply_norm(layer["norm1"], cfg, x)
        y, new_cache = attn_mod.attention_decode(layer["attn"], cfg, h,
                                                 layer_cache, positions)
        x = _mlp_residual(layer, cfg, x + y)
        new_caches.append(new_cache)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params["embed"], cfg, x), {"layers": new_caches}
