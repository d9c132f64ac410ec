"""Model assembly (port of ``repro.models.transformer``).

The reference scans a stacked ``params["groups"]`` over layers; the port
keeps one parameter dict per layer in ``params["layers"]`` and loops over
them (PyTorch runs eagerly, there is no compile to keep small). The layer
stack is ``first_k_dense`` leading dense blocks (DeepSeek style, kind
``_dense_kind_for(cfg)``) then ``block_pattern`` repeated. A block kind is
a mixer, optionally ``_`` an FFN: the mixers are GQA attention
(``"attn"``, ``models.attention``), MLA (``"mla"``, ``models.mla``), the
Mamba SSM (``"mamba"``, ``models.mamba``) and the xLSTM cells (``"mlstm"``,
``"slstm"``, ``models.xlstm``), each under its own key behind the pre-norm
``norm1``; the FFN is a dense MLP (``"mlp"``) or the MoE of
``models.moe`` (``"moe"``) behind ``norm2``. The kinds without an FFN
(``"mamba"``, ``"mlstm"``, ``"slstm"``) have no ``norm2`` and no FFN
residual, as in the reference.
``forward`` returns the MoE aux losses summed over the MoE layers
(``moe_load_balance``, ``moe_router_z``; ``{}`` for a config without MoE)
and ``loss_fn`` adds them at the config's weights. Inputs
are tokens, precomputed embeddings (``frontend="audio_stub"``, the
HuBERT encoder's frames; ``"vision_stub"``, InternVL2's patches put before
the tokens), or both; an encoder (``causal=False``) has ``forward`` and
``loss_fn`` but no prefill cache or decode step. ``loss_fn`` is
differentiable end to end on the fused rm path (the attention ops are
``torch.autograd.Function``s), on the exact path and through the SSM
mixers (plain PyTorch, through autograd); the two-launch path's featurize
kernels have no backward (ROADMAP.md queue C).

Parameters are plain nested dicts of tensors with the reference's leaf
names; the fp32 master weights get a compute-dtype copy, with each
attention or MLA layer's estimator weights packed for the kernels, through
``cast_params_to_compute`` (a no-op on params it has already returned, so
a caller that casts once — the serving executor — pays nothing per step).
The copies are differentiable casts: gradients reach the fp32 masters. The
packed ``rm_w`` / ``rm_slab`` live only in the compute copy, never in the
masters a train state holds.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.dtypes import canonical_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
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


_MIXER_INIT = {
    "attn": lambda cfg, gen, dtype: attn_mod.init_attention(
        cfg, gen, dtype, gen.device),
    "mla": lambda cfg, gen, dtype: mla_mod.init_mla(cfg, gen, dtype,
                                                    gen.device),
    "mamba": mamba_mod.init_mamba,
    "mlstm": xlstm_mod.init_mlstm,
    "slstm": xlstm_mod.init_slstm,
}
_MIXER_FWD = {
    "attn": attn_mod.attention_forward,
    "mla": mla_mod.mla_forward,
    "mamba": mamba_mod.mamba_forward,
    "mlstm": xlstm_mod.mlstm_forward,
    "slstm": xlstm_mod.slstm_forward,
}
_MIXER_PREFILL = {
    "attn": attn_mod.attention_prefill_cache,
    "mla": mla_mod.mla_prefill_cache,
    "mamba": mamba_mod.mamba_prefill_cache,
    "mlstm": xlstm_mod.mlstm_prefill_cache,
    "slstm": xlstm_mod.slstm_prefill_cache,
}
_MIXER_DECODE = {
    "attn": attn_mod.attention_decode,
    "mla": mla_mod.mla_decode,
    "mamba": mamba_mod.mamba_decode,
    "mlstm": xlstm_mod.mlstm_decode,
    "slstm": xlstm_mod.slstm_decode,
}
_MIXERS = tuple(_MIXER_FWD)
# the mixers that attend: the ones rm mode featurizes
_ATTENTION_MIXERS = ("attn", "mla")


def _split_kind(kind: str) -> Tuple[str, Optional[str]]:
    if "_" in kind:
        mixer, ffn = kind.split("_", 1)
        return mixer, ffn
    return kind, None


def _dense_kind_for(cfg: ModelConfig) -> str:
    """The block kind of the ``first_k_dense`` leading layers."""
    mixer, _ = _split_kind(cfg.block_pattern[0])
    return f"{mixer}_mlp" if mixer in _ATTENTION_MIXERS else "attn_mlp"


def layer_kinds(cfg: ModelConfig):
    """Block kind of every layer, in order (``first_k_dense`` leading
    blocks, then the pattern repeated).

    Raises:
        ValueError: a kind whose mixer is none of attn, mla, mamba, mlstm
            and slstm, or whose FFN is neither mlp nor moe.
    """
    kinds = [_dense_kind_for(cfg)] * cfg.first_k_dense
    kinds.extend(list(cfg.block_pattern) * cfg.num_scanned_groups)
    for kind in kinds:
        mixer, ffn = _split_kind(kind)
        if mixer not in _MIXERS or ffn not in (None, "mlp", "moe"):
            raise ValueError(
                f"unknown block kind {kind!r}: a mixer of {_MIXERS}, "
                "optionally followed by _mlp or _moe")
    return kinds


def _init_block(cfg: ModelConfig, kind: str, generator: torch.Generator,
                dtype) -> Params:
    mixer, ffn = _split_kind(kind)
    device = generator.device
    params: Params = {
        "norm1": init_norm(cfg, cfg.d_model, dtype, device),
        mixer: _MIXER_INIT[mixer](cfg, generator, dtype),
    }
    if ffn is not None:
        params["norm2"] = init_norm(cfg, cfg.d_model, dtype, device)
        if ffn == "moe":
            params["moe"] = moe_mod.init_moe(cfg, generator, dtype)
        else:
            params["mlp"] = init_mlp(cfg, generator, cfg.d_ff, dtype)
    return params


def init_model(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters from ``generator``, on the generator's device."""
    cfg.validate()
    device = generator.device
    dtype = canonical_dtype(cfg.param_dtype)
    params: Params = {"embed": init_embedding(cfg, generator, dtype)}
    params["layers"] = [_init_block(cfg, kind, generator, dtype)
                        for kind in layer_kinds(cfg)]
    params["final_norm"] = init_norm(cfg, cfg.d_model, dtype, device)
    return params


def cast_params_to_compute(params: Params, cfg: ModelConfig) -> Params:
    """Mixed precision: every fp32 leaf gets a compute-dtype copy (modules
    re-upcast where fp32 matters: norms, RM feature products, the SSM
    dynamics; the SSM's fp32 leaves ``a_log``, ``d_skip`` and ``r_rec`` are
    cast too, as in the reference), and each attention or MLA layer gets
    its estimator's packed weights ``rm_w`` in the
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
    layers = []
    for layer in out["layers"]:
        kind, mp = _mixer(layer)
        if kind not in _ATTENTION_MIXERS:
            layers.append(layer)
            continue
        width = mla_mod.mla_qk_dim(cfg) if kind == "mla" else None
        layers.append({**layer, kind: attn_mod.rm_packed_weights(
            mp, cfg, width)})
    out["layers"] = layers
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


def _mixer(layer: Params) -> Tuple[str, Params]:
    """The layer's mixer kind and params."""
    for kind in _MIXERS:
        if kind in layer:
            return kind, layer[kind]
    raise KeyError(f"a layer without a mixer: keys {sorted(layer)}")


def _ffn_residual(layer: Params, cfg: ModelConfig, x: torch.Tensor):
    """x plus the layer's FFN (dense MLP or MoE) of its second norm ->
    (x, the MoE's aux losses or {}); a kind without an FFN returns x."""
    if "norm2" not in layer:
        return x, {}
    h = apply_norm(layer["norm2"], cfg, x)
    if "moe" in layer:
        y, aux = moe_mod.apply_moe(layer["moe"], cfg, h)
        return x + y, aux
    return x + apply_mlp(layer["mlp"], cfg, h), {}


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits [B, T, V] fp32, aux losses: the
    MoE layers' ``moe_load_balance`` and ``moe_router_z`` summed, or {}
    for a config without MoE)."""
    params = cast_params_to_compute(params, cfg)
    x, positions = _prepare_inputs(params, cfg, batch)
    aux_total: Dict[str, torch.Tensor] = {}
    for layer in params["layers"]:
        kind, mp = _mixer(layer)
        h = apply_norm(layer["norm1"], cfg, x)
        x = x + _MIXER_FWD[kind](mp, cfg, h, positions)
        x, aux = _ffn_residual(layer, cfg, x)
        for k, v in aux.items():
            aux_total[k] = aux_total[k] + v if k in aux_total else v
    x = apply_norm(params["final_norm"], cfg, x)
    if cfg.moe is not None:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_total = {k: aux_total.get(k, zero)
                     for k in ("moe_load_balance", "moe_router_z")}
    return unembed(params["embed"], cfg, x), aux_total


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            z_loss_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """Causal-LM (or framewise, for encoders) cross entropy plus z-loss,
    plus for a MoE config the router's load-balance and z losses at
    ``router_aux_weight`` / ``router_z_weight`` -> (loss, metrics ``ce``,
    ``z_loss``, ``tokens``, ``loss``, and ``moe_load_balance`` /
    ``moe_router_z`` for a MoE config), all fp32.

    ``batch["targets"] [B, Tt]`` aligns with the LAST Tt positions of the
    model input; targets < 0 are ignored. Differentiable on the fused rm
    path: the loss reaches every master leaf but the frozen ``rm_est``
    (whose packed ``rm_w`` feeds the kernels as a constant) and reaches
    ``rm_scale`` through its softplus. The two-launch path raises under
    autograd at its featurize kernel (no VJP in the reference either).
    """
    logits, aux = forward(params, cfg, batch)
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
    metrics = {"ce": ce, "z_loss": z_loss, "tokens": mask.sum()}
    if cfg.moe is not None:
        lb, rz = aux["moe_load_balance"], aux["moe_router_z"]
        total = total + cfg.moe.router_aux_weight * lb
        total = total + cfg.moe.router_z_weight * rz
        metrics["moe_load_balance"] = lb
        metrics["moe_router_z"] = rz
    metrics["loss"] = total
    return total, metrics


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
        kind, mp = _mixer(layer)
        h = apply_norm(layer["norm1"], cfg, x)
        y, cache = _MIXER_PREFILL[kind](mp, cfg, h, positions, max_len)
        x, _ = _ffn_residual(layer, cfg, x + y)
        caches.append(cache)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params["embed"], cfg, x), {"layers": caches}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Params:
    """Zero decode cache for ``batch`` lanes, one entry per layer: the rm
    state, or exact attention's KV ring buffer (MLA: its latent cache) in
    the compute dtype; a Mamba layer's (conv window, ssm state), an mLSTM
    layer's (conv window, C, n, m), an sLSTM layer's (h, c, n, m), their
    conv windows in the compute dtype and the rest fp32."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    dtype = canonical_dtype(cfg.compute_dtype)
    caches = []
    for kind in layer_kinds(cfg):
        mixer = _split_kind(kind)[0]
        if mixer == "attn":
            caches.append(attn_mod.init_attention_cache(cfg, batch, device,
                                                        max_len, dtype))
        elif mixer == "mla":
            caches.append(mla_mod.init_mla_cache(cfg, batch, max_len, dtype,
                                                 device))
        else:
            init = {"mamba": mamba_mod.init_mamba_cache,
                    "mlstm": xlstm_mod.init_mlstm_cache,
                    "slstm": xlstm_mod.init_slstm_cache}[mixer]
            caches.append(init(cfg, batch, dtype, device))
    return {"layers": caches}


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
        kind, mp = _mixer(layer)
        h = apply_norm(layer["norm1"], cfg, x)
        y, new_cache = _MIXER_DECODE[kind](mp, cfg, h, layer_cache,
                                           positions)
        x, _ = _ffn_residual(layer, cfg, x + y)
        new_caches.append(new_cache)
    x = apply_norm(params["final_norm"], cfg, x)
    return unembed(params["embed"], cfg, x), {"layers": new_caches}
