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

On a mesh every function here runs on the local view
(``distributed.tensor_parallel``): params cut by ``shard_params``, the
config of ``local_config`` (a rank's heads, ff, vocabulary and SSM
channels), called inside ``tensor_parallel.local_view(mesh)``. The blocks
all-reduce their outputs over ``"model"``, the logits are this rank's
vocab columns (``tensor_parallel.gather_vocab`` joins them) and
``loss_fn`` reduces its ``logsumexp`` and target logits over the columns;
a part the local config keeps whole (``LocalConfig.whole``: its widths
the model axis does not divide) runs whole on every rank inside
``tensor_parallel.whole_part``, with no reduction.
``forward`` and ``prefill`` run inside ``tensor_parallel.
sequence_sharding``: where the model axis divides T the residual stream
between blocks is this rank's slice of the sequence (``"act_seq"``), the
blocks gather it on entry and reduce-scatter their outputs, and MLA and
the MoE, whose input also feeds replicated products, take the whole
sequence from the block. Inside a Trainer step with FSDP
(``distributed.fsdp.training``) ``forward`` gathers each block's weights
over ``"data"`` just before the block (``distributed.fsdp.block``) and
casts them there, in place of ``cast_params_to_compute``'s one cast of
the whole tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

import contextlib

from repro_torch.common.dtypes import canonical_dtype
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
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
    "meta_params",
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
# the kinds whose input also feeds a replicated product (MLA's latent, the
# MoE's router): under "act_seq" they take the whole sequence
_WHOLE_SEQUENCE = ("mla", "moe")


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


def init_model(cfg: ModelConfig, generator: torch.Generator, *,
               cut=None) -> Params:
    """Random parameters from ``generator``, on the generator's device.
    ``cut(key, draw)``, where given, draws each top-level part (``"embed"``,
    then ``"layers"`` one block at a time as ``[block]``, then
    ``"final_norm"``) by calling ``draw(generator)`` and returns what to
    keep (``distributed.tensor_parallel.init_local_params`` keeps one
    rank's shards, each weight cut as it is drawn, so the full weights
    never stand at once); the draws are the same."""
    cfg.validate()
    device = generator.device
    dtype = canonical_dtype(cfg.param_dtype)
    keep = cut or (lambda _, draw: draw(generator))
    params: Params = {"embed": keep("embed", lambda g: init_embedding(
        cfg, g, dtype))}
    params["layers"] = [
        keep("layers", lambda g, kind=kind: [_init_block(cfg, kind, g,
                                                         dtype)])[0]
        for kind in layer_kinds(cfg)]
    params["final_norm"] = keep("final_norm", lambda g: init_norm(
        cfg, cfg.d_model, dtype, device))
    return params


def meta_params(cfg: ModelConfig) -> Params:
    """``init_model(cfg)``'s tree as ``meta`` tensors: every weight a
    stand-in (``layers.drawing``), nothing allocated but the small leaves
    drawn on the CPU on the way (norm scales, the estimator draws), which
    become ``meta`` too. A dry run's params and a template's shapes."""
    from repro_torch.distributed.tensor_parallel import meta_template
    from repro_torch.models.layers import drawing

    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    with drawing(lambda g, shape, std, dtype: torch.empty(
            shape, dtype=dtype, device="meta")):
        return meta_template(init_model(cfg, gen))


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
    out = _cast_tree(params, canonical_dtype(cfg.compute_dtype))
    out["layers"] = [_pack_layer(layer, cfg) for layer in out["layers"]]
    return out


def _cast_tree(p, cdtype):
    """Every fp32 leaf of ``p`` in ``cdtype`` (the packed ``rm_w``, a
    tensor or a list of them, and ``rm_slab`` are already in the dtype
    their kernels take)."""
    if isinstance(p, dict):
        return {k: v if k in ("rm_w", "rm_slab") else _cast_tree(v, cdtype)
                for k, v in p.items()}
    if isinstance(p, list):
        return [_cast_tree(v, cdtype) for v in p]
    return p.to(cdtype) if p.dtype == torch.float32 else p


def _pack_layer(layer: Params, cfg: ModelConfig) -> Params:
    """An attention or MLA layer with its estimator's packed ``rm_w``."""
    kind, mp = _mixer(layer)
    if kind not in _ATTENTION_MIXERS:
        return layer
    width = mla_mod.mla_qk_dim(cfg) if kind == "mla" else None
    return {**layer, kind: attn_mod.rm_packed_weights(mp, cfg, width)}


@contextlib.contextmanager
def _compute_part(plan, cfg: ModelConfig, path, part, *,
                  regather: bool = True):
    """The compute copy of the params at ``path``: ``part`` itself (the
    caller cast the whole tree) without an FSDP ``plan``; with one, its
    leaves gathered over ``"data"`` for the part's forward inside the
    context (``distributed.fsdp.block``; ``regather``: whether backward
    gathers them again through saved-tensor hooks, off inside a
    checkpointed group, whose recompute gathers anew). A training plan's
    part is the fp32 masters, cast here; a serving plan's
    (``Plan.serving``) is the compute copy's shards, already cast and
    packed."""
    if plan is None:
        yield part
        return
    cdtype = canonical_dtype(cfg.compute_dtype)
    with fsdp.block(plan, path, part, cdtype, regather=regather) as full:
        if plan.serving:
            yield full
            return
        out = _cast_tree(full, cdtype)
        yield _pack_layer(out, cfg) if path[0] == "layers" else out


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


def _mixer_call(fn, kind: str, *args):
    """``fn(*args)`` (args: params, cfg, the normed x, then the rest),
    inside ``tensor_parallel.whole_part`` for a kind the local config
    keeps whole; a :data:`_WHOLE_SEQUENCE` kind takes x's whole sequence
    and returns its output's slice (``tensor_parallel.gather_sequence`` /
    ``scatter_sequence``: the identity outside ``"act_seq"``)."""
    params, cfg, h, *rest = args
    with tp.whole_part(cfg, kind):
        if kind not in _WHOLE_SEQUENCE:
            return fn(*args)
        out = fn(params, cfg, tp.gather_sequence(h), *rest)
    if isinstance(out, tuple):
        return (tp.scatter_sequence(out[0]), *out[1:])
    return tp.scatter_sequence(out)


def _ffn_residual(layer: Params, cfg: ModelConfig, x: torch.Tensor):
    """x plus the layer's FFN (dense MLP or MoE) of its second norm ->
    (x, the MoE's aux losses or {}); a kind without an FFN returns x."""
    if "norm2" not in layer:
        return x, {}
    h = apply_norm(tp.sequence_params(layer["norm2"]), cfg, x)
    if "moe" in layer:
        y, aux = _mixer_call(moe_mod.apply_moe, "moe", layer["moe"], cfg, h)
        return x + y, aux
    return x + apply_mlp(layer["mlp"], cfg, h), {}


def _block_forward(layer: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, aux_total: Dict):
    """One block's pre-norm mixer and FFN residuals -> (x, the running
    MoE aux sums with this block's added)."""
    kind, mp = _mixer(layer)
    h = apply_norm(tp.sequence_params(layer["norm1"]), cfg, x)
    x = x + _mixer_call(_MIXER_FWD[kind], kind, mp, cfg, h, positions)
    x, aux = _ffn_residual(layer, cfg, x)
    aux_total = dict(aux_total)
    for k, v in aux.items():
        aux_total[k] = aux_total[k] + v if k in aux_total else v
    return x, aux_total


def _run_group(plan, cfg: ModelConfig, layers, start: int, x, positions,
               aux_total, *, regather: bool = True):
    """The blocks ``layers`` (layer ``start`` on) in order, each gathered
    over ``"data"`` just before it under an FSDP ``plan``."""
    for j, layer in enumerate(layers):
        with _compute_part(plan, cfg, ("layers", start + j), layer,
                           regather=regather) as layer:
            x, aux_total = _block_forward(layer, cfg, x, positions,
                                          aux_total)
    return x, aux_total


def _checkpointed_group(plan, cfg: ModelConfig, layers, start: int, x,
                        positions, aux_total):
    """:func:`_run_group` under ``torch.utils.checkpoint`` (non-reentrant):
    nothing inside is saved for backward but the group's inputs, and the
    backward runs the group again. The thread-local views the blocks read
    (the tensor-parallel view with its ``"act_seq"`` flag, the FSDP plan)
    are taken here and entered again in the recompute, which runs after
    ``forward`` has left them; the FSDP gather runs inside, so the
    recompute gathers each block again and no gathered weight outlives
    the forward (no saved-tensor hook of ``distributed.fsdp`` is
    installed)."""
    from torch.utils.checkpoint import checkpoint

    view = tp.active()

    def group(x, aux_total):
        with tp.restore_view(view), fsdp.training(plan):
            return _run_group(plan, cfg, layers, start, x, positions,
                              aux_total, regather=False)

    return checkpoint(group, x, aux_total, use_reentrant=False,
                      preserve_rng_state=False)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits [B, T, V] fp32, aux losses: the
    MoE layers' ``moe_load_balance`` and ``moe_router_z`` summed, or {}
    for a config without MoE).

    With ``cfg.remat`` and a gradient being taken, each group of
    ``len(cfg.block_pattern)`` layers after the ``first_k_dense`` ones runs
    under activation checkpointing (:func:`_checkpointed_group`), the
    reference's ``jax.checkpoint`` of its scanned group: the dense layers,
    the final norm and the unembedding are not wrapped. The aux sums run
    through the groups in the same order either way, so the numbers do
    not depend on ``remat``."""
    plan = fsdp.active()
    if plan is None:
        params = cast_params_to_compute(params, cfg)
    x, positions = _prepare_inputs(params, cfg, batch)
    aux_total: Dict[str, torch.Tensor] = {}
    layers = params["layers"]
    dense, period = cfg.first_k_dense, len(cfg.block_pattern)
    remat = cfg.remat and torch.is_grad_enabled()
    with tp.sequence_sharding(x.shape[1]):
        x = tp.scatter_sequence(x)
        x, aux_total = _run_group(plan, cfg, layers[:dense], 0, x,
                                  positions, aux_total)
        for start in range(dense, len(layers), period):
            run = _checkpointed_group if remat else _run_group
            x, aux_total = run(plan, cfg, layers[start:start + period],
                               start, x, positions, aux_total)
        with _compute_part(plan, cfg, ("final_norm",),
                           params["final_norm"]) as final_norm:
            x = apply_norm(tp.sequence_params(final_norm), cfg, x)
        if cfg.moe is not None:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            aux_total = {k: aux_total.get(k, zero)
                         for k in ("moe_load_balance", "moe_router_z")}
        with _compute_part(plan, cfg, ("embed",), params["embed"]) as embed:
            return unembed(embed, cfg, x), aux_total


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
    if tp.model_view() is not None and not tp.is_whole(cfg, "vocab"):
        # this rank's vocab columns: the lse and the target logit reduce
        # over "model"
        lse, picked = tp.vocab_parallel_ce(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, targets.clamp_min(0).long()[
            ..., None])[..., 0]
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
    state does not grow with the sequence. Under a serving plan
    (``distributed.fsdp.training``) the params are the compute copy of a
    rank's slices over ``"data"``, each block gathered just before it
    runs.
    """
    plan = fsdp.active()
    if plan is None:
        params = cast_params_to_compute(params, cfg)
    x, positions = _prepare_inputs(params, cfg, batch)
    caches = []
    *blocks, final_norm, embed = serving_parts(params)
    with tp.sequence_sharding(x.shape[1]):
        x = tp.scatter_sequence(x)
        for path, layer in blocks:
            with _compute_part(plan, cfg, path, layer) as layer:
                kind, mp = _mixer(layer)
                h = apply_norm(tp.sequence_params(layer["norm1"]), cfg, x)
                y, cache = _mixer_call(_MIXER_PREFILL[kind], kind, mp, cfg,
                                       h, positions, max_len)
                x, _ = _ffn_residual(layer, cfg, x + y)
            caches.append(cache)
        with _compute_part(plan, cfg, *final_norm) as final_norm:
            x = apply_norm(tp.sequence_params(final_norm), cfg, x)
        with _compute_part(plan, cfg, *embed) as embed:
            return unembed(embed, cfg, x), {"layers": caches}


def serving_parts(params: Params):
    """``[(path, part)]`` in the order :func:`prefill` and
    :func:`decode_step` run them: each block, the final norm, the
    unembedding. Under a serving plan each part is gathered over
    ``"data"`` just before it runs, so this is also the order every data
    rank issues those gathers in (:func:`join_serving_gathers`)."""
    return ([(("layers", i), layer)
             for i, layer in enumerate(params["layers"])]
            + [(("final_norm",), params["final_norm"]),
               (("embed",), params["embed"])])


def join_serving_gathers(params: Params, cfg: ModelConfig) -> None:
    """A prefill's gathers over ``"data"`` under the active serving plan,
    in :func:`serving_parts`' order, computing nothing: a data rank that
    does not own an admission's slot joins the owner's prefill with it
    (``serve.executor``). A no-op without a plan."""
    plan = fsdp.active()
    if plan is None:
        return
    for path, part in serving_parts(params):
        with _compute_part(plan, cfg, path, part):
            pass


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
    buffers in place. Under a serving plan (``distributed.fsdp``) each block's
    slices are gathered over ``"data"`` just before it, as in
    :func:`prefill`."""
    plan = fsdp.active()
    if plan is None:
        params = cast_params_to_compute(params, cfg)
    cdtype = canonical_dtype(cfg.compute_dtype)
    x = embed_tokens(params["embed"], cfg, tokens, cdtype)
    new_caches = []
    *blocks, final_norm, embed = serving_parts(params)
    for (path, layer), layer_cache in zip(blocks, cache["layers"]):
        with _compute_part(plan, cfg, path, layer) as layer:
            kind, mp = _mixer(layer)
            h = apply_norm(layer["norm1"], cfg, x)
            with tp.whole_part(cfg, kind):
                y, new_cache = _MIXER_DECODE[kind](mp, cfg, h, layer_cache,
                                                   positions)
            x, _ = _ffn_residual(layer, cfg, x + y)
        new_caches.append(new_cache)
    with _compute_part(plan, cfg, *final_norm) as final_norm:
        x = apply_norm(final_norm, cfg, x)
    with _compute_part(plan, cfg, *embed) as embed:
        return unembed(embed, cfg, x), {"layers": new_caches}
