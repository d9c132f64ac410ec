"""Mixture-of-Experts FFN, single-device path (port of
``repro.models.moe``).

Tokens ``x [B, T, d]`` are flattened to ``[G, d]`` and routed by an fp32
router (softmax, top-k, the k weights renormalized to sum to 1). Two
dispatches, as in the reference:

* ``dispatch="local"`` (default): sorted-rank dispatch. Each (token,
  choice) pair gets its rank among the pairs sent to its expert; pairs of
  rank below the capacity ``C`` fill slot ``expert * C + rank`` of one
  flat buffer (an ``index_add_`` in fp32, one value a slot), the rest go
  to a dump row and are dropped. The experts run as batched products over
  ``[E, C, d]``; each pair picks its slot's output back, weighted, and a
  token sums its k picks (the reference's ``segment_sum``, in fp32);
* ``dispatch="einsum"``: the GShard one-hot dispatch and combine einsums
  (toy scale, ablation).

The capacity counts every routed token of the call, a prefill bucket's
padded positions included (the reference routes those too), so a
request's outputs depend on what it is batched with and on its padding;
``capacity_factor`` large enough that nothing drops removes that.

Shared experts (DeepSeek) add one dense SwiGLU over every token. The aux
losses are the load-balance term ``E * sum_e f_e p_e`` and the router
z-loss ``mean(logsumexp(logits)^2)``.

The reference has no Pallas kernel here: the expert products are plain
``torch.bmm`` / ``einsum``, as the reference computes them in XLA.

On a mesh (the reference's ``shard_map`` path, ``src/repro/models/
moe.py:160-224``): each data-parallel shard routes and dispatches its own
tokens, so the capacity is counted per shard, and every expert's ff dim
(and the shared experts') is split over ``"model"``; each model rank
computes its ff slice's part of every token's output and one all-reduce
over ``"model"`` completes the block, while ``lb_fe``, ``lb_pe`` and
``z_sq`` are averaged over the data axes. The expert stacks are stored by
ff slice, ``w_gate`` / ``w_up [E, d, ff / m]`` and ``w_down [E, ff / m,
d]``: that is the reference's compute layout (``P(None, None, ep)``),
where ``params_partition_specs`` would put the expert dim on ``"model"``
(a layout the reference gathers before it computes). Inside a
``distributed.tensor_parallel.local_view`` (the Trainer, the serving
executor) ``apply_moe`` takes this rank's tokens; ``apply_moe(mesh=)``
takes the whole batch on every rank, splits it over the batch axes where
they divide it (else every shard routes every token, as the reference
does for a batch of 1) and gathers the result back.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import normal_init

Params = Dict[str, torch.Tensor]

__all__ = ["init_moe", "apply_moe"]


def init_moe(cfg: ModelConfig, generator: torch.Generator, dtype) -> Params:
    """Router (fp32), stacked expert weights ``[E, d, ff]`` / ``[E, ff,
    d]`` and the shared experts' ``[d, S * ff]`` / ``[S * ff, d]``, on the
    generator's device."""
    moe = cfg.moe
    d, e, ff = cfg.d_model, moe.num_experts, moe.d_ff_expert
    std = cfg.init_std
    params: Params = {
        "router": normal_init(generator, (d, e), std, torch.float32),
        "w_gate": normal_init(generator, (e, d, ff), std, dtype),
        "w_up": normal_init(generator, (e, d, ff), std, dtype),
        "w_down": normal_init(generator, (e, ff, d), std, dtype),
    }
    if moe.num_shared_experts > 0:
        sff = moe.num_shared_experts * ff
        params["shared_gate"] = normal_init(generator, (d, sff), std, dtype)
        params["shared_up"] = normal_init(generator, (d, sff), std, dtype)
        params["shared_down"] = normal_init(generator, (sff, d), std, dtype)
    return params


def _capacity(moe: MoEConfig, num_tokens: int) -> int:
    cap = int(num_tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(cap, moe.top_k)


def _route(params: Params, moe: MoEConfig, xf: torch.Tensor):
    """Router logits, probs and the renormalized top-k. xf: [G, d].
    ``torch.topk`` orders ties as it likes, ``jax.lax.top_k`` by index:
    on inputs with tied probabilities the two may route differently."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, moe.top_k, dim=-1)
    top_vals = top_vals / torch.clamp_min(
        top_vals.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, top_vals, top_idx


def _experts(params: Params, xin: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: ``[E, C, d] -> [E, C, d]``."""
    gate = torch.bmm(xin, params["w_gate"])
    up = torch.bmm(xin, params["w_up"])
    return torch.bmm(F.silu(gate) * up, params["w_down"])


def _aux(logits, probs, top_idx, e: int, k: int) -> Dict[str, torch.Tensor]:
    mask_ge = F.one_hot(top_idx, e).float().sum(dim=1)       # [G, E]
    return {
        "lb_fe": mask_ge.mean(dim=0) / k,
        "lb_pe": probs.mean(dim=0),
        "z_sq": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
    }


def _moe_core_local(params: Params, cfg: ModelConfig, xf: torch.Tensor,
                    routed):
    """Sorted-rank dispatch -> expert FFN -> combine. xf: [G, d], routed:
    :func:`_route`'s -> (y [G, d] fp32, aux)."""
    moe = cfg.moe
    g, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    logits, probs, top_vals, top_idx = routed
    cap = _capacity(moe, g)

    e_flat = top_idx.reshape(-1)                              # [G*K]
    w_flat = top_vals.reshape(-1)
    # token-major pairs, k to a token (an expand: repeat_interleave would
    # read its output size back from the device)
    tok_flat = torch.arange(g, device=xf.device)[:, None].expand(g, k) \
        .reshape(-1)
    onehot = F.one_hot(e_flat, e)
    rank = torch.cumsum(onehot, dim=0) - onehot
    my_rank = torch.gather(rank, 1, e_flat[:, None])[:, 0]
    valid = my_rank < cap
    slot = torch.where(valid, e_flat * cap + my_rank,
                       torch.full_like(e_flat, e * cap))
    # one value a kept slot (exact in any order); the dropped pairs land,
    # zeroed, on the dump row e * cap
    buf = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                      device=xf.device)
    buf.index_add_(0, slot, xf[tok_flat].float() * valid[:, None])
    xin = buf[:-1].reshape(e, cap, d).to(xf.dtype)

    y_flat = _experts(params, xin).reshape(e * cap, d)
    picked = torch.where(valid[:, None],
                         y_flat[torch.clamp_max(slot, e * cap - 1)].float(),
                         0.0)
    # the pairs are token-major, k to a token: segment_sum is a sum over k
    y = (picked * w_flat[:, None]).reshape(g, k, d).sum(dim=1)
    return y, _aux(logits, probs, top_idx, e, k)


def _moe_core_einsum(params: Params, cfg: ModelConfig, xf: torch.Tensor,
                     routed):
    """GShard one-hot dispatch (toy scale / ablation)."""
    moe = cfg.moe
    g, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    logits, probs, top_vals, top_idx = routed
    cap = _capacity(moe, g)

    onehot = F.one_hot(top_idx, e).float()                    # [G, K, E]
    mask_ge = onehot.sum(dim=1)
    gates_ge = torch.einsum("gk,gke->ge", top_vals, onehot)
    rank = torch.cumsum(mask_ge, dim=0) - mask_ge
    keep = (rank < cap).float() * mask_ge
    # ranks >= cap are dropped by ``keep``; the clamp only keeps one_hot
    # in range (jax's one_hot gives zeros there)
    dispatch = F.one_hot(torch.clamp_max(rank.long(), cap - 1),
                         cap).float() * keep[..., None]       # [G, E, C]
    xin = torch.einsum("gec,gd->ecd", dispatch, xf.float()).to(xf.dtype)
    yexp = _experts(params, xin)
    combine = dispatch * gates_ge[..., None]
    y = torch.einsum("gec,ecd->gd", combine, yexp.float())
    return y, _aux(logits, probs, top_idx, e, k)


def _shared_expert_out(params: Params, xf: torch.Tensor) -> torch.Tensor:
    gate = xf @ params["shared_gate"]
    up = xf @ params["shared_up"]
    return (F.silu(gate) * up) @ params["shared_down"]


def _finalize_aux(moe: MoEConfig, aux) -> Dict[str, torch.Tensor]:
    return {
        "moe_load_balance": moe.num_experts * (aux["lb_fe"]
                                               * aux["lb_pe"]).sum(),
        "moe_router_z": aux["z_sq"],
    }


def _moe_tokens(params: Params, cfg: ModelConfig,
                xf: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """This rank's tokens ``[G, d]`` -> (y [G, d] fp32, aux). The router
    runs on the whole token (replicated over ``"model"``); the tokens and
    the combine weights enter the experts' ff slices through
    ``tensor_parallel.copy_to_model``, and one all-reduce sums the slices'
    parts. Outside a model-parallel view both are the identity.
    Where the view's ``gather_batch`` is set (the serving executor's decode
    step on a data axis) the tokens of every batch rank are all-gathered
    first and routed together, so the capacity counts the whole decode
    batch, as the reference's single-controller step does; the aux losses
    are then the whole batch's and this rank's rows are returned."""
    moe = cfg.moe
    core = _moe_core_einsum if moe.dispatch == "einsum" else _moe_core_local
    view = tp.active()
    gather = view is not None and view.gather_batch and view.batch_groups
    if gather:
        # route the whole batch: every rank's tokens, pod-major as the
        # batch is split (tensor_parallel.batch_index)
        rows, index = xf.shape[0], 0
        for group in view.batch_groups:
            index = index * group.size() + group.rank()
        for group in reversed(view.batch_groups):   # data, then pod
            xf = torch.cat(all_gather(xf, group), dim=0)
    logits, probs, top_vals, top_idx = _route(params, moe, xf)
    xin = tp.copy_to_model(xf)
    y, aux = core(params, cfg, xin,
                  (logits, probs, tp.copy_to_model(top_vals), top_idx))
    if moe.num_shared_experts > 0:
        y = y + _shared_expert_out(params, xin).float()
    y = tp.reduce_from_model(y)
    if gather:
        return y[index * rows:(index + 1) * rows], aux
    if view is not None and view.batch_groups:
        # the reference's pmean over the data axes, in one all-reduce
        e = moe.num_experts
        vec = tp.mean_over_batch(torch.cat([aux["lb_fe"], aux["lb_pe"],
                                            aux["z_sq"].reshape(1)]))
        aux = {"lb_fe": vec[:e], "lb_pe": vec[e:2 * e], "z_sq": vec[2 * e]}
    return y, aux


def apply_moe(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, d] -> (y [B, T, d] in x's dtype, aux losses).

    ``mesh`` (a ``DeviceMesh``): ``x`` is the whole batch, the same on
    every rank, and ``params`` this rank's ff slices
    (``distributed.tensor_parallel.shard_params``); the rows are split
    over the mesh's batch axes where they divide ``B`` (else replicated),
    routed per shard, and gathered back, so every rank returns the whole
    ``y``. Without it, inside a ``tensor_parallel.local_view``, ``x`` is
    this rank's rows.

    Raises:
        RuntimeError: ``mesh`` has no process group behind it.
    """
    moe = cfg.moe
    b, t, d = x.shape
    if mesh is None:
        y, aux = _moe_tokens(params, cfg, x.reshape(-1, d))
        return y.reshape(b, t, d).to(x.dtype), _finalize_aux(moe, aux)
    tp.local_view_of(mesh)               # raises without a process group
    index, parts = tp.batch_index(mesh)
    split = b % parts == 0
    rows = x[index * (b // parts):(index + 1) * (b // parts)] if split \
        else x
    with tp.local_view(mesh, batch_sharded=split) as view:
        y, aux = _moe_tokens(params, cfg, rows.reshape(-1, d))
        y = y.reshape(rows.shape).to(x.dtype)
        if split:
            for group in reversed(view.batch_groups):   # data, then pod
                y = torch.cat(all_gather(y, group), dim=0)
    return y, _finalize_aux(moe, aux)
