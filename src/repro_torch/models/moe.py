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
``torch.bmm`` / ``einsum``, as the reference computes them in XLA. Its
``shard_map`` path (tokens routed per data-parallel shard, experts split
over the tensor-parallel axis) waits for meshes (ROADMAP.md queue A item
7): ``mesh=`` raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def _moe_core_local(params: Params, cfg: ModelConfig, xf: torch.Tensor):
    """Sorted-rank dispatch -> expert FFN -> combine. xf: [G, d] ->
    (y [G, d] fp32, aux)."""
    moe = cfg.moe
    g, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    logits, probs, top_vals, top_idx = _route(params, moe, xf)
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


def _moe_core_einsum(params: Params, cfg: ModelConfig, xf: torch.Tensor):
    """GShard one-hot dispatch (toy scale / ablation)."""
    moe = cfg.moe
    g, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    logits, probs, top_vals, top_idx = _route(params, moe, xf)
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


def apply_moe(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, T, d] -> (y [B, T, d] in x's dtype, aux losses).

    Raises:
        NotImplementedError: ``mesh`` given (the sharded path is ROADMAP.md
            queue A item 7).
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded MoE path (shard_map over data-parallel shards, "
            "experts split over the tensor-parallel axis) waits for "
            "meshes (ROADMAP.md queue A item 7)")
    moe = cfg.moe
    b, t, d = x.shape
    core = _moe_core_einsum if moe.dispatch == "einsum" else _moe_core_local
    xf = x.reshape(-1, d)
    y, aux = core(params, cfg, xf)
    if moe.num_shared_experts > 0:
        y = y + _shared_expert_out(params, xf).float()
    return y.reshape(b, t, d).to(x.dtype), _finalize_aux(moe, aux)
