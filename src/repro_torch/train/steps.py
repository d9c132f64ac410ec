"""Step functions (port of ``repro.train.steps``): train (with gradient
accumulation), eval, prefill, decode.

``make_train_step(cfg, hyper)`` returns ``step(state, batch) -> (state,
metrics)`` over the state ``{"params", "opt", "step"}`` that
``init_train_state(cfg, seed, hyper, device)`` builds: fp32 master weights,
AdamW moments (``optim.adamw``) and the step as a 0-dim int32 tensor.
Gradients come from ``loss_fn`` through autograd; the fused rm attention
ops launch their kernels forward and differentiate the reference's XLA
formulation backward (``kernels.rm_attention.ops``). The frozen estimator
draws (``rm_est``) take no gradient. With ``grad_accum > 1`` the batch
splits into ``grad_accum`` microbatches along its first axis and their
gradients and metrics are averaged (the reference's ``lax.scan``, as a
loop). The update is in place (``optim.adamw``): a step consumes the
state it is given, as the reference's trainer donates it.

Data-parallel ranks (``train.trainer.Trainer(mesh=)``) pass their
process groups: ``data_group`` averages the gradients and metrics over
``"data"`` with ``all_reduce``; ``pod_group`` then averages over ``"pod"``,
int8-compressed with error feedback under ``grad_compression="int8_pod"``
(the state then carries fp32 ``residuals``, as the reference's; the step
runs ``optim.compression.compress_leaf`` a leaf and writes the reduced
gradient and the new residual over the old, so no second copy of either
tree is held). Each rank's gradients are weighted by
its share of the target tokens before the mean, so the result is the
global batch's mean whatever the ranks' masks; with equal token counts
the weight is exactly 1.

A tensor-parallel rank (``Trainer(mesh=)`` with a ``"model"`` axis above
1) runs the step inside ``distributed.tensor_parallel.local_view`` on its
local params and the local config, and passes ``cuts`` (the params'
``tensor_parallel.param_cuts``): the gradients of a kv head kept on
several ranks are summed over them, ``grad_norm`` is the full gradient's
(each rank's squared norms weighted so one all-reduce over ``"model"``
counts every leaf once), and the clip and AdamW act on the local shards.

With FSDP (``Trainer(mesh=)`` with ``"data"`` above 1; ``distributed.
fsdp``) the step also gets ``fsdp_dims``, the dim each leaf is cut along
over ``"data"``: it runs the forward and backward inside ``fsdp.
training``, so each block's weights are gathered before the block and
their gradients arrive already summed over ``"data"`` (each rank's share
weighted by its target tokens before the sum, as the all-reduce weights
it); the average then only divides them by the data size, the int8
reduction over ``"pod"`` shares each leaf's scale over the data slices
too, and ``grad_norm`` is reduced over ``"data"`` as well.

``make_eval_step(cfg)``, ``make_prefill_step(cfg, max_len)`` and
``make_decode_step(cfg)`` are forward-only, under ``torch.inference_mode``.
For an encoder (``causal=False``) "prefill" is a full bidirectional
encode: ``(logits, None)``; for a decoder it is ``transformer.prefill``:
``(logits, decode cache)``. Each callable runs where the params it is given
lie: ``init_params(cfg, seed)`` builds them on the card (``device``
defaults to ``"cuda"`` and raises without one, as everywhere in the port);
``device="cpu"`` runs the plain PyTorch path on the CPU.

    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    state = init_train_state(cfg, seed=0, hyper=hyper, device="cpu")
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=4, device="cpu")
    state, metrics = make_train_step(cfg, hyper)(state, data.batch_at(0))
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.common.tree import (
    tree_get,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_model,
    loss_fn,
    prefill,
)
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    is_frozen,
    mask_frozen,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "TrainHyper",
    "TrainState",
    "init_params",
    "init_train_state",
    "train_state_from_params",
    "loss_grads",
    "make_train_step",
    "make_eval_step",
    "make_prefill_step",
    "make_decode_step",
]

TrainState = Dict[str, Any]     # {"params", "opt", "step"}

# keys the compute copy derives from the masters (``attention.
# rm_packed_weights``); they never enter a train state
_DERIVED_KEYS = ("rm_w", "rm_slab")


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_accum: int = 1
    adamw: AdamWConfig = AdamWConfig()
    # "none" | "int8_pod": compress the cross-pod gradient all-reduce
    grad_compression: str = "none"

    def __post_init__(self):
        if self.grad_compression not in ("none", "int8_pod"):
            raise ValueError(f"unknown grad_compression "
                             f"{self.grad_compression!r}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random fp32 master weights of ``cfg`` from ``seed``, on ``device``.

    Raises:
        RuntimeError: ``device`` is CUDA (the default) and there is none.
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return init_model(cfg, gen)


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     hyper: TrainHyper = TrainHyper(),
                     device="cuda") -> TrainState:
    """``{"params", "opt", "step"}``: masters from ``seed`` on ``device``,
    zero AdamW moments, step 0; with ``grad_compression="int8_pod"`` also
    zero fp32 ``residuals`` of the params' layout."""
    return train_state_from_params(init_params(cfg, seed, device), hyper)


def train_state_from_params(params, hyper: TrainHyper = TrainHyper()
                            ) -> TrainState:
    """The step-0 train state around ``params`` (full, or a tensor-parallel
    rank's shards), on their device."""
    state = {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if hyper.grad_compression == "int8_pod":
        state["residuals"] = tree_map_with_path(
            lambda _, p: torch.zeros_like(p, dtype=torch.float32), params)
    return state


def _lr_at(hyper: TrainHyper, step):
    return warmup_cosine(step, hyper.peak_lr, hyper.warmup_steps,
                         hyper.total_steps)


def _check_masters(params) -> None:
    def check(path, _):
        if any(k in _DERIVED_KEYS for k in path):
            raise ValueError(
                f"train state params hold {'/'.join(map(str, path))}, a "
                "key derived for the kernels (cast_params_to_compute); "
                "train the fp32 masters, not the compute copy")
    tree_map_with_path(check, params)


def loss_grads(cfg: ModelConfig, params, batch):
    """``(grads, metrics)`` of ``loss_fn`` at ``params`` (the fp32
    masters): every trainable float leaf is differentiated; frozen
    (``optim.adamw.is_frozen``) and integer leaves, and leaves the batch
    does not reach, get zero gradients. ``grads`` has ``params``' layout;
    ``metrics`` are ``loss_fn``'s, detached."""
    trainable = {}

    def live(path, p):
        if is_frozen(path) or not p.is_floating_point():
            return p
        trainable[path] = p.detach().requires_grad_(True)
        return trainable[path]

    loss, metrics = loss_fn(tree_map_with_path(live, params), cfg, batch)
    grads = dict(zip(trainable, torch.autograd.grad(
        loss, list(trainable.values()), allow_unused=True)))

    def grad(path, p):
        g = grads.get(path)
        return torch.zeros_like(p) if g is None else g

    return (tree_map_with_path(grad, params),
            {k: v.detach() for k, v in metrics.items()})


def _microbatch(batch, accum: int, i: int):
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
            for k, v in batch.items()}


def _token_weight(tokens: torch.Tensor, group):
    """``(weight, sum)``: a rank's share of the target tokens over
    ``group``, ``tokens_r * n / sum tokens`` (exactly 1 for equal counts),
    and the sum."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import all_reduce

    tokens = tokens.float().reshape(1)
    total = all_reduce(tokens.clone(), group)
    return tokens[0] * dist.get_world_size(group) / total[0], total[0]


def _average(grads, metrics, group, residuals=None, *, summed=None,
             scale_group=None):
    """Average ``grads`` and ``metrics`` over ``group`` in place: each
    rank's share weighted by its target tokens (:func:`_token_weight`),
    then one ``all_reduce`` a leaf and ``/ n``, or with ``residuals`` the
    int8 reduction with error feedback (``optim.compression.
    compress_leaf``, its scale shared over ``scale_group`` too where a
    leaf is cut over it), the new residuals written over the old.
    ``summed``: a tree, not None where a leaf's gradient is already the
    weighted sum over ``group`` (FSDP's), which is only divided by ``n``.
    Returns ``(grads, metrics)``; ``metrics["tokens"]`` becomes the sum
    over the group."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.optim.compression import compress_leaf

    n = dist.get_world_size(group)
    weight, total = _token_weight(metrics["tokens"], group)
    keys = [k for k in metrics if k != "tokens"]
    vec = all_reduce(torch.stack([metrics[k].float() * weight
                                  for k in keys]), group).div_(n)
    metrics = {**dict(zip(keys, vec.unbind())), "tokens": total}

    def leaf(path, g):
        if not g.is_floating_point():      # frozen integer tables
            return
        if summed is not None and tree_get(summed, path) is not None:
            g.div_(n)
            return
        g.mul_(weight)
        if residuals is None:
            all_reduce(g, group).div_(n)
            return
        r = tree_get(residuals, path)
        cut = scale_group is not None and tree_get(scale_group[1],
                                                   path) is not None
        mean, new_r = compress_leaf(g, r, group,
                                    scale_group[0] if cut else None)
        g.copy_(mean)
        r.copy_(new_r)

    tree_map_with_path(leaf, grads)
    return grads, metrics


def make_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper(), *,
                    data_group=None, pod_group=None, cuts=None,
                    fsdp_dims=None):
    """``step(state, batch) -> (state, metrics)``: gradients of ``loss_fn``
    (averaged over ``hyper.grad_accum`` microbatches; then over
    ``data_group``, then over ``pod_group``, int8-compressed under
    ``grad_compression="int8_pod"``), then one AdamW step at the
    warm-up-cosine learning rate of ``state["step"]``. ``metrics`` holds
    ``loss_fn``'s (``loss``, ``ce``, ``z_loss``, ``tokens``) and the
    optimizer's (``grad_norm``, ``lr``), as 0-dim tensors on the state's
    device, the same on every rank. With ``cuts`` (a tensor-parallel
    rank's ``tensor_parallel.param_cuts``, the step run inside its
    ``local_view``) the replicated kv heads' gradients are summed over
    their ranks and ``grad_norm`` is the global one. With ``fsdp_dims``
    (the FSDP cut's ``distributed.fsdp.data_dims`` of the full params;
    ``data_group`` required) the step trains a rank's data slices, as the
    module doc says.

    Raises:
        ValueError: ``int8_pod`` without a ``pod_group``; the params hold
            the compute copy's derived keys (``rm_w``, ``rm_slab``), or
            the batch does not split into ``grad_accum`` microbatches.
    """
    accum = hyper.grad_accum
    compress = hyper.grad_compression == "int8_pod"
    if compress and pod_group is None:
        raise ValueError("grad_compression='int8_pod' reduces over a pod "
                         "process group: pass pod_group= (Trainer(mesh=) "
                         "with a 'pod' axis)")

    def accumulate(params, batch):
        if accum == 1:
            return loss_grads(cfg, params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{accum} microbatches")
        g, m = loss_grads(cfg, params, _microbatch(batch, accum, 0))
        for i in range(1, accum):
            gi, mi = loss_grads(cfg, params, _microbatch(batch, accum, i))
            g = tree_map_with_path(lambda path, a: a + tree_get(gi, path),
                                   g)
            m = {k: m[k] + mi[k] for k in m}
        scale = 1.0 / accum
        g = tree_map_with_path(lambda _, x: x * scale, g)
        return g, {k: v * scale for k, v in m.items()}

    def plan_for(batch):
        if fsdp_dims is None:
            return None
        import torch.distributed as dist

        weight, _ = _token_weight((batch["targets"] >= 0).sum(), data_group)
        return fsdp.Plan(data_group, dist.get_group_rank(
            data_group, dist.get_rank()), dist.get_world_size(data_group),
            fsdp_dims, weight)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        _check_masters(state["params"])
        plan = plan_for(batch)
        with fsdp.training(plan):
            grads, metrics = accumulate(state["params"], batch)
        if cuts is not None:
            grads = tp.sync_replicated_grads(grads, cuts)
        if data_group is not None:
            grads, metrics = _average(grads, metrics, data_group,
                                      summed=fsdp_dims)
        if pod_group is not None:
            grads, metrics = _average(
                grads, metrics, pod_group,
                state["residuals"] if compress else None,
                scale_group=None if fsdp_dims is None else (data_group,
                                                            fsdp_dims))
        grad_norm = None if cuts is None and plan is None else \
            tp.global_grad_norm(mask_frozen(grads), cuts, plan)
        lr = _lr_at(hyper, state["step"])
        params, opt, opt_metrics = adamw_update(
            state["params"], grads, state["opt"], lr, hyper.adamw,
            grad_norm=grad_norm)
        new_state = dict(state)
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        return new_state, {**metrics, **opt_metrics}

    return step_fn


def make_eval_step(cfg: ModelConfig):
    """``eval_step(params, batch) -> metrics`` (``ce``, ``z_loss``,
    ``tokens``, ``loss``; ``batch["targets"]`` as ``loss_fn`` takes it)."""
    def eval_step(params, batch: Dict[str, Any]):
        with torch.inference_mode():
            _, metrics = loss_fn(params, cfg, batch)
        return metrics

    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``prefill_step(params, batch) -> (logits [B, T, V] fp32, cache)``;
    the cache is ``None`` for an encoder."""
    def prefill_step(params, batch: Dict[str, Any]):
        with torch.inference_mode():
            if not cfg.causal:
                # encoder: "prefill" is a full (bidirectional) encode
                logits, _ = forward(params, cfg, batch)
                return logits, None
            return prefill(params, cfg, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode(params, cache, batch) -> (logits [B, 1, V] fp32, cache)``
    with ``batch["tokens"] [B, 1]`` and ``batch["positions"] [B]``."""
    def step(params, cache, batch: Dict[str, Any]):
        with torch.inference_mode():
            return decode_step(params, cfg, cache, batch["tokens"],
                               batch["positions"])

    return step
