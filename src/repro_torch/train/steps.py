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
from repro_torch.common.tree import tree_get, tree_map_with_path
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
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "TrainHyper",
    "TrainState",
    "init_params",
    "init_train_state",
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
    # "none" only: "int8_pod" compresses a cross-pod all-reduce, which
    # needs a mesh (ROADMAP.md queue A item 7)
    grad_compression: str = "none"

    def __post_init__(self):
        if self.grad_compression == "int8_pod":
            raise NotImplementedError(
                "grad_compression='int8_pod' all-reduces over a mesh's pod "
                "axis; the port has no mesh yet (ROADMAP.md queue A item 7)")
        if self.grad_compression != "none":
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
    zero AdamW moments, step 0."""
    params = init_params(cfg, seed, device)
    return {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=resolve_device(device)),
    }


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


def make_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper()):
    """``step(state, batch) -> (state, metrics)``: gradients of ``loss_fn``
    (averaged over ``hyper.grad_accum`` microbatches), then one AdamW step
    at the warm-up-cosine learning rate of ``state["step"]``. ``metrics``
    holds ``loss_fn``'s (``loss``, ``ce``, ``z_loss``, ``tokens``) and the
    optimizer's (``grad_norm``, ``lr``), as 0-dim tensors on the state's
    device.

    Raises:
        ValueError: the params hold the compute copy's derived keys
            (``rm_w``, ``rm_slab``), or the batch does not split into
            ``grad_accum`` microbatches.
    """
    accum = hyper.grad_accum

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

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        _check_masters(state["params"])
        grads, metrics = accumulate(state["params"], batch)
        lr = _lr_at(hyper, state["step"])
        params, opt, opt_metrics = adamw_update(
            state["params"], grads, state["opt"], lr, hyper.adamw)
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
