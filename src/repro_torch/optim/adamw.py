"""AdamW (port of ``repro.optim.adamw``): decoupled weight decay,
global-norm gradient clipping, non-trainable masking (the RM plan's
omegas and every other estimator draw are frozen model constants).

Trees are the port's params: nested dicts and the per-layer list
(``common.tree``). The optimizer state is ``{"mu", "nu", "step"}`` with
``mu``/``nu`` shaped like the params and ``step`` a 0-dim int32 tensor.

``adamw_update`` writes the new params and moments IN PLACE and returns
them: the reference's trainer donates its state to the jitted step, so no
caller reads the old state, and updating in place keeps one copy of
params, ``mu`` and ``nu`` on the card (three fp32 copies of a 1.7B model
are 20.6 GB) instead of two. It runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import (
    tree_get,
    tree_leaves,
    tree_map_with_path,
)

__all__ = [
    "FROZEN_LEAF_NAMES",
    "FROZEN_SUBTREES",
    "AdamWConfig",
    "is_frozen",
    "adamw_init",
    "global_norm",
    "clip_by_global_norm",
    "mask_frozen",
    "adamw_update",
]

# the reference's names of parameters that are never updated: the static
# draws of the paper's feature maps are part of the model DEFINITION.
# "rm_est" is the estimator-registry subtree (RM omegas; TensorSketch hash
# tables, which are int32 and must never see an optimizer step).
FROZEN_LEAF_NAMES = ("rm_omegas",)
FROZEN_SUBTREES = ("rm_est",)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # 1-D params (norm scales, biases) skip weight decay
    decay_min_ndim: int = 2


def is_frozen(path: Tuple[Any, ...]) -> bool:
    """Whether the leaf at ``path`` (``common.tree`` path) is frozen."""
    return bool(path) and (path[-1] in FROZEN_LEAF_NAMES
                           or any(p in FROZEN_SUBTREES for p in path))


def adamw_init(params: Any) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and step 0, on their device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {
        "mu": tree_map_with_path(lambda _, p: torch.zeros_like(p), params),
        "nu": tree_map_with_path(lambda _, p: torch.zeros_like(p), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    """``(grads * min(1, max_norm / norm), norm)``; new tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map_with_path(lambda _, g: g * scale, grads), norm


def mask_frozen(grads: Any) -> Any:
    """Zero the gradients of non-trainable leaves."""
    return tree_map_with_path(
        lambda path, g: torch.zeros_like(g) if is_frozen(path) else g, grads)


def adamw_update(
    params: Any,
    grads: Any,
    opt_state: Dict[str, Any],
    lr,
    cfg: AdamWConfig = AdamWConfig(),
    *,
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step -> ``(params, opt_state, {"grad_norm", "lr"})``.
    ``grad_norm``: the norm to clip by where the caller has it (a
    tensor-parallel rank holds a part of the gradient; its global norm is
    ``distributed.tensor_parallel.global_grad_norm``), else
    :func:`global_norm` of ``grads``.

    Frozen leaves keep their values (their gradients are masked to 0, so
    their moments stay 0). The gradients are clipped to
    ``cfg.grad_clip_norm`` by their global norm (after masking) one leaf at
    a time, so no clipped copy of the whole tree is made. ``params``,
    ``opt_state["mu"]`` and ``opt_state["nu"]`` are updated in place (see
    the module doc); ``grads`` are not modified.
    """
    with torch.no_grad():
        grads = mask_frozen(grads)
        if grad_norm is None:
            grad_norm = global_norm(grads)
        scale = _clip_scale(grad_norm, cfg.grad_clip_norm)
        step = opt_state["step"] + 1
        b1, b2 = cfg.b1, cfg.b2
        stepf = step.float()
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

        def leaf_update(path, p):
            m = tree_get(opt_state["mu"], path)
            v = tree_get(opt_state["nu"], path)
            g = tree_get(grads, path).to(m.dtype) * scale
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            if is_frozen(path):
                return p
            update = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if p.ndim >= cfg.decay_min_ndim:
                update.add_(p.to(update.dtype), alpha=cfg.weight_decay)
            if p.dtype == torch.float32:
                p.sub_(update.mul_(lr))
            else:           # a low-precision leaf: step in fp32, round once
                p.copy_(p.float() - lr * update)
            return p

        new_params = tree_map_with_path(leaf_update, params)
    metrics = {"grad_norm": grad_norm, "lr": lr}
    return new_params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                        "step": step}, metrics
