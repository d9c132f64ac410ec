"""Carry reference parameters into the port.

``params_from_jax(tree, cfg)`` takes the reference's parameter tree with
numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``) and returns
the port's parameters: numpy in, tensors out. The reference stacks its
scanned layers on a leading axis of ``params["groups"]``
(``repro.models.transformer.init_model``); the port keeps one dict per
layer, so that axis is unstacked, group-major then pattern order, after
the ``first_k_dense`` leading blocks ``dense_{i}``. A block's mixer
(``attn``, or MLA's ``mla``) and FFN (``mlp``, or ``moe``: the router,
the stacked expert weights ``[E, d, ff]`` / ``[E, ff, d]`` and the
shared experts) cross leaf by leaf under their own names. The
``rm_est`` estimator params (the rm omegas, the tensor_sketch hash tables
``h`` int32 and signs ``s``, the ctr rows ``wr``/``wi`` or the structured
signs ``d1``/``d2``) and ``rm_scale`` cross unchanged with
the rest, dtypes included, so both packages compute with the same weights
and the same random draws. An exact-attention tree, which has neither
leaf, crosses the same way.

``train_state_from_jax(state, cfg)`` carries a reference train state
(``{"params", "opt": {"mu", "nu", "step"}, "step"}``, numpy leaves) across
the same way: the params and both AdamW moments each through
``params_from_jax``'s layer unstacking, the steps as 0-dim int32 tensors,
so a train step of both packages starts from the same state.

``compositional_from_jax(cfm)`` does the same for the reference's
Algorithm 2 map (``repro.core.compositional.CompositionalFeatureMap``):
each inner map's arrays (a Rademacher map's ``omega``, an RFF map's ``w``,
``b`` and ``sigma``), then the scales, const, degrees and counts are read
through ``np.asarray`` and rebuilt as the port's map, on the CPU.

``growable_from_jax(gm, kernel=)`` hands the reference's
``GrowableFeatureMap`` across: its plan through the plans' shared JSON
(the port's plan type of the same family), its stacked ``[G, ...]``
params generation by generation, and its bound context. A JAX key cannot
seed a ``torch.Generator``: generations drawn after the hand-over (a
``grow()`` of the port's map) come from the port's keying rule
(``core.doubling``) at ``seed``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_kinds

__all__ = ["params_from_jax", "train_state_from_jax",
           "compositional_from_jax", "growable_from_jax"]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16: no numpy bridge
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """Reference parameter tree (numpy leaves) -> the port's parameters
    (CPU tensors; move them with ``.to(device)`` leaf by leaf)."""
    kinds = layer_kinds(cfg)
    layers = []
    for i in range(cfg.first_k_dense):
        layers.append(_map(tree[f"dense_{i}"], _tensor))
    for g in range(cfg.num_scanned_groups):
        for j, kind in enumerate(cfg.block_pattern):
            block = tree["groups"][f"b{j}_{kind}"]
            layers.append(_map(block, lambda a, g=g: _tensor(a[g])))
    if len(layers) != len(kinds):
        raise ValueError(f"reference tree holds {len(layers)} layers, "
                         f"{cfg.name} has {len(kinds)}")
    return {
        "embed": _map(tree["embed"], _tensor),
        "layers": layers,
        "final_norm": _map(tree["final_norm"], _tensor),
    }


def train_state_from_jax(state: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """Reference train state (numpy leaves) -> the port's (CPU tensors)."""
    opt = state["opt"]
    return {
        "params": params_from_jax(state["params"], cfg),
        "opt": {"mu": params_from_jax(opt["mu"], cfg),
                "nu": params_from_jax(opt["nu"], cfg),
                "step": _tensor(np.asarray(opt["step"], np.int32))},
        "step": _tensor(np.asarray(state["step"], np.int32)),
    }


def compositional_from_jax(cfm):
    """The reference's ``CompositionalFeatureMap`` (its leaves anything
    ``np.asarray`` reads) -> the port's, its draws as CPU tensors.

    Raises:
        TypeError: an inner map that is neither Rademacher (``omega``) nor
            RFF (``w``, ``b``).
    """
    from repro_torch.core.compositional import (
        CompositionalFeatureMap,
        RademacherInnerMap,
        RFFInnerMap,
    )

    inner = []
    for m in cfm.inner_maps:
        if hasattr(m, "omega"):
            inner.append(RademacherInnerMap(omega=_tensor(m.omega)))
        elif hasattr(m, "w") and hasattr(m, "b"):
            inner.append(RFFInnerMap(w=_tensor(m.w), b=_tensor(m.b),
                                     sigma=float(m.sigma)))
        else:
            raise TypeError(f"no port counterpart for inner map "
                            f"{type(m).__name__}")
    const = None if cfm.const is None else float(np.asarray(cfm.const))
    return CompositionalFeatureMap(
        degrees=tuple(int(n) for n in cfm.degrees),
        counts=tuple(int(c) for c in cfm.counts), inner_maps=inner,
        scales=[float(np.asarray(s)) for s in cfm.scales], const=const,
        input_dim=int(cfm.input_dim))


def growable_from_jax(gm, kernel=None, seed: int = 0):
    """The reference's ``GrowableFeatureMap`` (its leaves anything
    ``np.asarray`` reads) -> the port's, on the CPU. ``kernel`` is the
    port's ``DotProductKernel`` for the bound side (``eps_at``,
    ``required_generations``); ``seed`` keys generations drawn later."""
    import importlib

    from repro_torch.core.doubling import GrowableFeatureMap

    ptype = type(gm.plan)
    mod = ptype.__module__.replace("repro.", "repro_torch.", 1)
    plan = getattr(importlib.import_module(mod),
                   ptype.__qualname__).from_json(gm.plan.to_json())
    stacked = {k: np.asarray(v) for k, v in gm.params.items()}
    params = [{k: _tensor(v[g]) for k, v in stacked.items()}
              for g in range(int(gm.n_generations))]
    return GrowableFeatureMap(
        estimator=gm.estimator, plan=plan, params=params,
        n_generations=int(gm.n_generations), seed=int(seed), kernel=kernel,
        radius=float(gm.radius), measure=gm.measure, p=float(gm.p),
        omega_dtype=next((v.dtype for v in params[0].values()
                          if v.is_floating_point()), torch.float32),
        device=torch.device("cpu"))
