"""The step executor: model calls and the batched decode cache (port of
``repro.serve.executor``).

The executor owns everything that touches the device: construction-time
config validation (causal, attention mode, estimator, precision, fusion
mode), the prefill bucket ladder, the compute-dtype copy of the weights
(made once), the batched decode cache (``num_slots`` lanes, spliced per
admission: the rm decode state, or exact attention's ring-buffer KV
cache), and the prefill and decode calls. PyTorch runs eagerly, so there is no compile
cache; CUDA graphs for the decode step are later work.

On a mesh (``mesh=``, a ``DeviceMesh`` over ``("data", "model")`` or
``("pod", "data", "model")``) every rank runs the same executor calls in
the same order; only the model's compute is sharded. The weights are this
rank's shards (``distributed.tensor_parallel.init_local_params``); the
decode cache follows ``cache_partition_specs``: its slots split over the
batch axes where ``num_slots`` divides them (else every rank holds every
slot) and its heads (the SSM mixers' channels and heads too:
``tensor_parallel.cache_cuts``) over ``"model"``, at ``local_config``'s
widths. On a data axis above 1 with the ``"fsdp"`` rule on
(``distributed.fsdp.enabled``; a rules context with ``{"fsdp": None}``
around the construction keeps them whole) the weights are cut over
``"data"`` too, as the reference's executor places them with
``params_partition_specs``: each leaf's ``"fsdp"`` dim is this rank's
slice (``launch.serve.make_engine`` draws the slices; weights handed over
are cut by ``shard_params(fsdp_cut=True)``), the compute copy is made of
the slices, and each prefill and decode step gathers a block's slices
just before the block (``distributed.fsdp.training`` with its serving
plan), forward only; a data rank that does not own an admission's slot
joins its prefill's gathers without computing. A prefill whose length the model axis divides
runs with the residual stream cut by sequence (``"act_seq"``). A MoE
config splits its slots like a dense one, but its MoE layers route the
whole decode batch: ``models.moe`` all-gathers their tokens over the
batch axes, routes and counts capacity over every lane, as the
reference's single-controller step does, and keeps this rank's rows
(``LocalView.gather_batch``), so the tokens are ``mesh=None``'s and a
rank's cache is its slots' share. A request's prefill runs on
the ranks that own its slot, and its first logits row is broadcast from
them. After each decode
step the local logits are gathered over the batch axes and their vocab
columns over ``"model"``, so every rank samples every slot and makes the
same admissions, evictions and restarts (the reference is single-
controller: ``src/repro/serve/executor.py:152-169``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.collectives import all_gather, broadcast
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _split_kind,
    cast_params_to_compute,
    decode_step,
    init_decode_cache,
    join_serving_gathers,
    meta_params,
    prefill,
)

__all__ = ["DEFAULT_BUCKETS", "StepExecutor", "effective_buckets"]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def effective_buckets(buckets: Sequence[int], max_len: int) -> Tuple[int, ...]:
    """Clip a bucket ladder to the lengths ``max_len`` can serve: every
    bucket strictly below ``max_len``, then ``max_len`` itself."""
    ladder = tuple(int(b) for b in buckets)
    if not ladder:
        raise ValueError("buckets must be a non-empty sequence of ints")
    if any(b <= 0 for b in ladder):
        raise ValueError(f"buckets must all be positive, got {ladder}")
    if any(b >= nxt for b, nxt in zip(ladder, ladder[1:])):
        raise ValueError(
            f"buckets must be strictly increasing, got {ladder}")
    return tuple(b for b in ladder if b < max_len) + (int(max_len),)


class StepExecutor:
    """Owns the weights, the batched decode cache and the step calls.

    Args:
        cfg: frozen model config (validated here).
        params: model parameters (``models.transformer.init_model`` or
            ``convert.params_from_jax``), on ``device``.
        num_slots: decode lanes in the batched cache.
        max_len: per-lane length; position ``max_len - 1`` is the scratch
            position idle lanes decode into.
        buckets: prefill bucket ladder (default :data:`DEFAULT_BUCKETS`),
            clipped to ``max_len`` (:func:`effective_buckets`).
        device: where the cache lives and the steps run.
        feature_generations: how many equal generations the RM feature
            budget splits into for accuracy tiers (1: no tiers).
        mesh: optional ``DeviceMesh`` (see the module doc); ``params``
            are then this rank's shards
            (``distributed.tensor_parallel.init_local_params``, or
            ``shard_params`` of weights handed over), cut over ``"data"``
            exactly where ``distributed.fsdp.enabled(mesh)`` (the
            constructor raises ``ValueError`` otherwise).

    Attributes:
        estimator: the registry name of the RM feature family served
            (None for ``attention_mode="exact"``).
        fused_attention: whether attention runs the fused ops (kernel B2)
            or the two-launch path (featurize, then kernel B5); False for
            exact softmax attention, which is plain PyTorch with a
            ring-buffer KV cache.
        generation_features: the columns of one tier generation (None
            outside rm mode).
        bucketed: whether prompts are padded to a bucket of the ladder.

    Raises:
        ValueError: an encoder config, an unknown attention mode,
            ``feature_generations`` below 1, not dividing the RM budget,
            or above 1 outside rm mode; a mesh axis other than ``pod``,
            ``data`` and ``model``.
        RuntimeError: a mesh without a process group behind it.
    """

    def __init__(self, cfg: ModelConfig, params: Any, num_slots: int,
                 max_len: int, *, buckets: Sequence[int] = None,
                 device="cuda", feature_generations: int = 1, mesh=None):
        if not cfg.causal:
            raise ValueError("encoder-only models cannot be served "
                             "autoregressively")
        if cfg.attention_mode not in ("exact", "rm"):
            raise ValueError(f"attention_mode must be 'exact' or 'rm', got "
                             f"{cfg.attention_mode!r}")
        # exact softmax attention has no feature family and no fused path
        self.estimator = None
        self.fused_attention = False
        feature_generations = int(feature_generations)
        if feature_generations < 1:
            raise ValueError(f"feature_generations must be >= 1, got "
                             f"{feature_generations}")
        self.feature_generations = feature_generations
        self.generation_features = None
        if cfg.attention_mode == "rm":
            from repro_torch.common.dtypes import resolve_precision
            from repro_torch.core import registry
            from repro_torch.models.attention import rm_fuse_enabled

            # fail at construction, naming the valid options
            self.estimator = registry.get(cfg.rm.estimator).name
            resolve_precision(cfg.rm.precision)
            self.fused_attention = rm_fuse_enabled(cfg)
            # every tier's budget is a whole number of generations
            if cfg.rm.num_features % feature_generations:
                raise ValueError(
                    f"cfg.rm.num_features={cfg.rm.num_features} must "
                    f"divide evenly into feature_generations="
                    f"{feature_generations} (per-tier budgets are whole "
                    "generations)")
            self.generation_features = (cfg.rm.num_features
                                        // feature_generations)
        elif feature_generations != 1:
            raise ValueError(
                f"feature_generations={feature_generations} requires the "
                f"RM attention mode; {cfg.attention_mode!r} has no "
                "feature budget to tier")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.mesh = mesh
        # the config and weights the model calls take: a rank's on a mesh
        self.model_cfg = cfg
        self.local_slots = self.num_slots
        self._split = False
        self._plan = None
        if mesh is not None:
            self._set_mesh(mesh)
            if fsdp.enabled(mesh):
                self._plan = self._serving_plan(params)
        self.params = params
        # the fp32 master weights stay; the steps read one compute copy
        self.compute_params = cast_params_to_compute(params, self.model_cfg)
        self.max_len = int(max_len)
        self.buckets = effective_buckets(
            DEFAULT_BUCKETS if buckets is None else buckets, self.max_len)
        mixers = {_split_kind(kind)[0] for kind in cfg.block_pattern}
        self.bucketed = mixers <= {"attn", "mla"}
        self.cache = None
        self.reset_cache()

    def _set_mesh(self, mesh) -> None:
        from repro_torch.distributed.sharding import mesh_axes
        from repro_torch.launch.mesh import mesh_device

        tp.local_view_of(mesh)             # raises without a process group
        axes = set(mesh_axes(mesh))
        if not axes <= {"pod", "data", "model"}:
            raise ValueError(f"serving meshes have axes pod, data and model;"
                             f" got {sorted(axes)}")
        if self.device.type != mesh.device_type:
            raise ValueError(f"device {self.device} is not the mesh's "
                             f"{mesh.device_type!r}")
        self.device = mesh_device(mesh)
        self.model_cfg = tp.local_config(self.cfg, tp.model_size_of(mesh))
        self._act_seq = tp.act_seq_axes()
        self._index, parts = tp.batch_index(mesh)
        # cache_partition_specs' rule: slots over the batch axes where
        # they divide num_slots (a MoE gathers the lanes to route them)
        self._split = parts > 1 and self.num_slots % parts == 0
        if self._split:
            self.local_slots = self.num_slots // parts

    def _serving_plan(self, params):
        """The serving plan that gathers each block's slices over
        ``"data"`` a block at a time.

        Raises:
            ValueError: a leaf of ``params`` is not this rank's slice of
                its ``"fsdp"`` dim.
        """
        from repro_torch.common.tree import tree_get, tree_map_with_path
        from repro_torch.distributed.sharding import mesh_axes

        template = meta_params(self.cfg)
        dims = fsdp.data_dims(template, self.mesh)
        size = mesh_axes(self.mesh)[fsdp.DATA_AXIS]

        def check(path, p):
            dim = tree_get(dims, path)
            if dim is not None and \
                    p.shape[dim] * size != tree_get(template, path).shape[dim]:
                raise ValueError(
                    f"{'/'.join(map(str, path))} is not cut over 'data' "
                    "(the fsdp rule is on: shard_params(fsdp_cut=True))")

        tree_map_with_path(check, params)
        return fsdp.plan_for_mesh(self.mesh, dims, serving=True)

    @contextlib.contextmanager
    def _view(self, batch_sharded: bool = False):
        """The mesh's local view (the MoE routing the whole batch where it
        is split) and the serving plan (nothing without a mesh)."""
        if self.mesh is None:
            yield None
            return
        # a prefill only the slot's owner runs cuts no sequence over "data"
        with tp.local_view(self.mesh, batch_sharded=batch_sharded,
                           gather_batch=batch_sharded,
                           data_seq=not self._split,
                           act_seq=self._act_seq) as view, \
                fsdp.training(self._plan):
            yield view

    def tier_features(self, generations: int) -> int:
        """The feature budget a tier of ``generations`` generations
        certifies: the first ``generations * generation_features``
        columns.

        Raises:
            ValueError: outside rm mode, or ``generations`` outside [1,
                ``feature_generations``].
        """
        if self.generation_features is None:
            raise ValueError(
                "accuracy tiers require the RM attention mode "
                f"(attention_mode={self.cfg.attention_mode!r})")
        g = int(generations)
        if not 1 <= g <= self.feature_generations:
            raise ValueError(
                f"tier generations={generations} out of range [1, "
                f"{self.feature_generations}]")
        return g * self.generation_features

    @property
    def scratch_position(self) -> int:
        """The cache position idle lanes decode into (output discarded)."""
        return self.max_len - 1

    @torch.inference_mode()
    def reset_cache(self) -> None:
        """(Re)initialize the batched decode cache — fresh lanes."""
        self.cache = init_decode_cache(self.model_cfg, self.local_slots,
                                       self.max_len, self.device)

    def bucket_for(self, n: int) -> int:
        """Smallest effective-ladder bucket holding an ``n``-token prompt
        (``n`` itself where prompts are not bucketed)."""
        if not self.bucketed:
            return int(n)
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"({self.buckets[-1]} tokens); shorten the prompt or raise "
            "max_len / extend the bucket ladder")

    @torch.inference_mode()
    def prefill(self, prompt: np.ndarray) -> Tuple[torch.Tensor, Any, int]:
        """Run one request's prefill; return ``(logits [1, bucket, V],
        cache1, bucket)``. The prompt is right-padded to its bucket with
        tokens at sentinel position -1, which the attention masks out of
        every key sum and of the decode state."""
        t = len(prompt)
        tb = self.bucket_for(t)
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, :t] = np.asarray(prompt, np.int64)
        positions = np.full((1, tb), -1, np.int32)
        positions[0, :t] = np.arange(t, dtype=np.int32)
        with self._view():
            logits, cache1 = prefill(
                self.compute_params, self.model_cfg,
                {"tokens": torch.from_numpy(tokens).to(self.device),
                 "positions": torch.from_numpy(positions).to(self.device)},
                self.max_len)
        return logits, cache1, tb

    @torch.inference_mode()
    def admit(self, slot: int, prompt: np.ndarray
              ) -> Tuple[torch.Tensor, int]:
        """Prefill ``prompt`` into lane ``slot``; return ``(logits of its
        last real position [1, V] fp32, bucket)``. On a mesh whose batch
        axes split the slots, the ranks that own ``slot`` run the prefill
        and broadcast the row to the others (every rank calls this); with
        the weights cut over ``"data"`` the others join the prefill's
        gathers of each block over ``"data"`` and compute nothing
        (``models.transformer.join_serving_gathers``)."""
        t = len(prompt)
        owner = slot // self.local_slots if self._split else None
        if owner is None or owner == self._index:
            logits, cache1, tb = self.prefill(prompt)
            self.splice(slot % self.local_slots, cache1)
            with self._view():
                row = tp.gather_vocab(logits[:, t - 1], self.model_cfg)
        else:
            tb = self.bucket_for(t)
            with self._view():
                join_serving_gathers(self.compute_params, self.model_cfg)
            row = torch.empty((1, self.cfg.vocab_size), dtype=torch.float32,
                              device=self.device)
        if owner is not None:
            # data group first (within each pod, from the owner's data
            # index), then pod group (from the owner's pod)
            from repro_torch.distributed.sharding import mesh_axes

            sizes = mesh_axes(self.mesh)
            data = sizes.get("data", 1)
            for axis, src in (("data", owner % data), ("pod", owner // data)):
                if sizes.get(axis, 1) > 1:
                    broadcast(row, self.mesh.get_group(axis), src)
        return row, tb

    @torch.inference_mode()
    def splice(self, slot: int, cache1: Any) -> None:
        """Write a request's (batch=1) prefill state into lane ``slot``,
        in place (the batched cache is not copied)."""
        for big, small in zip(self.cache["layers"], cache1["layers"]):
            for name, lane in small.items():
                big[name][slot].copy_(lane[0])

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """One batched decode step over ALL lanes; updates the cache.

        ``tokens [num_slots, 1]`` and ``positions [num_slots]`` int
        tensors (idle lanes at :attr:`scratch_position`). Returns logits
        ``[num_slots, 1, V]`` fp32.
        """
        if self.mesh is None:
            logits, self.cache = decode_step(
                self.compute_params, self.cfg, self.cache,
                tokens.to(self.device), positions.to(self.device))
            return logits
        lo = self._index * self.local_slots if self._split else 0
        lanes = slice(lo, lo + self.local_slots)
        with self._view(batch_sharded=self._split) as view:
            logits, self.cache = decode_step(
                self.compute_params, self.model_cfg, self.cache,
                tokens[lanes].to(self.device),
                positions[lanes].to(self.device))
            logits = tp.gather_vocab(logits, self.model_cfg)
            for group in reversed(view.batch_groups):   # data, then pod
                logits = torch.cat(all_gather(logits, group), dim=0)
        return logits
