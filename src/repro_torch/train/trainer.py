"""The training loop (port of ``repro.train.trainer``): the step-indexed
data, the train step, the CheckpointManager (atomic, keep-k), the
StragglerMonitor and observability.

``Trainer(cfg, hyper, dataset, ckpt_dir=, mesh=, seed=, log_every=,
checkpoint_every=, obs=, device=)``. With ``mesh=None`` it trains on one
device. With a ``DeviceMesh`` over ``("data", "model")`` or ``("pod",
"data", "model")`` (``launch.mesh``) it trains on every rank, one
process a rank. Rank r trains on its rows of ``dataset.batch_at(step)``
(the batch dim split over the axes ``batch_partition_specs`` gives it)
and the gradients are averaged over ``"data"`` and then over ``"pod"``
(int8-compressed under ``grad_compression="int8_pod"``). A ``"model"``
axis above 1 adds tensor parallelism (``distributed.tensor_parallel``):
every rank draws its shards of the params from ``seed``, one block at a
time (``tensor_parallel.init_local_params``: the full weights never stand
on the card), or restores them from a checkpoint; it runs
the model at its local widths inside the mesh's local view and clips by
the global ``grad_norm``; ranks of one model index hold the same state
and log the same metrics. A ``"data"`` axis above 1 adds FSDP
(``distributed.fsdp``, the reference's ``"fsdp": "data"`` rule, on unless
a ``logical_rules_context`` maps ``"fsdp"`` to None when the Trainer is
built): params, ``mu``, ``nu`` and the int8 residuals are cut along each
leaf's ``"fsdp"`` dim over ``"data"``, drawn so from the seed, each block
gathered just before it runs and its gradients reduce-scattered. Only
rank 0 prints; every rank joins a save (the shards are gathered into the
full, topology-free state that rank 0 writes) and then waits at a
barrier, and a restore onto the mesh cuts the shards again
(``elastic_remesh(cfg=)`` moves a run between data and model sizes). A
step's
wall time is read on the ``obs`` clock after ``torch.cuda.synchronize`` (the
reference's ``block_until_ready``). With ``obs`` (``repro_torch.obs.Obs``)
each step records the reference's ``train/step`` span, ``train/step_s``
histogram, ``train/loss`` gauge and ``train/steps`` counter, and ticks the
drift monitor; ``obs=None`` is a no-op.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (active_rules,
                                              logical_rules_context)
from repro_torch.models.config import ModelConfig
from repro_torch.obs import resolve as _obs_resolve
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import StragglerMonitor
from repro_torch.train.steps import (
    TrainHyper,
    init_train_state,
    make_train_step,
    train_state_from_params,
)

__all__ = ["Trainer"]

_MESH_AXES = ("pod", "data", "model")


def _mesh_sizes(mesh, cfg: ModelConfig) -> Dict[str, int]:
    """The mesh's axis sizes, checked for training ``cfg`` on it.

    Raises:
        ValueError: an axis other than ``pod``, ``data`` and ``model``.
    """
    from repro_torch.distributed.sharding import mesh_axes

    sizes = mesh_axes(mesh)
    unknown = set(sizes) - set(_MESH_AXES)
    if unknown:
        raise ValueError(f"Trainer meshes have axes {_MESH_AXES}; got "
                         f"{tuple(sizes)}")
    tp.local_config(cfg, sizes.get("model", 1))
    return sizes


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        hyper: TrainHyper,
        dataset,
        ckpt_dir: Optional[str] = None,
        mesh=None,
        seed: int = 0,
        log_every: int = 10,
        checkpoint_every: int = 100,
        obs: Any = None,
        device="cuda",
    ):
        """Raises:
            ValueError: a mesh axis other than ``pod``, ``data`` and
                ``model``; ``device`` is not the mesh's device type;
                ``int8_pod`` without a ``"pod"`` axis.
            RuntimeError: ``device`` is CUDA (the default) and there is
                none.
        """
        self.cfg = cfg
        self.hyper = hyper
        self.dataset = dataset
        self.mesh = mesh
        self.device = resolve_device(device)
        groups = {}
        self._model = 1
        self._fsdp = False
        self._local_cfg = cfg
        self._template = self._cuts = None
        if mesh is not None:
            from repro_torch.launch.mesh import mesh_device

            sizes = _mesh_sizes(mesh, cfg)
            if self.device.type != mesh.device_type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device_type!r}")
            self.device = mesh_device(mesh)
            groups = {f"{axis}_group": mesh.get_group(axis)
                      for axis in ("data", "pod") if axis in sizes}
            self._sizes = sizes
            self._model = sizes.get("model", 1)
            self._fsdp = fsdp.enabled(mesh)
            self._local_cfg = tp.local_config(cfg, self._model)
            self._act_seq = tp.act_seq_axes()
        # the state is cut: over "model", or over "data" (FSDP)
        self._sharded = self._model > 1 or self._fsdp
        self._rank0 = mesh is None or _global_rank() == 0
        self._rows_split = False
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every
        self.obs = _obs_resolve(obs)
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.metrics_log: List[Dict[str, float]] = []
        self._groups = groups
        self._step = make_train_step(self._local_cfg, hyper, **groups)
        self._seed = seed
        # the sharding rules the local config was made under: the state is
        # cut under them too, wherever init_or_restore is called
        self._rules = active_rules()

    # -- lifecycle -------------------------------------------------------------
    def init_or_restore(self) -> Dict[str, Any]:
        """The latest checkpoint's state, else a fresh one from the seed;
        on a model axis above 1 or under FSDP, this rank's shards of it."""
        if not self._sharded:
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                return self.ckpt.restore(device=self.device)
            return init_train_state(self.cfg, self._seed, self.hyper,
                                    device=self.device)
        with (contextlib.nullcontext() if self._rules is None
              else logical_rules_context(self.mesh, self._rules)):
            if self.ckpt is not None and \
                    self.ckpt.latest_step() is not None:
                self._set_layout(self.ckpt.shapes()["params"])
                return self.ckpt.restore(device=self.device, mesh=self.mesh,
                                         cfg=self.cfg)
            params, template = tp.init_local_params(
                self.cfg, self._seed, self.mesh, self.device,
                fsdp_cut=self._fsdp)
            self._set_layout(template)
        return train_state_from_params(params, self.hyper)

    def _set_layout(self, template) -> None:
        """The full params' shapes (``meta`` tensors: the gather's
        template) and their cuts over ``"model"`` and ``"data"``; the step
        clips by the global norm over them."""
        self._template = template
        self._cuts = tp.param_cuts(template, self.mesh, self.cfg) \
            if self._model > 1 else None
        dims = fsdp.data_dims(template, self.mesh) if self._fsdp else None
        self._step = make_train_step(self._local_cfg, self.hyper,
                                     cuts=self._cuts, fsdp_dims=dims,
                                     **self._groups)

    def _view(self):
        """The mesh's local view around a step (the model code reads it);
        no context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return tp.local_view(self.mesh, batch_sharded=self._rows_split,
                             act_seq=self._act_seq)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _local_rows(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows: the batch dim split over the mesh axes its
        spec names, in mesh order (all rows where the spec replicates);
        sets whether they were split."""
        if self.mesh is None:
            return batch
        from repro_torch.distributed.sharding import batch_partition_specs

        specs = batch_partition_specs(batch, self.mesh)
        out = {}
        for k, v in batch.items():
            axes = specs[k][0] if len(specs[k]) else None
            axes = () if axes is None else (
                axes if isinstance(axes, tuple) else (axes,))
            index, parts = 0, 1
            for axis in axes:
                index = (index * self._sizes[axis]
                         + self.mesh.get_local_rank(axis))
                parts *= self._sizes[axis]
            rows = v.shape[0] // parts
            out[k] = v[index * rows:(index + 1) * rows]
            self._rows_split = parts > 1
        return out

    def _save(self, step: int, state) -> None:
        """Rank 0 writes; on a mesh every rank then waits at a barrier. On
        a sharded mesh every rank first joins the gather of the full
        state."""
        state = self.full_state(state)
        if self._rank0:
            self.ckpt.save(step, state)
        if self.mesh is not None:
            _barrier(self.device)

    def full_state(self, state):
        """``state`` at full widths: this rank's shards gathered over
        ``"data"`` and ``"model"`` (every rank joins), or ``state`` itself
        where nothing is cut."""
        if not self._sharded:
            return state
        return tp.gather_state(state, self.mesh, self._template)

    def train(self, num_steps: int, state: Optional[Dict] = None):
        """Run steps ``state["step"] .. num_steps - 1``; log every
        ``log_every`` steps and the last one (a ``[train]`` line and a row
        of ``metrics_log``); checkpoint every ``checkpoint_every`` steps and
        at the end. Returns the final state."""
        state = state if state is not None else self.init_or_restore()
        if self._sharded and self._template is None:
            raise ValueError("a sharded Trainer (model axis above 1, or "
                             "FSDP) trains the state of its "
                             "init_or_restore()")
        start = int(state["step"])
        for step in range(start, num_steps):
            batch = self._local_rows(
                {k: v.to(self.device)
                 for k, v in self.dataset.batch_at(step).items()})
            self._sync()
            t0 = self.obs.now()
            with self.obs.span("train/step", step=step), self._view():
                state, metrics = self._step(state, batch)
                self._sync()
            dt = self.obs.now() - t0
            self.monitor.record(step, dt)
            self.obs.histogram("train/step_s", dt)
            if self.obs.enabled:
                # the host read of the loss stays off the disabled path
                self.obs.gauge("train/loss", float(metrics["loss"]))
                self.obs.counter("train/steps")
            self.obs.tick_drift()
            if step % self.log_every == 0 or step == num_steps - 1:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(step=step, sec_per_step=dt)
                self.metrics_log.append(row)
                if self._rank0:
                    print(f"[train] step={step:5d} loss={row['loss']:.4f} "
                          f"ce={row['ce']:.4f} "
                          f"gnorm={row['grad_norm']:.3f} "
                          f"{dt * 1000:.0f}ms", flush=True)
            if (self.ckpt is not None and step > start
                    and step % self.checkpoint_every == 0):
                self._save(step, state)
        if self.ckpt is not None:
            self._save(num_steps, state)
        return state


def _global_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _barrier(device: torch.device) -> None:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
