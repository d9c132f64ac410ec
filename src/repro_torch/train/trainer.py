"""The training loop (port of ``repro.train.trainer``): the step-indexed
data, the train step, the CheckpointManager (atomic, keep-k), the
StragglerMonitor and observability.

``Trainer(cfg, hyper, dataset, ckpt_dir=, seed=, log_every=,
checkpoint_every=, obs=, device=)`` on one device; ``mesh`` must be
``None`` (meshes wait for ROADMAP.md queue A item 7). A step's wall time
is read on the ``obs`` clock after ``torch.cuda.synchronize`` (the
reference's ``block_until_ready``). With ``obs`` (``repro_torch.obs.Obs``)
each step records the reference's ``train/step`` span, ``train/step_s``
histogram, ``train/loss`` gauge and ``train/steps`` counter, and ticks the
drift monitor; ``obs=None`` is a no-op.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import resolve as _obs_resolve
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import StragglerMonitor
from repro_torch.train.steps import (
    TrainHyper,
    init_train_state,
    make_train_step,
)

__all__ = ["Trainer"]


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
            NotImplementedError: a ``mesh`` is given.
            RuntimeError: ``device`` is CUDA (the default) and there is
                none.
        """
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) shards over a device mesh; the port has "
                "no mesh yet (ROADMAP.md queue A item 7)")
        self.cfg = cfg
        self.hyper = hyper
        self.dataset = dataset
        self.device = resolve_device(device)
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every
        self.obs = _obs_resolve(obs)
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.metrics_log: List[Dict[str, float]] = []
        self._step = make_train_step(cfg, hyper)
        self._seed = seed

    # -- lifecycle -------------------------------------------------------------
    def init_or_restore(self) -> Dict[str, Any]:
        """The latest checkpoint's state, else a fresh one from the seed."""
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            return self.ckpt.restore(device=self.device)
        return init_train_state(self.cfg, self._seed, self.hyper,
                                device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, num_steps: int, state: Optional[Dict] = None):
        """Run steps ``state["step"] .. num_steps - 1``; log every
        ``log_every`` steps and the last one (a ``[train]`` line and a row
        of ``metrics_log``); checkpoint every ``checkpoint_every`` steps and
        at the end. Returns the final state."""
        state = state if state is not None else self.init_or_restore()
        start = int(state["step"])
        for step in range(start, num_steps):
            batch = {k: v.to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            self._sync()
            t0 = self.obs.now()
            with self.obs.span("train/step", step=step):
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
                print(f"[train] step={step:5d} loss={row['loss']:.4f} "
                      f"ce={row['ce']:.4f} gnorm={row['grad_norm']:.3f} "
                      f"{dt * 1000:.0f}ms", flush=True)
            if (self.ckpt is not None and step > start
                    and step % self.checkpoint_every == 0):
                self.ckpt.save(step, state)
        if self.ckpt is not None:
            self.ckpt.save(num_steps, state)
        return state
