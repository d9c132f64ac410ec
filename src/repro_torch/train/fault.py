"""Fault tolerance and straggler detection (port of
``repro.train.fault``), host-side and CPU-testable:

* ``StragglerMonitor`` — a per-step wall-time EWMA; flags a step longer
  than ``threshold`` x the running mean (after ``warmup_steps``), records
  it and calls ``on_straggler``.
* ``run_with_restarts`` — run a step loop, checkpoint every k steps, and
  on an exception restore the latest checkpoint and go on (bounded
  retries).

``elastic_remesh`` (restore onto another mesh) waits for the port's meshes
(ROADMAP.md queue A item 7) and raises.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["StragglerMonitor", "run_with_restarts", "elastic_remesh"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ewma: float = 0.9,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.threshold = threshold
        self.ewma_coef = ewma
        self.warmup = warmup_steps
        self.mean: Optional[float] = None
        self.events: List[Dict[str, float]] = []
        self.on_straggler = on_straggler
        self._seen = 0

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step was flagged as a straggler."""
        self._seen += 1
        flagged = False
        if self.mean is not None and self._seen > self.warmup:
            if duration_s > self.threshold * self.mean:
                flagged = True
                self.events.append(
                    {"step": step, "duration": duration_s, "mean": self.mean})
                if self.on_straggler:
                    self.on_straggler(step, duration_s, self.mean)
        if self.mean is None:
            self.mean = duration_s
        else:
            self.mean = self.ewma_coef * self.mean + \
                (1 - self.ewma_coef) * duration_s
        return flagged


def run_with_restarts(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    num_steps: int,
    ckpt_manager,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    monitor: Optional[StragglerMonitor] = None,
    device="cuda",
) -> Any:
    """Crash-tolerant loop: checkpoint every ``checkpoint_every`` steps and
    at the end; on an exception restore the latest checkpoint onto
    ``device`` and resume (up to ``max_restarts`` times, then re-raise).

    ``step_fn(state, step) -> state`` may raise (a simulated node failure
    in the tests; a CUDA or runtime error in production).
    """
    state = init_state
    start = 0
    latest = ckpt_manager.latest_step()
    if latest is not None:
        state = ckpt_manager.restore(latest, device=device)
        start = latest
    restarts = 0
    step = start
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(state, step)
            if monitor is not None:
                monitor.record(step, time.perf_counter() - t0)
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                ckpt_manager.save(step, state)
        except Exception:  # noqa: BLE001 - restart semantics
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = ckpt_manager.latest_step()
            if latest is None:
                state = init_state
                step = 0
            else:
                state = ckpt_manager.restore(latest, device=device)
                step = latest
    return state


def elastic_remesh(ckpt_manager, make_mesh_fn, make_shardings_fn,
                   step: Optional[int] = None):
    """Not ported: restoring onto a new mesh needs the port's meshes.

    Raises:
        NotImplementedError: always, until meshes are ported.
    """
    raise NotImplementedError(
        "elastic_remesh restores onto a device mesh; the port has no mesh "
        "yet (ROADMAP.md queue A item 7, distributed and launch)")
