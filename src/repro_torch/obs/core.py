"""The ``Obs`` facade: one object threading metrics, tracing and drift
monitoring through the hot paths, and a true no-op when disabled (port of
``repro.obs.core``).

Every instrumented layer (the ``Scheduler``, the ``Trainer``, the launch
CLIs) takes ``obs=None`` and resolves it through :func:`resolve`: ``None``
maps to the shared :data:`NOOP` whose every method is a ``pass`` (its
``span`` returns a pre-built null context), so the disabled path costs one
attribute call per site, and decoded tokens stay bit-identical because
observability never touches a tensor.

An enabled ``Obs`` owns a :class:`~repro_torch.obs.metrics.MetricsRegistry`
and a :class:`~repro_torch.obs.trace.Tracer` on ONE clock (injectable),
optionally installs its tracer as the process-ambient kernel tracer (so
the fused wrapper ops contribute ``kernel/*`` spans), and optionally
drives a :class:`~repro_torch.obs.drift.DriftMonitor` every
``drift_every`` ticks of the serving or training loop.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

from repro_torch.obs import clock as _clock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, install_tracer

__all__ = ["Obs", "NoopObs", "NOOP", "resolve"]

_NULL_CTX = contextlib.nullcontext()


class NoopObs:
    """Disabled observability: every hook is a no-op, ``now`` still ticks
    (a real monotonic read, so timestamp fields keep their meaning)."""

    enabled = False
    drift = None

    def now(self) -> float:
        return _clock.monotonic()

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def span(self, name: str, **attrs: Any):
        return _NULL_CTX

    def counter(self, name: str, amount: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def histogram(self, name: str, value: float) -> None:
        pass

    def tick_drift(self, rows=None) -> None:
        pass

    def close(self) -> None:
        pass


NOOP = NoopObs()


def resolve(obs: Optional["Obs"]) -> "Obs":
    """``None`` -> the shared no-op; anything else passes through."""
    return NOOP if obs is None else obs


class Obs:
    """Enabled observability: metrics + tracer + optional drift monitor.

    Args:
        trace_path: stream the JSONL trace here (None = in-memory only).
        clock: monotonic-clock override shared by metrics, tracer and the
            scheduler's timestamps (tests inject ``FakeClock``).
        provenance: platform-stamp override for trace/metrics headers.
        drift: a ``DriftMonitor`` to drive from the serving/training loop.
        drift_every: run ``drift.check()`` every N ``tick_drift`` calls
            (0 disables ticking even with a monitor attached).
        install_kernel_tracing: make this tracer the process-ambient
            kernel tracer until ``close()`` (the fused wrapper ops then
            record ``kernel/*`` spans with analytic FLOPs/HBM bytes).
    """

    enabled = True

    def __init__(self, trace_path=None,
                 clock: Optional[Callable[[], float]] = None,
                 provenance: Optional[Dict] = None,
                 drift=None, drift_every: int = 0,
                 install_kernel_tracing: bool = False):
        self._now = clock if clock is not None else _clock.monotonic
        self.metrics = MetricsRegistry(now=self._now)
        self.tracer = Tracer(path=trace_path, now=self._now,
                             provenance=provenance)
        self.drift = drift
        self.drift_every = int(drift_every)
        self._drift_tick = 0
        self._prev_tracer = None
        self._installed = False
        if install_kernel_tracing:
            self._prev_tracer = install_tracer(self.tracer)
            self._installed = True

    # -- clock / trace / metrics passthroughs --------------------------------
    def now(self) -> float:
        return self._now()

    def event(self, name: str, **attrs: Any) -> None:
        self.tracer.event(name, **attrs)

    def span(self, name: str, **attrs: Any):
        return self.tracer.span(name, **attrs)

    def counter(self, name: str, amount: float = 1.0) -> None:
        self.metrics.counter(name).inc(amount)

    def gauge(self, name: str, value: float) -> None:
        self.metrics.gauge(name).set(value)

    def histogram(self, name: str, value: float) -> None:
        self.metrics.histogram(name).observe(value)

    # -- drift ----------------------------------------------------------------
    def tick_drift(self, rows=None) -> None:
        """One serving/training loop tick: maybe run the drift check.

        ``rows`` (optional host array) feeds the monitor's sentinel
        reservoir before checking. Emits the ``drift/sup_err`` and
        ``drift/eps_bound`` gauges, the ``drift/checks`` and
        ``drift/violations`` counters, a ``drift/check`` span, and on a
        violation the ``drift/violation`` event and (with the doubled
        budget) ``drift/grow_recommendation``.
        """
        if self.drift is None or self.drift_every <= 0:
            return
        self._drift_tick += 1
        if self._drift_tick % self.drift_every:
            return
        if rows is not None:
            self.drift.ingest(rows)
        with self.span("drift/check"):
            report = self.drift.check()
        self.gauge("drift/sup_err", report.sup_err)
        self.gauge("drift/eps_bound", report.eps_bound)
        self.counter("drift/checks")
        if not report.ok:
            self.counter("drift/violations")
            self.event("drift/violation", sup_err=report.sup_err,
                       eps_bound=report.eps_bound,
                       num_features=report.num_features)
            rec = self.drift.recommend()
            if rec is not None:
                self.gauge("drift/recommended_features",
                           rec.num_features_target)
                self.event("drift/grow_recommendation",
                           num_features_now=rec.num_features_now,
                           num_features_target=rec.num_features_target,
                           eps_bound_target=rec.eps_bound_target,
                           reason=rec.reason)

    # -- lifecycle ------------------------------------------------------------
    def write_metrics(self, path) -> None:
        self.metrics.write_json(path)

    def close(self) -> None:
        """Flush the trace file and restore the ambient kernel tracer."""
        if self._installed:
            install_tracer(self._prev_tracer)
            self._installed = False
        self.tracer.close()
