"""``repro_torch.obs`` — tracing, metrics and online (eps, delta) accuracy
monitoring (port of ``repro.obs``, with its public names).

* :class:`Obs` / :data:`NOOP` / :func:`resolve` — the facade every
  instrumented layer threads (``Scheduler(obs=...)``,
  ``Trainer(obs=...)``); ``None`` resolves to a no-op.
* :mod:`repro_torch.obs.clock` — the one monotonic clock behind span
  durations and serving latencies (tests inject ``FakeClock``).
* :class:`MetricsRegistry` (counters/gauges/histograms, p50/p90/p99
  summaries, provenance-stamped JSON snapshots).
* :class:`Tracer` + :func:`chrome_trace` (JSONL spans/events, Perfetto
  export) and :func:`kernel_scope` (``record_function`` + analytic launch
  costs around the fused kernel wrappers' launches).
* :class:`DriftMonitor` — the paper's concentration bound as a live SLO.

CLI: ``python -m repro_torch.obs {summarize,diff,chrome} trace.jsonl``.
"""
from repro_torch.obs import clock
from repro_torch.obs.core import NOOP, NoopObs, Obs, resolve
from repro_torch.obs.drift import (
    DriftMonitor,
    DriftReport,
    GrowthRecommendation,
    hoeffding_eps,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    TRACE_SCHEMA,
    Tracer,
    chrome_trace,
    current_tracer,
    install_tracer,
    kernel_scope,
    read_trace,
    write_chrome,
)

__all__ = [
    "Obs", "NoopObs", "NOOP", "resolve", "clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "TRACE_SCHEMA", "chrome_trace", "read_trace", "write_chrome",
    "install_tracer", "current_tracer", "kernel_scope",
    "DriftMonitor", "DriftReport", "GrowthRecommendation", "hoeffding_eps",
]
