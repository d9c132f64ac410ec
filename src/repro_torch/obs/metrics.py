"""Counters, gauges and histograms with JSON snapshots (port of
``repro.obs.metrics``).

* **host-side only** — metrics record Python floats the moment a value is
  already on the host (a sampled token, a synchronized step time). Nothing
  here touches a tensor, so recording adds no device synchronization.
* **shared clock** — histograms remember the monotonic time of their first
  and last observation (``repro_torch.obs.clock``).
* **cheap percentiles** — histograms keep raw observations up to a bounded
  reservoir (4096; beyond that, uniform replacement sampling), so
  p50/p90/p99 are exact for every realistic serving run and a
  bounded-memory estimate under abuse.

``MetricsRegistry.snapshot()`` returns a plain JSON-able dict stamped with
the port's platform provenance (``repro_torch.common.env``), so a metrics
file always says which backend produced it.
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.obs import clock as _clock

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "percentile"]

_RESERVOIR = 4096


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (q in [0, 100])."""
    if not sorted_vals:
        return 0.0
    idx = int(round(q / 100.0 * (len(sorted_vals) - 1)))
    return float(sorted_vals[min(max(idx, 0), len(sorted_vals) - 1)])


class Counter:
    """Monotone event count (``inc``)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value (queue depth, slot occupancy)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Distribution of observations with p50/p90/p99 summaries.

    Keeps raw values up to ``_RESERVOIR``, then samples uniformly with
    replacement (a ``random.Random(0)`` stream, as in the reference);
    count/sum/min/max stay exact either way.
    """

    def __init__(self, name: str, now: Callable[[], float] = _clock.monotonic):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._vals: List[float] = []
        self._now = now
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self._rng = random.Random(0)

    def observe(self, value: float) -> None:
        value = float(value)
        t = self._now()
        if self.t_first is None:
            self.t_first = t
        self.t_last = t
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if len(self._vals) < _RESERVOIR:
            self._vals.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < _RESERVOIR:
                self._vals[j] = value

    def summary(self) -> Dict[str, float]:
        vals = sorted(self._vals)
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": percentile(vals, 50.0),
            "p90": percentile(vals, 90.0),
            "p99": percentile(vals, 99.0),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms plus the JSON snapshot.

    Instruments are created on first use (``counter("a/b").inc()``); names
    are slash-paths by convention (``serve/ttft_s``, ``drift/sup_err``).
    """

    def __init__(self, now: Callable[[], float] = _clock.monotonic):
        self._now = now
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(name)
        return self.gauges[name]

    def histogram(self, name: str) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(name, now=self._now)
        return self.histograms[name]

    def snapshot(self, provenance: Optional[Dict] = None) -> Dict:
        """JSON-able state of every instrument, provenance-stamped.

        ``provenance`` defaults to
        ``repro_torch.common.env.platform_provenance()``; pass an explicit
        dict in tests to keep snapshots platform-independent.
        """
        if provenance is None:
            from repro_torch.common.env import platform_provenance

            provenance = platform_provenance()
        return {
            "schema": "repro.obs.metrics/v1",
            "wall_time": _clock.wall(),
            "provenance": provenance,
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }

    def write_json(self, path, provenance: Optional[Dict] = None) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.snapshot(provenance), indent=2,
                                sort_keys=True) + "\n")
        return p
