"""The shared monotonic clock behind every timing number of the port
(port of ``repro.obs.clock``).

Anything that measures a duration — span durations, the Scheduler's TTFT
and per-token clocks, the Trainer's step time — reads THIS module's
``monotonic()``. ``wall()`` is for provenance stamps only (absolute
timestamps in artifacts), never for durations.

Tests inject a :class:`FakeClock` (deterministic, advances by a fixed step
per read) through ``Obs(clock=...)``; histograms, span durations and the
serving lifecycle timestamps then become exactly reproducible.
"""
from __future__ import annotations

import time

__all__ = ["monotonic", "wall", "FakeClock"]


def monotonic() -> float:
    """Seconds on the process-wide monotonic clock (``perf_counter``)."""
    return time.perf_counter()


def wall() -> float:
    """Absolute wall-clock seconds since the epoch (provenance stamps)."""
    return time.time()


class FakeClock:
    """Deterministic clock for tests: each read advances by ``step``.

    Callable with the same signature as :func:`monotonic`, so it drops into
    ``Obs(clock=...)`` unchanged. ``advance()`` adds extra time between
    reads when a test wants unequal intervals.
    """

    def __init__(self, start: float = 0.0, step: float = 1.0):
        self.t = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        t = self.t
        self.t += self.step
        return t

    def advance(self, dt: float) -> None:
        self.t += float(dt)
