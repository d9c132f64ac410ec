"""Span tracing: JSONL events, Chrome-trace export, kernel-launch scopes
(port of ``repro.obs.trace``; the record format and the schema string are
the reference's, so ``tools/check_trace.py`` validates a port trace).

A :class:`Tracer` records two record kinds on the shared monotonic clock
(``repro_torch.obs.clock``), streamed to a ``.jsonl`` file when a path is
given and always kept in memory::

    {"type": "meta",  "schema": ..., "provenance": {...}, "wall_time": ...}
    {"type": "span",  "name": ..., "ts_us": ..., "dur_us": ..., "attrs": {}}
    {"type": "event", "name": ..., "ts_us": ...,               "attrs": {}}

The first line of every trace file is the ``meta`` record (schema version +
the port's platform provenance). :func:`chrome_trace` converts a record
list to the Chrome ``traceEvents`` format (Perfetto, ``chrome://tracing``).

Kernel launches are traced through the AMBIENT tracer: the fused wrapper
ops (``rm_feature``, ``tensor_sketch``, ``ctr_feature``,
``structured_feature``, ``rm_attention``, ``rm_attn_fused``) run under
:func:`kernel_scope`. With no tracer installed that costs one global
``is None`` check. With one installed, the launch runs inside
``torch.profiler.record_function("repro.<kernel>")`` (so a profiler
timeline carries the kernel name) and a ``kernel/<kernel>`` span records
the analytic FLOPs/HBM bytes of the launch shape
(``repro_torch.bench.roofline.launch_cost``).
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.obs import clock as _clock

__all__ = ["TRACE_SCHEMA", "Tracer", "install_tracer", "current_tracer",
           "kernel_scope", "chrome_trace", "read_trace", "write_chrome"]

TRACE_SCHEMA = "repro.obs.trace/v1"


class Tracer:
    """Append-only span/event recorder on the shared monotonic clock.

    Args:
        path: optional ``.jsonl`` destination — records stream to it as
            they are recorded (the meta header first), so a crashed run
            still leaves a readable trace.
        now: clock override (tests inject ``FakeClock``).
        provenance: platform stamp override for the meta record.
    """

    def __init__(self, path=None,
                 now: Callable[[], float] = _clock.monotonic,
                 provenance: Optional[Dict] = None):
        self._now = now
        self.records: List[Dict] = []
        self._fh = None
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = p.open("w")
        if provenance is None:
            from repro_torch.common.env import platform_provenance

            provenance = platform_provenance()
        self._emit({"type": "meta", "schema": TRACE_SCHEMA,
                    "wall_time": _clock.wall(), "provenance": provenance})

    # -- recording ----------------------------------------------------------
    def _emit(self, rec: Dict) -> None:
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def now_us(self) -> float:
        return self._now() * 1e6

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous event."""
        self._emit({"type": "event", "name": name, "ts_us": self.now_us(),
                    "attrs": attrs})

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Record a duration span around the ``with`` body (also when the
        body raises)."""
        t0 = self.now_us()
        try:
            yield self
        finally:
            t1 = self.now_us()
            self._emit({"type": "span", "name": name, "ts_us": t0,
                        "dur_us": t1 - t0, "attrs": attrs})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- convenience --------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict]:
        out = [r for r in self.records if r["type"] == "span"]
        return out if name is None else [r for r in out if r["name"] == name]

    def events(self, name: Optional[str] = None) -> List[Dict]:
        out = [r for r in self.records if r["type"] == "event"]
        return out if name is None else [r for r in out if r["name"] == name]


# ---------------------------------------------------------------------------
# ambient tracer for the kernel wrappers
# ---------------------------------------------------------------------------
_CURRENT: Optional[Tracer] = None
_NULL_CTX = contextlib.nullcontext()


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Set (or clear, with None) the process-ambient tracer.

    The kernel wrappers consult this instead of taking an ``obs`` argument,
    so their signatures stay as they are and the disabled path is one
    global ``is None`` check. Returns the previous tracer so callers can
    restore it (``Obs.close`` does).
    """
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    return prev


def current_tracer() -> Optional[Tracer]:
    return _CURRENT


def kernel_scope(kernel: str, x=None, cost: Optional[Dict] = None,
                 **attrs: Any):
    """Context manager naming one fused-kernel launch for the obs trace.

    With no ambient tracer this returns a shared null context after one
    global ``is None`` check: no ``record_function``, no cost arithmetic.
    With a tracer installed it enters
    ``torch.profiler.record_function(f"repro.{kernel}")`` and records a
    ``kernel/<kernel>`` span. ``x`` (a tensor operand) marks the span
    ``traced=True`` when its launch is being captured into a CUDA graph
    (``torch.cuda.is_current_stream_capturing()``, the port's counterpart
    of the reference's jit trace); ``cost`` (shape kwargs of
    ``repro_torch.bench.roofline.launch_cost``) adds the analytic ``flops``
    and ``hbm_bytes``.

    The span's duration is the HOST's time to enqueue the launch (and, on a
    CPU tensor, to run the plain version), not the device's time: CUDA
    launches are asynchronous. Device time per kernel belongs to the
    profiler, whose timeline carries the same ``repro.<kernel>`` name.
    """
    tracer = _CURRENT
    if tracer is None:
        return _NULL_CTX
    return _kernel_span(tracer, kernel, x, cost, attrs)


@contextlib.contextmanager
def _kernel_span(tracer: Tracer, kernel: str, x, cost, attrs):
    import torch

    traced = bool(x is not None and x.is_cuda
                  and torch.cuda.is_current_stream_capturing())
    if cost is not None:
        from repro_torch.bench.roofline import launch_cost

        attrs.update(launch_cost(kernel, **cost))
    with torch.profiler.record_function(f"repro.{kernel}"), \
            tracer.span(f"kernel/{kernel}", traced=traced, **attrs):
        yield


# ---------------------------------------------------------------------------
# file IO + Chrome-trace conversion
# ---------------------------------------------------------------------------
def read_trace(path) -> List[Dict]:
    """Load a ``.jsonl`` trace file into a record list."""
    records = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def chrome_trace(records: Iterable[Dict]) -> Dict:
    """Convert obs records to the Chrome ``traceEvents`` JSON format.

    Spans become complete ("ph": "X") slices and events instant ("ph": "i")
    marks, all on one pid/tid; ``attrs`` ride along as ``args`` so Perfetto
    shows the analytic FLOPs/HBM bytes on kernel slices. The meta record
    maps to process metadata.
    """
    out: List[Dict] = []
    for rec in records:
        if rec.get("type") == "meta":
            out.append({"name": "process_name", "ph": "M", "pid": 0,
                        "args": {"name": "repro.obs "
                                 + str(rec.get("provenance", {}))}})
        elif rec.get("type") == "span":
            out.append({"name": rec["name"], "ph": "X", "pid": 0, "tid": 0,
                        "ts": rec["ts_us"], "dur": rec.get("dur_us", 0.0),
                        "args": rec.get("attrs", {})})
        elif rec.get("type") == "event":
            out.append({"name": rec["name"], "ph": "i", "pid": 0, "tid": 0,
                        "ts": rec["ts_us"], "s": "g",
                        "args": rec.get("attrs", {})})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(records: Iterable[Dict], path) -> Path:
    """Write the Chrome-trace conversion of ``records`` to ``path``."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(records)) + "\n")
    return p
