"""Trace-file CLI: ``python -m repro_torch.obs <cmd> trace.jsonl`` (port of
``repro.obs.__main__``).

Commands:

* ``summarize FILE`` — provenance header plus one row per span/event name
  (count, total and p50/p90/p99 durations for spans).
* ``diff A B`` — per-name count and p50-duration deltas between two trace
  files (e.g. a before/after pair of serve runs).
* ``chrome FILE [-o OUT]`` — convert to the Chrome ``traceEvents`` format
  (default ``FILE`` with a ``.chrome.json`` suffix) for Perfetto /
  ``chrome://tracing``.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

from repro_torch.obs.metrics import percentile
from repro_torch.obs.trace import read_trace, write_chrome


def _span_stats(records: List[Dict]) -> Dict[str, Dict]:
    stats: Dict[str, Dict] = {}
    by_name: Dict[str, List[float]] = defaultdict(list)
    counts: Dict[str, int] = defaultdict(int)
    kinds: Dict[str, str] = {}
    for rec in records:
        if rec.get("type") == "span":
            by_name[rec["name"]].append(float(rec.get("dur_us", 0.0)))
            kinds[rec["name"]] = "span"
        elif rec.get("type") == "event":
            counts[rec["name"]] += 1
            kinds.setdefault(rec["name"], "event")
    for name, durs in by_name.items():
        srt = sorted(durs)
        stats[name] = {
            "kind": "span", "count": len(durs), "total_us": sum(durs),
            "p50_us": percentile(srt, 50.0), "p90_us": percentile(srt, 90.0),
            "p99_us": percentile(srt, 99.0),
        }
    for name, c in counts.items():
        if name not in stats:
            stats[name] = {"kind": "event", "count": c, "total_us": 0.0,
                           "p50_us": 0.0, "p90_us": 0.0, "p99_us": 0.0}
    return stats


def _meta(records: List[Dict]) -> Dict:
    for rec in records:
        if rec.get("type") == "meta":
            return rec
    return {}


def cmd_summarize(path: str) -> int:
    records = read_trace(path)
    meta = _meta(records)
    print(f"trace: {path}  schema={meta.get('schema', '?')}  "
          f"provenance={meta.get('provenance', {})}")
    stats = _span_stats(records)
    if not stats:
        print("  (no spans or events)")
        return 0
    print(f"  {'name':40s} {'kind':5s} {'count':>7s} {'total_us':>12s} "
          f"{'p50_us':>10s} {'p99_us':>10s}")
    for name in sorted(stats):
        s = stats[name]
        print(f"  {name:40s} {s['kind']:5s} {s['count']:7d} "
              f"{s['total_us']:12.1f} {s['p50_us']:10.1f} "
              f"{s['p99_us']:10.1f}")
    return 0


def cmd_diff(a: str, b: str) -> int:
    sa, sb = _span_stats(read_trace(a)), _span_stats(read_trace(b))
    names = sorted(set(sa) | set(sb))
    print(f"diff {a} -> {b}")
    print(f"  {'name':40s} {'count':>13s} {'p50_us':>21s}")
    for name in names:
        ca = sa.get(name, {}).get("count", 0)
        cb = sb.get(name, {}).get("count", 0)
        pa = sa.get(name, {}).get("p50_us", 0.0)
        pb = sb.get(name, {}).get("p50_us", 0.0)
        print(f"  {name:40s} {ca:5d} -> {cb:5d} {pa:9.1f} -> {pb:9.1f}")
    return 0


def cmd_chrome(path: str, out: str | None) -> int:
    dest = Path(out) if out else Path(path).with_suffix(".chrome.json")
    write_chrome(read_trace(path), dest)
    print(f"wrote {dest}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description="trace-file summarize/diff/"
                                             "chrome-export")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="per-name span/event stats")
    p.add_argument("file")
    p = sub.add_parser("diff", help="count/p50 deltas between two traces")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("chrome", help="convert to Chrome traceEvents JSON")
    p.add_argument("file")
    p.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        return cmd_summarize(args.file)
    if args.cmd == "diff":
        return cmd_diff(args.a, args.b)
    return cmd_chrome(args.file, args.out)


if __name__ == "__main__":
    sys.exit(main())
