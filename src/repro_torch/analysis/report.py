"""The dry run's tables from its records (port of
``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report

Reads ``results_torch/dryrun/<mesh>/*.json`` (``launch.dryrun``) and
prints the reference's two tables, ``dryrun_table`` and
``roofline_table``, and a third of the cells that failed, with their
reasons. The reference's columns whose meaning has no counterpart here
are renamed, not filled (:data:`RENAMED`): the meta run's seconds stand
where the reference has its compile time, the counted FLOPs where it has
XLA's HLO FLOPs, the card's 80 GB where it has the TPU's HBM, the bytes
of the counted products' operands and results (``launch.dryrun``'s
``bytes_counted_by``) where it has XLA's bytes after fusion, and the
bottleneck notes name the card's tensor cores.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["RESULTS", "RENAMED", "load", "load_failures", "dryrun_table",
           "roofline_table", "failures_table", "main"]

RESULTS = Path(__file__).resolve().parents[3] / "results_torch" / "dryrun"

# the reference's column or note text -> the port's
RENAMED = {
    "| compile |": "| meta run |",
    "| fits HBM |": "| fits 80 GB |",
    "| temp/dev (scanned) |": "| temp/dev |",
    "| HLO_FLOPS (corr) |": "| counted FLOPS |",
    "| memory_s |": "| memory_s (product bytes) |",
    "push MXU utilization": "push tensor-core utilization",
}


def _fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 1e9:.2f}GB"


def load(mesh: str):
    """The records of ``mesh``, failures left out, by file name."""
    base = RESULTS / mesh
    if not base.exists():
        return []
    return [json.loads(p.read_text()) for p in sorted(base.glob("*.json"))
            if not p.name.endswith(".FAILED.json")]


def load_failures(mesh: str):
    """The ``FAILED`` records of ``mesh``, by file name."""
    base = RESULTS / mesh
    if not base.exists():
        return []
    return [json.loads(p.read_text())
            for p in sorted(base.glob("*.FAILED.json"))]


def dryrun_table(mesh: str = "single") -> str:
    rows = [
        "| arch | shape | mode | meta run | fits 80 GB | args/dev | "
        "temp/dev | collectives (per-dev bytes: AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh):
        if r.get("skipped"):
            rows.append(
                f"| {r['arch']} | {r['shape']} | - | SKIP | - | - | - | "
                f"{r['skip_reason']} |")
            continue
        ma = r.get("memory_analysis") or {}
        c = r["collectives"]
        coll = "/".join(
            _fmt_bytes(c[k]["bytes"]) for k in
            ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
        )
        accum = r.get("grad_accum")
        mode = r["attention_mode"] + (f",ga{accum}" if accum and accum > 1
                                      else "")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mode} | "
            f"{r['meta_s']:.0f}s | {r.get('fits_hbm')} | "
            f"{_fmt_bytes(ma.get('argument_size_in_bytes'))} | "
            f"{_fmt_bytes(ma.get('temp_size_in_bytes'))} | {coll} |"
        )
    return "\n".join(rows)


def roofline_table(mesh: str = "single") -> str:
    rows = [
        "| arch | shape | compute_s | memory_s (product bytes) | "
        "collective_s | dominant | "
        "MODEL_FLOPS | counted FLOPS | useful ratio | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh):
        if r.get("skipped"):
            continue
        comp = r.get("compute_s_corrected", r.get("compute_s"))
        terms = {"compute": comp, "memory": r["memory_s"],
                 "collective": r["collective_s"]}
        dom = max(terms, key=terms.get)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {comp:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | {dom} | "
            f"{r['model_flops']:.3g} | {r['hlo_flops_corrected']:.3g} | "
            f"{r['useful_flops_ratio']:.3f} | {_bottleneck_note(r, dom)} |"
        )
    return "\n".join(rows)


def failures_table(mesh: str = "single") -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for r in load_failures(mesh):
        rows.append(f"| {r['arch']} | {r['shape']} | {r['error']} |")
    return "\n".join(rows)


def _bottleneck_note(r, dom) -> str:
    kind = r["kind"]
    if dom == "collective":
        big = max(r["collectives"], key=lambda k: r["collectives"][k]["bytes"])
        return f"{big} dominates — reshard/overlap it"
    if dom == "memory":
        if kind == "decode":
            return "cache/weight streaming bound (expected for decode)"
        return "bytes-accessed bound; fuse casts / shrink materialized acts"
    return "compute-bound — good; push tensor-core utilization"


def main():
    print("## Dry run (single-pod 16x16)\n")
    print(dryrun_table("single"))
    print("\n## Dry run (multi-pod 2x16x16)\n")
    print(dryrun_table("multi"))
    print("\n## Roofline (single-pod, per-device terms, NVIDIA H100)\n")
    print(roofline_table("single"))
    for mesh in ("single", "multi"):
        print(f"\n## Failed cells ({mesh})\n")
        print(failures_table(mesh))


if __name__ == "__main__":
    main()
