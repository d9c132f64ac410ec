"""Roofline terms of one step from counted work (port of
``repro.analysis.roofline``).

The reference derives its three terms from a compiled XLA program
(``cost_analysis``, ``memory_analysis`` and the HLO text's collectives).
PyTorch has no such lowering: the port's dry run (``launch.dryrun``) runs
one rank's step on ``meta`` tensors and counts the work itself, and
:func:`roofline_from_counts` turns the counts into the same record keys:

    compute    = FLOPs per device / peak FLOP/s per card
    memory     = bytes per device / HBM bytes/s per card
    collective = collective result bytes per device / link bytes/s

The hardware row is the port's card, :data:`HW_H100` (an H100 SXM: 989
TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, NVLink 450 GB/s
each way). ``collective_bytes_from_hlo`` and ``memory_analysis_dict`` parse
XLA output and have no PyTorch counterpart (ROADMAP.md): the collectives
are counted by ``distributed.collectives`` and the memory by the dry run.

:func:`count_params`, :func:`model_flops` and
:func:`analytic_inner_loop_flops` are the reference's arithmetic. The
last is the reference's correction for loop bodies XLA counts once; the
port's dry run runs every trip eagerly and counts it, so it applies no
correction, but the function stays for comparison with the reference's
records.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

__all__ = [
    "HardwareSpec",
    "HW_H100",
    "COLLECTIVES",
    "roofline_from_counts",
    "analytic_inner_loop_flops",
    "count_params",
    "model_flops",
]

# the reference's collective kinds, in its order; the port makes no
# reduce-scatter of its own (an all-reduce and a slice), no all-to-all and
# no collective-permute, so those stay at 0
COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """One card's peak rates and memory."""

    name: str
    peak_flops: float             # dense bf16 on the tensor cores, FLOP/s
    hbm_bw: float                 # bytes/s
    link_bw: float                # bytes/s, one direction
    hbm_bytes: float              # device memory


# NVIDIA H100 SXM (PERF.md §3's device row; NVLink 4: 18 links x 25 GB/s
# each way)
HW_H100 = HardwareSpec("h100_sxm", 989e12, 3.35e12, 450e9, 80e9)


def roofline_from_counts(flops: float, nbytes: float,
                         collectives: Dict[str, Dict[str, float]],
                         num_devices: int, hw: HardwareSpec = HW_H100,
                         memory: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """The three roofline terms and the raw counters of one step, with
    the keys of the reference's ``roofline_from_compiled``.

    ``flops`` and ``nbytes``: one device's counted FLOPs and bytes
    accessed (the dry run's reading of the bytes: ``launch.dryrun``);
    ``collectives``: ``{kind: {"bytes", "count"}}`` over
    :data:`COLLECTIVES` (one device's result bytes); ``memory``: the dry
    run's ``memory_analysis`` dict."""
    coll_bytes = float(sum(v["bytes"] for v in collectives.values()))
    terms = {"compute_s": flops / hw.peak_flops,
             "memory_s": nbytes / hw.hbm_bw,
             "collective_s": coll_bytes / hw.link_bw}
    dominant = max(terms, key=terms.get)
    return {
        "hw": hw.name,
        "num_devices": num_devices,
        "per_device_flops": float(flops),
        "per_device_bytes": float(nbytes),
        "per_device_collective_bytes": coll_bytes,
        "collectives": collectives,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "memory_analysis": dict(memory or {}),
    }


# ---------------------------------------------------------------------------
# inner-loop flop corrections (the reference's arithmetic)
# ---------------------------------------------------------------------------
_ATTN_BLOCK = 1024  # the reference's attention._BLOCK_Q / _BLOCK_K


def analytic_inner_loop_flops(cfg, seq_len: int, global_batch: int,
                              kind: str) -> float:
    """GLOBAL flops of the loop-body trips XLA counts once (forward and
    backward), as the reference adds them to its HLO count. The port's dry
    run counts every trip, so its records carry 0 in their place."""
    if kind == "decode":
        return 0.0
    t, b = seq_len, global_batch
    # train: fwd(1) + remat fwd(1) + bwd(2) instances of each loop
    factor = 4.0 if kind == "train" else 1.0
    missing = 0.0
    pattern = list(cfg.block_pattern) * cfg.num_scanned_groups
    pattern = [cfg.block_pattern[0]] * cfg.first_k_dense + pattern

    for kind_b in pattern:
        mixer = kind_b.split("_")[0]
        if mixer in ("attn", "mla") and cfg.attention_mode == "exact" \
                and t > 2048:
            h = cfg.num_heads
            dh = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
                  if mixer == "mla" else cfg.resolved_head_dim)
            dv = cfg.mla.v_head_dim if mixer == "mla" else \
                cfg.resolved_head_dim
            bq = bk = min(_ATTN_BLOCK, t)
            nq, nk = -(-t // bq), -(-t // bk)
            trips = nq * nk
            body = 2.0 * b * h * bq * bk * (dh + dv)
            missing += (trips - 1) * body * factor
        elif mixer == "mamba":
            mc = cfg.mamba
            d_in = mc.expand * cfg.d_model
            c = min(mc.scan_chunk, t)
            trips = -(-t // c)
            logc = max(1.0, math.log2(c))
            body = b * c * d_in * mc.d_state * (4.0 * logc + 8.0)
            missing += (trips - 1) * body * factor
        elif mixer == "mlstm":
            h = cfg.num_heads
            d_up = int(cfg.xlstm.proj_factor * cfg.d_model)
            dh = d_up // h
            c = min(cfg.xlstm.chunk, t)
            trips = -(-t // c)
            body = b * h * (4.0 * c * c * dh + 8.0 * c * dh * dh)
            missing += (trips - 1) * body * factor
        elif mixer == "slstm":
            h = cfg.num_heads
            dh = cfg.d_model // h
            body = b * h * (8.0 * dh * dh + 40.0 * dh)
            missing += (t - 1) * body * factor
    return missing


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the useful-work reference)
# ---------------------------------------------------------------------------
def count_params(tree, active_moe_fraction: Optional[float] = None):
    """``(total, active)`` parameter counts of a tree of tensors (``meta``
    ones do: only shapes are read), dicts and lists.

    ``active``: the MoE expert weights (leaves under a ``"moe"`` path named
    ``w_gate`` / ``w_up`` / ``w_down``) scaled by ``top_k / num_experts``.
    """
    total = 0
    active = 0

    def walk(path, node):
        nonlocal total, active
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        if isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (i,), v)
            return
        n = math.prod(node.shape)
        total += n
        frac = 1.0
        if active_moe_fraction is not None and "moe" in path and \
                path[-1] in ("w_gate", "w_up", "w_down"):
            frac = active_moe_fraction
        active += int(n * frac)

    walk((), tree)
    return total, active


def model_flops(kind: str, n_active_params: int, tokens: int) -> float:
    """6*N*D for training, 2*N*D for inference forward passes."""
    if kind == "train":
        return 6.0 * n_active_params * tokens
    return 2.0 * n_active_params * tokens
