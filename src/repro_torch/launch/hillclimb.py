"""Hill-climbing on the dry run: one cell measured under a named change,
its hypothesis beside the record (port of ``repro.launch.hillclimb``).

Each experiment but ``baseline`` is the reference's (its names and
hypotheses, ``src/repro/launch/hillclimb.py:56-139``): an override of the
sharding rules, the model config or the train hyper-parameters applied to
one (arch, shape) cell, measured by ``launch.dryrun.measure`` on the 16 x 16
mesh and written to ``results_torch/perf/<arch>__<shape>__<exp>.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --cell qwen2-7b:prefill_32k --exp rm_mode no_fsdp

Every lever is a sharding rule the model code reads
(``distributed.tensor_parallel``): ``no_fsdp`` / ``rm_no_fsdp`` switch off
the weights' cut over ``"data"`` in training and in serving, ``no_sp`` /
``rm_no_sp`` the sequence sharding, ``sp_data`` cuts the residual
stream's sequence over ``"data"`` where the rows are not split over it
(batch 1), ``vocab_unsharded`` keeps the vocabulary whole on every model
rank, and ``kv_seq_shard`` cuts the exact and MLA decode caches by
sequence over ``"model"`` with every kv head on every rank, its decode a
split-K over the ranks' slots; ``no_remat`` switches off the activation
checkpointing of ``ModelConfig.remat``. A rules override the port cannot
express raises ``NotImplementedError`` (``launch.dryrun.
UNSUPPORTED_RULES``) and records nothing. ``baseline`` is the cell with
no override (the default rules, config and hyper every experiment starts
from; ``rm_mode`` is the rm-mode baseline), so a lever's record has its
before beside it:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --cell qwen2-7b:decode_32k --exp baseline kv_seq_shard

``rm_chunk256`` sets ``cfg.rm.chunk`` to 256: the plain versions the dry
run counts honor it, but the card's fused kernel B2 always takes 64-position
chunks (``kernels/rm_attention/ops.py``), so its record says the count is
the plain formulation's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

from repro_torch.launch.dryrun import MESHES, dry_world, measure
from repro_torch.launch.shapes import SHAPES
from repro_torch.train.steps import TrainHyper

__all__ = ["PERF_DIR", "EXPERIMENTS", "run_experiment", "main"]

PERF_DIR = Path(__file__).resolve().parents[3] / "results_torch" / "perf"


def _rm_features(n):
    def f(cfg):
        return dataclasses.replace(
            cfg, rm=dataclasses.replace(cfg.rm, num_features=n))
    return f


def _rm_chunk(c):
    def f(cfg):
        return dataclasses.replace(
            cfg, rm=dataclasses.replace(cfg.rm, chunk=c))
    return f


def _moe_dispatch(kind):
    def f(cfg):
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=kind))
    return f


EXPERIMENTS = {
    "baseline": dict(
        hypothesis="the cell with no override: what every experiment is "
                   "measured against",
    ),
    # paper-technique cell: exact -> rm and RM plan tuning
    "rm_mode": dict(
        hypothesis="RM linear attention removes the O(T^2) term; prefill "
                   "compute and score-matmul memory drop, collectives "
                   "unchanged",
        attention_mode="rm",
    ),
    "rm_mode_D512": dict(
        hypothesis="doubling RM features doubles feature-matmul flops but "
                   "stays far below exact attention at 32k",
        attention_mode="rm", cfg_override=_rm_features(512),
    ),
    "rm_mode_D128": dict(
        hypothesis="halving RM features halves the linear-attention state "
                   "cost; approximation error grows ~sqrt(2)x (bench)",
        attention_mode="rm", cfg_override=_rm_features(128),
    ),
    "rm_chunk256": dict(
        hypothesis="larger rm chunks amortize state I/O; intra-chunk "
                   "[C,C] grows 2x but stays MXU-bound",
        attention_mode="rm", cfg_override=_rm_chunk(256),
        note="counted on the plain versions, which take cfg.rm.chunk; the "
             "card's fused kernel B2 takes 64-position chunks whatever the "
             "config says",
    ),
    # sharding levers
    "no_sp": dict(
        hypothesis="dropping Megatron-SP on residuals removes per-layer "
                   "all-gathers but grows saved activations 16x",
        rules_override={"act_seq": None},
    ),
    "sp_data": dict(
        hypothesis="sharding long-context activations over data axis "
                   "(batch=1 long_500k) rebalances memory",
        rules_override={"act_seq": ("data",)},
    ),
    "kv_seq_shard": dict(
        hypothesis="FlashDecoding-style split-K: shard the KV cache's "
                   "sequence dim over 'model' — XLA gathers [B,H,S] scores "
                   "(small) instead of [B,S,H,dh] values (the 75GB/step "
                   "all-gather measured in the decode baseline)",
        rules_override={"kv_seq": "model", "kv_heads": None},
    ),
    "vocab_unsharded": dict(
        hypothesis="replicating the embedding removes the logits "
                   "all-reduce at the cost of vocab memory",
        rules_override={"vocab": None},
    ),
    "no_fsdp": dict(
        hypothesis="inference has no optimizer state: shard weights over "
                   "'model' only (pure TP) — the per-layer FSDP weight "
                   "all-gathers disappear and weights still fit "
                   "(7B bf16 / 16 = 0.9GB/device)",
        rules_override={"fsdp": None},
    ),
    "rm_no_fsdp": dict(
        hypothesis="combine the paper's linear attention with pure-TP "
                   "inference sharding: both the quadratic compute term "
                   "and the weight-gather collective term drop",
        attention_mode="rm", rules_override={"fsdp": None},
    ),
    "rm_no_sp": dict(
        hypothesis="combine winners: RM linear attention (compute term) + "
                   "dropping SP's per-layer activation gathers (collective "
                   "term) — inference prefill has no remat-memory pressure "
                   "so SP's memory saving is not needed",
        attention_mode="rm", rules_override={"act_seq": None},
    ),
    # MoE levers
    "moe_einsum": dict(
        hypothesis="GShard einsum dispatch pays O(G*E*C*d) dispatch flops "
                   "(the classic formulation; expect flops blow-up)",
        cfg_override=_moe_dispatch("einsum"),
    ),
    # train levers
    "accum4": dict(
        hypothesis="4 microbatches: peak activations /4, collective bytes "
                   "~const (per-microbatch reduce)",
        hyper=TrainHyper(grad_accum=4),
    ),
    "no_remat": dict(
        hypothesis="dropping remat removes the recompute fwd (-25% flops) "
                   "but multiplies saved activations",
        cfg_override=lambda cfg: dataclasses.replace(cfg, remat=False),
    ),
}


def run_experiment(arch: str, shape: str, exp_name: str, mesh=None,
                   out_dir: Path = PERF_DIR):
    """One experiment on one cell -> its record (also written to
    ``out_dir``). ``mesh``: a ``DeviceMesh`` over a dry world (default: the
    16 x 16 mesh in a dry world of its own).

    Raises:
        NotImplementedError: a rules override the port cannot express
            (``launch.dryrun.UNSUPPORTED_RULES``).
    """
    from repro_torch.configs import get_config

    exp = EXPERIMENTS[exp_name]
    if mesh is None:
        from repro_torch.launch.dryrun import _mesh

        with dry_world(math.prod(MESHES["single"][0])):
            return run_experiment(arch, shape, exp_name, _mesh("single"),
                                  out_dir)
    cfg = get_config(arch, attention_mode=exp.get("attention_mode",
                                                  "exact"))
    if exp.get("cfg_override") is not None:
        cfg = exp["cfg_override"](cfg).validate()
    rec = measure(cfg, SHAPES[shape], mesh, "single",
                  rules=exp.get("rules_override"), hyper=exp.get("hyper"),
                  arch=arch)
    rec["experiment"] = exp_name
    rec["hypothesis"] = exp["hypothesis"]
    if "note" in exp:
        rec["note"] = exp["note"]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{shape}__{exp_name}.json").write_text(
        json.dumps(rec, indent=2))
    print(f"[perf] {arch} {shape} {exp_name}: "
          f"comp={rec['compute_s_corrected']:.4f}s "
          f"mem={rec['memory_s']:.4f}s coll={rec['collective_s']:.4f}s "
          f"ratio={rec['useful_flops_ratio']:.3f} "
          f"meta={rec['meta_s']:.1f}s", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--exp", nargs="+", required=True,
                    choices=list(EXPERIMENTS))
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    from repro_torch.launch.dryrun import _mesh

    with dry_world(math.prod(MESHES["single"][0])):
        mesh = _mesh("single")
        for e in args.exp:
            run_experiment(arch, shape, e, mesh)


if __name__ == "__main__":
    main()
