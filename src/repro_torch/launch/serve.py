"""Serving launcher: requests through the continuous-batching Scheduler
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --attention-mode rm

runs the full-width model on the CUDA device with random weights from
``--seed``; ``--smoke`` takes the reduced config, ``--device cpu`` the plain
PyTorch path, ``--attention-mode exact`` softmax attention with a KV
cache, ``--estimator tensor_sketch``, ``ctr`` or ``structured`` another
feature family (each takes the two-launch attention path). It prints TTFT
p50/p99 and aggregate tokens/s.

Observability: ``--trace-out trace.jsonl`` streams the request lifecycle
and the ``kernel/*`` spans (summarize or convert with ``python -m
repro_torch.obs``, validate with ``tools/check_trace.py``),
``--metrics-out metrics.json`` snapshots the TTFT / token-latency /
tokens-per-second histograms, and ``--drift-every N`` runs the online
(eps, delta) Gram-drift check every N decode iterations.

Adaptive accuracy (``launch/budget.py``): ``--eps E --delta D`` sizes
``cfg.rm`` from Theorem 12 through ``core.select.select_budget``, priced
by ``--bench FILE`` (default: the card's payload that ``chip_smoke.py``
phase 26 writes; unpriced when absent), ``--latency-budget S`` preferring
the families whose predicted featurize fits. ``--accuracy-tiers
low:1,standard:2,high:4`` serves per-request tiers (the synthetic requests
cycle through them; each finished request prints the budget its tier
certifies), rounding a selected D up to a multiple of the largest tier.
``--arch deepseek-v2-lite-16b`` serves MLA + MoE; ``--param-dtype
bfloat16`` draws the weights straight in bf16 (its 15.7 B parameters fit
one card only so). ``--arch jamba-v0.1-52b`` serves the Mamba + attention
hybrid (its FULL config, 51.6 B parameters, does not fit one card: serve
``--smoke`` there, or cut its depth in a config of your own) and ``--arch
xlstm-350m`` the attention-free xLSTM; ``--attention-mode`` defaults to rm
where the arch attends and to the config's own mode where it does not.
``--scheduler bucketed`` serves through the deprecated batch-synchronous
``serve.ServingEngine`` in place of the continuous-batching Scheduler
(default ``continuous``).
``--data-parallel`` serves over ``launch.mesh.make_host_mesh()``, every
rank of the default process group (``launch.mesh.init_distributed``: under
``torchrun`` one process a rank, else a world of one), slots split over
``"data"``; every rank runs the same Scheduler and rank 0 prints:

    torchrun --nproc-per-node 1 -m repro_torch.launch.serve --smoke \
        --data-parallel

Not ported yet: ``--arrival-trace`` (it replays through
``bench/loadgen.py``, ROADMAP.md queue A item 2).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import (
    get_config,
    launcher_attention_mode,
    list_archs,
    supports_rm,
)
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.budget import add_budget_args, apply_budget_selection
from repro_torch.launch.obs_flags import add_obs_args, close_obs, make_obs
from repro_torch.models.transformer import init_model
from repro_torch.serve import Request, Scheduler, ServingEngine

__all__ = ["make_engine", "parse_tiers", "main"]


def make_engine(
    arch: str,
    *,
    smoke: bool = True,
    attention_mode: str = "rm",
    estimator: Optional[str] = None,
    num_slots: int = 4,
    max_len: int = 128,
    seed: int = 0,
    obs=None,
    device="cuda",
    cfg=None,
    accuracy_tiers: Optional[Dict[str, int]] = None,
    param_dtype: Optional[str] = None,
    mesh=None,
    scheduler: str = "continuous",
    buckets: Optional[Sequence[int]] = None,
) -> Union[Scheduler, ServingEngine]:
    """Config -> random weights from ``seed`` -> a :class:`Scheduler`
    (``scheduler="continuous"``) or the deprecated
    :class:`ServingEngine` (``"bucketed"``), with the prefill bucket
    ladder ``buckets`` (default ``serve.DEFAULT_BUCKETS``).

    ``estimator`` (a registry name) is forwarded to ``get_config``, which
    validates it; ``cfg`` instead serves a config resolved already (the
    launcher's, after budget selection). ``obs`` (a ``repro_torch.obs.
    Obs``) and ``accuracy_tiers`` reach the Scheduler. ``param_dtype``
    ("float32" | "bfloat16") overrides the config's weight dtype (the
    weights are drawn on the device in it). ``device`` defaults to
    ``"cuda"`` and raises a ``RuntimeError`` where CUDA is absent; only
    ``device="cpu"`` runs on the CPU. ``mesh`` (a ``DeviceMesh``) serves on
    it: every rank draws its shards of the same weights, each weight cut as
    it is drawn, over ``"data"`` too where ``distributed.fsdp.enabled``
    (``distributed.tensor_parallel.init_local_params``).

    Raises:
        ValueError: an encoder config; an unknown ``scheduler``;
            ``accuracy_tiers`` with the bucketed engine (it has no
            per-request admission surface). Both before any weight is
            drawn.
    """
    if scheduler not in ("continuous", "bucketed"):
        raise ValueError(f"unknown scheduler {scheduler!r}: expected "
                         "'continuous' or 'bucketed'")
    if scheduler == "bucketed" and accuracy_tiers is not None:
        raise ValueError("accuracy tiers need the continuous scheduler; "
                         "the bucketed engine has no per-request admission "
                         "surface")
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(arch, smoke=smoke, attention_mode=attention_mode,
                         estimator=estimator)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype).validate()
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only; nothing to serve")
    if mesh is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_model(cfg, gen)
    else:
        params, _ = tp.init_local_params(cfg, seed, mesh, dev,
                                         fsdp_cut=fsdp.enabled(mesh))
    if scheduler == "bucketed":
        return ServingEngine(cfg, params, num_slots=num_slots,
                             max_len=max_len, rng_seed=seed, mesh=mesh,
                             obs=obs, buckets=buckets, device=dev)
    return Scheduler(cfg, params, num_slots=num_slots, max_len=max_len,
                     rng_seed=seed, buckets=buckets, obs=obs,
                     accuracy_tiers=accuracy_tiers, device=dev, mesh=mesh)


def parse_tiers(spec: str) -> Dict[str, int]:
    """``"low:1,standard:2,high:4"`` -> ``{"low": 1, ...}`` (CLI format)."""
    tiers = {}
    for part in spec.split(","):
        name, _, gens = part.partition(":")
        name = name.strip()
        if not name or not gens.strip().isdigit():
            raise SystemExit(
                f"[serve] bad --accuracy-tiers entry {part!r}: expected "
                "name:generations pairs like 'low:1,standard:2,high:4'")
        tiers[name] = int(gens)
    return tiers


def summarize(done) -> dict:
    """TTFT percentiles (seconds) and token count of finished requests."""
    ttft = np.asarray([s.t_first_token - s.t_enqueue for s in done.values()])
    return {
        "requests": len(done),
        "tokens": int(sum(len(s.generated) for s in done.values())),
        "ttft_p50_s": float(np.percentile(ttft, 50)) if len(ttft) else None,
        "ttft_p99_s": float(np.percentile(ttft, 99)) if len(ttft) else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attention-mode", default=None,
                    choices=["exact", "rm"],
                    help="default: rm where the arch attends, else the "
                         "config's own (xlstm-350m: attention-free)")
    ap.add_argument("--estimator", default=None,
                    help="feature-estimator registry name (rm, "
                         "tensor_sketch, ctr or structured; default: the "
                         "config's)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "bucketed"],
                    help="serving frontend: the continuous-batching "
                         "Scheduler (default) or the deprecated "
                         "batch-synchronous bucketed ServingEngine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="dtype the weights are drawn in (default: the "
                         "config's)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="serve over a host mesh of every rank of the "
                         "default process group (slots split over 'data')")
    ap.add_argument("--accuracy-tiers", default=None, metavar="SPEC",
                    help="per-request accuracy tiers as name:generations "
                         "pairs, e.g. 'low:1,standard:2,high:4' (rm "
                         "attention; the synthetic requests cycle through "
                         "the tiers)")
    add_obs_args(ap, "decode iterations")
    add_budget_args(ap)
    args = ap.parse_args(argv)

    # resolve the config once: the budget selection rewrites cfg.rm, and
    # the drift monitor and the engine both see the selected budget
    cfg = get_config(args.arch, smoke=args.smoke,
                     attention_mode=launcher_attention_mode(
                         args.arch, args.attention_mode),
                     estimator=args.estimator)
    cfg, decision = apply_budget_selection(cfg, args, tag="serve")
    tiers = parse_tiers(args.accuracy_tiers) if args.accuracy_tiers \
        else None
    if tiers and decision is not None:
        # tiers split the budget into max(generations) equal blocks: round
        # the selected D up to a multiple (eps_at only tightens)
        gmax = max(tiers.values())
        d = cfg.rm.num_features
        if d % gmax:
            d += gmax - d % gmax
            cfg = dataclasses.replace(cfg, rm=dataclasses.replace(
                cfg.rm, num_features=d)).validate()
            print(f"[serve] rounded D up to {d} (a multiple of {gmax} "
                  "tier generations)")
    mesh, rank0 = None, True
    if args.data_parallel:
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_mod

        mesh_mod.init_distributed(device=args.device)
        mesh = mesh_mod.make_host_mesh()
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"[serve] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" over {dist.get_world_size()} ranks")
    try:
        _serve(args, cfg, tiers, mesh, rank0)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, cfg, tiers, mesh, rank0: bool) -> None:
    """Submit the synthetic requests, run them, print on rank 0."""
    obs = make_obs(args, cfg, resolve_device(args.device), "serve")
    engine = make_engine(args.arch, num_slots=args.slots,
                         max_len=args.max_len, seed=args.seed, obs=obs,
                         device=args.device, cfg=cfg, accuracy_tiers=tiers,
                         param_dtype=args.param_dtype, mesh=mesh,
                         scheduler=args.scheduler)
    rng = np.random.default_rng(args.seed)
    vocab = engine.cfg.vocab_size
    tier_names = sorted(tiers) if tiers else None
    for i in range(args.requests):
        prompt = rng.integers(0, vocab, size=int(rng.integers(4, 24)))
        tier = tier_names[i % len(tier_names)] if tier_names else None
        engine.submit(Request(request_id=i, prompt=prompt,
                              max_new_tokens=args.max_new,
                              accuracy_tier=tier))
    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0
    if not rank0:
        close_obs(obs, args, "serve")
        return
    stats = summarize(done)
    print(f"[serve] {stats['requests']} requests, {stats['tokens']} tokens "
          f"in {wall:.3f}s ({stats['tokens'] / wall:.1f} tok/s aggregate) "
          f"on {engine.device}, {_attention_label(engine)}"
          + (", bucketed engine" if args.scheduler == "bucketed" else ""))
    print(f"[serve] ttft p50={stats['ttft_p50_s']:.4f}s "
          f"p99={stats['ttft_p99_s']:.4f}s")
    for rid in sorted(done):
        s = done[rid]
        ttft = s.t_first_token - s.t_enqueue
        tier = "" if s.tier_features is None else (
            f", tier {s.request.accuracy_tier} certified at "
            f"D={s.tier_features}")
        print(f"  req {rid}: {len(s.generated)} tokens "
              f"({s.finish_reason}), ttft={ttft:.4f}s{tier}")
    close_obs(obs, args, "serve")


def _attention_label(engine) -> str:
    if not supports_rm(engine.cfg):
        return "attention-free"
    if engine.cfg.attention_mode != "rm":
        return "exact softmax attention"
    return (f"estimator {engine.estimator}, "
            f"{'fused' if engine.fused_attention else 'two-launch'} "
            "attention")


if __name__ == "__main__":
    main()
