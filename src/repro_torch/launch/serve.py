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
(eps, delta) Gram-drift check every N decode iterations. Not ported yet:
``--arrival-trace`` (it replays through ``bench/loadgen.py``, ROADMAP.md
queue A item 2).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.obs_flags import add_obs_args, close_obs, make_obs
from repro_torch.models.transformer import init_model
from repro_torch.serve import Request, Scheduler

__all__ = ["make_engine", "main"]


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
) -> Scheduler:
    """Config -> random weights from ``seed`` -> a :class:`Scheduler`.

    ``estimator`` (a registry name) is forwarded to ``get_config``, which
    validates it. ``obs`` (a ``repro_torch.obs.Obs``) reaches the
    Scheduler. ``device`` defaults to ``"cuda"`` and raises a
    ``RuntimeError`` where CUDA is absent; only ``device="cpu"`` runs on
    the CPU.
    """
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke, attention_mode=attention_mode,
                     estimator=estimator)
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only; nothing to serve")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_model(cfg, gen)
    return Scheduler(cfg, params, num_slots=num_slots, max_len=max_len,
                     rng_seed=seed, obs=obs, device=dev)


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
    ap.add_argument("--attention-mode", default="rm",
                    choices=["exact", "rm"])
    ap.add_argument("--estimator", default=None,
                    help="feature-estimator registry name (rm, "
                         "tensor_sketch, ctr or structured; default: the "
                         "config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_obs_args(ap, "decode iterations")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke,
                     attention_mode=args.attention_mode,
                     estimator=args.estimator)
    obs = make_obs(args, cfg, resolve_device(args.device), "serve")
    engine = make_engine(args.arch, smoke=args.smoke,
                         attention_mode=args.attention_mode,
                         estimator=args.estimator, num_slots=args.slots,
                         max_len=args.max_len,
                         seed=args.seed, obs=obs, device=args.device)
    rng = np.random.default_rng(args.seed)
    vocab = engine.cfg.vocab_size
    for i in range(args.requests):
        prompt = rng.integers(0, vocab, size=int(rng.integers(4, 24)))
        engine.submit(Request(request_id=i, prompt=prompt,
                              max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0
    stats = summarize(done)
    print(f"[serve] {stats['requests']} requests, {stats['tokens']} tokens "
          f"in {wall:.3f}s ({stats['tokens'] / wall:.1f} tok/s aggregate) "
          f"on {engine.device}, {_attention_label(engine)}")
    print(f"[serve] ttft p50={stats['ttft_p50_s']:.4f}s "
          f"p99={stats['ttft_p99_s']:.4f}s")
    for rid in sorted(done):
        s = done[rid]
        ttft = s.t_first_token - s.t_enqueue
        print(f"  req {rid}: {len(s.generated)} tokens "
              f"({s.finish_reason}), ttft={ttft:.4f}s")
    close_obs(obs, args, "serve")


def _attention_label(engine) -> str:
    if engine.cfg.attention_mode != "rm":
        return "exact softmax attention"
    return (f"estimator {engine.estimator}, "
            f"{'fused' if engine.fused_attention else 'two-launch'} "
            "attention")


if __name__ == "__main__":
    main()
