"""Serving example: batching over decode slots through the deprecated
``ServingEngine``, exact KV attention against the paper's RM attention
with its O(1) state.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --attention-mode rm [--device cpu]

Reports aggregate tokens/s and each request's first tokens; with
``--attention-mode rm`` a lane's state does not grow with the sequence.
The model is the arch's SMOKE config (``--full``: its published widths)
with random weights from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_model
from repro_torch.serve import Request, ServingEngine


def run(arch: str = "qwen3-1.7b", attention_mode: str = "exact",
        requests: int = 6, slots: int = 3, max_new: int = 12,
        device="cuda", full: bool = False) -> dict:
    """{request id: its RequestState} after the engine drained."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=not full, attention_mode=attention_mode)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(cfg, params, num_slots=slots, max_len=128,
                           device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(requests):
        n = int(rng.integers(4, 20))
        engine.submit(Request(request_id=i,
                              prompt=rng.integers(0, cfg.vocab_size, size=n),
                              max_new_tokens=max_new,
                              temperature=0.8 if i % 2 else 0.0))
    done = engine.run()
    wall = time.perf_counter() - t0
    toks = sum(len(s.generated) for s in done.values())
    print(f"[serve_lm] mode={attention_mode}: {len(done)} requests, "
          f"{toks} tokens, {wall:.1f}s, {toks / wall:.1f} tok/s aggregate")
    for rid in sorted(done):
        s = done[rid]
        print(f"  req {rid}: prompt={len(s.request.prompt):3d} tokens -> "
              f"{s.generated[:8]}{'...' if len(s.generated) > 8 else ''}")
    return done


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--attention-mode", default="exact",
                    choices=["exact", "rm"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths, not its SMOKE config")
    args = ap.parse_args(argv)
    return run(args.arch, args.attention_mode, args.requests, args.slots,
               args.max_new, args.device, args.full)


if __name__ == "__main__":
    main()
