"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --batch 4 --seq 128 --device cpu

trains on ``SyntheticLMDataset`` with the RM attention mode through the
fused ops (kernel B2 forward on the card), or with ``--attention-mode
exact`` softmax attention (plain PyTorch, through autograd). Without
``--smoke`` it takes the full-width config; ``--device`` defaults to
``cuda`` and raises without one. An encoder arch (frame-embedding inputs)
is refused, as in the reference. ``--trace-out`` streams the
``train/step`` and ``kernel/*`` spans, ``--metrics-out`` writes the
step-time histogram and loss gauge, ``--drift-every N`` runs the Gram-drift
check every N steps. Not ported yet: meshes and the budget flags
(ROADMAP.md queue A items 5 and 7).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch import resolve_device
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch.obs_flags import add_obs_args, close_obs, make_obs
from repro_torch.train.steps import TrainHyper
from repro_torch.train.trainer import Trainer

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--attention-mode", default="rm",
                    choices=["exact", "rm"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the data")
    ap.add_argument("--device", default="cuda")
    add_obs_args(ap, "train steps")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke,
                     attention_mode=args.attention_mode)
    if cfg.frontend != "none":
        raise SystemExit(
            f"{args.arch} needs modality inputs; train an LM arch, or step "
            "an encoder with repro_torch.train.steps.make_train_step")
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=args.seed,
                              device=args.device)
    hyper = TrainHyper(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                       total_steps=args.steps, grad_accum=args.grad_accum)
    obs = make_obs(args, cfg, resolve_device(args.device), "train")
    trainer = Trainer(cfg, hyper, data, ckpt_dir=args.ckpt_dir,
                      seed=args.seed, obs=obs, device=args.device)
    state = trainer.train(args.steps)
    close_obs(obs, args, "train")
    return state


if __name__ == "__main__":
    main()
