"""End-to-end training driver: an LM on the synthetic Markov corpus with
checkpointing and crash recovery, in EXACT or RM (paper) attention mode.

A quick run (about 1.1 M parameters, the loss visibly dropping in about
50 steps):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset quick \\
        [--device cpu]

The ~100 M-parameter configuration (the same code path):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \\
        --steps 300
"""
from __future__ import annotations

import argparse
import math

from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.models.config import ModelConfig, RMAttentionConfig
from repro_torch.train.steps import TrainHyper
from repro_torch.train.trainer import Trainer

PRESETS = {
    # ~1.1 M params
    "quick": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  d_ff=256, vocab_size=512, seq=128, batch=8),
    # ~10 M params
    "10m": dict(num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
                d_ff=1024, vocab_size=2048, seq=256, batch=8),
    # ~100 M params (GPT-2-small-ish)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
                 d_ff=3072, vocab_size=8192, seq=512, batch=8),
}


def run(preset: str = "quick", steps: int = 80,
        attention_mode: str = "exact", lr: float = 3e-3, ckpt_dir=None,
        device="cuda"):
    """``(trainer, state)`` after ``steps`` steps (resumed from
    ``ckpt_dir``'s latest checkpoint where it holds one)."""
    p = PRESETS[preset]
    cfg = ModelConfig(
        name=f"lm-{preset}-{attention_mode}",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_kv_heads"],
        d_ff=p["d_ff"], vocab_size=p["vocab_size"],
        attention_mode=attention_mode,
        rm=RMAttentionConfig(num_features=128, n_max=6),
        tie_embeddings=True,
    ).validate()
    data = SyntheticLMDataset(vocab_size=p["vocab_size"], seq_len=p["seq"],
                              global_batch=p["batch"], device=device)
    hyper = TrainHyper(peak_lr=lr, warmup_steps=max(steps // 10, 5),
                       total_steps=steps)
    trainer = Trainer(cfg, hyper, data, ckpt_dir=ckpt_dir,
                      log_every=max(steps // 20, 1), device=device)
    state = trainer.train(steps)
    if not trainer.metrics_log:
        print(f"\n[train_lm] resumed at step {int(state['step'])}: nothing "
              "left to train")
        return trainer, state
    first = trainer.metrics_log[0]["ce"]
    last = trainer.metrics_log[-1]["ce"]
    uniform = math.log(p["vocab_size"])
    print(f"\n[train_lm] ce: {first:.3f} -> {last:.3f} "
          f"(uniform baseline {uniform:.3f}); "
          f"{'LEARNED' if last < first - 0.3 else 'check hyperparams'}")
    return trainer, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="quick", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--attention-mode", default="exact",
                    choices=["exact", "rm"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.preset, args.steps, args.attention_mode, args.lr,
               args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
