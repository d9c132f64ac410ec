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
check every N steps. ``--eps/--delta/--latency-budget/--bench`` size
``cfg.rm`` from Theorem 12 (``launch/budget.py``), as the serve
launcher's do, within the config's feature family (the only one whose
kernels train). ``--mesh host`` trains data-parallel over every rank of
the default process group (``launch.mesh.init_distributed``: under
``torchrun`` one process a rank, else a world of one), ``--mesh single``
and ``multi`` over the 256- and 512-rank production meshes (they raise
with fewer ranks); ``--model-parallel N`` gives the host mesh a ``"model"``
axis of N (tensor parallelism, ``distributed.tensor_parallel``, with
``"act_seq"`` sequence sharding where N divides ``--seq``); the ranks
left form its ``"data"`` axis, over which the Trainer cuts params and
optimizer state (FSDP, ``distributed.fsdp``):

    torchrun --nproc-per-node 1 -m repro_torch.launch.train --mesh host \
        --smoke --steps 20
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import (
    get_config,
    launcher_attention_mode,
    list_archs,
)
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.launch.budget import add_budget_args, apply_budget_selection
from repro_torch.launch.obs_flags import add_obs_args, close_obs, make_obs
from repro_torch.train.steps import TrainHyper
from repro_torch.train.trainer import Trainer

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--attention-mode", default=None,
                    choices=["exact", "rm"],
                    help="default: rm where the arch attends, else the "
                         "config's own (xlstm-350m: attention-free)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the data")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single", "multi"])
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel size (the 'model' axis) of "
                         "--mesh host")
    add_obs_args(ap, "train steps")
    add_budget_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke,
                     attention_mode=launcher_attention_mode(
                         args.arch, args.attention_mode))
    # only the fused rm family's kernels have a backward (ROADMAP.md queue
    # C): the selection sizes D and picks the precision within the
    # config's family
    args.estimator = cfg.rm.estimator
    cfg, _ = apply_budget_selection(cfg, args, tag="train")
    if cfg.frontend != "none":
        raise SystemExit(
            f"{args.arch} needs modality inputs; train an LM arch, or step "
            "an encoder with repro_torch.train.steps.make_train_step")
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch, seed=args.seed,
                              device=args.device)
    hyper = TrainHyper(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                       total_steps=args.steps, grad_accum=args.grad_accum)
    mesh = None
    if args.mesh != "none":
        from repro_torch.launch import mesh as mesh_mod

        mesh_mod.init_distributed(device=args.device)
        mesh = {
            "host": lambda: mesh_mod.make_host_mesh(args.model_parallel),
            "single": mesh_mod.make_production_mesh,
            "multi": lambda: mesh_mod.make_production_mesh(multi_pod=True),
        }[args.mesh]()
    obs = make_obs(args, cfg, resolve_device(args.device), "train")
    trainer = Trainer(cfg, hyper, data, ckpt_dir=args.ckpt_dir, mesh=mesh,
                      seed=args.seed, obs=obs, device=args.device)
    try:
        state = trainer.train(args.steps)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    close_obs(obs, args, "train")
    return state


if __name__ == "__main__":
    main()
