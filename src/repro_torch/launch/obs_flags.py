"""The launchers' observability flags (``--trace-out``, ``--metrics-out``,
``--drift-every``), shared by ``launch/serve.py`` and ``launch/train.py``
as the reference's two launchers each spell them out."""
from __future__ import annotations

import argparse

__all__ = ["add_obs_args", "make_obs", "close_obs"]


def add_obs_args(ap: argparse.ArgumentParser, loop: str) -> None:
    """``loop`` names the ticks ``--drift-every`` counts ("decode
    iterations" or "train steps")."""
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="stream a JSONL lifecycle + kernel-span trace "
                         "(inspect with python -m repro_torch.obs)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the metrics snapshot (histograms, "
                         "counters, gauges) as JSON")
    ap.add_argument("--drift-every", type=int, default=0, metavar="N",
                    help="run the online (eps, delta) Gram-drift check "
                         f"every N {loop} (0 = off; rm attention only)")


def make_obs(args, cfg, device, tag: str):
    """An ``Obs`` with kernel tracing installed when any flag asks for
    one, else None. The drift monitor watches a map drawn like the
    deployed attention featurizer (same family, measure and budget, at
    the head width), on ``device``."""
    if not (args.trace_out or args.metrics_out or args.drift_every):
        return None
    from repro_torch import obs as obs_mod

    drift = None
    if args.drift_every and cfg.attention_mode == "rm":
        from repro_torch.core.maclaurin import ExponentialDotProductKernel

        rm = cfg.rm
        # the monitor holds the map to the selected delta (--delta)
        delta = getattr(args, "delta", None)
        drift = obs_mod.DriftMonitor.for_estimator(
            ExponentialDotProductKernel(sigma2=rm.sigma2),
            cfg.resolved_head_dim, rm.num_features, estimator=rm.estimator,
            measure=rm.measure, device=device,
            **({"delta": delta} if delta is not None else {}))
    elif args.drift_every:
        print(f"[{tag}] --drift-every ignored: attention mode is not "
              "rm-family")
    return obs_mod.Obs(trace_path=args.trace_out, drift=drift,
                       drift_every=args.drift_every,
                       install_kernel_tracing=True)


def close_obs(obs, args, tag: str) -> None:
    """Print the drift verdict, write the metrics, close the trace."""
    if obs is None:
        return
    if obs.drift is not None and obs.drift.last is not None:
        rep = obs.drift.last
        print(f"[{tag}] drift: sup_err={rep.sup_err:.4f} vs "
              f"eps({rep.num_features}, delta)={rep.eps_bound:.4f} "
              f"[{'OK' if rep.ok else 'VIOLATION'}] "
              f"({obs.drift.checks} checks, {obs.drift.violations} "
              "violations)")
    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        print(f"[{tag}] wrote metrics -> {args.metrics_out}")
    obs.close()
    if args.trace_out:
        print(f"[{tag}] wrote trace -> {args.trace_out}")
