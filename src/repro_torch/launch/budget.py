"""The launchers' ``--eps/--delta/--latency-budget/--bench`` flags (port of
``repro.launch.budget``).

Both launchers (``repro_torch.launch.serve``, ``repro_torch.launch.train``)
take an accuracy target ``(--eps, --delta)`` and an optional
``--latency-budget``. When given, the launcher stops trusting the arch
config's feature budget and asks :func:`repro_torch.core.select.
select_budget` for the (estimator, D, precision) that certifies the target
at the lowest predicted featurization cost, priced from the bench payload
``--bench`` when it exists. Its default is the card's own payload, which
``chip_smoke.py`` (phase 26) writes under ``smoke_out/``; without it the
selection runs unpriced and says so. A decision for the card is never
priced from the reference's CPU interpret-mode rows in
``BENCH_core.json`` unless the caller names that file.

The selection goes into the resolved config by ``dataclasses.replace`` on
its ``rm`` sub-config, which is then validated again, so the model runs at
exactly the certified budget.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from repro_torch.core.select import DEFAULT_BENCH

__all__ = ["add_budget_args", "apply_budget_selection"]


def add_budget_args(ap) -> None:
    """Install the adaptive-accuracy flags on a launcher's argparser."""
    ap.add_argument("--eps", type=float, default=None, metavar="EPS",
                    help="target sup Gram error: size the RM feature "
                         "budget from the Theorem 12 bound instead of the "
                         "arch config (requires --delta; rm attention "
                         "only)")
    ap.add_argument("--delta", type=float, default=None, metavar="DELTA",
                    help="failure probability for --eps; also the delta "
                         "the --drift-every monitor holds the map to")
    ap.add_argument("--latency-budget", type=float, default=None,
                    metavar="SECONDS",
                    help="prefer the fastest (estimator, precision) whose "
                         "predicted featurization time fits (advisory: "
                         "accuracy is a guarantee, latency a preference)")
    ap.add_argument("--bench", default=DEFAULT_BENCH, metavar="FILE",
                    help="bench payload the selection's cost model is "
                         "fitted from (default: the card's, written by "
                         "chip_smoke.py phase 26; selection runs unpriced "
                         "when it is absent)")


def apply_budget_selection(cfg, args, *, tag: str = "launch",
                           ) -> Tuple[object, Optional[object]]:
    """Resolve ``--eps/--delta/--latency-budget`` against a config.

    Returns ``(cfg, decision)``: the config with the selected (estimator,
    num_features, precision) in ``cfg.rm``, validated, and the
    :class:`~repro_torch.core.select.BudgetDecision` (``None`` when no
    accuracy target was asked for). Exits with a usage error on a target
    given half, or for a config whose attention mode is not rm.
    """
    if args.eps is None and args.delta is None:
        return cfg, None
    if args.eps is None or args.delta is None:
        raise SystemExit(
            f"[{tag}] --eps and --delta must be given together "
            "(the Theorem 12 bound prices an (eps, delta) pair)")
    if cfg.attention_mode != "rm":
        raise SystemExit(
            f"[{tag}] --eps/--delta size the RM feature budget; "
            f"attention_mode={cfg.attention_mode!r} has none "
            "(pass --attention-mode rm)")

    from repro_torch.core import CostModel, ExponentialDotProductKernel
    from repro_torch.core.select import select_budget

    rm = cfg.rm
    cost = None
    if args.bench and os.path.exists(args.bench):
        cost = CostModel.from_file(args.bench)
    else:
        print(f"[{tag}] bench payload {args.bench!r} not found; "
              "selection runs without a cost model (no latency ranking)")
    # the bound constants exist for the measures core.bounds knows; the
    # config's proportional default maps through, anything else takes the
    # geometric constants (make_feature_map's accuracy-target rule)
    measure = "proportional" if rm.measure == "proportional" else "geometric"
    decision = select_budget(
        ExponentialDotProductKernel(sigma2=rm.sigma2),
        cfg.resolved_head_dim, args.eps, args.delta,
        latency_budget_s=args.latency_budget,
        # pin the family only when the user pinned it on the CLI
        estimator=getattr(args, "estimator", None),
        cost_model=cost, measure=measure, radius=0.9,
    )
    line = (f"[{tag}] selection: {decision.estimator}/{decision.precision} "
            f"D={decision.num_features} certifies "
            f"eps={decision.eps_certified:.4g} <= {decision.eps:.4g} "
            f"at delta={decision.delta:g}")
    if decision.predicted_latency_s is not None:
        over = decision.meets_latency_budget not in (None, True)
        line += (f" (predicted featurize "
                 f"{decision.predicted_latency_s * 1e3:.2f} ms/batch"
                 f"{', OVER the latency budget' if over else ''}, "
                 f"priced on backend {decision.backend})")
    print(line)
    cfg = dataclasses.replace(
        cfg, rm=dataclasses.replace(
            rm, estimator=decision.estimator,
            precision=decision.precision,
            num_features=decision.num_features)).validate()
    return cfg, decision
