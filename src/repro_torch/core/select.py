"""Adaptive (eps, delta)-driven budget selection (port of
``repro.core.select``).

Theorem 12 prices accuracy in features: ``required_d(eps, delta)`` is the
budget the bound demands. A bench payload in ``BENCH_core.json``'s schema
prices features in seconds: every (estimator x precision) cell carries a
measured featurization throughput (``fused_feats_per_s``).
``select_budget`` combines the two: given (kernel, eps, delta, optional
latency budget) it returns the (estimator, D, precision) that certifies
the accuracy target at the lowest predicted latency.

The latency side is a ``CostModel`` fitted from bench rows: per
(estimator, precision) the measured features/second at each benched F,
linearly interpolated in log-F and clamped at the ends. A decision for the
card is priced from rows measured on the card: ``chip_smoke.py`` (phase
26) writes such a payload (``"backend": "gpu"``) under ``smoke_out/``;
the committed ``BENCH_core.json`` holds the reference's CPU
interpret-mode rows, and ``platform=`` refuses a cost model from another
backend.

Relative-error mode (Chen & Phillips): ``relative=True`` converts a
relative target into the additive eps that guarantees it at the smallest
kernel magnitude on the data ball.

Run as a CLI: ``python -m repro_torch.core.select --kernel exp --dim 64
--eps 0.1 --delta 0.05 --bench smoke_out/phase26/bench_core_gpu.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bounds import constants_for
from repro_torch.core.maclaurin import DotProductKernel

__all__ = ["CostModel", "BudgetDecision", "select_budget",
           "relative_to_additive_eps", "selection_section", "make_kernel",
           "main"]

# The throughput column the cost model reads. ``fused_feats_per_s`` is the
# single-launch featurize (the fused kernel) — the one serving runs.
THROUGHPUT_KEY = "fused_feats_per_s"


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Featurization throughput per (estimator, precision), from bench rows.

    ``rows`` maps ``(estimator, precision)`` to a sorted tuple of
    ``(F, feats_per_s)`` measurements.
    """

    backend: str
    interpret: bool
    rows: Dict[Tuple[str, str], Tuple[Tuple[int, float], ...]]

    @classmethod
    def from_payload(cls, payload: Dict[str, Any],
                     throughput_key: str = THROUGHPUT_KEY) -> "CostModel":
        rows: Dict[Tuple[str, str], List[Tuple[int, float]]] = {}
        for shape in payload.get("results", {}).values():
            F = int(shape["F"])
            for cell_key, cell in shape.get("cells", {}).items():
                est, prec = cell_key.split("/", 1)
                tput = float(cell[throughput_key])
                if tput > 0.0:
                    rows.setdefault((est, prec), []).append((F, tput))
        return cls(
            backend=str(payload.get("backend", "unknown")),
            interpret=bool(payload.get("interpret", False)),
            rows={k: tuple(sorted(v)) for k, v in rows.items()},
        )

    @classmethod
    def from_file(cls, path, throughput_key: str = THROUGHPUT_KEY
                  ) -> "CostModel":
        with open(path) as f:
            return cls.from_payload(json.load(f), throughput_key)

    def covers(self, estimator: str, precision: str) -> bool:
        return (estimator, precision) in self.rows

    def missing_cells(self, estimators: Sequence[str],
                      precisions: Sequence[str]) -> List[str]:
        """Grid cells with no usable throughput row (the coverage gate)."""
        return [f"{e}/{p}" for e in estimators for p in precisions
                if not self.covers(e, p)]

    def throughput(self, estimator: str, precision: str,
                   num_features: int) -> float:
        """Features/second at budget F: log-F linear interpolation over the
        benched points, clamped to the measured range at the ends."""
        pts = self.rows.get((estimator, precision))
        if not pts:
            raise KeyError(
                f"cost model has no rows for {estimator}/{precision} "
                f"(backend={self.backend}); benched cells: "
                f"{sorted('/'.join(k) for k in self.rows)}")
        fs = np.log([p[0] for p in pts])
        ts = np.asarray([p[1] for p in pts])
        return float(np.interp(math.log(max(num_features, 1)), fs, ts))

    def predict_latency_s(self, estimator: str, precision: str,
                          num_features: int, batch: int) -> float:
        """Time to featurize ``batch`` rows at budget ``num_features``."""
        return batch * num_features / self.throughput(
            estimator, precision, num_features)


# The card's own payload: chip_smoke.py's phase 26 times every family's
# fused featurize on the card at BENCH_core.json's shapes and writes it
# here (relative to the working directory, the repo root; git-ignored).
DEFAULT_BENCH = "smoke_out/phase26/bench_core_gpu.json"


def make_kernel(name: str) -> DotProductKernel:
    """Resolve a bench kernel name (``exp`` | ``poly<N>``) to a kernel (the
    port's copy of ``repro.bench.spec.make_kernel``)."""
    from repro_torch.core.maclaurin import (
        ExponentialDotProductKernel,
        PolynomialKernel,
    )

    if name == "exp":
        return ExponentialDotProductKernel(1.0)
    if name.startswith("poly"):
        return PolynomialKernel(int(name[len("poly"):]), 1.0)
    raise ValueError(f"unknown bench kernel {name!r} (exp | poly<N>)")


def relative_to_additive_eps(kernel: DotProductKernel, radius: float,
                             eps_rel: float, grid: int = 512) -> float:
    """Additive eps guaranteeing relative error ``eps_rel`` on the ball.

    On ``B(0, R)`` the kernel value is ``f(t)`` for ``t in [-R^2, R^2]``;
    an additive error of ``eps_rel * min |f|`` is a relative error of at
    most ``eps_rel`` everywhere on the ball (Chen & Phillips' regime is
    exactly the one where this min is small and additive targets go
    blind).  Raises if the kernel crosses zero on the ball — no additive
    budget can certify a relative target there.
    """
    if not eps_rel > 0.0:
        raise ValueError(f"eps_rel must be > 0, got eps_rel={eps_rel!r}")
    r2 = radius * radius
    lo = -r2 if kernel.radius > r2 or not np.isfinite(kernel.radius) else -r2
    ts = np.linspace(lo, r2, grid)
    raw = np.asarray([float(kernel.f(t)) for t in ts])
    min_val = float(np.abs(raw).min())
    # a sign change between grid points means f hits zero somewhere on the
    # ball even if no sample lands exactly on it
    if min_val <= 0.0 or (raw.min() < 0.0 < raw.max()):
        raise ValueError(
            f"kernel {kernel.name} attains 0 on the radius-{radius} ball; "
            "a relative-error target is not certifiable by an additive "
            "bound there")
    return eps_rel * min_val


@dataclasses.dataclass(frozen=True)
class BudgetDecision:
    """The selection outcome plus the full candidate table behind it."""

    estimator: str
    precision: str
    num_features: int
    eps: float                          # the (additive) target
    delta: float
    measure: str
    eps_certified: float                # eps_at(num_features, delta)
    predicted_latency_s: Optional[float]
    latency_budget_s: Optional[float]
    meets_latency_budget: Optional[bool]
    kernel: str
    input_dim: int
    radius: float
    batch: int
    backend: Optional[str]
    candidates: Tuple[Dict[str, Any], ...]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["candidates"] = list(d["candidates"])
        return d


def select_budget(
    kernel: DotProductKernel,
    input_dim: int,
    eps: float,
    delta: float,
    *,
    latency_budget_s: Optional[float] = None,
    estimator: Optional[str] = None,
    platform: Optional[str] = None,
    precision: Optional[str] = None,
    cost_model: Optional[CostModel] = None,
    bench_path: Optional[str] = None,
    measure: str = "proportional",
    radius: float = 1.0,
    p: float = 2.0,
    batch: int = 1024,
    relative: bool = False,
) -> BudgetDecision:
    """Pick (estimator, D, precision) certifying (eps, delta) at least cost.

    The accuracy side is exact: ``D = required_d(eps, delta)`` from the
    Theorem 12 constants, so ``eps_at(D, delta) <= eps`` by the round-trip
    property ``tests/test_bounds_roundtrip.py`` pins.  The latency side
    ranks candidates by the cost model's predicted featurization time;
    with no cost model (or for unbenched cells) selection falls back to
    the fixed preference order and reports ``predicted_latency_s=None``.

    ``latency_budget_s`` filters candidates by predicted latency.  When NO
    candidate fits, the fastest one is still returned with
    ``meets_latency_budget=False`` — accuracy is a guarantee, latency a
    preference; callers that want hard latency floors check the flag.

    ``relative=True`` reinterprets ``eps`` as a relative target (Chen &
    Phillips) and converts via :func:`relative_to_additive_eps`.

    ``platform`` is advisory: it is recorded and checked against the cost
    model's backend, a mismatch raises (a GPU decision priced from CPU
    interpret rows would be fiction).
    """
    from repro_torch.core import registry

    if relative:
        eps = relative_to_additive_eps(kernel, radius, eps)
    if cost_model is None and bench_path is not None:
        cost_model = CostModel.from_file(bench_path)
    if (platform is not None and cost_model is not None
            and cost_model.backend not in (platform, "unknown")):
        raise ValueError(
            f"platform={platform!r} but the cost model was measured on "
            f"backend={cost_model.backend!r}; re-bench on the target "
            "platform or drop the platform pin")

    consts = constants_for(kernel, radius, input_dim, p)
    d_req = consts.required_d(eps, delta, measure)
    eps_certified = consts.eps_at(d_req, delta, measure)

    estimators = [estimator] if estimator else list(
        registry.list_estimators())
    precisions = [precision] if precision else ["fp32", "bf16"]

    candidates: List[Dict[str, Any]] = []
    for est in estimators:
        registry.get(est)  # raises with the available-name list
        for prec in precisions:
            cand: Dict[str, Any] = {
                "estimator": est, "precision": prec,
                "num_features": d_req,
                "predicted_latency_s": None,
                "meets_latency_budget": None,
            }
            if cost_model is not None and cost_model.covers(est, prec):
                lat = cost_model.predict_latency_s(est, prec, d_req, batch)
                cand["predicted_latency_s"] = lat
                if latency_budget_s is not None:
                    cand["meets_latency_budget"] = lat <= latency_budget_s
            candidates.append(cand)

    priced = [c for c in candidates
              if c["predicted_latency_s"] is not None]
    in_budget = [c for c in priced if c["meets_latency_budget"]]
    if in_budget:
        best = min(in_budget, key=lambda c: c["predicted_latency_s"])
    elif priced:
        best = min(priced, key=lambda c: c["predicted_latency_s"])
    else:
        best = candidates[0]  # no cost model: fixed preference order

    return BudgetDecision(
        estimator=best["estimator"],
        precision=best["precision"],
        num_features=d_req,
        eps=eps,
        delta=delta,
        measure=measure,
        eps_certified=eps_certified,
        predicted_latency_s=best["predicted_latency_s"],
        latency_budget_s=latency_budget_s,
        meets_latency_budget=best["meets_latency_budget"],
        kernel=kernel.name,
        input_dim=input_dim,
        radius=radius,
        batch=batch,
        backend=cost_model.backend if cost_model is not None else None,
        candidates=tuple(candidates),
    )


def selection_section(payload: Dict[str, Any],
                      targets: Optional[Sequence[Tuple[float, float]]] = None
                      ) -> Dict[str, Any]:
    """The ``selection`` section of a bench payload: the decision table
    ``select_budget`` produces for each benched shape at a small (eps,
    delta) target grid, priced from the payload's OWN rows.  Committed
    next to the timings, it makes every bench artifact double as a
    worked example of the adaptive-accuracy control loop."""
    cost = CostModel.from_payload(payload)
    targets = list(targets or [(0.25, 0.05), (0.1, 0.01)])
    decisions: Dict[str, Any] = {}
    for shape_name, shape in payload.get("results", {}).items():
        kernel = make_kernel(shape["kernel"])
        per_shape = []
        for eps, delta in targets:
            dec = select_budget(
                kernel, int(shape["d"]), eps, delta,
                cost_model=cost, measure="proportional", radius=0.7,
                batch=int(shape["batch"]),
            )
            per_shape.append(dec.to_dict())
        decisions[shape_name] = per_shape
    return {
        "targets": [list(t) for t in targets],
        "measure": "proportional",
        "radius": 0.7,
        "decisions": decisions,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Selection CLI: print the decision as JSON; ``--check-coverage``
    exits 1 when the cost model misses a cell of the estimator x precision
    grid (or the payload is absent)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.select",
        description="(eps, delta) -> (estimator, D, precision) via "
                    "Theorem 12 + a bench payload's cost model")
    ap.add_argument("--kernel", default="exp",
                    help="exp | polyN (e.g. poly7)")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--delta", type=float, default=0.05)
    ap.add_argument("--latency-budget", type=float, default=None,
                    help="seconds; filters candidates by predicted latency")
    ap.add_argument("--estimator", default=None)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--measure", default="proportional")
    ap.add_argument("--radius", type=float, default=0.7)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--relative", action="store_true",
                    help="treat --eps as a relative target "
                         "(Chen & Phillips)")
    ap.add_argument("--bench", default=DEFAULT_BENCH,
                    help="bench payload to fit the cost model from "
                         "(default: the card's, written by chip_smoke.py "
                         "phase 26)")
    ap.add_argument("--check-coverage", action="store_true",
                    help="exit 1 if the cost model misses any "
                         "estimator x precision cell")
    args = ap.parse_args(argv)

    from repro_torch.core import registry

    cost = None
    if args.bench and Path(args.bench).exists():
        cost = CostModel.from_file(args.bench)
    elif args.check_coverage:
        print(f"selection: bench artifact {args.bench!r} not found")
        return 1

    if args.check_coverage:
        missing = cost.missing_cells(registry.list_estimators(),
                                     ["fp32", "bf16"])
        if missing:
            print(f"selection: cost model from {args.bench} is missing "
                  f"cells: {missing}")
            return 1
        print(f"selection: cost model covers the full "
              f"{len(registry.list_estimators())} x 2 grid "
              f"(backend={cost.backend}, interpret={cost.interpret})")

    decision = select_budget(
        make_kernel(args.kernel), args.dim, args.eps, args.delta,
        latency_budget_s=args.latency_budget, estimator=args.estimator,
        precision=args.precision, cost_model=cost, measure=args.measure,
        radius=args.radius, batch=args.batch, relative=args.relative,
    )
    print(json.dumps(decision.to_dict(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
