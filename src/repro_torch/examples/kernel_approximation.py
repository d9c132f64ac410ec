"""Paper Figure 1: approximation error against the number of random
features D, for the homogeneous polynomial, polynomial and exponential dot
product kernels; with and without H0/1; the paper's iid sampling against
the beyond-paper proportional measure.

    PYTHONPATH=src python -m repro_torch.examples.kernel_approximation \\
        --out results_torch/fig1_approx_error.csv [--full] [--device cpu]

Writes the table as CSV to ``--out`` (its directory is made).
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    ExponentialDotProductKernel,
    HomogeneousPolynomialKernel,
    PolynomialKernel,
    make_feature_map,
)
from repro_torch.examples.quickstart import unit_rows

KERNELS = {
    "homogeneous": HomogeneousPolynomialKernel(10),
    "polynomial": PolynomialKernel(10, 1.0),
    "exponential": ExponentialDotProductKernel(1.0),
}
VARIANTS = ("rf", "h01", "proportional")


def run(out, full: bool = False, device="cuda", dims=None, features=None,
        reps=None):
    """The table's rows (kernel, d, D, variant, mean_abs_err, std), also
    written to ``out``; ``dims``, ``features`` and ``reps`` override the
    sizes ``full`` picks (the reference example's)."""
    dev = resolve_device(device)
    dims = dims or ((10, 50, 200) if full else (10, 50))
    features = features or ((10, 50, 100, 500, 1000, 5000) if full
                            else (10, 100, 1000))
    reps = reps or (5 if full else 3)
    rows = []
    for d in dims:
        x = unit_rows(100, d, torch.Generator(device=dev).manual_seed(d))
        for kname, kern in KERNELS.items():
            exact = kern.gram(x)
            for D in features:
                for variant in VARIANTS:
                    if variant == "h01" and kname == "homogeneous":
                        continue  # a_0 = a_1 = 0 (paper §6.2)
                    errs = []
                    for r in range(reps):
                        fm = make_feature_map(
                            kern, d, D, seed=1000 * r + D + d,
                            h01=(variant == "h01"),
                            measure=("proportional"
                                     if variant == "proportional"
                                     else "geometric"),
                            stratified=(variant == "proportional"),
                            device=dev)
                        errs.append(float((fm.estimate_gram(x) - exact)
                                          .abs().mean()))
                    errs_t = torch.tensor(errs, dtype=torch.float64)
                    rows.append({
                        "kernel": kname, "d": d, "D": D, "variant": variant,
                        "mean_abs_err": float(errs_t.mean()),
                        "std": float(errs_t.std(unbiased=False)),
                    })
                    print(f"  {kname:12s} d={d:3d} D={D:5d} {variant:13s} "
                          f"err={rows[-1]['mean_abs_err']:.4f}")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results_torch/fig1_approx_error.csv",
                    help="the CSV to write")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default=None, help="comma-separated d")
    ap.add_argument("--features", default=None, help="comma-separated D")
    ap.add_argument("--reps", type=int, default=None)
    args = ap.parse_args(argv)

    def ints(spec):
        return tuple(int(v) for v in spec.split(",")) if spec else None

    return run(args.out, args.full, args.device, ints(args.dims),
               ints(args.features), args.reps)


if __name__ == "__main__":
    main()
