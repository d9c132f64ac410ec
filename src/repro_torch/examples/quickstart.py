"""Quickstart: the paper in a minute.

Builds Random Maclaurin feature maps (Algorithm 1) for three dot product
kernels, checks the kernel approximation, trains a LINEAR classifier on
the features that matches an exact-kernel classifier (the paper's
headline claim), shows the H0/1 heuristic (§6.1) and Theorem 12's feature
count.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``--svm-rows``, ``--features``, ``--rf-features`` and ``--h01-features``
size the run (defaults: the reference example's).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    ExponentialDotProductKernel,
    HomogeneousPolynomialKernel,
    PolynomialKernel,
    constants_for,
    make_feature_map,
    train_kernel_svm,
    train_linear,
)
from repro_torch.data.toy import make_classification_dataset


def unit_rows(n: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` Gaussian rows scaled to norm 1 / 1.01 (inside the unit ball)."""
    x = torch.randn((n, d), generator=gen, device=gen.device)
    return x / (torch.linalg.norm(x, dim=1, keepdim=True) * 1.01)


def run(device="cuda", svm_rows: int = 1500,
        features=(100, 1000, 5000), rf_features: int = 500,
        h01_features: int = 100, x=None) -> dict:
    """The four sections; returns their numbers: ``approx`` {(kernel
    name, D): mean |error|}, ``acc_kernel``, ``acc_rf``, ``acc_h01`` and
    ``required_d`` (geometric, proportional). ``x``: the rows of section
    1 (default 100 x 20 drawn from seed 0)."""
    dev = resolve_device(device)
    out = {"approx": {}}

    print("=== kernel approximation (paper Fig. 1 setting) ===")
    if x is None:
        x = unit_rows(100, 20, torch.Generator(device=dev).manual_seed(0))
    x = x.to(dev)
    for kern in (HomogeneousPolynomialKernel(10), PolynomialKernel(10, 1.0),
                 ExponentialDotProductKernel(1.0)):
        exact = kern.gram(x)
        for D in features:
            fm = make_feature_map(kern, x.shape[1], D, seed=0, device=dev)
            err = float((fm.estimate_gram(x) - exact).abs().mean())
            out["approx"][(kern.name, D)] = err
            print(f"  {kern.name:22s} D={D:5d} mean |err| = {err:8.4f}")

    print("\n=== RM features + linear model vs exact kernel SVM ===")
    ds = make_classification_dataset("spambase", device=dev)
    kern = PolynomialKernel(10, 1.0)
    xs, ys = ds["x_train"][:svm_rows], ds["y_train"][:svm_rows]
    _, ksvm = train_kernel_svm(kern.gram(xs), ys, C=1.0,
                               kernel_fn=kern.gram, X_train=xs)
    out["acc_kernel"] = ksvm.accuracy(ds["x_test"], ds["y_test"])
    d = ds["x_train"].shape[1]
    fm = make_feature_map(kern, d, rf_features, seed=1, device=dev)
    lin = train_linear(fm(ds["x_train"]), ds["y_train"], lam=1e-5)
    out["acc_rf"] = lin.accuracy(fm(ds["x_test"]), ds["y_test"])
    print(f"  exact kernel SVM acc = {out['acc_kernel']:.3f}   "
          f"RM(D={rf_features}) + linear acc = {out['acc_rf']:.3f}")

    fm_h = make_feature_map(kern, d, h01_features, seed=2, h01=True,
                            device=dev)
    lin_h = train_linear(fm_h(ds["x_train"]), ds["y_train"], lam=1e-5)
    out["acc_h01"] = lin_h.accuracy(fm_h(ds["x_test"]), ds["y_test"])
    print(f"  H0/1 (D={h01_features} + raw features) acc = "
          f"{out['acc_h01']:.3f}")

    print("\n=== Theorem 12 required D (eps=0.2, delta=0.1, d=20) ===")
    c = constants_for(ExponentialDotProductKernel(1.0), radius=1.0, dim=20)
    out["required_d"] = (c.required_d(0.2, 0.1),
                         c.required_d(0.2, 0.1, "proportional"))
    print(f"  paper geometric measure : D >= {out['required_d'][0]:,}")
    print(f"  proportional measure    : D >= {out['required_d'][1]:,} "
          "(beyond-paper)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--svm-rows", type=int, default=1500)
    ap.add_argument("--features", default="100,1000,5000",
                    help="comma-separated D of section 1")
    ap.add_argument("--rf-features", type=int, default=500)
    ap.add_argument("--h01-features", type=int, default=100)
    args = ap.parse_args(argv)
    return run(args.device, args.svm_rows,
               tuple(int(v) for v in args.features.split(",")),
               args.rf_features, args.h01_features)


if __name__ == "__main__":
    main()
