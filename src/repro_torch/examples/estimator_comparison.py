"""Compare the registry estimators on one kernel-approximation task.

Builds a feature map per requested estimator ("rm", "tensor_sketch",
"ctr", "structured") at the SAME feature budget from the estimator
registry, then reports Gram RMSE against the exact kernel and the accuracy
of a linear classifier trained on each feature set: the paper's Table 1
pipeline, the estimator swapped with one string.

    PYTHONPATH=src python -m repro_torch.examples.estimator_comparison \\
        [--estimators rm,ctr] [--shards 4] [--device cpu]

``--shards N`` also builds every estimator as N feature shards
(``make_feature_map(num_shards=N)``: shard s draws its own sub-map, the
Gram sums the shards' partial Grams, here on one device in a host loop)
and prints the sharded Gram RMSE beside the single map's; a mesh of N
ranks runs the same shards one a rank (``make_feature_map(mesh=)``).
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.core import (
    ExponentialDotProductKernel,
    make_feature_map,
    registry,
    train_featurized_linear,
)
from repro_torch.data.toy import make_classification_dataset


def run(shards: int = 0, estimators: str = "", device="cuda",
        train_rows: int = 2000, test_rows: int = 1000, features: int = 512,
        gram_rows: int = 256, data=None) -> dict:
    """{estimator: {"output_dim", "gram_rmse", "test_acc", "trunc_bias"
    and, with ``shards`` above 1, "sharded_rmse"}}; ``data``: the adult
    set (default ``make_classification_dataset("adult", seed=0)``)."""
    dev = resolve_device(device)
    kern = ExponentialDotProductKernel(1.0)
    data = data or make_classification_dataset("adult", seed=0, device=dev)
    xtr, ytr = data["x_train"][:train_rows], data["y_train"][:train_rows]
    xte, yte = data["x_test"][:test_rows], data["y_test"][:test_rows]
    d = xtr.shape[1]
    if shards > 1 and features % shards:
        raise SystemExit(f"--shards must divide the F={features} feature "
                         f"budget evenly (got {shards}); try 2, 4, 8, ...")
    names = ([s.strip() for s in estimators.split(",") if s.strip()]
             if estimators else list(registry.list_estimators()))
    for name in names:
        registry.get(name)   # validate early, naming the available ones
    k_exact = kern.gram(xte[:gram_rows])
    print(f"kernel={kern.name}  d={d}  F={features}  device={dev}")
    print(f"available estimators: {registry.list_estimators()}")
    out = {}
    for name in names:
        fm = make_feature_map(kern, d, features, seed=0, estimator=name,
                              measure="proportional", device=dev)
        est = fm.estimate_gram(xte[:gram_rows])
        rmse = float(((est - k_exact) ** 2).mean().sqrt())
        clf = train_featurized_linear(fm, xtr, ytr, lam=1e-4, n_iters=15)
        row = {"output_dim": fm.output_dim, "gram_rmse": rmse,
               "test_acc": clf.accuracy(xte, yte),
               "trunc_bias": fm.truncation_bias(1.0)}
        line = (f"  {name:>14}: output_dim={row['output_dim']:4d}  "
                f"gram_rmse={rmse:.4f}  test_acc={row['test_acc']:.3f}  "
                f"trunc_bias={row['trunc_bias']:.2e}")
        if shards > 1:
            sfm = make_feature_map(kern, d, features, seed=0,
                                   estimator=name, measure="proportional",
                                   num_shards=shards, device=dev)
            sh = sfm.estimate_gram(xte[:gram_rows])
            row["sharded_rmse"] = float(((sh - k_exact) ** 2).mean().sqrt())
            line += (f"  sharded[{sfm.num_shards}x{sfm.shard_output_dim}]"
                     f"_rmse={row['sharded_rmse']:.4f}")
        out[name] = row
        print(line)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=0,
                    help="also build each estimator as N feature shards")
    ap.add_argument("--estimators", type=str, default="",
                    help="comma-separated registry names to compare "
                         "(default: every registry entry)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-rows", type=int, default=2000)
    ap.add_argument("--test-rows", type=int, default=1000)
    ap.add_argument("--features", type=int, default=512)
    args = ap.parse_args(argv)
    return run(args.shards, args.estimators, args.device, args.train_rows,
               args.test_rows, args.features)


if __name__ == "__main__":
    main()
