"""Paper Table 1 — exact-kernel classifier vs RF vs H0/1 (port of
``benchmarks/table1_svm.py``): accuracy, train wall and test time per
example, on the UCI-like stand-ins (``repro_torch.data``).

Rows ``table1/<dataset>/<method>,us_per_call,acc`` where us_per_call is
the TEST-time cost per example (the paper's headline speedup axis); the
``_train`` rows carry the training wall in µs, the ``speedup_`` rows the
exact kernel's test time over each map's. Settings as the reference's:
poly10; the exact SVM (``train_kernel_svm``: one CUDA graph an epoch on
the card) on the first 1200 training rows; RM at D 500 (seed 0) and H0/1
at D 100 (seed 1), each + ``train_linear`` at lam 1e-5.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.core import (
    PolynomialKernel,
    train_kernel_svm,
    train_linear,
)
from repro_torch.paper._common import clock, dataset, map_maker

DATASETS = ("nursery", "spambase", "ijcnn")
KERNEL = PolynomialKernel(10, 1.0)
N_KERNEL_TRAIN = 1200   # exact Gram solves are O(N^2)-O(N^3): cap like LIBSVM
D_RF = 500
D_H01 = 100
LAM = 1e-5


def run(device="cuda", datasets: Optional[Dict] = None, make_map=None,
        details: Optional[Dict] = None) -> List[str]:
    """The Table 1 rows. ``datasets[name]`` hands over ``x_train``,
    ``y_train``, ``x_test``, ``y_test``; ``details[<dataset>/<method>]``
    (method ``kernel``, ``rf`` or ``h01``) gets ``{"acc", "pred",
    "train_s", "test_s"}`` and, for the maps, ``"map"``."""
    dev = resolve_device(device)
    make = map_maker(make_map, dev)
    rows = []
    for name in DATASETS:
        ds = dataset(name, datasets, dev)
        xtr, ytr = ds["x_train"], ds["y_train"]
        xte, yte = ds["x_test"], ds["y_test"]
        d = xtr.shape[1]
        found = {}

        # --- exact kernel (LIBSVM stand-in) -------------------------------
        xk, yk = xtr[:N_KERNEL_TRAIN], ytr[:N_KERNEL_TRAIN]
        t0 = clock(dev)
        gram = KERNEL.gram(xk)
        _, ksvm = train_kernel_svm(gram, yk, C=1.0, kernel_fn=KERNEL.gram,
                                   X_train=xk)
        t1 = clock(dev)
        acc = ksvm.accuracy(xte, yte)
        found["kernel"] = {"acc": acc, "train_s": t1 - t0,
                           "test_s": clock(dev) - t1, "clf": ksvm, "x": xte}

        # --- RF and H0/1: random features + linear ------------------------
        for method, num, seed, h01 in (("rf", D_RF, 0, False),
                                       ("h01", D_H01, 1, True)):
            t0 = clock(dev)
            fm = make(KERNEL, d, num, seed, h01)
            lin = train_linear(fm(xtr), ytr, lam=LAM)
            t1 = clock(dev)
            zte = fm(xte)
            acc = lin.accuracy(zte, yte)
            found[method] = {"acc": acc, "train_s": t1 - t0,
                             "test_s": clock(dev) - t1, "clf": lin,
                             "x": zte, "map": fm}

        n_te = xte.shape[0]
        tst = {m: f["test_s"] for m, f in found.items()}
        for m in ("kernel", "rf", "h01"):
            rows.append(f"table1/{name}/{m}_test,"
                        f"{tst[m] / n_te * 1e6:.1f},{found[m]['acc']:.4f}")
        for m in ("kernel", "rf", "h01"):
            rows.append(f"table1/{name}/{m}_train,"
                        f"{found[m]['train_s'] * 1e6:.0f},"
                        f"{found[m]['acc']:.4f}")
        rows += [
            f"table1/{name}/speedup_tst_rf,"
            f"{tst['kernel'] / max(tst['rf'], 1e-9):.1f},0",
            f"table1/{name}/speedup_tst_h01,"
            f"{tst['kernel'] / max(tst['h01'], 1e-9):.1f},0",
        ]
        if details is not None:
            for m, f in found.items():
                clf, x = f.pop("clf"), f.pop("x")
                details[f"{name}/{m}"] = {**f, "pred": clf.predict(x).cpu()}
    return rows
