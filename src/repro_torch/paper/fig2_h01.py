"""Paper Figure 2 — H0/1 vs plain RF accuracy as D grows (port of
``benchmarks/fig2_h01.py``).

Rows ``fig2/<dataset>/D<D>/<rf|h01>,us_per_call,acc``: us_per_call is the
wall of the whole variant (map, featurize, train, test) on the device's
synchronized clock. Settings as the reference's: poly10, spambase and
nursery, D 25 / 100 / 400, maps seeded with D, ``train_linear`` at lam
1e-5.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch import resolve_device
from repro_torch.core import PolynomialKernel, train_linear
from repro_torch.paper._common import clock, dataset, map_maker

KERNEL = PolynomialKernel(10, 1.0)
DATASETS = ("spambase", "nursery")
BUDGETS = (25, 100, 400)
LAM = 1e-5


def run(device="cuda", datasets: Optional[Dict] = None, make_map=None,
        details: Optional[Dict] = None) -> List[str]:
    """The Figure 2 rows. ``datasets[name]`` hands over ``x_train``,
    ``y_train``, ``x_test``, ``y_test``; ``details[row]`` gets ``{"acc",
    "pred", "map"}`` (the test predictions on the CPU)."""
    dev = resolve_device(device)
    make = map_maker(make_map, dev)
    rows = []
    for name in DATASETS:
        ds = dataset(name, datasets, dev)
        d = ds["x_train"].shape[1]
        for D in BUDGETS:
            for variant, h01 in (("rf", False), ("h01", True)):
                t0 = clock(dev)
                fm = make(KERNEL, d, D, D, h01)
                ztr = fm(ds["x_train"])
                lin = train_linear(ztr, ds["y_train"], lam=LAM)
                zte = fm(ds["x_test"])
                acc = lin.accuracy(zte, ds["y_test"])
                us = (clock(dev) - t0) * 1e6
                row = f"fig2/{name}/D{D}/{variant}"
                rows.append(f"{row},{us:.0f},{acc:.4f}")
                if details is not None:
                    details[row] = {"acc": acc, "map": fm,
                                    "pred": lin.predict(zte).cpu()}
    return rows
