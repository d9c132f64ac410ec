"""Paper Figure 1 — kernel approximation error vs D (port of
``benchmarks/fig1_approx.py``).

Rows ``fig1/<kernel>/D<D>,us_per_call,derived``: the derived column is
the mean absolute Gram error over ``max(1, max |K|)``; us_per_call times
the feature-map application (kernel B1 on the card), the mean of 5 calls.
Settings as the reference's: d 50, 100 points of a Gaussian normalized
into the unit ball (radius 1/1.01), D 100 / 1000 / 4000, maps seeded with
D.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    ExponentialDotProductKernel,
    HomogeneousPolynomialKernel,
    PolynomialKernel,
)
from repro_torch.paper._common import as_tensor, clock, map_maker

KERNELS = {
    "homog10": HomogeneousPolynomialKernel(10),
    "poly10": PolynomialKernel(10, 1.0),
    "exp": ExponentialDotProductKernel(1.0),
}
DIM, POINTS, BUDGETS = 50, 100, (100, 1000, 4000)


def run(device="cuda", datasets: Optional[Dict] = None, make_map=None,
        details: Optional[Dict] = None) -> List[str]:
    """The Figure 1 rows. ``datasets={"x": [100, 50]}`` hands over the
    Gaussian points before their normalization; ``details[row]`` gets
    ``{"err", "map", "gram", "x"}`` (the estimated Gram, the normalized
    points)."""
    dev = resolve_device(device)
    if datasets is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((POINTS, DIM), generator=gen, device=dev)
    else:
        x = as_tensor(datasets["x"], dev)
    x = x / (torch.linalg.norm(x, dim=1, keepdim=True) * 1.01)
    make = map_maker(make_map, dev)
    rows = []
    for kname, kern in KERNELS.items():
        exact = kern.gram(x)
        scale = max(1.0, exact.abs().max().item())
        for D in BUDGETS:
            fm = make(kern, DIM, D, D)
            z = fm(x)
            gram = z @ z.T
            err = (gram - exact).abs().mean().item() / scale
            t0 = clock(dev)
            for _ in range(5):
                fm(x)
            us = (clock(dev) - t0) / 5 * 1e6
            name = f"fig1/{kname}/D{D}"
            rows.append(f"{name},{us:.1f},{err:.5f}")
            if details is not None:
                details[name] = {"err": err, "map": fm, "gram": gram,
                                 "x": x}
    return rows
