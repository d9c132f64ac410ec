"""Datasets for the paper's experiments (Figures 1-2, Table 1; port of
``repro.data.toy``).

The paper's UCI datasets are unavailable offline; ``UCI_LIKE_SPECS`` mirrors
their (N, d) and the evaluation protocol (60% train / 40% test, vectors
normalized to the unit ball — the paper normalizes because dot product
kernels are unbounded, §3). The synthetic generator plants a polynomial
decision boundary so that non-linear kernels genuinely beat linear ones —
the qualitative structure Table 1 demonstrates.

The draws are the port's own, from a ``torch.Generator``: they are not the
reference's ``jax.random`` datasets. A dataset's seed is a stable digest of
its name (``zlib.crc32``) plus ``seed``, so a name gives the same data in
every process (the reference adds ``hash(name)``, which Python salts per
process).
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device

__all__ = ["UCI_LIKE_SPECS", "unit_ball_points", "make_classification_dataset"]

# name: (N, d) — mirrors the paper's Table 1 datasets
UCI_LIKE_SPECS: Dict[str, Tuple[int, int]] = {
    "nursery": (13000, 8),
    "spambase": (4600, 57),
    "cod-rna": (20000, 8),      # capped at 20000 like the paper's protocol
    "adult": (20000, 123),
    "ijcnn": (20000, 22),
    "covertype": (20000, 54),
}


def unit_ball_points(generator: torch.Generator, n: int, d: int
                     ) -> torch.Tensor:
    """``[n, d]`` points with ``||x||_2 <= 1`` (the paper's toy experiment):
    Gaussian directions at radius ``u^(1/d)``, u uniform, drawn from
    ``generator`` on its device."""
    dev = generator.device
    x = torch.randn((n, d), generator=generator, device=dev)
    r = torch.rand((n, 1), generator=generator, device=dev) ** (1.0 / d)
    return x / torch.linalg.norm(x, dim=1, keepdim=True) * r


def make_classification_dataset(
    name: str, seed: int = 0, noise: float = 0.05, device="cuda",
) -> Dict[str, torch.Tensor]:
    """Synthetic stand-in for one Table-1 dataset: degree-3 polynomial
    boundary in a random low-dim subspace + label noise. Returns
    ``x_train``, ``y_train``, ``x_test``, ``y_test`` (fp32, labels +-1) on
    ``device``, the card unless the caller asks for the CPU."""
    n, d = UCI_LIKE_SPECS[name]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(zlib.crc32(name.encode()) % (2**31) + seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    x = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-9)

    # boundary: w.x + (q1.x)(q2.x) + (q3.x)^3
    w = torch.randn((d,), generator=gen, device=dev)
    q = torch.randn((3, d), generator=gen, device=dev)
    score = x @ w + 2.0 * (x @ q[0]) * (x @ q[1]) + 3.0 * (x @ q[2]) ** 3
    y = torch.sign(score - torch.quantile(score, 0.5))
    flip = torch.rand((n,), generator=gen, device=dev) < noise
    y = torch.where(flip, -y, y)
    y = torch.where(y == 0, torch.ones_like(y), y)

    perm = torch.randperm(n, generator=gen, device=dev)
    x, y = x[perm], y[perm]
    n_train = int(0.6 * n)
    return {
        "x_train": x[:n_train],
        "y_train": y[:n_train],
        "x_test": x[n_train:],
        "y_test": y[n_train:],
    }
