"""§4.2 — the alternative feature map via Maclaurin series truncation (port
of ``repro.core.truncated``).

Choose ``k = k(eps, R)`` such that the tail mass ``sum_{n>k} a_n R^{2n} <=
eps_trunc`` and build a feature map for the truncated kernel ``K~(x,y) =
sum_{n<=k} a_n <x,y>^n``; it is ``(eps_trunc + eps_rf)``-accurate for K.
The truncated map is a stratified, proportional-measure ``RMFeatureMap``
restricted to degrees ``<= k``: every allocated degree is estimated with
exact weight a_n, and the budget splits across degrees in proportion to
their worst-case mass ``a_n R^{2n}``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.feature_map import RMFeatureMap, make_feature_map
from repro_torch.core.maclaurin import DotProductKernel

__all__ = ["truncation_degree", "make_truncated_feature_map"]


def truncation_degree(
    kernel: DotProductKernel,
    radius: float,
    eps_trunc: float,
    n_max: int = 64,
) -> Tuple[int, float]:
    """Smallest k with tail mass ``sum_{n>k} a_n R^{2n} <= eps_trunc``.

    Returns ``(k, achieved_tail_mass)``; raises if even n_max is not enough.
    """
    coefs = kernel.coefs(n_max)
    mass = coefs * (radius**2) ** np.arange(n_max + 1)
    total = kernel.f(radius**2)
    # tail after degree k = total - cumulative_{<=k}
    cum = np.cumsum(mass)
    tails = np.asarray(total - cum, dtype=np.float64)
    ok = np.nonzero(tails <= eps_trunc)[0]
    if len(ok) == 0:
        raise ValueError(
            f"kernel {kernel.name}: tail mass at n_max={n_max} is "
            f"{tails[-1]:.3e} > eps_trunc={eps_trunc:.3e}; increase n_max "
            "or rescale the data (paper §3: scale by c > I/gamma)."
        )
    k = int(ok[0])
    return k, float(max(tails[k], 0.0))


def make_truncated_feature_map(
    kernel: DotProductKernel,
    input_dim: int,
    num_features: int,
    key: torch.Generator,
    *,
    radius: float = 1.0,
    eps_trunc: float = 1e-4,
    n_max: int = 64,
    omega_dtype=None,
    device="cuda",
) -> RMFeatureMap:
    """Build the §4.2 truncated feature map for ``kernel``, its draws from
    ``key`` on ``device``."""
    k, _ = truncation_degree(kernel, radius, eps_trunc, n_max)
    return make_feature_map(
        kernel,
        input_dim,
        num_features,
        key,
        measure="proportional",
        stratified=True,
        n_max=max(k, 1),
        radius=radius,
        omega_dtype=omega_dtype,
        device=device,
    )
