"""Dot product kernels and their Maclaurin coefficients (port of
``repro.core.maclaurin``, the parts the RM attention plan reads).

A dot product kernel is ``K(x, y) = f(<x, y>)`` with ``f(x) = sum_n a_n
x^n``; by Schoenberg's theorem (paper Theorem 1) it is positive definite on
the unit ball iff every ``a_n >= 0``. The coefficients are host-side float64
arithmetic — ``math`` and numpy only — so the port's plans equal the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "DotProductKernel",
    "ExponentialDotProductKernel",
    "degree_measure",
]


class DotProductKernel:
    """Base class. Subclasses set ``name`` and implement ``coef``."""

    name: str = "abstract"

    def coef(self, n: int) -> float:
        raise NotImplementedError

    def coefs(self, n_max: int) -> np.ndarray:
        return np.asarray([self.coef(n) for n in range(n_max + 1)],
                          dtype=np.float64)

    def validate_positive_definite(self, n_max: int = 64) -> None:
        """Theorem 1: all Maclaurin coefficients must be non-negative."""
        cs = self.coefs(n_max)
        if np.any(cs < -1e-300):
            bad = int(np.argmax(cs < 0))
            raise ValueError(
                f"kernel {self.name!r} has negative Maclaurin coefficient "
                f"a_{bad}={cs[bad]:.3e}; not positive definite (Schoenberg)."
            )


@dataclasses.dataclass(frozen=True)
class ExponentialDotProductKernel(DotProductKernel):
    """``K(x, y) = exp(<x, y> / sigma^2)`` — a_n = sigma^{-2n} / n!.

    The softmax-attention kernel: with ``sigma^2 = sqrt(d_head)`` it is the
    unnormalized attention weight ``exp(q.k / sqrt(d_head))``.
    """

    sigma2: float = 1.0

    def __post_init__(self):
        if self.sigma2 <= 0:
            raise ValueError("sigma2 must be > 0")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"exp_dot_s{self.sigma2:g}"

    def coef(self, n: int) -> float:
        # exp(log) for stability at large n / small sigma2.
        return math.exp(-n * math.log(self.sigma2) - math.lgamma(n + 1))


def degree_measure(
    kernel: DotProductKernel,
    n_max: int,
    p: float = 2.0,
    kind: str = "geometric",
    min_degree: int = 0,
    radius: float = 1.0,
) -> np.ndarray:
    """Normalized measure q over degrees [0, n_max], zero where a_n == 0.

    (In the reference this lives in ``repro.core.feature_map``; the port
    keeps it beside the coefficients it reads until ``feature_map`` is
    ported.)

    ``kind``: ``"geometric"`` (paper), ``"geometric_ge2"`` (H0/1) or
    ``"proportional"`` (variance-optimal ``q_n ∝ a_n R^{2n}``). Returns a
    float64 ``[n_max + 1]`` array summing to 1.
    """
    coefs = kernel.coefs(n_max)
    if kind == "geometric":
        q = np.asarray([p ** -(n + 1) for n in range(n_max + 1)])
    elif kind == "geometric_ge2":
        q = np.asarray(
            [p ** -(n + 1) if n >= 2 else 0.0 for n in range(n_max + 1)]
        )
    elif kind == "proportional":
        q = coefs * (radius**2) ** np.arange(n_max + 1)
    else:
        raise ValueError(f"unknown degree measure {kind!r}")
    q = np.where(coefs > 0.0, q, 0.0)
    q = np.where(np.arange(n_max + 1) >= min_degree, q, 0.0)
    total = q.sum()
    if total <= 0:
        raise ValueError(
            f"measure {kind!r} has empty support for kernel {kernel.name} "
            f"with n_max={n_max}, min_degree={min_degree}"
        )
    return q / total
