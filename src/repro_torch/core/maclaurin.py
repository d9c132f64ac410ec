"""Dot product kernel zoo with Maclaurin coefficient access (port of
``repro.core.maclaurin``).

A dot product kernel is ``K(x, y) = f(<x, y>)`` with ``f(x) = sum_n a_n
x^n``; by Schoenberg's theorem (paper Theorem 1) it is positive definite on
the unit ball iff every ``a_n >= 0``. Every kernel here exposes:

  * ``coefs(n_max)`` — the coefficients ``a_0 .. a_{n_max}`` (float64,
    host; ``math`` and numpy only, so the port's plans equal the
    reference's bit for bit),
  * ``f(x)`` / ``fprime(x)`` — closed forms: a Python float or a numpy
    array is evaluated in float64 numpy (what the bounds use, as in the
    reference), a torch tensor in torch on its own device and dtype,
  * ``gram(X, Y)`` — the exact kernel matrix of torch tensors, on their
    device,
  * ``radius`` — radius of convergence of the series (``np.inf`` if
    entire).

``degree_measure`` lives here, beside the coefficients it reads
(``core.feature_map`` re-exports it under the reference's name: defining it
there would make an import cycle, since ``core.plan`` reads it and
``core.feature_map`` reads ``core.plan``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "DotProductKernel",
    "HomogeneousPolynomialKernel",
    "PolynomialKernel",
    "ExponentialDotProductKernel",
    "VovkRealKernel",
    "VovkInfiniteKernel",
    "MaclaurinKernel",
    "kernel_from_name",
    "degree_measure",
]


def _host(x) -> bool:
    """True for the values the reference evaluates in numpy float64."""
    return isinstance(x, (np.ndarray, float, int))


def _horner(x, coefs):
    """``sum_n coefs[n] x^n`` by Horner's rule: float64 numpy for host
    values, torch on a tensor's device and dtype."""
    if _host(x):
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros_like(x)
    else:
        out = torch.zeros_like(x)
    for c in reversed(coefs):
        out = out * x + c
    return out


class DotProductKernel:
    """Base class. Subclasses set ``name`` and implement ``coef``/``f``."""

    name: str = "abstract"
    #: radius of convergence of the Maclaurin series (np.inf when entire)
    radius: float = np.inf

    # -- series ------------------------------------------------------------
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

    # -- closed forms --------------------------------------------------------
    def f(self, x):
        raise NotImplementedError

    def fprime(self, x):
        raise NotImplementedError

    def series_eval(self, x, n_max: int = 64) -> np.ndarray:
        """Evaluate via the truncated series (float64). For tests/oracles."""
        return _horner(np.asarray(x, dtype=np.float64), self.coefs(n_max))

    # -- batched kernels -----------------------------------------------------
    def gram(self, X: torch.Tensor, Y: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Exact kernel matrix ``K[i, j] = f(<X_i, Y_j>)`` on X's device.

        Without ``Y`` the upper triangle of the result is mirrored into
        the lower one, so the self-Gram is symmetric bit for bit whatever
        order the BLAS sums each entry of ``X @ X.T`` in, and whether an
        element of ``f`` lands in a vectorized or a scalar loop (the two
        may round ``pow`` differently)."""
        if Y is not None:
            return self.f(X @ Y.T)
        k = self.f(X @ X.T)
        lower = torch.triu(k, diagonal=1).T
        return k.triu_() + lower

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"{type(self).__name__}({self.name})"


@dataclasses.dataclass(frozen=True)
class HomogeneousPolynomialKernel(DotProductKernel):
    """``K(x, y) = <x, y>^p`` — a_p = 1, all other coefficients zero."""

    degree: int = 10

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError("degree must be >= 1")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"homogeneous_poly{self.degree}"

    def coef(self, n: int) -> float:
        return 1.0 if n == self.degree else 0.0

    def f(self, x):
        return x**self.degree

    def fprime(self, x):
        return self.degree * x ** (self.degree - 1)


@dataclasses.dataclass(frozen=True)
class PolynomialKernel(DotProductKernel):
    """``K(x, y) = (<x, y> + r)^p`` — a_n = C(p, n) r^(p-n) for n <= p."""

    degree: int = 10
    r: float = 1.0

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError("degree must be >= 1")
        if self.r < 0:
            raise ValueError("offset r must be >= 0 for positive definiteness")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"poly{self.degree}_r{self.r:g}"

    def coef(self, n: int) -> float:
        if n > self.degree:
            return 0.0
        return float(math.comb(self.degree, n)) * self.r ** (self.degree - n)

    def f(self, x):
        return (x + self.r) ** self.degree

    def fprime(self, x):
        return self.degree * (x + self.r) ** (self.degree - 1)


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

    def f(self, x):
        if _host(x):
            return np.exp(np.asarray(x, dtype=np.float64) / self.sigma2)
        return torch.exp(x / self.sigma2)

    def fprime(self, x):
        return self.f(x) / self.sigma2


@dataclasses.dataclass(frozen=True)
class VovkRealKernel(DotProductKernel):
    """Vovk's real polynomial kernel ``(1 - x^p) / (1 - x) = sum_{n<p} x^n``."""

    degree: int = 10

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"vovk_real{self.degree}"

    def coef(self, n: int) -> float:
        return 1.0 if n < self.degree else 0.0

    def f(self, x):
        # the series form: stable at x == 1
        return _horner(x, [1.0] * self.degree)

    def fprime(self, x):
        return _horner(x, [float(n) for n in range(1, self.degree)])


@dataclasses.dataclass(frozen=True)
class VovkInfiniteKernel(DotProductKernel):
    """Vovk's infinite polynomial kernel ``1 / (1 - x)`` (radius 1)."""

    radius: float = 1.0

    @property
    def name(self) -> str:  # type: ignore[override]
        return "vovk_infinite"

    def coef(self, n: int) -> float:
        return 1.0

    def f(self, x):
        return 1.0 / (1.0 - x)

    def fprime(self, x):
        return 1.0 / (1.0 - x) ** 2


@dataclasses.dataclass(frozen=True)
class MaclaurinKernel(DotProductKernel):
    """Generic kernel from a user-supplied coefficient function.

    ``f``/``fprime`` fall back to series evaluation (``series_terms``
    terms; float64 on the host, the tensor's dtype on a tensor) when no
    closed form is given.
    """

    coef_fn: Callable[[int], float] = lambda n: 0.0
    f_fn: Optional[Callable] = None
    fprime_fn: Optional[Callable] = None
    label: str = "custom"
    radius: float = np.inf
    series_terms: int = 64

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"maclaurin_{self.label}"

    def coef(self, n: int) -> float:
        return float(self.coef_fn(n))

    def f(self, x):
        if self.f_fn is not None:
            return self.f_fn(x)
        return _horner(x, self.coefs(self.series_terms))

    def fprime(self, x):
        if self.fprime_fn is not None:
            return self.fprime_fn(x)
        cs = self.coefs(self.series_terms)
        return _horner(x, [n * cs[n] for n in range(1, self.series_terms + 1)])


def kernel_from_name(name: str, **kwargs) -> DotProductKernel:
    """Config-friendly constructor: 'exp', 'poly', 'homogeneous', 'vovk_real',
    'vovk_infinite'."""
    name = name.lower()
    if name in ("exp", "exponential", "exp_dot"):
        return ExponentialDotProductKernel(**kwargs)
    if name in ("poly", "polynomial"):
        return PolynomialKernel(**kwargs)
    if name in ("homogeneous", "homogeneous_poly", "hpoly"):
        return HomogeneousPolynomialKernel(**kwargs)
    if name == "vovk_real":
        return VovkRealKernel(**kwargs)
    if name == "vovk_infinite":
        return VovkInfiniteKernel(**kwargs)
    raise ValueError(f"unknown dot product kernel {name!r}")


def degree_measure(
    kernel: DotProductKernel,
    n_max: int,
    p: float = 2.0,
    kind: str = "geometric",
    min_degree: int = 0,
    radius: float = 1.0,
) -> np.ndarray:
    """Normalized measure q over degrees [0, n_max], zero where a_n == 0.

    ``kind``: ``"geometric"`` (paper), ``"geometric_ge2"`` (H0/1) or
    ``"proportional"`` (variance-optimal ``q_n ∝ a_n R^{2n}``). Returns a
    float64 ``[n_max + 1]`` array summing to 1. Degrees with ``a_n == 0``
    would give identically zero features, so they leave the support.
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
