"""Theorem 12 / Theorem 16 constants and required-D calculators (port of
``repro.core.bounds``, numpy only, the reference's arithmetic line for line).

All quantities follow the paper's notation:

  * domain ``Omega ⊆ B_1(0, R)`` in R^d,
  * estimator bound   ``C_Omega = p * f(p R^2)``                (Lemma 8)
  * kernel Lipschitz  ``R f'(R^2)``                             (Lemma 10)
  * estimator Lip.    ``p^2 R sqrt(d) f'(p R^2)``               (Lemma 11)
  * L = sum of the two                                           (§4.1)
  * failure prob     ``2 (32 R L / eps)^{2d} exp(-D eps^2 / (8 C^2))``

plus the beyond-paper constant for the ``proportional`` degree measure
(q_n ∝ a_n R^{2n}): there every feature satisfies
``|Z(x)Z(y)| <= sum_n a_n R^{2n} = f(R^2)`` — strictly smaller than the
paper's ``p f(p R^2)``, shrinking required D by the squared ratio.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.maclaurin import DotProductKernel

__all__ = ["HoeffdingConstants", "constants_for", "required_num_features",
           "pointwise_failure_prob", "uniform_failure_prob",
           "pairwise_eps", "required_features_for_pairs"]

# Shared floor for the covering ratio 32 R L / eps.  Both directions of the
# Theorem 12 bound (required_d forward, uniform_failure_prob backward) MUST
# floor identically, otherwise the round trip
# ``uniform_failure_prob(consts, required_d(eps, delta), eps) <= delta``
# breaks for large eps where the ratio drops below 1 (one side would use a
# positive log-cover, the other a hugely negative one).
_COVER_RATIO_FLOOR = 2.0


def _require_positive(name: str, value: float) -> None:
    if not value > 0.0:
        raise ValueError(f"{name} must be > 0, got {name}={value!r}")


def _require_delta(delta: float) -> None:
    if not 0.0 < delta < 1.0:
        raise ValueError(
            f"delta must be a failure probability in (0, 1), got "
            f"delta={delta!r}")


def _require_n_pairs(n_pairs: int) -> None:
    if n_pairs < 1:
        raise ValueError(
            f"n_pairs must be >= 1 (a union bound over zero pairs is "
            f"vacuous), got n_pairs={n_pairs!r}")


@dataclasses.dataclass(frozen=True)
class HoeffdingConstants:
    """All the constants entering Theorem 12 for one (kernel, domain) pair."""

    radius: float
    dim: int
    p: float
    c_omega: float          # paper estimator bound  p f(pR^2)
    c_proportional: float   # beyond-paper bound     f(R^2)
    lipschitz: float        # L of §4.1

    def _c(self, measure: str) -> float:
        return self.c_omega if measure == "geometric" else self.c_proportional

    def _log_cover(self, eps: float) -> float:
        """Log of the Theorem 12 covering term, floored consistently for
        BOTH directions of the bound (see ``_COVER_RATIO_FLOOR``)."""
        ratio = 32.0 * self.radius * self.lipschitz / eps
        return 2.0 * self.dim * math.log(max(ratio, _COVER_RATIO_FLOOR))

    def _log_uniform_failure(self, num_features: int, eps: float,
                             measure: str) -> float:
        c = self._c(measure)
        return (math.log(2.0) + self._log_cover(eps)
                - num_features * eps**2 / (8.0 * c**2))

    def required_d(self, eps: float, delta: float, measure: str = "geometric") -> int:
        _require_positive("eps", eps)
        _require_delta(delta)
        c = self._c(measure)
        d_req = 8.0 * c**2 / eps**2 * (self._log_cover(eps) + math.log(2.0 / delta))
        d = max(int(math.ceil(d_req)), 1)
        # The ceil can land within float slop of the boundary (observed at
        # D ~ 1e15: failure prob = delta * (1 + 3e-13)); bump until the
        # round trip uniform_failure_prob(required_d(...)) <= delta holds
        # exactly rather than approximately.  The guard must exponentiate
        # the same way uniform_failure_prob does — comparing in log space
        # admits one-ulp regressions after exp().
        while math.exp(
                min(self._log_uniform_failure(d, eps, measure), 50.0)
        ) > delta:
            d = int(math.ceil(d * (1.0 + 1e-12))) + 1
        return d

    def eps_at(self, num_features: int, delta: float,
               measure: str = "geometric", *, tol: float = 1e-12) -> float:
        """Invert :meth:`required_d`: the smallest uniform error ``eps``
        Theorem 12 certifies at budget ``num_features``.

        ``required_d`` is strictly decreasing in eps (the Hoeffding
        exponent dominates the log-covering term), so the inverse is a
        bisection; the defining round-trip property — pinned by
        tests/test_bounds_roundtrip.py — is::

            required_d(eps, delta) <= D  =>  eps_at(D, delta) <= eps

        i.e. asking for the budget the bound demands always buys back an
        error guarantee at least as tight as requested.
        """
        if num_features <= 0:
            raise ValueError(f"num_features must be positive, "
                             f"got {num_features}")
        _require_delta(delta)

        def _ok(eps: float) -> bool:
            return self.required_d(eps, delta, measure) <= num_features

        lo, hi = tol, 1.0
        while not _ok(hi):            # error certs can exceed 1 at tiny D
            hi *= 2.0
            if hi > 1e12:
                raise ValueError(
                    f"no meaningful eps at D={num_features} "
                    f"(delta={delta}): bound exceeds 1e12")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _ok(mid):
                hi = mid
            else:
                lo = mid
            if hi - lo <= tol * max(1.0, hi):
                break
        return hi

    def pairwise_eps(self, num_features: int, n_pairs: int, delta: float,
                     measure: str = "geometric") -> float:
        """Hoeffding + union error bound over a FIXED set of ``n_pairs``
        pairs at budget D (no epsilon-net): the exact inversion of
        ``pointwise_failure_prob`` with ``delta / n_pairs`` per pair::

            eps(D, delta) = sqrt(8 C^2 log(2 n_pairs / delta) / D)

        This is the monitor-facing bound — ``obs.DriftMonitor`` watches
        specific sentinel pairs, not the whole domain, so it delegates
        here rather than to the Theorem 12 covering bound.
        """
        if num_features <= 0:
            raise ValueError(f"num_features must be positive, "
                             f"got {num_features}")
        _require_n_pairs(n_pairs)
        _require_delta(delta)
        c = self._c(measure)
        return math.sqrt(
            8.0 * c * c * math.log(2.0 * n_pairs / delta) / num_features)

    def required_features_for_pairs(self, eps: float, n_pairs: int,
                                    delta: float,
                                    measure: str = "geometric") -> int:
        """Inverse of :meth:`pairwise_eps`: D such that the fixed-pair
        union bound certifies error <= eps w.p. >= 1 - delta.

        The returned D is clamped to >= 1: for huge eps the raw formula
        rounds to 0, which is invalid downstream as a feature budget.
        """
        _require_positive("eps", eps)
        _require_n_pairs(n_pairs)
        _require_delta(delta)
        c = self._c(measure)
        return max(int(math.ceil(
            8.0 * c * c * math.log(2.0 * n_pairs / delta) / eps**2)), 1)


def constants_for(
    kernel: DotProductKernel, radius: float, dim: int, p: float = 2.0
) -> HoeffdingConstants:
    r2 = radius**2
    if np.isfinite(kernel.radius) and p * r2 >= kernel.radius:
        raise ValueError(
            f"p*R^2 = {p * r2:g} exceeds the series radius {kernel.radius:g} "
            f"of {kernel.name}; rescale the data (paper §3, choose c > I/gamma)."
        )
    f_pr2 = float(kernel.f(p * r2))
    fp_r2 = float(kernel.fprime(r2))
    fp_pr2 = float(kernel.fprime(p * r2))
    c_omega = p * f_pr2
    c_prop = float(kernel.f(r2))
    lipschitz = radius * fp_r2 + p**2 * radius * math.sqrt(dim) * fp_pr2
    return HoeffdingConstants(
        radius=radius,
        dim=dim,
        p=p,
        c_omega=c_omega,
        c_proportional=c_prop,
        lipschitz=lipschitz,
    )


def pairwise_eps(
    kernel: DotProductKernel, radius: float, dim: int, num_features: int,
    n_pairs: int, delta: float, p: float = 2.0,
    measure: str = "geometric",
) -> float:
    """Module-level convenience for ``constants_for(...).pairwise_eps``."""
    return constants_for(kernel, radius, dim, p).pairwise_eps(
        num_features, n_pairs, delta, measure)


def required_features_for_pairs(
    kernel: DotProductKernel, radius: float, dim: int, eps: float,
    n_pairs: int, delta: float, p: float = 2.0,
    measure: str = "geometric",
) -> int:
    """Module-level convenience for
    ``constants_for(...).required_features_for_pairs``."""
    return constants_for(kernel, radius, dim, p).required_features_for_pairs(
        eps, n_pairs, delta, measure)


def pointwise_failure_prob(
    consts: HoeffdingConstants, num_features: int, eps: float,
    measure: str = "geometric",
) -> float:
    """Hoeffding bound for a single pair (x, y)."""
    c = consts.c_omega if measure == "geometric" else consts.c_proportional
    return 2.0 * math.exp(-num_features * eps**2 / (8.0 * c**2))


def uniform_failure_prob(
    consts: HoeffdingConstants, num_features: int, eps: float,
    measure: str = "geometric",
) -> float:
    """Theorem 12's uniform bound over the whole domain (can exceed 1).

    Shares the covering-ratio floor with :meth:`HoeffdingConstants.required_d`
    (``_COVER_RATIO_FLOOR``), so the round trip
    ``uniform_failure_prob(consts, required_d(eps, delta), eps) <= delta``
    holds for every eps, including large eps where the ratio drops below 1.
    """
    log_p = consts._log_uniform_failure(num_features, eps, measure)
    return math.exp(min(log_p, 50.0))


def required_num_features(
    kernel: DotProductKernel,
    radius: float,
    dim: int,
    eps: float,
    delta: float,
    p: float = 2.0,
    measure: str = "geometric",
) -> int:
    """D such that Theorem 12 guarantees sup error <= eps w.p. >= 1 - delta."""
    return constants_for(kernel, radius, dim, p).required_d(eps, delta, measure)
