"""Online Gram-drift monitoring: the paper's (eps, delta) guarantee as a
live SLO (port of ``repro.obs.drift``).

A random feature map's promise is probabilistic: with probability
``1 - delta``, ``sup |<Z(x), Z(y)> - K(x, y)| <= eps`` at the deployed
budget D. :class:`DriftMonitor` holds a small reservoir of sentinel points
in the kernel's domain ball, and on every ``check()`` recomputes the
empirical ``sup |<Z(x), Z(y)> - K(x, y)|`` over all sentinel pairs with
the map's own ``estimate_gram`` on the map's device (so on the card a
check launches the family's featurize kernel: B1 for ``rm``, B6/B7/B8 for
``tensor_sketch``/``ctr``/``structured``), and compares it with the
per-pair Hoeffding + union bound at the map's D::

    eps(D, delta) = sqrt(8 C^2 log(2 n_pairs / delta) / D) + bias

where ``C`` is the measure-matched estimator bound
(``repro_torch.core.bounds``) and ``bias`` the plan's deterministic
truncation bias. ``Obs.tick_drift`` wires it to the metrics and the trace
(``drift/sup_err`` gauge, ``drift/violations`` counter,
``drift/violation`` event).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["DriftReport", "DriftMonitor", "GrowthRecommendation",
           "hoeffding_eps"]


def hoeffding_eps(kernel, radius: float, dim: int, num_features: int,
                  n_pairs: int, delta: float,
                  measure: str = "proportional") -> float:
    """Per-pair Hoeffding + union-over-pairs error bound at budget D: the
    inversion of the pointwise failure probability for a FIXED sentinel
    set of ``n_pairs`` pairs. A thin wrapper over
    ``core.bounds.pairwise_eps`` with the monitor's default measure, so the
    arithmetic lives in one place."""
    from repro_torch.core import bounds

    return bounds.pairwise_eps(kernel, radius, dim, num_features, n_pairs,
                               delta, measure=measure)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One ``check()`` result: the observed sup error vs the live bound."""

    sup_err: float
    eps_bound: float
    num_features: int
    n_pairs: int
    ok: bool


@dataclasses.dataclass(frozen=True)
class GrowthRecommendation:
    """``DriftMonitor.recommend()``'s answer to an (eps, delta) violation:
    double the budget. ``eps_bound_target`` is the envelope the monitor
    would hold the grown map to (tighter by ``1/sqrt(2)`` per doubling)."""

    num_features_now: int
    num_features_target: int
    eps_bound_now: float
    eps_bound_target: float
    sup_err: float
    reason: str


def _map_device(feature_map) -> torch.device:
    """The device a map's draws live on (its first tensor parameter; a
    ``GrowableFeatureMap`` holds a list of per-generation dicts)."""
    stack = [feature_map.params]
    while stack:
        p = stack.pop(0)
        if isinstance(p, torch.Tensor):
            return p.device
        if isinstance(p, (list, tuple)):
            stack[:0] = list(p)
        elif isinstance(p, dict):
            stack[:0] = list(p.values())
    return torch.device("cpu")


class DriftMonitor:
    """Watch a deployed feature map's Gram error against its (eps, delta)
    bound.

    Args:
        feature_map: any of the port's map objects (``estimate_gram`` +
            ``plan`` + ``output_dim`` — every family conforms, and so does
            ``core.doubling.GrowableFeatureMap``).
        kernel: the exact ``DotProductKernel`` the map approximates.
        delta: failure probability the bound is evaluated at.
        n_sentinels: reservoir size (16 sentinel points = 136 pairs).
        radius: domain ball radius the sentinels are drawn in.
        seed: sentinel draw seed (numpy ``default_rng``, the reference's
            draws bit for bit).
        measure: degree measure the map was built with (selects the
            estimator constant C).
        margin: multiplier on the bound before flagging.
    """

    def __init__(self, feature_map, kernel, *, delta: float = 0.05,
                 n_sentinels: int = 16, radius: float = 0.9, seed: int = 0,
                 measure: str = "proportional", margin: float = 1.0):
        self.fm = feature_map
        self.kernel = kernel
        self.delta = float(delta)
        self.radius = float(radius)
        self.measure = measure
        self.margin = float(margin)
        self.checks = 0
        self.violations = 0
        self.last: Optional[DriftReport] = None
        d = int(feature_map.plan.input_dim)
        rng = np.random.default_rng(seed)
        pts = rng.standard_normal((n_sentinels, d))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        # span radii up to R (not all on the shell): drift in low-degree
        # terms shows up at small radii, high-degree at the boundary
        pts *= np.linspace(0.3, 1.0, n_sentinels)[:, None] * self.radius
        self._sentinels = np.asarray(pts, np.float32)
        self._rng = rng

    @classmethod
    def for_estimator(cls, kernel, dim: int, num_features: int, *,
                      estimator: str = "rm", seed: int = 0,
                      measure: str = "proportional", device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **kwargs):
        """Draw a fresh map of ``estimator`` at budget D and monitor it.

        The map comes from the port's ``make_feature_map`` on ``device``
        (the card unless the caller asks for the CPU), its draws from
        ``generator``, or from a ``torch.Generator`` on ``device`` seeded
        with ``seed``. The monitor then watches a map drawn like the
        deployed one (same registry entry, measure and budget).
        """
        from repro_torch import resolve_device
        from repro_torch.core import make_feature_map

        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        fm = make_feature_map(kernel, dim, num_features, generator,
                              estimator=estimator, measure=measure,
                              device=dev)
        return cls(fm, kernel, measure=measure, **kwargs)

    @property
    def n_pairs(self) -> int:
        n = self._sentinels.shape[0]
        return n * (n + 1) // 2

    def ingest(self, rows) -> None:
        """Reservoir-sample live data rows (host arrays) into the sentinel
        set, clipped to the domain ball: each row replaces a uniformly
        random sentinel with probability ``1/4``."""
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        norms = np.linalg.norm(rows, axis=1, keepdims=True)
        scale = np.minimum(1.0, self.radius / np.maximum(norms, 1e-12))
        rows = rows * scale
        n = self._sentinels.shape[0]
        for row in rows:
            j = self._rng.integers(0, n * 4)
            if j < n:
                self._sentinels[j] = row

    def eps_bound(self) -> float:
        """The live (eps, delta) envelope at the monitored map's D."""
        stat = hoeffding_eps(
            self.kernel, self.radius, int(self.fm.plan.input_dim),
            int(self.fm.output_dim), self.n_pairs, self.delta,
            measure=self.measure)
        bias = float(self.fm.plan.truncation_bias(self.radius))
        return stat + bias

    def check(self) -> DriftReport:
        """Recompute the sup Gram error over the sentinels on the map's
        device and compare it with the bound."""
        X = torch.from_numpy(self._sentinels).to(_map_device(self.fm))
        G = self.fm.estimate_gram(X)
        K = self.kernel.gram(X)
        sup_err = float((G - K).abs().max())
        bound = self.eps_bound()
        ok = sup_err <= self.margin * bound
        self.checks += 1
        if not ok:
            self.violations += 1
        self.last = DriftReport(sup_err=sup_err, eps_bound=bound,
                                num_features=int(self.fm.output_dim),
                                n_pairs=self.n_pairs, ok=ok)
        return self.last

    def recommend(self) -> Optional[GrowthRecommendation]:
        """After a violating ``check()``, the doubled budget and the
        envelope it buys; None while the last check (or no check yet) is
        within the envelope."""
        if self.last is None or self.last.ok:
            return None
        now = int(self.fm.output_dim)
        target = 2 * now
        stat = hoeffding_eps(
            self.kernel, self.radius, int(self.fm.plan.input_dim),
            target, self.n_pairs, self.delta, measure=self.measure)
        bias = float(self.fm.plan.truncation_bias(self.radius))
        return GrowthRecommendation(
            num_features_now=now,
            num_features_target=target,
            eps_bound_now=self.last.eps_bound,
            eps_bound_target=stat + bias,
            sup_err=self.last.sup_err,
            reason=(f"sup_err={self.last.sup_err:.3g} exceeded "
                    f"eps_bound={self.last.eps_bound:.3g} at "
                    f"D={now}; double to D={target}"),
        )

    def rebind(self, feature_map) -> None:
        """Point the monitor at a grown or rebuilt map (same kernel and
        domain). The counters survive (growth is part of one monitored
        deployment), but the stale report is dropped so ``recommend()``
        does not fire again off the check made before the growth."""
        self.fm = feature_map
        self.last = None
