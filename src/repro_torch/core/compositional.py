"""Algorithm 2 — Random Maclaurin feature maps for compositional kernels
(port of ``repro.core.compositional``).

``K_co(x, y) = K_dp(K(x, y)) = f(K(x, y))`` for an arbitrary PD kernel K,
given black-box access to a routine A that returns *one-dimensional*
unbiased feature maps W for K: ``E[W(x) W(y)] = K(x, y)``, ``|W(x)| <=
sqrt(C_W)``.

Per output feature: draw ``N ~ q``, get N independent instantiations
``W_1..W_N`` from A, and emit ``Z(x) = sqrt(a_N / q_N) * prod_j W_j(x)``.

Inner maps provided:

  * ``RademacherInnerMap`` — W(x) = w.x with Rademacher w. Recovers
    Algorithm 1 exactly (the dot product composed into K_dp). A bucket of
    these is exactly kernel B9's contract (feature i is ``scale * prod_j
    <omega[i * deg + j], x>``, rows feature-major), so on a CUDA tensor
    each such bucket is one launch of B9
    (``kernels.rm_feature.rm_feature_bucket``) writing its columns of the
    map in place, and on a CPU tensor B9's plain version.
  * ``RFFInnerMap`` — Rahimi-Recht random Fourier features for the
    Gaussian kernel: W(x) = sqrt(2) cos(w.x + b), w ~ N(0, 1/sigma^2 I),
    b ~ U[0, 2pi). Bounded by sqrt(2), unbiased for
    exp(-|x-y|^2/2sigma^2). Its buckets are plain PyTorch on either device
    (a matrix product, cos, a product over the slots), as the reference
    computes them outside any Pallas kernel.

Draws come from a ``torch.Generator`` (on its device): a map made here is
not the reference's map from the same seed; ``repro_torch.convert``
carries the reference's draws across instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.maclaurin import DotProductKernel, degree_measure
from repro_torch.core.plan import allocate_features

__all__ = [
    "InnerMap",
    "RademacherInnerMap",
    "RFFInnerMap",
    "CompositionalFeatureMap",
    "make_compositional_feature_map",
]


class InnerMap:
    """A batch of M independent 1-d feature maps W for the inner kernel K.

    ``apply(x)`` returns ``[..., M]``: column j is W_j evaluated at x.
    """

    bound: float  # sqrt(C_W)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def exact_kernel(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to(self, device) -> "InnerMap":
        raise NotImplementedError


@dataclasses.dataclass
class RademacherInnerMap(InnerMap):
    """W_j(x) = <w_j, x>, w Rademacher — the dot product inner kernel."""

    omega: torch.Tensor  # [M, d]
    bound: float = math.inf  # bounded by R in B_1(0,R) only

    @staticmethod
    def create(generator: torch.Generator, num: int,
               dim: int) -> "RademacherInnerMap":
        """``num`` rows of +-1 drawn from ``generator``, on its device."""
        bits = torch.randint(0, 2, (num, dim), generator=generator,
                             device=generator.device)
        return RademacherInnerMap(omega=2.0 * bits.float() - 1.0)

    def apply(self, x):
        return x @ self.omega.T

    def exact_kernel(self, X, Y):
        return X @ Y.T

    def to(self, device):
        return dataclasses.replace(self, omega=self.omega.to(device))


@dataclasses.dataclass
class RFFInnerMap(InnerMap):
    """Rahimi-Recht random Fourier features for the Gaussian RBF kernel."""

    w: torch.Tensor  # [M, d]
    b: torch.Tensor  # [M]
    sigma: float = 1.0
    bound: float = float(np.sqrt(2.0))

    @staticmethod
    def create(generator: torch.Generator, num: int, dim: int,
               sigma: float = 1.0) -> "RFFInnerMap":
        """``w ~ N(0, I / sigma^2)`` and ``b ~ U[0, 2 pi)`` drawn from
        ``generator``, on its device."""
        dev = generator.device
        w = torch.randn((num, dim), generator=generator, device=dev) / sigma
        b = torch.rand((num,), generator=generator, device=dev) * (
            2.0 * np.pi)
        return RFFInnerMap(w=w, b=b, sigma=sigma)

    def apply(self, x):
        return math.sqrt(2.0) * torch.cos(x @ self.w.T + self.b)

    def exact_kernel(self, X, Y):
        sq = ((X**2).sum(-1)[:, None] + (Y**2).sum(-1)[None, :]
              - 2.0 * X @ Y.T)
        return torch.exp(-sq / (2.0 * self.sigma**2))

    def to(self, device):
        return dataclasses.replace(self, w=self.w.to(device),
                                   b=self.b.to(device))


@dataclasses.dataclass
class CompositionalFeatureMap:
    """Degree-bucketed Algorithm 2 map.

    For each allocated degree n there is an inner map batch with ``c_n * n``
    independent W's; feature i of the bucket is the product of its n
    columns ``i * n .. i * n + n - 1``. ``scales`` and ``const`` are fp32
    values held as Python floats (``const`` None without a degree-0
    column).
    """

    degrees: Tuple[int, ...]
    counts: Tuple[int, ...]
    inner_maps: List[InnerMap]
    scales: List[float]
    const: Optional[float]
    input_dim: int

    @property
    def output_dim(self) -> int:
        return sum(self.counts) + (1 if self.const is not None else 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x [..., input_dim] -> [..., output_dim]`` fp32, the map
        allocated once and each bucket written into its columns: a
        Rademacher bucket through ``rm_feature_bucket`` (kernel B9 on a
        CUDA tensor; x and its omega rows in x's dtype, fp32 or bf16), an
        RFF bucket in plain PyTorch."""
        from repro_torch.kernels.rm_feature import rm_feature_bucket

        batch_shape = x.shape[:-1]
        xf = x.reshape(-1, self.input_dim).contiguous()
        z = torch.empty((xf.shape[0], self.output_dim), dtype=torch.float32,
                        device=x.device)
        off = 0
        if self.const is not None:
            z[:, 0] = self.const
            off = 1
        for deg, cnt, inner, scale in zip(self.degrees, self.counts,
                                          self.inner_maps, self.scales):
            if isinstance(inner, RademacherInnerMap):
                rm_feature_bucket(xf, inner.omega.to(xf.dtype), deg, scale,
                                  out=z, col=off)
            else:
                w = inner.apply(xf).reshape(xf.shape[0], cnt, deg)
                z[:, off: off + cnt] = torch.prod(w, dim=-1) * scale
            off += cnt
        return z.reshape(*batch_shape, self.output_dim)

    def estimate_gram(self, X: torch.Tensor,
                      Y: Optional[torch.Tensor] = None) -> torch.Tensor:
        zx = self(X)
        zy = zx if Y is None else self(Y)
        return zx @ zy.T

    def to(self, device) -> "CompositionalFeatureMap":
        """The same map with its draws on ``device``."""
        return dataclasses.replace(
            self, inner_maps=[m.to(device) for m in self.inner_maps])


def make_compositional_feature_map(
    dp_kernel: DotProductKernel,
    inner_factory: Callable[[torch.Generator, int], InnerMap],
    input_dim: int,
    num_features: int,
    generator: torch.Generator,
    *,
    p: float = 2.0,
    measure: str = "geometric",
    n_max: int = 24,
    inner_bound: float = 1.0,
    stratified: bool = True,
) -> CompositionalFeatureMap:
    """Build Algorithm 2's map.

    ``inner_factory(generator, num) -> InnerMap`` returns a batch of
    ``num`` independent inner maps (black-box A of the paper), drawn from
    ``generator``. ``inner_bound`` is ``C_W`` and feeds the proportional
    measure (q_n ∝ a_n C_W^n). With ``stratified=False`` the degree draws'
    seed is drawn from ``generator`` first.
    """
    dp_kernel.validate_positive_definite(n_max)
    q = degree_measure(dp_kernel, n_max, p=p, kind=measure,
                       radius=np.sqrt(inner_bound))
    coefs = dp_kernel.coefs(n_max)
    seed = 0
    if not stratified:
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=generator.device))
    counts_all, scales_all = allocate_features(
        coefs, q, num_features, stratified=stratified, seed=seed)

    const = None
    if counts_all[0] > 0:
        const = float(np.float32(np.sqrt(counts_all[0]) * scales_all[0]))
    degrees: List[int] = []
    counts: List[int] = []
    inner_maps: List[InnerMap] = []
    scales: List[float] = []
    for n in range(1, n_max + 1):
        cnt = int(counts_all[n])
        if cnt == 0:
            continue
        inner_maps.append(inner_factory(generator, cnt * n))
        degrees.append(n)
        counts.append(cnt)
        scales.append(float(np.float32(scales_all[n])))
    return CompositionalFeatureMap(
        degrees=tuple(degrees), counts=tuple(counts), inner_maps=inner_maps,
        scales=scales, const=const, input_dim=input_dim)
