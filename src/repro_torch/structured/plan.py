"""StructuredPlan — Hadamard-structured (HD) feature maps (port of
``repro.structured.plan``).

Choromanski & Sindhwani (2016) replace i.i.d. Rademacher rows with
structured stacks: each degree-n product slot applies

    P_j x = D2_j H D1_j x,

``D1_j, D2_j`` diagonal Rademacher signs and ``H`` the unnormalized
Sylvester Walsh-Hadamard matrix of size ``d_pad = 2^ceil(log2 d)``. One
stack gives ``d_pad`` columns per slot from ``2 d_pad`` signs, applied in
``O(d_pad log d_pad)`` by the butterfly transform. Every column is
distributed exactly like one RM Rademacher projection, so the budget split
and the ``sqrt(a_n / c_n)`` scales are RM's.

The plan arithmetic is host-side numpy, line for line the reference's.
Column layout:

    [ h01 const | h01 identity block | degree-0 const
      | random columns, buckets ascending ]

Bucket n funds ``ceil(c_n / d_pad)`` stacks; the surplus ``S_n d_pad -
c_n`` columns of its last stack are computed with scale 0 and never
written by ``apply_structured_plan``. The padded section runs as ONE
launch of kernel B8 (``kernels.structured_feature``) on a CUDA tensor,
which writes each bucket's kept columns into their place in the map, or
its plain PyTorch version on a CPU tensor, with the same routing; the
dense-H path in ``structured.ref`` is the oracle the tests hold it
against.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.maclaurin import DotProductKernel, degree_measure
from repro_torch.core.plan import (
    BIAS_TAIL_DEGREES,
    allocate_features,
    plan_columns,
    plan_from_json,
    plan_to_json,
    prefix_columns,
    truncation_bias,
)

__all__ = [
    "StructuredPlan",
    "make_structured_plan",
    "init_structured_params",
    "pack_structured",
    "structured_keep",
    "apply_structured_plan",
]


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


class StructuredPlan(NamedTuple):
    """Hashable Hadamard-structured plan (see the reference for field
    notes). ``degrees``/``counts``/``scales`` describe the degree >= 1 real
    buckets (ascending), each backed by ``ceil(counts[i] / d_pad)`` stacks
    per degree slot."""

    degrees: Tuple[int, ...]
    counts: Tuple[int, ...]
    scales: Tuple[float, ...]
    const: float
    h01: bool
    h01_a0: float
    h01_a1: float
    input_dim: int
    num_random: int
    coefs_host: Tuple[float, ...]
    seed: int

    @property
    def d_pad(self) -> int:
        """Hadamard size: the next power of two >= input_dim."""
        return _next_pow2(max(self.input_dim, 1))

    @property
    def stacks_per_bucket(self) -> Tuple[int, ...]:
        m = self.d_pad
        return tuple((c + m - 1) // m for c in self.counts)

    @property
    def total_stacks(self) -> int:
        return int(sum(self.stacks_per_bucket))

    @property
    def total_slots(self) -> int:
        """Sign rows backing the buckets: sum_n S_n * n."""
        return int(sum(s * n
                       for s, n in zip(self.stacks_per_bucket, self.degrees)))

    @property
    def max_degree(self) -> int:
        return max(self.degrees) if self.degrees else 0

    @property
    def num_prefix_columns(self) -> int:
        pre = 0
        if self.h01:
            pre += 1 + self.input_dim
        if self.const != 0.0:
            pre += 1
        return pre

    @property
    def num_random_cols(self) -> int:
        return int(sum(self.counts))

    @property
    def padded_num_cols(self) -> int:
        """Columns the fused launch computes: total_stacks * d_pad."""
        return self.total_stacks * self.d_pad

    @property
    def output_dim(self) -> int:
        return self.num_prefix_columns + self.num_random_cols

    def padded_column_degrees(self) -> np.ndarray:
        """Per PADDED column product depth, int32 ``[padded_num_cols]``."""
        m = self.d_pad
        deg = []
        for n, s in zip(self.degrees, self.stacks_per_bucket):
            deg.extend([n] * (s * m))
        return np.asarray(deg, dtype=np.int32)

    def padded_column_scales(self) -> np.ndarray:
        """Per PADDED column scale, float32 ``[padded_num_cols]``: the
        bucket scale on its first c_n columns, 0.0 on the surplus tail."""
        m = self.d_pad
        sc = []
        for scale, c, s in zip(self.scales, self.counts,
                               self.stacks_per_bucket):
            sc.extend([float(scale)] * c)
            sc.extend([0.0] * (s * m - c))
        return np.asarray(sc, dtype=np.float32)

    def truncation_bias(self, radius: float) -> float:
        return truncation_bias(self, radius)

    def to_json(self) -> str:
        return plan_to_json(self)

    @classmethod
    def from_json(cls, s: str) -> "StructuredPlan":
        return plan_from_json(cls, s)


def make_structured_plan(
    kernel: DotProductKernel,
    input_dim: int,
    num_features: int,
    *,
    p: float = 2.0,
    measure: str = "geometric",
    h01: bool = False,
    n_max: int = 24,
    radius: float = 1.0,
    stratified: bool = True,
    seed: int = 0,
) -> StructuredPlan:
    """Allocate structured features across degrees of the Maclaurin
    measure — the reference's arithmetic, step for step: RM's degree
    measure, counts and scales over degrees >= 1 (>= 2 under H0/1)."""
    kernel.validate_positive_definite(n_max)
    if h01 and measure == "geometric":
        measure = "geometric_ge2"
    a0 = float(kernel.coef(0))
    a1 = float(kernel.coef(1))
    if h01 and a0 == 0.0 and a1 == 0.0:
        raise ValueError(
            f"H0/1 is a no-op for kernel {kernel.name}: a_0 = a_1 = 0 "
            "(e.g. homogeneous polynomial kernels — paper §6.2)."
        )
    min_degree = 2 if h01 else 1
    q = degree_measure(kernel, n_max, p=p, kind=measure, radius=radius,
                       min_degree=min_degree)
    coefs = kernel.coefs(n_max)
    coefs_diag = kernel.coefs(n_max + BIAS_TAIL_DEGREES)

    prefix = (1 + input_dim) if h01 else (1 if a0 > 0.0 else 0)
    budget = max(num_features - prefix, 0)
    counts_all, scales_all = allocate_features(
        coefs, q, budget, stratified=stratified, seed=seed
    )

    degrees, counts, scales = [], [], []
    for n in range(min_degree, n_max + 1):
        c = int(counts_all[n])
        if c > 0 and coefs[n] > 0.0:
            degrees.append(n)
            counts.append(c)
            scales.append(float(scales_all[n]))

    return StructuredPlan(
        degrees=tuple(degrees),
        counts=tuple(counts),
        scales=tuple(scales),
        const=float(np.sqrt(a0)) if (a0 > 0.0 and not h01) else 0.0,
        h01=h01,
        h01_a0=a0 if h01 else 0.0,
        h01_a1=a1 if h01 else 0.0,
        input_dim=input_dim,
        num_random=num_features,
        coefs_host=tuple(float(c) for c in coefs_diag),
        seed=seed,
    )


def init_structured_params(plan: StructuredPlan, generator: torch.Generator,
                           dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Diagonal Rademacher signs, on the generator's device: ``{"d1":
    [total_slots, d_pad], "d2": [total_slots, d_pad]}`` of exact +-1.

    Slot layout is bucket-major, then stack-major, then degree slot. The
    draws cannot reproduce the reference's ``jax.random`` bits; parity
    tests hand the reference's signs across instead.
    """
    bits = torch.randint(0, 2, (2, plan.total_slots, plan.d_pad),
                         generator=generator, device=generator.device)
    signs = (2 * bits - 1).to(dtype)
    return {"d1": signs[0], "d2": signs[1]}


def pack_structured(plan: StructuredPlan, params: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat slots ``[total_slots, d_pad]`` x2 -> ``(d1, d2)``, each
    ``[max_degree, total_stacks, d_pad]`` and contiguous: stack i's slots
    are ``[0:stack_degree[i], i, :]``, unused slots zero."""
    m = plan.d_pad
    k = plan.max_degree

    def _pack(flat):
        parts = []
        off = 0
        for n, s in zip(plan.degrees, plan.stacks_per_bucket):
            rows = flat[off: off + s * n].reshape(s, n, m)
            off += s * n
            parts.append(torch.nn.functional.pad(rows, (0, 0, 0, k - n)))
        if not parts:
            return torch.zeros((k, 0, m), dtype=flat.dtype,
                               device=flat.device)
        return torch.cat(parts, dim=0).transpose(0, 1).contiguous()

    return _pack(params["d1"]), _pack(params["d2"])


@functools.lru_cache(maxsize=None)
def structured_keep(plan: StructuredPlan):
    """Where kernel B8 writes each stack in the plan's map: stack i of
    bucket n keeps its first ``min(d_pad, c_n - i d_pad)`` columns (the
    last stack's surplus tail is dropped) at their place after the prefix
    columns and the buckets before it (a
    ``kernels.structured_feature.StructuredKeep``)."""
    from repro_torch.kernels.structured_feature.ops import StructuredKeep

    m = plan.d_pad
    first, count = [], []
    off = plan.num_prefix_columns
    for c, s in zip(plan.counts, plan.stacks_per_bucket):
        for i in range(s):
            first.append(off + i * m)
            count.append(min(m, c - i * m))
        off += c
    return StructuredKeep(tuple(first), tuple(count))


def apply_structured_plan(
    plan: StructuredPlan,
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    precision=None,
    packed: Sequence[torch.Tensor] = None,
) -> torch.Tensor:
    """Featurize ``x [..., d] -> [..., plan.output_dim]`` (fp32).

    The map is allocated once: the prefix columns are exact fills written
    into it, and the padded structured section runs as ONE launch of
    ``kernels.structured_feature.structured_feature_fused`` (the kernel for
    a CUDA tensor, its plain version for a CPU tensor), which reads x at
    its true width ``d <= d_pad`` and treats the rest as zero, and writes
    each bucket's kept columns in place (``structured_keep``): no slice or
    concatenation follows. ``packed=(d1, d2)`` short-circuits
    ``pack_structured``. Under ``precision="bf16"`` x and the signs enter
    the launch in bf16 (the signs exactly), and accumulation stays fp32.
    """
    from repro_torch.common.dtypes import resolve_precision
    from repro_torch.kernels.structured_feature.ops import (
        structured_feature_fused,
    )

    if x.shape[-1] != plan.input_dim:
        raise ValueError(
            f"expected trailing dim {plan.input_dim}, got {tuple(x.shape)}")
    cdt = resolve_precision(precision).compute_dtype
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, plan.input_dim).float()
    out = torch.empty((xf.shape[0], plan.output_dim), dtype=torch.float32,
                      device=x.device)
    off = 0
    for col in prefix_columns(plan, xf, cdt):
        out[:, off: off + col.shape[1]] = col
        off += col.shape[1]
    if plan.num_random_cols:
        if packed is None:
            packed = pack_structured(plan, params)
        d1, d2 = (t.to(cdt) for t in packed)
        col_deg, col_scale = plan_columns(plan, x.device)
        structured_feature_fused(xf.to(cdt), d1, d2, col_deg, col_scale,
                                 out=out, keep=structured_keep(plan))
    return out.reshape(*batch_shape, plan.output_dim)
