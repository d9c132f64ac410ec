"""CtrPlan — complex-to-real (CtR) random features (port of
``repro.ctr.plan``).

Wacker, Kanagawa & Filippone (2022) draw COMPLEX Rademacher entries
``w_i ~ Uniform{1, i, -1, -i}``; the degree-n product feature

    z(x) = prod_{j < n} <w_j, x>,      E[ z(x) conj(z(y)) ] = <x, y>^n

stays unbiased with lower variance than real Rademacher products on
aligned pairs. Stacking ``[Re z | Im z]`` makes it a real feature map:
``<z_R(x), z_R(y)> = Re(z(x) conj(z(y)))``. At a matched REAL budget F the
plan funds ``(F - prefix) // 2`` complex features.

The plan arithmetic is host-side numpy, line for line the reference's, so
the port's plan for a config equals the reference's exactly. Column layout:

    [ h01 const | h01 identity block | degree-0 const
      | Re of complex columns, buckets ascending
      | Im of complex columns, buckets ascending ]

Degree 0 and the H0/1 prefix are exact fills outside the kernel; the
complex buckets run as ONE launch of kernel B7 (``kernels.ctr_feature``)
on a CUDA tensor, or its plain PyTorch version on a CPU tensor. The
``complex64`` path in ``ctr.ref`` is the oracle the tests hold it against.
"""
from __future__ import annotations

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
    "CtrPlan",
    "make_ctr_plan",
    "init_ctr_params",
    "pack_ctr",
    "apply_ctr_plan",
]


class CtrPlan(NamedTuple):
    """Hashable complex-to-real plan (see the reference for field notes).

    ``degrees``/``counts``/``scales`` describe the degree >= 1 COMPLEX
    buckets (ascending): bucket n holds ``counts[i]`` complex features of
    scale ``scales[i]``, each giving one Re and one Im real column.
    """

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
    def total_rows(self) -> int:
        """Complex Rademacher rows backing the buckets: sum_n c_n * n."""
        return int(sum(c * n for c, n in zip(self.counts, self.degrees)))

    @property
    def max_degree(self) -> int:
        return max(self.degrees) if self.degrees else 0

    @property
    def num_complex(self) -> int:
        return int(sum(self.counts))

    @property
    def num_prefix_columns(self) -> int:
        pre = 0
        if self.h01:
            pre += 1 + self.input_dim
        if self.const != 0.0:
            pre += 1
        return pre

    @property
    def output_dim(self) -> int:
        return self.num_prefix_columns + 2 * self.num_complex

    def column_degrees(self) -> np.ndarray:
        """Per COMPLEX column product depth, int32 ``[num_complex]``."""
        deg = []
        for n, c in zip(self.degrees, self.counts):
            deg.extend([n] * c)
        return np.asarray(deg, dtype=np.int32)

    def column_scales(self) -> np.ndarray:
        """Per COMPLEX column scale (both its Re and Im column), float32
        ``[num_complex]``."""
        sc = []
        for s, c in zip(self.scales, self.counts):
            sc.extend([float(s)] * c)
        return np.asarray(sc, dtype=np.float32)

    def truncation_bias(self, radius: float) -> float:
        return truncation_bias(self, radius)

    def to_json(self) -> str:
        return plan_to_json(self)

    @classmethod
    def from_json(cls, s: str) -> "CtrPlan":
        return plan_from_json(cls, s)


def make_ctr_plan(
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
) -> CtrPlan:
    """Allocate complex features across degrees of the Maclaurin measure —
    the reference's arithmetic, step for step: after the exact prefix
    columns, ``(F - prefix) // 2`` complex features split by
    ``allocate_features`` over degrees >= 1 (>= 2 under H0/1)."""
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
    budget = max((num_features - prefix) // 2, 0)
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

    return CtrPlan(
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


def init_ctr_params(plan: CtrPlan, generator: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Complex Rademacher rows as two real tensors, on the generator's
    device: ``{"wr": [total_rows, d], "wi": [total_rows, d]}`` with
    ``wr + i wi`` uniform over {1, i, -1, -i}.

    Each entry is drawn as an integer t in {0..3} and mapped as the
    reference maps it: t = 0 -> 1, 1 -> i, 2 -> -1, 3 -> -i (exact 0 / +-1
    floats, no cos/sin). Rows are bucket-major then feature-major. The
    draws cannot reproduce the reference's ``jax.random`` bits; parity
    tests hand the reference's rows across instead.
    """
    t = torch.randint(0, 4, (plan.total_rows, plan.input_dim),
                      generator=generator, device=generator.device)
    re = torch.tensor([1.0, 0.0, -1.0, 0.0], dtype=dtype, device=t.device)
    im = torch.tensor([0.0, 1.0, 0.0, -1.0], dtype=dtype, device=t.device)
    return {"wr": re[t], "wi": im[t]}


def pack_ctr(plan: CtrPlan, params: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat rows ``[total_rows, d]`` x2 -> ``(wr, wi)``, each
    ``[max_degree, num_complex, d]`` and contiguous: complex column f's
    slots are ``[0:col_degree[f], f, :]``, unused slots zero."""
    d = plan.input_dim
    k = plan.max_degree

    def _pack(flat):
        parts = []
        off = 0
        for n, c in zip(plan.degrees, plan.counts):
            rows = flat[off: off + c * n].reshape(c, n, d)
            off += c * n
            parts.append(torch.nn.functional.pad(rows, (0, 0, 0, k - n)))
        if not parts:
            return torch.zeros((k, 0, d), dtype=flat.dtype,
                               device=flat.device)
        return torch.cat(parts, dim=0).transpose(0, 1).contiguous()

    return _pack(params["wr"]), _pack(params["wi"])


def apply_ctr_plan(
    plan: CtrPlan,
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    precision=None,
    packed: Sequence[torch.Tensor] = None,
) -> torch.Tensor:
    """Featurize ``x [..., d] -> [..., plan.output_dim]`` (fp32).

    The prefix columns are exact fills; the complex buckets run as ONE
    launch of ``kernels.ctr_feature.ctr_feature_fused`` (the kernel for a
    CUDA tensor, its plain version for a CPU tensor). ``packed=(wr, wi)``
    short-circuits ``pack_ctr``. Under ``precision="bf16"`` x and the
    packed tensors enter the launch in bf16 — the values {0, +-1} are
    exact there, so only x is rounded — and accumulation stays fp32.
    """
    from repro_torch.common.dtypes import resolve_precision
    from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused

    if x.shape[-1] != plan.input_dim:
        raise ValueError(
            f"expected trailing dim {plan.input_dim}, got {tuple(x.shape)}")
    cdt = resolve_precision(precision).compute_dtype
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, plan.input_dim).float()
    feats = prefix_columns(plan, xf, cdt)
    if plan.num_complex:
        if packed is None:
            packed = pack_ctr(plan, params)
        wr, wi = (t.to(cdt) for t in packed)
        col_deg, col_scale = plan_columns(plan, x.device)
        feats.append(ctr_feature_fused(xf.to(cdt), wr, wi, col_deg,
                                       col_scale))
    if not feats:
        # a_0 = 0 and the halved budget funded no complex feature: a valid
        # 0-column map, as in the reference
        return torch.zeros((*batch_shape, 0), dtype=torch.float32,
                           device=x.device)
    out = torch.cat(feats, dim=-1)
    return out.reshape(*batch_shape, out.shape[-1])
