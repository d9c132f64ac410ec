"""FeaturePlan — the RM feature-map plan (port of ``repro.core.plan``).

Host-side numpy arithmetic, line for line the reference's, so the port's
plan for a config equals the reference's exactly (degrees, counts, scales,
column vectors; pinned by tests/test_torch_plan.py). The plan fixes the
column layout of the feature vector

    [ h01 const | h01 identity block | degree-0 const | degree buckets asc ]

and, for the fused kernels, every column f is

    z_f(x) = col_scale[f] * prod_{j < col_degree[f]} <W[j, f, :], x>

with ``W`` one ``[max_degree, F, d]`` tensor (``pack_omegas``).
"""
from __future__ import annotations

import json
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.maclaurin import DotProductKernel, degree_measure

__all__ = [
    "FeaturePlan",
    "BIAS_TAIL_DEGREES",
    "allocate_features",
    "make_feature_plan",
    "plan_output_dim",
    "init_omegas",
    "pack_omegas",
    "plan_to_json",
    "plan_from_json",
    "prefix_columns",
    "truncation_bias",
]

# Taylor coefficients carried beyond n_max in ``coefs_host`` (the
# reference's truncation-bias window; kept so plans compare equal).
BIAS_TAIL_DEGREES = 8

_PLAN_TUPLE_FIELDS = ("degrees", "counts", "scales", "coefs_host")


def plan_to_json(plan) -> str:
    """Any plan NamedTuple -> JSON carrying every field."""
    return json.dumps({f: getattr(plan, f) for f in plan._fields})


def plan_from_json(cls, s: str):
    d = json.loads(s)
    for f in _PLAN_TUPLE_FIELDS:
        if f in d:
            d[f] = tuple(d[f])
    return cls(**d)


def prefix_columns(plan, xf: torch.Tensor, compute_dtype) -> list:
    """The exact columns ahead of the random section of a sketch, ctr or
    structured plan, in order ``[h01 const | h01 identity block | degree-0
    const]``, for rows ``xf [B, d]`` (fp32): a list of fp32 tensors, empty
    when the plan has none. The identity block takes x rounded to
    ``compute_dtype``."""
    rows = xf.shape[0]
    cols = []
    if plan.h01:
        cols.append(torch.full((rows, 1), float(np.sqrt(plan.h01_a0)),
                               dtype=torch.float32, device=xf.device))
        cols.append(float(np.sqrt(plan.h01_a1))
                    * xf.to(compute_dtype).float())
    if plan.const != 0.0:
        cols.append(torch.full((rows, 1), plan.const, dtype=torch.float32,
                               device=xf.device))
    return cols


def truncation_bias(plan, radius: float) -> float:
    """Worst-case dropped-degree mass ``sum a_n R^{2n}`` (paper §4.2) of a
    sketch, ctr or structured plan, the tail window beyond n_max
    included: every degree with ``a_n > 0`` that neither a bucket nor an
    exact prefix column carries."""
    present = set(plan.degrees)
    if plan.const != 0.0:
        present.add(0)
    if plan.h01:
        present.update((0, 1))
    bias = 0.0
    for n, a_n in enumerate(plan.coefs_host):
        if a_n > 0.0 and n not in present:
            bias += a_n * radius ** (2 * n)
    return bias


def allocate_features(
    coefs: np.ndarray,
    q: np.ndarray,
    num_features: int,
    *,
    stratified: bool,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split a budget of ``num_features`` across degrees of measure ``q``.

    ``stratified=True``: counts ``round(D q_n)`` by largest remainder with
    weights ``sqrt(a_n / c_n)``. ``stratified=False``: paper Algorithm 1,
    iid draws ``N ~ q`` from ``Philox(seed)`` with weights
    ``sqrt(a_n / q_n) / sqrt(D)``. ``scales[n]`` is 0 where
    ``counts[n] == 0``.
    """
    if stratified:
        raw = q * num_features
        counts = np.floor(raw).astype(np.int64)
        deficit = num_features - int(counts.sum())
        if deficit > 0:
            order = np.argsort(-(raw - counts))
            counts[order[:deficit]] += 1
    else:
        rng = np.random.Generator(np.random.Philox(seed))
        draws = rng.choice(len(q), size=num_features, p=q)
        counts = np.bincount(draws, minlength=len(q)).astype(np.int64)

    scales = np.zeros(len(q), dtype=np.float64)
    nz = counts > 0
    if stratified:
        scales[nz] = np.sqrt(coefs[nz] / counts[nz])
    else:
        scales[nz] = np.sqrt(coefs[nz] / q[nz]) / np.sqrt(num_features)
    return counts, scales


class FeaturePlan(NamedTuple):
    """Hashable RM feature-map plan (see the reference for field notes)."""

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
        """Rademacher rows backing the random buckets: sum_n c_n * n."""
        return int(sum(c * n for c, n in zip(self.counts, self.degrees)))

    @property
    def max_degree(self) -> int:
        """Product depth of the packed layout (0 for a const-only plan)."""
        deg = max(self.degrees) if self.degrees else 0
        if self.h01:
            deg = max(deg, 1)
        return deg

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
        return self.num_prefix_columns + int(sum(self.counts))

    def column_degrees(self) -> np.ndarray:
        """Per-column product depth, int32 ``[output_dim]``."""
        deg = []
        if self.h01:
            deg.append(0)
            deg.extend([1] * self.input_dim)
        if self.const != 0.0:
            deg.append(0)
        for n, c in zip(self.degrees, self.counts):
            deg.extend([n] * c)
        return np.asarray(deg, dtype=np.int32)

    def column_scales(self) -> np.ndarray:
        """Per-column scale, float32 ``[output_dim]``."""
        sc = []
        if self.h01:
            sc.append(float(np.sqrt(self.h01_a0)))
            sc.extend([float(np.sqrt(self.h01_a1))] * self.input_dim)
        if self.const != 0.0:
            sc.append(float(self.const))
        for s, c in zip(self.scales, self.counts):
            sc.extend([float(s)] * c)
        return np.asarray(sc, dtype=np.float32)

    def truncation_bias(self, radius: float) -> float:
        return truncation_bias(self, radius)

    def to_json(self) -> str:
        return plan_to_json(self)

    @classmethod
    def from_json(cls, s: str) -> "FeaturePlan":
        return plan_from_json(cls, s)


def make_feature_plan(
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
) -> FeaturePlan:
    """Construct the plan (Algorithm 1 / §6.1 H0/1 / beyond-paper
    measures) — the reference's arithmetic, step for step."""
    kernel.validate_positive_definite(n_max)
    if h01 and measure == "geometric":
        measure = "geometric_ge2"
    q = degree_measure(kernel, n_max, p=p, kind=measure, radius=radius,
                       min_degree=2 if h01 else 0)
    coefs = kernel.coefs(n_max)
    coefs_diag = kernel.coefs(n_max + BIAS_TAIL_DEGREES)

    counts_all, scales_all = allocate_features(
        coefs, q, num_features, stratified=stratified, seed=seed
    )

    const = 0.0
    if counts_all[0] > 0:
        # c_0 identical constant features collapse into one column of value
        # sqrt(c_0) * scale_0 (same second moment, fewer columns).
        const = float(np.sqrt(counts_all[0]) * scales_all[0])

    degrees, counts, scales = [], [], []
    for n in range(1, n_max + 1):
        if counts_all[n]:
            degrees.append(n)
            counts.append(int(counts_all[n]))
            scales.append(float(scales_all[n]))

    h01_a0 = h01_a1 = 0.0
    if h01:
        h01_a0 = float(kernel.coef(0))
        h01_a1 = float(kernel.coef(1))
        if h01_a0 == 0.0 and h01_a1 == 0.0:
            raise ValueError(
                f"H0/1 is a no-op for kernel {kernel.name}: a_0 = a_1 = 0 "
                "(e.g. homogeneous polynomial kernels — paper §6.2)."
            )

    return FeaturePlan(
        degrees=tuple(degrees),
        counts=tuple(counts),
        scales=tuple(scales),
        const=const,
        h01=h01,
        h01_a0=h01_a0,
        h01_a1=h01_a1,
        input_dim=input_dim,
        num_random=num_features,
        coefs_host=tuple(float(c) for c in coefs_diag),
        seed=seed,
    )


def plan_output_dim(plan: FeaturePlan) -> int:
    """Real output columns of ``apply_plan`` for this plan (prefix columns
    plus one column per allocated random feature)."""
    return plan.output_dim


def init_omegas(plan: FeaturePlan, generator: torch.Generator,
                dtype=torch.float32) -> torch.Tensor:
    """All Rademacher rows for one plan instance, flat ``[total_rows, d]``,
    on the generator's device.

    Row layout is bucket-major then feature-major. The draws come from
    ``generator`` and cannot reproduce the reference's ``jax.random``
    bits; parity tests hand the reference's omegas across instead
    (``repro_torch.convert``).
    """
    bits = torch.randint(0, 2, (plan.total_rows, plan.input_dim),
                         generator=generator, device=generator.device)
    return (2 * bits - 1).to(dtype)


def pack_omegas(plan: FeaturePlan, omegas: torch.Tensor) -> torch.Tensor:
    """Flat rows ``[total_rows, d]`` -> fused tensor ``[max_degree, F, d]``.

    Column f's product slots are ``W[0:col_degree[f], f, :]``; unused slots
    are zero. The H0/1 identity block occupies slot 0 with one-hot rows;
    const columns use no slots.
    """
    d = plan.input_dim
    k = plan.max_degree
    dtype, device = omegas.dtype, omegas.device
    parts = []
    if plan.h01:
        pre = torch.zeros((1 + d, k, d), dtype=dtype, device=device)
        if k > 0:
            pre[1:, 0, :] = torch.eye(d, dtype=dtype, device=device)
        parts.append(pre)
    if plan.const != 0.0:
        parts.append(torch.zeros((1, k, d), dtype=dtype, device=device))
    off = 0
    for n, c in zip(plan.degrees, plan.counts):
        rows = omegas[off: off + c * n].reshape(c, n, d)
        off += c * n
        parts.append(torch.nn.functional.pad(rows, (0, 0, 0, k - n)))
    if not parts:
        return torch.zeros((k, 0, d), dtype=dtype, device=device)
    packed = torch.cat(parts, dim=0)                  # [F, k, d]
    return packed.transpose(0, 1).contiguous()        # [k, F, d]


def _apply_plan_flat(plan: FeaturePlan, omegas: torch.Tensor,
                     xf: torch.Tensor, compute_dtype=torch.float32,
                     accum_dtype=torch.float32) -> torch.Tensor:
    """Plain flat apply: one ``x @ omegas.T`` + segmented products.

    Emits the fused column order (h01 const, identity block, const,
    buckets ascending). Operands are rounded to ``compute_dtype`` and then
    upcast, so the projection accumulates in ``accum_dtype`` (fp32) either
    way — the reference's precision contract.
    """
    xc = xf.to(compute_dtype).to(accum_dtype)
    n = xf.shape[0]
    feats = []
    if plan.h01:
        feats.append(torch.full((n, 1), float(np.sqrt(plan.h01_a0)),
                                dtype=accum_dtype, device=xf.device))
        feats.append(float(np.sqrt(plan.h01_a1)) * xc)
    if plan.const != 0.0:
        feats.append(torch.full((n, 1), plan.const, dtype=accum_dtype,
                                device=xf.device))
    if plan.total_rows:
        proj = xc @ omegas.to(compute_dtype).to(accum_dtype).T
        off = 0
        for deg, cnt, scale in zip(plan.degrees, plan.counts, plan.scales):
            rows = cnt * deg
            block = proj[:, off: off + rows].reshape(-1, cnt, deg)
            feats.append(torch.prod(block, dim=-1)
                         * torch.tensor(scale, dtype=accum_dtype))
            off += rows
    return torch.cat(feats, dim=-1)


def apply_plan(plan: FeaturePlan, omegas: torch.Tensor, x: torch.Tensor,
               precision=None, packed: torch.Tensor = None) -> torch.Tensor:
    """Featurize ``x [..., d] -> [..., plan.output_dim]`` in ONE launch of
    the fused map (``kernels.rm_feature.rm_feature_fused``: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor). ``packed``
    short-circuits ``pack_omegas`` for callers that pack once."""
    from repro_torch.common.dtypes import resolve_precision
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused

    if x.shape[-1] != plan.input_dim:
        raise ValueError(
            f"expected trailing dim {plan.input_dim}, got {tuple(x.shape)}")
    cdt = resolve_precision(precision).compute_dtype
    w = pack_omegas(plan, omegas) if packed is None else packed
    col_deg, col_scale = plan_columns(plan, x.device)
    batch_shape = x.shape[:-1]
    z = rm_feature_fused(x.reshape(-1, plan.input_dim).to(cdt), w.to(cdt),
                         col_deg, col_scale)
    return z.reshape(*batch_shape, z.shape[-1])


_COLUMNS_CACHE: dict = {}


def plan_columns(plan, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(col_deg int32 [F], col_scale fp32 [F])`` of any plan with
    ``column_degrees``/``column_scales`` (``FeaturePlan``, ``SketchPlan``,
    ``CtrPlan``), or of the padded columns of a ``StructuredPlan``
    (``padded_column_degrees``/``padded_column_scales``, the columns its
    kernel computes), as tensors on ``device``.

    Memoized per (plan type, plan, device): the decode loop asks for them
    once per layer and step, and a fresh host-to-device copy each time
    would synchronize the stream. (Plans are NamedTuples, so two plan
    types with equal fields would otherwise share an entry.) The tensors
    are made outside inference mode even when the first call comes from
    inside it, so a train step after an eval or a serve in the same
    process can save them for its backward.
    """
    device = torch.device(device)
    key = (type(plan).__name__, plan, str(device))
    cols = _COLUMNS_CACHE.get(key)
    if cols is None:
        if hasattr(plan, "padded_column_degrees"):
            deg, scale = (plan.padded_column_degrees(),
                          plan.padded_column_scales())
        else:
            deg, scale = plan.column_degrees(), plan.column_scales()
        with torch.inference_mode(False):
            cols = (torch.from_numpy(deg).to(device),
                    torch.from_numpy(scale).to(device))
        _COLUMNS_CACHE[key] = cols
    return cols
