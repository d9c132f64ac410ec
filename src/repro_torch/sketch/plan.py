"""SketchPlan — TensorSketch plans for dot-product kernels (port of
``repro.sketch.plan``).

TensorSketch (Pham & Pagh, KDD 2013) approximates the degree-n component of
a dot product kernel ``f(<x,y>) = sum_n a_n <x,y>^n`` with the circular
convolution of ``n`` independent CountSketches:

    S_n(x) = IFFT( prod_{j<n} FFT( C_j x ) ),   E[<S_n(x), S_n(y)>] = <x,y>^n.

The plan arithmetic is host-side numpy, line for line the reference's, so
the port's plan for a config equals the reference's exactly. Column layout:

    [ h01 const | h01 identity block | degree-0 const | degree blocks asc ]

Frequency-domain packing (``pack_sketch``): the FFT is linear, so
``FFT(C_j x)[f] = <G_j[f], x>`` is a dense complex projection, and the whole
map is (i) a masked complex running product over degree slots followed by
(ii) one block-diagonal inverse-DFT product. ``apply_sketch_plan`` runs both
in ONE launch of kernel B6 (``kernels.tensor_sketch``) on a CUDA tensor, or
its plain PyTorch version on a CPU tensor; the ``torch.fft`` path in
``sketch.ref`` is the oracle the tests hold it against.
"""
from __future__ import annotations

import itertools
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
    "SketchPlan",
    "make_sketch_plan",
    "init_sketch_params",
    "pack_sketch",
    "apply_sketch_plan",
]


class SketchPlan(NamedTuple):
    """Hashable TensorSketch plan (see the reference for field notes).

    ``degrees``/``counts``/``scales`` describe the degree >= 1 sketch blocks
    (ascending): block n has sketch width ``counts[i]`` and block scale
    ``scales[i] = sqrt(a_n)``.
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
    def num_funcs(self) -> int:
        """CountSketch hash functions backing the blocks: sum_n n."""
        return int(sum(self.degrees))

    @property
    def max_degree(self) -> int:
        return max(self.degrees) if self.degrees else 0

    @property
    def num_sketch_cols(self) -> int:
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
        return self.num_prefix_columns + self.num_sketch_cols

    def column_degrees(self) -> np.ndarray:
        """Per sketch column product depth, int32 ``[num_sketch_cols]``."""
        deg = []
        for n, c in zip(self.degrees, self.counts):
            deg.extend([n] * c)
        return np.asarray(deg, dtype=np.int32)

    def column_scales(self) -> np.ndarray:
        """Per sketch column scale sqrt(a_n), float32 ``[num_sketch_cols]``."""
        sc = []
        for s, c in zip(self.scales, self.counts):
            sc.extend([float(s)] * c)
        return np.asarray(sc, dtype=np.float32)

    def block_starts(self) -> Tuple[int, ...]:
        """First sketch column of every degree block, then the column count:
        ``(0, c_1, c_1 + c_2, ..., num_sketch_cols)``. ``pack_sketch``'s
        inverse DFT is block-diagonal on exactly these blocks."""
        return tuple(itertools.accumulate(self.counts, initial=0))

    def truncation_bias(self, radius: float) -> float:
        return truncation_bias(self, radius)

    def to_json(self) -> str:
        return plan_to_json(self)

    @classmethod
    def from_json(cls, s: str) -> "SketchPlan":
        return plan_from_json(cls, s)


def make_sketch_plan(
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
) -> SketchPlan:
    """Allocate sketch widths across degrees of the Maclaurin measure — the
    reference's arithmetic, step for step. Widths are always deterministic
    largest-remainder rounding; ``stratified`` is accepted for protocol
    uniformity and ignored, ``seed`` is recorded on the plan."""
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
    counts_all, _ = allocate_features(coefs, q, budget, stratified=True,
                                      seed=seed)

    degrees, counts, scales = [], [], []
    for n in range(min_degree, n_max + 1):
        c = int(counts_all[n])
        if c > 0 and coefs[n] > 0.0:
            degrees.append(n)
            counts.append(c)
            scales.append(float(np.sqrt(coefs[n])))

    return SketchPlan(
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


def init_sketch_params(plan: SketchPlan, generator: torch.Generator,
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """CountSketch hash tensors for one plan instance, on the generator's
    device: ``{"h": int32 [num_funcs, d], "s": dtype [num_funcs, d]}``.

    Rows are block-major then slot-major; row values of block i lie in
    ``[0, counts[i])``, signs in {+-1}. The draws come from ``generator``
    and cannot reproduce the reference's ``jax.random`` bits; parity tests
    hand the reference's tables across instead (``repro_torch.convert``).
    """
    d = plan.input_dim
    dev = generator.device
    hs, ss = [], []
    for n, c in zip(plan.degrees, plan.counts):
        for _ in range(n):
            hs.append(torch.randint(0, c, (d,), generator=generator,
                                    device=dev, dtype=torch.int32))
            bits = torch.randint(0, 2, (d,), generator=generator, device=dev)
            ss.append((2 * bits - 1).to(dtype))
    if not hs:
        return {"h": torch.zeros((0, d), dtype=torch.int32, device=dev),
                "s": torch.zeros((0, d), dtype=dtype, device=dev)}
    return {"h": torch.stack(hs), "s": torch.stack(ss)}


def pack_sketch(plan: SketchPlan, params: Dict[str, torch.Tensor],
                dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    """Hash tensors -> fused tensors ``(wr, wi, mr, mi)`` on the tables'
    device.

    * ``wr/wi [max_degree, Fs, d]``: column f of block (n, c) with local
      frequency ``fl`` and slot j holds ``s_j(i) * exp(-2 pi i fl h_j(i) /
      c)``; slots ``j >= n`` are zero.
    * ``mr/mi [Fs, Fs]``: the block-diagonal inverse DFT, ``M[g, f] =
      exp(+2 pi i g f / c) / c`` within a block, 0 across blocks.

    As in the reference, phase indices are reduced mod c in int32 BEFORE
    the angle (exact: ``f * h < c^2 < 2^31``), and angles, cos and sin are
    computed in ``dtype`` (fp32 by default; callers round the result to
    a storage dtype once).
    """
    d = plan.input_dim
    k = plan.max_degree
    fs = plan.num_sketch_cols
    h_all = params["h"]
    dev = h_all.device
    wr = torch.zeros((k, fs, d), dtype=dtype, device=dev)
    wi = torch.zeros((k, fs, d), dtype=dtype, device=dev)
    mr = torch.zeros((fs, fs), dtype=dtype, device=dev)
    mi = torch.zeros((fs, fs), dtype=dtype, device=dev)
    col = 0
    row = 0
    for n, c in zip(plan.degrees, plan.counts):
        freqs = torch.arange(c, dtype=torch.int32, device=dev)
        for j in range(n):
            h = h_all[row + j].to(torch.int32)
            s = params["s"][row + j].to(dtype)
            ph = (freqs[:, None] * h[None, :]) % c            # [c, d] exact
            ang = (2.0 * np.pi / c) * ph.to(dtype)
            wr[j, col:col + c] = s[None, :] * torch.cos(ang)
            wi[j, col:col + c] = -s[None, :] * torch.sin(ang)
        gf = (freqs[:, None] * freqs[None, :]) % c            # [c, c] exact
        ang = (2.0 * np.pi / c) * gf.to(dtype)
        mr[col:col + c, col:col + c] = torch.cos(ang) / c
        mi[col:col + c, col:col + c] = torch.sin(ang) / c
        col += c
        row += n
    return wr, wi, mr, mi


def apply_sketch_plan(
    plan: SketchPlan,
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    precision=None,
    packed: Sequence[torch.Tensor] = None,
) -> torch.Tensor:
    """Featurize ``x [..., d] -> [..., plan.output_dim]`` (fp32).

    The prefix columns (h01 block, degree-0 const) are exact fills; the
    sketch blocks run as ONE launch of ``kernels.tensor_sketch.
    tensor_sketch_fused`` (the kernel for a CUDA tensor, its plain version
    for a CPU tensor). ``packed=(wr, wi, mr, mi)`` short-circuits
    ``pack_sketch`` for callers that pack once per weight set. Under
    ``precision="bf16"`` x and the four packed tensors enter the launch in
    bf16 (accumulation stays fp32); the packing itself runs in fp32.
    """
    from repro_torch.common.dtypes import resolve_precision
    from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused

    if x.shape[-1] != plan.input_dim:
        raise ValueError(
            f"expected trailing dim {plan.input_dim}, got {tuple(x.shape)}")
    cdt = resolve_precision(precision).compute_dtype
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, plan.input_dim).float()
    feats = prefix_columns(plan, xf, cdt)
    if plan.num_sketch_cols:
        if packed is None:
            packed = pack_sketch(plan, params)
        wr, wi, mr, mi = (t.to(cdt) for t in packed)
        col_deg, col_scale = plan_columns(plan, x.device)
        feats.append(tensor_sketch_fused(xf.to(cdt), wr, wi, col_deg, mr,
                                         mi, col_scale, plan.block_starts()))
    out = torch.cat(feats, dim=-1)
    return out.reshape(*batch_shape, out.shape[-1])
