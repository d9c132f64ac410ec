"""Plain PyTorch paths for the TensorSketch estimator (port of
``repro.sketch.ref``).

* ``count_sketch_ref`` / ``tensor_sketch_blocks_ref`` — the textbook
  O(d + F log F) oracle: scatter-by-hash CountSketch, then ``torch.fft``
  product and inverse. The tests hold the fused map against it.
* ``tensor_sketch_fused_ref`` — the plain version of kernel B6: the same
  frequency-domain formulation on the ``pack_sketch`` tensors (complex
  masked running product, then the DENSE inverse-DFT product), in fp32.

Both emit the sketch-block section only; ``apply_sketch_plan`` adds the
prefix columns.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sketch.plan import SketchPlan

__all__ = [
    "count_sketch_ref",
    "tensor_sketch_blocks_ref",
    "tensor_sketch_fused_ref",
]


def count_sketch_ref(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
                     width: int) -> torch.Tensor:
    """One CountSketch: ``x [B, d] -> [B, width]``, ``C(x)[b, m] =
    sum_{i : h[i] == m} s[i] x[b, i]`` (duplicate buckets accumulate)."""
    vals = x * s[None, :].to(x.dtype)
    out = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    return out.index_add_(1, h.long(), vals)


def tensor_sketch_blocks_ref(plan: SketchPlan,
                             params: Dict[str, torch.Tensor],
                             x: torch.Tensor) -> torch.Tensor:
    """All degree blocks via FFT: ``x [B, d] -> [B, num_sketch_cols]``;
    block n is ``sqrt(a_n) * real(IFFT(prod_j FFT(C_j x)))``."""
    xf = x.float()
    feats = []
    row = 0
    for n, c, scale in zip(plan.degrees, plan.counts, plan.scales):
        prod = torch.ones((xf.shape[0], c), dtype=torch.complex64,
                          device=x.device)
        for j in range(n):
            cs = count_sketch_ref(xf, params["h"][row + j],
                                  params["s"][row + j], c)
            prod = prod * torch.fft.fft(cs, dim=-1)
        row += n
        feats.append(torch.fft.ifft(prod, dim=-1).real
                     * torch.tensor(scale, dtype=torch.float32))
    if not feats:
        return torch.zeros((xf.shape[0], 0), dtype=torch.float32,
                           device=x.device)
    return torch.cat(feats, dim=-1)


def tensor_sketch_fused_ref(
    x: torch.Tensor,          # [B, d]
    wr: torch.Tensor,         # [max_degree, Fs, d]
    wi: torch.Tensor,         # [max_degree, Fs, d]
    col_deg: torch.Tensor,    # [Fs] int32
    mr: torch.Tensor,         # [Fs, Fs] block-diagonal inverse DFT, real
    mi: torch.Tensor,         # [Fs, Fs] imag
    col_scale: torch.Tensor,  # [Fs]
) -> torch.Tensor:            # [B, Fs] fp32
    """Plain version of kernel B6; every operand is upcast to fp32."""
    xf = x.float()
    k, fs, _ = wr.shape
    ar = torch.ones((xf.shape[0], fs), dtype=torch.float32, device=x.device)
    ai = torch.zeros_like(ar)
    deg = col_deg.to(x.device)
    for j in range(k):
        pr = xf @ wr[j].float().T
        pi = xf @ wi[j].float().T
        keep = (j < deg)[None, :]
        nr = ar * pr - ai * pi
        ni = ar * pi + ai * pr
        ar = torch.where(keep, nr, ar)
        ai = torch.where(keep, ni, ai)
    z = ar @ mr.float().T - ai @ mi.float().T
    return z * col_scale.float()[None, :]
