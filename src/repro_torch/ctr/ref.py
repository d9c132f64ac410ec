"""Plain PyTorch paths for the complex-to-real (CtR) estimator (port of
``repro.ctr.ref``).

* ``ctr_blocks_ref`` — the oracle: ONE flat ``complex64`` product
  ``x @ (wr + i wi)^T``, then segmented products per degree bucket. The
  tests hold the fused map against it.
* ``ctr_feature_fused_ref`` — the plain version of kernel B7: the masked
  complex running product on the ``pack_ctr`` tensors, in fp32.

Both emit the random section only, ``[Re of every complex column | Im of
every complex column]``, each column times its complex column's scale;
``apply_ctr_plan`` adds the prefix columns.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.ctr.plan import CtrPlan

__all__ = ["ctr_blocks_ref", "ctr_feature_fused_ref"]


def ctr_blocks_ref(plan: CtrPlan, params: Dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """All degree buckets via complex64: ``x [B, d] -> [B, 2 num_complex]``;
    complex feature i of bucket n is ``scale_n prod_{j<n} <w_ij, x>``."""
    xf = x.float()
    w = torch.complex(params["wr"].float(), params["wi"].float())
    if w.shape[0] == 0:
        return torch.zeros((xf.shape[0], 0), dtype=torch.float32,
                           device=x.device)
    proj = xf.to(torch.complex64) @ w.T                  # [B, rows]
    res, ims = [], []
    off = 0
    for n, c, scale in zip(plan.degrees, plan.counts, plan.scales):
        rows = c * n
        block = proj[:, off: off + rows].reshape(-1, c, n)
        z = torch.prod(block, dim=-1) * torch.tensor(scale,
                                                     dtype=torch.float32)
        res.append(z.real)
        ims.append(z.imag)
        off += rows
    return torch.cat(res + ims, dim=-1)


def ctr_feature_fused_ref(
    x: torch.Tensor,          # [B, d]
    wr: torch.Tensor,         # [max_degree, Fc, d] real part (pack_ctr)
    wi: torch.Tensor,         # [max_degree, Fc, d] imaginary part
    col_deg: torch.Tensor,    # [Fc] int32 per-column product depth
    col_scale: torch.Tensor,  # [Fc] per-complex-column scale
) -> torch.Tensor:            # [B, 2 Fc] fp32, [Re | Im]
    """Plain version of kernel B7; every operand is upcast to fp32.

    Column f of each half is ``col_scale[f] Re/Im(prod_{j < col_deg[f]}
    <wr[j, f] + i wi[j, f], x>)``.
    """
    xf = x.float()
    k, fc, _ = wr.shape
    ar = torch.ones((xf.shape[0], fc), dtype=torch.float32, device=x.device)
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
    sc = col_scale.float()[None, :]
    return torch.cat([ar * sc, ai * sc], dim=-1)
