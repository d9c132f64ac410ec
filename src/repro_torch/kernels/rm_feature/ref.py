"""Plain PyTorch version of the rm_feature kernel (port of
``repro.kernels.rm_feature.ref.rm_feature_fused_ref``).

Column f of the output is

    z[b, f] = col_scale[f] * prod_{j < col_deg[f]} <w[j, f, :], x[b, :]>

Const columns (depth 0) reduce to their scale. Inputs are upcast to fp32
before every product, so bf16 inputs accumulate in fp32.
"""
from __future__ import annotations

import torch


def rm_feature_fused_ref(
    x: torch.Tensor,          # [B, d]
    w: torch.Tensor,          # [max_degree, F, d]
    col_deg: torch.Tensor,    # [F] int32
    col_scale: torch.Tensor,  # [F]
) -> torch.Tensor:            # [B, F] fp32
    k = w.shape[0]
    proj = torch.einsum("bd,kfd->kbf", x.float(), w.float())
    slots = torch.arange(k, device=x.device)[:, None, None]
    mask = slots < col_deg.to(x.device)[None, None, :]
    prod = torch.prod(torch.where(mask, proj, torch.ones_like(proj)), dim=0)
    return prod * col_scale.float()
