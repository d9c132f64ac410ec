"""Plain PyTorch versions of the rm_feature kernels (port of
``repro.kernels.rm_feature.ref``).

``rm_feature_fused_ref`` (kernel B1's): column f of the output is

    z[b, f] = col_scale[f] * prod_{j < col_deg[f]} <w[j, f, :], x[b, :]>

Const columns (depth 0) reduce to their scale.

``rm_feature_bucket_ref`` (kernel B9's): one degree bucket, ``omega``
holding ``count * degree`` Rademacher rows feature-major; feature i is

    z[b, i] = scale * prod_{j < degree} <omega[i * degree + j, :], x[b, :]>

Inputs are upcast to fp32 before every product, so bf16 inputs accumulate
in fp32.
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


def rm_feature_bucket_ref(
    x: torch.Tensor,          # [B, d]
    omega: torch.Tensor,      # [count * degree, d]
    degree: int,
    scale: float,
) -> torch.Tensor:            # [B, count] fp32
    if degree < 1:
        raise ValueError("bucket oracle handles degree >= 1")
    count = omega.shape[0] // degree
    proj = x.float() @ omega.float().T                  # [B, count * degree]
    proj = proj.reshape(x.shape[0], count, degree)
    return torch.prod(proj, dim=-1) * torch.tensor(scale, dtype=torch.float32)
