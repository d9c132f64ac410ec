"""Shape-level analytic launch costs the obs kernel spans attach (port of
``repro.bench.roofline.launch_cost``; the dry-run roofline rows of that
module are still to be ported, ROADMAP.md queue A item 2).

The fused wrapper ops (``kernels/*/ops.py``) attach :func:`launch_cost`'s
FLOPs and HBM bytes to their ``kernel/*`` trace spans
(``repro_torch.obs.trace.kernel_scope``), so a Perfetto view of a serve
trace carries the analytic roofline next to every launch. The arithmetic
is the reference's, so both packages report the same numbers for the same
shapes.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["launch_cost"]


def launch_cost(kernel: str, *, batch: int, d: int, depth: int, f: int,
                dv: int = 0, t: int = 0,
                itemsize: int = 4) -> Dict[str, float]:
    """Analytic FLOPs + HBM bytes of one fused launch, from shapes alone.

    Upper-bound accounting (every feature column at the packed tensor's
    ``depth``). Families:

    * ``rm_feature`` / ``ctr_feature`` (and ``structured_feature``, which
      takes this branch with one weight tensor) — (batch, feature)-tiled
      product kernels: one x read, ``n_w`` packed weight tensors, fp32
      output.
    * ``tensor_sketch`` — adds the two [f, f] inverse-DFT operands and the
      stage-2 matmul FLOPs.
    * ``rm_attn_fused`` — the fused featurize+attention kernel: featurize
      FLOPs for q and k rows plus the chunked attention GEMMs; bytes
      stream q/k/v/w once and emit out + the (S, n) decode state.
    """
    if kernel == "rm_attn_fused":
        rows = batch * t
        feat_flops = 2.0 * 2 * rows * d * depth * f
        attn_flops = 4.0 * rows * f * (dv + 1)
        bytes_moved = (itemsize * (2 * rows * d + depth * f * d)
                       + 4.0 * rows * 2 * dv
                       + 4.0 * batch * (f * dv + f))
        flops = feat_flops + attn_flops
    else:
        n_w = 2 if kernel in ("ctr_feature", "tensor_sketch") else 1
        flops = 2.0 * n_w * batch * d * depth * f
        weight_elems = n_w * depth * f * d
        out_cols = 2 * f if kernel == "ctr_feature" else f
        if kernel == "tensor_sketch":
            flops += 4.0 * batch * f * f   # stage-2 inverse-DFT matmuls
            weight_elems += 2 * f * f
        bytes_moved = (itemsize * (batch * d + weight_elems)
                       + 4.0 * batch * out_cols)
    return {"flops": float(flops), "hbm_bytes": float(bytes_moved)}
