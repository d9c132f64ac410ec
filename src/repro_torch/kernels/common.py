"""Tiling helpers shared by the hand-written Hopper kernels (port of
``repro.kernels.common``).

The reference sizes its Pallas tiles against a TPU VMEM budget. On Hopper
the limits are a block's shared memory (227 KB = 232,448 bytes after
``cudaFuncSetAttribute``) and its registers (65,536 per SM, at most 255 a
thread). Both kernels build their feature tiles with one device function
(``csrc/rm_featurize.cuh``): 256 threads, each holding a 4x4 register tile
of a 64-row by 64-feature output tile, staging 32-wide slices of x and of
the packed omegas in shared memory. Those constants are fixed by the CUDA
source and mirrored here. The rm_feature kernel's grid is one such 64 x 64
tile a block (16.9 KB of staging, 32 fp32 registers of running product and
partial sum a thread), so it needs no choice; the fused attention kernel's
chunk and value slice, and the tensor_sketch kernel's row tile (the
reference's ``get_batch_block``), are chosen below. The chunked attention
kernel (``csrc/rm_attention_chunked.cu``) has fixed 64-wide tiles and static
shared memory. The two non-causal kernels (``csrc/rm_fused_state.cu``, B3,
and ``csrc/rm_fused_apply.cu``, B4) take one 64-wide feature or query tile
a block and a value slice of up to 128 columns (:func:`noncausal_blocks`).
There is no autotune cache yet.
"""
from __future__ import annotations

from typing import Tuple

__all__ = [
    "SMEM_PER_BLOCK",
    "FEATURE_TILE",
    "STAGE_K",
    "round_up",
    "attention_smem_bytes",
    "pick_attention_blocks",
    "sketch_smem_bytes",
    "pick_sketch_rows",
    "noncausal_blocks",
]

# Hopper: the most dynamic shared memory one block may opt into.
SMEM_PER_BLOCK = 232_448
# Rows and feature columns of one featurize tile (16x16 threads x 4x4 each).
FEATURE_TILE = 64
# Width of the x / omega slices staged in shared memory per step over d.
STAGE_K = 32
# Lanes of a warp: the fused attention kernel maps one value column to each.
_WARP = 32
# Streaming multiprocessors of an H100 SXM: enough blocks to fill them.
NUM_SMS = 132
# Row tiles the tensor_sketch kernel is compiled for (16 rows x 1, 2 or 4
# rows a thread).
SKETCH_ROW_TILES = (64, 32, 16)
# Value columns one non-causal block accumulates: 16 thread columns x 8
# register slots (``kColSlots`` in csrc/rm_fused_state.cu and
# csrc/rm_fused_apply.cu).
NONCAUSAL_DV_BLOCK = 128


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return (x + m - 1) // m * m


def attention_smem_bytes(f_pad: int, chunk: int, dv_block: int) -> int:
    """Dynamic shared memory of one fused-causal block, in bytes.

    zq and zk of the chunk over ALL features (``chunk x (f_pad + 1)`` each,
    padded a column against bank conflicts), the carried state slice
    ``S [f_pad, dv_block]`` and ``n [f_pad]``, the featurize staging area
    (reused for the ``chunk x (chunk + 1)`` score tile) and the value slice
    ``[chunk, dv_block]``.
    """
    stage = max(2 * FEATURE_TILE * (STAGE_K + 1), chunk * (chunk + 1))
    floats = (2 * chunk * (f_pad + 1) + f_pad * dv_block + f_pad + stage
              + chunk * dv_block)
    return 4 * floats


def pick_attention_blocks(f: int, dv: int, t: int) -> Tuple[int, int]:
    """``(chunk, dv_block)`` for the fused causal kernel.

    One block owns ALL feature columns of one (batch*head, value slice), so
    the score, numerator and denominator sums over features finish inside
    the block and the causal mask is applied once, after the feature sum.
    The value axis is split into ``dv_block``-wide slices (one warp lane a
    column) to put several blocks on each batch*head. The largest chunk
    (at most one 64-row featurize tile, and no longer than the padded
    sequence) whose working set fits ``SMEM_PER_BLOCK`` wins.

    Raises:
        ValueError: no chunk fits — the feature axis is too wide for one
            block to own (a split with a second pass is future work).
    """
    f_pad = round_up(max(f, 1), FEATURE_TILE)
    dv_block = min(_WARP, max(dv, 1))
    cap = min(FEATURE_TILE, round_up(max(t, 1), 8))
    for chunk in (64, 32, 16, 8):
        if chunk > cap:
            continue
        if attention_smem_bytes(f_pad, chunk, dv_block) <= SMEM_PER_BLOCK:
            return chunk, dv_block
    raise ValueError(
        f"fused causal kernel: F={f} features do not fit one block's "
        f"{SMEM_PER_BLOCK} bytes of shared memory even at chunk 8")


def sketch_smem_bytes(rows: int, c_max: int) -> int:
    """Dynamic shared memory of one tensor_sketch block, in bytes.

    The staging area (x ``[rows, STAGE_K + 1]`` and two 64-column weight or
    inverse-DFT slices ``[64, STAGE_K + 1]``) and the block's complex
    running product ``Ar, Ai [rows, round_up(c_max, 64) + 1]``, kept for
    the inverse-DFT stage.
    """
    stage = (rows + 2 * FEATURE_TILE) * (STAGE_K + 1)
    acc = 2 * rows * (round_up(max(c_max, 1), FEATURE_TILE) + 1)
    return 4 * (stage + acc)


def pick_sketch_rows(c_max: int, b: int, n_blocks: int) -> int:
    """Row tile of the tensor_sketch kernel (grid = row tiles x degree
    blocks).

    The largest tile of :data:`SKETCH_ROW_TILES` whose shared memory fits
    :data:`SMEM_PER_BLOCK` and whose grid still fills the card
    (``ceil(b / rows) * n_blocks >= NUM_SMS``); when no tile fills it (a
    decode-sized batch), the smallest tile that fits, for the most blocks
    in flight.

    Raises:
        ValueError: the widest degree block does not fit one block's shared
            memory even at 16 rows.
    """
    fits = [r for r in SKETCH_ROW_TILES
            if sketch_smem_bytes(r, c_max) <= SMEM_PER_BLOCK]
    if not fits:
        raise ValueError(
            f"tensor_sketch kernel: a degree block of {c_max} columns does "
            f"not fit one block's {SMEM_PER_BLOCK} bytes of shared memory")
    for r in fits:
        if -(-b // r) * n_blocks >= NUM_SMS:
            return r
    return fits[-1]


def noncausal_blocks(dv: int) -> Tuple[int, int]:
    """``(dv_block, smem_bytes)`` for the non-causal kernels B3 and B4.

    A block accumulates ``[64, dv_block]`` of S (B3) or of the numerator
    (B4) in registers, one 64-row tile by 16 thread columns of up to 8
    values each, so ``dv_block`` is ``dv`` rounded up to 16, at most
    :data:`NONCAUSAL_DV_BLOCK` (a wider ``dv`` takes several value slices,
    each featurizing again). Shared memory holds the featurize staging
    area, the 64 x 64 feature tile (a column of padding against bank
    conflicts), the 64-row value or state tile and, for B4, ``n`` and the
    denominators of the tile: 54,528 bytes at ``dv = 80``, 66,816 at 128,
    so three blocks or more fit an SM's 227 KB (registers allow two).
    """
    dv_block = min(round_up(max(dv, 1), 16), NONCAUSAL_DV_BLOCK)
    floats = (2 * FEATURE_TILE * (STAGE_K + 1)
              + FEATURE_TILE * (FEATURE_TILE + 1)
              + FEATURE_TILE * dv_block + 2 * FEATURE_TILE)
    return dv_block, 4 * floats
