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
The ctr kernel (``csrc/ctr_feature.cu``, B7) takes B1's 64 x 64 tile with
three staged slices (x, wr, wi: 25,344 bytes of static shared memory), so
it needs no choice either; the structured kernel (``csrc/structured_feature.cu``, B8) takes
a row tile of one Hadamard stack a block (:func:`pick_structured_rows`).
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
    "STRUCTURED_MAX_DPAD",
    "check_structured_d_pad",
    "pick_structured_rows",
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
# Elements (rows x Hadamard size) one structured block may hold: 32 fp32
# register slots a thread of 256 and a 32 KB shared-memory butterfly buffer
# (``kMaxElems`` in csrc/structured_feature.cu). A block holds at least
# one row, so this is also the largest d_pad the kernel takes.
STRUCTURED_MAX_DPAD = 8192
# Elements a structured block takes where d_pad allows: 4 register slots a
# thread, 48 registers, so several blocks share an SM (an 8192-element
# block takes 178 registers, one block an SM, and its butterfly barriers
# then stall the SM).
STRUCTURED_TILE_ELEMS = 1024
# Threads of a structured block: the smallest row tile keeps them all busy.
_STRUCTURED_THREADS = 256


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


def check_structured_d_pad(m: int) -> None:
    """Raises ValueError unless the structured kernel takes Hadamard size
    ``m``: a power of two no larger than :data:`STRUCTURED_MAX_DPAD`."""
    if m < 1 or m & (m - 1) or m > STRUCTURED_MAX_DPAD:
        raise ValueError(
            f"structured kernel: d_pad={m} must be a power of two no larger "
            f"than {STRUCTURED_MAX_DPAD} (a block holds at least one row's "
            "transform)")


def pick_structured_rows(m: int, b: int, stacks: int) -> int:
    """Row tile R of the structured kernel (grid = row tiles x stacks) for
    Hadamard size ``m``.

    A block holds ``R * m <= STRUCTURED_TILE_ELEMS`` elements (one row,
    ``m`` elements, where ``m`` is larger), at most 64 rows. The largest
    power-of-two R whose grid fills the card (``ceil(b / R) * stacks >=
    NUM_SMS``) wins; when none does (a decode batch), the smallest R that
    still gives every thread an element, for the most blocks in flight.

    Raises:
        ValueError: as :func:`check_structured_d_pad`.
    """
    check_structured_d_pad(m)
    r_max = max(1, min(64, STRUCTURED_TILE_ELEMS // m))
    r_min = min(r_max, max(1, _STRUCTURED_THREADS // m))
    r = r_max
    while r > r_min and -(-b // r) * stacks < NUM_SMS:
        r //= 2
    return r
