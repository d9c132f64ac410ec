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
and ``csrc/rm_fused_apply.cu``, B4) run on the tensor cores
(``csrc/rm_featurize_mma.cuh``: 512 threads, a 64-row tile, the omega slab
resident in shared memory); a block walks several row tiles of one
batch*head row, and :func:`noncausal_schedule` picks how many, the value
and feature groups and the shared-memory layout.
The ctr kernel (``csrc/ctr_feature.cu``, B7) takes B1's 64 x 64 tile with
three staged slices (x, wr, wi: 25,344 bytes of static shared memory), so
it needs no choice either; the structured kernel (``csrc/structured_feature.cu``, B8) takes
a row tile of one Hadamard stack a block (:func:`pick_structured_rows`).
There is no autotune cache yet.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

__all__ = [
    "SMEM_PER_BLOCK",
    "FEATURE_TILE",
    "STAGE_K",
    "round_up",
    "attention_smem_bytes",
    "pick_attention_blocks",
    "sketch_smem_bytes",
    "pick_sketch_rows",
    "NoncausalSchedule",
    "noncausal_schedule",
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
# The non-causal kernels B3 and B4 (csrc/rm_featurize_mma.cuh): 64-row
# tiles, 8-column feature tiles (one mma n-tile), and a 4 x 4 grid of warps
# over the (16 x 8) accumulator tiles of the contraction: B3 holds up to
# 3 x 3 state tiles a warp (``kStateMI``, ``kStateNI``), B4 one query tile
# by up to 3 value tiles (``kApplyNI``). So a block takes at most 12 value
# tiles (its value columns plus B3's ones column or B4's n column) and B3
# at most 12 feature tiles of 16.
NONCAUSAL_ROWS = 64
NONCAUSAL_COL_TILE = 8
NONCAUSAL_MAX_VALUE_TILES = 12
STATE_MAX_FEATURE_TILES = 12
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


class NoncausalSchedule(NamedTuple):
    """How B3 (``csrc/rm_fused_state.cu``) or B4 (``csrc/rm_fused_apply.cu``)
    cuts its work and its shared memory. The kernels read these fields as
    one int array, in this order (``struct Sched`` in
    ``csrc/rm_featurize_mma.cuh``).

    Grid: ``bh * splits * n_fgroups * n_dvgroups`` blocks of 512 threads.
    A block walks ``tiles_per_split`` 64-row tiles of one batch*head row
    (B3: keys, its partial state summed by a second pass when ``splits >
    1``; B4: queries), for the column tiles ``[g * ct_per_group, ...)`` of
    its feature group and the value columns ``[h * dv_per_group, ...)`` of
    its value group. Shared memory, in bytes and in this order: the slab
    (``slab_cap`` rows of the input type) and the 64-row x tile, both with
    rows of ``ldx`` elements (``d`` padded to ``dp`` with zeros), the B operand of the
    contraction (``b_rows`` rows of ``ldb`` fp32: B3's value tile plus a
    ones column, B4's state rows plus an ``n`` column), the feature tile
    ``Z`` (64 rows of ``ldz`` fp32) and, for B4, 64 denominators. A feature
    group whose slab rows exceed ``slab_cap`` (or, for B4, whose column
    tiles exceed ``chunk_ct``) is featurized in chunks that reload the slab
    for every row tile.
    """
    bh: int
    t: int
    d: int
    dv: int
    f: int
    n_ct: int
    splits: int
    tiles_per_split: int
    ct_per_group: int
    n_fgroups: int
    dv_per_group: int
    n_dvgroups: int
    dp: int
    ldx: int
    slab_cap: int
    ldb: int
    b_rows: int
    ldz: int
    chunk_ct: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.bh * self.splits * self.n_fgroups * self.n_dvgroups


def _ld_rows(n: int) -> int:
    """Row stride (elements) >= n, = 4 mod 8: the reads of an mma fragment
    (8 rows x 4 consecutive 32-bit words) then hit 32 distinct banks."""
    return n + (4 - n) % 8


def _ld_cols(n: int) -> int:
    """Row stride (fp32) >= n, = 8 or 24 mod 32: the reads of a transposed
    fragment (4 rows x 8 consecutive words) hit 32 distinct banks."""
    while n % 32 not in (8, 24):
        n += 1
    return n


def _round16(nbytes: int) -> int:
    return round_up(nbytes, 16)


def _x_layout(d: int, item: int) -> Tuple[int, int]:
    """``(dp, ldx)``: the MMA depth pads d to 8 (3xTF32 m16n8k8) or 16
    (bf16 m16n8k16); the row stride adds 4 words against bank conflicts."""
    if item == 4:
        dp = round_up(max(d, 1), 8)
        return dp, dp + 4
    dp = round_up(max(d, 1), 16)
    return dp, dp + 8


def _value_groups(dv: int, max_ntiles: int) -> Tuple[int, int, int]:
    """``(dv_per_group, n_dvgroups, n8 tiles a group)``: value columns a
    block takes, at most ``max_ntiles`` mma n-tiles with the extra column
    (B3's ones column, B4's n), groups of equal width rounded to 8."""
    full = -(-(dv + 1) // 8)
    groups = -(-full // max_ntiles)
    width = round_up(-(-dv // groups), 8)
    return width, -(-dv // width), -(-(width + 1) // 8)


@functools.lru_cache(maxsize=None)
def _pick_splits(units: int, tiles: int) -> Tuple[int, int]:
    """``(splits, tiles_per_split)`` along the row axis for ``units``
    independent (batch*head, group) items of ``tiles`` 64-row tiles each:
    at least two waves of blocks on :data:`NUM_SMS` SMs where the tiles
    allow (one block an SM: a block takes most of the shared memory), never
    more splits than tiles, and the fewest waves x (tiles a block + one for
    its fixed cost: slab load, epilogue, its share of a second pass); ties
    go to fewer splits."""
    lo = min(tiles, max(1, -(-2 * NUM_SMS // units)))
    best = None
    for s in range(lo, tiles + 1):
        per = -(-tiles // s)
        s_eff = -(-tiles // per)
        cost = -(-units * s_eff // NUM_SMS) * (per + 1)
        if best is None or (cost, s_eff) < best[0]:
            best = ((cost, s_eff), (s_eff, per))
    return best[1]


def _slab_rows(tile_rows, ct0: int, ct1: int) -> int:
    return tile_rows[min(ct1, len(tile_rows) - 1)] - tile_rows[ct0]


@functools.lru_cache(maxsize=256)
def noncausal_schedule(kind: str, bh: int, t: int, d: int, dv: int, f: int,
                       tile_rows: Sequence[int],
                       item: int) -> NoncausalSchedule:
    """The :class:`NoncausalSchedule` of kernel ``kind`` (``"state"``, B3,
    or ``"apply"``, B4) at ``[bh, t, d]`` rows, ``dv`` values, ``f``
    features, the slab's ``tile_rows`` (``NoncausalPack.tile_rows``) and
    input element size ``item`` (4 fp32, 2 bf16).

    B3 holds its ``[features, dv + 1]`` state in registers, at most
    :data:`STATE_MAX_FEATURE_TILES` x :data:`NONCAUSAL_MAX_VALUE_TILES`
    (16 x 8) tiles a block, so a wide ``dv`` splits into value groups and a
    wide F into feature groups (each group featurizes again); B4 holds
    ``[64, dv + 1]`` outputs, so only ``dv`` groups. Both
    take :data:`SMEM_PER_BLOCK` bytes of shared memory at most; a slab that
    does not fit is tiled in chunks of column tiles. Memoized: the encoder
    asks once per layer with the same shapes (``tile_rows`` a tuple).

    The depth d is not tiled: the 64-row x tile and one column tile's slab
    rows (8 x its depth rows of d) must fit together. For the rm plans of
    depth 5 (the hubert and qwen3 heads use d 80 and 128) at dv 80 that
    holds up to d 384 for B3 and 536 for B4 in fp32, 768 and 1072 in
    bf16.

    Raises:
        ValueError: one column tile's slab rows do not fit beside the rest
            even alone (d past the limit above).
    """
    if kind not in ("state", "apply"):
        raise ValueError(f"kind must be 'state' or 'apply', got {kind!r}")
    n_ct = len(tile_rows) - 1
    if n_ct != -(-f // NONCAUSAL_COL_TILE):
        raise ValueError(f"{n_ct} column tiles do not cover F={f}")
    tiles = max(1, -(-t // NONCAUSAL_ROWS))
    dp, ldx = _x_layout(d, item)
    x_bytes = _round16(NONCAUSAL_ROWS * ldx * item)
    max_tile = max((tile_rows[c + 1] - tile_rows[c] for c in range(n_ct)),
                   default=0)
    width, n_dvg, ntiles = _value_groups(dv, NONCAUSAL_MAX_VALUE_TILES)
    ldb = _ld_cols(8 * ntiles)
    if kind == "state":
        ct_per_group = max(1, min(n_ct, 2 * STATE_MAX_FEATURE_TILES))
        n_fg = max(1, -(-n_ct // ct_per_group))
        ct_per_group = max(1, -(-n_ct // n_fg))
        b_rows = NONCAUSAL_ROWS
        ldz = _ld_cols(16 * -(-ct_per_group // 2))
        chunk_ct = ct_per_group
        fixed = x_bytes + b_rows * ldb * 4 + NONCAUSAL_ROWS * ldz * 4
        need = max(_slab_rows(tile_rows, g * ct_per_group,
                              (g + 1) * ct_per_group) for g in range(n_fg))
        cap = (SMEM_PER_BLOCK - fixed - 16) // (ldx * item)
    else:
        ct_per_group, n_fg = max(n_ct, 1), 1
        need = tile_rows[-1]
        # the most column tiles a chunk may take (their state rows and Z
        # columns) with room left for one column tile's slab rows
        chunk_ct = ct_per_group
        while True:
            b_rows = NONCAUSAL_COL_TILE * chunk_ct
            ldz = _ld_rows(b_rows)
            fixed = (x_bytes + b_rows * ldb * 4 + NONCAUSAL_ROWS * ldz * 4
                     + NONCAUSAL_ROWS * 4)
            cap = (SMEM_PER_BLOCK - fixed - 16) // (ldx * item)
            if cap >= max_tile or chunk_ct == 1:
                break
            chunk_ct = -(-chunk_ct // 2)
    slab_cap = min(need, cap)
    if slab_cap < max_tile:
        raise ValueError(
            f"non-causal kernels: a column tile's {max_tile} slab rows of "
            f"d={d} do not fit {SMEM_PER_BLOCK} bytes of shared memory beside the "
            f"rest of the block")
    smem = _round16(slab_cap * ldx * item) + fixed
    units = bh * n_fg * n_dvg
    splits, per = _pick_splits(units, tiles)
    return NoncausalSchedule(
        bh=bh, t=t, d=d, dv=dv, f=f, n_ct=n_ct, splits=splits,
        tiles_per_split=per, ct_per_group=ct_per_group, n_fgroups=n_fg,
        dv_per_group=width, n_dvgroups=n_dvg, dp=dp, ldx=ldx,
        slab_cap=slab_cap, ldb=ldb, b_rows=b_rows, ldz=ldz,
        chunk_ct=chunk_ct, smem_bytes=smem)


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
