"""Tiling helpers shared by the hand-written Hopper kernels (port of
``repro.kernels.common``).

The reference sizes its Pallas tiles against a TPU VMEM budget. On Hopper
the limits are a block's shared memory (227 KB = 232,448 bytes after
``cudaFuncSetAttribute``) and its registers (65,536 per SM, at most 255 a
thread). The Random Maclaurin kernels B1-B4 featurize on the tensor cores
(``csrc/rm_featurize_mma.cuh``). B2 (``csrc/rm_fused_attention.cu``) forms
one chain a warp, 16 rows by one 8-column tile, reading x and the packed
omegas from device memory; its three kernels (chunk states, their prefix,
the outputs) are cut by :func:`causal_schedule`. B1 (``csrc/rm_feature.cu``)
runs the same chains on a decode-sized batch and a 64-row tile staged in
shared memory on a Gram-sized one (:func:`pick_feature_tiles`). The non-causal
kernels B3 (``csrc/rm_fused_state.cu``) and B4 (``csrc/rm_fused_apply.cu``)
run 512 threads on a 64-row tile with the omega slab resident in shared
memory; a block walks several row tiles of one batch*head row, and
:func:`noncausal_schedule` picks how many, the value and feature groups,
the depth chunks and the shared-memory layout. B9
(``csrc/rm_feature_bucket.cu``), one degree bucket, runs B1's chains on
small batches and narrow buckets and a 256-row tile walking runs of staged
omega rows on Gram-sized ones (:func:`bucket_schedule`). The tensor_sketch (B6,
``csrc/tensor_sketch.cu``) and ctr (B7, ``csrc/ctr_feature.cu``) kernels
run complex chains on the tensor cores (``csrc/complex_mma.cuh``), 16 rows
a block: B7 needs no choice, B6's warps and output groups are
:func:`sketch_schedule`. The chunked attention kernel B5
(``csrc/rm_attention_chunked.cu``) runs a query tile as a cluster of two
blocks on the tensor cores, its tiles and shared memory cut by
:func:`chunked_schedule`; the structured kernel B8
(``csrc/structured_feature.cu``) runs each Hadamard transform in a warp's
registers (a block's, past 1024 points; in passes through a scratch, past
8192), its warps and lanes a row chosen by :func:`structured_schedule`.
There is no autotune cache yet.

Every wrapper takes its plain PyTorch version on a tensor whose device is
one of :data:`PLAIN_DEVICES`: the CPU, and ``meta`` (shapes only, as a dry
run's step runs: ``launch.dryrun``, the counterpart of the reference
lowering its jnp paths off the TPU); a CUDA tensor launches the kernel,
and any other device raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

__all__ = [
    "PLAIN_DEVICES",
    "SMEM_PER_BLOCK",
    "round_up",
    "feature_tile_smem",
    "pick_feature_tiles",
    "BucketSchedule",
    "bucket_tile_smem",
    "bucket_schedule",
    "CausalSchedule",
    "causal_schedule",
    "SketchSchedule",
    "sketch_schedule",
    "NoncausalSchedule",
    "noncausal_schedule",
    "ChunkedSchedule",
    "chunked_schedule",
    "STRUCTURED_BLOCK_MAX_DPAD",
    "StructuredSchedule",
    "check_structured_d_pad",
    "structured_split_passes",
    "structured_split_rows",
    "structured_schedule",
]

# the devices whose tensors take a wrapper's plain version
PLAIN_DEVICES = ("cpu", "meta")
# Hopper: the most dynamic shared memory one block may opt into.
SMEM_PER_BLOCK = 232_448
# Streaming multiprocessors of an H100 SXM: enough blocks to fill them.
NUM_SMS = 132
# B6 (csrc/tensor_sketch.cu): a block of 8 warps (batches of at most
# SKETCH_WIDE_ROWS rows) or 4 owns 16 rows and one item, and walks its
# degree block in rounds of 8 columns a warp; the output groups tried are
# at most 160 columns (the Mr / Mi slices a block stages, kMaxGroup there:
# one group holds qwen3's widest block, 149 columns).
SKETCH_WIDE_ROWS = 256
SKETCH_GROUPS = (16, 32, 64, 160)
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
# B8 (csrc/structured_feature.cu): a warp holds transforms of up to
# STRUCTURED_WARP_MAX_DPAD points in its registers (one row, d_pad / 32 a
# lane; two rows of half a warp each; 32 / d_pad rows below 32 points);
# past that one block of
# STRUCTURED_WIDE_THREADS threads holds it (d_pad / 256 a thread, the
# stages past a warp through a shared-memory buffer of d_pad floats, 32 KB
# at STRUCTURED_BLOCK_MAX_DPAD); past that the split path: a pass over
# runs of STRUCTURED_WARP_MAX_DPAD points a warp, then passes of at most
# 2^STRUCTURED_PASS_MAX_LG points at a stride a thread, through an fp32
# scratch of every slot of every stack of a chunk of rows, at most
# STRUCTURED_SCRATCH_BYTES (one row's at the least).
STRUCTURED_BLOCK_MAX_DPAD = 8192
STRUCTURED_WARP_MAX_DPAD = 1024
STRUCTURED_WIDE_THREADS = 256
STRUCTURED_PASS_MAX_LG = 5
STRUCTURED_SCRATCH_BYTES = 1 << 30
# B5 (csrc/rm_attention_chunked.cu): 4 warps a block, a cluster of two
# blocks a query tile of CHUNKED_ROWS rows (the scores and the state term);
# F staged 32 features a slice, keys scored CHUNKED_KEY_GROUP at a time, v
# staged 32 keys a tile; value groups of at most CHUNKED_GROUP_COLS columns
# (plus the den column: 20 n-tiles, 5 a warp); the scores of at most
# CHUNKED_WINDOW keys held in shared memory (a multiple of 64).
CHUNKED_ROWS = 16
CHUNKED_FSLICE = 32
CHUNKED_KEY_GROUP = 128
CHUNKED_VALUE_TILE = 32
CHUNKED_GROUP_COLS = 156
CHUNKED_WINDOW = 512


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return (x + m - 1) // m * m


# B1 (csrc/rm_feature.cu): 4 warps a block; the chain kernel takes one
# 16-row group a block, the tile kernel a 64-row tile staged in shared
# memory beside 4 warps' buffers of 16 omega rows.
FEATURE_WARPS = 4
FEATURE_CHAIN_ROWS = 16
FEATURE_TILE_ROWS = 64
# B2 (csrc/rm_fused_attention.cu): 64-position chunks, 64-feature tiles, 8
# warps a block. Pass A holds [dS | dn] tiles of a feature tile by value
# n-tiles in batches, so a value group is at most 17 n-tiles (16 of values
# and the ones column); pass B holds a 64-row numerator of at most 10
# n-tiles (``kOutNI`` x 2 warps), a value group of at most 9 with its den
# column.
CAUSAL_CHUNK = 64
CAUSAL_FTILE = 64
# Chunks of one segment: B2 runs its three passes on at most this many
# chunks at a time (the state carried between segments), so its scratch of
# chunk states is at most 32 times the (S, n) a call returns, whatever T.
CAUSAL_SEGMENT_CHUNKS = 32
_CAUSAL_LDZ_A = 72
_CAUSAL_LDZ_B = 68
_CAUSAL_A_VALUE_TILES = 17
_CAUSAL_B_VALUE_TILES = 9


def feature_tile_smem(d: int, item: int) -> int:
    """Shared memory of a B1 tile block: the 64-row x tile and 4 warps' 16
    omega rows, rows of ``dp + step / 2`` elements (``dp`` d padded to one
    mma's depth ``step``: 8 fp32, 16 bf16)."""
    step = 8 if item == 4 else 16
    ldx = round_up(max(d, 1), step) + step // 2
    return (FEATURE_TILE_ROWS + FEATURE_WARPS * 16) * ldx * item


def pick_feature_tiles(rows: int, f: int, d: int,
                       item: int) -> Tuple[int, int]:
    """``(row_tile, ct_per_warp)`` of B1 at ``rows`` x ``d`` inputs (element
    size ``item``) and ``f`` columns.

    The tile kernel (``row_tile`` 64) where its grid at one column tile a
    warp has two blocks an SM and its shared memory fits (d up to 448 fp32,
    896 bf16); otherwise the chain kernel (16), whose 16-row groups spread
    a decode batch over many blocks (128 rows x 21 column tiles: 8 x 6 =
    48 blocks of 4 warps). Each warp then walks ``ct_per_warp`` column
    tiles: the most of 8, 4, 2 that still leaves four blocks an SM in the
    grid (a warp reuses its rows over them), else 1."""
    n_ct = -(-max(f, 1) // 8)
    row_tile = FEATURE_CHAIN_ROWS
    if (-(-max(rows, 1) // FEATURE_TILE_ROWS) * -(-n_ct // FEATURE_WARPS)
            >= 2 * NUM_SMS
            and feature_tile_smem(d, item) <= SMEM_PER_BLOCK):
        row_tile = FEATURE_TILE_ROWS
    groups = -(-max(rows, 1) // row_tile)
    for per in (8, 4, 2):
        if groups * -(-n_ct // (FEATURE_WARPS * per)) >= 4 * NUM_SMS:
            return row_tile, per
    return row_tile, 1


# B9 (csrc/rm_feature_bucket.cu): the chain kernel takes one 16-row group
# a block of 4 warps, each warp one 8-column tile at a time; the tile
# kernel a 256-row x tile staged in shared memory by 16 warps (16 rows
# each, one block an SM), which walks runs of ct_per_warp column tiles,
# each run's omega rows staged in one go into one of one or two buffers
# and taken by every warp.
BUCKET_CHAIN_ROWS = 16
BUCKET_CHAIN_WARPS = 4
BUCKET_TILE_ROWS = 256
# A run is at most BUCKET_RUN_TILES column tiles and about
# BUCKET_RUN_ITEMS (tile, slot) items a warp.
BUCKET_RUN_TILES = 8
BUCKET_RUN_ITEMS = 32
# The tile kernel's time in (tile, slot) items of a run, fitted to its
# times on an H100 at homog10 x [20000, 50] and the adult map's buckets
# at 8000 rows (``time_rm_kernels.py --b9-schedules``, PERF.md): a run
# costs its items and BUCKET_RUN_OVERHEAD more (its staging wait and
# barriers), a block BUCKET_BLOCK_OVERHEAD more (the x tile and the first
# run).
BUCKET_RUN_OVERHEAD = 2
BUCKET_BLOCK_OVERHEAD = 8


class BucketSchedule(NamedTuple):
    """How B9 (``csrc/rm_feature_bucket.cu``) cuts its work.

    ``kernel``: ``"chain"`` or ``"tile"``; ``rows``: rows a block (16 or
    256); ``ct_per_warp``: column tiles a warp takes (chain: in turn; tile:
    a run's, which every warp takes for its 16 rows); ``runs``: the runs a
    tile block walks (1 for chain); ``buffers``: run buffers of a tile
    block (2: the next run is staged while this one multiplies; 0 for
    chain); ``grid``: ``(row blocks, column blocks)``; ``smem``: a block's
    dynamic shared memory in bytes (0 for chain)."""
    kernel: str
    rows: int
    ct_per_warp: int
    runs: int
    buffers: int
    grid: Tuple[int, int]
    smem: int


def bucket_tile_smem(d: int, degree: int, ct_per_warp: int, buffers: int,
                     item: int) -> int:
    """Shared memory of a B9 tile block: the 256-row x tile and ``buffers``
    runs of ``ct_per_warp * 8 * degree`` omega rows, rows of ``dp +
    step / 2`` elements (``dp`` d padded to one mma's depth ``step``: 8
    fp32, 16 bf16)."""
    step = 8 if item == 4 else 16
    ldx = round_up(max(d, 1), step) + step // 2
    run_rows = ct_per_warp * 8 * degree
    return (BUCKET_TILE_ROWS + buffers * run_rows) * ldx * item


def _bucket_tile(rows: int, n_ct: int, d: int, degree: int, item: int):
    """The tile kernel's cheapest ``BucketSchedule`` by the cost model
    above (run sizes that fit shared memory with two buffers, or one
    column tile with one; 1 to 32 runs a block), or None where nothing
    fits."""
    row_blocks = -(-max(rows, 1) // BUCKET_TILE_ROWS)
    top = min(BUCKET_RUN_TILES, -(-BUCKET_RUN_ITEMS // degree))
    plans = [(cw, 2) for cw in range(1, top + 1)
             if bucket_tile_smem(d, degree, cw, 2, item) <= SMEM_PER_BLOCK]
    if not plans and bucket_tile_smem(d, degree, 1, 1, item) <= SMEM_PER_BLOCK:
        plans = [(1, 1)]
    best = None
    for cw, buffers in plans:
        n_runs = -(-n_ct // cw)
        for runs in (1, 2, 4, 8, 16, 32):
            col_blocks = -(-n_runs // runs)
            per_block = -(-n_runs // col_blocks)
            waves = -(-row_blocks * col_blocks // NUM_SMS)
            cost = waves * (per_block * (cw * degree + BUCKET_RUN_OVERHEAD)
                            + BUCKET_BLOCK_OVERHEAD)
            key = (cost, row_blocks * col_blocks)
            if best is None or key < best[0]:
                best = (key, BucketSchedule(
                    "tile", BUCKET_TILE_ROWS, cw, per_block, buffers,
                    (row_blocks, col_blocks),
                    bucket_tile_smem(d, degree, cw, buffers, item)))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def bucket_schedule(rows: int, count: int, d: int, degree: int, item: int,
                    kernel: str = None) -> BucketSchedule:
    """B9's kernel and grid for ``rows`` x ``d`` inputs (element size
    ``item``) and one bucket of ``count`` features of ``degree`` slots.

    The tile kernel where its 256-row blocks by 8-column tiles make two
    waves of blocks on the card (2 NUM_SMS) and its x tile and a run fit
    shared memory; its run size and runs a block are the cheapest by the
    cost model above (:func:`_bucket_tile`). Otherwise the chain kernel,
    whose 16-row groups and 8-column tiles spread a small batch or a
    narrow bucket over many warps (spambase's deg-8 bucket at 1840 rows:
    115), any d; each warp then walks ``ct_per_warp`` column tiles, the
    most of 8, 4, 2 that still leaves four blocks an SM, else 1. ``kernel``
    forces one of the two (for holding both against the plain version at
    one shape). Cached: the wrapper asks at every launch.

    Raises:
        ValueError: ``kernel="tile"`` where the tile does not fit.
    """
    n_ct = -(-max(count, 1) // 8)
    if kernel != "chain":
        tile = _bucket_tile(rows, n_ct, d, degree, item)
        if kernel == "tile" and tile is None:
            raise ValueError(f"B9's tile does not fit d {d}, degree "
                             f"{degree}")
        row_blocks = -(-max(rows, 1) // BUCKET_TILE_ROWS)
        if tile is not None and (kernel == "tile"
                                 or row_blocks * n_ct >= 2 * NUM_SMS):
            return tile
    groups = -(-max(rows, 1) // BUCKET_CHAIN_ROWS)
    per = 1
    for p in (8, 4, 2):
        if groups * -(-n_ct // (BUCKET_CHAIN_WARPS * p)) >= 4 * NUM_SMS:
            per = p
            break
    return BucketSchedule("chain", BUCKET_CHAIN_ROWS, per, 1, 0,
                          (groups, -(-n_ct // (BUCKET_CHAIN_WARPS * per))),
                          0)


class CausalSchedule(NamedTuple):
    """How B2 (``csrc/rm_fused_attention.cu``) cuts its work. The kernels
    read these fields as one int array, in this order (``struct CSched``).

    ``bh`` rows are ``heads`` heads of each batch row (the kernels read
    ``kvalid [B, T]`` at row ``bh // heads``). ``t`` is the padded length
    (a multiple of :data:`CAUSAL_CHUNK`), cut
    into ``n_chunks`` chunks, run ``seg_chunks`` at a time (a segment: its
    three passes, then the next segment's, the state carried between
    them); the features into ``n_ftiles`` tiles of
    :data:`CAUSAL_FTILE`. Pass A (each chunk's own key state, ``bh *
    seg_chunks * n_agroups * n_dvagroups`` blocks a segment) takes
    ``ftiles_per_agroup`` feature tiles and ``dva_per_group`` value columns
    a block, its value tile at row stride ``lda``; the prefix pass walks a
    segment's chunks in order; pass B (the outputs, ``bh * seg_chunks *
    n_dvbgroups`` blocks a segment) takes ``dvb_per_group`` value columns
    and every feature tile, its state and value tiles at row stride
    ``ldb``. ``smem_a`` / ``smem_b``: dynamic shared memory of a pass-A /
    pass-B block, in bytes.
    """
    bh: int
    heads: int
    t: int
    d: int
    dv: int
    f: int
    n_ct: int
    n_chunks: int
    seg_chunks: int
    n_ftiles: int
    ftiles_per_agroup: int
    n_agroups: int
    dva_per_group: int
    n_dvagroups: int
    lda: int
    dvb_per_group: int
    n_dvbgroups: int
    ldb: int
    smem_a: int
    smem_b: int

    @property
    def blocks_a(self) -> int:
        return self.bh * self.n_chunks * self.n_agroups * self.n_dvagroups

    @property
    def blocks_b(self) -> int:
        return self.bh * self.n_chunks * self.n_dvbgroups

    @property
    def scratch_bytes(self) -> int:
        """Device memory of the chunk states a call allocates: ``ds [bh,
        seg_chunks, f, dv]`` and ``dn [bh, seg_chunks, f]``, fp32."""
        return 4 * self.bh * self.seg_chunks * self.f * (self.dv + 1)


@functools.lru_cache(maxsize=256)
def causal_schedule(bh: int, heads: int, t: int, d: int, dv: int,
                    f: int) -> CausalSchedule:
    """The :class:`CausalSchedule` of B2 at ``[bh, t, d]`` rows of
    ``heads`` heads a batch row (``t`` before padding), ``dv`` values and
    ``f`` features. Shared memory does
    not depend on ``d`` or ``f`` (x and the omegas are read from device
    memory, the features a 64-wide tile at a time), so every shape fits:
    a pass-A block takes at most 57,344 bytes, a pass-B block 80,128 (the
    widest value groups). Pass A's feature tiles
    are split into groups until its grid has two blocks an SM (no more
    groups than tiles). The chunks run in segments of at most
    :data:`CAUSAL_SEGMENT_CHUNKS` (2048 positions), so the scratch of chunk
    states (:attr:`CausalSchedule.scratch_bytes`) stays at most that many
    times the (S, n) a call returns: 43 MB at BH 16, F 163, dv 128 from T
    2048 on. Memoized: the model asks once per layer with the same
    shapes."""
    tp = round_up(max(t, 1), CAUSAL_CHUNK)
    n_chunks = tp // CAUSAL_CHUNK
    seg = min(n_chunks, CAUSAL_SEGMENT_CHUNKS)
    n_ct = -(-f // 8)
    n_ftiles = max(1, -(-f // CAUSAL_FTILE))
    dva, n_dva, nta = _value_groups(dv, _CAUSAL_A_VALUE_TILES)
    dvb, n_dvb, ntb = _value_groups(dv, _CAUSAL_B_VALUE_TILES)
    lda, ldb = _ld_cols(8 * nta), _ld_cols(8 * ntb)
    units = bh * seg * n_dva
    groups = min(n_ftiles, max(1, -(-2 * NUM_SMS // units)))
    per = -(-n_ftiles // groups)
    groups = -(-n_ftiles // per)
    smem_a = 4 * CAUSAL_CHUNK * (_CAUSAL_LDZ_A + lda)
    smem_b = 4 * CAUSAL_CHUNK * (2 * _CAUSAL_LDZ_B + 2 * ldb + 1)
    return CausalSchedule(
        bh=bh, heads=heads, t=tp, d=d, dv=dv, f=f, n_ct=n_ct,
        n_chunks=n_chunks, seg_chunks=seg, n_ftiles=n_ftiles,
        ftiles_per_agroup=per, n_agroups=groups,
        dva_per_group=dva, n_dvagroups=n_dva, lda=lda, dvb_per_group=dvb,
        n_dvbgroups=n_dvb, ldb=ldb, smem_a=smem_a, smem_b=smem_b)


class ChunkedSchedule(NamedTuple):
    """How B5 (``csrc/rm_attention_chunked.cu``) cuts its work. The kernel
    reads these fields as one int array, in this order (``struct BSched``).

    Each chunk of ``chunk`` rows of the ``bh`` rows of ``t`` positions is
    cut into ``q_tiles`` query tiles of ``rows`` rows; a query tile is a
    cluster of two blocks (its scores and tril(scores) [v | 1]; its state
    term zq [S_prev | n_prev]). Value columns go ``group_cols`` at a time
    (``n_groups`` groups); the scores of up to ``win_keys`` keys stay in
    shared memory (row stride ``lds``). ``ldq``: row stride (elements) of
    the staged zq / zk slices; ``ldv``: of the staged value, state and
    partial tiles (fp32). ``smem_bytes``: a block's dynamic shared memory.
    """
    bh: int
    t: int
    f: int
    dv: int
    chunk: int
    rows: int
    q_tiles: int
    n_groups: int
    group_cols: int
    win_keys: int
    ldq: int
    ldv: int
    lds: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return 2 * self.bh * (self.t // self.chunk) * self.q_tiles


@functools.lru_cache(maxsize=256)
def chunked_schedule(bh: int, t: int, f: int, dv: int, chunk: int,
                     item: int) -> ChunkedSchedule:
    """The :class:`ChunkedSchedule` of B5 at ``zq, zk [bh, t, f]`` (element
    size ``item``), ``dv`` values and chunks of ``chunk`` rows (``t`` a
    multiple of it). The query tile is 16 rows, one mma m-tile: at the
    bucket-256 prefill (bh 16, t 256, chunk 128) 512 blocks, two an SM and
    more. Shared memory does not depend on ``f`` (F is staged 32
    features at a time): 49,984 bytes a block there (fp32, dv 128), so four
    blocks share an SM. Memoized: the model asks once per layer with the
    same shapes."""
    rows = CHUNKED_ROWS
    q_tiles = -(-chunk // rows)
    n_groups = -(-dv // CHUNKED_GROUP_COLS)
    w0 = min(dv, CHUNKED_GROUP_COLS)
    ldv = _ld_cols(8 * -(-(w0 + 1) // 8))
    win = min(round_up(chunk, 64), CHUNKED_WINDOW)
    lds = win + 4
    ldq = CHUNKED_FSLICE + (4 if item == 4 else 8)
    q = _round16(2 * rows * ldq * item)
    stage = max(q + _round16(2 * CHUNKED_KEY_GROUP * ldq * item),
                _round16(2 * CHUNKED_VALUE_TILE * ldv * 4),
                q + _round16(2 * CHUNKED_FSLICE * ldv * 4),
                _round16(rows * ldv * 4))
    smem = stage + _round16(rows * lds * 4) + _round16(rows * 4)
    return ChunkedSchedule(
        bh=bh, t=t, f=f, dv=dv, chunk=chunk, rows=rows, q_tiles=q_tiles,
        n_groups=n_groups, group_cols=CHUNKED_GROUP_COLS, win_keys=win,
        ldq=ldq, ldv=ldv, lds=lds, smem_bytes=smem)


class SketchSchedule(NamedTuple):
    """How the tensor_sketch kernel B6 cuts its work (grid = 16-row groups
    x items, ``warps`` a block). An item is a degree block ``[c0, c0 + c)``
    and its output columns ``[g0, g0 + group)`` (block-relative, cut at
    ``c``); ``items`` is flat, ``(c0, c, g0)`` an item, as the kernel reads
    it from device memory."""
    warps: int
    group: int
    items: Tuple[int, ...]

    @property
    def n_items(self) -> int:
        return len(self.items) // 3


def _sketch_items(starts: Sequence[int], group: int) -> Tuple[int, ...]:
    items = []
    for a, b in zip(starts, starts[1:]):
        for g0 in range(0, b - a, group):
            items += [a, b - a, g0]
    return tuple(items)


def _sketch_time(starts, b: int, d: int, warps: int, group: int) -> float:
    """B6's time in multiply-adds per row, the larger of the longest item
    (a block runs its degree block's stage 1 in rounds of ``8 warps``
    columns, degree 1 assumed, and its group's share of stage 2) and the
    whole grid's work spread over the SMs."""
    costs = []
    for a, b_ in zip(starts, starts[1:]):
        cols = round_up(b_ - a, 8 * warps)
        for g0 in range(0, b_ - a, group):
            gw = round_up(min(group, b_ - a - g0), 8)
            costs.append(cols * 2 * d + 2 * cols * gw)
    return max(max(costs), -(-b // 16) * sum(costs) / NUM_SMS)


@functools.lru_cache(maxsize=256)
def sketch_schedule(starts: Tuple[int, ...], b: int,
                    d: int) -> SketchSchedule:
    """The :class:`SketchSchedule` of B6 on ``b`` rows of width ``d`` and
    the degree blocks ``starts`` (``SketchPlan.block_starts()``: 0, ...,
    Fs), any number of blocks of any width: 8 warps a block up to
    :data:`SKETCH_WIDE_ROWS` rows, else 4; the group of
    :data:`SKETCH_GROUPS` whose estimated time (:func:`_sketch_time`) is
    least, ties to the wider (less of stage 1 recomputed). Narrow groups
    win on decode-sized batches (more blocks in flight), wide ones on
    large batches. Memoized: the serving path asks with the same shapes
    every step.

    Raises:
        ValueError: ``starts`` do not rise strictly from 0.
    """
    if len(starts) < 2 or starts[0] != 0 or any(
            a >= b_ for a, b_ in zip(starts, starts[1:])):
        raise ValueError(f"degree blocks must rise strictly from 0, got "
                         f"{tuple(starts)}")
    warps = 8 if b <= SKETCH_WIDE_ROWS else 4
    group = min(SKETCH_GROUPS,
                key=lambda g: (_sketch_time(starts, b, d, warps, g), -g))
    return SketchSchedule(warps, group, _sketch_items(starts, group))


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
    ``Z`` (64 rows of ``ldz`` fp32), the projection tile ``P`` (64 rows of
    ``ldp`` fp32; 0 unless d is tiled) and, for B4, 64 denominators. A
    feature group whose slab rows exceed ``slab_cap`` (or, for B4, whose
    column tiles exceed ``chunk_ct``) is featurized in chunks that reload
    the slab for every row tile. ``dk``: the depth a featurize step takes;
    ``dk == dp`` but where the x tile and one column tile's slab rows do
    not fit together, and then the x tile and the slab rows are staged
    ``dk`` columns of d at a time (``ldx`` is then ``dk``'s stride) and the
    projections summed in ``P``. ``slot_rows``: 0, or where a column tile's
    slab rows do not fit even at the narrowest depth chunk (a tile deeper
    than about 80 slots), the slab rows (whole slots) such a tile is staged
    in at a time, its running product carried across the pieces (its own
    kernel instance).
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
    dk: int
    ldp: int
    smem_bytes: int
    slot_rows: int

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


# Depth chunks B3 and B4 try, widest first, where d is tiled: fp32 (item
# 4) in steps of 8 (one 3xTF32 mma), bf16 in steps of 16.
_DEPTH_CHUNKS = {4: (128, 64, 32, 16, 8), 2: (256, 128, 64, 32, 16)}


def _noncausal_plan(kind, n_ct, tile_rows, dv, item, ldx, p_row_bytes):
    """``(ct_per_group, n_fgroups, b_rows, ldz, chunk_ct, fixed, cap,
    need)`` of :func:`noncausal_schedule` for x rows of ``ldx`` elements:
    ``fixed`` the bytes besides the slab and P, ``cap`` the slab rows that
    fit beside them when each slab row also takes ``p_row_bytes`` of P,
    ``need`` the slab rows the largest group (B3) or the whole plan (B4)
    holds."""
    x_bytes = _round16(NONCAUSAL_ROWS * ldx * item)
    max_tile = max((tile_rows[c + 1] - tile_rows[c] for c in range(n_ct)),
                   default=0)
    _, _, ntiles = _value_groups(dv, NONCAUSAL_MAX_VALUE_TILES)
    ldb = _ld_cols(8 * ntiles)
    # P's row stride is padded to 4 mod 8: at most 7 more columns
    p_pad = NONCAUSAL_ROWS * 7 * 4 if p_row_bytes else 0
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
        cap = (SMEM_PER_BLOCK - fixed - 16 - p_pad) // (ldx * item
                                                        + p_row_bytes)
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
            cap = (SMEM_PER_BLOCK - fixed - 16 - p_pad) // (ldx * item
                                                            + p_row_bytes)
            if cap >= max_tile or chunk_ct == 1:
                break
            chunk_ct = -(-chunk_ct // 2)
    return ct_per_group, n_fg, b_rows, ldz, chunk_ct, fixed, cap, need, \
        max_tile


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

    The depth d is taken whole (``dk == dp``) where the 64-row x tile and
    one column tile's slab rows fit together; on the rm plans of depth 5
    (the hubert and qwen3 heads use d 80 and 128) at dv 80 that holds up
    to d 384 for B3 and 536 for B4 in fp32, 768 and 1072 in bf16. Past
    that, d is tiled: the widest depth chunk ``dk`` of
    :data:`_DEPTH_CHUNKS` with which a column tile's slab rows and their
    projection tile fit, so any d runs. A column tile whose slab rows do
    not fit even at the narrowest chunk (depth above about 80 slots) is
    staged ``slot_rows`` slab rows at a time (the largest whole number of
    slots that fits), so any degree runs too.
    """
    if kind not in ("state", "apply"):
        raise ValueError(f"kind must be 'state' or 'apply', got {kind!r}")
    n_ct = len(tile_rows) - 1
    if n_ct != -(-f // NONCAUSAL_COL_TILE):
        raise ValueError(f"{n_ct} column tiles do not cover F={f}")
    tiles = max(1, -(-t // NONCAUSAL_ROWS))
    dp, ldx = _x_layout(d, item)
    dk, ldp = dp, 0
    ct_per_group, n_fg, b_rows, ldz, chunk_ct, fixed, cap, need, max_tile = \
        _noncausal_plan(kind, n_ct, tile_rows, dv, item, ldx, 0)
    if cap < max_tile:
        # d tiled: the x tile and the slab rows a chunk of d at a time, the
        # projections of a chunk's slab rows in P
        for dk in _DEPTH_CHUNKS[item]:
            if dk >= dp:
                continue
            ldx = dk + (4 if item == 4 else 8)
            ct_per_group, n_fg, b_rows, ldz, chunk_ct, fixed, cap, need, _ = \
                _noncausal_plan(kind, n_ct, tile_rows, dv, item, ldx,
                                NONCAUSAL_ROWS * 4)
            if cap >= max_tile:
                break
    slab_cap = min(need, cap)
    # a column tile too deep for shared memory even a depth chunk at a
    # time: its slots a piece of whole slots at a time
    slot_rows = 0 if slab_cap >= max_tile else \
        slab_cap // NONCAUSAL_COL_TILE * NONCAUSAL_COL_TILE
    smem = _round16(slab_cap * ldx * item) + fixed
    if dk < dp:
        ldp = _ld_rows(slab_cap)
        smem += NONCAUSAL_ROWS * ldp * 4
    width, n_dvg, _ = _value_groups(dv, NONCAUSAL_MAX_VALUE_TILES)
    ldb = _ld_cols(8 * -(-(width + 1) // 8))
    units = bh * n_fg * n_dvg
    splits, per = _pick_splits(units, tiles)
    return NoncausalSchedule(
        bh=bh, t=t, d=d, dv=dv, f=f, n_ct=n_ct, splits=splits,
        tiles_per_split=per, ct_per_group=ct_per_group, n_fgroups=n_fg,
        dv_per_group=width, n_dvgroups=n_dvg, dp=dp, ldx=ldx,
        slab_cap=slab_cap, ldb=ldb, b_rows=b_rows, ldz=ldz,
        chunk_ct=chunk_ct, dk=dk, ldp=ldp, smem_bytes=smem,
        slot_rows=slot_rows)


def check_structured_d_pad(m: int) -> None:
    """Raises ValueError unless ``m`` is a power of two (every Hadamard size
    the structured kernel takes)."""
    if m < 1 or m & (m - 1):
        raise ValueError(
            f"structured kernel: d_pad={m} must be a power of two")


def structured_split_passes(m: int) -> Tuple[int, ...]:
    """The log2 sizes of B8's split-path passes at Hadamard size ``m`` (>
    :data:`STRUCTURED_BLOCK_MAX_DPAD`): the run pass's 10, then lg(m) - 10
    bits in pieces of at most :data:`STRUCTURED_PASS_MAX_LG`, as even as
    they come, the larger first (``split_passes`` in the kernel's source).
    """
    run = STRUCTURED_WARP_MAX_DPAD.bit_length() - 1
    rest = m.bit_length() - 1 - run
    n = -(-rest // STRUCTURED_PASS_MAX_LG)
    return (run,) + tuple(rest // n + (1 if i < rest % n else 0)
                          for i in range(n))


def structured_split_rows(b: int, m: int, stacks: int, depth: int) -> int:
    """Rows of one chunk of B8's split path: as many as keep its fp32
    scratch (``depth`` slots x ``stacks`` x ``m`` a row) within
    :data:`STRUCTURED_SCRATCH_BYTES`, at least 1 and at most ``b`` (and a
    grid's 65535)."""
    per_row = 4 * depth * stacks * m
    return max(1, min(b, 65535, STRUCTURED_SCRATCH_BYTES // per_row))


class StructuredSchedule(NamedTuple):
    """How B8 (``csrc/structured_feature.cu``) cuts its work at Hadamard
    size ``d_pad``. ``wide`` False: ``lanes_per_row`` lanes of a warp hold
    one row's transform of one stack, ``elems_per_lane`` points a lane, so
    a warp holds ``rows_per_warp`` rows (grid: row groups of ``warps`` warps
    x stacks); ``wide`` True and ``passes`` empty: a block of
    :data:`STRUCTURED_WIDE_THREADS` threads holds one row's
    (``elems_per_lane`` points a thread; grid: rows x stacks); ``passes``
    set (past :data:`STRUCTURED_BLOCK_MAX_DPAD`): the split path, the log2
    sizes of its passes (:func:`structured_split_passes`), ``warps`` and
    ``elems_per_lane`` its run pass's and ``blocks`` that pass's blocks a
    slot."""
    d_pad: int
    wide: bool
    lanes_per_row: int
    rows_per_warp: int
    elems_per_lane: int
    warps: int
    blocks: int
    passes: Tuple[int, ...] = ()


def structured_schedule(m: int, b: int, stacks: int) -> StructuredSchedule:
    """The :class:`StructuredSchedule` of B8 at Hadamard size ``m`` on
    ``b`` rows of ``stacks`` stacks. Up to
    :data:`STRUCTURED_WARP_MAX_DPAD` a warp path: a row takes min(m, 32)
    lanes, or half a warp (two rows a warp, ``m / 16`` points a lane) for
    32 <= m <= 512 where there are at least 16 rows x stacks an SM: fewer
    shuffle stages a point where the card is full (faster at qwen3-1.7b's
    x ``[4096, 128]`` on an H100), while at decode a warp a row keeps each
    row's chain of stages shortest (faster at x ``[64, 128]``). A block
    takes the most warps of 8, 4, 2 whose grid
    still fills the card (at least :data:`NUM_SMS` blocks; the warps of a
    block share the stack's signs in L1), else 1. Past the warp path the
    block path, and past :data:`STRUCTURED_BLOCK_MAX_DPAD` the split
    path.

    Raises:
        ValueError: as :func:`check_structured_d_pad`.
    """
    check_structured_d_pad(m)
    if m > STRUCTURED_BLOCK_MAX_DPAD:
        return StructuredSchedule(
            d_pad=m, wide=True, lanes_per_row=32, rows_per_warp=0,
            elems_per_lane=STRUCTURED_WARP_MAX_DPAD // 32, warps=8,
            blocks=m // (8 * STRUCTURED_WARP_MAX_DPAD) * b * stacks,
            passes=structured_split_passes(m))
    if m > STRUCTURED_WARP_MAX_DPAD:
        return StructuredSchedule(
            d_pad=m, wide=True, lanes_per_row=0, rows_per_warp=0,
            elems_per_lane=m // STRUCTURED_WIDE_THREADS,
            warps=STRUCTURED_WIDE_THREADS // 32, blocks=b * stacks)
    lanes = min(m, 32)
    if 32 <= m <= 512 and b * stacks >= 16 * NUM_SMS:
        lanes = 16
    rpw = 32 // lanes
    warps = 1
    for w in (8, 4, 2):
        if -(-b // (w * rpw)) * stacks >= NUM_SMS:
            warps = w
            break
    return StructuredSchedule(
        d_pad=m, wide=False, lanes_per_row=lanes, rows_per_warp=rpw,
        elems_per_lane=m // lanes, warps=warps,
        blocks=-(-b // (warps * rpw)) * stacks)
