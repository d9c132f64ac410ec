"""What surrounds the non-causal kernels B3 (``csrc/rm_fused_state.cu``) and
B4 (``csrc/rm_fused_apply.cu``): their omega slab, its plain featurize, and
a plain model of B3's split-and-reduce order.

**The slab.** Both kernels featurize a 64-row tile on the tensor cores,
8 feature columns (one ``mma`` n-tile, a *column tile*) at a time: for
column tile ``c`` and each degree slot ``j`` below the tile's depth (the
largest degree of its 8 columns) one ``[16 x d] x [d x 8]`` product, and
the running product of the slots multiplies in registers. The slab lays the
omegas out in exactly that order, once per weight set:

    slab[tile_row0[c] + 8 j + i] = w[j, 8 c + i, :]

for the slots a column uses (``j < col_deg[8 c + i]``), and a zero row for
every slot past a column's degree and for the padding columns past F (the
kernel masks both, so their rows are never read into a product). Depth is
per column tile, not per 64-column tile: the hubert plan (F 163, degrees
``[0:1, 1:94, 2:47, 3:16, 4:4, 5:1]``, 257 used slots) takes 304 slab rows
against 512 column-slots at depth per 64-column tile; the 47 extra rows
are the 8-column tiles that straddle a change of degree.

**Split order.** With ``splits`` blocks along T, B3's block ``s`` sums the
key tiles ``[s * tiles_per_split, (s + 1) * tiles_per_split)`` into a
partial ``(S, n)``, and a second pass adds the partials in split order
``0, 1, ...``: :func:`state_by_splits_ref` is that order in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

__all__ = [
    "COL_TILE",
    "ROW_TILE",
    "NoncausalPack",
    "slab_layout",
    "tile_classes",
    "pack_noncausal",
    "featurize_slab_ref",
    "state_by_splits_ref",
]

# Feature columns of one column tile: the n of one mma tile.
COL_TILE = 8
# Rows (keys or queries) of the tile a kernel featurizes at once.
ROW_TILE = 64
# Column-tile classes of the featurize: 16 warps = 2 row halves x 8
# classes (``kColClasses`` in csrc/rm_featurize_mma.cuh).
COL_CLASSES = 8


def slab_layout(col_deg) -> Tuple[np.ndarray, np.ndarray]:
    """``(tile_row0 [n_ct + 1], slab_index [rows])`` for per-column
    degrees ``col_deg [F]`` (host ints).

    ``tile_row0[c]`` is the first slab row of column tile ``c`` (8 columns,
    the last one padded), ``tile_row0[n_ct]`` the slab's row count. Slab
    row ``r`` holds ``w[j, f]`` flattened as ``j * F + f``, or ``-1`` for a
    zero row (a slot past the column's degree, or a padding column).
    """
    deg = np.asarray(col_deg, dtype=np.int64).reshape(-1)
    f = deg.shape[0]
    n_ct = -(-f // COL_TILE)
    padded = np.zeros(n_ct * COL_TILE, np.int64)
    padded[:f] = deg
    depth = padded.reshape(n_ct, COL_TILE).max(axis=1)
    tile_row0 = np.zeros(n_ct + 1, np.int64)
    tile_row0[1:] = np.cumsum(COL_TILE * depth)
    index = np.full(int(tile_row0[-1]), -1, np.int64)
    for c in range(n_ct):
        for j in range(int(depth[c])):
            for i in range(COL_TILE):
                col = c * COL_TILE + i
                if col < f and j < deg[col]:
                    index[tile_row0[c] + COL_TILE * j + i] = j * f + col
    return tile_row0.astype(np.int32), index


def tile_classes(tile_row0, classes: int = COL_CLASSES) -> np.ndarray:
    """The column tiles of each class, as the kernels read them: the
    classes' starts ``[classes + 1]``, then each class's tiles in ascending
    order. The kernels' featurize gives each class to its own warps, so the
    classes should carry equal depth: longest tile first into the lightest
    class (ties to the lower class); deterministic."""
    depth = np.diff(np.asarray(tile_row0, np.int64)) // COL_TILE
    load = np.zeros(classes, np.int64)
    members = [[] for _ in range(classes)]
    for c in sorted(range(depth.shape[0]), key=lambda c: (-depth[c], c)):
        k = int(np.argmin(load))
        members[k].append(c)
        load[k] += max(int(depth[c]), 1)
    starts = np.cumsum([0] + [len(m) for m in members])
    tiles = [c for m in members for c in sorted(m)]
    return np.asarray(list(starts) + tiles, np.int32)


@dataclasses.dataclass(frozen=True)
class NoncausalPack:
    """The slab and its column vectors, on the slab's device.

    ``slab [rows, d]`` in ``w``'s dtype; ``tile_row0 [n_ct + 1]`` and
    ``class_tiles [COL_CLASSES + 1 + n_ct]`` (:func:`tile_classes`) int32;
    ``col_deg``/``col_scale [n_ct * 8]`` int32 / fp32, the padding columns
    at degree 0 and scale 0; ``tile_rows`` the host copy of ``tile_row0``
    (the kernels' shared-memory plan reads it without a device sync);
    ``num_features`` F; ``tf32_exact`` whether every slab value is a TF32
    number (the rm plans' +-1 and one-hot omegas are), so that an fp32
    kernel may skip the 3xTF32 term of the omegas' low part, which is 0.
    """
    slab: torch.Tensor
    tile_row0: torch.Tensor
    class_tiles: torch.Tensor
    col_deg: torch.Tensor
    col_scale: torch.Tensor
    tile_rows: Tuple[int, ...]
    num_features: int
    tf32_exact: bool

    @property
    def num_col_tiles(self) -> int:
        return len(self.tile_rows) - 1


def _host(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype).reshape(-1)


def pack_noncausal(w: torch.Tensor, col_deg, col_scale) -> NoncausalPack:
    """Lay the packed omegas ``w [kdeg, F, d]`` out as the non-causal
    kernels' slab (module docstring). ``col_deg``/``col_scale [F]`` may be
    host arrays or tensors (a device tensor is copied to the host once:
    pack once per weight set, as ``models.attention.rm_packed_weights``
    does; the TF32 test of the slab reads it back once). The slab is one
    gather of ``w``'s rows: exact in any dtype."""
    kdeg, f, d = w.shape
    deg = _host(col_deg, np.int32)
    scale = _host(col_scale, np.float32)
    if deg.shape[0] != f or scale.shape[0] != f:
        raise ValueError(f"col_deg {deg.shape} / col_scale {scale.shape} do "
                         f"not match w {tuple(w.shape)}")
    if f and int(deg.max()) > kdeg:
        raise ValueError(f"a column of degree {int(deg.max())} exceeds w's "
                         f"{kdeg} slots")
    tile_row0, index = slab_layout(deg)
    n_pad = (len(tile_row0) - 1) * COL_TILE
    dev = w.device
    flat = torch.cat([w.reshape(kdeg * f, d),
                      torch.zeros((1, d), dtype=w.dtype, device=dev)])
    idx = np.where(index < 0, kdeg * f, index)
    slab = flat[torch.from_numpy(idx).to(dev)].contiguous()
    # TF32 keeps 10 of fp32's 23 mantissa bits: the low 13 must be 0
    exact = slab.dtype != torch.float32 or not bool(
        (slab.view(torch.int32) & 0x1FFF).any())
    deg_pad = np.zeros(n_pad, np.int32)
    deg_pad[:f] = deg
    scale_pad = np.zeros(n_pad, np.float32)
    scale_pad[:f] = scale
    return NoncausalPack(
        slab=slab,
        tile_row0=torch.from_numpy(tile_row0).to(dev),
        class_tiles=torch.from_numpy(tile_classes(tile_row0)).to(dev),
        col_deg=torch.from_numpy(deg_pad).to(dev),
        col_scale=torch.from_numpy(scale_pad).to(dev),
        tile_rows=tuple(int(r) for r in tile_row0),
        num_features=f,
        tf32_exact=exact)


def featurize_slab_ref(x: torch.Tensor, pack: NoncausalPack) -> torch.Tensor:
    """``Z(x) [N, F]`` fp32 from the slab, in the kernels' order: per
    column tile and slot one projection ``x . slab[row]``, the running
    product over the slots below each column's degree (slot 0 first), then
    the scale. Equals ``rm_feature_fused_ref`` on ``w [kdeg, F, d]``."""
    n = x.shape[0]
    f = pack.num_features
    proj = x.float() @ pack.slab.float().T                    # [N, rows]
    z = torch.ones((n, pack.num_col_tiles * COL_TILE), dtype=torch.float32,
                   device=x.device)
    deg = pack.col_deg.to(x.device)
    for c in range(pack.num_col_tiles):
        r0, r1 = pack.tile_rows[c], pack.tile_rows[c + 1]
        cols = slice(c * COL_TILE, (c + 1) * COL_TILE)
        for j in range((r1 - r0) // COL_TILE):
            p = proj[:, r0 + COL_TILE * j: r0 + COL_TILE * (j + 1)]
            z[:, cols] = torch.where(j < deg[cols], z[:, cols] * p,
                                     z[:, cols])
    z = z * pack.col_scale.to(x.device)
    return z[:, :f]


def state_by_splits_ref(k, v, kvalid, w, col_deg, col_scale, *, splits: int,
                        tiles_per_split: int):
    """B3's arithmetic in its split-and-reduce order, plain: split ``s``
    sums keys ``[s * tiles_per_split * 64, (s + 1) * tiles_per_split *
    64)`` into a partial ``(S, n)`` (an all-padded or empty split gives a
    zero partial), then the partials are added in split order.

    ``k [BH, T, d]``, ``v [BH, T, dv]``, ``kvalid [BH, T]``, packed ``w
    [kdeg, F, d]`` -> ``(S [BH, F, dv], n [BH, F])`` fp32.
    """
    bh, t, d = k.shape
    if splits * tiles_per_split * ROW_TILE < t:
        raise ValueError(f"{splits} splits of {tiles_per_split} tiles do not "
                         f"cover T={t}")
    zk = rm_feature_fused_ref(k.reshape(bh * t, d), w, col_deg, col_scale)
    zk = zk.reshape(bh, t, -1) * kvalid.float()[..., None]
    vf = v.float()
    s_tot = n_tot = None
    span = tiles_per_split * ROW_TILE
    for s in range(splits):
        part = slice(s * span, min((s + 1) * span, t))
        s_part = torch.einsum("bsf,bsd->bfd", zk[:, part], vf[:, part])
        n_part = zk[:, part].sum(dim=1)
        s_tot = s_part if s_tot is None else s_tot + s_part
        n_tot = n_part if n_tot is None else n_tot + n_part
    return s_tot, n_tot
