"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Two pieces, as in the reference:

1. **Activation constraints.** Models call ``constrain(x, logical_axes)``
   at block boundaries. Outside a ``logical_rules_context`` it is a no-op,
   so models run unmodified on one device. Inside one, every rank already
   holds its local view (its rows over the batch axes; its heads, ff and
   vocabulary over ``"model"``: ``distributed.tensor_parallel``, whose
   collectives stand where GSPMD puts them), so ``constrain`` checks the
   rank of ``x`` against the logical axes and returns ``x`` unchanged.
   Five rules also switch the local view's layouts, read through
   :func:`rule`: ``"act_seq"`` (the residual stream cut by sequence over
   ``"model"``, or over ``("data",)`` at batch 1,
   ``tensor_parallel.sequence_sharding``), ``"fsdp"`` (the weights cut
   over ``"data"``, ``distributed.fsdp``), ``"vocab"`` and ``"kv_heads"``
   (``None``: the vocabulary, or every kv head, whole on every model
   rank) and ``"kv_seq"`` (``"model"``: the decode caches cut by
   sequence, ``tensor_parallel.cache_cuts``); a rules context that maps
   one to ``None`` switches it off, as the reference's overrides do.

2. **Parameter specs.** ``params_partition_specs`` maps every parameter
   leaf to a :class:`PartitionSpec` from a name-based rule table (TP over
   ``"model"``, FSDP over ``"data"``, DP over ``("pod", "data")``, EP over
   ``"model"``); ``cache_partition_specs``, ``batch_partition_specs`` and
   ``estimator_param_specs`` do the same for decode caches, input batches
   and the sharded estimator's stacked params. The rules are the
   reference's, table for table.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a :class:`AbstractMesh`: axis names and
sizes with no process group behind it, which is how the tests hold these
functions against the reference's and how a dry run sizes ``meta``
tensors. The port keeps one dict per layer under ``params["layers"]``
where the reference stacks scanned layers on a leading axis, so a layer's
spec here is the reference's stacked spec without its leading ``None``.

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` (``Shard(dim)`` or ``Replicate()`` per mesh dim); this slice
places the sharded estimator's leading shard dim with it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

__all__ = [
    "FEATURE_AXIS",
    "DEFAULT_RULES",
    "PartitionSpec",
    "P",
    "AbstractMesh",
    "mesh_axes",
    "set_default_rules",
    "logical_rules_context",
    "rule",
    "active_rules",
    "spec_for",
    "constrain",
    "params_partition_specs",
    "estimator_param_specs",
    "cache_partition_specs",
    "batch_partition_specs",
    "placements",
]

# THE feature axis: random-feature columns (and the stacked per-shard
# estimator params behind them) shard over this name. It is the logical
# axis of the rule table below and the mesh axis of
# ``launch.mesh.make_feature_mesh`` / ``distributed.estimator``.
FEATURE_AXIS = "rm_features"

# logical axis -> mesh axis (or tuple of mesh axes, or None)
DEFAULT_RULES: Dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,           # ("pod", "data") for long-context SP
    # Megatron-style sequence parallelism of the residual stream over the
    # TP axis (replicated where T % tp != 0, as at decode)
    "act_seq": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,
    "fsdp": "data",        # weight dim sharded for ZeRO-style FSDP
    FEATURE_AXIS: None,    # in-model estimator params replicate
    "state": "model",
    "layers": None,
    # decode KV-cache sequence dim: None = replicated over model
    "kv_seq": None,
}


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis name, a tuple of names (the dim
    split over their product), or ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group behind them."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`.

    Raises:
        ValueError: a ``DeviceMesh`` without ``mesh_dim_names``.
    """
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the mesh has no mesh_dim_names; build it with "
                         "repro_torch.launch.mesh.make_mesh")
    return dict(zip(names, tuple(mesh.shape)))


_local = threading.local()


def _active() -> Optional[Tuple[Any, Dict[str, object]]]:
    return getattr(_local, "ctx", None)


def set_default_rules(rules: Dict[str, object]) -> None:
    DEFAULT_RULES.update(rules)


def _merged(rules: Optional[Dict[str, object]]) -> Dict[str, object]:
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    return merged


@contextlib.contextmanager
def logical_rules_context(mesh, rules: Optional[Dict[str, object]] = None):
    """Activate ``mesh`` and the rules for :func:`constrain` and
    :func:`spec_for`, with the mesh axes the mesh lacks dropped (no
    ``"pod"`` on a single-pod mesh)."""
    names = mesh_axes(mesh)

    def _filter(axis):
        if axis is None:
            return None
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a in names)
            return kept if kept else None
        return axis if axis in names else None

    merged = {k: _filter(v) for k, v in _merged(rules).items()}
    prev = _active()
    _local.ctx = (mesh, merged)
    try:
        yield merged
    finally:
        _local.ctx = prev


def rule(name: str):
    """The mesh axis the logical axis ``name`` maps to: the active rules
    context's entry (``None`` where that context's mesh lacks the axis),
    else ``DEFAULT_RULES``'."""
    ctx = _active()
    return (ctx[1] if ctx is not None else DEFAULT_RULES).get(name)


def active_rules() -> Optional[Dict[str, object]]:
    """The active rules context's rules (what :func:`rule` reads), or None
    outside one: what the Trainer keeps at its construction to cut its
    state under."""
    ctx = _active()
    return None if ctx is None else dict(ctx[1])


def spec_for(logical_axes: Tuple[Optional[str], ...],
             rules: Optional[Dict[str, object]] = None) -> PartitionSpec:
    if rules is None:
        ctx = _active()
        if ctx is None:
            return P()
        rules = ctx[1]
    return P(*(rules.get(a) if a is not None else None
               for a in logical_axes))


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    """Outside a rules context: ``x``. Inside one: ``x`` after a rank
    check (the data-parallel ranks already hold their rows; see the module
    docstring).

    Raises:
        ValueError: ``logical_axes`` does not have one entry a dim of x.
    """
    if _active() is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"rank mismatch: {logical_axes} vs "
                         f"{tuple(x.shape)}")
    return x


# ---------------------------------------------------------------------------
# parameter rules (matched on the leaf's name; an expert-stacked leaf gets a
# leading "experts" axis when its rank exceeds the rule)
# ---------------------------------------------------------------------------
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embedding": ("vocab", "embed"),
    "unembed": ("fsdp", "vocab"),
    # attention (2D fused-head weights)
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    # MLA
    "w_q": ("fsdp", "heads"),
    "w_dkv": ("fsdp", None),
    "w_ukv": (None, "heads"),
    "w_o": ("heads", "fsdp"),
    "kv_norm_scale": (None,),
    # MLP
    "w_gate": ("fsdp", "ffn"),
    "w_up": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    "b_up": ("ffn",),
    "b_down": (None,),
    # MoE (expert-stacked 3D leaves: padded by rank below)
    "router": (None, None),
    "shared_gate": ("fsdp", "ffn"),
    "shared_up": ("fsdp", "ffn"),
    "shared_down": ("ffn", "fsdp"),
    # mamba
    "w_in": ("fsdp", "state"),
    "conv_w": (None, "state"),
    "conv_b": ("state",),
    "x_proj": ("state", None),
    "dt_proj": (None, "state"),
    "dt_bias": ("state",),
    "a_log": ("state", None),
    "d_skip": ("state",),
    "w_out": ("state", "fsdp"),
    # xlstm
    "w_if": ("fsdp", None),
    "b_if": (None,),
    "r_rec": (None, None, None, None),
    "gn_scale": (None,),
    "ff_up": ("fsdp", "ffn"),
    "ff_down": ("ffn", "fsdp"),
    # estimator params ("rm_est": small, frozen): replicated
    "rm_omegas": (None, None),
    "omegas": (None, None),
    "h": (None, None),
    "s": (None, None),
    "wr": (None, None),
    "wi": (None, None),
    "rm_scale": (),
    # norms
    "scale": (None,),
    "bias": (None,),
    "pos_embedding": (None, "embed"),
}


def _leaf_spec(path: Tuple[Any, ...], ndim: int,
               rules: Dict[str, object]) -> PartitionSpec:
    """The rule of the leaf's name, padded at the front to its rank: with
    ``"experts"`` then ``"layers"`` under a MoE module, ``"layers"``
    elsewhere, then ``None``; cut to the last ``ndim`` entries."""
    name = path[-1]
    base = _PARAM_RULES.get(name)
    if base is None:
        base = tuple(None for _ in range(ndim))
    logical = list(base)
    in_moe = any(p == "moe" for p in path)
    pad_order = ("experts", "layers") if in_moe else ("layers",)
    pad_i = 0
    while len(logical) < ndim and pad_i < len(pad_order):
        logical.insert(0, pad_order[pad_i])
        pad_i += 1
    while len(logical) < ndim:
        logical.insert(0, None)
    logical = logical[-ndim:] if len(logical) > ndim else logical
    return P(*(rules.get(a) if a is not None else None for a in logical))


def _dedupe_spec(spec: PartitionSpec, shape: Tuple[int, ...],
                 axes: Mapping[str, int]) -> PartitionSpec:
    """Drop mesh axes that appear twice or do not divide the dim."""
    used = set()
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        kept = [a for a in names if a not in used and a in axes]
        if not kept or dim % math.prod(axes[a] for a in kept) != 0:
            out.append(None)
            continue
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else kept[0])
    return P(*out)


def _walk(node, path, fn):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, path + (i,), fn) for i, v in enumerate(node)]
    return fn(path, tuple(node.shape))


def params_partition_specs(params_tree, mesh,
                           rules: Optional[Dict[str, object]] = None):
    """A tree of :class:`PartitionSpec` matching ``params_tree`` (tensors,
    ``meta`` tensors or anything with a ``shape``)."""
    merged, axes = _merged(rules), mesh_axes(mesh)
    return _walk(params_tree, (), lambda path, shape: _dedupe_spec(
        _leaf_spec(path, len(shape), merged), shape, axes))


# ---------------------------------------------------------------------------
# estimator param subtrees
# ---------------------------------------------------------------------------
# Two layouts, as in the reference: the in-model ``rm_est`` subtree is
# REPLICATED (the name rules above); the sharded estimator's stacked
# per-shard params are FEATURE-SHARDED: a leading shard dim on the
# "rm_features" axis, shard s owning the s-th sub-map's draws and columns.
def estimator_param_specs(params_stacked, mesh, axis: str = FEATURE_AXIS):
    """Specs for stacked per-shard estimator params (leaves ``[S, ...]``):
    the leading dim over ``axis``, the rest replicated; a leading dim the
    axis size does not divide falls back to replicated."""
    axes = mesh_axes(mesh)
    return _walk(params_stacked, (), lambda _, shape: _dedupe_spec(
        P(axis, *(None for _ in shape[1:])), shape, axes))


# decode-cache leaves, matched by name (rank of one layer's leaf)
_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_pe": ("batch", "kv_seq", None),
    "rm_s": ("batch", "heads", None, None),
    "rm_n": ("batch", "heads", None),
    "conv": ("batch", None, "state"),
    "ssm": ("batch", "state", None),
    "c": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads", None),   # sLSTM rank 3; the mLSTM's rank 2 cut
    "h": ("batch", "heads", None),
}


def cache_partition_specs(cache_tree, mesh,
                          rules: Optional[Dict[str, object]] = None):
    """Specs for decode caches: batch over the DP axes, heads and state over
    ``"model"``; an indivisible dim (batch 1) falls back to replicated."""
    merged, axes = _merged(rules), mesh_axes(mesh)

    def one(path, shape):
        base = _CACHE_RULES.get(path[-1])
        nd = len(shape)
        if base is None:
            logical = ["batch"] + [None] * (nd - 1)
        else:
            logical = list(base)[:nd]
            logical += [None] * (nd - len(logical))
        spec = P(*(merged.get(a) if a is not None else None
                   for a in logical))
        return _dedupe_spec(spec, shape, axes)

    return _walk(cache_tree, (), one)


def batch_partition_specs(batch_tree, mesh,
                          rules: Optional[Dict[str, object]] = None,
                          seq_sharded: bool = False):
    """Input batch specs: the batch dim over ``("pod", "data")``; with
    ``seq_sharded`` the sequence dim over the ``"seq"`` rule too."""
    merged, axes = _merged(rules), mesh_axes(mesh)
    batch_axes = merged.get("batch")

    def one(_, shape):
        nd = len(shape)
        if nd == 0:
            return P()
        entries = [batch_axes]
        if seq_sharded and nd >= 2:
            entries.append(merged.get("seq"))
        entries += [None] * (nd - len(entries))
        return _dedupe_spec(P(*entries), shape, axes)

    return _walk(batch_tree, (), one)


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one a
    mesh dim, ``Shard(d)`` where tensor dim d is split over that mesh axis,
    ``Replicate()`` where no dim is.

    Raises:
        ValueError: the spec splits one dim over several mesh axes (a
            nested shard, the next slice's), or names an axis the mesh
            lacks.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, tuple):
            if len(entry) != 1:
                raise ValueError(f"dim {dim} is split over {entry}: one "
                                 "mesh axis a dim in this slice")
            entry = entry[0]
        if entry not in names:
            raise ValueError(f"mesh axis {entry!r} not in {names}")
        out[names.index(entry)] = Shard(dim)
    return out
