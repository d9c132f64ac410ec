"""Tensor parallelism over a mesh's ``"model"`` axis: the local view of a
mesh, Megatron style.

The reference leaves partitioning to GSPMD. The port cannot: kernels B1-B4
are custom ops, and DTensor has no sharding rule for them. So each rank
holds plain local tensors and runs the model at its local widths:

* :func:`init_local_params` draws this rank's shards from a seed, block
  by block (how the Trainer and ``launch.serve.make_engine`` draw a
  model onto a mesh); :func:`shard_params` cuts full params (weights
  handed over, a restored checkpoint) into this rank's tensors along the
  ``"model"`` entries of ``distributed.sharding.params_partition_specs``
  (contiguous slices: the fused-head layout keeps query head ``i`` with kv
  head ``i // q_per_kv``), and :func:`gather_params` is its inverse,
  bitwise. Departures from the specs: the MoE expert stacks are cut
  along their ff dim (the reference computes them so,
  ``P(None, None, "model")``); with more model ranks than kv heads each
  rank keeps the one kv head its query heads read (Megatron's rule; the
  reference's GSPMD splits inside a head there); a fused column group
  (Mamba's ``w_in`` ``[x | z]``, the mLSTM's ``w_up`` ``[xu | z]`` and
  ``w_if`` ``[i | f]``, the sLSTM's gate-major ``w_in`` and ``b_in``) is
  cut group by group, each rank keeping its channels or heads of every
  group; and the xLSTM leaves the reference replicates but reads per head
  (the mLSTM's ``w_if``, ``b_if`` and ``gn_scale``, the sLSTM's
  ``r_rec``, ``b_in`` and ``gn_scale``) are cut by head. A Mamba
  ``d_inner``, ``d_ff``, experts' ff or MLA head count the model axis
  does not divide raises ``ValueError``;
  :func:`shard_cache` / :func:`gather_cache` cut decode caches along the
  ``"model"`` entries of ``cache_partition_specs`` the same way.
* :func:`local_config` divides ``num_heads``, ``num_kv_heads``, ``d_ff``,
  the experts' ff and ``vocab_size`` by the model size and returns a
  :class:`LocalConfig`, whose ``model_shards`` the SSM mixers divide their
  inner widths by (Mamba's ``d_inner``, the mLSTM's up-projection, the
  sLSTM's cells), so the model code needs no branch for widths.
* A part whose width the model axis divides in neither direction is kept
  whole on every model rank, as the reference's ``_dedupe_spec``
  replicates such a dim: the attention, mLSTM and sLSTM mixers together
  (they read one ``num_heads``; attention also where its kv heads and
  the axis divide in neither direction) and the vocabulary
  (``LocalConfig.whole`` names them). Their leaves
  and caches are not cut, and their code runs inside
  :func:`whole_part`, where the collectives over ``"model"`` are the
  identity and a block's entry and exit only move the sequence. Where the
  reference's fused 2-D weight does divide (qwen2-7b's ``wq``, 28 heads x
  128 = 3584 columns over 16), GSPMD splits inside a head and the port
  keeps the head whole: the same numbers, more bytes a rank.
* The collectives stand where GSPMD puts them, as autograd functions over
  the model group: :func:`reduce_from_model` (all-reduce forward,
  identity backward) after ``wo`` / ``w_o`` / ``w_down`` / ``w_out`` and
  the MoE's combine, and :func:`copy_to_model` (identity forward,
  all-reduce backward) where a replicated tensor enters a region each
  rank computes a part of; :func:`gather_from_model` joins a rank's
  channels where the next product reads all of them (the mLSTM's conv'd
  input before ``wq`` / ``wk`` / ``wv``, the sLSTM's cells before its
  feed-forward). A block's own input and output pass through
  :func:`enter_block` and :func:`exit_block`.
* ``"act_seq"`` (Megatron's sequence parallelism, on by default as in the
  reference's rules): inside :func:`sequence_sharding`, where the model
  axis divides T (training, prefill), the residual stream between blocks
  is each rank's slice of the sequence (:func:`scatter_sequence`), the
  norms and residual adds run on the slice, :func:`enter_block` is an
  all-gather over the sequence with a reduce-scatter backward and
  :func:`exit_block` a reduce-scatter with an all-gather backward. At
  decode, or where T does not divide, it is replicated, and a rules
  context with ``{"act_seq": None}`` turns it off (the rule is read when
  the Trainer or the serving executor is built, :func:`act_seq_axes`, and
  kept on every view it enters). Each reduce-scatter is
  an all-reduce and this rank's slice, so the numbers are the replicated
  path's bit for bit. The rule ``("data",)`` (the ``sp_data`` lever) cuts
  the stream over ``"data"`` instead, where the rows are not split over
  it (batch 1): each data rank then runs every block on the gathered
  sequence and keeps its slice between blocks.
* Three more rules, read like it when the local config and the cuts are
  made (a rules context around the Trainer's or the Scheduler's
  construction):
  ``{"vocab": None}`` keeps the vocabulary whole on every model rank;
  ``{"kv_heads": None}`` keeps every kv head on every rank while the query
  heads stay cut (``LocalConfig.kv_group``; ``wk`` / ``wv`` are a cut whose
  ``reps`` is the whole axis, their gradients summed over it); and
  ``{"kv_seq": "model"}`` cuts the exact and MLA decode caches by sequence
  (``LocalConfig.kv_seq``, :func:`cache_cuts`): a decode step writes the
  new key on the rank that owns its slot, all-gathers the queries
  (:func:`gather_heads`) and combines each rank's partial softmax by
  log-sum-exp (``models.attention.split_k_combine``).
* The vocabulary is split over ``"model"`` too: a masked local embedding
  lookup then an all-reduce (:func:`vocab_parallel_embed`), local logit
  columns, and a cross entropy whose ``logsumexp`` reduces the max and then
  the sum of exponentials over the group (:func:`vocab_parallel_ce`).

The weight dims on ``"fsdp"`` are cut over ``"data"`` in training and in
serving (``distributed.fsdp``; ``shard_params(fsdp_cut=True)``, and
:func:`gather_params` gathers them back).
The model code reads the view from :func:`local_view`, a context the caller
enters (the Trainer, the serving executor, ``models.moe.apply_moe(mesh=)``).
Outside it, or on a model axis of size 1, every function here returns its
input: ``mesh=None`` is bitwise the single-device path.

    view = local_view_of(mesh)                     # a DeviceMesh, group up
    lcfg = local_config(cfg, view.model_size)
    local, template = init_local_params(cfg, seed, mesh)  # or shard_params
    with local_view(mesh):
        logits_shard, _ = transformer.forward(local, lcfg, batch)
    logits = gather_vocab(logits_shard, lcfg)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.common.tree import tree_get, tree_map_with_path
from repro_torch.distributed import fsdp
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.distributed.sharding import (
    cache_partition_specs,
    mesh_axes,
    params_partition_specs,
    rule,
)
from repro_torch.models.config import ModelConfig

__all__ = [
    "MODEL_AXIS",
    "BATCH_AXES",
    "LocalView",
    "LocalConfig",
    "shards_of",
    "is_whole",
    "whole_part",
    "local_view_of",
    "local_view",
    "restore_view",
    "active",
    "model_view",
    "model_size_of",
    "local_config",
    "kv_replication",
    "param_cuts",
    "shard_params",
    "init_local_params",
    "gather_params",
    "meta_template",
    "shard_state",
    "gather_state",
    "cache_cuts",
    "kv_seq_view",
    "shard_cache",
    "gather_cache",
    "batch_index",
    "reduce_from_model",
    "copy_to_model",
    "gather_from_model",
    "gather_heads",
    "sequence_sharding",
    "scatter_sequence",
    "gather_sequence",
    "sequence_params",
    "enter_block",
    "exit_block",
    "mean_over_batch",
    "sync_replicated_grads",
    "global_grad_norm",
    "vocab_parallel_embed",
    "vocab_parallel_ce",
    "gather_vocab",
]

MODEL_AXIS = "model"
BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class LocalView:
    """This rank's place on a mesh.

    ``model_group`` is the process group of the ``"model"`` axis (None
    when the axis is absent or of size 1); ``batch_groups`` the groups of
    the batch axes (``"pod"``, ``"data"``, each of size above 1) that this
    call's rows are split over, empty where the rows are replicated, and
    ``batch_size`` the product of their sizes; ``seq_axis`` the mesh axis
    the residual stream's sequence is cut over (``"model"`` or
    ``"data"``), with its group and this rank's place in it, set inside
    :func:`sequence_sharding`; ``whole`` whether the code runs a part
    every model rank holds whole (set inside :func:`whole_part`);
    ``gather_batch`` whether the MoE routes the whole batch, its tokens
    gathered over the batch groups (the serving executor's decode step:
    the reference's single-controller step routes every slot together);
    ``data_seq`` whether every data rank runs this call on the same rows,
    so the sequence may be cut over ``"data"`` (not a prefill only the
    slot's owner runs); ``act_seq`` the mesh axes the ``"act_seq"`` rule
    named when the view's owner was built (:func:`act_seq_axes`);
    ``mesh`` the mesh."""

    model_size: int
    model_rank: int
    model_group: Any
    batch_groups: Tuple[Any, ...]
    batch_size: int
    seq_axis: Optional[str] = None
    seq_group: Any = None
    seq_rank: int = 0
    whole: bool = False
    gather_batch: bool = False
    data_seq: bool = True
    act_seq: Tuple[str, ...] = ()
    mesh: Any = None


@dataclasses.dataclass(frozen=True)
class LocalConfig(ModelConfig):
    """A :class:`ModelConfig` at one model rank's widths (what
    :func:`local_config` returns): ``model_shards`` is the model axis its
    widths were divided by, which the SSM mixers divide their inner widths
    by (their sub-configs keep the full model's fields); ``whole`` the
    parts every model rank keeps whole (of ``"attn"``, ``"mlstm"``,
    ``"slstm"`` and ``"vocab"``), at their full widths; ``kv_group``, where
    the ``"kv_heads"`` rule is None and the query heads are cut, the
    model's query heads a kv head (every rank then holds all
    ``num_kv_heads``; 0 elsewhere); ``kv_seq`` whether the exact and MLA
    decode caches are cut by sequence over ``"model"`` (the ``"kv_seq"``
    rule), their decode a split-K over the ranks' slots."""

    model_shards: int = 1
    whole: Tuple[str, ...] = ()
    kv_group: int = 0
    kv_seq: bool = False


def is_whole(cfg, part: str) -> bool:
    """Whether ``cfg`` (a :class:`LocalConfig`) keeps ``part`` whole on
    every model rank."""
    return part in getattr(cfg, "whole", ())


def shards_of(cfg, part: Optional[str] = None) -> int:
    """The model axis ``cfg``'s widths are divided by: a
    :class:`LocalConfig`'s ``model_shards``, 1 for a full config or for a
    ``part`` it keeps whole."""
    if part is not None and is_whole(cfg, part):
        return 1
    return getattr(cfg, "model_shards", 1)


def model_size_of(mesh) -> int:
    """The size of the mesh's ``"model"`` axis (1 where it has none)."""
    return mesh_axes(mesh).get(MODEL_AXIS, 1)


def local_view_of(mesh, *, batch_sharded: bool = True) -> LocalView:
    """The :class:`LocalView` of this rank on ``mesh``.

    Raises:
        RuntimeError: ``mesh`` has no process group behind it (an
            ``AbstractMesh``, or no initialized default group).
    """
    import torch.distributed as dist

    if not hasattr(mesh, "get_group") or not dist.is_initialized():
        raise RuntimeError(
            "tensor parallelism needs a DeviceMesh over an initialized "
            "process group (repro_torch.launch.mesh.init_distributed, then "
            f"make_mesh); got {mesh!r}")
    sizes = mesh_axes(mesh)
    m = sizes.get(MODEL_AXIS, 1)
    group = mesh.get_group(MODEL_AXIS) if m > 1 else None
    rank = mesh.get_local_rank(MODEL_AXIS) if m > 1 else 0
    groups = tuple(mesh.get_group(a) for a in BATCH_AXES
                   if batch_sharded and sizes.get(a, 1) > 1)
    size = math.prod(sizes.get(a, 1) for a in BATCH_AXES) \
        if batch_sharded else 1
    return LocalView(m, rank, group, groups, size, mesh=mesh)


_local = threading.local()


def active() -> Optional[LocalView]:
    """The view :func:`local_view` entered on this thread, or None."""
    return getattr(_local, "view", None)


def model_view() -> Optional[LocalView]:
    """The active view where its model axis is above 1 and the code runs
    a cut part (not inside :func:`whole_part`), else None: the one test
    every model-parallel branch of the model code makes."""
    view = active()
    return view if view is not None and view.model_size > 1 \
        and not view.whole else None


_NO_PART = contextlib.nullcontext()


def whole_part(cfg, part: str):
    """A context to run ``part``'s code in (a mixer kind or ``"vocab"``)
    where ``cfg`` keeps it whole on every model rank: inside,
    :func:`model_view` is None, so every collective over ``"model"`` is the
    identity, and :func:`enter_block` / :func:`exit_block` only gather and
    slice the sequence under ``"act_seq"`` (no sum: each rank computes
    the whole block). A part ``cfg`` cuts gets a shared no-op context."""
    if not is_whole(cfg, part):
        return _NO_PART
    return _whole_view()


@contextlib.contextmanager
def _whole_view() -> Iterator[None]:
    view = active()
    if view is None or view.model_size == 1:
        yield
        return
    prev = _local.view
    _local.view = dataclasses.replace(view, whole=True)
    try:
        yield
    finally:
        _local.view = prev


def act_seq_axes() -> Tuple[str, ...]:
    """The mesh axes the active rules' ``"act_seq"`` entry names (``()``
    where it is None): what the Trainer and the serving executor read at
    their construction and hand to :func:`local_view`, as the other
    levers' rules are read into the local config there."""
    entry = rule("act_seq")
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in axes if a is not None)


@contextlib.contextmanager
def local_view(mesh, *, batch_sharded: bool = True,
               gather_batch: bool = False, data_seq: bool = True,
               act_seq: Optional[Tuple[str, ...]] = None
               ) -> Iterator[LocalView]:
    """Run the model code inside on ``mesh``'s local view.
    ``batch_sharded``: whether the rows the code is given are this rank's
    share of a batch split over the batch axes (so the MoE averages its aux
    losses over them), or replicated; ``gather_batch``: the MoE routes the
    whole batch instead; ``data_seq``: every data rank runs the call, so
    ``"act_seq"`` may cut the sequence over ``"data"``; ``act_seq``: the
    ``"act_seq"`` rule's axes as the caller read them at its construction
    (None: :func:`act_seq_axes` now) (:class:`LocalView`)."""
    prev = active()
    _local.view = dataclasses.replace(
        local_view_of(mesh, batch_sharded=batch_sharded),
        gather_batch=gather_batch, data_seq=data_seq,
        act_seq=act_seq_axes() if act_seq is None else tuple(act_seq))
    try:
        yield _local.view
    finally:
        _local.view = prev


@contextlib.contextmanager
def restore_view(view: Optional[LocalView]) -> Iterator[Optional[LocalView]]:
    """Run the code inside on ``view`` as :func:`active` returned it (None:
    no view), e.g. a checkpointed group's recompute in backward, after the
    forward's contexts have been left."""
    prev = active()
    _local.view = view
    try:
        yield view
    finally:
        _local.view = prev


# ---------------------------------------------------------------------------
# the local config and the cut of the params
# ---------------------------------------------------------------------------
def kv_replication(cfg, model_size: int) -> int:
    """Ranks that hold one kv head under the ``"kv_heads"`` rule
    ``"model"``: 1 where the model axis divides ``num_kv_heads``,
    ``model_size // num_kv_heads`` where the kv heads divide the model
    axis (each rank keeps the kv head its query heads read).

    Raises:
        ValueError: neither divides the other (:func:`local_config` then
            keeps the attention whole).
    """
    hkv = cfg.num_kv_heads
    if hkv % model_size == 0:
        return 1
    if model_size % hkv == 0:
        return model_size // hkv
    raise ValueError(f"{cfg.name}: num_kv_heads={hkv} and the mesh's model "
                     f"axis of {model_size} divide in neither direction")


_HEAD_MIXERS = ("attn", "mlstm", "slstm")


def _divide(name: str, value: int, m: int, cfg) -> None:
    if value % m:
        raise ValueError(f"{cfg.name}: {name}={value} is not divisible by "
                         f"the mesh's model axis of {m}")


def _parts(cfg):
    """``(mixers, ffns)``: the mixer and FFN kinds of ``cfg``'s layers."""
    from repro_torch.models.transformer import _split_kind, layer_kinds

    kinds = [_split_kind(k) for k in layer_kinds(cfg)]
    return {k[0] for k in kinds}, {k[1] for k in kinds}


def _whole_parts(cfg, model_size: int) -> Tuple[str, ...]:
    """The parts of ``cfg`` a model axis of ``model_size`` keeps whole,
    in the order of :data:`_HEAD_MIXERS`, then ``"vocab"``: the head
    mixers together where the axis does not divide ``num_heads``
    (attention's kv heads, the mLSTM's up-projection likewise: they share
    the one ``num_heads``), the vocabulary where it does not divide
    ``vocab_size`` or where the ``"vocab"`` rule is None (the
    ``vocab_unsharded`` lever). The reference's ``_dedupe_spec``
    replicates each such dim.

    Raises:
        ValueError: the axis does not divide MLA's heads, Mamba's
            ``d_inner``, ``d_ff`` or the experts' ff (the message names the
            dim and the axis).
    """
    m = int(model_size)
    if m == 1:
        return ()
    mixers, ffns = _parts(cfg)
    if "mla" in mixers:
        _divide("num_heads", cfg.num_heads, m, cfg)
    if "mamba" in mixers:
        _divide("mamba d_inner", cfg.mamba.expand * cfg.d_model, m, cfg)
    if "mlp" in ffns:
        _divide("d_ff", cfg.d_ff, m, cfg)
    if "moe" in ffns:
        _divide("moe.d_ff_expert", cfg.moe.d_ff_expert, m, cfg)
    heads = cfg.num_heads % m != 0
    if "attn" in mixers and cfg.num_kv_heads % m and m % cfg.num_kv_heads:
        heads = True
    if "mlstm" in mixers and int(cfg.xlstm.proj_factor * cfg.d_model) % m:
        heads = True
    whole = [k for k in _HEAD_MIXERS if heads and k in mixers]
    if cfg.vocab_size % m or rule("vocab") is None:
        whole.append("vocab")
    return tuple(whole)


def _kv_whole(cfg, model_size: int, whole) -> bool:
    """Whether every model rank holds all of a cut attention's kv heads:
    the ``"kv_heads"`` rule is None (the ``kv_seq_shard`` lever's
    second half; the query heads stay cut)."""
    return (model_size > 1 and "attn" in _parts(cfg)[0]
            and "attn" not in whole and rule("kv_heads") is None)


def _kv_seq(cfg, model_size: int, whole) -> bool:
    """Whether the exact and MLA decode caches are cut by sequence over
    ``"model"`` (the ``"kv_seq"`` rule).

    Raises:
        NotImplementedError: ``"kv_seq"`` over another axis, or over
            ``"model"`` where a cut attention's kv heads are cut too (the
            split-K decode reads every kv head on every rank: it needs
            ``"kv_heads"`` None).
    """
    entry = rule("kv_seq")
    if entry is None or model_size == 1:
        return False
    if entry != MODEL_AXIS:
        raise NotImplementedError(
            f"the 'kv_seq' rule {entry!r}: the port cuts decode caches by "
            "sequence over 'model' only")
    if ("attn" in _parts(cfg)[0] and "attn" not in whole
            and not _kv_whole(cfg, model_size, whole)):
        raise NotImplementedError(
            "'kv_seq' over 'model' with the kv heads cut over 'model' too: "
            "the split-K decode keeps every kv head on every rank (rules "
            "{'kv_seq': 'model', 'kv_heads': None})")
    return True


def local_config(cfg, model_size: int):
    """``cfg`` at one model rank's widths, a :class:`LocalConfig`: heads,
    kv heads, ``d_ff``, the experts' ff and the vocabulary divided by
    ``model_size`` (kv heads: 1 where they are replicated,
    :func:`kv_replication`), and ``model_shards`` set for the SSM mixers'
    inner widths (Mamba's ``d_inner``, the mLSTM's up-projection; the
    sLSTM's cells are its heads); the head mixers or the vocabulary the
    axis does not divide (or the rules replicate) are kept whole at their
    full widths (:func:`_whole_parts`, ``LocalConfig.whole``); all the kv
    heads under the ``"kv_heads"`` rule None (``kv_group``) and the
    ``"kv_seq"`` rule's cut (``kv_seq``), both read from the active rules
    context (``sharding.logical_rules_context``, entered around the
    construction of the Trainer or the Scheduler); ``cfg`` itself at
    size 1.

    Raises:
        ValueError: as :func:`_whole_parts`.
        NotImplementedError: as :func:`_kv_seq`.
    """
    m = int(model_size)
    if m == 1:
        return cfg
    whole = _whole_parts(cfg, m)
    _, ffns = _parts(cfg)
    heads, kv = cfg.num_heads, cfg.num_kv_heads
    kv_group = 0
    if not set(_HEAD_MIXERS) & set(whole):
        heads //= m
        if _kv_whole(cfg, m, whole):
            kv_group = cfg.num_heads // kv
        else:
            # a replicated kv head: one a rank (kv_replication); neither
            # way only without attention, where nothing reads it
            kv = kv // m if kv % m == 0 else (1 if m % kv == 0 else kv)
    d_ff = cfg.d_ff // m if "mlp" in ffns else cfg.d_ff
    moe = cfg.moe
    if moe is not None and "moe" in ffns:
        moe = dataclasses.replace(moe, d_ff_expert=moe.d_ff_expert // m)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(
        num_heads=heads, num_kv_heads=kv, head_dim=cfg.resolved_head_dim,
        d_ff=d_ff, moe=moe, vocab_size=cfg.vocab_size if "vocab" in whole
        else cfg.vocab_size // m)
    return LocalConfig(**fields, model_shards=m, whole=whole,
                       kv_group=kv_group,
                       kv_seq=_kv_seq(cfg, m, whole)).validate()


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one leaf is cut over ``"model"``: along ``dim``, each rank
    keeping slice ``rank // reps`` of ``model_size // reps`` (``reps`` > 1:
    ranks that share a replicated kv head) of each of the dim's ``groups``
    equal column groups (a fused ``[x | z]`` projection: 2)."""

    dim: int
    reps: int = 1
    groups: int = 1


_KV_LEAVES = ("wk", "wv", "bk", "bv")
_MOE_FF_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}
# the SSM leaves cut otherwise than (or where) the spec says: (mixer, leaf)
# -> (dim, column groups). Fused groups are cut group by group; the xLSTM's
# per-head leaves the spec replicates are cut by head.
_SSM_CUTS = {
    ("mamba", "w_in"): (1, 2),
    ("mlstm", "w_up"): (1, 2),
    ("mlstm", "w_if"): (1, 2),
    ("mlstm", "b_if"): (0, 2),
    ("mlstm", "gn_scale"): (0, 1),
    ("slstm", "w_in"): (1, 4),
    ("slstm", "b_in"): (0, 4),
    ("slstm", "r_rec"): (1, 1),
    ("slstm", "gn_scale"): (0, 1),
}


def _groups(path) -> int:
    """The column groups of the leaf at ``path`` (1 but for the fused SSM
    projections)."""
    key = tuple(path[-2:]) if len(path) >= 2 else None
    return _SSM_CUTS.get(key, (None, 1))[1]


def param_cuts(params, mesh, cfg):
    """A tree matching ``params`` (FULL widths): a :class:`Cut` for each
    leaf split over ``"model"``, None for each replicated one (every leaf
    of a part :func:`local_config` keeps whole among them). Kv heads every
    model rank holds (the ``"kv_heads"`` rule None) are a cut whose
    ``reps`` is the whole axis: each rank's copy is the whole leaf, and its
    gradient is summed over the ranks (``sync_replicated_grads``)."""
    m = model_size_of(mesh)
    whole = _whole_parts(cfg, m)
    specs = params_partition_specs(params, mesh)
    reps = _kv_reps(cfg, m, whole)

    def one(path, p):
        if m == 1 or _in_whole_part(path, whole):
            return None
        name = path[-1]
        if "moe" in path and name in _MOE_FF_DIM and p.ndim == 3:
            return Cut(_MOE_FF_DIM[name])
        if len(path) >= 2 and tuple(path[-2:]) in _SSM_CUTS:
            dim, groups = _SSM_CUTS[tuple(path[-2:])]
            return Cut(dim, groups=groups)
        if name in _KV_LEAVES and "attn" in path and reps > 1:
            return Cut(p.ndim - 1, reps)
        for dim, entry in enumerate(tree_get(specs, path)):
            if MODEL_AXIS in (entry if isinstance(entry, tuple)
                              else (entry,)):
                return Cut(dim)
        return None

    return tree_map_with_path(one, params)


def _kv_reps(cfg, m: int, whole) -> int:
    """The ranks that hold each kv head of a cut attention (1 without
    one)."""
    if m == 1 or "attn" not in _parts(cfg)[0] or "attn" in whole:
        return 1
    return m if _kv_whole(cfg, m, whole) else kv_replication(cfg, m)


def _in_whole_part(path, whole) -> bool:
    """Whether the params leaf at ``path`` belongs to a part in ``whole``
    (a layer's mixer; the token embedding and unembedding for
    ``"vocab"``)."""
    if path[0] == "layers":
        return len(path) > 2 and path[2] in whole
    return path[0] == "embed" and "vocab" in whole


def _slice(p: torch.Tensor, cut: Optional[Cut], m: int, rank: int):
    if cut is None:
        return p
    parts = m // cut.reps
    pieces = []
    for group in p.chunk(cut.groups, dim=cut.dim):
        width = group.shape[cut.dim] // parts
        pieces.append(group.narrow(cut.dim, (rank // cut.reps) * width,
                                   width))
    return torch.cat(pieces, dim=cut.dim)


def _join(pieces, dim: int, groups: int) -> torch.Tensor:
    """The inverse of :func:`_slice` from the distinct slices, in rank
    order: group by group, each group's slices in order."""
    split = [piece.chunk(groups, dim=dim) for piece in pieces]
    return torch.cat([part[g] for g in range(groups) for part in split],
                     dim=dim)


def _leaf_cutter(template, mesh, cfg, fsdp_cut: bool):
    """``cut(path, p)``: this rank's part of the leaf at ``path`` of a tree
    shaped as ``template`` (full widths; tensors or ``meta``): its
    ``"model"`` slice (:func:`param_cuts`), then, with ``fsdp_cut``, its
    ``"data"`` slice (``fsdp.data_dims``). A cut leaf is a new tensor; a
    whole one is ``p`` itself."""
    view = local_view_of(mesh)
    cuts = param_cuts(template, mesh, cfg)
    dims = fsdp.data_dims(template, mesh) if fsdp_cut else None
    if fsdp_cut:
        data_rank, data_size = fsdp._data_rank(mesh)

    def cut(path, p):
        p = _slice(p, tree_get(cuts, path), view.model_size, view.model_rank)
        dim = None if dims is None else tree_get(dims, path)
        if dim is None:
            return p
        width = p.shape[dim] // data_size
        return p.narrow(dim, data_rank * width, width).clone()

    return cut


def shard_params(params, mesh, cfg, *, fsdp_cut: bool = False):
    """This rank's local tensors of the full ``params`` (new tensors where
    a leaf is cut; a replicated leaf is the caller's tensor); with
    ``fsdp_cut``, each leaf's ``"fsdp"`` dim is then cut over ``"data"``
    too (``distributed.fsdp``, the Trainer's layout and a serving
    executor's on a data axis).

    Raises:
        RuntimeError: ``mesh`` has no process group behind it.
        ValueError: as :func:`local_config`.
    """
    return tree_map_with_path(_leaf_cutter(params, mesh, cfg, fsdp_cut),
                              params)


def init_local_params(cfg, seed: int, mesh, device="cuda", *,
                      fsdp_cut: bool = False):
    """This rank's shards of ``transformer.init_model(cfg)`` from ``seed``
    on ``device``: the same draws as ``train.steps.init_params``, each
    weight cut as soon as it is drawn (over ``"data"`` too with
    ``fsdp_cut``, as :func:`shard_params`), so a rank holds its shards and
    one full weight at most (a model that fits the card only in shards).
    Each part is walked once with ``meta`` stand-ins for its weights
    (``models.layers.drawing``; a copy of the generator takes the other,
    small draws) to learn which leaf each draw becomes; then it is drawn
    for real and each weight is cut at once. The one way the
    port's entry points (``Trainer``, ``launch.serve.make_engine``) draw a
    model onto a mesh.

    Returns ``(params, template)``: the local params and the full params'
    :func:`meta_template` (what :func:`gather_params` and
    :func:`param_cuts` take).

    Raises:
        RuntimeError: as :func:`shard_params`; ``device`` is CUDA and
            there is none.
        ValueError: as :func:`local_config`; a draw of a part does not
            become one of its leaves unchanged.
    """
    from repro_torch import resolve_device
    from repro_torch.models.layers import draw_normal, drawing
    from repro_torch.models.transformer import init_model

    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    shapes = {"embed": None, "layers": [], "final_norm": None}

    def cut(key, draw):
        stand_ins = []

        def stand_in(g, shape, std, dtype):
            stand_ins.append(torch.empty(shape, dtype=dtype, device="meta"))
            return stand_ins[-1]

        probe = torch.Generator(device=gen.device)
        probe.set_state(gen.get_state())
        with drawing(stand_in):
            walked = {key: draw(probe)}
        template = meta_template(walked)
        if key == "layers":
            shapes["layers"].extend(template["layers"])
        else:
            shapes[key] = template[key]
        one = _leaf_cutter(template, mesh, cfg, fsdp_cut)
        where = {}
        tree_map_with_path(lambda path, p: where.setdefault(id(p), path),
                           walked)
        for i, t in enumerate(stand_ins):
            if id(t) not in where:
                raise ValueError(
                    f"init_local_params: draw {i} of part {key!r} (shape "
                    f"{tuple(t.shape)}) does not become one leaf as drawn; "
                    "an init must return each normal_init draw unchanged")
        order = iter([where[id(t)] for t in stand_ins])
        drawn = set()

        def keep_shard(g, shape, std, dtype):
            path = next(order)
            drawn.add(path)
            return one(path, draw_normal(g, shape, std, dtype))

        with drawing(keep_shard):
            sub = {key: draw(gen)}
        return tree_map_with_path(
            lambda path, p: p if path in drawn else one(path, p), sub)[key]

    return init_model(cfg, gen, cut=cut), shapes


def meta_template(tree):
    """``tree`` as ``meta`` tensors: its shapes and dtypes, no storage (the
    template :func:`gather_params` takes)."""
    return tree_map_with_path(
        lambda _, p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        tree)


def _gather_model(path, p, full, view) -> torch.Tensor:
    """One leaf's model slices joined back to ``full``'s shape (one copy
    of a replicated kv head; the column groups of a fused projection)."""
    if tuple(p.shape) == tuple(full):
        return p
    dim = next(i for i, (a, b) in enumerate(zip(p.shape, full)) if a != b)
    reps = view.model_size * p.shape[dim] // full[dim]
    pieces = all_gather(p, view.model_group)
    return _join(pieces[::reps], dim, _groups(path))


def gather_params(local, mesh, template):
    """The full params back from every rank's ``local`` tensors: a leaf
    cut over ``"data"`` (its ``"fsdp"`` dim shorter than ``template``'s)
    is all-gathered over ``"data"`` first, then each leaf whose shape
    still differs from ``template``'s (a tree of full-shaped leaves, e.g.
    :func:`meta_template`) is all-gathered over ``"model"`` and its slices
    joined. Every rank gets the result; the round trip with
    :func:`shard_params` is bitwise.
    """
    view = local_view_of(mesh)
    data = fsdp.data_dims(template, mesh) \
        if mesh_axes(mesh).get(fsdp.DATA_AXIS, 1) > 1 else None

    def one(path, p):
        full = tree_get(template, path).shape
        dim = None if data is None else tree_get(data, path)
        if dim is not None and p.shape[dim] != full[dim]:
            p = fsdp.gather_leaf(p, dim, mesh)
        return _gather_model(path, p, full, view)

    return tree_map_with_path(one, local)


_STATE_PARAM_TREES = ("params", "residuals")


def shard_state(state, mesh, cfg, *, fsdp_cut: bool = False):
    """A train state (``{"params", "opt": {"mu", "nu", "step"}, "step"}``,
    maybe ``"residuals"``) at full widths -> this rank's local state (cut
    over ``"data"`` too with ``fsdp_cut``)."""
    def cut(tree):
        return shard_params(tree, mesh, cfg, fsdp_cut=fsdp_cut)

    out = dict(state)
    for key in _STATE_PARAM_TREES:
        if key in state:
            out[key] = cut(state[key])
    out["opt"] = {**state["opt"], "mu": cut(state["opt"]["mu"]),
                  "nu": cut(state["opt"]["nu"])}
    return out


def gather_state(state, mesh, template):
    """The inverse of :func:`shard_state`; ``template`` is the full
    params' (every param-shaped tree shares it)."""
    out = dict(state)
    for key in _STATE_PARAM_TREES:
        if key in state:
            out[key] = gather_params(state[key], mesh, template)
    out["opt"] = {**state["opt"],
                  "mu": gather_params(state["opt"]["mu"], mesh, template),
                  "nu": gather_params(state["opt"]["nu"], mesh, template)}
    return out


def cache_cuts(cache, mesh, cfg):
    """A tree matching a decode ``cache`` (FULL widths): a :class:`Cut`
    along each leaf's ``"model"`` entry of ``cache_partition_specs``
    (Mamba's ``conv`` / ``ssm`` by channel; the rm state, the mLSTM's
    ``c`` / ``n`` / ``m`` and the sLSTM's ``h`` / ``c`` / ``n`` / ``m`` by
    head; exact attention's ``k`` / ``v`` by kv head, one a rank where the
    kv heads are replicated), None where it stays whole.

    A part :func:`local_config` keeps whole keeps its cache whole, but
    under the ``"kv_seq"`` rule the exact cache's ``k`` / ``v`` and MLA's
    ``c_kv`` / ``k_pe`` are cut by sequence (dim 1, the ring buffer's
    slots) in every part, each rank holding every kv head of its slots.
    """
    m = model_size_of(mesh)
    if m == 1:
        return tree_map_with_path(lambda *_: None, cache)
    from repro_torch.models.transformer import _split_kind, layer_kinds

    whole = _whole_parts(cfg, m)
    mixers = [_split_kind(k)[0] for k in layer_kinds(cfg)]
    specs = cache_partition_specs(cache, mesh)
    reps = _kv_reps(cfg, m, whole)
    kv_whole = _kv_whole(cfg, m, whole)
    by_seq = _kv_seq(cfg, m, whole)

    def one(path, p):
        if by_seq and path[-1] in _SEQ_CACHE_LEAVES:
            return Cut(1)
        if mixers[path[1]] in whole:
            return None
        if path[-1] in ("k", "v") and kv_whole:
            return None
        if path[-1] in ("k", "v") and reps > 1:
            return Cut(2, reps)
        for dim, entry in enumerate(tree_get(specs, path)):
            if MODEL_AXIS in (entry if isinstance(entry, tuple)
                              else (entry,)):
                return Cut(dim)
        return None

    return tree_map_with_path(one, cache)


_SEQ_CACHE_LEAVES = ("k", "v", "c_kv", "k_pe")


def kv_seq_view(cfg) -> Optional[LocalView]:
    """The active view where ``cfg`` (a :class:`LocalConfig`) cuts the
    exact and MLA decode caches by sequence over ``"model"`` (inside a
    :func:`whole_part` too: its cache is cut all the same), else None."""
    view = active()
    if view is None or view.model_size == 1 or \
            not getattr(cfg, "kv_seq", False):
        return None
    return view


def shard_cache(cache, mesh, cfg):
    """This rank's slices of a full decode ``cache`` (:func:`cache_cuts`):
    the cache a rank's prefill returns, and the shapes
    ``transformer.init_decode_cache`` gives at :func:`local_config`'s
    widths."""
    view = local_view_of(mesh)
    cuts = cache_cuts(cache, mesh, cfg)
    return tree_map_with_path(
        lambda path, p: _slice(p, tree_get(cuts, path), view.model_size,
                               view.model_rank), cache)


def gather_cache(cache, mesh, template):
    """The inverse of :func:`shard_cache` (``template`` full-shaped, e.g.
    :func:`meta_template`); bitwise."""
    view = local_view_of(mesh)
    return tree_map_with_path(
        lambda path, p: _gather_model(path, p, tree_get(template, path).shape,
                                      view), cache)


def batch_index(mesh) -> Tuple[int, int]:
    """``(index, parts)``: this rank's share of a batch split over the
    mesh's batch axes, pod-major, and how many shares there are."""
    sizes = mesh_axes(mesh)
    index, parts = 0, 1
    for axis in BATCH_AXES:
        if axis in sizes:
            index = index * sizes[axis] + mesh.get_local_rank(axis)
            parts *= sizes[axis]
    return index, parts


# ---------------------------------------------------------------------------
# the collectives, with their gradients
# ---------------------------------------------------------------------------
def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """An all-reduced copy of ``x`` over each group in turn, summed in
    fp32 (a bf16 or fp16 partial is rounded once, after the sum)."""
    out = x.to(torch.float32, copy=True).contiguous()
    for group in groups:
        all_reduce(out, group)
    return out.to(x.dtype)


class _ReduceForward(torch.autograd.Function):
    """All-reduce (sum, then ``scale``) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, groups, scale):
        out = _sum_over(x, groups)
        return out if scale == 1.0 else out * scale

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce (sum) over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, (ctx.group,)), None


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's partial ``x``: one all-reduce forward,
    identity backward (Megatron's ``g``). ``x`` itself outside a view or on
    a model axis of 1."""
    view = model_view()
    if view is None:
        return x
    return _ReduceForward.apply(x, (view.model_group,), 1.0)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a region each model rank computes a part of: identity
    forward, all-reduce of its gradient backward (Megatron's ``f``). ``x``
    itself outside a view or on a model axis of 1."""
    view = model_view()
    if view is None:
        return x
    return _CopyToModel.apply(x, view.model_group)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward: this rank's slice of
    the gradient, summed over the group first where ``reduce`` (the
    gathered tensor feeds a region each rank computes a part of)."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, reduce):
        ctx.group, ctx.rank, ctx.dim, ctx.reduce = group, rank, dim, reduce
        ctx.width = x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            grad = _sum_over(grad, (ctx.group,))
        return (grad.narrow(ctx.dim, ctx.rank * ctx.width,
                            ctx.width).contiguous(), None, None, None, None)


class _ScatterDim(torch.autograd.Function):
    """Forward: this rank's slice along ``dim``, of the sum over the group
    where ``reduce`` (a reduce-scatter, as an all-reduce and a slice);
    backward: the all-gather of the gradient's slices."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, reduce):
        ctx.group, ctx.dim = group, dim
        out = _sum_over(x, (group,)) if reduce else x
        width = x.shape[dim] // group.size()
        return out.narrow(dim, rank * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (torch.cat(all_gather(grad.contiguous(), ctx.group),
                          dim=ctx.dim), None, None, None, None)


def gather_from_model(x: torch.Tensor, dim: int = -1, *,
                      partial: bool = True) -> torch.Tensor:
    """Every model rank's ``x`` joined along ``dim`` (a rank's channels or
    heads -> all of them): one all-gather forward; backward, this rank's
    slice of the gradient, all-reduced first where ``partial`` (the joined
    tensor feeds a product each rank computes a part of). ``x`` itself
    outside a view or on a model axis of 1."""
    view = model_view()
    if view is None:
        return x
    return _GatherDim.apply(x, view.model_group, view.model_rank,
                            dim % x.ndim, partial)


def _seq_axis(view: Optional[LocalView], seq_len: int) -> Optional[str]:
    """The mesh axis ``"act_seq"`` cuts the residual stream's sequence over
    in this call, after the reference's ``_dedupe_spec``: ``"model"``
    where a model view is active and the axis divides ``seq_len``;
    ``"data"`` (the rule ``("data",)``, the ``sp_data`` lever) where the
    rows are not split over the batch axes (the ``"batch"`` entry would
    take ``"data"`` first), every data rank runs the call and the axis
    divides ``seq_len``; else None (as at any decode, T = 1). The axes
    are the view's (``LocalView.act_seq``).

    Raises:
        NotImplementedError: the rule names other axes.
    """
    axes = view.act_seq if view is not None else ()
    if not axes:
        return None
    if axes == (MODEL_AXIS,):
        on = model_view() is not None and seq_len % view.model_size == 0
        return MODEL_AXIS if on else None
    if axes == (fsdp.DATA_AXIS,):
        size = mesh_axes(view.mesh).get(fsdp.DATA_AXIS, 1)
        on = (size > 1 and not view.batch_groups and view.data_seq
              and seq_len % size == 0)
        return fsdp.DATA_AXIS if on else None
    raise NotImplementedError(
        f"the 'act_seq' rule {axes!r}: the port cuts the residual stream "
        "by sequence over 'model' or over ('data',)")


def gather_heads(x: torch.Tensor) -> torch.Tensor:
    """This rank's query heads ``[B, H / m, ...]`` -> every rank's ``[B,
    H, ...]`` in rank order (one all-gather over ``"model"``, no gradient:
    the split-K decode's queries); ``x`` itself outside a view, on a model
    axis of 1 or in a :func:`whole_part`, where a rank holds every head."""
    view = model_view()
    if view is None:
        return x
    return torch.cat(all_gather(x.contiguous(), view.model_group), dim=1)


@contextlib.contextmanager
def sequence_sharding(seq_len: int) -> Iterator[bool]:
    """Inside: the residual stream cut by sequence over the mesh axis
    ``"act_seq"`` names, where :func:`_seq_axis` finds one; yields whether
    it is. Over ``"model"`` the model ranks share each block's work; over
    ``"data"`` each data rank runs every block on the whole sequence (its
    rows are every data rank's) and keeps its slice between blocks."""
    view = active()
    axis = _seq_axis(view, seq_len)
    if axis is None:
        yield False
        return
    if axis == MODEL_AXIS:
        group, rank = view.model_group, view.model_rank
    else:
        group = view.mesh.get_group(axis)
        rank = view.mesh.get_local_rank(axis)
    prev = _local.view
    _local.view = dataclasses.replace(view, seq_axis=axis, seq_group=group,
                                      seq_rank=rank)
    try:
        yield True
    finally:
        _local.view = prev


def _seq_view() -> Optional[LocalView]:
    """The active view inside :func:`sequence_sharding` (inside a
    :func:`whole_part` too), else None."""
    view = active()
    return view if view is not None and view.seq_axis is not None else None


def scatter_sequence(x: torch.Tensor) -> torch.Tensor:
    """A replicated ``[B, T, ...]`` -> this rank's slice of the sequence
    (all-gather backward) inside :func:`sequence_sharding`; else ``x``."""
    view = _seq_view()
    if view is None:
        return x
    return _ScatterDim.apply(x, view.seq_group, view.seq_rank, 1, False)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the sequence -> the whole ``[B, T, ...]``,
    replicated (backward: the gradient's slice) inside
    :func:`sequence_sharding`; else ``x``. For a mixer whose input feeds
    replicated and per-rank products alike (MLA, the MoE), which then
    keep their own :func:`copy_to_model`."""
    view = _seq_view()
    if view is None:
        return x
    return _GatherDim.apply(x, view.seq_group, view.seq_rank, 1, False)


def sequence_params(tree):
    """Replicated params read on this rank's slice of the sequence (the
    norms between blocks, a bias added after :func:`exit_block`): inside
    :func:`sequence_sharding` each leaf's gradient, each rank's part from
    its positions, is summed over the sequence's group (identity
    forward); ``tree`` itself elsewhere."""
    view = _seq_view()
    if view is None:
        return tree
    return tree_map_with_path(
        lambda _, p: _CopyToModel.apply(p, view.seq_group), tree)


def enter_block(x: torch.Tensor) -> torch.Tensor:
    """A block's input ``[B, T, d]`` entering its per-rank products: the
    sequence all-gathered inside :func:`sequence_sharding` (backward: over
    ``"model"`` a reduce-scatter, or in a :func:`whole_part` this rank's
    slice of the gradient unsummed; over ``"data"`` the slice unsummed,
    then :func:`copy_to_model`), else :func:`copy_to_model`."""
    view = _seq_view()
    if view is None:
        return copy_to_model(x)
    if view.seq_axis == MODEL_AXIS:
        return _GatherDim.apply(x, view.model_group, view.model_rank, 1,
                                not view.whole)
    return copy_to_model(_GatherDim.apply(x, view.seq_group, view.seq_rank,
                                          1, False))


def exit_block(y: torch.Tensor, *, partial: bool = True) -> torch.Tensor:
    """A block's output ``[B, T, d]``, each rank's part where ``partial``
    (replicated otherwise, as in a :func:`whole_part`): inside
    :func:`sequence_sharding` over ``"model"`` reduce-scattered over the
    sequence (all-gather backward), sliced where replicated; over
    ``"data"`` :func:`reduce_from_model` where ``partial``, then sliced;
    else :func:`reduce_from_model` (``y`` itself where replicated)."""
    view = _seq_view()
    if view is None:
        return reduce_from_model(y) if partial else y
    if view.seq_axis == MODEL_AXIS:
        return _ScatterDim.apply(y, view.model_group, view.model_rank, 1,
                                 partial and not view.whole)
    if partial:
        y = reduce_from_model(y)
    return _ScatterDim.apply(y, view.seq_group, view.seq_rank, 1, False)


def mean_over_batch(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks the batch is split over (one
    all-reduce an axis forward, identity backward: each rank's loss uses
    the same mean, and the data-parallel gradient average then counts each
    rank's share once). ``x`` itself where the rows are not split."""
    view = active()
    if view is None or not view.batch_groups:
        return x
    return _ReduceForward.apply(x, view.batch_groups, 1.0 / view.batch_size)


def sync_replicated_grads(grads, cuts):
    """Sum the gradients of replicated kv heads over the ranks that share
    each head (in place), so every copy of a head steps alike."""
    view = model_view()
    if view is None:
        return grads
    m, rank = view.model_size, view.model_rank

    def one(path, g):
        cut = tree_get(cuts, path)
        if cut is None or cut.reps == 1:
            return g
        parts = m // cut.reps
        shape = list(g.shape)
        shape[cut.dim] *= parts
        full = torch.zeros(shape, dtype=torch.float32, device=g.device)
        w = g.shape[cut.dim]
        full.narrow(cut.dim, (rank // cut.reps) * w, w).copy_(g)
        all_reduce(full, view.model_group)
        g.copy_(full.narrow(cut.dim, (rank // cut.reps) * w, w))
        return g

    tree_map_with_path(one, grads)
    return grads


def global_grad_norm(grads, cuts, plan=None) -> torch.Tensor:
    """The 2-norm of the FULL gradient from this rank's local ``grads``:
    each leaf's sum of squares weighted so that one all-reduce over
    ``"model"`` counts it once (a split leaf 1, a replicated leaf ``1 /
    model_size``, a kv head replicated on ``reps`` ranks ``1 / reps``) and,
    with an FSDP ``plan`` (``distributed.fsdp.Plan``), one more over
    ``"data"`` (a leaf cut over it 1, a replicated one ``1 / size``).
    Outside a view and without ``plan`` it is
    ``optim.adamw.global_norm``."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.optim.adamw import global_norm

    view = model_view()
    if view is None and plan is None:
        return global_norm(grads)
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(grads)[0].device)

    def one(path, g):
        nonlocal total
        w = 1.0
        if view is not None:
            cut = tree_get(cuts, path)
            w = 1.0 / view.model_size if cut is None else 1.0 / cut.reps
        if plan is not None and tree_get(plan.dims, path) is None:
            w = w / plan.size
        total = total + torch.sum(torch.square(g.float())) * w

    tree_map_with_path(one, grads)
    if view is not None:
        all_reduce(total, view.model_group)
    if plan is not None:
        all_reduce(total, plan.group)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# the vocabulary over "model"
# ---------------------------------------------------------------------------
def vocab_parallel_embed(table: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the full embedding from this rank's vocab slice ``table
    [V / m, d]``: the tokens this rank owns are looked up, the rest are
    zero, and one all-reduce over ``"model"`` sums the slices."""
    view = model_view()
    vl = table.shape[0]
    local = tokens - view.model_rank * vl
    own = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)] * own[..., None].to(table.dtype)
    return reduce_from_model(rows)


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor):
    """``(lse, picked)`` of the full logits from this rank's vocab columns
    ``logits [..., V / m]`` (fp32): the ``logsumexp`` from an all-reduce of
    the max and then of the sum of exponentials, and the target logit
    from the shard that owns it (0 for targets < 0)."""
    view = model_view()
    vl = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    all_reduce(mx, view.model_group, op="max")
    sumexp = torch.exp(logits - mx[..., None]).sum(dim=-1)
    lse = mx + torch.log(reduce_from_model(sumexp))
    local = targets.long() - view.model_rank * vl
    own = (local >= 0) & (local < vl)
    picked = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])
    picked = reduce_from_model(picked[..., 0] * own.to(logits.dtype))
    return lse, picked


def gather_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The full-vocabulary logits from every model rank's columns (one
    all-gather over ``"model"``, no gradient); ``logits`` itself outside a
    view, on a model axis of 1 or where ``cfg`` (the local config the
    logits came from) keeps the vocabulary whole."""
    view = model_view()
    if view is None or is_whole(cfg, "vocab"):
        return logits
    return torch.cat(all_gather(logits.detach(), view.model_group), dim=-1)
