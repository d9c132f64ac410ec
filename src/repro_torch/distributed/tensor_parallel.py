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
  bitwise. Two departures from the specs: the MoE expert stacks are cut
  along their ff dim (the reference computes them so,
  ``P(None, None, "model")``), and with more model ranks than kv heads
  each rank keeps the one kv head its query heads read (Megatron's rule;
  the reference's GSPMD splits inside a head there). A dim the model axis
  divides in neither direction raises ``ValueError``.
* :func:`local_config` divides ``num_heads``, ``num_kv_heads``, ``d_ff``,
  the experts' ff and ``vocab_size`` by the model size, so the model code
  needs no branch for widths.
* The collectives stand where GSPMD puts them, as two autograd functions
  over the model group: :func:`reduce_from_model` (all-reduce forward,
  identity backward) after ``wo`` / ``w_o`` / ``w_down`` and the MoE's
  combine, and :func:`copy_to_model` (identity forward, all-reduce
  backward) where the block's input, or a replicated weight, enters a
  region each rank computes a part of.
* The vocabulary is split over ``"model"`` too: a masked local embedding
  lookup then an all-reduce (:func:`vocab_parallel_embed`), local logit
  columns, and a cross entropy whose ``logsumexp`` reduces the max and then
  the sum of exponentials over the group (:func:`vocab_parallel_ce`).

Activations between blocks stay replicated over ``"model"``; weight dims
on ``"fsdp"`` stay replicated over ``"data"``. The model code reads the
view from :func:`local_view`, a context the caller enters (the Trainer, the
serving executor, ``models.moe.apply_moe(mesh=)``). Outside it, or on a
model axis of size 1, every function here returns its input: ``mesh=None``
is bitwise the single-device path.

    view = local_view_of(mesh)                     # a DeviceMesh, group up
    lcfg = local_config(cfg, view.model_size)
    local, template = init_local_params(cfg, seed, mesh)  # or shard_params
    with local_view(mesh):
        logits_shard, _ = transformer.forward(local, lcfg, batch)
    logits = gather_vocab(logits_shard)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.common.tree import tree_get, tree_map_with_path
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.distributed.sharding import mesh_axes, params_partition_specs

__all__ = [
    "MODEL_AXIS",
    "BATCH_AXES",
    "LocalView",
    "local_view_of",
    "local_view",
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
    "batch_index",
    "reduce_from_model",
    "copy_to_model",
    "mean_over_batch",
    "sync_replicated_grads",
    "global_grad_norm",
    "vocab_parallel_embed",
    "vocab_parallel_ce",
    "gather_vocab",
]

MODEL_AXIS = "model"
BATCH_AXES = ("pod", "data")
# the mixers this slice shards; Mamba's "state" dims and xLSTM's ff_up /
# ff_down wait for the third part of ROADMAP.md queue A item 7
_SSM_MIXERS = ("mamba", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class LocalView:
    """This rank's place on a mesh.

    ``model_group`` is the process group of the ``"model"`` axis (None
    when the axis is absent or of size 1); ``batch_groups`` the groups of
    the batch axes (``"pod"``, ``"data"``, each of size above 1) that this
    call's rows are split over, empty where the rows are replicated, and
    ``batch_size`` the product of their sizes."""

    model_size: int
    model_rank: int
    model_group: Any
    batch_groups: Tuple[Any, ...]
    batch_size: int


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
    return LocalView(m, rank, group, groups, size)


_local = threading.local()


def active() -> Optional[LocalView]:
    """The view :func:`local_view` entered on this thread, or None."""
    return getattr(_local, "view", None)


def model_view() -> Optional[LocalView]:
    """The active view where its model axis is above 1, else None: the
    one test every model-parallel branch of the model code makes."""
    view = active()
    return view if view is not None and view.model_size > 1 else None


@contextlib.contextmanager
def local_view(mesh, *, batch_sharded: bool = True) -> Iterator[LocalView]:
    """Run the model code inside on ``mesh``'s local view.
    ``batch_sharded``: whether the rows the code is given are this rank's
    share of a batch split over the batch axes (so the MoE averages its aux
    losses over them), or replicated."""
    prev = active()
    _local.view = local_view_of(mesh, batch_sharded=batch_sharded)
    try:
        yield _local.view
    finally:
        _local.view = prev


# ---------------------------------------------------------------------------
# the local config and the cut of the params
# ---------------------------------------------------------------------------
def _divide(name: str, value: int, m: int, cfg) -> int:
    if value % m:
        raise ValueError(f"{cfg.name}: {name}={value} is not divisible by "
                         f"the mesh's model axis of {m}")
    return value // m


def kv_replication(cfg, model_size: int) -> int:
    """Ranks that hold one kv head: 1 where the model axis divides
    ``num_kv_heads``, ``model_size // num_kv_heads`` where the kv heads
    divide the model axis (each rank keeps the kv head its query heads
    read).

    Raises:
        ValueError: neither divides the other.
    """
    hkv = cfg.num_kv_heads
    if hkv % model_size == 0:
        return 1
    if model_size % hkv == 0:
        return model_size // hkv
    raise ValueError(f"{cfg.name}: num_kv_heads={hkv} and the mesh's model "
                     f"axis of {model_size} divide in neither direction")


def local_config(cfg, model_size: int):
    """``cfg`` at one model rank's widths: heads, kv heads, ``d_ff``, the
    experts' ff and the vocabulary divided by ``model_size`` (kv heads: 1
    where they are replicated, :func:`kv_replication`); ``cfg`` itself at
    size 1.

    Raises:
        NotImplementedError: a Mamba or xLSTM mixer under a model axis
            above 1 (the third part of ROADMAP.md queue A item 7).
        ValueError: a width the model axis does not divide (the message
            names the dim and the axis).
    """
    m = int(model_size)
    if m == 1:
        return cfg
    from repro_torch.models.transformer import _split_kind, layer_kinds

    kinds = layer_kinds(cfg)
    mixers = {_split_kind(k)[0] for k in kinds}
    ssm = sorted(mixers & set(_SSM_MIXERS))
    if ssm:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism for the {', '.join(ssm)} "
            f"mixer(s) on a model axis of {m} is the third part of "
            "ROADMAP.md queue A item 7; a model axis of 1 trains and serves "
            "them data-parallel")
    dh = cfg.resolved_head_dim
    heads = _divide("num_heads", cfg.num_heads, m, cfg)
    reps = kv_replication(cfg, m)
    kv = cfg.num_kv_heads // m if reps == 1 else 1
    ffns = {_split_kind(k)[1] for k in kinds}
    d_ff = _divide("d_ff", cfg.d_ff, m, cfg) if "mlp" in ffns else cfg.d_ff
    moe = cfg.moe
    if moe is not None and "moe" in ffns:
        moe = dataclasses.replace(moe, d_ff_expert=_divide(
            "moe.d_ff_expert", moe.d_ff_expert, m, cfg))
    return dataclasses.replace(
        cfg, num_heads=heads, num_kv_heads=kv, head_dim=dh, d_ff=d_ff,
        vocab_size=_divide("vocab_size", cfg.vocab_size, m, cfg),
        moe=moe).validate()


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one leaf is cut over ``"model"``: along ``dim``, each rank
    keeping slice ``rank // reps`` of ``model_size // reps`` (``reps`` > 1:
    ranks that share a replicated kv head)."""

    dim: int
    reps: int = 1


_KV_LEAVES = ("wk", "wv", "bk", "bv")
_MOE_FF_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1}


def param_cuts(params, mesh, cfg):
    """A tree matching ``params`` (FULL widths): a :class:`Cut` for each
    leaf split over ``"model"``, None for each replicated one.

    Raises:
        ValueError: as :func:`local_config`.
    """
    m = model_size_of(mesh)
    local_config(cfg, m)                  # validates every width
    specs = params_partition_specs(params, mesh)
    reps = kv_replication(cfg, m) if m > 1 else 1

    def one(path, p):
        if m == 1:
            return None
        name = path[-1]
        if "moe" in path and name in _MOE_FF_DIM and p.ndim == 3:
            return Cut(_MOE_FF_DIM[name])
        if name in _KV_LEAVES and "attn" in path and reps > 1:
            return Cut(p.ndim - 1, reps)
        for dim, entry in enumerate(tree_get(specs, path)):
            if MODEL_AXIS in (entry if isinstance(entry, tuple)
                              else (entry,)):
                return Cut(dim)
        return None

    return tree_map_with_path(one, params)


def _slice(p: torch.Tensor, cut: Optional[Cut], m: int, rank: int):
    if cut is None:
        return p
    parts = m // cut.reps
    width = p.shape[cut.dim] // parts
    return p.narrow(cut.dim, (rank // cut.reps) * width, width).clone()


def shard_params(params, mesh, cfg):
    """This rank's local tensors of the full ``params`` (new tensors where
    a leaf is cut; a replicated leaf is the caller's tensor).

    Raises:
        RuntimeError: ``mesh`` has no process group behind it.
        ValueError: as :func:`local_config`.
    """
    view = local_view_of(mesh)
    cuts = param_cuts(params, mesh, cfg)
    return tree_map_with_path(
        lambda path, p: _slice(p, tree_get(cuts, path),
                               view.model_size, view.model_rank), params)


def init_local_params(cfg, seed: int, mesh, device="cuda"):
    """This rank's shards of ``transformer.init_model(cfg)`` from ``seed``
    on ``device``: the same draws as ``train.steps.init_params``, each
    block cut as soon as it is drawn, so a rank holds its shards and one
    full block at most (a model that fits the card only in shards). The
    one way the port's entry points (``Trainer``, ``launch.serve.
    make_engine``) draw a model onto a mesh.

    Returns ``(params, template)``: the local params and the full params'
    :func:`meta_template` (what :func:`gather_params` and
    :func:`param_cuts` take).

    Raises:
        RuntimeError: as :func:`shard_params`; ``device`` is CUDA and
            there is none.
        ValueError, NotImplementedError: as :func:`local_config`.
    """
    from repro_torch import resolve_device
    from repro_torch.models.transformer import init_model

    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    shapes = {"embed": None, "layers": [], "final_norm": None}

    def cut(key, sub):
        if key == "layers":
            shapes["layers"].extend(meta_template(sub))
        else:
            shapes[key] = meta_template(sub)
        return shard_params({key: sub}, mesh, cfg)[key]

    return init_model(cfg, gen, cut=cut), shapes


def meta_template(tree):
    """``tree`` as ``meta`` tensors: its shapes and dtypes, no storage (the
    template :func:`gather_params` takes)."""
    return tree_map_with_path(
        lambda _, p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        tree)


def gather_params(local, mesh, template):
    """The full params back from every rank's ``local`` tensors: each leaf
    whose shape differs from ``template``'s (a tree of full-shaped leaves,
    e.g. :func:`meta_template`) is all-gathered over ``"model"`` and its
    slices concatenated (one copy of a replicated kv head). Every rank
    gets the result; the round trip with :func:`shard_params` is bitwise.
    """
    view = local_view_of(mesh)
    m = view.model_size

    def one(path, p):
        full = tree_get(template, path).shape
        if tuple(p.shape) == tuple(full):
            return p
        dim = next(i for i, (a, b) in enumerate(zip(p.shape, full))
                   if a != b)
        reps = m * p.shape[dim] // full[dim]
        pieces = all_gather(p, view.model_group)
        return torch.cat(pieces[::reps], dim=dim)

    return tree_map_with_path(one, local)


_STATE_PARAM_TREES = ("params", "residuals")


def shard_state(state, mesh, cfg):
    """A train state (``{"params", "opt": {"mu", "nu", "step"}, "step"}``,
    maybe ``"residuals"``) at full widths -> this rank's local state."""
    out = dict(state)
    for key in _STATE_PARAM_TREES:
        if key in state:
            out[key] = shard_params(state[key], mesh, cfg)
    out["opt"] = {**state["opt"],
                  "mu": shard_params(state["opt"]["mu"], mesh, cfg),
                  "nu": shard_params(state["opt"]["nu"], mesh, cfg)}
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


def global_grad_norm(grads, cuts) -> torch.Tensor:
    """The 2-norm of the FULL gradient from this rank's local ``grads``:
    each leaf's sum of squares weighted so that one all-reduce over
    ``"model"`` counts it once (a split leaf 1, a replicated leaf ``1 /
    model_size``, a kv head replicated on ``reps`` ranks ``1 / reps``).
    Outside a view it is ``optim.adamw.global_norm``."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.optim.adamw import global_norm

    view = model_view()
    if view is None:
        return global_norm(grads)
    m = view.model_size
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(grads)[0].device)

    def one(path, g):
        nonlocal total
        cut = tree_get(cuts, path)
        w = 1.0 / m if cut is None else 1.0 / cut.reps
        total = total + torch.sum(torch.square(g.float())) * w

    tree_map_with_path(one, grads)
    all_reduce(total, view.model_group)
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


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The full-vocabulary logits from every model rank's columns (one
    all-gather over ``"model"``, no gradient); ``logits`` itself outside a
    view or on a model axis of 1."""
    view = model_view()
    if view is None:
        return logits
    return torch.cat(all_gather(logits.detach(), view.model_group), dim=-1)
