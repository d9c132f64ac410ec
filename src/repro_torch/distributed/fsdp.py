"""FSDP over ``"data"`` for the Trainer: ZeRO-3, the reference's
``"fsdp": "data"`` rule.

The cut. Each leaf whose spec (``distributed.sharding.
params_partition_specs`` of the FULL params) puts ``"data"`` on a dim is
cut along that dim into the data ranks' contiguous slices
(:func:`data_dims`, :func:`shard`); the params, AdamW's ``mu`` and ``nu``
and the int8 residuals alike, so the optimizer steps on the local shard
alone. A dim the data size does not divide stays replicated (the spec's
dedupe, as the reference's ``_dedupe_spec``), as do the leaves the rules
leave whole (norm scales, biases, the embedding table, the estimator
draws). On a ``"model"`` axis above 1 the model cut comes first
(``tensor_parallel.shard_params``); the two cuts never share a dim.

The step. Inside :func:`training` (``train.steps.make_train_step``)
``models.transformer.forward`` gathers a block's weights just before the
block (:func:`block`): one all-gather over ``"data"`` for all of the
block's cut leaves, cast to the compute dtype first (half the bytes in
bf16), through an autograd function whose backward weights each rank's
gradient by its share of the target tokens (the weight
``train.steps``' data-parallel average gives it), sums it over
``"data"`` in fp32 and keeps this rank's slice: the gradient lands as the
local shard, summed over the data ranks, and the step divides it by their
count as it divides the replicated leaves' all-reduced sums. So the fp32
numbers are the replicated run's. The gathered weights are not kept for
backward: a saved-tensor hook swaps each saved tensor whose storage is a
gathered weight for a handle, and backward gathers the block again at the
first such handle it unpacks (one all-gather a block), freeing it once
the block's last handle is unpacked.

Under activation checkpointing (``ModelConfig.remat``, the default) the
gather runs inside each checkpointed group, without the saved-tensor
hook: checkpoint keeps nothing of the group, and its recompute in
backward gathers each block again. So a rank makes, a step, one
all-gather a block in forward and one a block of the groups in the
recompute (the ``first_k_dense`` blocks, the final norm and the
unembedding, which are not checkpointed, gather again through the hook).

The reduce-scatter is an all-reduce and this rank's slice
(``tensor_parallel._sum_over``): the bytes of an all-reduce, and the sums
of the replicated path bit for bit.

Serving (``serve.executor.StepExecutor(mesh=)``) takes the same cut of
its weights: the compute copy of a rank's slices is made once, and
``models.transformer.prefill`` / ``decode_step`` run inside
:func:`training` with a serving plan (``Plan.serving``), where
:func:`block` gathers a block's slices (already in
the compute dtype) just before it, with no autograd function and no
hooks, and frees them after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, List, Optional

import torch

from repro_torch.common.tree import tree_get, tree_map_with_path
from repro_torch.distributed.collectives import all_gather, all_reduce

__all__ = ["DATA_AXIS", "Plan", "data_dims", "enabled", "shard",
           "gather_leaf", "plan_for_mesh", "active", "training", "block"]

DATA_AXIS = "data"


def enabled(mesh) -> bool:
    """Whether a Trainer or a serving executor on ``mesh`` cuts its
    weights over ``"data"``: a
    data axis above 1 and the ``"fsdp"`` rule on (``sharding.rule``;
    ``logical_rules_context(mesh, rules={"fsdp": None})`` turns it off)."""
    from repro_torch.distributed.sharding import mesh_axes, rule

    return mesh_axes(mesh).get(DATA_AXIS, 1) > 1 and rule("fsdp") == \
        DATA_AXIS


def data_dims(params, mesh):
    """A tree matching ``params`` (FULL shapes; tensors or ``meta``
    templates): the dim each floating leaf is cut along over ``"data"``,
    None where it stays replicated."""
    from repro_torch.distributed.sharding import params_partition_specs

    specs = params_partition_specs(params, mesh)

    def one(path, p):
        if not p.is_floating_point():
            return None
        for dim, entry in enumerate(tree_get(specs, path)):
            if DATA_AXIS in (entry if isinstance(entry, tuple)
                             else (entry,)):
                return dim
        return None

    return tree_map_with_path(one, params)


def _data_rank(mesh):
    from repro_torch.distributed.sharding import mesh_axes

    return (mesh.get_local_rank(DATA_AXIS),
            mesh_axes(mesh)[DATA_AXIS])


def shard(tree, mesh, dims):
    """This rank's data slices of ``tree``'s leaves along ``dims`` (new
    tensors; a replicated leaf is the caller's tensor)."""
    rank, size = _data_rank(mesh)

    def one(path, p):
        dim = tree_get(dims, path)
        if dim is None:
            return p
        width = p.shape[dim] // size
        return p.narrow(dim, rank * width, width).clone()

    return tree_map_with_path(one, tree)


def gather_leaf(p: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """One leaf's data slices joined along ``dim`` (no gradient)."""
    return torch.cat(all_gather(p, mesh.get_group(DATA_AXIS)), dim=dim)


@dataclasses.dataclass
class Plan:
    """What a step's forward reads: the data group, this rank's index in
    it and its size, the params' :func:`data_dims`, the weight of this
    rank's gradient (its share of the target tokens times the data size
    over their sum: exactly 1 for equal shares), and whether it serves
    (forward only: the params are the compute copy's slices)."""

    group: Any
    rank: int
    size: int
    dims: Any
    weight: Any = 1.0
    serving: bool = False


def plan_for_mesh(mesh, dims, *, serving: bool = False) -> Plan:
    """The :class:`Plan` of this rank on ``mesh`` with ``dims``."""
    rank, size = _data_rank(mesh)
    return Plan(mesh.get_group(DATA_AXIS), rank, size, dims,
                serving=serving)


_local = threading.local()


def active() -> Optional[Plan]:
    """The plan :func:`training` entered on this thread, or None."""
    return getattr(_local, "plan", None)


@contextlib.contextmanager
def training(plan: Optional[Plan]) -> Iterator[Optional[Plan]]:
    """Run a step's forward and backward (a train step's), or its forward
    alone (a serving plan's), with ``plan`` active (None: no FSDP, a
    no-op)."""
    prev = active()
    _local.plan = plan
    try:
        yield plan
    finally:
        _local.plan = prev


def _gather_flat(plan: Plan, leaves: List[torch.Tensor], dims: List[int],
                 dtype) -> List[torch.Tensor]:
    """The full leaves from every rank's slices: one all-gather of the
    flattened slices in ``dtype``."""
    flat = torch.cat([p.to(dtype).reshape(-1) for p in leaves])
    pieces = all_gather(flat, plan.group)
    out, at = [], 0
    for p, dim in zip(leaves, dims):
        n = p.numel()
        out.append(torch.cat([piece[at:at + n].view(p.shape)
                              for piece in pieces], dim=dim))
        at += n
    return out


class _GatherBlock(torch.autograd.Function):
    """Forward: the block's cut leaves gathered over ``"data"`` in the
    compute dtype. Backward: each gradient, weighted, summed over
    ``"data"`` in fp32 (one all-reduce a block) and cut to this rank's
    slice, in the leaf's own dtype."""

    @staticmethod
    def forward(ctx, plan, dims, dtype, *leaves):
        ctx.plan, ctx.dims = plan, dims
        ctx.shapes = [p.shape for p in leaves]
        ctx.dtypes = [p.dtype for p in leaves]
        return tuple(_gather_flat(plan, list(leaves), dims, dtype))

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        device = next(g.device for g in grads if g is not None)
        fulls = []
        for g, shape, dim in zip(grads, ctx.shapes, ctx.dims):
            full = list(shape)
            full[dim] *= plan.size
            fulls.append(torch.zeros(full, dtype=torch.float32, device=device)
                         if g is None else g.float() * plan.weight)
        flat = torch.cat([f.reshape(-1) for f in fulls])
        all_reduce(flat, plan.group)
        out, at = [], 0
        for f, shape, dim, dtype in zip(fulls, ctx.shapes, ctx.dims,
                                        ctx.dtypes):
            n = f.numel()
            width = shape[dim]
            out.append(flat[at:at + n].view(f.shape).narrow(
                dim, plan.rank * width, width).to(dtype).contiguous())
            at += n
        return (None, None, None, *out)


class _Regather:
    """The saved-tensor hooks of one gathered block: a saved tensor whose
    storage is one of the gathered weights is packed as (this, index,
    its view's geometry) and unpacked from the block gathered again,
    which is kept until the block's last such tensor is unpacked."""

    def __init__(self, plan, leaves, dims, dtype, fulls):
        self.plan, self.leaves, self.dims, self.dtype = (plan, leaves, dims,
                                                         dtype)
        self.index = {f.untyped_storage().data_ptr(): i
                      for i, f in enumerate(fulls)}
        self.pending = 0
        self.cache = None

    def pack(self, t):
        i = self.index.get(t.untyped_storage().data_ptr()) \
            if t.layout == torch.strided and t.device.type != "meta" \
            else None
        if i is None:
            return t
        self.pending += 1
        return (self, i, t.size(), t.stride(), t.storage_offset())

    @staticmethod
    def unpack(obj):
        if not isinstance(obj, tuple):
            return obj
        self, i, size, stride, offset = obj
        if self.cache is None:
            with torch.no_grad():
                self.cache = _gather_flat(self.plan, self.leaves, self.dims,
                                          self.dtype)
        full = self.cache[i]
        self.pending -= 1
        if self.pending == 0:
            self.cache = None
        return full.as_strided(size, stride, offset)


@contextlib.contextmanager
def block(plan: Optional[Plan], path, sub, dtype, *,
          regather: bool = True) -> Iterator[Any]:
    """``sub`` (the params at ``path``, e.g. ``("layers", i)``) with each
    cut leaf replaced by its gathered compute-dtype tensor, for the block's
    forward inside the context; ``sub`` itself where ``plan`` is None or
    nothing in it is cut. ``regather``: whether backward gathers the block
    again through saved-tensor hooks (off inside a checkpointed group). A
    serving plan's leaves are gathered as they are, with no gradient."""
    if plan is None:
        yield sub
        return
    dims = tree_get(plan.dims, path)
    cut = []
    tree_map_with_path(lambda p, d: cut.append(p) if d is not None else None,
                       dims)
    if not cut:
        yield sub
        return
    leaves = [tree_get(sub, p) for p in cut]
    dim_list = [tree_get(dims, p) for p in cut]
    if plan.serving:
        fulls = [None] * len(leaves)
        for dt in sorted({p.dtype for p in leaves}, key=str):
            at = [i for i, p in enumerate(leaves) if p.dtype == dt]
            got = _gather_flat(plan, [leaves[i] for i in at],
                               [dim_list[i] for i in at], dt)
            for i, full in zip(at, got):
                fulls[i] = full
    else:
        fulls = _GatherBlock.apply(plan, dim_list, dtype, *leaves)
    gathered = dict(zip(cut, fulls))
    out = tree_map_with_path(lambda p, leaf: gathered.get(p, leaf), sub)
    if plan.serving or not regather:
        yield out
        return
    hooks = _Regather(plan, [p.detach() for p in leaves], dim_list, dtype,
                      fulls)
    with torch.autograd.graph.saved_tensors_hooks(hooks.pack, hooks.unpack):
        yield out
