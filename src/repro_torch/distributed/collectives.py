"""The collectives of the mesh paths, each counted.

``all_reduce``, ``all_gather`` and ``broadcast`` wrap ``torch.distributed``'s
on a process group (a ``DeviceMesh`` dim's group), and each adds one to its
``calls`` where it starts its collective, as the kernel wrappers count
launches: the sharded estimator's contract (one ``all_reduce`` a Gram) is
checked by reading ``all_reduce.calls`` around a call, and
``all_reduce.by_group`` counts them per group. Each also adds the bytes of
its result on this rank to its ``nbytes`` (the reduced tensor, every
rank's pieces gathered, the tensor broadcast: the reference's dry run
counts a collective's result shape the same way), which the dry run
(``launch.dryrun``) reads. The port's reduce-scatter is an all-reduce and
a slice, so it counts as an all-reduce.

The dry run's group is PyTorch's fake process group (backend ``"fake"``
over ``torch.testing._internal.distributed.fake_pg.FakeStore``): every
call returns at once with no peer, on ``meta`` tensors too, and is
counted here like any other. NCCL takes CUDA tensors and
gloo CPU or CUDA tensors; the backend is the group's own, chosen once
(``launch.mesh.init_distributed``).
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["all_reduce", "all_gather", "broadcast"]

_OPS = ("sum", "max")


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (``"sum"`` or ``"max"``) and
    return it.

    Raises:
        ValueError: an unknown ``op``.
    """
    import torch.distributed as dist

    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    all_reduce.calls += 1
    all_reduce.by_group[group] = all_reduce.by_group.get(group, 0) + 1
    all_reduce.nbytes += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return t


all_reduce.calls = 0
all_reduce.by_group = {}     # the calls on each process group
all_reduce.nbytes = 0        # the bytes of the results on this rank


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the group's rank order."""
    import torch.distributed as dist

    all_gather.calls += 1
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    all_gather.nbytes += len(out) * t.numel() * t.element_size()
    dist.all_gather(out, t.contiguous(), group=group)
    return out


all_gather.calls = 0
all_gather.nbytes = 0


def broadcast(t: torch.Tensor, group, group_src: int) -> torch.Tensor:
    """Overwrite ``t`` in place with the ``t`` of the group's rank
    ``group_src`` (in the group's rank order) and return it."""
    import torch.distributed as dist

    broadcast.calls += 1
    broadcast.nbytes += t.numel() * t.element_size()
    dist.broadcast(t, src=dist.get_global_rank(group, group_src),
                   group=group)
    return t


broadcast.calls = 0
broadcast.nbytes = 0
