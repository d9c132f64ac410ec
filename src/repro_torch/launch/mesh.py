"""Device meshes over the default process group (port of
``repro.launch.mesh``).

The reference builds its meshes over ``jax.devices()``; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with the reference's axis names. So a mesh needs an
initialized process group: :func:`init_distributed` makes one (under
``torchrun`` from its environment, otherwise a world of one over a
``FileStore``, which needs no TCP port), and every mesh function raises
without one rather than starting a group on its own.

``make_production_mesh`` is a function, not a module-level constant, so
importing this module touches no device or process group.

    device = init_distributed(device="cpu")        # gloo, a world of one
    mesh = make_host_mesh()                        # ("data", "model")
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device

__all__ = [
    "init_distributed",
    "mesh_device",
    "make_mesh",
    "make_host_mesh",
    "make_feature_mesh",
    "make_production_mesh",
]


def init_distributed(backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Initialize the default process group once and return this rank's
    device.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) rank
    r joins the launcher's group and, on CUDA, binds to ``cuda:LOCAL_RANK``.
    Otherwise a world of one is made over a ``FileStore`` in a fresh
    temporary directory, removed when the process exits. ``device`` defaults to ``"cuda"``; the backend to
    NCCL for CUDA and gloo for the CPU, unless the caller names one. If the
    default group exists already, nothing is initialized and the device is
    returned as above.

    Raises:
        RuntimeError: ``device`` is CUDA and there is none.
    """
    import torch.distributed as dist

    dev = resolve_device("cuda" if device is None else device)
    torchrun = all(k in os.environ
                   for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if dev.type == "cuda":
        index = (int(os.environ["LOCAL_RANK"]) if torchrun
                 else dev.index if dev.index is not None
                 else torch.cuda.current_device())
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if torchrun:
        dist.init_process_group(backend, init_method="env://")
    else:
        root = tempfile.mkdtemp(prefix="repro_torch_pg_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(root, "store"), 1),
            rank=0, world_size=1)
    return dev


def _device_type() -> str:
    """The default mesh device type: ``cuda`` under NCCL, ``cpu`` under
    gloo (gloo over CUDA tensors names ``device_type="cuda"``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "repro_torch.launch.mesh.init_distributed() (or "
            "torch.distributed.init_process_group) first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: ``cuda:<current>`` or ``cpu``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, its
    dims named ``axes`` (tests, elastic reconfiguration).

    Raises:
        RuntimeError: no default process group, or ``shape`` does not hold
            exactly its world of ranks.
    """
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dtype = device_type or _device_type()
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise RuntimeError(f"mesh {tuple(shape)} {tuple(axes)} needs "
                           f"{math.prod(shape)} ranks; the process group "
                           f"has {world}")
    return init_device_mesh(dtype, tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(model_parallel: int = 1):
    """``("data", "model")`` over every rank of the default group.

    Raises:
        ValueError: ``model_parallel`` does not divide the world size.
    """
    import torch.distributed as dist

    _device_type()                      # raises without a process group
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {n} ranks")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"))


def make_feature_mesh(num_shards: Optional[int] = None,
                      device_type: Optional[str] = None):
    """A one-axis mesh whose axis is the logical feature axis
    ``"rm_features"``: the sharded estimator (``repro_torch.distributed.
    estimator``) gives each rank one shard's params and feature columns and
    reduces a Gram with one ``all_reduce``. Defaults to every rank."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import FEATURE_AXIS

    _device_type()                      # raises without a process group
    n = dist.get_world_size() if num_shards is None else num_shards
    return make_mesh((n,), (FEATURE_AXIS,), device_type)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16 x 16 single-pod (256 ranks) or 2 x 16 x 16 two-pod (512
    ranks) mesh.

    Raises:
        RuntimeError: the default group does not have that many ranks.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
