"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``):
atomic writes, keep-last-k, a structure check on restore.

Layout, as the reference's: ``<dir>/step_XXXXXXXXXX/state.npz`` (the
flattened state, ``common.tree.flatten_dict`` paths -> numpy arrays) plus
``meta.json`` (step, time, each leaf's shape and dtype). A save writes
``<dir>/tmp.<step>.<pid>`` and then ``os.replace``s it into place, so a
crash mid-save never corrupts the latest checkpoint. ``restore(device=)``
puts every leaf on ``device`` as a tensor of its saved dtype; bf16 leaves
travel as their 16-bit patterns, so every leaf restores bitwise.

A checkpoint always holds full tensors, whatever mesh wrote it: a
sharded Trainer (tensor parallel, or FSDP over ``"data"``) gathers its
shards before rank 0 saves (``distributed.tensor_parallel.
gather_state``), and ``restore(mesh=, cfg=)`` cuts this rank's shards
again, the Trainer's layout on that mesh, so a run moves between model
and data sizes (``train.fault.elastic_remesh``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import (
    flatten_dict,
    tree_map_with_path,
    unflatten_dict,
)
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp

__all__ = ["CheckpointManager"]

_DTYPES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:        # no numpy bf16: keep the bits
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(a)               # a fresh array np.load read
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- paths -----------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def available_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "state.npz").exists():
                steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any,
             extra_meta: Optional[Dict] = None) -> Path:
        """Write ``state`` (a tree of tensors) as checkpoint ``step``."""
        flat = flatten_dict(state)
        leaves = {k: v if torch.is_tensor(v) else torch.as_tensor(v)
                  for k, v in flat.items()}
        tmp = self.dir / f"tmp.{step}.{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "state.npz",
                 **{k: _to_numpy(v) for k, v in leaves.items()})
        meta = {
            "step": step,
            "time": time.time(),
            "leaves": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in leaves.items()},
        }
        if extra_meta:
            meta.update(extra_meta)
        (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)             # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def shapes(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Checkpoint ``step``'s (the latest by default) tree as ``meta``
        tensors of its leaves' shapes and dtypes, read from its
        ``meta.json`` alone."""
        if step is None:
            step = self.latest_step()
        meta = json.loads((self._step_dir(step) / "meta.json").read_text())
        return unflatten_dict({
            k: torch.empty(shape, dtype=_DTYPES[dtype], device="meta")
            for k, (shape, dtype) in meta["leaves"].items()})

    # -- restore ---------------------------------------------------------------
    def restore(self, step: Optional[int] = None, template: Any = None,
                device="cuda", *, mesh=None, cfg=None) -> Dict[str, Any]:
        """Load checkpoint ``step`` (the latest by default) with every leaf
        on ``device``; with a ``mesh`` and the model config ``cfg``, this
        rank's shards of it in a Trainer's layout on that mesh
        (``tensor_parallel.shard_state``: over ``"model"``, and over
        ``"data"`` where ``distributed.fsdp.enabled``), cut on the host;
        without ``cfg``, the whole state, which a model axis above 1
        refuses.

        Raises:
            FileNotFoundError: no checkpoint in the directory.
            ValueError: ``template`` (a tree) has other leaf paths than the
                checkpoint; a model axis above 1 without ``cfg``.
            RuntimeError: ``device`` is CUDA (the default) and there is
                none.
        """
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._step_dir(step)
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "state.npz") as data:
            flat = {k: data[k] for k in data.files}
        if template is not None:
            t_flat = set(flatten_dict(template))
            s_flat = set(flat)
            if t_flat != s_flat:
                missing = t_flat - s_flat
                extra = s_flat - t_flat
                raise ValueError(
                    f"checkpoint structure mismatch: "
                    f"missing={sorted(missing)[:5]} "
                    f"extra={sorted(extra)[:5]}")
        model_cut = mesh is not None and tp.model_size_of(mesh) > 1
        if model_cut and cfg is None:
            raise ValueError("restoring onto a model axis above 1 cuts the "
                             "params by their config: pass cfg=")
        data_cut = mesh is not None and cfg is not None and \
            fsdp.enabled(mesh)
        cut = model_cut or data_cut
        state = unflatten_dict({
            k: _from_numpy(a, meta["leaves"][k][1],
                           "cpu" if cut else device)
            for k, a in flat.items()})
        if not cut:
            return state
        return tree_map_with_path(lambda _, t: t.to(device),
                                  tp.shard_state(state, mesh, cfg,
                                                 fsdp_cut=data_cut))
