"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``):
atomic writes, keep-last-k, a structure check on restore.

Layout, as the reference's: ``<dir>/step_XXXXXXXXXX/state.npz`` (the
flattened state, ``common.tree.flatten_dict`` paths -> numpy arrays) plus
``meta.json`` (step, time, each leaf's shape and dtype). A save writes
``<dir>/tmp.<step>.<pid>`` and then ``os.replace``s it into place, so a
crash mid-save never corrupts the latest checkpoint. ``restore(device=)``
puts every leaf on ``device`` as a tensor of its saved dtype; bf16 leaves
travel as their 16-bit patterns, so every leaf restores bitwise.
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
from repro_torch.common.tree import flatten_dict, unflatten_dict

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

    # -- restore ---------------------------------------------------------------
    def restore(self, step: Optional[int] = None, template: Any = None,
                device="cuda") -> Dict[str, Any]:
        """Load checkpoint ``step`` (the latest by default) with every leaf
        on ``device``.

        Raises:
            FileNotFoundError: no checkpoint in the directory.
            ValueError: ``template`` (a tree) has other leaf paths than the
                checkpoint.
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
        return unflatten_dict({
            k: _from_numpy(a, meta["leaves"][k][1], device)
            for k, a in flat.items()})
