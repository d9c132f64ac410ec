"""Assigned input shapes and the (arch x shape) cells (port of
``repro.launch.shapes``).

LM shapes:
  train_4k     seq_len=4096,   global_batch=256  -> train step
  prefill_32k  seq_len=32768,  global_batch=32   -> prefill (serve)
  decode_32k   seq_len=32768,  global_batch=128  -> decode step (1 new
                                                   token, a cache of seq_len)
  long_500k    seq_len=524288, global_batch=1    -> long-context decode step

Skip rules, as the reference's:
  * an encoder-only arch (hubert) has no decode step: decode_32k and
    long_500k are skipped;
  * long_500k needs sub-quadratic attention: an arch that attends runs it
    in the paper's RM linear-attention mode ("rm"); SSM archs run natively.
    Each cell records the attention mode it runs under.

The input specs are ``meta`` tensors: shapes and dtypes, no allocation (the
reference's ``ShapeDtypeStruct`` stand-ins); a dry run sizes a cell from
them and ``distributed.sharding``'s specs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.config import ModelConfig

__all__ = [
    "VLM_PATCHES",
    "ShapeSpec",
    "SHAPES",
    "Cell",
    "enumerate_cells",
    "train_batch_specs",
    "prefill_batch_specs",
    "decode_batch_specs",
    "decode_cache_specs",
    "input_specs",
]

VLM_PATCHES = 256  # vision_stub prefix length carved out of seq_len


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    attention_mode: str            # the mode this cell runs under
    skipped: bool = False
    skip_reason: str = ""


def enumerate_cells(archs: List[str], arch_cfgs: Dict[str, ModelConfig],
                    shapes: Optional[List[str]] = None) -> List[Cell]:
    cells = []
    for arch in archs:
        cfg = arch_cfgs[arch]
        attention_free = not any(
            b.split("_")[0] in ("attn", "mla") for b in cfg.block_pattern)
        for sname in shapes or SHAPES:
            spec = SHAPES[sname]
            if spec.kind == "decode" and not cfg.causal:
                cells.append(Cell(arch, sname, cfg.attention_mode, True,
                                  "encoder-only: no decode step"))
                continue
            mode = cfg.attention_mode
            if sname == "long_500k" and not attention_free:
                mode = "rm"
            cells.append(Cell(arch, sname, mode))
    return cells


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int):
    b, t = global_batch, seq_len
    if cfg.frontend == "audio_stub":
        return {"embeds": _meta((b, t, cfg.d_model), torch.bfloat16),
                "targets": _meta((b, t), torch.int32)}
    if cfg.frontend == "vision_stub":
        t_text = t - VLM_PATCHES
        return {"embeds": _meta((b, VLM_PATCHES, cfg.d_model),
                                torch.bfloat16),
                "tokens": _meta((b, t_text), torch.int32),
                "targets": _meta((b, t_text), torch.int32)}
    return {"tokens": _meta((b, t), torch.int32),
            "targets": _meta((b, t), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int):
    specs = train_batch_specs(cfg, seq_len, global_batch)
    specs.pop("targets", None)
    return specs


def decode_batch_specs(cfg: ModelConfig, global_batch: int):
    return {"tokens": _meta((global_batch, 1), torch.int32),
            "positions": _meta((global_batch,), torch.int32)}


def decode_cache_specs(cfg: ModelConfig, global_batch: int, max_len: int):
    """The decode cache on the ``meta`` device (no allocation)."""
    from repro_torch.models.transformer import init_decode_cache

    return init_decode_cache(cfg, global_batch, max_len, "meta")


def input_specs(cfg: ModelConfig, shape_name: str):
    """The abstract inputs of a cell, keyed by what the step takes.

    Raises:
        KeyError: an unknown shape name.
    """
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        return {"batch": train_batch_specs(cfg, spec.seq_len,
                                           spec.global_batch)}
    if spec.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, spec.seq_len,
                                             spec.global_batch)}
    return {"batch": decode_batch_specs(cfg, spec.global_batch),
            "cache": decode_cache_specs(cfg, spec.global_batch,
                                        spec.seq_len)}
