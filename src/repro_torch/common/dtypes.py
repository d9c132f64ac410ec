"""Mixed-precision policies (port of ``repro.common.dtypes``).

``Precision`` is the FEATURE-KERNEL policy: which dtype x and the packed
omega tensor enter the kernels in. Accumulation is ALWAYS fp32: the CUDA
kernels convert each loaded element to fp32 and keep every running product
and sum in fp32 registers or shared memory, and the plain versions upcast
before every product. The Rademacher omegas take values in {+-1}, so bf16
storage of them is lossless; only x is rounded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = [
    "canonical_dtype",
    "Precision",
    "PRECISION_FP32",
    "PRECISION_BF16",
    "PRECISIONS",
    "resolve_precision",
]


def canonical_dtype(name: str) -> torch.dtype:
    return {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
        "int8": torch.int8,
        "int32": torch.int32,
    }[name]


@dataclasses.dataclass(frozen=True)
class Precision:
    """Input dtype policy for the feature kernels; ``accum`` is fp32 for
    every built-in policy (bf16-in / fp32-accum, never bf16 accumulation)."""

    name: str
    compute: str
    accum: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return canonical_dtype(self.compute)

    @property
    def accum_dtype(self) -> torch.dtype:
        return canonical_dtype(self.accum)


PRECISION_FP32 = Precision(name="fp32", compute="float32")
PRECISION_BF16 = Precision(name="bf16", compute="bfloat16")

PRECISIONS = {p.name: p for p in (PRECISION_FP32, PRECISION_BF16)}


def resolve_precision(
    precision: Optional[Union[str, Precision]] = None,
) -> Precision:
    """``None`` -> fp32, a name -> ``PRECISIONS[name]``, a record passes.

    Raises:
        ValueError: unknown name, naming the available ones.
    """
    if precision is None:
        return PRECISION_FP32
    if isinstance(precision, Precision):
        return precision
    try:
        return PRECISIONS[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; "
            f"available: {tuple(sorted(PRECISIONS))}"
        ) from None
