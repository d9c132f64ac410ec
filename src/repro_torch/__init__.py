"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and names so each counterpart is easy to find (``core/plan.py`` here
is ``core/plan.py`` there). It never imports ``jax`` or ``repro``: what it
needs from a reference module it keeps as its own copy.

Device rule. Entry points take ``device`` and default to ``"cuda"``; only an
explicit ``device="cpu"`` runs on the CPU (the tests do). Each hand-written
CUDA kernel sits behind a wrapper that takes the kernel's plain PyTorch
version ONLY for a CPU tensor; a CUDA tensor launches the kernel or raises.

Numerics. fp32 matrix products and convolutions run in full fp32: importing
this package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. Kernel inputs may be fp32 or
bf16; accumulation is always fp32 (``common.dtypes.Precision``).

PyTorch runs eagerly: there is no jit cache to warm.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """Normalize a ``device`` argument and refuse CUDA where there is none.

    Raises:
        RuntimeError: a CUDA device was asked for (the default of every
            entry point) but ``torch.cuda.is_available()`` is False — the
            port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
