"""Where-did-this-number-come-from stamp (port of
``repro.common.env.platform_provenance``; the reference module's platform
and XLA-flag knobs have no counterpart in a PyTorch process)."""
from __future__ import annotations

import torch

__all__ = ["platform_provenance"]


def platform_provenance() -> dict:
    """One dict attached to metrics snapshots and trace headers
    (``repro_torch.obs``): the backend (``"cuda"`` where a card is visible,
    else ``"cpu"``), the device kind and count, and the library versions.

    ``interpret`` is always False (the port never interprets a kernel: a
    CPU tensor takes the kernel's plain PyTorch version) and
    ``jax_version`` is None (the port has no jax); both keys are kept
    because the trace checker (``tools/check_trace.py``) requires them.
    """
    cuda = torch.cuda.is_available()
    return {
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "interpret": False,
        "jax_version": None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
