"""What the paper scripts share: the device clock, handed-over data and
the default map maker."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.feature_map import make_feature_map
from repro_torch.data import make_classification_dataset


def clock(device: torch.device) -> float:
    """Host seconds, after the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def as_tensor(a, device: torch.device) -> torch.Tensor:
    """A handed-over array (numpy, a tensor, anything ``np.asarray``
    reads) as an fp32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def dataset(name: str, datasets: Optional[Dict], device: torch.device
            ) -> Dict[str, torch.Tensor]:
    """``datasets[name]`` handed over, else the port's own stand-in."""
    if datasets is None:
        return make_classification_dataset(name, device=device)
    return {k: as_tensor(v, device) for k, v in datasets[name].items()}


def map_maker(make_map, device: torch.device):
    """``make_map`` as given, else ``make_feature_map(kernel, d, D,
    seed=seed, h01=h01)`` on ``device``."""
    if make_map is not None:
        return make_map

    def default(kernel, d, num_features, seed, h01=False):
        return make_feature_map(kernel, d, num_features, seed=seed, h01=h01,
                                device=device)

    return default
