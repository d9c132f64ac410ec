"""Request records of the serving path (port of the dataclasses of
``repro.serve.engine``; the deprecated ``ServingEngine`` is not ported)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["Request", "RequestState"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # [T] int token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: Optional[int] = None
    priority: int = 0                   # higher admits first
    accuracy_tier: Optional[str] = None  # a key of the Scheduler's
    #   accuracy_tiers, resolved to a feature generation count and
    #   certified on the admit event / RequestState.tier_features


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int
    generated: List[int] = dataclasses.field(default_factory=list)
    position: int = 0                   # next position to decode
    done: bool = False
    finish_reason: Optional[str] = None  # "eos"|"max_new_tokens"|"cache_full"
    t_enqueue: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_tokens: List[float] = dataclasses.field(default_factory=list)
    admissions: int = 0                 # times admitted (> 1 after eviction)
    tier_features: Optional[int] = None  # feature budget certified for
    #   the request's accuracy tier (None: no tier, the full budget)
