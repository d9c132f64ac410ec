"""The step executor: model calls and the batched decode cache (port of
``repro.serve.executor``).

The executor owns everything that touches the device: construction-time
config validation (causal, attention mode, estimator, precision, fusion
mode), the prefill bucket ladder, the compute-dtype copy of the weights
(made once), the batched decode cache (``num_slots`` lanes, spliced per
admission: the rm decode state, or exact attention's ring-buffer KV
cache), and the prefill and decode calls. PyTorch runs eagerly, so there is no compile
cache; CUDA graphs for the decode step are later work.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    cast_params_to_compute,
    decode_step,
    init_decode_cache,
    prefill,
)

__all__ = ["DEFAULT_BUCKETS", "StepExecutor", "effective_buckets"]

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def effective_buckets(buckets: Sequence[int], max_len: int) -> Tuple[int, ...]:
    """Clip a bucket ladder to the lengths ``max_len`` can serve: every
    bucket strictly below ``max_len``, then ``max_len`` itself."""
    ladder = tuple(int(b) for b in buckets)
    if not ladder:
        raise ValueError("buckets must be a non-empty sequence of ints")
    if any(b <= 0 for b in ladder):
        raise ValueError(f"buckets must all be positive, got {ladder}")
    if any(b >= nxt for b, nxt in zip(ladder, ladder[1:])):
        raise ValueError(
            f"buckets must be strictly increasing, got {ladder}")
    return tuple(b for b in ladder if b < max_len) + (int(max_len),)


class StepExecutor:
    """Owns the weights, the batched decode cache and the step calls.

    Args:
        cfg: frozen model config (validated here).
        params: model parameters (``models.transformer.init_model`` or
            ``convert.params_from_jax``), on ``device``.
        num_slots: decode lanes in the batched cache.
        max_len: per-lane length; position ``max_len - 1`` is the scratch
            position idle lanes decode into.
        buckets: prefill bucket ladder (default :data:`DEFAULT_BUCKETS`),
            clipped to ``max_len`` (:func:`effective_buckets`).
        device: where the cache lives and the steps run.

    Attributes:
        estimator: the registry name of the RM feature family served
            (None for ``attention_mode="exact"``).
        fused_attention: whether attention runs the fused ops (kernel B2)
            or the two-launch path (featurize, then kernel B5); False for
            exact softmax attention, which is plain PyTorch with a
            ring-buffer KV cache.
    """

    def __init__(self, cfg: ModelConfig, params: Any, num_slots: int,
                 max_len: int, *, buckets: Sequence[int] = None,
                 device="cuda"):
        if not cfg.causal:
            raise ValueError("encoder-only models cannot be served "
                             "autoregressively")
        if cfg.attention_mode not in ("exact", "rm"):
            raise ValueError(f"attention_mode must be 'exact' or 'rm', got "
                             f"{cfg.attention_mode!r}")
        # exact softmax attention has no feature family and no fused path
        self.estimator = None
        self.fused_attention = False
        if cfg.attention_mode == "rm":
            from repro_torch.common.dtypes import resolve_precision
            from repro_torch.core import registry
            from repro_torch.models.attention import rm_fuse_enabled

            # fail at construction, naming the valid options
            self.estimator = registry.get(cfg.rm.estimator).name
            resolve_precision(cfg.rm.precision)
            self.fused_attention = rm_fuse_enabled(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        # the fp32 master weights stay; the steps read one compute copy
        self.compute_params = cast_params_to_compute(params, cfg)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.buckets = effective_buckets(
            DEFAULT_BUCKETS if buckets is None else buckets, self.max_len)
        self.cache = None
        self.reset_cache()

    @property
    def scratch_position(self) -> int:
        """The cache position idle lanes decode into (output discarded)."""
        return self.max_len - 1

    @torch.inference_mode()
    def reset_cache(self) -> None:
        """(Re)initialize the batched decode cache — fresh lanes."""
        self.cache = init_decode_cache(self.cfg, self.num_slots,
                                       self.max_len, self.device)

    def bucket_for(self, n: int) -> int:
        """Smallest effective-ladder bucket holding an ``n``-token prompt."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"({self.buckets[-1]} tokens); shorten the prompt or raise "
            "max_len / extend the bucket ladder")

    @torch.inference_mode()
    def prefill(self, prompt: np.ndarray) -> Tuple[torch.Tensor, Any, int]:
        """Run one request's prefill; return ``(logits [1, bucket, V],
        cache1, bucket)``. The prompt is right-padded to its bucket with
        tokens at sentinel position -1, which the attention masks out of
        every key sum and of the decode state."""
        t = len(prompt)
        tb = self.bucket_for(t)
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, :t] = np.asarray(prompt, np.int64)
        positions = np.full((1, tb), -1, np.int32)
        positions[0, :t] = np.arange(t, dtype=np.int32)
        logits, cache1 = prefill(
            self.compute_params, self.cfg,
            {"tokens": torch.from_numpy(tokens).to(self.device),
             "positions": torch.from_numpy(positions).to(self.device)},
            self.max_len)
        return logits, cache1, tb

    @torch.inference_mode()
    def splice(self, slot: int, cache1: Any) -> None:
        """Write a request's (batch=1) prefill state into lane ``slot``,
        in place (the batched cache is not copied)."""
        for big, small in zip(self.cache["layers"], cache1["layers"]):
            for name, lane in small.items():
                big[name][slot].copy_(lane[0])

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        """One batched decode step over ALL lanes; updates the cache.

        ``tokens [num_slots, 1]`` and ``positions [num_slots]`` int
        tensors (idle lanes at :attr:`scratch_position`). Returns logits
        ``[num_slots, 1, V]`` fp32.
        """
        logits, self.cache = decode_step(
            self.compute_params, self.cfg, self.cache,
            tokens.to(self.device), positions.to(self.device))
        return logits
