"""Continuous-batching scheduler (port of ``repro.serve.scheduler``).

Per-step slot admission over the shared :class:`StepExecutor`:

  * **per-step admission** — every :meth:`step` first admits queued
    requests into free slots (one prefill each), then decodes every lane
    in one batched call;
  * **priority + FIFO queue** — a heap on ``(-priority, seq)``: higher
    priority first, submission order within a priority; a full scheduler
    never drops work, requests wait for a slot;
  * **finish at admission** — a request whose first token is its EOS, or
    that wants one token, or whose prompt fills the cache, finishes at
    prefill and hands its lane straight to the next queued request;
  * **eviction** — :meth:`evict` re-queues a request at its ORIGINAL
    sequence number (no starvation); it replays from its prompt;
  * **finish reasons** — ``"eos"``, ``"max_new_tokens"``, ``"cache_full"``;
  * **scheduling-independent sampling** — PyTorch has no ``fold_in``, so
    request ``r``'s ``t``-th token draws from a ``torch.Generator`` seeded
    with a fixed integer mix of ``(seed, r, t)``. Every request's output
    is a function of ``(seed, request)`` alone: independent of slot count,
    admission order, co-batched requests and evictions.

Observability, data-parallel meshes, restart recovery (``max_restarts``)
and accuracy tiers of the reference scheduler are not ported yet
(ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.engine import Request, RequestState
from repro_torch.serve.executor import StepExecutor
from repro_torch.serve.sampler import sample_token

__all__ = ["Scheduler", "StepInfo", "sampling_seed"]

_MASK64 = (1 << 64) - 1


def sampling_seed(seed: int, request_id: int, token_index: int) -> int:
    """A fixed 63-bit mix of ``(seed, request_id, token_index)``
    (splitmix64 finalizer over each word in turn), the seed of the
    generator that samples that token."""
    h = 0x9E3779B97F4A7C15
    for word in (seed, request_id, token_index):
        h = (h ^ (int(word) & _MASK64)) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h >> 1


@dataclasses.dataclass
class StepInfo:
    """What one scheduler tick did."""

    admitted: List[int] = dataclasses.field(default_factory=list)
    finished: List[int] = dataclasses.field(default_factory=list)
    active: int = 0                 # lanes that ran the decode this tick
    new_tokens: int = 0             # tokens emitted (prefill + decode)
    t_start: float = 0.0
    t_end: float = 0.0


class Scheduler:
    """Continuous-batching serving scheduler (see the module docstring).

    Args:
        cfg: frozen model config.
        params: model parameters on ``device``.
        num_slots: decode lanes.
        max_len: per-lane length (the scratch position is the last).
        rng_seed: base seed of every request's sampling stream.
        buckets: prefill bucket ladder override.
        device: where the model runs (default ``"cuda"``).
    """

    def __init__(self, cfg: Any, params: Any, *, num_slots: int = 4,
                 max_len: int = 1024, rng_seed: int = 0,
                 buckets: Optional[Sequence[int]] = None, device="cuda"):
        self.executor = StepExecutor(cfg, params, num_slots, max_len,
                                     buckets=buckets, device=device)
        self.estimator = self.executor.estimator
        self.fused_attention = self.executor.fused_attention
        self.cfg = cfg
        self.device = self.executor.device
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.rng_seed = int(rng_seed)
        self.slots: List[Optional[RequestState]] = [None] * self.num_slots
        self.finished: Dict[int, RequestState] = {}
        self._heap: List[Tuple[int, int, Request]] = []  # (-prio, seq, req)
        self._seq = 0
        self._seq_of: Dict[int, int] = {}
        self._t_submit: Dict[int, float] = {}
        self._attempts: Dict[int, int] = {}
        self._tokens = np.zeros((self.num_slots, 1), np.int64)
        self._positions = np.full((self.num_slots,),
                                  self.executor.scratch_position, np.int32)

    # -- public API -----------------------------------------------------------
    def pending(self) -> bool:
        """Any work left — queued or mid-decode?"""
        return bool(self._heap) or any(s is not None for s in self.slots)

    def submit(self, request: Request) -> None:
        """Enqueue a request (never drops, never blocks). Request ids must
        be unique: they key the sampling stream and the result map."""
        rid = request.request_id
        if rid in self._seq_of or rid in self.finished or any(
                s is not None and s.request.request_id == rid
                for s in self.slots):
            raise ValueError(f"duplicate request_id {rid}: ids key the "
                             "per-request sampling stream and result map")
        if len(request.prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds engine "
                f"max_len {self.max_len}: the decode cache has no room "
                "for generated tokens; raise max_len or truncate")
        seq = self._seq
        self._seq += 1
        self._seq_of[rid] = seq
        self._t_submit[rid] = time.perf_counter()
        heapq.heappush(self._heap, (-int(request.priority), seq, request))

    def step(self) -> StepInfo:
        """One tick: admit into free slots, then decode the batch."""
        info = StepInfo(t_start=time.perf_counter())
        self._admit_phase(info)
        self._decode_phase(info)
        info.t_end = time.perf_counter()
        return info

    def evict(self, slot: int) -> Request:
        """Preempt ``slot``: drop its decode state and re-queue its request
        at its ORIGINAL sequence number; it regenerates the same tokens on
        re-admission."""
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is not occupied")
        req = state.request
        self.slots[slot] = None
        self._positions[slot] = self.executor.scratch_position
        self._requeue(req)
        return req

    def run(self, max_iters: int = 100_000) -> Dict[int, RequestState]:
        """Step until drained (or ``max_iters``; a cap expiry warns and
        leaves the unfinished requests queued or in flight)."""
        it = 0
        while self.pending() and it < max_iters:
            self.step()
            it += 1
        pendings = len(self._heap) + sum(s is not None for s in self.slots)
        if pendings:
            warnings.warn(
                f"Scheduler.run hit max_iters={max_iters} with "
                f"{pendings} request(s) still pending; returned results "
                "are truncated", RuntimeWarning, stacklevel=2)
        return self.finished

    # -- internals ------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, rid: int, token_idx: int,
                temperature: float) -> int:
        """Sample one token of request ``rid`` from ``logits [1, V]``."""
        if temperature <= 0.0:
            return int(sample_token(logits)[0])
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(sampling_seed(self.rng_seed, rid, token_idx))
        return int(sample_token(logits, gen, temperature)[0])

    def _requeue(self, request: Request) -> None:
        rid = request.request_id
        heapq.heappush(self._heap,
                       (-int(request.priority), self._seq_of[rid], request))
        self._t_submit.setdefault(rid, time.perf_counter())

    def _admit_phase(self, info: StepInfo) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        # one admission per lane free at the start of the tick; a request
        # that finishes at admission hands its lane back but spends its
        # unit, as in the reference
        budget = len(free)
        while free and self._heap and budget > 0:
            slot = free.pop(0)
            _, _, req = heapq.heappop(self._heap)
            budget -= 1
            try:
                finished_at_admit = self._admit_one(slot, req, info)
            except Exception:
                # a failed prefill must not lose the popped request
                self._requeue(req)
                raise
            if finished_at_admit:
                free.insert(0, slot)

    def _finish_reason(self, state: RequestState, tok: int) -> Optional[str]:
        req = state.request
        if req.eos_token is not None and tok == req.eos_token:
            return "eos"
        if len(state.generated) >= req.max_new_tokens:
            return "max_new_tokens"
        if state.position >= self.max_len - 1:
            return "cache_full"
        return None

    def _admit_one(self, slot: int, req: Request, info: StepInfo) -> bool:
        """Prefill ``req`` into ``slot``. Returns True if it finished at
        admission — the lane is then still free."""
        rid = req.request_id
        t = len(req.prompt)
        attempt = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = attempt
        logits, cache1, _ = self.executor.prefill(req.prompt)
        self.executor.splice(slot, cache1)
        t_enqueue = self._t_submit.pop(rid, None)
        if t_enqueue is None:
            t_enqueue = time.perf_counter()
        state = RequestState(request=req, slot=slot, position=t,
                             t_enqueue=t_enqueue, admissions=attempt)
        info.admitted.append(rid)
        # first token from the LAST REAL prefill position (token index 0)
        tok = self._sample(logits[:, t - 1], rid, 0, req.temperature)
        state.generated.append(tok)
        state.t_first_token = time.perf_counter()
        state.t_tokens.append(state.t_first_token)
        info.new_tokens += 1
        reason = self._finish_reason(state, tok)
        if reason is not None:
            self._finish(state, reason, info)
            return True
        self._tokens[slot, 0] = tok
        self._positions[slot] = t
        self.slots[slot] = state
        return False

    def _decode_phase(self, info: StepInfo) -> None:
        active = [s for s in self.slots if s is not None]
        info.active = len(active)
        if not active:
            return
        logits = self.executor.decode(torch.from_numpy(self._tokens),
                                      torch.from_numpy(self._positions))
        # one device-to-host copy for every greedy lane
        greedy = sample_token(logits[:, 0]).tolist()
        for state in active:
            i = state.slot
            req = state.request
            if req.temperature <= 0.0:
                tok = int(greedy[i])
            else:
                tok = self._sample(logits[i:i + 1, 0], req.request_id,
                                   len(state.generated), req.temperature)
            state.generated.append(tok)
            state.t_tokens.append(time.perf_counter())
            state.position += 1
            info.new_tokens += 1
            self._tokens[i, 0] = tok
            self._positions[i] = state.position
            reason = self._finish_reason(state, tok)
            if reason is not None:
                self._finish(state, reason, info)
                self.slots[i] = None
                self._positions[i] = self.executor.scratch_position

    def _finish(self, state: RequestState, reason: str,
                info: StepInfo) -> None:
        state.done = True
        state.t_done = time.perf_counter()
        state.finish_reason = reason
        self.finished[state.request.request_id] = state
        info.finished.append(state.request.request_id)
