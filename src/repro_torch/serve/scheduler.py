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
  * **eviction + restart-from-scratch recovery** — :meth:`evict`
    re-queues a request at its ORIGINAL sequence number (no starvation);
    it replays from its prompt and regenerates the same tokens. A failed
    prefill or decode (when ``max_restarts > 0``) takes the same path for
    every in-flight lane, on a fresh decode cache: at-least-once token
    delivery with bit-identical replay;
  * **finish reasons** — ``"eos"``, ``"max_new_tokens"``, ``"cache_full"``;
  * **scheduling-independent sampling** — PyTorch has no ``fold_in``, so
    request ``r``'s ``t``-th token draws from a ``torch.Generator`` seeded
    with a fixed integer mix of ``(seed, r, t)``. Every request's output
    is a function of ``(seed, request)`` alone: independent of slot count,
    admission order, co-batched requests and evictions.

Observability (``obs=``, ``repro_torch.obs``), with the reference's
names: the request lifecycle events (``request/submit``,
``request/admit``, ``request/evict``, ``request/finish``) and
``serve/restart``, the ``admit``, ``prefill``, ``decode/step`` and
``evict`` spans, and the ``serve/*`` metrics (TTFT, inter-token and
per-step latency, tokens per second, queue depth and age, slot
occupancy), all on the injectable ``obs`` clock. ``obs=None`` is a strict
no-op: the same tokens, and no device synchronization beyond the step's
own. Decode-step wall times also feed an optional ``StragglerMonitor``
(``repro_torch.train.fault``).

Not ported yet: data-parallel meshes (ROADMAP.md queue A item 7) and
accuracy tiers, which need the fold-in-keyed feature generations of
``core/doubling.py`` (queue A item 5).
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import resolve as _obs_resolve
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
    evicted: List[int] = dataclasses.field(default_factory=list)
    active: int = 0                 # lanes that ran the decode this tick
    new_tokens: int = 0             # tokens emitted (prefill + decode)
    restarted: bool = False         # a fault-recovery respawn happened
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
        max_restarts: fault-recovery budget. 0 (default) disables
            recovery: executor exceptions propagate. With N > 0, up to N
            failed ticks re-queue every in-flight request onto a fresh
            decode cache and continue; the N+1-th failure re-raises.
        straggler_monitor: optional ``repro_torch.train.fault.
            StragglerMonitor``; every decode step's wall time (on the obs
            clock) is ``record``-ed on it.
        obs: optional ``repro_torch.obs.Obs``; ``None`` is a strict no-op.
        accuracy_tiers: not ported (raises, naming ROADMAP.md queue A
            item 5).
        device: where the model runs (default ``"cuda"``).
    """

    def __init__(self, cfg: Any, params: Any, *, num_slots: int = 4,
                 max_len: int = 1024, rng_seed: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 max_restarts: int = 0, straggler_monitor: Any = None,
                 obs: Any = None,
                 accuracy_tiers: Optional[Dict[str, int]] = None,
                 device="cuda"):
        if accuracy_tiers:
            raise NotImplementedError(
                "accuracy tiers are not ported yet: they need the "
                "fold_in-keyed feature generations of core/doubling.py "
                "(ROADMAP.md queue A item 5)")
        self.obs = _obs_resolve(obs)
        self.executor = StepExecutor(cfg, params, num_slots, max_len,
                                     buckets=buckets, device=device)
        self.estimator = self.executor.estimator
        self.fused_attention = self.executor.fused_attention
        self.cfg = cfg
        self.device = self.executor.device
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.rng_seed = int(rng_seed)
        self.max_restarts = int(max_restarts)
        self.straggler_monitor = straggler_monitor
        self.restarts = 0
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
        self._step_idx = 0

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
        self._t_submit[rid] = self.obs.now()
        heapq.heappush(self._heap, (-int(request.priority), seq, request))
        # the reference's attributes, accuracy_tier included (always None:
        # tiers are not ported)
        self.obs.event("request/submit", request_id=rid,
                       prompt_len=len(request.prompt),
                       priority=int(request.priority), accuracy_tier=None)
        self.obs.counter("serve/requests_submitted")
        self.obs.gauge("serve/queue_depth", len(self._heap))

    def step(self) -> StepInfo:
        """One tick: admit into free slots, then decode the batch. With
        ``max_restarts > 0`` an executor failure inside the tick re-queues
        every in-flight request onto a fresh decode cache instead of
        propagating, up to the budget."""
        self._step_idx += 1
        info = StepInfo(t_start=self.obs.now())
        try:
            self._admit_phase(info)
            self._decode_phase(info)
        except Exception as e:  # noqa: BLE001 - bounded restart semantics
            if self.restarts >= self.max_restarts:
                raise
            self.restarts += 1
            self._recover(info, repr(e))
        info.t_end = self.obs.now()
        return info

    def evict(self, slot: int) -> Request:
        """Preempt ``slot``: drop its decode state and re-queue its request
        at its ORIGINAL sequence number; it regenerates the same tokens on
        re-admission."""
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is not occupied")
        req = state.request
        with self.obs.span("evict", request_id=req.request_id, slot=slot,
                           reason="preempted"):
            self.obs.event("request/evict", request_id=req.request_id,
                           slot=slot, reason="preempted",
                           tokens_discarded=len(state.generated))
            self.obs.counter("serve/evictions")
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
            self.obs.counter("serve/truncated", pendings)
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
        # queue-age accounting restarts from the requeue
        self._t_submit.setdefault(rid, self.obs.now())
        self.obs.gauge("serve/queue_depth", len(self._heap))

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
        if self._heap:
            oldest = min(self._t_submit.get(r.request_id, info.t_start)
                         for _, _, r in self._heap)
            self.obs.gauge("serve/queue_age_s", self.obs.now() - oldest)
        else:
            self.obs.gauge("serve/queue_age_s", 0.0)
        self.obs.gauge("serve/slots_occupied",
                       sum(s is not None for s in self.slots))

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
        tb = self.executor.bucket_for(t)
        attempt = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = attempt
        with self.obs.span("admit", request_id=rid, slot=slot, bucket=tb,
                           attempt=attempt):
            self.obs.event("request/admit", request_id=rid, slot=slot,
                           bucket=tb, attempt=attempt, accuracy_tier=None,
                           tier_features=None)
            with self.obs.span("prefill", request_id=rid, bucket=tb,
                               prompt_len=t):
                logits, cache1, _ = self.executor.prefill(req.prompt)
                self.executor.splice(slot, cache1)
        t_enqueue = self._t_submit.pop(rid, None)
        if t_enqueue is None:
            t_enqueue = self.obs.now()
        state = RequestState(request=req, slot=slot, position=t,
                             t_enqueue=t_enqueue, admissions=attempt)
        info.admitted.append(rid)
        # first token from the LAST REAL prefill position (token index 0)
        tok = self._sample(logits[:, t - 1], rid, 0, req.temperature)
        state.generated.append(tok)
        state.t_first_token = self.obs.now()
        state.t_tokens.append(state.t_first_token)
        info.new_tokens += 1
        self.obs.histogram("serve/ttft_s",
                           state.t_first_token - state.t_enqueue)
        self.obs.gauge("serve/queue_depth", len(self._heap))
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
        t_step = self.obs.now()
        with self.obs.span("decode/step", active=len(active)):
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
                t_tok = self.obs.now()
                self.obs.histogram("serve/inter_token_s",
                                   t_tok - state.t_tokens[-1])
                state.t_tokens.append(t_tok)
                state.position += 1
                info.new_tokens += 1
                self._tokens[i, 0] = tok
                self._positions[i] = state.position
                reason = self._finish_reason(state, tok)
                if reason is not None:
                    self._finish(state, reason, info)
                    self.slots[i] = None
                    self._positions[i] = self.executor.scratch_position
        dur = self.obs.now() - t_step
        if self.straggler_monitor is not None:
            self.straggler_monitor.record(self._step_idx, dur)
        self.obs.histogram("serve/token_latency_s", dur)
        self.obs.counter("serve/tokens_generated", len(active))
        self.obs.gauge("serve/slots_occupied",
                       sum(s is not None for s in self.slots))
        self.obs.tick_drift()

    def _recover(self, info: StepInfo, cause: str) -> None:
        """Respawn after a failed tick: re-queue every in-flight request,
        reset the decode cache, continue. Requests replay from their
        prompts and regenerate identical tokens (scheduling-independent
        sampling)."""
        requeued = []
        for i, state in enumerate(self.slots):
            if state is None:
                continue
            req = state.request
            requeued.append(req.request_id)
            info.evicted.append(req.request_id)
            self.slots[i] = None
            self._requeue(req)
            self.obs.event("request/evict", request_id=req.request_id,
                           slot=i, reason="restart",
                           tokens_discarded=len(state.generated))
        self.executor.reset_cache()
        self._tokens[:] = 0
        self._positions[:] = self.executor.scratch_position
        info.restarted = True
        self.obs.counter("serve/restarts")
        self.obs.event("serve/restart", cause=cause,
                       restart=self.restarts, requeued=requeued)
        self.obs.gauge("serve/slots_occupied", 0)

    def _finish(self, state: RequestState, reason: str,
                info: StepInfo) -> None:
        req = state.request
        state.done = True
        state.t_done = self.obs.now()
        state.finish_reason = reason
        self.finished[req.request_id] = state
        info.finished.append(req.request_id)
        n_tok = len(state.generated)
        self.obs.event("request/finish", request_id=req.request_id,
                       slot=state.slot, tokens=n_tok, reason=reason)
        wall = state.t_done - state.t_enqueue
        if wall > 0:
            self.obs.histogram("serve/tokens_per_s", n_tok / wall)
