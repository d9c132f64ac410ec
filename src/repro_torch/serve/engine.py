"""Batched serving engine with bucketed prefill over fixed decode slots,
and the request records of the serving path (port of
``repro.serve.engine``).

.. deprecated::
    ``ServingEngine`` is the LEGACY serving frontend. New code should use
    :class:`repro_torch.serve.scheduler.Scheduler`, the continuous-batching
    scheduler with per-step admission and eviction, priority queues,
    per-request deterministic sampling, restarts and accuracy tiers. The
    engine is kept for its engine-wide sampling stream and as the serve
    launcher's ``--scheduler bucketed`` frontend.

Design (as the reference's):

  * the engine owns ``num_slots`` decode lanes; the decode step is ONE
    executor call over all lanes every iteration (token + per-lane
    position);
  * finished and empty lanes decode into a scratch position of their cache
    (position pinned, output discarded);
  * admission: queued requests are prefills, each bucketed to the
    executor's ladder and spliced into its lane of the batched cache (on a
    mesh, by the ranks that own the lane: ``StepExecutor.admit``).

Everything that touches the device lives in
:class:`repro_torch.serve.executor.StepExecutor`, shared with the
Scheduler; this module owns queueing, sampling and observability, under
the reference's obs names (events ``request/submit``, ``request/admit``,
``request/finish``; spans ``prefill``, ``decode/step``; counters
``serve/requests_submitted``, ``serve/tokens_generated``,
``serve/truncated``; gauges ``serve/queue_depth``,
``serve/slots_occupied``; histograms ``serve/ttft_s``,
``serve/token_latency_s``, ``serve/tokens_per_s``).

Sampling: one engine-wide ``torch.Generator`` on the executor's device,
seeded from ``rng_seed``, in place of the reference's ``jax.random.split``
discipline: it draws once per admission (at the request's temperature;
a greedy request takes the argmax, the draw is made all the same) and
once per decode step (each lane's logits scaled by its temperature, then
one batched draw at temperature 1; greedy lanes take the argmax).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs import resolve as _obs_resolve
from repro_torch.serve.executor import DEFAULT_BUCKETS, StepExecutor
from repro_torch.serve.sampler import sample_token

__all__ = ["Request", "RequestState", "ServingEngine"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # [T] int token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: Optional[int] = None
    priority: int = 0                   # higher admits first (Scheduler)
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


def _bucket(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Legacy module-level bucket lookup (kept for its regression tests);
    engines resolve buckets through ``StepExecutor.bucket_for``, which also
    clips the ladder to ``max_len``."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt length {n} exceeds the largest prefill bucket "
        f"({buckets[-1]} tokens); shorten the prompt or extend the "
        "bucket ladder in serve.engine._bucket")


class ServingEngine:
    """The deprecated batch-synchronous frontend (see the module doc).

    Args:
        cfg: frozen model config (the executor validates it).
        params: model parameters on ``device`` (on a mesh, this rank's
            shards, as ``StepExecutor(mesh=)`` takes them).
        num_slots: decode lanes.
        max_len: per-lane length (the scratch position is the last).
        rng_seed: seed of the engine-wide sampling generator.
        mesh: optional ``DeviceMesh``, forwarded to the executor.
        obs: optional ``repro_torch.obs.Obs``; ``None`` is a strict no-op.
        buckets: prefill bucket ladder override.
        device: where the model runs (default ``"cuda"``).

    Raises:
        ValueError: what the executor refuses (an encoder config, a bad
            bucket ladder, ...).
    """

    def __init__(self, cfg: Any, params: Any, num_slots: int = 4,
                 max_len: int = 1024, rng_seed: int = 0, mesh: Any = None,
                 obs: Any = None, buckets: Optional[Sequence[int]] = None,
                 device="cuda"):
        self.obs = _obs_resolve(obs)
        self.executor = StepExecutor(cfg, params, num_slots, max_len,
                                     buckets=buckets, device=device,
                                     mesh=mesh)
        self.estimator = self.executor.estimator
        self.fused_attention = self.executor.fused_attention
        self.cfg = cfg
        self.device = self.executor.device
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.mesh = mesh
        self.slots: List[Optional[RequestState]] = [None] * self.num_slots
        self.queue: List[Request] = []
        self.finished: Dict[int, RequestState] = {}
        self._t_submit: Dict[int, float] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(rng_seed))
        self._tokens = np.zeros((self.num_slots, 1), np.int64)
        self._positions = np.zeros((self.num_slots,), np.int32)

    @property
    def params(self):
        return self.executor.params

    @property
    def cache(self):
        return self.executor.cache

    # -- public API -----------------------------------------------------------
    def submit(self, request: Request) -> None:
        if len(request.prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds engine "
                f"max_len {self.max_len}: the decode cache has no room "
                "for generated tokens; raise max_len or truncate")
        self._t_submit[request.request_id] = self.obs.now()
        self.queue.append(request)
        self.obs.event("request/submit", request_id=request.request_id,
                       prompt_len=len(request.prompt))
        self.obs.counter("serve/requests_submitted")
        self.obs.gauge("serve/queue_depth", len(self.queue))

    def run(self, max_iters: int = 10_000) -> Dict[int, RequestState]:
        """Drive admission + decode until drained (or ``max_iters``).

        Returns the finished-request map. If ``max_iters`` expires with
        requests still queued or mid-decode, the run is TRUNCATED: those
        requests stay in ``self.queue`` / ``self.slots``, a
        ``RuntimeWarning`` is emitted, and the ``serve/truncated`` counter
        records how many were left behind.
        """
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self._admit()
            self._decode_iteration()
            it += 1
        pending = len(self.queue) + sum(s is not None for s in self.slots)
        if pending:
            warnings.warn(
                f"ServingEngine.run hit max_iters={max_iters} with "
                f"{pending} request(s) still pending; returned results "
                "are truncated", RuntimeWarning, stacklevel=2)
            self.obs.counter("serve/truncated", pending)
        return self.finished

    # -- internals --------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _first_token(self, row: torch.Tensor, temperature: float) -> int:
        """The admission's draw: one from the engine's generator at the
        request's temperature; a greedy request takes the argmax."""
        drawn = sample_token(row, self._gen,
                             temperature if temperature > 0 else 1.0)
        return int(drawn[0] if temperature > 0 else torch.argmax(row[0]))

    def _admit(self) -> None:
        free = self._free_slots()
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            t = len(req.prompt)
            tb = self.executor.bucket_for(t)
            self.obs.event("request/admit", request_id=req.request_id,
                           slot=slot, bucket=tb)
            with self.obs.span("prefill", request_id=req.request_id,
                               bucket=tb, prompt_len=t):
                row, _ = self.executor.admit(slot, req.prompt)
            t_enqueue = self._t_submit.pop(req.request_id, None)
            if t_enqueue is None:
                t_enqueue = self.obs.now()
            state = RequestState(request=req, slot=slot, position=t,
                                 t_enqueue=t_enqueue, admissions=1)
            # the first generated token from the LAST REAL prefill logit
            tok = self._first_token(row, req.temperature)
            state.generated.append(tok)
            state.t_first_token = self.obs.now()
            state.t_tokens.append(state.t_first_token)
            self.obs.histogram("serve/ttft_s",
                               state.t_first_token - state.t_enqueue)
            self.obs.gauge("serve/queue_depth", len(self.queue))
            # the prefill-sampled token can already end the request (EOS,
            # max_new_tokens=1, a prompt that fills the cache): it finishes
            # without taking the lane, which goes to the next request
            hit_eos = req.eos_token is not None and tok == req.eos_token
            if (hit_eos or len(state.generated) >= req.max_new_tokens
                    or t >= self.max_len - 1):
                state.done = True
                state.t_done = self.obs.now()
                self._finish(state, "eos" if hit_eos else (
                    "max_new_tokens"
                    if len(state.generated) >= req.max_new_tokens
                    else "cache_full"))
                free.insert(0, slot)
                continue
            self._tokens[slot, 0] = tok
            self._positions[slot] = t
            self.slots[slot] = state
        self.obs.gauge("serve/slots_occupied",
                       sum(s is not None for s in self.slots))
        # park the empty lanes on the scratch position
        for i, s in enumerate(self.slots):
            if s is None:
                self._positions[i] = self.executor.scratch_position

    def _decode_iteration(self) -> None:
        active = [s for s in self.slots if s is not None]
        if not active:
            return
        t_step = self.obs.now()
        with self.obs.span("decode/step", active=len(active)):
            logits = self.executor.decode(torch.from_numpy(self._tokens),
                                          torch.from_numpy(self._positions))
            # each lane's logits over its request's temperature, then ONE
            # batched draw at temperature 1 (division by the 1.0 of a
            # greedy lane is exact); greedy lanes take the argmax
            temps = np.ones((self.num_slots, 1), np.float32)
            for state in active:
                if state.request.temperature > 0:
                    temps[state.slot, 0] = state.request.temperature
            rows = logits[:, 0]
            greedy = torch.argmax(rows, dim=-1).tolist()
            sampled = sample_token(
                rows / torch.from_numpy(temps).to(rows.device), self._gen,
                temperature=1.0).tolist()
            for state in active:
                i = state.slot
                req = state.request
                tok = int(sampled[i] if req.temperature > 0 else greedy[i])
                state.generated.append(tok)
                state.t_tokens.append(self.obs.now())
                state.position += 1
                self._tokens[i, 0] = tok
                self._positions[i] = state.position
                hit_eos = req.eos_token is not None and tok == req.eos_token
                if (len(state.generated) >= req.max_new_tokens or hit_eos
                        or state.position >= self.max_len - 1):
                    state.done = True
                    state.t_done = self.obs.now()
                    self._finish(state, "eos" if hit_eos else (
                        "max_new_tokens"
                        if len(state.generated) >= req.max_new_tokens
                        else "cache_full"))
                    self.slots[i] = None
        # the step latency amortizes over every lane that got a token, so
        # the histogram reads as per-token decode latency
        self.obs.histogram("serve/token_latency_s",
                           self.obs.now() - t_step)
        self.obs.counter("serve/tokens_generated", len(active))
        self.obs.gauge("serve/slots_occupied",
                       sum(s is not None for s in self.slots))
        self.obs.tick_drift()

    def _finish(self, state: RequestState, reason: str) -> None:
        """Record a finished request; ``reason`` is the stopping condition
        the caller met: "eos" | "max_new_tokens" | "cache_full"."""
        req = state.request
        state.finish_reason = reason
        self.finished[req.request_id] = state
        n_tok = len(state.generated)
        self.obs.event("request/finish", request_id=req.request_id,
                       slot=state.slot, tokens=n_tok, reason=reason)
        wall = state.t_done - state.t_enqueue
        if wall > 0:
            self.obs.histogram("serve/tokens_per_s", n_tok / wall)
