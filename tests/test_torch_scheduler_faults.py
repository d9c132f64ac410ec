"""Fault injection for the port's Scheduler: the six cases of
tests/test_scheduler_faults.py on the port (qwen3 SMOKE, the reference's
default exact attention, fp32, the reference's weights handed across).

The recovery contract: with ``max_restarts=N``, up to N failed ticks
re-queue every in-flight request at its ORIGINAL queue position, reset the
decode cache, and continue; the N+1-th failure propagates. Tokens are
compared with an undisturbed one-request-at-a-time run: greedy
(temperature 0) against the REFERENCE Scheduler's tokens, and sampled
(temperature 0.5; the port samples from its own generators, not the
reference's fold_in keys) against the port's own one-at-a-time run."""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.obs import Obs, clock
from repro_torch.serve import Request, Scheduler
from repro_torch.train.fault import StragglerMonitor

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from check_trace import check_request_lifecycles  # noqa: E402

PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}
MAX_LEN = 32
VOCAB = 512
TEMPERATURES = [0.0, 0.5]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b", smoke=True),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                               compute_dtype="float32")
    assert jcfg.attention_mode == tcfg.attention_mode == "exact"
    jp = jax_init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _sched(setup, **kw):
    return Scheduler(setup[2], setup[3], max_len=MAX_LEN, device="cpu",
                     **kw)


def _prompts(n):
    rng = np.random.default_rng(7)
    return [rng.integers(0, VOCAB, size=5) for _ in range(n)]


def _submit_workload(sched, n=3, max_new=4, temperature=0.5):
    for i, p in enumerate(_prompts(n)):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=max_new,
                             temperature=temperature))


_ORACLE = {}


def _oracle(setup, n=3, max_new=4, temperature=0.5):
    """Each request alone in a one-slot scheduler: the reference's for
    greedy decoding, the port's for sampling."""
    key = (n, max_new, temperature)
    if key not in _ORACLE:
        out = {}
        for i, p in enumerate(_prompts(n)):
            if temperature == 0.0:
                s = JScheduler(setup[0], setup[1], num_slots=1,
                               max_len=MAX_LEN)
                s.submit(JRequest(request_id=i, prompt=p,
                                  max_new_tokens=max_new))
            else:
                s = _sched(setup, num_slots=1)
                s.submit(Request(request_id=i, prompt=p,
                                 max_new_tokens=max_new,
                                 temperature=temperature))
            out[i] = s.run()[i].generated
        _ORACLE[key] = out
    return _ORACLE[key]


def _inject_decode_failures(sched, fail_on_calls, monkeypatch):
    """Make executor.decode raise on the given 1-based call numbers."""
    orig = sched.executor.decode
    calls = {"n": 0}

    def flaky(tokens, positions):
        calls["n"] += 1
        if calls["n"] in fail_on_calls:
            raise RuntimeError(f"injected decode failure "
                               f"(call {calls['n']})")
        return orig(tokens, positions)

    monkeypatch.setattr(sched.executor, "decode", flaky)
    return calls


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_decode_crash_requeues_and_finishes_bit_identically(
        setup, monkeypatch, temperature):
    """Kill one decode step mid-run: every in-flight slot is re-queued,
    the run completes, and outputs match an undisturbed run."""
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    sched = _sched(setup, num_slots=2, max_restarts=2, obs=obs)
    _submit_workload(sched, temperature=temperature)
    _inject_decode_failures(sched, {2}, monkeypatch)
    done = sched.run()
    obs.close()

    assert sorted(done) == [0, 1, 2]
    assert sched.restarts == 1
    assert {i: s.generated for i, s in done.items()} == \
        _oracle(setup, temperature=temperature)
    restarts = obs.tracer.events("serve/restart")
    assert len(restarts) == 1
    assert "injected decode failure" in restarts[0]["attrs"]["cause"]
    evs = obs.tracer.events("request/evict")
    assert evs and all(e["attrs"]["reason"] == "restart" for e in evs)
    assert {e["attrs"]["request_id"] for e in evs} == \
        set(restarts[0]["attrs"]["requeued"])
    assert check_request_lifecycles(obs.tracer.records) == []
    assert any(done[i].admissions >= 2 for i in done)
    snap = obs.metrics.snapshot(provenance=PROV)
    assert snap["counters"]["serve/restarts"] == 1.0


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_repeated_crashes_within_budget_still_complete(setup, monkeypatch,
                                                       temperature):
    sched = _sched(setup, num_slots=2, max_restarts=3)
    _submit_workload(sched, temperature=temperature)
    _inject_decode_failures(sched, {2, 4, 7}, monkeypatch)
    infos = []
    while sched.pending():
        infos.append(sched.step())
    assert sched.restarts == 3
    assert sum(i.restarted for i in infos) == 3
    assert all(i.evicted for i in infos if i.restarted)
    assert {i: s.generated for i, s in sched.finished.items()} == \
        _oracle(setup, temperature=temperature)


def test_crash_beyond_budget_propagates(setup, monkeypatch):
    """The N+1-th failure re-raises: bounded restarts, never an infinite
    crash loop, and the in-flight work is back in the queue."""
    sched = _sched(setup, num_slots=2, max_restarts=1)
    _submit_workload(sched)
    _inject_decode_failures(sched, {1, 2}, monkeypatch)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        sched.run()
    assert sched.restarts == 1
    assert sched.pending()


def test_default_zero_restarts_fails_fast(setup, monkeypatch):
    """max_restarts defaults to 0: recovery is opt-in."""
    sched = _sched(setup, num_slots=1)
    _submit_workload(sched, n=1)
    _inject_decode_failures(sched, {1}, monkeypatch)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        sched.run()


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_prefill_crash_does_not_lose_the_popped_request(
        setup, monkeypatch, temperature):
    """A prefill failure strikes BETWEEN queue pop and slot assignment:
    the request is re-queued at its original position, not dropped."""
    sched = _sched(setup, num_slots=1, max_restarts=1)
    _submit_workload(sched, n=2, temperature=temperature)
    orig = sched.executor.prefill
    calls = {"n": 0}

    def flaky(prompt):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected prefill failure")
        return orig(prompt)

    monkeypatch.setattr(sched.executor, "prefill", flaky)
    done = sched.run()
    assert sorted(done) == [0, 1]
    assert sched.restarts == 1
    assert {i: s.generated for i, s in done.items()} == \
        _oracle(setup, n=2, temperature=temperature)


def test_straggler_monitor_watches_decode_steps(setup):
    """The training stack's StragglerMonitor plugs into serving: decode
    wall times (on the obs clock) feed its EWMA, and a deliberately
    slowed step is flagged."""
    fake = clock.FakeClock(step=0.001)
    obs = Obs(clock=fake, provenance=PROV)
    monitor = StragglerMonitor(threshold=2.0, warmup_steps=2)
    sched = _sched(setup, num_slots=2, straggler_monitor=monitor, obs=obs)
    _submit_workload(sched, n=2, max_new=8)
    for _ in range(6):
        if sched.pending():
            sched.step()
    assert monitor.mean is not None and monitor._seen >= 4
    baseline_events = len(monitor.events)
    orig = sched.executor.decode

    def slow(tokens, positions):
        fake.advance(10.0)
        return orig(tokens, positions)

    sched.executor.decode = slow
    if sched.pending():
        sched.step()
    sched.executor.decode = orig
    sched.run()
    obs.close()
    assert len(monitor.events) > baseline_events, (
        "slowed decode step was not flagged as a straggler")
