"""The Scheduler's invariant contract, held on the port: the deterministic
sweep of tests/test_scheduler_invariants.py with its seed counts (10 main
workloads, 6 with an eviction, 4 under cache pressure, 3 for each registry
family, 5 priority orders) and its three standalone tests, on the CPU with
qwen3 SMOKE in fp32 and the reference's weights handed across.

Every run must:

  * finish every request, with a lifecycle trace that replays clean
    through ``tools/check_trace.check_records`` (no slot held twice);
  * give each request bitwise the tokens and finish reason of the port's
    one-request, one-slot run at the same ``rng_seed`` (greedy and sampled
    alike: the port's per-request generators make scheduling invisible);
  * give each greedy request bitwise the tokens and finish reason of the
    REFERENCE Scheduler on the same workload (sampled tokens draw from the
    reference's ``fold_in`` keys there, so they are held inside the port).

Evictions go through ``evict(slot, reason=...)``. The reference's
hypothesis drivers draw more seeds from the same ``gen_workload``; the
port runs the fixed sweep only.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import registry
from repro_torch.obs import Obs, clock
from repro_torch.serve import Request, Scheduler

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from check_trace import check_records, check_request_lifecycles  # noqa: E402

PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}
MAX_LEN = 32
VOCAB = 512


def _handed(jcfg, tcfg):
    jp = jax_init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def exact_setup():
    return _handed(
        dataclasses.replace(jax_get_config("qwen3-1.7b", smoke=True),
                            compute_dtype="float32"),
        dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                            compute_dtype="float32"))


_EST_CACHE = {}


def estimator_setup(name):
    """qwen3 SMOKE in rm mode with the family ``name``; ``rm`` takes the
    fused path on both sides (the reference's ``fuse_featurize="on"``)."""
    if name not in _EST_CACHE:
        jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                              estimator=name)
        if name == "rm":
            jcfg = dataclasses.replace(
                jcfg, rm=dataclasses.replace(jcfg.rm, fuse_featurize="on"))
        tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                          estimator=name)
        _EST_CACHE[name] = _handed(
            dataclasses.replace(jcfg, compute_dtype="float32"),
            dataclasses.replace(tcfg, compute_dtype="float32"))
    return _EST_CACHE[name]


# -- the shared workload space (the reference's) ------------------------------
def gen_workload(seed, max_requests=4, max_prompt=8, max_new=4,
                 temperatures=(0.0, 0.7)):
    """A random workload from one generator seed: the reference's own
    sample space, draw for draw."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, max_requests + 1))
    reqs = []
    for i in range(n):
        reqs.append({
            "request_id": i,
            "prompt_seed": int(rng.integers(0, 2**16)),
            "prompt_len": int(rng.integers(1, max_prompt + 1)),
            "max_new_tokens": int(rng.integers(1, max_new + 1)),
            "temperature": float(rng.choice(np.asarray(temperatures))),
            "priority": int(rng.integers(0, 3)),
            "eos_token": 3 if rng.integers(0, 2) else None,
        })
    slots = int(rng.integers(1, 4))
    rng_seed = int(rng.integers(0, 2**16))
    return reqs, slots, rng_seed


def make_request(spec, cls=Request):
    rng = np.random.default_rng((spec["prompt_seed"], spec["request_id"]))
    return cls(request_id=spec["request_id"],
               prompt=rng.integers(0, VOCAB, size=spec["prompt_len"]),
               max_new_tokens=spec["max_new_tokens"],
               temperature=spec["temperature"],
               priority=spec["priority"],
               eos_token=spec["eos_token"])


def oracle_run(setup, spec, rng_seed, max_len=MAX_LEN):
    """One request, one slot, nothing else: the port's sequential run the
    batched run must reproduce bit for bit."""
    s = Scheduler(setup[2], setup[3], num_slots=1, max_len=max_len,
                  rng_seed=rng_seed, device="cpu")
    s.submit(make_request(spec))
    return s.run()[spec["request_id"]]


def reference_run(setup, reqs, slots, rng_seed, max_len=MAX_LEN,
                  evict=None):
    """The reference Scheduler on the same workload (and the same eviction,
    ``(step, pick)``); its finished map."""
    s = JScheduler(setup[0], setup[1], num_slots=slots, max_len=max_len,
                   rng_seed=rng_seed)
    for spec in reqs:
        s.submit(make_request(spec, JRequest))
    if evict is not None:
        _evict_after(s, *evict)
    return s.run()


def _evict_after(sched, evict_step, evict_pick):
    for _ in range(evict_step):
        if sched.pending():
            sched.step()
    occupied = [i for i, s in enumerate(sched.slots) if s is not None]
    if not occupied:
        return None, 0
    slot = occupied[evict_pick % len(occupied)]
    had = len(sched.slots[slot].generated)
    return sched.evict(slot, reason="test-preempt").request_id, had


def assert_matches_oracles(setup, done, reqs, slots, rng_seed,
                           max_len=MAX_LEN, evict=None):
    ref = reference_run(setup, reqs, slots, rng_seed, max_len, evict)
    assert sorted(ref) == sorted(done)
    for spec in reqs:
        rid = spec["request_id"]
        one = oracle_run(setup, spec, rng_seed, max_len=max_len)
        assert done[rid].generated == one.generated, (
            f"request {rid}: scheduled tokens {done[rid].generated} != "
            f"sequential oracle {one.generated}")
        assert done[rid].finish_reason == one.finish_reason
        if spec["temperature"] == 0.0:
            assert done[rid].generated == ref[rid].generated, (
                f"request {rid}: port {done[rid].generated} != reference "
                f"Scheduler {ref[rid].generated}")
            assert done[rid].finish_reason == ref[rid].finish_reason


def _scheduler(setup, slots, rng_seed, obs=None, max_len=MAX_LEN):
    return Scheduler(setup[2], setup[3], num_slots=slots, max_len=max_len,
                     rng_seed=rng_seed, obs=obs, device="cpu")


# -- the property checks (seed in, invariants out) ----------------------------
def check_main_invariants(setup, seed):
    reqs, slots, rng_seed = gen_workload(seed)
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    sched = _scheduler(setup, slots, rng_seed, obs)
    for spec in reqs:
        sched.submit(make_request(spec))
    done = sched.run()
    obs.close()

    assert sorted(done) == [s["request_id"] for s in reqs]   # no starvation
    assert not sched.pending()
    spans = ("prefill", "decode/step") if any(
        len(done[s["request_id"]].generated) > 1 for s in reqs) \
        else ("prefill",)
    errors = check_records(obs.tracer.records, require_spans=spans)
    assert errors == [], errors
    assert_matches_oracles(setup, done, reqs, slots, rng_seed)


def check_eviction_replay(setup, seed, evict_step, evict_pick):
    """Preempting an in-flight slot mid-run discards its tokens, yet the
    output is still the oracles' and the trace stays clean."""
    reqs, slots, rng_seed = gen_workload(seed, max_requests=3)
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    sched = _scheduler(setup, slots, rng_seed, obs)
    for spec in reqs:
        sched.submit(make_request(spec))
    evicted_rid, had = _evict_after(sched, evict_step, evict_pick)
    if evicted_rid is not None:
        assert evicted_rid not in [s.request.request_id
                                   for s in sched.slots if s is not None]
        assert had >= 1                       # it really was mid-flight
    done = sched.run()
    obs.close()

    assert sorted(done) == [s["request_id"] for s in reqs]
    if evicted_rid is not None:
        assert done[evicted_rid].admissions >= 2
        evs = [e for e in obs.tracer.events("request/evict")
               if e["attrs"]["request_id"] == evicted_rid]
        assert [e["attrs"]["reason"] for e in evs] == ["test-preempt"]
    assert check_request_lifecycles(obs.tracer.records) == []
    assert_matches_oracles(setup, done, reqs, slots, rng_seed,
                           evict=(evict_step, evict_pick))


def check_cache_pressure(setup, seed):
    """A prompt near max_len stops with "cache_full" exactly at the cache
    bound, while co-batched short requests finish normally."""
    max_len = 16
    reqs, slots, rng_seed = gen_workload(seed, max_requests=3,
                                         max_prompt=4, max_new=12)
    long_spec = {"request_id": len(reqs), "prompt_seed": seed,
                 "prompt_len": max_len - 3, "max_new_tokens": 12,
                 "temperature": 0.0, "priority": 0, "eos_token": None}
    reqs = reqs + [long_spec]
    sched = _scheduler(setup, slots, rng_seed, max_len=max_len)
    for spec in reqs:
        sched.submit(make_request(spec))
    done = sched.run()

    rid = long_spec["request_id"]
    assert done[rid].finish_reason == "cache_full"
    # the last decode writes at max_len - 2; max_len - 1 is the scratch
    assert long_spec["prompt_len"] + len(done[rid].generated) == max_len
    assert_matches_oracles(setup, done, reqs, slots, rng_seed,
                           max_len=max_len)


def check_estimator_invariants(estimator, seed):
    setup = estimator_setup(estimator)
    reqs, slots, rng_seed = gen_workload(seed, max_requests=2,
                                         max_prompt=6, max_new=3)
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    sched = _scheduler(setup, slots, rng_seed, obs)
    assert sched.estimator == estimator
    for spec in reqs:
        sched.submit(make_request(spec))
    done = sched.run()
    obs.close()

    assert sorted(done) == [s["request_id"] for s in reqs]
    assert check_request_lifecycles(obs.tracer.records) == []
    assert_matches_oracles(setup, done, reqs, slots, rng_seed)


def check_priority_order(setup, prios, rng_seed):
    """One slot, everything queued up front: admission order is strictly
    (priority desc, submission asc), in the port and in the reference."""
    admitted = []
    for cls, req_cls, extra in ((Scheduler, Request, {"device": "cpu"}),
                                (JScheduler, JRequest, {})):
        cfg, params = (setup[2], setup[3]) if cls is Scheduler \
            else (setup[0], setup[1])
        sched = cls(cfg, params, num_slots=1, max_len=MAX_LEN,
                    rng_seed=rng_seed, **extra)
        for i, p in enumerate(prios):
            rng = np.random.default_rng(i)
            sched.submit(req_cls(request_id=i,
                                 prompt=rng.integers(0, VOCAB, size=3),
                                 max_new_tokens=1, priority=p))
        order = []
        while sched.pending():
            order.extend(sched.step().admitted)
        admitted.append(order)
    expect = [i for _, i in sorted(((-p, i) for i, p in enumerate(prios)))]
    assert admitted[0] == admitted[1] == expect


# -- the deterministic sweep, at the reference's seed counts -------------------
@pytest.mark.parametrize("seed", range(10))
def test_sweep_random_workload_matches_sequential_oracle(exact_setup, seed):
    check_main_invariants(exact_setup, seed)


@pytest.mark.parametrize("seed", range(6))
def test_sweep_eviction_replays_bit_identically(exact_setup, seed):
    check_eviction_replay(exact_setup, seed, evict_step=seed % 3,
                          evict_pick=seed)


@pytest.mark.parametrize("seed", range(4))
def test_sweep_cache_pressure_exact_reason(exact_setup, seed):
    check_cache_pressure(exact_setup, seed)


@pytest.mark.parametrize("estimator", registry.list_estimators())
@pytest.mark.parametrize("seed", range(3))
def test_sweep_every_estimator(estimator, seed):
    check_estimator_invariants(estimator, seed)


@pytest.mark.parametrize("seed", range(5))
def test_sweep_priority_then_fifo(exact_setup, seed):
    rng = np.random.default_rng(seed)
    prios = [int(p) for p in rng.integers(0, 4, size=rng.integers(2, 6))]
    check_priority_order(exact_setup, prios, int(rng.integers(0, 2**16)))


# -- deterministic edges ------------------------------------------------------
def test_truncated_run_reports_every_unfinished_request(exact_setup):
    """An expired step budget warns, counts the leftovers and keeps them
    pending for a later run; nothing silently vanishes."""
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    sched = _scheduler(exact_setup, 1, 0, obs)
    rng = np.random.default_rng(0)
    for i in range(3):
        sched.submit(Request(request_id=i,
                             prompt=rng.integers(0, VOCAB, size=4),
                             max_new_tokens=8))
    with pytest.warns(RuntimeWarning, match="truncated"):
        done = sched.run(max_iters=1)
    pending_ids = {s.request.request_id for s in sched.slots
                   if s is not None}
    queued_ids = {r.request_id for _, _, r in sched._heap}
    assert set(done) | pending_ids | queued_ids == {0, 1, 2}
    snap = obs.metrics.snapshot(provenance=PROV)
    assert snap["counters"]["serve/truncated"] == \
        len(pending_ids) + len(queued_ids)
    done = sched.run()                      # the truncated run resumes
    assert sorted(done) == [0, 1, 2]
    obs.close()


def test_duplicate_request_id_rejected(exact_setup):
    sched = _scheduler(exact_setup, 1, 0)
    sched.submit(Request(request_id=7, prompt=np.zeros(3, np.int64),
                         max_new_tokens=1))
    with pytest.raises(ValueError, match="duplicate request_id 7"):
        sched.submit(Request(request_id=7, prompt=np.zeros(3, np.int64)))


def test_scheduler_output_independent_of_obs(exact_setup):
    """``obs=None`` and a full Obs give the same tokens: instrumentation
    never touches a tensor."""
    def run(obs):
        sched = _scheduler(exact_setup, 2, 3, obs)
        rng = np.random.default_rng(1)
        for i in range(3):
            sched.submit(Request(request_id=i,
                                 prompt=rng.integers(0, VOCAB, size=5),
                                 max_new_tokens=3, temperature=0.5))
        return {i: s.generated for i, s in sched.run().items()}

    off = run(None)
    obs = Obs(clock=clock.FakeClock(), provenance=PROV)
    on = run(obs)
    obs.close()
    assert off == on
