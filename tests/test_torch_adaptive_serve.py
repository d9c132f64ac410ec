"""Accuracy tiers and the drift -> grow -> rebind loop in the port, held
against the reference (tests/test_adaptive.py's tier, executor-validation
and drift cases).

Tiers: the port's Scheduler and the reference's, on the same qwen3 SMOKE
weights (fp32, rm, the fused path) and a FakeClock, serve the same tokens
and emit the same ``request/*`` events (``accuracy_tier``,
``tier_features`` on each admit), and tiers change no token (they are
bookkeeping in both packages). Drift: the reference's growable map,
handed across at each budget, gives the reference's ``drift/*`` events
(the sup error within 1e-5, every other attribute exactly); the port's own
``grow()`` runs the same loop deterministically."""
import json

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.core import ExponentialDotProductKernel as JExp
from repro.core import make_growable_feature_map as jax_growable
from repro.obs import Obs as JObs
from repro.obs import clock as jclock
from repro.obs.drift import DriftMonitor as JDrift
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.convert import growable_from_jax
from repro_torch.core import ExponentialDotProductKernel as TExp
from repro_torch.core import make_growable_feature_map
from repro_torch.obs import Obs, clock
from repro_torch.obs.drift import DriftMonitor
from repro_torch.serve import Request, Scheduler
from repro_torch.serve.executor import StepExecutor
from test_torch_serve import _fp32_models

TIERS = {"low": 1, "standard": 2, "high": 4}
PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}
SUP_TOL = 1e-5   # sup |G - K| over 136 sentinel pairs, fp32 Grams


@pytest.fixture(scope="module")
def models():
    return _fp32_models()


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=n) for n in (6, 11, 4, 20)]


def _serve(sched, make_request, vocab, tiers=(None,)):
    for i, p in enumerate(_prompts(vocab)):
        sched.submit(make_request(request_id=i, prompt=p, max_new_tokens=3,
                                  accuracy_tier=tiers[i % len(tiers)]))
    return sched.run()


@pytest.fixture(scope="module")
def tiered(models):
    jcfg, jp, tcfg, tp = models
    tier_cycle = ("low", "high", None, "standard")
    obs_p = Obs(clock=clock.FakeClock(), provenance=PROV)
    port = Scheduler(tcfg, tp, num_slots=2, max_len=64, device="cpu",
                     accuracy_tiers=TIERS, obs=obs_p)
    done_p = _serve(port, Request, tcfg.vocab_size, tier_cycle)
    obs_r = JObs(clock=jclock.FakeClock(), provenance=PROV)
    ref = JScheduler(jcfg, jp, num_slots=2, max_len=64,
                     accuracy_tiers=TIERS, obs=obs_r)
    done_r = _serve(ref, JRequest, jcfg.vocab_size, tier_cycle)
    return port, done_p, obs_p, done_r, obs_r


def _events(obs, prefix):
    return [(r["name"], r["attrs"]) for r in obs.tracer.records[1:]
            if r.get("name", "").startswith(prefix)]


def test_tiers_match_reference(tiered, models):
    port, done_p, obs_p, done_r, obs_r = tiered
    assert {r: s.generated for r, s in done_p.items()} == {
        r: s.generated for r, s in done_r.items()}
    assert {r: s.tier_features for r, s in done_p.items()} == {
        r: s.tier_features for r, s in done_r.items()}
    assert _events(obs_p, "request/") == _events(obs_r, "request/")
    admits = [a for n, a in _events(obs_p, "request/") if n ==
              "request/admit"]
    assert {a["accuracy_tier"] for a in admits} == {"low", "high",
                                                    "standard", None}
    # tiers are bookkeeping: an untiered scheduler serves the same tokens
    _, _, tcfg, tp = models
    plain = _serve(Scheduler(tcfg, tp, num_slots=2, max_len=64,
                             device="cpu"), Request, tcfg.vocab_size)
    assert {r: s.generated for r, s in plain.items()} == {
        r: s.generated for r, s in done_p.items()}


def test_scheduler_tier_features(tiered, models):
    port, done_p, _, _, _ = tiered
    tcfg = models[2]
    per_gen = tcfg.rm.num_features // 4
    assert port.executor.feature_generations == 4
    assert port.executor.generation_features == per_gen
    assert port.executor.tier_features(1) == per_gen
    assert port.executor.tier_features(4) == tcfg.rm.num_features
    with pytest.raises(ValueError, match="range"):
        port.executor.tier_features(5)
    assert done_p[0].tier_features == per_gen            # low
    assert done_p[1].tier_features == tcfg.rm.num_features   # high
    assert done_p[2].tier_features is None               # untiered
    assert done_p[3].tier_features == 2 * per_gen        # standard


def test_scheduler_rejects_bad_tiers(tiered, models):
    port = tiered[0]
    tcfg, tp = models[2], models[3]
    prompt = np.arange(4) % tcfg.vocab_size
    with pytest.raises(ValueError, match="gold"):
        port.submit(Request(request_id=99, prompt=prompt,
                            accuracy_tier="gold"))
    untiered = Scheduler(tcfg, tp, num_slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="without accuracy_tiers"):
        untiered.submit(Request(request_id=0, prompt=prompt,
                                accuracy_tier="low"))


def test_executor_tier_validation(models):
    import dataclasses

    from repro_torch.models.transformer import init_model

    tcfg, tp = models[2], models[3]
    with pytest.raises(ValueError, match="divide"):
        StepExecutor(tcfg, tp, 1, 32, device="cpu",
                     feature_generations=tcfg.rm.num_features + 1)
    with pytest.raises(ValueError, match=">= 1"):
        StepExecutor(tcfg, tp, 1, 32, device="cpu", feature_generations=0)
    exact = dataclasses.replace(tcfg, attention_mode="exact").validate()
    params_exact = init_model(exact, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="RM"):
        StepExecutor(exact, params_exact, 1, 32, device="cpu",
                     feature_generations=2)
    ex = StepExecutor(exact, params_exact, 1, 32, device="cpu")
    with pytest.raises(ValueError, match="RM attention"):
        ex.tier_features(1)
    with pytest.raises(ValueError, match=">= 1"):
        Scheduler(tcfg, tp, num_slots=1, max_len=32, device="cpu",
                  accuracy_tiers={"bad": 0})


# ---------------------------------------------------------------------------
# drift -> grow -> rebind
# ---------------------------------------------------------------------------
def _drift_trace(grown_maps, monitor_cls, obs_cls, clock_mod, kernel):
    """Three ticks of the loop on a FakeClock, the monitor rebound to the
    next map of ``grown_maps`` after each; returns the ``drift/*`` events,
    budgets, target bounds and counters."""
    mon = monitor_cls(grown_maps[0], kernel, delta=0.05, radius=0.7,
                      measure="proportional", margin=1e-9)
    obs = obs_cls(clock=clock_mod.FakeClock(step=0.5), drift=mon,
                  drift_every=1, provenance=PROV)
    bounds = []
    for nxt in grown_maps[1:]:
        obs.tick_drift()
        rec = mon.recommend()
        assert rec is not None          # the margin forces a violation
        assert nxt.output_dim == rec.num_features_target
        mon.rebind(nxt)
        assert mon.recommend() is None   # the stale report is dropped
        bounds.append(rec.eps_bound_target)
    obs.close()
    events = [(r["name"], r["attrs"]) for r in obs.tracer.records[1:]
              if r.get("name", "").startswith("drift/")]
    return events, bounds, mon.checks, mon.violations


def test_drift_events_equal_reference_on_handed_maps():
    jgm = jax_growable(JExp(1.0), 6, jax.random.PRNGKey(0),
                       base_features=48, measure="proportional")
    jmaps = [jgm, jgm.grow(), jgm.grow().grow(), jgm.grow().grow().grow()]
    tmaps = [growable_from_jax(m, kernel=TExp(1.0)) for m in jmaps]
    want = _drift_trace(jmaps, JDrift, JObs, jclock, JExp(1.0))
    got = _drift_trace(tmaps, DriftMonitor, Obs, clock, TExp(1.0))
    assert got[1:] == want[1:]
    assert [n for n, _ in got[0]] == [n for n, _ in want[0]]
    assert "drift/grow_recommendation" in [n for n, _ in got[0]]
    for (_, a), (_, b) in zip(got[0], want[0]):
        assert set(a) == set(b)
        for k in a:
            if k in ("sup_err", "reason"):
                continue
            assert a[k] == b[k], k
        if "sup_err" in a:
            assert abs(a["sup_err"] - b["sup_err"]) <= SUP_TOL


def test_drift_grow_rebind_loop_deterministic():
    """The port's own growth: budgets double, the envelope tightens, two
    runs give identical traces."""
    def run():
        gm = make_growable_feature_map(TExp(1.0), 6, 0, base_features=48,
                                       measure="proportional", device="cpu")
        maps = [gm]
        for _ in range(3):
            maps.append(maps[-1].grow_to(2 * maps[-1].output_dim))
        return _drift_trace(maps, DriftMonitor, Obs, clock, TExp(1.0))

    a, b = run(), run()
    assert a == b
    events, bounds, checks, violations = a
    assert bounds[0] > bounds[1] > bounds[2]
    assert (checks, violations) == (3, 3)
    budgets = [e["num_features_target"] for n, e in events
               if n == "drift/grow_recommendation"]
    assert budgets == [64, 128, 256]


def test_drift_recommend_fires_only_on_violation(tmp_path):
    kern = TExp(1.0)
    gm = make_growable_feature_map(kern, 6, 0, base_features=64,
                                   measure="proportional", device="cpu")
    mon = DriftMonitor(gm, kern, delta=0.05, radius=0.7,
                       measure="proportional")
    assert mon.recommend() is None
    if mon.check().ok:
        assert mon.recommend() is None
    tight = DriftMonitor(gm, kern, delta=0.05, radius=0.7,
                         measure="proportional", margin=1e-9)
    assert not tight.check().ok
    rec = tight.recommend()
    assert rec.num_features_target == 2 * gm.output_dim
    assert rec.eps_bound_target < rec.eps_bound_now
    assert str(gm.output_dim) in rec.reason
    # the event reaches a trace file
    path = tmp_path / "trace.jsonl"
    obs = Obs(trace_path=str(path), clock=clock.FakeClock(step=0.5),
              drift=DriftMonitor(gm, kern, margin=1e-9, radius=0.7,
                                 measure="proportional"), drift_every=1)
    obs.tick_drift()
    obs.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    rec_row = next(r for r in rows
                   if r.get("name") == "drift/grow_recommendation")
    assert rec_row["attrs"]["num_features_target"] == 2 * gm.output_dim
