"""The port's observability layer (repro_torch.obs, common.env,
bench.roofline) against the reference's repro.obs on the same inputs:
metrics summaries and snapshots exactly, the Tracer's records and their
Chrome conversion dict-equal, launch costs equal, the drift monitor's
bound within 1e-12, its sentinels bitwise and its sup error within 1e-5 on
a reference map handed across, tick_drift's metrics and events, the CLI's
output, and the kernel spans the wrappers record."""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import repro.obs as R
import repro_torch.obs as P
from repro.bench.roofline import launch_cost as ref_launch_cost
from repro.core import ExponentialDotProductKernel as JExp
from repro.core import make_feature_map as j_make_feature_map
from repro_torch.bench.roofline import launch_cost
from repro_torch.core.feature_map import RMFeatureMap
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp
from repro_torch.core.plan import FeaturePlan
from repro_torch.obs import metrics as pmetrics

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from check_trace import PROVENANCE_KEYS, check_trace  # noqa: E402

PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}


def _strip_wall(d):
    return {k: v for k, v in d.items() if k != "wall_time"}


def _records(tracer):
    return [_strip_wall(r) for r in tracer.records]


# ---------------------------------------------------------------------------
# clock and metrics
# ---------------------------------------------------------------------------
def test_fake_clock_reads_like_the_reference():
    a, b = P.clock.FakeClock(10.0, 0.5), R.clock.FakeClock(10.0, 0.5)
    assert [a(), a()] == [b(), b()] == [10.0, 10.5]
    a.advance(4.0)
    b.advance(4.0)
    assert a() == b() == 15.0
    assert P.clock.monotonic() <= P.clock.monotonic()


@pytest.mark.parametrize("vals", [[], [7.0], [float(v) for v in range(101)],
                                  list(np.random.default_rng(0).exponential(
                                      size=37))])
def test_percentiles_equal_reference(vals):
    srt = sorted(vals)
    for q in (0.0, 50.0, 90.0, 99.0, 100.0):
        assert pmetrics.percentile(srt, q) == R.metrics.percentile(srt, q)


@pytest.mark.parametrize("n", [4, 5000])
def test_histogram_summary_equals_reference(n):
    """Below and past the 4096 reservoir (the replacement draws come from
    the same ``random.Random(0)`` stream)."""
    vals = np.random.default_rng(n).standard_normal(n).tolist()
    hp = P.MetricsRegistry(now=P.clock.FakeClock()).histogram("x")
    hr = R.MetricsRegistry(now=R.clock.FakeClock()).histogram("x")
    for v in vals:
        hp.observe(v)
        hr.observe(v)
    assert hp.summary() == hr.summary()
    assert hp._vals == hr._vals
    assert (hp.t_first, hp.t_last) == (hr.t_first, hr.t_last)


def test_snapshot_and_json_equal_reference(tmp_path):
    regs = [P.MetricsRegistry(now=P.clock.FakeClock()),
            R.MetricsRegistry(now=R.clock.FakeClock())]
    for reg in regs:
        for v in (1.0, 2.0, 3.0, 4.0):
            reg.histogram("serve/ttft_s").observe(v)
        reg.counter("serve/requests_submitted").inc(3)
        reg.gauge("serve/queue_depth").set(2)
    sp, sr = (_strip_wall(r.snapshot(provenance=PROV)) for r in regs)
    assert sp == sr
    assert sp["schema"] == "repro.obs.metrics/v1"
    p = regs[0].write_json(tmp_path / "m.json", provenance=PROV)
    assert _strip_wall(json.loads(p.read_text())) == sr


def test_platform_provenance_has_the_checker_keys():
    from repro_torch.common.env import platform_provenance

    prov = platform_provenance()
    for key in PROVENANCE_KEYS + ("device_count", "torch_version",
                                  "cuda_version"):
        assert key in prov
    assert prov["interpret"] is False and prov["jax_version"] is None
    assert prov["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    json.dumps(prov)
    assert "backend" in P.MetricsRegistry().snapshot()["provenance"]
    assert P.Tracer().records[0]["provenance"] == prov


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
def _scripted(mod, path=None):
    tr = mod.Tracer(path=path, now=mod.clock.FakeClock(), provenance=PROV)
    tr.event("request/submit", request_id=0)
    tr.event("request/admit", request_id=0, slot=0, bucket=32)
    with tr.span("prefill", bucket=32):
        pass
    with tr.span("decode/step", active=1):
        pass
    tr.event("request/finish", request_id=0, tokens=4)
    tr.close()
    return tr


def test_tracer_jsonl_roundtrip_equals_reference(tmp_path):
    tp = _scripted(P, tmp_path / "p.jsonl")
    tr = _scripted(R, tmp_path / "r.jsonl")
    assert _records(tp) == _records(tr)
    assert P.read_trace(tmp_path / "p.jsonl") == tp.records
    assert tp.records[0]["schema"] == P.TRACE_SCHEMA == R.TRACE_SCHEMA
    assert check_trace(tmp_path / "p.jsonl") == []


def test_span_recorded_on_exception():
    tr = P.Tracer(now=P.clock.FakeClock(), provenance=PROV)
    with pytest.raises(RuntimeError):
        with tr.span("boom", a=1):
            raise RuntimeError("x")
    (sp,) = tr.spans("boom")
    assert sp["dur_us"] == 1e6 and sp["attrs"] == {"a": 1}


def test_chrome_trace_dict_equal_reference(tmp_path):
    tp, tr = _scripted(P), _scripted(R)
    want = R.chrome_trace(tr.records)
    assert P.chrome_trace(tp.records) == want
    out = P.write_chrome(tp.records, tmp_path / "c.json")
    assert json.loads(out.read_text()) == json.loads(json.dumps(want))


def test_ambient_tracer_install_and_restore():
    assert P.current_tracer() is None
    tr = P.Tracer(now=P.clock.FakeClock(), provenance=PROV)
    prev = P.install_tracer(tr)
    try:
        assert prev is None and P.current_tracer() is tr
    finally:
        P.install_tracer(prev)
    assert P.current_tracer() is None
    obs = P.Obs(clock=P.clock.FakeClock(), provenance=PROV,
                install_kernel_tracing=True)
    assert P.current_tracer() is obs.tracer
    obs.close()
    assert P.current_tracer() is None


def test_noop_and_resolve():
    assert P.resolve(None) is P.NOOP and P.NOOP.enabled is False
    P.NOOP.event("x", a=1)
    P.NOOP.counter("c")
    P.NOOP.gauge("g", 1.0)
    P.NOOP.histogram("h", 1.0)
    P.NOOP.tick_drift()
    assert P.NOOP.span("a") is P.NOOP.span("b")
    obs = P.Obs(clock=P.clock.FakeClock(), provenance=PROV)
    assert P.resolve(obs) is obs
    t0 = obs.now()
    obs.histogram("h", 1.0)
    with obs.span("s"):
        pass
    assert obs.now() - t0 == 4.0          # one clock behind everything
    obs.close()


def test_kernel_scope_disabled_is_a_shared_null_context():
    x = torch.ones(4, 8)
    assert P.current_tracer() is None
    assert P.kernel_scope("rm_feature", x=x) is \
        P.kernel_scope("tensor_sketch", x=x, cost=None)


def test_kernel_scope_span_equals_reference_with_cost():
    cost = dict(batch=4, d=8, depth=3, f=16)
    spans = []
    for mod, x in ((P, torch.ones(4, 8)), (R, jnp.ones((4, 8)))):
        tr = mod.Tracer(now=mod.clock.FakeClock(), provenance=PROV)
        prev = mod.install_tracer(tr)
        try:
            with mod.kernel_scope("rm_feature", x=x, cost=cost, chunk=3):
                pass
        finally:
            mod.install_tracer(prev)
        spans.append(tr.spans("kernel/rm_feature"))
    assert spans[0] == spans[1]
    assert spans[0][0]["attrs"]["traced"] is False
    assert spans[0][0]["attrs"]["flops"] > 0


def test_fused_wrappers_record_one_span_each_with_reference_cost():
    """One call of a fused wrapper (its plain version on the CPU) records
    one ``kernel/<name>`` span whose analytic cost is the reference's
    ``launch_cost`` at the arguments of the reference's call site
    (``kernels/*/ops.py``); tracing changes no value. (The reference's own
    Pallas kernels do not trace on this jax, so the costs are held
    against its ``launch_cost`` directly.)"""
    from repro_torch.kernels.rm_attention.ops import (
        rm_attention_fused_causal,
        rm_attention_fused_noncausal,
    )
    from repro_torch.kernels.rm_feature.ops import rm_feature_fused

    jfm = j_make_feature_map(JExp(), 8, 32, jax.random.PRNGKey(0))
    tfm = RMFeatureMap(plan=FeaturePlan.from_json(jfm.plan.to_json()),
                       omegas=torch.from_numpy(np.array(jfm.omegas)))
    from repro_torch.core.plan import pack_omegas, plan_columns

    w = pack_omegas(tfm.plan, tfm.omegas)
    cd, cs = plan_columns(tfm.plan, torch.device("cpu"))
    kdeg, f, d = w.shape
    gen = torch.Generator().manual_seed(0)
    x = 0.2 * torch.randn((6, d), generator=gen)
    q, k, v = (0.3 * torch.randn((1, 2, 5, d), generator=gen)
               for _ in range(3))
    calls = [
        ("rm_feature", lambda: rm_feature_fused(x, w, cd, cs),
         dict(batch=6, d=d, depth=kdeg, f=f, itemsize=4), {}),
        ("rm_attn_fused",
         lambda: rm_attention_fused_causal(q, k, v, w, cd, cs),
         dict(batch=2, t=5, d=d, depth=kdeg, f=f, dv=d, itemsize=4), {}),
        ("rm_attn_fused",
         lambda: rm_attention_fused_noncausal(q, k, v, w, cd, cs),
         dict(batch=2, t=5, d=d, depth=kdeg, f=f, dv=d, itemsize=4),
         {"mode": "noncausal"}),
    ]
    for name, call, cost, attrs in calls:
        with torch.no_grad():
            plain = call()
        tr = P.Tracer(now=P.clock.FakeClock(), provenance=PROV)
        prev = P.install_tracer(tr)
        try:
            with torch.no_grad():
                traced = call()
        finally:
            P.install_tracer(prev)
        assert torch.equal(plain, traced)
        (sp,) = tr.spans()
        assert sp["name"] == f"kernel/{name}"
        assert sp["attrs"] == {"traced": False, **attrs,
                               **ref_launch_cost(name, **cost)}


@pytest.mark.parametrize("kernel", ["rm_feature", "ctr_feature",
                                    "tensor_sketch", "structured_feature",
                                    "rm_attn_fused"])
@pytest.mark.parametrize("shape", [
    dict(batch=1, d=16, depth=6, f=64),
    dict(batch=128, d=128, depth=8, f=256, dv=128, t=256, itemsize=2),
    dict(batch=20000, d=123, depth=10, f=4000, itemsize=4),
])
def test_launch_cost_equals_reference(kernel, shape):
    assert launch_cost(kernel, **shape) == ref_launch_cost(kernel, **shape)


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_features,n_pairs,delta,measure", [
    (64, 10, 0.05, "proportional"), (256, 136, 0.01, "proportional"),
    (4096, 36, 0.05, "geometric")])
def test_hoeffding_eps_equals_reference(num_features, n_pairs, delta,
                                        measure):
    want = R.hoeffding_eps(JExp(), 0.9, 8, num_features, n_pairs, delta,
                           measure=measure)
    got = P.hoeffding_eps(TExp(), 0.9, 8, num_features, n_pairs, delta,
                          measure=measure)
    assert abs(got - want) <= 1e-12


def _monitors(num_features, **kw):
    """The reference's monitor, and the port's on the reference's map
    handed across (its plan through JSON, its omegas)."""
    jfm = R.DriftMonitor.for_estimator(JExp(), 8, num_features,
                                       estimator="rm", seed=0).fm
    jm = R.DriftMonitor(jfm, JExp(), **kw)
    tfm = RMFeatureMap(plan=FeaturePlan.from_json(jm.fm.plan.to_json()),
                       omegas=torch.from_numpy(np.array(jm.fm.omegas)))
    tm = P.DriftMonitor(tfm, TExp(), **kw)
    return jm, tm


@pytest.mark.parametrize("n_sentinels", [8, 16])
def test_drift_sentinels_bitwise_reference(n_sentinels):
    jm, tm = _monitors(64, n_sentinels=n_sentinels, seed=3)
    np.testing.assert_array_equal(tm._sentinels, jm._sentinels)
    assert tm.n_pairs == jm.n_pairs
    rows = np.random.default_rng(5).standard_normal((40, 8)) * 3.0
    jm.ingest(rows)
    tm.ingest(rows)
    np.testing.assert_array_equal(tm._sentinels, jm._sentinels)
    assert np.all(np.linalg.norm(tm._sentinels, axis=1) <= 0.9 + 1e-5)


@pytest.mark.parametrize("num_features,margin", [(2048, 1.0), (8, 0.01)])
def test_drift_check_on_handed_over_map_equals_reference(num_features,
                                                         margin):
    jm, tm = _monitors(num_features, n_sentinels=8, margin=margin)
    want, got = jm.check(), tm.check()
    assert abs(got.sup_err - want.sup_err) <= 1e-5
    assert abs(got.eps_bound - want.eps_bound) <= 1e-12
    assert (got.ok, got.num_features, got.n_pairs) == \
        (want.ok, want.num_features, want.n_pairs)
    assert got.ok is (margin == 1.0)
    assert (tm.checks, tm.violations) == (jm.checks, jm.violations)
    jr, tr_ = jm.recommend(), tm.recommend()
    if jr is None:
        assert tr_ is None
    else:
        assert tr_.num_features_target == jr.num_features_target
        assert abs(tr_.eps_bound_target - jr.eps_bound_target) <= 1e-12


def test_drift_for_estimator_draws_on_the_given_device():
    gen = torch.Generator().manual_seed(0)
    mon = P.DriftMonitor.for_estimator(TExp(), 8, 256, estimator="rm",
                                       device="cpu", generator=gen,
                                       n_sentinels=8)
    assert mon.fm.omegas.device.type == "cpu"
    again = P.DriftMonitor.for_estimator(TExp(), 8, 256, estimator="rm",
                                         device="cpu", seed=0,
                                         n_sentinels=8)
    assert torch.equal(mon.fm.omegas, again.fm.omegas)
    assert mon.check().ok
    for est in ("tensor_sketch", "ctr", "structured"):
        assert P.DriftMonitor.for_estimator(
            TExp(), 8, 256, estimator=est, device="cpu",
            n_sentinels=8).check().ok, est


def test_tick_drift_metrics_and_violation_event_equal_reference():
    jm, tm = _monitors(8, n_sentinels=8, margin=0.01)
    obs_r = R.Obs(clock=R.clock.FakeClock(), provenance=PROV, drift=jm,
                  drift_every=2)
    obs_p = P.Obs(clock=P.clock.FakeClock(), provenance=PROV, drift=tm,
                  drift_every=2)
    for obs, mon in ((obs_r, jm), (obs_p, tm)):
        obs.tick_drift()
        assert mon.checks == 0
        obs.tick_drift()
        assert mon.checks == 1 and mon.violations == 1
    sr = obs_r.metrics.snapshot(provenance=PROV)
    sp = obs_p.metrics.snapshot(provenance=PROV)
    assert sp["counters"] == sr["counters"] == {"drift/checks": 1.0,
                                                "drift/violations": 1.0}
    assert set(sp["gauges"]) == set(sr["gauges"])
    for k, v in sr["gauges"].items():
        assert abs(sp["gauges"][k] - v) <= 1e-5, k
    names = lambda o: [(r["type"], r["name"], r.get("ts_us"),
                        r.get("dur_us")) for r in o.tracer.records[1:]]
    assert names(obs_p) == names(obs_r)
    (ev,) = obs_p.tracer.events("drift/violation")
    assert ev["attrs"]["num_features"] == tm.fm.output_dim
    (gr,) = obs_p.tracer.events("drift/grow_recommendation")
    assert gr["attrs"]["num_features_target"] == 2 * tm.fm.output_dim
    obs_r.close()
    obs_p.close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_summarize_diff_chrome_equal_reference(tmp_path, capsys):
    from repro.obs.__main__ import main as ref_main
    from repro_torch.obs.__main__ import main

    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _scripted(P, a)
    tr = P.Tracer(path=b, now=P.clock.FakeClock(step=2.0), provenance=PROV)
    with tr.span("prefill"):
        pass
    tr.close()
    for argv in (["summarize", str(a)], ["diff", str(a), str(b)]):
        assert ref_main(argv) == 0
        want = capsys.readouterr().out
        assert main(argv) == 0
        assert capsys.readouterr().out == want
        assert "prefill" in want
    assert main(["chrome", str(a), "-o", str(tmp_path / "p.json")]) == 0
    assert ref_main(["chrome", str(a), "-o", str(tmp_path / "r.json")]) == 0
    capsys.readouterr()
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "r.json").read_text())
