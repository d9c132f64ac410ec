"""The port's Scheduler with observability against the reference
Scheduler on the same workload and parameters (qwen3 SMOKE, rm attention,
fp32, the fused path on both sides): on a FakeClock every record of the
trace (names, attributes, timestamps and durations) and every metric
equals the reference's; the trace passes tools/check_trace.py unchanged;
with kernel tracing the ``kernel/*`` spans carry the reference's names and
launch costs, one per launch; and ``obs=None`` serves the same tokens bit
for bit."""
import sys
from pathlib import Path

import pytest
import torch

from repro.bench.roofline import launch_cost as ref_launch_cost
from repro.obs import Obs as JObs
from repro.obs import clock as jclock
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.obs import Obs, clock
from repro_torch.serve import Request, Scheduler
from test_torch_serve import _drive, _fp32_models

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from check_trace import check_trace  # noqa: E402

PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}
MAX_LEN = 64


@pytest.fixture(scope="module")
def models():
    return _fp32_models()


def _serve(models, obs, port=True):
    jcfg, jp, tcfg, tp = models
    if port:
        sched = Scheduler(tcfg, tp, num_slots=2, max_len=MAX_LEN,
                          device="cpu", obs=obs)
        done, evicted = _drive(sched, Request, tcfg.vocab_size)
    else:
        sched = JScheduler(jcfg, jp, num_slots=2, max_len=MAX_LEN, obs=obs)
        done, evicted = _drive(sched, JRequest, jcfg.vocab_size)
    return sched, {rid: s.generated for rid, s in done.items()}, evicted


def _body(obs):
    return [{k: v for k, v in r.items() if k != "wall_time"}
            for r in obs.tracer.records[1:]]


@pytest.fixture(scope="module")
def both_traced(models, tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "port.jsonl"
    obs_p = Obs(trace_path=path, clock=clock.FakeClock(), provenance=PROV)
    _, toks_p, ev_p = _serve(models, obs_p)
    obs_p.close()
    obs_r = JObs(clock=jclock.FakeClock(), provenance=PROV)
    _, toks_r, ev_r = _serve(models, obs_r, port=False)
    obs_r.close()
    assert toks_p == toks_r and ev_p == ev_r is not None
    return obs_p, obs_r, path, toks_p


def test_request_events_equal_reference(both_traced):
    obs_p, obs_r, _, _ = both_traced
    req = lambda o: [(r["name"], r["attrs"]) for r in _body(o)
                     if r["name"].startswith("request/")]
    got, want = req(obs_p), req(obs_r)
    assert got == want
    names = [n for n, _ in got]
    for n in ("request/submit", "request/admit", "request/evict",
              "request/finish"):
        assert n in names
    assert all({"request_id", "slot", "bucket"} <= set(a)
               for n, a in got if n == "request/admit")


def test_whole_trace_and_metrics_equal_reference_on_fake_clock(
        both_traced):
    """Every clock read happens in the reference's order, so every span
    and event (name, ts_us, dur_us, attrs) and every histogram value is
    the reference's."""
    obs_p, obs_r, _, _ = both_traced
    assert _body(obs_p) == _body(obs_r)
    sp = obs_p.metrics.snapshot(provenance=PROV)
    sr = obs_r.metrics.snapshot(provenance=PROV)
    sp.pop("wall_time"), sr.pop("wall_time")
    assert sp == sr
    for name, h in obs_r.metrics.histograms.items():
        assert obs_p.metrics.histograms[name]._vals == h._vals, name
    assert {"serve/ttft_s", "serve/inter_token_s", "serve/token_latency_s",
            "serve/tokens_per_s"} <= set(sp["histograms"])
    assert sp["counters"]["serve/evictions"] == 1.0


def test_port_trace_passes_check_trace(both_traced):
    _, _, path, _ = both_traced
    assert check_trace(path) == []


def test_kernel_spans_one_per_launch_with_reference_costs(models,
                                                          both_traced):
    """With kernel tracing, each admission records one ``kernel/
    rm_attn_fused`` span a layer (the fused prefill, kernel B2 on the
    card) and each decode step one ``kernel/rm_feature`` span a layer (q
    and k featurized in one launch, kernel B1), each with the reference's
    ``launch_cost`` at the launch's shape. Tokens are unchanged."""
    _, _, tcfg, _ = models
    _, _, _, toks = both_traced
    obs = Obs(clock=clock.FakeClock(), provenance=PROV,
              install_kernel_tracing=True)
    sched, got, _ = _serve(models, obs)
    obs.close()
    assert got == toks
    layers = tcfg.num_layers
    admits = obs.tracer.spans("admit")
    steps = obs.tracer.spans("decode/step")
    fused = obs.tracer.spans("kernel/rm_attn_fused")
    feat = obs.tracer.spans("kernel/rm_feature")
    assert len(fused) == layers * len(admits)
    assert len(feat) == layers * len(steps)
    assert {s["name"] for s in obs.tracer.spans()
            if s["name"].startswith("kernel/")} == {
                "kernel/rm_attn_fused", "kernel/rm_feature"}
    h, dh = tcfg.num_heads, tcfg.resolved_head_dim
    w = sched.executor.compute_params["layers"][0]["attn"]["rm_w"]
    kdeg, f, _ = w.shape
    for adm in admits:
        t = adm["attrs"]["bucket"]
        inside = [s for s in fused
                  if adm["ts_us"] <= s["ts_us"] < adm["ts_us"]
                  + adm["dur_us"]]
        assert len(inside) == layers
        want = ref_launch_cost("rm_attn_fused", batch=h, t=t, d=dh,
                               depth=kdeg, f=f, dv=dh, itemsize=4)
        for s in inside:
            assert s["attrs"] == {"traced": False, **want}
    want = ref_launch_cost("rm_feature", batch=2 * 2 * h, d=dh, depth=kdeg,
                           f=f, itemsize=4)
    assert all(s["attrs"] == {"traced": False, **want} for s in feat)


def test_obs_none_is_bitwise_identical(models, both_traced):
    _, _, _, toks = both_traced
    _, off, _ = _serve(models, None)
    assert off == toks
    sched = Scheduler(models[2], models[3], num_slots=1, max_len=16,
                      device="cpu")
    assert sched.obs.enabled is False
    tiered = Scheduler(models[2], models[3], num_slots=1, max_len=16,
                       device="cpu", accuracy_tiers={"low": 1})
    assert tiered.executor.tier_features(1) == models[2].rm.num_features
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("which,mode", [("serve", "rm"), ("serve", "exact"),
                                        ("train", "rm"), ("train", "exact")])
def test_launchers_write_trace_and_metrics(tmp_path, which, mode):
    """``--trace-out``, ``--metrics-out`` and ``--drift-every`` of both
    launchers (the reference's flags), in either attention mode: the
    trace carries the loop's spans and, in rm mode, the kernel spans and
    the drift check; the metrics file its counters."""
    import json

    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.obs import current_tracer, read_trace

    trace, metrics = tmp_path / "t.jsonl", tmp_path / "m.json"
    flags = ["--smoke", "--device", "cpu", "--attention-mode", mode,
             "--trace-out", str(trace), "--metrics-out", str(metrics),
             "--drift-every", "2"]
    if which == "serve":
        serve_cli.main(flags + ["--requests", "2", "--max-new", "3"])
        assert check_trace(trace) == []
    else:
        train_cli.main(flags + ["--steps", "2", "--batch", "2", "--seq",
                                "16"])
    assert current_tracer() is None
    names = {r["name"] for r in read_trace(trace)[1:]}
    loop = "decode/step" if which == "serve" else "train/step"
    assert loop in names
    kernel = {"kernel/rm_attn_fused", "kernel/rm_feature"}
    assert (kernel <= names) if mode == "rm" else not kernel & names
    assert ("drift/check" in names) == (mode == "rm")
    snap = json.loads(metrics.read_text())
    counter = "serve/tokens_generated" if which == "serve" else "train/steps"
    assert snap["counters"][counter] > 0
    assert ("drift/checks" in snap["counters"]) == (mode == "rm")
