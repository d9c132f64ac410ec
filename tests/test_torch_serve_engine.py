"""The port's deprecated ``ServingEngine`` (``repro_torch.serve``) held
against the reference's, and the cases of ``tests/test_serve_engine.py``
and ``tests/test_serve_obs.py`` ported.

1. Greedy tokens of a workload (mixed prompt lengths, more requests than
   slots) identical to the reference engine's on the same weights (qwen3
   SMOKE, fp32): rm fused, rm two-launch, tensor_sketch, ctr, structured
   and exact attention; and to a full-forward argmax rollout.
2. Sampling: one engine-wide ``torch.Generator`` (draws cross no
   package), held against a full-forward rollout that replays its
   discipline (one draw an admission at the request's temperature, one
   batched draw a decode step on logits over the temperature); the hot
   and cold streams of one seed diverge.
3. Slot-count invariance, the bucket ladder (custom, validated, clipped),
   the finish reasons (max_new_tokens 1, EOS first, cache_full), the
   ``max_iters`` truncation warning and counter, the refusals.
4. Observability on a FakeClock: the trace's events and spans (names and
   attributes, in order) equal the reference engine's; the histograms
   hold the fake clock's exact values; obs on and off serve the same
   tokens.
5. ``launch.serve.make_engine(scheduler="bucketed")`` and its refusals.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.obs import Obs as JObs
from repro.obs import clock as jclock
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import make_engine
from repro_torch.models.transformer import forward, init_model
from repro_torch.obs import Obs, clock
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve.engine import _bucket
from repro_torch.serve.sampler import sample_token

PROV = {"backend": "test", "device_kind": "test", "device_count": 1,
        "interpret": False, "jax_version": "0"}
MAX_LEN = 64
# (request_id, prompt_len, max_new_tokens): prompts in both buckets
WORKLOAD = [(0, 5, 6), (1, 33, 4), (2, 17, 7), (3, 40, 5), (4, 9, 6)]
KINDS = ("rm", "rm_off", "tensor_sketch", "ctr", "structured", "exact")


def _prompt(rid, n, vocab):
    return np.random.default_rng((9, rid)).integers(0, vocab, size=n)


def _models(kind):
    """qwen3 SMOKE fp32 on both sides, the reference's weights handed
    across: rm fused (the reference's jnp formulation, the port's B2
    plain version), rm two-launch, the three other families, or exact."""
    if kind == "exact":
        mode, est, fuse = "exact", None, None
    else:
        mode = "rm"
        est = "rm" if kind in ("rm", "rm_off") else kind
        fuse = "off" if kind == "rm_off" else "auto"
    cfgs = []
    # the reference's fused rm path: its jnp formulation ("on")
    for get, f in ((jax_get_config, "on" if kind == "rm" else fuse),
                   (get_config, fuse)):
        cfg = get("qwen3-1.7b", smoke=True, attention_mode=mode,
                  estimator=est)
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        if f is not None:
            cfg = dataclasses.replace(cfg, rm=dataclasses.replace(
                cfg.rm, fuse_featurize=f))
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jp = jt.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _drive(engine, make_request, vocab, workload=WORKLOAD, **kw):
    for rid, n, new in workload:
        engine.submit(make_request(request_id=rid,
                                   prompt=_prompt(rid, n, vocab),
                                   max_new_tokens=new, **kw))
    return engine.run()


@pytest.fixture(scope="module")
def setup():
    """The port's own qwen3 SMOKE in fp32 (exact attention, as the
    reference's engine tests)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              compute_dtype="float32")
    return cfg, init_model(cfg, torch.Generator().manual_seed(0))


def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    return ServingEngine(cfg, params, device="cpu", **kw)


def _fake_obs(port=True):
    return (Obs if port else JObs)(
        clock=(clock if port else jclock).FakeClock(), provenance=PROV)


# ---------------------------------------------------------------------------
# 1. greedy tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_greedy_tokens_equal_the_reference_engine(kind):
    jcfg, jp, tcfg, tp = _models(kind)
    jeng = JEngine(jcfg, jp, num_slots=2, max_len=MAX_LEN)
    teng = _engine(tcfg, tp)
    assert teng.estimator == jeng.estimator
    assert teng.fused_attention is jeng.fused_attention
    jdone = _drive(jeng, JRequest, jcfg.vocab_size)
    tdone = _drive(teng, Request, tcfg.vocab_size)
    assert sorted(tdone) == sorted(jdone) == [r[0] for r in WORKLOAD]
    for rid in jdone:
        assert tdone[rid].generated == jdone[rid].generated, (kind, rid)
        assert tdone[rid].finish_reason == jdone[rid].finish_reason
        assert tdone[rid].slot == jdone[rid].slot


def _rollout(cfg, params, prompt, n_new):
    """Greedy decode through repeated FULL forward passes (no cache)."""
    tokens, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n_new):
            logits, _ = forward(params, cfg,
                                {"tokens": torch.tensor([tokens])})
            out.append(int(torch.argmax(logits[0, -1])))
            tokens.append(out[-1])
    return out


def test_engine_matches_full_forward_rollout(setup):
    cfg, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 7)]
    engine = _engine(cfg, params)
    for i, p in enumerate(prompts):
        engine.submit(Request(request_id=i, prompt=p, max_new_tokens=6))
    done = engine.run()
    for i, p in enumerate(prompts):
        assert done[i].generated == _rollout(cfg, params, p, 6), i


def test_engine_slot_count_invariance(setup):
    cfg, params = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=6) for _ in range(4)]
    results = {}
    for slots in (1, 4):
        engine = _engine(cfg, params, num_slots=slots)
        for i, p in enumerate(prompts):
            engine.submit(Request(request_id=i, prompt=p, max_new_tokens=5))
        done = engine.run()
        results[slots] = {i: done[i].generated for i in range(4)}
    assert results[1] == results[4]


# ---------------------------------------------------------------------------
# 2. sampling
# ---------------------------------------------------------------------------
def _sampled_rollout(cfg, params, prompt, n_new, temperature, rng_seed=0):
    """Temperature decode through repeated FULL forward passes, replaying
    the engine's generator: one draw at the request's temperature for the
    admission, then one a step on the logits over the temperature."""
    gen = torch.Generator()
    gen.manual_seed(rng_seed)
    tokens, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for step in range(n_new):
            logits, _ = forward(params, cfg,
                                {"tokens": torch.tensor([tokens])})
            row = logits[:, -1]
            if step == 0:
                tok = int(sample_token(row, gen, temperature)[0])
            else:
                tok = int(sample_token(row / temperature, gen, 1.0)[0])
            out.append(tok)
            tokens.append(tok)
    return out


@pytest.mark.parametrize("temperature", [0.25, 4.0])
def test_decode_respects_per_request_temperature(setup, temperature):
    cfg, params = setup
    prompt = np.random.default_rng(17).integers(0, cfg.vocab_size, size=6)
    want = _sampled_rollout(cfg, params, prompt, 8, temperature)
    engine = _engine(cfg, params, num_slots=1, rng_seed=0)
    engine.submit(Request(request_id=0, prompt=prompt, max_new_tokens=8,
                          temperature=temperature))
    assert engine.run()[0].generated == want


def test_hot_and_cold_streams_diverge(setup):
    cfg, params = setup

    def gen(temperature):
        engine = _engine(cfg, params, num_slots=1, rng_seed=123)
        _drive(engine, Request, cfg.vocab_size, [(0, 5, 12)],
               temperature=temperature)
        return engine.finished[0].generated

    cold, hot = gen(0.25), gen(4.0)
    assert len(cold) == len(hot) == 12
    assert cold != hot


def test_greedy_requests_keep_the_stream_in_step(setup):
    """A greedy admission draws from the generator all the same, so a
    sampled request's tokens do not depend on the greedy requests admitted
    before it in the same slot order."""
    cfg, params = setup

    def sampled(first_temperature):
        engine = _engine(cfg, params, num_slots=2, rng_seed=5)
        engine.submit(Request(0, _prompt(0, 5, cfg.vocab_size), 4,
                              temperature=first_temperature))
        engine.submit(Request(1, _prompt(1, 7, cfg.vocab_size), 6,
                              temperature=0.7))
        return engine.run()[1].generated

    assert sampled(0.0) == sampled(1.3)


# ---------------------------------------------------------------------------
# 3. finish reasons, the ladder, refusals
# ---------------------------------------------------------------------------
def test_max_new_tokens_one_yields_exactly_one_token(setup):
    cfg, params = setup
    obs = _fake_obs()
    engine = _engine(cfg, params, obs=obs)
    done = _drive(engine, Request, cfg.vocab_size,
                  [(i, 5, 1) for i in range(3)])
    assert all(len(done[i].generated) == 1 for i in range(3))
    names = [r["name"] for r in obs.tracer.records if r["type"] != "meta"]
    assert "decode/step" not in names
    finishes = obs.tracer.events("request/finish")
    assert [e["attrs"]["reason"] for e in finishes] == \
        ["max_new_tokens"] * 3
    obs.close()


def test_eos_first_token_finishes_without_decode(setup):
    cfg, params = setup
    prompt = _prompt(11, 5, cfg.vocab_size)
    probe = _engine(cfg, params, num_slots=1)
    probe.submit(Request(request_id=0, prompt=prompt, max_new_tokens=1))
    first = probe.run()[0].generated[0]
    obs = _fake_obs()
    engine = _engine(cfg, params, num_slots=1, obs=obs)
    engine.submit(Request(request_id=0, prompt=prompt, max_new_tokens=8,
                          eos_token=int(first)))
    assert engine.run()[0].generated == [first]
    names = [r["name"] for r in obs.tracer.records if r["type"] != "meta"]
    assert "decode/step" not in names
    assert [e["attrs"]["reason"] for e in
            obs.tracer.events("request/finish")] == ["eos"]
    obs.close()


def test_cache_exhaustion_reports_cache_full(setup):
    cfg, params = setup
    obs = _fake_obs()
    engine = _engine(cfg, params, num_slots=1, max_len=16, obs=obs)
    done = _drive(engine, Request, cfg.vocab_size, [(0, 10, 32)])
    # positions 10..14 decode (15 is the scratch position): one prefill
    # token and 5 decode tokens
    assert len(done[0].generated) == 6
    assert [e["attrs"]["reason"] for e in
            obs.tracer.events("request/finish")] == ["cache_full"]
    obs.close()


def test_run_warns_and_counts_on_max_iters_truncation(setup):
    cfg, params = setup
    obs = _fake_obs()
    engine = _engine(cfg, params, num_slots=1, obs=obs)
    for i in range(3):
        engine.submit(Request(i, _prompt(i, 5, cfg.vocab_size), 8))
    with pytest.warns(RuntimeWarning, match="max_iters=2.*truncated"):
        done = engine.run(max_iters=2)
    assert len(done) == 0
    assert obs.metrics.snapshot()["counters"]["serve/truncated"] == 3.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        done = engine.run()
    assert len(done) == 3
    obs.close()


def test_engine_rejects_encoder():
    cfg = get_config("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, {}, num_slots=1, max_len=16, device="cpu")


def test_engine_accepts_custom_bucket_ladder(setup):
    cfg, params = setup
    engine = _engine(cfg, params, num_slots=1, max_len=24,
                     buckets=(8, 16, 64))
    assert engine.executor.buckets == (8, 16, 24)
    assert [engine.executor.bucket_for(n) for n in (5, 9, 17)] == \
        [8, 16, 24]
    with pytest.raises(ValueError, match="exceeds the largest"):
        engine.executor.bucket_for(25)
    prompt = _prompt(5, 6, cfg.vocab_size)
    engine.submit(Request(request_id=0, prompt=prompt, max_new_tokens=4))
    default = _engine(cfg, params, num_slots=1, max_len=24)
    default.submit(Request(request_id=0, prompt=prompt, max_new_tokens=4))
    assert engine.run()[0].generated == default.run()[0].generated


def test_bucket_ladder_validation(setup):
    cfg, params = setup
    for bad in [(), (0, 32), (-4, 8), (32, 16), (16, 16)]:
        with pytest.raises(ValueError, match="buckets"):
            _engine(cfg, params, num_slots=1, buckets=bad)
    engine = _engine(cfg, params, num_slots=1)
    assert engine.executor.buckets == (32, 64)


def test_bucket_raises_clear_valueerror_on_oversized_prompt():
    assert _bucket(2048) == 2048
    with pytest.raises(ValueError, match="2048"):
        _bucket(2049)


def test_submit_rejects_prompt_at_or_beyond_max_len(setup):
    cfg, params = setup
    engine = _engine(cfg, params, num_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len 16"):
        engine.submit(Request(request_id=0, prompt=np.zeros(16, np.int64)))
    engine.submit(Request(request_id=1, prompt=np.zeros(15, np.int64),
                          max_new_tokens=1))


# ---------------------------------------------------------------------------
# 4. observability
# ---------------------------------------------------------------------------
def _two_requests(engine, make_request, vocab):
    rng = np.random.default_rng(0)
    for i in range(2):
        engine.submit(make_request(request_id=i,
                                   prompt=rng.integers(0, vocab, size=5),
                                   max_new_tokens=2))
    return engine.run()


def test_lifecycle_trace_equals_the_reference_engines():
    """One slot, two requests of two tokens on a FakeClock: every record's
    name, type and attributes, in order, equal the reference engine's
    (submit x2, then admit -> prefill -> finish -> decode/step a request:
    a span is recorded when it closes), as do the timestamps and spans'
    durations; the histograms hold the fake clock's exact values."""
    jcfg, jp, tcfg, tp = _models("rm")
    obs_p, obs_r = _fake_obs(), _fake_obs(port=False)
    done = _two_requests(_engine(tcfg, tp, num_slots=1, obs=obs_p),
                         Request, tcfg.vocab_size)
    _two_requests(JEngine(jcfg, jp, num_slots=1, max_len=MAX_LEN,
                          obs=obs_r), JRequest, jcfg.vocab_size)

    def body(obs):
        return [{k: v for k, v in r.items() if k != "wall_time"}
                for r in obs.tracer.records if r["type"] != "meta"]

    assert body(obs_p) == body(obs_r)
    assert [r["name"] for r in body(obs_p)] == [
        "request/submit", "request/submit",
        "request/admit", "prefill", "request/finish", "decode/step",
        "request/admit", "prefill", "request/finish", "decode/step"]
    ttft = obs_p.metrics.histogram("serve/ttft_s")
    assert sorted(ttft._vals) == sorted(s.t_first_token - s.t_enqueue
                                        for s in done.values())
    tps = obs_p.metrics.histogram("serve/tokens_per_s")
    assert sorted(tps._vals) == sorted(2.0 / (s.t_done - s.t_enqueue)
                                       for s in done.values())
    snap = obs_p.metrics.snapshot(provenance=PROV)
    snap_r = obs_r.metrics.snapshot(provenance=PROV)
    assert {k: v for k, v in snap.items() if k != "wall_time"} == \
        {k: v for k, v in snap_r.items() if k != "wall_time"}
    assert snap["counters"]["serve/requests_submitted"] == 2.0
    assert snap["counters"]["serve/tokens_generated"] == 2.0
    assert snap["gauges"]["serve/slots_occupied"] == 0.0
    obs_p.close()
    obs_r.close()


def test_obs_disabled_is_bit_identical(setup):
    cfg, params = setup
    off = _two_requests(_engine(cfg, params, num_slots=1), Request,
                        cfg.vocab_size)
    obs = Obs(clock=clock.FakeClock(), provenance=PROV,
              install_kernel_tracing=True)
    on = _two_requests(_engine(cfg, params, num_slots=1, obs=obs), Request,
                       cfg.vocab_size)
    obs.close()
    assert {i: s.generated for i, s in off.items()} == \
        {i: s.generated for i, s in on.items()}


# ---------------------------------------------------------------------------
# 5. the launcher's frontend
# ---------------------------------------------------------------------------
def test_make_engine_bucketed_and_its_refusals():
    eng = make_engine("qwen3-1.7b", smoke=True, attention_mode="rm",
                      estimator="tensor_sketch", num_slots=1, max_len=32,
                      device="cpu", scheduler="bucketed", buckets=(8, 16))
    assert isinstance(eng, ServingEngine)
    assert eng.estimator == "tensor_sketch" and eng.fused_attention is False
    assert eng.executor.buckets == (8, 16, 32)
    eng.submit(Request(0, _prompt(0, 5, eng.cfg.vocab_size), 3))
    assert len(eng.run()[0].generated) == 3
    with pytest.raises(ValueError, match="unknown scheduler 'fifo'"):
        make_engine("qwen3-1.7b", device="cpu", scheduler="fifo")
    with pytest.raises(ValueError, match="accuracy tiers need the "
                       "continuous scheduler"):
        make_engine("qwen3-1.7b", device="cpu", scheduler="bucketed",
                    accuracy_tiers={"low": 1})
    with pytest.raises(KeyError, match="no_such_estimator"):
        make_engine("qwen3-1.7b", smoke=True, attention_mode="rm",
                    estimator="no_such_estimator", num_slots=1,
                    max_len=32, device="cpu", scheduler="bucketed")


def test_serve_launcher_scheduler_flag(capsys):
    from repro_torch.launch.serve import main

    main(["--smoke", "--device", "cpu", "--scheduler", "bucketed",
          "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests, 6 tokens" in out
    assert "bucketed engine" in out
