"""The port's continuous-batching Scheduler: greedy outputs token-identical
to the reference Scheduler on a small workload (mixed prompt lengths, more
requests than slots, one eviction), and — inside the port — sampled outputs
equal to a one-request-at-a-time run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import make_engine
from repro_torch.models.transformer import init_model
from repro_torch.serve import Request, Scheduler, effective_buckets
from repro_torch.serve.scheduler import sampling_seed

MAX_LEN = 64

# (request_id, prompt_len, max_new_tokens, priority): prompts in both
# buckets (32 and 64), all right-padded to their bucket
WORKLOAD = [(0, 5, 6, 0), (1, 33, 4, 0), (2, 17, 7, 1), (3, 40, 5, 0),
            (4, 9, 6, 2)]


def _prompt(rid, n, vocab):
    return np.random.default_rng((7, rid)).integers(0, vocab, size=n)


def _fp32_models():
    """fp32 compute on both sides: the frameworks then agree to ~1e-6 on
    logits, far below the gaps greedy decoding turns on."""
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    jcfg = dataclasses.replace(
        jcfg, compute_dtype="float32",
        rm=dataclasses.replace(jcfg.rm, fuse_featurize="on"))
    tcfg = dataclasses.replace(
        get_config("qwen3-1.7b", smoke=True, attention_mode="rm"),
        compute_dtype="float32")
    jp = jt.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _drive(sched, make_request, vocab, evict_at=2):
    for rid, n, new, prio in WORKLOAD:
        sched.submit(make_request(request_id=rid, prompt=_prompt(rid, n,
                                                                 vocab),
                                  max_new_tokens=new, priority=prio))
    steps, evicted = 0, None
    while sched.pending():
        sched.step()
        steps += 1
        if steps == evict_at:
            slot = next(i for i, s in enumerate(sched.slots) if s is not None)
            evicted = sched.evict(slot).request_id
    return sched.finished, evicted


def test_greedy_tokens_identical_to_reference_scheduler():
    jcfg, jp, tcfg, tp = _fp32_models()
    jdone, jev = _drive(JScheduler(jcfg, jp, num_slots=2, max_len=MAX_LEN),
                        JRequest, jcfg.vocab_size)
    tdone, tev = _drive(Scheduler(tcfg, tp, num_slots=2, max_len=MAX_LEN,
                                  device="cpu"),
                        Request, tcfg.vocab_size)
    assert jev == tev is not None
    assert sorted(jdone) == sorted(tdone) == [r[0] for r in WORKLOAD]
    for rid in jdone:
        assert tdone[rid].generated == jdone[rid].generated, rid
        assert tdone[rid].finish_reason == jdone[rid].finish_reason
    assert tdone[tev].admissions == 2


def test_sampled_outputs_equal_one_request_at_a_time():
    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    params = init_model(cfg, torch.Generator().manual_seed(1))
    batched = Scheduler(cfg, params, num_slots=3, max_len=MAX_LEN,
                        rng_seed=11, device="cpu")
    specs = [(rid, n, new, prio, temp) for (rid, n, new, prio), temp in
             zip(WORKLOAD, (0.8, 0.0, 1.3, 0.8, 0.5))]
    for rid, n, new, prio, temp in specs:
        batched.submit(Request(rid, _prompt(rid, n, cfg.vocab_size), new,
                               temperature=temp, priority=prio))
    done = batched.run()
    for rid, n, new, prio, temp in specs:
        alone = Scheduler(cfg, params, num_slots=1, max_len=MAX_LEN,
                          rng_seed=11, device="cpu")
        alone.submit(Request(rid, _prompt(rid, n, cfg.vocab_size), new,
                             temperature=temp))
        assert alone.run()[rid].generated == done[rid].generated, rid


def test_finish_reasons_and_admission_finish():
    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    params = init_model(cfg, torch.Generator().manual_seed(2))
    sched = Scheduler(cfg, params, num_slots=2, max_len=16, device="cpu")
    probe = Scheduler(cfg, params, num_slots=1, max_len=16, device="cpu")
    probe.submit(Request(0, _prompt(0, 4, cfg.vocab_size), 1))
    first = probe.run()[0].generated[0]
    sched.submit(Request(0, _prompt(0, 4, cfg.vocab_size), 9,
                         eos_token=first))                  # eos at admit
    sched.submit(Request(1, _prompt(1, 4, cfg.vocab_size), 1))
    sched.submit(Request(2, _prompt(2, 12, cfg.vocab_size), 50))
    sched.submit(Request(3, _prompt(3, 3, cfg.vocab_size), 3))
    info = sched.step()
    # requests 0 and 1 finish at admission and hand their lane back; the
    # tick's admission budget (its free lanes at the start) is spent, so
    # requests 2 and 3 wait for the next tick, as in the reference
    assert info.admitted == info.finished == [0, 1] and info.active == 0
    assert sched.step().admitted == [2, 3]
    done = sched.run()
    assert done[0].finish_reason == "eos"
    assert done[1].finish_reason == "max_new_tokens"
    assert done[2].finish_reason == "cache_full"
    assert len(done[2].generated) == 16 - 1 - 12 + 1
    assert done[3].finish_reason == "max_new_tokens"
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(Request(3, _prompt(3, 3, cfg.vocab_size), 3))
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(9, _prompt(9, 16, cfg.vocab_size), 3))


def test_priority_then_fifo_admission_order():
    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    params = init_model(cfg, torch.Generator().manual_seed(3))
    sched = Scheduler(cfg, params, num_slots=1, max_len=32, device="cpu")
    for rid, prio in [(0, 0), (1, 2), (2, 0), (3, 2), (4, 1)]:
        sched.submit(Request(rid, _prompt(rid, 3, cfg.vocab_size), 1,
                             priority=prio))
    order = []
    while sched.pending():
        order.extend(sched.step().admitted)
    assert order == [1, 3, 4, 0, 2]


def test_sampler_greedy_temperature_top_k():
    from repro_torch.serve import sample_token

    logits = torch.tensor([[0.0, 3.0, 1.0, 2.9], [5.0, -1.0, 0.0, 4.0]])
    assert sample_token(logits).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    # top_k=1 leaves only the argmax to draw
    assert sample_token(logits, gen, 0.7, top_k=1).tolist() == [1, 0]
    draws = torch.stack([sample_token(logits, gen, 1.0, top_k=2)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) == {1, 3}
    assert set(draws[:, 1].tolist()) == {0, 3}


def test_buckets_and_sampling_seed():
    assert effective_buckets((32, 64, 128), 100) == (32, 64, 100)
    for bad in ((), (0, 8), (8, 8)):
        with pytest.raises(ValueError):
            effective_buckets(bad, 64)
    seeds = {sampling_seed(0, r, t) for r in range(20) for t in range(20)}
    assert len(seeds) == 400 and all(0 <= s < 2**63 for s in seeds)
    assert sampling_seed(1, 2, 3) == sampling_seed(1, 2, 3)


def test_make_engine_on_cpu_serves():
    sched = make_engine("qwen3-1.7b", smoke=True, num_slots=2, max_len=32,
                        device="cpu")
    sched.submit(Request(0, _prompt(0, 5, sched.cfg.vocab_size), 3))
    state = sched.run()[0]
    assert len(state.generated) == 3 and state.finish_reason == \
        "max_new_tokens"


def _two_launch_fp32_models(kind):
    est = "rm" if kind == "rm_off" else kind
    fuse = "off" if kind == "rm_off" else "auto"
    cfgs = []
    for get in (jax_get_config, get_config):
        cfg = get("qwen3-1.7b", smoke=True, attention_mode="rm",
                  estimator=est)
        cfgs.append(dataclasses.replace(
            cfg, compute_dtype="float32",
            rm=dataclasses.replace(cfg.rm, fuse_featurize=fuse)))
    jcfg, tcfg = cfgs
    jp = jt.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("kind", ["tensor_sketch", "rm_off", "ctr",
                                  "structured"])
def test_two_launch_greedy_tokens_identical_to_reference_scheduler(kind):
    """The two-launch path (featurize launches, kernel B5's plain version,
    the plain decode update) through both Schedulers: the same tokens and
    finish reasons, eviction included."""
    jcfg, jp, tcfg, tp = _two_launch_fp32_models(kind)
    jsched = JScheduler(jcfg, jp, num_slots=2, max_len=MAX_LEN)
    tsched = Scheduler(tcfg, tp, num_slots=2, max_len=MAX_LEN, device="cpu")
    assert tsched.estimator == jsched.estimator
    assert tsched.fused_attention is jsched.fused_attention is False
    jdone, jev = _drive(jsched, JRequest, jcfg.vocab_size)
    tdone, tev = _drive(tsched, Request, tcfg.vocab_size)
    assert jev == tev is not None
    assert sorted(tdone) == sorted(jdone) == [r[0] for r in WORKLOAD]
    for rid in jdone:
        assert tdone[rid].generated == jdone[rid].generated, rid
        assert tdone[rid].finish_reason == jdone[rid].finish_reason


def test_launch_serve_forwards_estimator():
    """As the reference's regression test: ``make_engine`` must thread
    ``estimator=`` into ``get_config``, which validates the name; each of
    the three two-launch families serves."""
    for name in ("tensor_sketch", "ctr", "structured"):
        eng = make_engine("qwen3-1.7b", smoke=True, attention_mode="rm",
                          estimator=name, num_slots=1, max_len=32,
                          device="cpu")
        assert eng.estimator == name
        assert eng.cfg.rm.estimator == name
        assert eng.fused_attention is False
        eng.submit(Request(0, _prompt(0, 5, eng.cfg.vocab_size), 2))
        assert len(eng.run()[0].generated) == 2
    assert make_engine("qwen3-1.7b", smoke=True, num_slots=1, max_len=32,
                       device="cpu").estimator == "rm"
    with pytest.raises(KeyError, match="no_such_estimator"):
        make_engine("qwen3-1.7b", smoke=True, attention_mode="rm",
                    estimator="no_such_estimator", num_slots=1, max_len=32,
                    device="cpu")


def test_get_config_validates_estimator():
    for name in ("rm", "tensor_sketch", "ctr", "structured"):
        cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                         estimator=name)
        assert cfg.rm.estimator == name
    with pytest.raises(KeyError, match="available"):
        get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                   estimator="no_such_estimator")
    with pytest.raises(ValueError, match="attention_mode"):
        get_config("qwen3-1.7b", smoke=True, estimator="tensor_sketch")
