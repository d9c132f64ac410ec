"""The port's exact softmax attention (``attention_mode="exact"``, plain
PyTorch) against the reference's plain jnp on the CPU, in fp32:

* the small (one einsum) and blockwise (online-softmax loop over 1024-wide
  blocks above 2048 positions) forwards on the same q/k/v and positions —
  causal, non-causal, a sliding window, padded keys at negative
  positions — within 1e-4 relative;
* the qwen3 SMOKE model's prefill and decode logits through the
  ring-buffer KV cache past its wrap (a full cache, a sliding window
  shorter than the prompt, a bucket-padded prompt), within 1e-4 relative;
* qwen3 SMOKE greedy tokens through both Schedulers, identical;
* hubert SMOKE (non-causal, encode only) logits;
* ``loss_fn`` gradients against ``jax.grad`` within 1e-4 x max(1,
  max |g|) per leaf (the exact layers hold no ``rm_est`` / ``rm_scale``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as ja
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.common.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serve import Request, Scheduler
from repro_torch.train.steps import loss_grads
from test_torch_serve import _drive

TOL = 1e-4


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        1e-30, np.abs(want).max())


def _grad_rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------
def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _positions(b, t, pad):
    """[B, T] int32: 0..T-1, with the last ``pad`` positions of row 1 at
    -1 (bucket padding)."""
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    if pad:
        pos[1, t - pad:] = -1
    return pos


CASES = [  # causal, sliding_window, pad
    (True, 0, 0), (False, 0, 0), (True, 0, 5), (False, 0, 5),
    (True, 7, 0), (True, 700, 3)]


@pytest.mark.parametrize("causal,window,pad", CASES)
@pytest.mark.parametrize("path,t", [("small", 37), ("blockwise", 2500)])
def test_softmax_attention_matches_reference(path, t, causal, window, pad):
    """The few-head, narrow-d blockwise case pads T 2500 to three
    1024-wide blocks (the padded keys at the sentinel position)."""
    b, h, d = 2, (2 if path == "small" else 1), 8
    jcfg = JModelConfig(causal=causal, sliding_window=window)
    tcfg = TModelConfig(causal=causal, sliding_window=window)
    q, k, v = _qkv(b, t, h, d, seed=t + pad)
    pos = _positions(b, t, pad)
    jfn = getattr(ja, f"_softmax_attention_{path}")
    tfn = getattr(ta, f"_softmax_attention_{path}")
    want = jfn(jcfg, *map(jnp.asarray, (q, k, v, pos, pos)))
    got = tfn(tcfg, *map(torch.from_numpy, (q, k, v, pos, pos)))
    assert got.shape == want.shape == (b, t, h, d)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL
    if path == "blockwise":
        # the dispatcher takes this path above the threshold, and the
        # small path gives the same attention at every real query (a
        # padded query attends to no key: both formulations average over
        # what they hold, the blockwise one its block-padded keys too)
        assert t > ta._BLOCKWISE_THRESHOLD
        disp = ta._softmax_attention(tcfg, *map(torch.from_numpy,
                                               (q, k, v, pos, pos)))
        assert torch.equal(disp, got)
        small = ta._softmax_attention_small(
            tcfg, *map(torch.from_numpy, (q, k, v, pos, pos)))
        real = pos >= 0
        assert _rel(got.numpy()[real], small.numpy()[real]) <= TOL


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _models(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               compute_dtype="float32", **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32", **over)
    assert jcfg.attention_mode == tcfg.attention_mode == "exact"
    jp = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("window,max_len,prompt,pad,steps", [
    (0, 16, 12, 0, 9),       # full cache: decode wraps past slot 15
    (8, 32, 12, 0, 10),      # window 8 < prompt: the tail branch, wraps
    (0, 16, 12, 4, 8),       # a bucket-padded prompt (positions -1)
])
def test_prefill_and_decode_through_the_ring_buffer(window, max_len, prompt,
                                                    pad, steps):
    jcfg, jp, tcfg, tp = _models("qwen3-1.7b", seed=3,
                                 sliding_window=window)
    rng = np.random.default_rng(window + pad)
    toks = rng.integers(0, jcfg.vocab_size, (2, prompt + pad))
    pos = np.tile(np.arange(prompt + pad, dtype=np.int32), (2, 1))
    if pad:
        pos[:, prompt:] = -1
    jprefill = jax.jit(jt.prefill, static_argnums=(1, 3))
    jdecode = jax.jit(jt.decode_step, static_argnums=1)
    jl, jc = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32),
                                 "positions": jnp.asarray(pos)}, max_len)
    with torch.no_grad():
        tl, tc = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                       "positions": torch.from_numpy(pos)},
                            max_len)
        assert tc["layers"][0]["k"].shape[1] == (window or max_len)
        assert _rel(tl.numpy()[:, :prompt], np.asarray(jl)[:, :prompt]) \
            <= TOL
        for i in range(steps):
            nt = rng.integers(0, jcfg.vocab_size, (2, 1))
            p = np.full((2,), prompt + i, np.int32)
            jl, jc = jdecode(jp, jcfg, jc, jnp.asarray(nt, jnp.int32),
                             jnp.asarray(p))
            tl, tc = tt.decode_step(tp, tcfg, tc, torch.from_numpy(nt),
                                    torch.from_numpy(p))
            assert _rel(tl.numpy(), np.asarray(jl)) <= TOL, i
    assert prompt + steps > (window or max_len)       # it wrapped


def test_scheduler_greedy_tokens_identical_to_reference():
    jcfg, jp, tcfg, tp = _models("qwen3-1.7b", seed=0)
    jdone, jev = _drive(JScheduler(jcfg, jp, num_slots=2, max_len=64),
                        JRequest, jcfg.vocab_size)
    sched = Scheduler(tcfg, tp, num_slots=2, max_len=64, device="cpu")
    assert sched.estimator is None and sched.fused_attention is False
    tdone, tev = _drive(sched, Request, tcfg.vocab_size)
    assert jev == tev is not None
    assert sorted(jdone) == sorted(tdone)
    for rid in jdone:
        assert tdone[rid].generated == jdone[rid].generated, rid
        assert tdone[rid].finish_reason == jdone[rid].finish_reason


def test_hubert_exact_logits_match_reference():
    jcfg, jp, tcfg, tp = _models("hubert-xlarge", seed=2)
    assert not tcfg.causal
    emb = np.random.default_rng(2).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    want, _ = jt.forward(jp, jcfg, {"embeds": jnp.asarray(emb)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="encoder-only"):
        tt.init_decode_cache(tcfg, 1, 16, "cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge"])
def test_loss_fn_grads_match_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch, seed=1)
    rng = np.random.default_rng(7)
    if jcfg.frontend == "audio_stub":
        x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
        tg = rng.integers(0, jcfg.vocab_size, size=(2, 40))
        tg[1, -5:] = -1
        jb = {"embeds": jnp.asarray(x), "targets": jnp.asarray(tg)}
        tb = {"embeds": torch.from_numpy(x), "targets": torch.from_numpy(tg)}
    else:
        toks = rng.integers(0, jcfg.vocab_size, size=(2, 33))
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]),
              "targets": torch.from_numpy(toks[:, 1:])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    want = flatten_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg))
    grads, metrics = loss_grads(tcfg, tp, tb)
    got = flatten_dict(grads)
    assert abs(float(metrics["loss"]) - float(jloss)) <= \
        TOL * abs(float(jloss))
    assert set(got) == set(want)
    assert not any(leaf in k.split("/") for k in got
                   for leaf in ("rm_est", "rm_scale"))
    for key, g in got.items():
        assert g.dtype == torch.float32
        assert _grad_rel(g.numpy(), want[key]) <= TOL, key
