"""Gradients of the port against the reference's ``jax.grad`` on the CPU.

The three differentiable RM attention ops of the port
(``rm_attention_fused_causal``: kernel B2; ``rm_attention_fused_noncausal``:
B3 + B4; ``rm_attention_causal``: B5) are ``torch.autograd.Function``s whose
backward differentiates the port of the reference's XLA formulation. Each
op's cotangents for q, k, v (and kvalid, w where asked) are held against
``jax.vjp`` of the reference's public op with ``use_pallas=False``, the
same jnp formulation its custom VJP differentiates, within 1e-5 x max(1,
max |g|): fp32 sums of at most T x F products in another order.

``loss_fn`` of the qwen3 and hubert SMOKE models (rm, fp32 compute, fused
featurize), with the reference's weights handed over by
``convert.params_from_jax``, is held against ``jax.grad`` of the
reference's ``loss_fn`` for every trainable leaf within 1e-4 x max(1, max
|g|): the logits' budget (1e-4 relative) carried through a backward of the
same depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rm_attention import ops as jops
from repro.models import transformer as jt
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro_torch.common.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rm_attention import ops as tops
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import is_frozen
from repro_torch.train.steps import (
    TrainHyper,
    init_train_state,
    loss_grads,
    make_train_step,
)

OP_TOL = 1e-5      # x max(1, max |g|)
MODEL_TOL = 1e-4   # x max(1, max |g|), per trainable leaf


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())


def _plan_operands(b, h, t, dv, seed, pad=0):
    """The qwen3 SMOKE head's plan (d 16), +-1 omegas, pre-scaled unit
    q/k rows, values, and kvalid with ``pad`` padded keys on batch row 1."""
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    plan = jax_rm_plan_for(jcfg, jcfg.resolved_head_dim)
    d = jcfg.resolved_head_dim
    deg = np.asarray(plan.column_degrees(), np.int32)
    scale = np.asarray(plan.column_scales(), np.float32)
    rng = np.random.default_rng(seed)
    w = rng.choice([-1.0, 1.0], size=(int(deg.max()), len(deg), d))
    q, k = (rng.standard_normal((b, h, t, d)) for _ in range(2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, h, t, dv))
    kvalid = np.ones((b, t))
    if pad:
        kvalid[1, t - pad:] = 0.0
    cot = rng.standard_normal((b, h, t, dv))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(a) for a in (q, k, v, kvalid, w)], deg, scale, f32(cot)


def _torch_vjp(fn, arrays, cot, wrt):
    ts = [torch.tensor(a).requires_grad_(i in wrt)
          for i, a in enumerate(arrays)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt],
                                torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_vjp(fn, arrays, cot, wrt):
    """The reference's output and cotangents, under one ``jax.jit`` (op by
    op the reference's first call compiles every primitive apart)."""
    def f(sel, rest, c):
        args = list(rest)
        for i, s in zip(wrt, sel):
            args[i] = s
        out, vjp = jax.vjp(lambda *x: fn(*(
            x[wrt.index(i)] if i in wrt else a
            for i, a in enumerate(args))), *sel)
        return out, vjp(c)

    out, grads = jax.jit(f)(tuple(jnp.asarray(arrays[i]) for i in wrt),
                            tuple(map(jnp.asarray, arrays)), jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("t,pad,chunk,wrt", [
    (37, 5, 16, (0, 1, 2)),        # T padded to the chunk, padded keys
    (24, 0, 128, (0, 1, 2)),       # one chunk (chunk = min(chunk, T))
    (40, 9, 8, (0, 1, 2, 3, 4)),   # kvalid and w cotangents too
])
def test_fused_causal_grads_match_reference(t, pad, chunk, wrt):
    arrays, deg, scale, cot = _plan_operands(2, 2, t, 8, seed=t, pad=pad)
    got_out, got = _torch_vjp(
        lambda q, k, v, kv, w: tops.rm_attention_fused_causal(
            q, k, v, w, deg, scale, kvalid=kv, chunk=chunk),
        arrays, cot, wrt)
    want_out, want = _jax_vjp(
        lambda q, k, v, kv, w: jops.rm_attention_fused_causal(
            q, k, v, w, deg, scale, kvalid=kv, chunk=chunk,
            use_pallas=False),
        arrays, cot, wrt)
    assert _rel(got_out, want_out) <= OP_TOL
    for i, g, gw in zip(wrt, got, want):
        assert g.shape == arrays[i].shape
        assert _rel(g, gw) <= OP_TOL, ("qkv kvalid w".split()[i], _rel(g, gw))


@pytest.mark.parametrize("t,pad,wrt", [(23, 4, (0, 1, 2)),
                                       (40, 0, (0, 1, 2, 3, 4))])
def test_fused_noncausal_grads_match_reference(t, pad, wrt):
    arrays, deg, scale, cot = _plan_operands(2, 3, t, 8, seed=t, pad=pad)
    got_out, got = _torch_vjp(
        lambda q, k, v, kv, w: tops.rm_attention_fused_noncausal(
            q, k, v, w, deg, scale, kvalid=kv),
        arrays, cot, wrt)
    want_out, want = _jax_vjp(
        lambda q, k, v, kv, w: jops.rm_attention_fused_noncausal(
            q, k, v, w, deg, scale, kvalid=kv, use_pallas=False),
        arrays, cot, wrt)
    assert _rel(got_out, want_out) <= OP_TOL
    for i, g, gw in zip(wrt, got, want):
        assert _rel(g, gw) <= OP_TOL, ("qkv kvalid w".split()[i], _rel(g, gw))


@pytest.mark.parametrize("t,chunk", [(37, 8), (16, 128)])
def test_two_launch_causal_grads_match_reference(t, chunk):
    """B5's op over given features (the plan's features of the rows)."""
    (q, k, v, kvalid, w), deg, scale, cot = _plan_operands(2, 2, t, 8,
                                                           seed=3, pad=4)
    z = lambda x: np.asarray(jops._featurize_ref4(  # noqa: E731
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(deg),
        jnp.asarray(scale)))
    zq, zk = z(q), z(k) * kvalid[:, None, :, None]
    arrays = [zq, zk, v]
    got_out, got = _torch_vjp(
        lambda a, b, c: tops.rm_attention_causal(a, b, c, chunk=chunk),
        arrays, cot, (0, 1, 2))
    want_out, want = _jax_vjp(
        lambda a, b, c: jops.rm_attention_causal(a, b, c, chunk=chunk,
                                                 use_pallas=False),
        arrays, cot, (0, 1, 2))
    assert _rel(got_out, want_out) <= OP_TOL
    for g, gw in zip(got, want):
        assert _rel(g, gw) <= OP_TOL


def test_functions_forward_is_the_forward_only_wrappers():
    """The Function's forward is the wrapper's own output, bitwise, with or
    without autograd recording; bf16 inputs get bf16 cotangents."""
    (q, k, v, kvalid, w), deg, scale, cot = _plan_operands(2, 2, 30, 8,
                                                           seed=5, pad=3)
    q, k, v, kv, w = map(torch.from_numpy, (q, k, v, kvalid, w))
    with torch.no_grad():
        plain, _, _ = tops.rm_fused_causal(q, k, v, kv, w, deg, scale, 1e-4)
    qg = q.clone().requires_grad_()
    out = tops.rm_attention_fused_causal(qg, k, v, w, deg, scale, kvalid=kv)
    assert torch.equal(out.detach(), plain)
    qb, kb, vb = (x.bfloat16().requires_grad_() for x in (q, k, v))
    out = tops.rm_attention_fused_noncausal(qb, kb, vb, w.bfloat16(), deg,
                                            scale, kvalid=kv)
    out.backward(torch.from_numpy(cot))
    assert out.dtype == torch.float32
    assert qb.grad.dtype == kb.grad.dtype == vb.grad.dtype == torch.bfloat16


def test_serving_only_ops_keep_refusing_autograd():
    (q, k, v, kvalid, w), deg, scale, _ = _plan_operands(1, 1, 8, 4, seed=1)
    q = torch.from_numpy(q).requires_grad_()
    k, v, w = map(torch.from_numpy, (k, v, w))
    with pytest.raises(NotImplementedError, match="backward"):
        tops.rm_attention_fused_prefill(q, k, v, w, deg, scale)
    with pytest.raises(NotImplementedError, match="backward"):
        tops.rm_fused_causal(q, k, v, None, w, deg, scale, 1e-4)


# ---------------------------------------------------------------------------
# loss_fn gradients of the SMOKE models
# ---------------------------------------------------------------------------
def _configs(arch, compute_dtype="float32"):
    jcfg = jax_get_config(arch, smoke=True, attention_mode="rm")
    jcfg = dataclasses.replace(
        jcfg, compute_dtype=compute_dtype,
        rm=dataclasses.replace(jcfg.rm, fuse_featurize="on"))
    tcfg = get_config(arch, smoke=True, attention_mode="rm")
    tcfg = dataclasses.replace(
        tcfg, compute_dtype=compute_dtype,
        rm=dataclasses.replace(tcfg.rm, fuse_featurize="on"))
    return jcfg, tcfg


def _batches(jcfg, seed):
    rng = np.random.default_rng(seed)
    if jcfg.frontend == "audio_stub":
        x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
        tg = rng.integers(0, jcfg.vocab_size, size=(2, 40))
        tg[1, -5:] = -1                      # ignored frames
        return ({"embeds": jnp.asarray(x), "targets": jnp.asarray(tg)},
                {"embeds": torch.from_numpy(x),
                 "targets": torch.from_numpy(tg)})
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 33))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "targets": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])})


def _trainable_grads(tcfg, params, batch):
    """``({path: grad}, loss)`` of loss_fn for every trainable float leaf
    (``train.steps.loss_grads``, flattened)."""
    grads, metrics = loss_grads(tcfg, params, batch)
    flat = flatten_dict(grads)
    return ({k: g for k, g in flat.items()
             if not is_frozen(tuple(k.split("/")))
             and g.is_floating_point()}, metrics["loss"], metrics)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge"])
def test_loss_fn_grads_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jp = jt.init_model(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    jb, tb = _batches(jcfg, seed=7)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    want = flatten_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg))
    got, loss, _ = _trainable_grads(tcfg, tp, tb)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    # every float leaf but the frozen estimator draws is trained
    assert set(got) == {k for k in want if "rm_est" not in k}
    assert any(k.endswith("/rm_scale") for k in got)
    for key, g in got.items():
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), want[key]) <= MODEL_TOL, (key, _rel(
            g.numpy(), want[key]))
    # the learnable RM scale gets a gradient through its softplus
    assert all(float(g.abs()) > 0 for k, g in got.items()
               if k.endswith("/rm_scale"))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge"])
def test_bf16_compute_grads_reach_fp32_masters(arch):
    """bf16 compute copies (``cast_params_to_compute``) pass gradients back
    to the fp32 masters, which hold no derived kernel key."""
    _, tcfg = _configs(arch, "bfloat16")
    jcfg, _ = _configs(arch)
    _, tb = _batches(jcfg, seed=2)
    state = init_train_state(tcfg, seed=0, device="cpu")
    got, loss, _ = _trainable_grads(tcfg, state["params"], tb)
    assert torch.isfinite(loss)
    for key, g in got.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), key
    keys = set(flatten_dict(state))
    assert not any("rm_w" in k or "rm_slab" in k for k in keys)


def test_train_step_refuses_the_compute_copy():
    """The derived kernel keys (``rm_w``, ``rm_slab``) never enter a train
    state: a step on a compute copy's params is refused."""
    _, tcfg = _configs("qwen3-1.7b")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(tcfg, seed=0, hyper=hyper, device="cpu")
    bad = dict(state, params=tt.cast_params_to_compute(state["params"],
                                                       tcfg))
    _, tb = _batches(_configs("qwen3-1.7b")[0], seed=1)
    with pytest.raises(ValueError, match="rm_w"):
        make_train_step(tcfg, hyper)(bad, tb)
    state, metrics = make_train_step(tcfg, hyper)(state, tb)
    assert not any("rm_w" in k for k in flatten_dict(state))
    assert torch.isfinite(metrics["loss"])


def test_train_step_after_inference_mode(monkeypatch):
    """An eval (under ``torch.inference_mode``) first in a process, then
    gradients: the plan columns the eval cached are not inference tensors,
    so the attention Functions can save them for their backward."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.train.steps import make_eval_step

    monkeypatch.setattr(plan_mod, "_COLUMNS_CACHE", {})
    for arch in ("qwen3-1.7b", "hubert-xlarge"):
        jcfg, tcfg = _configs(arch)
        _, tb = _batches(jcfg, seed=4)
        params = init_train_state(tcfg, seed=0, device="cpu")["params"]
        metrics = make_eval_step(tcfg)(params, tb)
        got, loss, _ = _trainable_grads(tcfg, params, tb)
        assert float(loss) == float(metrics["loss"])
        assert all(torch.isfinite(g).all() for g in got.values())
