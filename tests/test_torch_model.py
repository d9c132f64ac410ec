"""The port's dense qwen3 path against the reference, at the SMOKE config
with attention_mode="rm" (fuse_featurize="on" on the reference side, so it
runs the fused jnp formulation) and the reference's weights carried across
by ``repro_torch.convert.params_from_jax``: forward logits, prefill logits
and decode state (S, n), and 8 greedy decode steps. The two-launch path
(estimators "tensor_sketch", "ctr" and "structured", and "rm" with
fuse_featurize="off") is held
the same way against the reference's two-launch path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt

# bf16 budget: activations round to 8 mantissa bits (relative 2^-8) at
# every layer in both frameworks, at different places; logits here are
# O(1), so 4 bf16 steps at |logit| ~ 2 bound the gap.
BF16_LOGIT_ATOL = 3e-2


def _configs(compute_dtype):
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    jcfg = dataclasses.replace(
        jcfg, compute_dtype=compute_dtype,
        rm=dataclasses.replace(jcfg.rm, fuse_featurize="on"))
    tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    tcfg = dataclasses.replace(tcfg, compute_dtype=compute_dtype)
    return jcfg, tcfg


def _models(compute_dtype, seed=0):
    jcfg, tcfg = _configs(compute_dtype)
    jp = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t))


def test_params_cross_with_layer_axis_unstacked():
    jcfg, jp, tcfg, tp = _models("float32")
    assert len(tp["layers"]) == tcfg.num_layers == 2
    wq = np.asarray(jp["groups"]["b0_attn_mlp"]["attn"]["wq"])
    om = np.asarray(jp["groups"]["b0_attn_mlp"]["attn"]["rm_est"]["omegas"])
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), wq[i])
        np.testing.assert_array_equal(
            layer["attn"]["rm_est"]["omegas"].numpy(), om[i])
        assert layer["attn"]["rm_scale"].shape == ()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_compute_params_pack_omegas_once(compute_dtype, precision):
    """Each layer's compute copy holds the reference's packed omegas in the
    RM precision policy's dtype (bit-exact: the omegas are +-1), and casting
    the compute copy again copies no tensor."""
    from repro.core.plan import pack_omegas as jax_pack_omegas
    from repro.models.attention import rm_plan_for as jax_rm_plan_for

    jcfg, jp, tcfg, tp = _models(compute_dtype)
    tcfg = dataclasses.replace(
        tcfg, rm=dataclasses.replace(tcfg.rm, precision=precision))
    want_dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    cp = tt.cast_params_to_compute(tp, tcfg)
    plan = jax_rm_plan_for(jcfg, jcfg.resolved_head_dim)
    om = np.asarray(jp["groups"]["b0_attn_mlp"]["attn"]["rm_est"]["omegas"])
    for i, layer in enumerate(cp["layers"]):
        w = layer["attn"]["rm_w"]
        assert w.dtype == want_dtype
        np.testing.assert_array_equal(
            w.float().numpy(), np.asarray(jax_pack_omegas(plan, om[i])))
        assert "rm_w" not in tp["layers"][i]["attn"]
    again = tt.cast_params_to_compute(cp, tcfg)
    for layer, layer2 in zip(cp["layers"], again["layers"]):
        for part in ("attn", "mlp", "norm1", "norm2"):
            for name, leaf in layer[part].items():
                if torch.is_tensor(leaf):
                    assert layer2[part][name] is leaf, (part, name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(compute_dtype):
    jcfg, jp, tcfg, tp = _models(compute_dtype)
    toks = _tokens(2, 20, jcfg.vocab_size, 1)
    want, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if compute_dtype == "float32":
        assert _rel(got.numpy(), want) <= 1e-4
    else:
        assert np.abs(got.numpy() - want).max() <= BF16_LOGIT_ATOL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_state_match_reference(compute_dtype):
    """Bucketed prefill: the second prompt is right-padded with sentinel
    position -1; its padded keys must not reach the state."""
    jcfg, jp, tcfg, tp = _models(compute_dtype, seed=1)
    toks = _tokens(2, 32, jcfg.vocab_size, 2)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    pos[1, 21:] = -1
    want, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                         "positions": jnp.asarray(pos)}, 64)
    with torch.no_grad():
        got, tcache = tt.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos)}, 64)
    jstate = jcache["groups"]["b0_attn_mlp"]
    tol = 1e-4 if compute_dtype == "float32" else None
    for i, layer in enumerate(tcache["layers"]):
        for name in ("rm_s", "rm_n"):
            ref = np.asarray(jstate[name][i])
            if tol:
                assert _rel(layer[name].numpy(), ref) <= tol, name
            else:   # the state sums ~21 bf16-rounded keys per feature
                assert _rel(layer[name].numpy(), ref) <= 5e-2, name
    if tol:
        assert _rel(got.numpy(), np.asarray(want)) <= tol
    else:
        assert np.abs(got.numpy() - np.asarray(want)).max() \
            <= BF16_LOGIT_ATOL


def _greedy_decode(prefill_fn, step_fn, toks, steps):
    logits, cache = prefill_fn(toks)
    t = toks.shape[1]
    tok = np.argmax(logits[:, -1], axis=-1)
    out, all_logits = [tok], []
    for i in range(steps - 1):
        logits, cache = step_fn(cache, tok[:, None],
                                np.full((toks.shape[0],), t + i, np.int32))
        all_logits.append(logits[:, 0])
        tok = np.argmax(logits[:, 0], axis=-1)
        out.append(tok)
    return np.stack(out, 1), np.stack(all_logits, 1)


def test_greedy_decode_matches_reference_fp32():
    """8 greedy tokens: identical tokens, logits within 1e-4 relative."""
    jcfg, jp, tcfg, tp = _models("float32", seed=2)
    toks = _tokens(2, 12, jcfg.vocab_size, 3).astype(np.int32)

    def jpre(x):
        lg, c = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(x)}, 64)
        return np.asarray(lg), c

    def jstep(c, tok, pos):
        lg, c = jt.decode_step(jp, jcfg, c, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos))
        return np.asarray(lg), c

    def tpre(x):
        lg, c = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(x)}, 64)
        return lg.numpy(), c

    def tstep(c, tok, pos):
        lg, c = tt.decode_step(tp, tcfg, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        return lg.numpy(), c

    with torch.no_grad():
        want_tok, want_lg = _greedy_decode(jpre, jstep, toks, 8)
        got_tok, got_lg = _greedy_decode(tpre, tstep, toks, 8)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert _rel(got_lg, want_lg) <= 1e-4


def test_decode_bf16_within_budget_teacher_forced():
    """bf16: feed both models the same tokens (near-ties may flip a greedy
    pick in one framework) and hold every step's logits to the budget."""
    jcfg, jp, tcfg, tp = _models("bfloat16", seed=3)
    toks = _tokens(2, 12, jcfg.vocab_size, 4).astype(np.int32)
    feed = _tokens(2, 8, jcfg.vocab_size, 5).astype(np.int32)
    _, jc = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64)
    with torch.no_grad():
        _, tc = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 64)
        for i in range(feed.shape[1]):
            pos = np.full((2,), 12 + i, np.int32)
            jl, jc = jt.decode_step(jp, jcfg, jc, jnp.asarray(feed[:, i:i+1]),
                                    jnp.asarray(pos))
            tl, tc = tt.decode_step(tp, tcfg, tc,
                                    torch.from_numpy(feed[:, i:i + 1]),
                                    torch.from_numpy(pos))
            assert np.abs(tl.numpy() - np.asarray(jl)).max() \
                <= BF16_LOGIT_ATOL


def test_unported_modes_raise_not_implemented():
    """``fuse_featurize="off"`` now runs the two-launch path and matches the
    reference (held in full by the two-launch tests below); an unknown
    fusion mode raises, and so does a block kind that is not ported yet.
    Exact attention is ported (tests/test_torch_exact_attention.py): its
    layers hold no estimator leaves."""
    from repro_torch.models.attention import rm_fuse_enabled

    jcfg, jp, tcfg, tp = _two_launch_models("rm_off", "float32", seed=4)
    assert rm_fuse_enabled(tcfg) is False
    toks = _tokens(1, 9, jcfg.vocab_size, 6)
    want, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4
    bad = dataclasses.replace(tcfg, rm=dataclasses.replace(
        tcfg.rm, fuse_featurize="sometimes"))
    with pytest.raises(ValueError):
        rm_fuse_enabled(bad)
    exact = get_config("qwen3-1.7b", smoke=True)
    assert exact.attention_mode == "exact"
    layer = tt.init_model(exact, torch.Generator().manual_seed(0))[
        "layers"][0]["attn"]
    assert "rm_est" not in layer and "rm_scale" not in layer
    moe = dataclasses.replace(exact, block_pattern=("attn_moe",))
    with pytest.raises(NotImplementedError, match="attn_moe"):
        tt.init_model(moe, torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# the two-launch path: featurize (B1 for rm, B6 for tensor_sketch, B7 for
# ctr, B8 for structured), then B5
# ---------------------------------------------------------------------------
TWO_LAUNCH = ["tensor_sketch", "rm_off", "ctr", "structured"]


def _two_launch_configs(kind, compute_dtype, precision="fp32"):
    """``kind``: "tensor_sketch", "ctr" or "structured" (families without
    the fused capability: both packages take the two-launch path on their
    own) or "rm_off" (the rm family with fuse_featurize="off" on both
    sides)."""
    est = "rm" if kind == "rm_off" else kind
    fuse = "off" if kind == "rm_off" else "auto"
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                          estimator=est)
    tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm",
                      estimator=est)
    out = []
    for cfg in (jcfg, tcfg):
        out.append(dataclasses.replace(
            cfg, compute_dtype=compute_dtype,
            rm=dataclasses.replace(cfg.rm, fuse_featurize=fuse,
                                   precision=precision)))
    return out


def _two_launch_models(kind, compute_dtype, seed=0, precision="fp32"):
    jcfg, tcfg = _two_launch_configs(kind, compute_dtype, precision)
    jp = jt.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def test_rm_fuse_enabled_follows_the_reference():
    from repro.models.attention import rm_fuse_enabled as jax_fuse
    from repro_torch.models.attention import rm_fuse_enabled

    for kind in TWO_LAUNCH:
        jcfg, tcfg = _two_launch_configs(kind, "float32")
        assert rm_fuse_enabled(tcfg) is jax_fuse(jcfg) is False, kind
    _, tcfg = _configs("float32")
    for mode in ("auto", "on"):
        assert rm_fuse_enabled(dataclasses.replace(
            tcfg, rm=dataclasses.replace(tcfg.rm, fuse_featurize=mode)))


def test_sketch_tables_cross_and_pack_once():
    """The hash tables cross as int32 / fp32 leaves; each layer's compute
    copy holds ``[wr, wi, mr, mi]`` packed from them within 1e-6 of the
    reference's ``pack_sketch``, in the RM precision dtype and never in the
    bf16 compute dtype; a second cast copies no tensor."""
    from repro.models.attention import rm_plan_for as jax_rm_plan_for
    from repro.sketch.plan import pack_sketch as jax_pack_sketch

    jcfg, jp, tcfg, tp = _two_launch_models("tensor_sketch", "bfloat16")
    est = jp["groups"]["b0_attn_mlp"]["attn"]["rm_est"]
    h, s = np.asarray(est["h"]), np.asarray(est["s"])
    plan = jax_rm_plan_for(jcfg, jcfg.resolved_head_dim)
    cp = tt.cast_params_to_compute(tp, tcfg)
    for i, layer in enumerate(tp["layers"]):
        assert layer["attn"]["rm_est"]["h"].dtype == torch.int32
        np.testing.assert_array_equal(layer["attn"]["rm_est"]["h"].numpy(),
                                      h[i])
        packed = cp["layers"][i]["attn"]["rm_w"]
        want = jax_pack_sketch(plan, {"h": h[i], "s": s[i]})
        for g, w in zip(packed, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
    again = tt.cast_params_to_compute(cp, tcfg)
    for layer, layer2 in zip(cp["layers"], again["layers"]):
        assert layer2["attn"]["rm_w"] is layer["attn"]["rm_w"]


@pytest.mark.parametrize("est,names", [("ctr", ("wr", "wi")),
                                       ("structured", ("d1", "d2"))])
def test_two_tensor_rows_cross_and_pack_once(est, names):
    """The ctr rows / structured signs cross unchanged (values {0, +-1},
    dtypes kept); each layer's compute copy holds the two-tensor list
    ``rm_w``, bit-exact against the reference's pack of the same rows, in
    the RM precision dtype (bf16 under ``rm.precision="bf16"``, lossless);
    a second cast copies no tensor."""
    from repro.ctr.plan import pack_ctr as jax_pack_ctr
    from repro.models.attention import rm_plan_for as jax_rm_plan_for
    from repro.structured.plan import pack_structured as jax_pack_structured

    jax_pack = jax_pack_ctr if est == "ctr" else jax_pack_structured
    for precision, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
        jcfg, jp, tcfg, tp = _two_launch_models(est, "bfloat16",
                                                precision=precision)
        rows = jp["groups"]["b0_attn_mlp"]["attn"]["rm_est"]
        plan = jax_rm_plan_for(jcfg, jcfg.resolved_head_dim)
        cp = tt.cast_params_to_compute(tp, tcfg)
        for i, layer in enumerate(tp["layers"]):
            for name in names:
                got = layer["attn"]["rm_est"][name]
                want = np.asarray(rows[name][i])
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
            packed = cp["layers"][i]["attn"]["rm_w"]
            assert isinstance(packed, list) and len(packed) == 2
            want = jax_pack(plan, {n: np.asarray(rows[n][i]) for n in names})
            for g, w in zip(packed, want):
                assert g.dtype == dtype
                np.testing.assert_array_equal(g.float().numpy(),
                                              np.asarray(w))
        again = tt.cast_params_to_compute(cp, tcfg)
        for layer, layer2 in zip(cp["layers"], again["layers"]):
            assert layer2["attn"]["rm_w"] is layer["attn"]["rm_w"]


@pytest.mark.parametrize("kind", TWO_LAUNCH)
def test_two_launch_forward_matches_reference(kind):
    jcfg, jp, tcfg, tp = _two_launch_models(kind, "float32")
    toks = _tokens(2, 20, jcfg.vocab_size, 1)
    want, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("kind", TWO_LAUNCH)
def test_two_launch_prefill_and_state_match_reference(kind):
    """Bucketed prefill (the second prompt right-padded at position -1):
    logits within 1e-4 relative, the decode state (S, n) within 1e-5."""
    jcfg, jp, tcfg, tp = _two_launch_models(kind, "float32", seed=1)
    toks = _tokens(2, 32, jcfg.vocab_size, 2)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    pos[1, 21:] = -1
    want, jcache = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                         "positions": jnp.asarray(pos)}, 64)
    with torch.no_grad():
        got, tcache = tt.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos)}, 64)
    jstate = jcache["groups"]["b0_attn_mlp"]
    for i, layer in enumerate(tcache["layers"]):
        for name in ("rm_s", "rm_n"):
            assert _rel(layer[name].numpy(),
                        np.asarray(jstate[name][i])) <= 1e-5, name
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("kind", TWO_LAUNCH)
def test_two_launch_greedy_decode_matches_reference(kind):
    """8 greedy tokens: identical tokens, logits within 1e-4 relative."""
    jcfg, jp, tcfg, tp = _two_launch_models(kind, "float32", seed=2)
    toks = _tokens(2, 12, jcfg.vocab_size, 3).astype(np.int32)

    def jpre(x):
        lg, c = jt.prefill(jp, jcfg, {"tokens": jnp.asarray(x)}, 64)
        return np.asarray(lg), c

    def jstep(c, tok, pos):
        lg, c = jt.decode_step(jp, jcfg, c, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos))
        return np.asarray(lg), c

    def tpre(x):
        lg, c = tt.prefill(tp, tcfg, {"tokens": torch.from_numpy(x)}, 64)
        return lg.numpy(), c

    def tstep(c, tok, pos):
        lg, c = tt.decode_step(tp, tcfg, c, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        return lg.numpy(), c

    with torch.no_grad():
        want_tok, want_lg = _greedy_decode(jpre, jstep, toks, 8)
        got_tok, got_lg = _greedy_decode(tpre, tstep, toks, 8)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert _rel(got_lg, want_lg) <= 1e-4


def test_tensor_sketch_bf16_within_budget():
    """Default bf16 compute with the fp32 RM precision: logits within the
    bf16 budget of the reference."""
    jcfg, jp, tcfg, tp = _two_launch_models("tensor_sketch", "bfloat16",
                                            seed=5)
    toks = _tokens(2, 20, jcfg.vocab_size, 7)
    want, _ = jt.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        got, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert np.abs(got.numpy() - np.asarray(want)).max() <= BF16_LOGIT_ATOL
