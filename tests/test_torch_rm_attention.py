"""Kernel B2 (fused featurize + causal attention + final state) and the
decode step in the port, against the reference's jnp formulations:
``ops._fused_causal_jnp`` for the output, ``rm_attention_prefill_final_state``
for (S, n), and ``rm_attention_fused_decode_step(use_pallas=False)`` for a
decode step. Tolerance 1e-5 throughout: all fp32, only summation orders
differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.kernels.rm_attention import ops as jops
from repro_torch.kernels import common
from repro_torch.kernels.rm_attention.ops import (
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_prefill,
    rm_fused_causal,
)
from repro_torch.kernels.rm_attention.ref import rm_fused_causal_ref

TOL = 1e-5


def _packed(d, num_features, n_max, seed=0):
    plan = jplan.make_feature_plan(JExp(1.0), d, num_features,
                                   measure="proportional", n_max=n_max)
    om = jplan.init_omegas(plan, jax.random.PRNGKey(seed))
    return (np.asarray(jplan.pack_omegas(plan, om)),
            plan.column_degrees(), plan.column_scales())


def _inputs(b, h, t, d, dv, seed, pad_last=0):
    rng = np.random.default_rng(seed)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, k = unit(b, h, t, d), unit(b, h, t, d)
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    kvalid = np.ones((b, t), np.float32)
    if pad_last:
        kvalid[-1, t - pad_last:] = 0.0       # bucketed-prefill padding
    return q, k, v, kvalid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (b, h, t, d, dv, num_features, n_max, chunk, pad_last)
CASES = [
    (2, 4, 20, 16, 16, 64, 6, 128, 7),     # T < chunk, smoke head
    (1, 3, 70, 16, 8, 64, 6, 32, 10),      # T not a multiple of the chunk
    (2, 2, 40, 32, 32, 96, 5, 16, 0),      # several chunks, no padding
]


@pytest.mark.parametrize("case", CASES, ids=["short", "ragged", "chunks"])
def test_plain_fused_causal_matches_reference(case):
    b, h, t, d, dv, nf, n_max, chunk, pad = case
    w, deg, scale = _packed(d, nf, n_max)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 1, pad)
    jdeg, jscale = jnp.asarray(deg), jnp.asarray(scale)
    want_out = np.asarray(jops._fused_causal_jnp(
        *map(jnp.asarray, (q, k, v, kvalid, w)), jdeg, jscale, chunk, 1e-4))
    zk = jops._featurize_ref4(jnp.asarray(k), jnp.asarray(w), jdeg, jscale)
    zk = zk * jnp.asarray(kvalid)[:, None, :, None]
    want_s, want_n = map(np.asarray, jops.rm_attention_prefill_final_state(
        zk, jnp.asarray(v)))
    out, s, n = rm_fused_causal_ref(*_t(q, k, v, kvalid, w, deg, scale),
                                    chunk=chunk, eps=1e-4)
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), want_s, atol=TOL, rtol=0)
    np.testing.assert_allclose(n.numpy(), want_n, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=["short", "ragged", "chunks"])
def test_prefill_op_matches_reference_prefill(case):
    """The public ops on CPU tensors against the reference's
    ``rm_attention_fused_prefill`` / ``_causal`` with use_pallas=False."""
    b, h, t, d, dv, nf, n_max, chunk, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=1)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 2, pad)
    jargs = [jnp.asarray(a) for a in (q, k, v, w)]
    want = jops.rm_attention_fused_prefill(
        *jargs, deg, scale, kvalid=jnp.asarray(kvalid), chunk=chunk,
        use_pallas=False)
    want_causal = jops.rm_attention_fused_causal(
        *jargs, deg, scale, kvalid=jnp.asarray(kvalid), chunk=chunk,
        use_pallas=False)
    qt, kt, vt, wt, kvt = _t(q, k, v, w, kvalid)
    before = rm_fused_causal.launches
    got = rm_attention_fused_prefill(qt, kt, vt, wt, deg, scale,
                                     kvalid=kvt, chunk=chunk)
    got_causal = rm_attention_fused_causal(qt, kt, vt, wt, deg, scale,
                                           kvalid=kvt, chunk=chunk)
    assert rm_fused_causal.launches == before      # CPU: plain version
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(got_causal.numpy(), np.asarray(want_causal),
                               atol=TOL, rtol=0)
    assert got[2].shape == (b, h, w.shape[1])       # n comes back [B,H,F]


@pytest.mark.parametrize("b,h,d,nf,n_max", [(3, 4, 16, 64, 6),
                                            (2, 2, 128, 256, 8)])
def test_decode_step_matches_reference(b, h, d, nf, n_max):
    w, deg, scale = _packed(d, nf, n_max, seed=2)
    f = w.shape[1]
    rng = np.random.default_rng(5)
    q, k, _, _ = _inputs(b, h, 1, d, d, 6)
    q, k = q[:, :, 0], k[:, :, 0]
    v = rng.normal(size=(b, h, d)).astype(np.float32)
    # the state of a real 10-token prefix, so the denominator is what a
    # decode step meets (the const feature alone contributes ~10)
    _, kp, vp, _ = _inputs(b, h, 10, d, d, 7)
    zk = jops._featurize_ref4(jnp.asarray(kp), jnp.asarray(w),
                              jnp.asarray(deg), jnp.asarray(scale))
    s0, n0 = map(np.asarray, jops.rm_attention_prefill_final_state(
        zk, jnp.asarray(vp)))
    want = jops.rm_attention_fused_decode_step(
        *[jnp.asarray(a) for a in (q, k, v, s0, n0, w)], deg, scale,
        use_pallas=False)
    got = rm_attention_fused_decode_step(*_t(q, k, v, s0, n0, w), deg,
                                         scale)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=TOL,
                                   rtol=0)


def test_edge_shapes_give_their_arithmetic_result():
    q = torch.ones(1, 2, 5, 4)
    v = torch.ones(1, 2, 5, 3)
    out, s, n = rm_attention_fused_prefill(
        q, q, v, torch.ones(2, 0, 4), np.zeros(0, np.int32),
        np.zeros(0, np.float32))
    assert torch.equal(out, torch.zeros(1, 2, 5, 3))
    assert s.shape == (1, 2, 0, 3) and n.shape == (1, 2, 0)
    out = rm_attention_fused_causal(q[:, :, :0], q[:, :, :0], v[:, :, :0],
                                    torch.ones(1, 3, 4),
                                    np.ones(3, np.int32),
                                    np.ones(3, np.float32))
    assert out.shape == (1, 2, 0, 3)


def test_fused_ops_refuse_autograd():
    q = torch.ones(1, 1, 4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        rm_attention_fused_causal(q, q, torch.ones(1, 1, 4, 4),
                                  torch.ones(1, 3, 4), np.ones(3, np.int32),
                                  np.ones(3, np.float32))


@pytest.mark.parametrize("f,dv,t", [(163, 128, 256), (42, 16, 20),
                                    (1000, 64, 4096)])
def test_attention_blocks_fit_shared_memory(f, dv, t):
    chunk, dvb = common.pick_attention_blocks(f, dv, t)
    assert 1 <= chunk <= common.FEATURE_TILE and 1 <= dvb <= 32
    assert chunk <= common.round_up(t, 8)
    f_pad = common.round_up(f, common.FEATURE_TILE)
    assert common.attention_smem_bytes(f_pad, chunk, dvb) \
        <= common.SMEM_PER_BLOCK


def test_attention_blocks_raise_when_features_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        common.pick_attention_blocks(20000, 128, 256)
