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
from repro_torch.kernels.rm_attention.ref import (
    rm_fused_causal_ref,
)

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
    """The serving-only prefill and the raw B2 wrapper have no VJP (nor in
    the reference) and refuse autograd; the fused causal op differentiates
    (tests/test_torch_train_grads.py holds its gradients)."""
    q = torch.ones(1, 1, 4, 4, requires_grad=True)
    args = (q, q, torch.ones(1, 1, 4, 4), torch.ones(1, 3, 4),
            np.ones(3, np.int32), np.ones(3, np.float32))
    with pytest.raises(NotImplementedError, match="backward"):
        rm_attention_fused_prefill(*args)
    with pytest.raises(NotImplementedError, match="backward"):
        rm_fused_causal(*args[:3], None, *args[3:], 1e-4)
    out = rm_attention_fused_causal(*args)
    out.sum().backward()
    assert q.grad.shape == q.shape


@pytest.mark.parametrize("bh,heads,t,dv,f", [(16, 16, 256, 128, 163),
                                             (16, 16, 4096, 128, 163),
                                             (16, 16, 32768, 128, 163),
                                             (16, 16, 256, 128, 2048),
                                             (8, 4, 20, 16, 42),
                                             (1, 1, 1, 1, 1),
                                             (3, 3, 300, 200, 20000)])
def test_causal_schedule_covers_the_work(bh, heads, t, dv, f):
    """B2's plan at any F: the padded length is whole chunks, the feature
    tiles and value groups cover F and dv within the tiles a block's warps
    hold (pass A 17 n-tiles, pass B 10 with the den column), and each
    pass's shared memory, which does not grow with F or d, fits a block
    (F 2048 and 20000 raised in the earlier one-block kernel); the chunks
    run in segments of at most 32, so the scratch of chunk states does not grow
    with T past 2048 positions."""
    sc = common.causal_schedule(bh, heads, t, 128, dv, f)
    assert sc.bh % sc.heads == 0
    assert sc.t % common.CAUSAL_CHUNK == 0 and sc.t - t < common.CAUSAL_CHUNK
    assert sc.n_chunks * common.CAUSAL_CHUNK == sc.t
    assert sc.seg_chunks == min(sc.n_chunks, common.CAUSAL_SEGMENT_CHUNKS)
    assert sc.scratch_bytes == 4 * bh * sc.seg_chunks * f * (dv + 1)
    assert sc.n_ct == -(-f // 8)
    assert sc.n_ftiles * common.CAUSAL_FTILE >= f
    assert sc.n_agroups * sc.ftiles_per_agroup >= sc.n_ftiles
    assert (sc.n_agroups - 1) * sc.ftiles_per_agroup < sc.n_ftiles
    for width, groups, max_tiles in (
            (sc.dva_per_group, sc.n_dvagroups, 17),
            (sc.dvb_per_group, sc.n_dvbgroups, 10)):
        assert width % 8 == 0 and groups * width >= dv > (groups - 1) * width
        assert -(-(width + 1) // 8) <= max_tiles
    for ld in (sc.lda, sc.ldb):
        assert ld % 32 in (8, 24)
    assert sc.smem_a == 4 * 64 * (72 + sc.lda)
    assert sc.smem_b == 4 * 64 * (2 * 68 + 2 * sc.ldb + 1)
    assert max(sc.smem_a, sc.smem_b) <= common.SMEM_PER_BLOCK
    assert sc == common.causal_schedule(bh, heads, t, 128, dv, f)  # memoized


def test_causal_schedule_block_counts():
    """At the bucket-256 prefill (BH 16, F 163, dv 128) pass A splits its
    three feature tiles into three groups (192 blocks) and pass B its
    values into two groups of 64 (128 blocks), against 64 blocks of the
    earlier one-block kernel; at a 4096-token prompt 1024 and 2048 blocks
    in all, in two segments of 32 chunks, so its scratch is 43 MB, not 85."""
    pre = common.causal_schedule(16, 16, 256, 128, 128, 163)
    assert (pre.n_chunks, pre.n_ftiles, pre.n_agroups) == (4, 3, 3)
    assert (pre.dvb_per_group, pre.n_dvbgroups) == (64, 2)
    assert (pre.blocks_a, pre.blocks_b) == (192, 128)
    long_ = common.causal_schedule(16, 16, 4096, 128, 128, 163)
    assert (long_.n_agroups, long_.blocks_a, long_.blocks_b) == (1, 1024,
                                                                 2048)
    assert (long_.n_chunks, long_.seg_chunks) == (64, 32)
    assert long_.scratch_bytes == 43_063_296
    assert pre.scratch_bytes == 5_382_912


@pytest.mark.parametrize("rows,f,d,item,want", [
    (128, 163, 128, 4, (16, 1)),      # decode: 8 x 6 = 48 blocks
    (128, 163, 128, 2, (16, 1)),
    (4096, 163, 128, 4, (64, 1)),     # a Gram shape: 64 x 6 = 384 blocks
    (20000, 2000, 123, 4, (64, 8)),   # the adult-shaped map
    (20000, 2000, 460, 4, (16, 8)),   # d past the tile's shared memory
    (0, 0, 1, 4, (16, 1)),
])
def test_feature_tiles_spread_a_decode_batch(rows, f, d, item, want):
    """B1's kernel and column tiles a warp: the chain kernel at the decode
    shape (at least 40 blocks for 168 chains), the 64-row tile kernel
    where its grid has two blocks an SM and its shared memory fits, with
    several column tiles a warp where the grid stays large."""
    got = common.pick_feature_tiles(rows, f, d, item)
    assert got == want
    row_tile, per = got
    blocks = -(-max(rows, 1) // row_tile) * -(-(-(-max(f, 1) // 8))
                                               // (4 * per))
    if rows == 128:
        assert blocks >= 40
    if row_tile == 64:
        assert common.feature_tile_smem(d, item) <= common.SMEM_PER_BLOCK
        assert blocks >= common.NUM_SMS


@pytest.mark.parametrize("case", CASES, ids=["short", "ragged", "chunks"])
def test_kernel_pass_order_matches_unsplit_and_reference(case):
    """B2's order of sums (each chunk's own state, their prefix in chunk
    order, the outputs over the whole F with the mask after the F sum) is
    the plain version's at the kernel's 64-position chunk: that, against
    the plain version at the case's chunk and the reference's
    ``_fused_causal_jnp`` and final state."""
    b, h, t, d, dv, nf, n_max, chunk, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=3)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 4, pad)
    args = _t(q, k, v, kvalid, w, deg, scale)
    got = rm_fused_causal_ref(*args, chunk=common.CAUSAL_CHUNK, eps=1e-4)
    unsplit = rm_fused_causal_ref(*args, chunk=chunk, eps=1e-4)
    jdeg, jscale = jnp.asarray(deg), jnp.asarray(scale)
    want_out = np.asarray(jops._fused_causal_jnp(
        *map(jnp.asarray, (q, k, v, kvalid, w)), jdeg, jscale, chunk, 1e-4))
    zk = jops._featurize_ref4(jnp.asarray(k), jnp.asarray(w), jdeg, jscale)
    zk = zk * jnp.asarray(kvalid)[:, None, :, None]
    want_s, want_n = map(np.asarray, jops.rm_attention_prefill_final_state(
        zk, jnp.asarray(v)))
    for g, u, w_ in zip(got, unsplit, (want_out, want_s, want_n)):
        assert g.shape == u.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), w_, atol=TOL, rtol=0)
