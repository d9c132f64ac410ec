"""The two-launch RM attention ops in the port (``rm_attention_causal`` —
pass A and the prefixes in PyTorch, then kernel B5's plain version on the
CPU — ``rm_attention_decode_step`` and ``rm_attention_prefill_final_state``)
against the reference. ``rm_attention_causal`` is held against the
reference's REAL Pallas kernel ``rm_attention_chunked_pallas`` run in
interpret mode (``use_pallas=True, interpret=True``), for ragged T, chunks
of several sizes and padded keys. Tolerance 1e-5 throughout: all fp32,
only summation orders differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.kernels.rm_attention import ops as jops
from repro.kernels.rm_attention import ref as jref
from repro_torch.kernels import common
from repro_torch.kernels.rm_attention.ops import (
    rm_attention_causal,
    rm_attention_chunked,
    rm_attention_decode_step,
    rm_attention_prefill_final_state,
)
from repro_torch.kernels.rm_attention.ref import (
    causal_chunked_ref,
    chunk_states,
    rm_attention_chunked_ref,
    rm_attention_ref,
)

TOL = 1e-5


def _features(b, h, t, f, dv, seed, pad_last=0):
    """Signed features with a constant first column (as the RM and sketch
    maps have), so denominators sit near the prefix length; the last
    sequence's final ``pad_last`` keys zeroed, as bucket padding is."""
    rng = np.random.default_rng(seed)
    zq = (0.3 * rng.normal(size=(b, h, t, f))).astype(np.float32)
    zk = (0.3 * rng.normal(size=(b, h, t, f))).astype(np.float32)
    zq[..., 0] = zk[..., 0] = 1.0
    if pad_last:
        zk[-1, :, t - pad_last:] = 0.0
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    return zq, zk, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (b, h, t, f, dv, chunk, pad_last)
CASES = [
    (2, 3, 20, 64, 16, 128, 7),    # T < chunk: one chunk of T rows
    (1, 2, 70, 50, 8, 32, 10),     # T not a multiple of the chunk, ragged F
    (2, 2, 64, 96, 32, 16, 0),     # several chunks, no padding
    (1, 2, 130, 40, 16, 64, 3),    # chunk 64, ragged tail
]
IDS = ["short", "ragged", "chunks", "chunk64"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_causal_matches_reference_pallas_kernel(case):
    b, h, t, f, dv, chunk, pad = case
    zq, zk, v = _features(b, h, t, f, dv, 1, pad)
    want = np.asarray(jops.rm_attention_causal(
        jnp.asarray(zq), jnp.asarray(zk), jnp.asarray(v), chunk=chunk,
        eps=1e-4, use_pallas=True, interpret=True))
    before = rm_attention_chunked.launches
    got = rm_attention_causal(*_t(zq, zk, v), chunk=chunk, eps=1e-4)
    assert rm_attention_chunked.launches == before     # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_causal_matches_quadratic_reference(case):
    """The chunked formulation against the O(T^2) direct evaluation, in
    both packages (the reference's ``rm_attention_ref``)."""
    b, h, t, f, dv, chunk, pad = case
    zq, zk, v = _features(b, h, t, f, dv, 2, pad)
    want = np.asarray(jref.rm_attention_ref(
        jnp.asarray(zq), jnp.asarray(zk), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(rm_attention_ref(*_t(zq, zk, v)).numpy(),
                               want, atol=TOL, rtol=0)
    np.testing.assert_allclose(
        causal_chunked_ref(*_t(zq, zk, v), chunk, 1e-4).numpy(), want,
        atol=TOL, rtol=0)


@pytest.mark.parametrize("t,chunk", [(64, 16), (40, 40), (96, 32)])
def test_chunk_states_and_pass_b_match_reference(t, chunk):
    """Pass A plus prefixes against ``ops._chunk_states``, and pass B's
    plain version against the Pallas kernel itself (interpret mode) on the
    reference's own prefixes."""
    from repro.kernels.rm_attention.rm_attention import (
        rm_attention_chunked_pallas,
    )

    b, h, f, dv = 1, 2, 48, 16
    zq, zk, v = _features(b, h, t, f, dv, 3)
    _, _, js_prev, jn_prev = jops._chunk_states(jnp.asarray(zk),
                                                jnp.asarray(v), chunk)
    s_prev, n_prev = chunk_states(*_t(zk, v), chunk)
    np.testing.assert_allclose(s_prev.numpy(), np.asarray(js_prev),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(n_prev.numpy(), np.asarray(jn_prev),
                               atol=TOL, rtol=0)
    n = t // chunk
    want = np.asarray(rm_attention_chunked_pallas(
        jnp.asarray(zq).reshape(b * h, t, f),
        jnp.asarray(zk).reshape(b * h, t, f),
        jnp.asarray(v).reshape(b * h, t, dv),
        js_prev.reshape(b * h, n, f, dv), jn_prev.reshape(b * h, n, f, 1),
        chunk=chunk, eps=1e-4, interpret=True))
    got = rm_attention_chunked_ref(
        *_t(zq.reshape(b * h, t, f), zk.reshape(b * h, t, f),
            v.reshape(b * h, t, dv)),
        s_prev.reshape(b * h, n, f, dv), n_prev.reshape(b * h, n, f),
        chunk=chunk, eps=1e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("b,h,f,dv", [(3, 4, 64, 16), (2, 2, 256, 128)])
def test_decode_step_and_final_state_match_reference(b, h, f, dv):
    zq_p, zk_p, v_p = _features(b, h, 10, f, dv, 4, pad_last=3)
    want_s, want_n = jops.rm_attention_prefill_final_state(
        jnp.asarray(zk_p), jnp.asarray(v_p))
    s0, n0 = rm_attention_prefill_final_state(*_t(zk_p, v_p))
    np.testing.assert_allclose(s0.numpy(), np.asarray(want_s), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(n0.numpy(), np.asarray(want_n), atol=TOL,
                               rtol=0)
    zq, zk, v = (a[:, :, 0] for a in _features(b, h, 1, f, dv, 5))
    want = jops.rm_attention_decode_step(
        *[jnp.asarray(a) for a in (zq, zk, v)], want_s, want_n)
    got = rm_attention_decode_step(*_t(zq, zk, v), s0, n0)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=TOL,
                                   rtol=0)


def test_two_launch_ops_edges():
    zq = torch.ones(1, 2, 0, 8)
    out = rm_attention_causal(zq, zq, torch.ones(1, 2, 0, 4))
    assert out.shape == (1, 2, 0, 4)
    # the op differentiates (tests/test_torch_train_grads.py holds its
    # gradients); the raw B5 wrapper has no VJP and refuses autograd
    z = torch.ones(1, 1, 4, 8, requires_grad=True)
    rm_attention_causal(z, z, torch.ones(1, 1, 4, 4)).sum().backward()
    assert z.grad.shape == z.shape
    with pytest.raises(NotImplementedError, match="backward"):
        rm_attention_chunked(z[0], z[0], torch.ones(1, 4, 4),
                             torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8),
                             chunk=4, eps=1e-4)


# (bh, t, f, dv, chunk, item) -> (rows, q_tiles, blocks, n_groups,
# win_keys) of kernel B5
@pytest.mark.parametrize("shape,want", [
    ((16, 256, 256, 128, 128, 4), (16, 8, 512, 1, 128)),   # the prefill
    ((16, 256, 255, 128, 128, 4), (16, 8, 512, 1, 128)),   # ctr's F 255
    ((16, 256, 256, 128, 128, 2), (16, 8, 512, 1, 128)),   # bf16 features
    ((16, 32, 256, 128, 32, 4), (16, 2, 64, 1, 64)),       # chunk 32
    ((16, 20, 64, 128, 20, 4), (16, 2, 64, 1, 64)),        # T 20, ragged
    ((16, 4096, 256, 128, 128, 4), (16, 8, 8192, 1, 128)),  # 4096 tokens
    ((2, 2048, 64, 300, 1024, 4), (16, 64, 512, 2, 512)),  # wide chunk, dv
], ids=["prefill", "ctr-F255", "bf16", "chunk32", "T20", "T4096",
        "chunk1024-dv300"])
def test_chunked_schedule(shape, want):
    """B5's query tile: 32 rows where the grid (a cluster of two blocks a
    query tile) still has two blocks an SM, else 16; value groups of at
    most 156 columns; the scores of a window of at most 512 (16 rows) or
    256 (32 rows) keys in shared memory, which four blocks an SM share at
    the prefill."""
    bh, t, f, dv, chunk, item = shape
    s = common.chunked_schedule(bh, t, f, dv, chunk, item)
    assert (s.rows, s.q_tiles, s.blocks, s.n_groups, s.win_keys) == want
    assert s.q_tiles * s.rows >= chunk > (s.q_tiles - 1) * s.rows
    assert s.rows == 16
    assert s.n_groups * s.group_cols >= dv
    w0 = min(dv, s.group_cols)
    assert s.ldv >= 8 * -(-(w0 + 1) // 8) and s.ldv % 32 in (8, 24)
    assert s.lds == s.win_keys + 4 and s.win_keys % 64 == 0
    assert s.win_keys == min(common.round_up(chunk, 64),
                             common.CHUNKED_WINDOW)
    assert s.ldq == 32 + (4 if item == 4 else 8)
    assert s.smem_bytes <= common.SMEM_PER_BLOCK
    if shape[:5] == (16, 256, 256, 128, 128):
        assert s.blocks >= 2 * common.NUM_SMS
        # four blocks share an SM's 228 KB of shared memory
        assert 4 * (s.smem_bytes + 1024) <= 228 * 1024
