"""Kernels B3 (key state) and B4 (apply) and the fused non-causal op in the
port, against the reference's jnp formulations: ``ops._fused_noncausal_jnp``
(the op), ``_featurize_ref4`` + ``rm_attention_prefill_final_state`` (the
state B3 builds), ``ops.rm_attention_noncausal`` and
``ref.rm_attention_ref(causal=False)`` (the two-launch op and the O(T^2)
direct evaluation). The reference's Pallas B3/B4 do not trace on this jax
(ROADMAP.md queue C), so its jnp oracle is the reference here.

Tolerances, as ``max |got - want| <= tol x max(1, max |want|)``: 1e-5 in
fp32 (only summation orders differ); bf16 inputs against the reference's
own bf16 path at 1e-5 (both upcast exactly and accumulate in fp32), and
against the fp32 path within the rm bf16 feature budget of
``tests/test_precision.py`` (5e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.core import plan as jplan
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.kernels.rm_attention import ops as jops
from repro.kernels.rm_attention import ref as jref
from repro_torch.kernels import common
from repro_torch.kernels.rm_attention.noncausal import (
    COL_CLASSES,
    featurize_slab_ref,
    pack_noncausal,
    slab_layout,
    state_by_splits_ref,
    tile_classes,
)
from repro_torch.kernels.rm_attention.ops import (
    rm_attention_fused_noncausal,
    rm_attention_noncausal,
    rm_fused_apply,
    rm_fused_state,
)
from repro_torch.kernels.rm_attention.ref import (
    featurize_ref4,
    rm_attention_ref,
    rm_fused_apply_ref,
    rm_fused_noncausal_ref,
    rm_fused_state_ref,
)

TOL = 1e-5
RM_BF16_BUDGET = 5e-3    # tests/test_precision.py TOLERANCES["rm"]
B3_TOL = 1e-4            # chip_smoke.py: fp32 sums of up to T terms


def _packed(d, num_features, n_max, seed=0):
    import jax

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
        kvalid[-1, t - pad_last:] = 0.0       # a padded clip
    return q, k, v, kvalid


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max() if want.size else 0.0), \
        err


def _reference_zk(k, kvalid, w, deg, scale):
    zk = jops._featurize_ref4(jnp.asarray(k), jnp.asarray(w),
                              jnp.asarray(deg), jnp.asarray(scale))
    return zk * jnp.asarray(kvalid)[:, None, :, None]


# (b, h, t, d, dv, num_features, n_max, chunk, pad_last); F is the plan's
# packed width: 42 columns for the 16-wide SMOKE head, 163 for the hubert
# head (d = 80, 256 features), never a multiple of the 64-column tile
CASES = [
    (2, 4, 20, 16, 16, 64, 6, 128, 7),     # T < chunk, SMOKE head
    (1, 3, 70, 16, 8, 64, 6, 32, 10),      # T not a multiple of the chunk
    (2, 2, 150, 80, 80, 256, 8, 128, 36),  # hubert head, T 150 -> 256
    (1, 2, 45, 80, 80, 256, 8, 16, 0),     # hubert head, several chunks
]
IDS = ["smoke-short", "smoke-ragged", "hubert-padded", "hubert-chunks"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_state_matches_reference(case):
    """B3's plain version: the whole-sequence (S, n) of the masked keys."""
    b, h, t, d, dv, nf, n_max, _, pad = case
    w, deg, scale = _packed(d, nf, n_max)
    _, k, v, kvalid = _inputs(b, h, t, d, dv, 1, pad)
    want_s, want_n = jops.rm_attention_prefill_final_state(
        _reference_zk(k, kvalid, w, deg, scale), jnp.asarray(v))
    kv_bh = np.repeat(kvalid[:, None, :], h, axis=1).reshape(b * h, t)
    s, n = rm_fused_state_ref(*_t(k.reshape(b * h, t, d),
                                  v.reshape(b * h, t, dv), kv_bh, w, deg,
                                  scale))
    assert s.shape == (b * h, w.shape[1], dv) and n.shape == (b * h,
                                                              w.shape[1])
    _close(s.reshape(b, h, -1, dv), want_s, TOL)
    _close(n.reshape(b, h, -1), want_n, TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_apply_matches_reference(case):
    """B4's plain version against the reference's apply arithmetic
    (``_featurize_ref4``, two einsums, ``_clamp_den``) on a given state."""
    b, h, t, d, dv, nf, n_max, _, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=1)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 2, pad)
    s, n = map(np.asarray, jops.rm_attention_prefill_final_state(
        _reference_zk(k, kvalid, w, deg, scale), jnp.asarray(v)))
    zq = jops._featurize_ref4(jnp.asarray(q), jnp.asarray(w),
                              jnp.asarray(deg), jnp.asarray(scale))
    num = jnp.einsum("bhtf,bhfd->bhtd", zq, jnp.asarray(s))
    den = jref._clamp_den(jnp.einsum("bhtf,bhf->bht", zq, jnp.asarray(n)),
                          1e-4)
    want = num / den[..., None]
    f = w.shape[1]
    got = rm_fused_apply_ref(*_t(q.reshape(b * h, t, d),
                                 s.reshape(b * h, f, dv), n.reshape(b * h, f),
                                 w, deg, scale), eps=1e-4)
    _close(got.reshape(b, h, t, dv), want, TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_noncausal_op_matches_reference(case):
    """The public op on CPU tensors (T padding, then B3's and B4's plain
    versions) against the reference's op with use_pallas=False
    (``_fused_noncausal_jnp``), its own composed plain version, and the
    O(T^2) direct evaluation."""
    b, h, t, d, dv, nf, n_max, chunk, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=2)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 3, pad)
    want = jops.rm_attention_fused_noncausal(
        *[jnp.asarray(a) for a in (q, k, v, w)], deg, scale,
        kvalid=jnp.asarray(kvalid), chunk=chunk, use_pallas=False)
    want_jnp = jops._fused_noncausal_jnp(
        *[jnp.asarray(a) for a in (q, k, v, kvalid, w)], jnp.asarray(deg),
        jnp.asarray(scale), 1e-4)
    qt, kt, vt, wt, kvt = _t(q, k, v, w, kvalid)
    before = (rm_fused_state.launches, rm_fused_apply.launches)
    got = rm_attention_fused_noncausal(qt, kt, vt, wt, deg, scale,
                                       kvalid=kvt, chunk=chunk)
    assert (rm_fused_state.launches, rm_fused_apply.launches) == before
    assert got.dtype == torch.float32
    _close(got, want, TOL)
    _close(got, want_jnp, TOL)
    _close(rm_fused_noncausal_ref(qt, kt, vt, kvt, wt, *_t(deg, scale),
                                  eps=1e-4), want, TOL)
    zq = jops._featurize_ref4(jnp.asarray(q), jnp.asarray(w),
                              jnp.asarray(deg), jnp.asarray(scale))
    zk = _reference_zk(k, kvalid, w, deg, scale)
    _close(got, jref.rm_attention_ref(zq, zk, jnp.asarray(v), causal=False),
           TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_two_launch_noncausal_matches_reference(case):
    """``rm_attention_noncausal`` over given features (the two-launch
    encoder path) and the port's O(T^2) evaluation, against the
    reference's."""
    b, h, t, d, dv, nf, n_max, _, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=3)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 4, pad)
    zq = np.asarray(jops._featurize_ref4(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(deg),
        jnp.asarray(scale)))
    zk = np.asarray(_reference_zk(k, kvalid, w, deg, scale))
    want = jops.rm_attention_noncausal(*map(jnp.asarray, (zq, zk, v)),
                                       eps=1e-4)
    got = rm_attention_noncausal(*_t(zq, zk, v), eps=1e-4)
    _close(got, want, TOL)
    _close(rm_attention_ref(*_t(zq, zk, v), causal=False),
           jref.rm_attention_ref(*map(jnp.asarray, (zq, zk, v)),
                                 causal=False), TOL)


@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_bf16_inputs_within_budget(case):
    """bf16 q, k and w (``rm.precision="bf16"``): the port's op against the
    reference's op on the same bf16 inputs at 1e-5, and against the fp32
    op within the rm bf16 budget."""
    b, h, t, d, dv, nf, n_max, chunk, pad = case
    w, deg, scale = _packed(d, nf, n_max, seed=4)
    q, k, v, kvalid = _inputs(b, h, t, d, dv, 5, pad)
    qb, kb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, w))
    want16 = jops.rm_attention_fused_noncausal(
        qb, kb, jnp.asarray(v), wb, deg, scale, kvalid=jnp.asarray(kvalid),
        chunk=chunk, use_pallas=False)
    want32 = jops.rm_attention_fused_noncausal(
        *[jnp.asarray(a) for a in (q, k, v, w)], deg, scale,
        kvalid=jnp.asarray(kvalid), chunk=chunk, use_pallas=False)
    qt, kt, vt, wt, kvt = _t(q, k, v, w, kvalid)
    got = rm_attention_fused_noncausal(
        qt.bfloat16(), kt.bfloat16(), vt, wt.bfloat16(), deg, scale,
        kvalid=kvt, chunk=chunk)
    assert got.dtype == torch.float32
    _close(got, want16, TOL)
    _close(got, want32, RM_BF16_BUDGET)


def test_empty_shapes_give_their_arithmetic_result():
    """No rows or no keys: empty outputs and an empty (zero) state; no
    feature columns: every numerator and denominator is 0, so the output
    is 0 / clamp(0) = 0 — as the reference returns."""
    w, deg, scale = _packed(16, 64, 6)
    wt = torch.from_numpy(np.array(w))
    q = torch.ones(2, 3, 0, 16)
    v = torch.ones(2, 3, 0, 8)
    out = rm_attention_fused_noncausal(q, q, v, wt, deg, scale)
    want = jops.rm_attention_fused_noncausal(
        jnp.ones((2, 3, 0, 16)), jnp.ones((2, 3, 0, 16)),
        jnp.ones((2, 3, 0, 8)), jnp.asarray(w), deg, scale,
        use_pallas=False)
    assert out.shape == want.shape == (2, 3, 0, 8)
    s, n = rm_fused_state(torch.ones(6, 0, 16), torch.ones(6, 0, 8),
                          torch.ones(6, 0), wt, deg, scale)
    assert torch.equal(s, torch.zeros(6, w.shape[1], 8))
    assert torch.equal(n, torch.zeros(6, w.shape[1]))
    assert rm_fused_apply(torch.ones(6, 0, 16), s, n, wt, deg, scale,
                          1e-4).shape == (6, 0, 8)
    q5 = torch.ones(1, 2, 5, 16)
    v5 = torch.ones(1, 2, 5, 8)
    out = rm_attention_fused_noncausal(q5, q5, v5, torch.ones(3, 0, 16),
                                       np.zeros(0, np.int32),
                                       np.zeros(0, np.float32))
    assert torch.equal(out, torch.zeros(1, 2, 5, 8))


def test_noncausal_ops_refuse_autograd():
    w, deg, scale = _packed(16, 64, 6)
    wt = torch.from_numpy(np.array(w))
    q = torch.ones(1, 1, 4, 16, requires_grad=True)
    v = torch.ones(1, 1, 4, 8)
    # the fused op differentiates (tests/test_torch_train_grads.py holds its
    # gradients); the raw B3 / B4 wrappers have no VJP and refuse autograd
    rm_attention_fused_noncausal(q, q, v, wt, deg, scale).sum().backward()
    assert q.grad.shape == q.shape
    with pytest.raises(NotImplementedError, match="backward"):
        rm_fused_state(q[0], v[0], torch.ones(1, 4), wt, deg, scale)
    s = torch.zeros(1, w.shape[1], 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        rm_fused_apply(q[0].detach(), s, torch.zeros(1, w.shape[1]), wt,
                       deg, scale, 1e-4)
    with torch.no_grad():
        assert rm_attention_fused_noncausal(q, q, v, wt, deg,
                                            scale).shape == (1, 1, 4, 8)


def test_wrappers_take_no_other_device_and_check_shapes(monkeypatch):
    """A ``meta`` tensor takes the plain version (shapes only, a dry
    run's step); a tensor on a device neither plain nor a card raises
    (there is no silent fallback: meta taken out of
    ``common.PLAIN_DEVICES`` stands for one), and so do mismatched
    shapes."""
    from repro_torch.kernels.rm_attention import ops as rm_attn_ops

    w, deg, scale = _packed(16, 64, 6)
    wt = torch.from_numpy(np.array(w))
    k = torch.ones(2, 8, 16, device="meta")
    args = (k, torch.ones(2, 8, 4, device="meta"),
            torch.ones(2, 8, device="meta"), wt.to("meta"), deg, scale)
    s, n = rm_fused_state(*args)
    assert s.device.type == "meta" and s.shape == (2, wt.shape[1], 4)
    assert n.shape == (2, wt.shape[1])
    monkeypatch.setattr(rm_attn_ops, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        rm_fused_state(*args)
    with pytest.raises(ValueError, match="shape mismatch"):
        rm_fused_state(torch.ones(2, 8, 16), torch.ones(2, 8, 4),
                       torch.ones(2, 7), wt, deg, scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        rm_fused_apply(torch.ones(2, 8, 16), torch.ones(2, 5, 4),
                       torch.ones(2, 5), wt, deg, scale, 1e-4)


@pytest.mark.parametrize("dv", [16, 80, 128, 200, 1])
def test_noncausal_blocks_fit_shared_memory(dv):
    """B3's and B4's schedules on the hubert plan (d 80, F 163), fp32 and
    bf16: each fits one block's shared memory, its value groups cover dv
    within the accumulator tiles the block's warps hold, and B3's feature
    groups cover F."""
    pack = _hubert_pack()
    for kind in ("state", "apply"):
        for item in (4, 2):
            sc = common.noncausal_schedule(kind, 128, 1500, 80, dv, 163,
                                           pack.tile_rows, item)
            assert sc.smem_bytes <= common.SMEM_PER_BLOCK
            assert sc.dv_per_group % 8 == 0
            assert sc.n_dvgroups * sc.dv_per_group >= dv
            assert (sc.n_dvgroups - 1) * sc.dv_per_group < dv
            assert sc.n_fgroups * sc.ct_per_group >= sc.n_ct
            ntiles = -(-(sc.dv_per_group + 1) // 8)
            assert ntiles <= common.NONCAUSAL_MAX_VALUE_TILES
            if kind == "state":
                assert -(-sc.ct_per_group * 8 // 16) <= \
                    common.STATE_MAX_FEATURE_TILES
            else:
                assert sc.n_fgroups == 1


def _hubert_pack(dtype=torch.float32):
    """The hubert head's slab: d 80, F 163, degrees [0:1, 1:94, 2:47, 3:16,
    4:4, 5:1]."""
    w, deg, scale = _packed(80, 256, 8)
    assert w.shape[1] == 163
    return pack_noncausal(torch.from_numpy(np.array(w)).to(dtype), deg,
                          scale)


def _ragged_plan(seed=0, f=29, d=24, kdeg=4):
    """Degrees 0 to kdeg in no order (several degree-0 columns, F ragged
    against the 8-column tile), omegas +-1 on the slots a column uses."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, kdeg + 1, size=f).astype(np.int32)
    deg[[0, 5]] = 0
    w = rng.choice([-1.0, 1.0], size=(kdeg, f, d)).astype(np.float32)
    w[np.arange(kdeg)[:, None] >= deg[None, :]] = 0.0
    scale = rng.uniform(0.2, 1.5, size=f).astype(np.float32)
    return w, deg, scale


def test_slab_layout_rows_and_padding():
    """One 8-column tile a depth: 304 rows for the hubert plan (257 used
    slots), zero rows for the slots past a column's degree and for the
    padding columns, which carry degree 0 and scale 0."""
    w, deg, scale = _packed(80, 256, 8)
    tile_row0, index = slab_layout(deg)
    assert tile_row0[-1] == 304 and (index >= 0).sum() == deg.sum() == 257
    pack = _hubert_pack()
    assert pack.slab.shape == (304, 80) and pack.num_col_tiles == 21
    used = torch.from_numpy(index >= 0)
    assert torch.equal(pack.slab[~used], torch.zeros(int((~used).sum()),
                                                     80))
    j, f = np.divmod(index[index >= 0], w.shape[1])
    assert torch.equal(pack.slab[used], torch.from_numpy(w[j, f]))
    assert pack.col_deg[163:].eq(0).all() and pack.col_scale[163:].eq(0).all()
    assert pack.tile_rows == tuple(int(r) for r in tile_row0)


@pytest.mark.parametrize("plan", ["hubert", "ragged"])
def test_tile_classes_deal_out_every_tile_once(plan):
    """Each column tile in exactly one of the featurize's classes, each
    class's tiles in order, and the classes' depths within one deepest
    tile of each other (the hubert plan: 38 slot-tiles, at most 5 a
    class)."""
    deg = _packed(80, 256, 8)[1] if plan == "hubert" else _ragged_plan()[1]
    tile_row0, _ = slab_layout(deg)
    lists = tile_classes(tile_row0)
    starts, tiles = lists[:COL_CLASSES + 1], lists[COL_CLASSES + 1:]
    assert starts[0] == 0 and starts[-1] == len(tile_row0) - 1
    assert sorted(tiles.tolist()) == list(range(len(tile_row0) - 1))
    depth = np.diff(tile_row0) // 8
    loads = []
    for k in range(COL_CLASSES):
        mine = tiles[starts[k]:starts[k + 1]]
        assert list(mine) == sorted(mine)
        loads.append(int(np.maximum(depth[mine], 1).sum()))
    assert max(loads) - min(loads) <= depth.max()
    if plan == "hubert":
        assert max(loads) == 5


def test_slab_knows_when_its_values_are_tf32():
    """The rm omegas (+-1, 0) are TF32 numbers; Gaussian ones are not; a
    bf16 slab needs no such test."""
    w, deg, scale = _packed(16, 64, 6)
    wt = torch.from_numpy(np.array(w))
    assert pack_noncausal(wt, deg, scale).tf32_exact
    noisy = wt * torch.rand(wt.shape, generator=torch.Generator()
                            .manual_seed(0))
    assert not pack_noncausal(noisy, deg, scale).tf32_exact
    assert pack_noncausal(noisy.bfloat16(), deg, scale).tf32_exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("plan", ["hubert", "smoke", "ragged"])
def test_slab_featurize_matches_reference(plan, dtype):
    """The slab's plain featurize (the kernels' slot order) against the
    port's ``featurize_ref4`` on ``w [kdeg, F, d]`` and the reference's
    ``_featurize_ref4``: 1e-5, fp32 accumulation in all three (bf16 rows
    and omegas upcast exactly)."""
    if plan == "ragged":
        w, deg, scale = _ragged_plan()
    else:
        w, deg, scale = _packed(*((80, 256, 8) if plan == "hubert"
                                  else (16, 64, 6)))
    d = w.shape[2]
    q, _, _, _ = _inputs(2, 3, 37, d, 8, 11)
    wt = torch.from_numpy(np.array(w)).to(dtype)
    xt = torch.from_numpy(q).to(dtype)
    pack = pack_noncausal(wt, deg, scale)
    assert pack.slab.dtype == dtype
    got = featurize_slab_ref(xt.reshape(-1, d), pack).reshape(2, 3, 37, -1)
    _close(got, featurize_ref4(xt, wt, *_t(deg, scale)).numpy(), TOL)
    want = jops._featurize_ref4(
        jnp.asarray(xt.float().numpy()), jnp.asarray(wt.float().numpy()),
        jnp.asarray(deg), jnp.asarray(scale))
    _close(got, want, TOL)


# (bh, t, splits, tiles_per_split, padded keys at the end of each row):
# ragged T, a split whose keys are all padding, one split, uneven splits
SPLIT_CASES = [(3, 150, 3, 1, 0), (2, 200, 4, 1, 72), (2, 130, 1, 3, 9),
               (1, 300, 2, 3, 0)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=["ragged", "all-padded-split", "one-split",
                              "uneven"])
def test_split_order_matches_unsplit_and_reference(case):
    """B3's split-and-reduce order, plain: partial states summed in split
    order against the unsplit plain state and the reference's state, and
    the output they give against the reference's ``_fused_noncausal_jnp``,
    within B3's tolerance."""
    bh, t, splits, per, pad = case
    w, deg, scale = _packed(80, 256, 8, seed=7)
    q, k, v, _ = _inputs(1, bh, t, 80, 80, 12)
    kvalid = np.ones((1, t), np.float32)
    if pad:
        kvalid[0, t - pad:] = 0.0
    kv_bh = np.repeat(kvalid, bh, axis=0)
    args = _t(k[0], v[0], kv_bh, w, deg, scale)
    s, n = state_by_splits_ref(*args, splits=splits, tiles_per_split=per)
    s1, n1 = rm_fused_state_ref(*args)
    _close(s, s1.numpy(), B3_TOL)
    _close(n, n1.numpy(), B3_TOL)
    want_s, want_n = jops.rm_attention_prefill_final_state(
        _reference_zk(k, kvalid, w, deg, scale), jnp.asarray(v))
    _close(s, np.asarray(want_s)[0], B3_TOL)
    _close(n, np.asarray(want_n)[0], B3_TOL)
    out = rm_fused_apply_ref(*_t(q[0]), s, n, *_t(w, deg, scale), eps=1e-4)
    want = jops._fused_noncausal_jnp(
        *[jnp.asarray(a) for a in (q, k, v, kvalid, w)], jnp.asarray(deg),
        jnp.asarray(scale), 1e-4)
    _close(out, np.asarray(want)[0], B3_TOL)


def test_split_picker_block_counts():
    """Two waves of blocks on 132 SMs where T allows, never more splits
    than key tiles, no empty split: 384 blocks at the 8 x 1500 encode
    (128 rows x 3 splits of 8 tiles), 512 at 1 x 32768 (16 x 32 of 16),
    one split where T is a single tile."""
    pack = _hubert_pack()
    for kind in ("state", "apply"):
        for item in (4, 2):
            def sched(bh, t, kind=kind, item=item):
                return common.noncausal_schedule(kind, bh, t, 80, 80, 163,
                                                 pack.tile_rows, item)

            enc, long_, short = sched(128, 1500), sched(16, 32768), \
                sched(1, 64)
            assert (enc.splits, enc.tiles_per_split, enc.blocks) == (3, 8,
                                                                     384)
            assert (long_.splits, long_.tiles_per_split,
                    long_.blocks) == (32, 16, 512)
            assert (short.splits, short.blocks) == (1, 1)
            for sc, t in ((enc, 1500), (long_, 32768), (short, 64)):
                tiles = -(-t // 64)
                assert sc.splits <= tiles
                assert (sc.splits - 1) * sc.tiles_per_split < tiles <= \
                    sc.splits * sc.tiles_per_split
                assert sc.smem_bytes <= common.SMEM_PER_BLOCK
                assert sc.slab_cap == pack.tile_rows[-1]    # one chunk
            assert enc.blocks >= 2 * common.NUM_SMS
            assert long_.blocks >= 2 * common.NUM_SMS


def test_split_picker_tiles_a_slab_too_large():
    """A slab larger than shared memory (d 256: 8 column tiles of depth 8)
    is brought in chunks (slab_cap below the slab's rows, at least one
    column tile); at d 1024 a column tile's slab rows do not fit beside
    the x tile even alone, so d is tiled (a depth chunk dk below dp, the
    projection tile P beside the slab); a column tile too deep to fit even
    at the narrowest depth chunk (degree 120) is staged a piece of whole
    slots at a time (``slot_rows``, within ``slab_cap`` and ``P``)."""
    deg = np.full(64, 8, np.int32)
    tile_row0 = tuple(int(r) for r in slab_layout(deg)[0])
    for kind in ("state", "apply"):
        for item in (4, 2):
            sc = common.noncausal_schedule(kind, 4, 200, 256, 64, 64,
                                           tile_row0, item)
            assert 64 <= sc.slab_cap < tile_row0[-1]
            assert sc.smem_bytes <= common.SMEM_PER_BLOCK
            assert (sc.dk, sc.ldp) == (sc.dp, 0)
        deep = common.noncausal_schedule(kind, 4, 200, 1024, 64, 64,
                                         tile_row0, 4)
        assert deep.dk < deep.dp == 1024
        assert 64 <= deep.slab_cap <= deep.ldp
        assert deep.smem_bytes <= common.SMEM_PER_BLOCK
        too_deep = tuple(int(r) for r in
                         slab_layout(np.full(8, 120, np.int32))[0])
        sc = common.noncausal_schedule(kind, 4, 200, 1024, 64, 8, too_deep,
                                       4)
        assert sc.dk < sc.dp and 0 < sc.slot_rows < too_deep[-1]
        assert sc.slot_rows % 8 == 0 and sc.slot_rows <= sc.slab_cap <= \
            sc.ldp
        assert sc.smem_bytes <= common.SMEM_PER_BLOCK
        assert (deep.slot_rows, sc.slot_rows > 0) == (0, True)


@pytest.mark.parametrize("kind,item,limit", [("state", 4, 384),
                                             ("state", 2, 768),
                                             ("apply", 4, 536),
                                             ("apply", 2, 1072)])
def test_schedule_takes_d_whole_up_to_the_old_limit(kind, item, limit):
    """Up to the deepest d the kernels took whole on the hubert plan (depth
    5) at dv 80, the plan keeps d whole (``dk == dp``, no projection tile),
    so the encoder's d 80 and qwen3's d 128 keep their code path; the next
    multiple of 8 past it tiles d instead of raising, within shared
    memory."""
    tile_rows = _hubert_pack().tile_rows
    for d in (80, 128, limit):
        sc = common.noncausal_schedule(kind, 128, 1500, d, 80, 163,
                                       tile_rows, item)
        assert (sc.dk, sc.ldp) == (sc.dp, 0)
        assert sc.smem_bytes <= common.SMEM_PER_BLOCK
    sc = common.noncausal_schedule(kind, 128, 1500, limit + 8, 80, 163,
                                   tile_rows, item)
    assert sc.dk < sc.dp
    assert sc.smem_bytes <= common.SMEM_PER_BLOCK


@pytest.mark.parametrize("kind,item,d", [("state", 4, 640),
                                         ("state", 2, 1088),
                                         ("apply", 4, 640),
                                         ("apply", 2, 1088),
                                         ("state", 4, 4100),
                                         ("apply", 2, 4100)])
def test_schedule_tiles_deep_d(kind, item, d):
    """Any d runs: past the whole-d limit the schedule stages the x tile
    and the slab rows one depth chunk at a time (``dk``, a multiple of one
    mma's depth, below ``dp``), with every column tile's slab rows and
    their projection tile ``P`` (``ldp >= slab_cap``) in shared memory
    beside the rest (the hubert plan, F 163, dv 80)."""
    tile_rows = _hubert_pack().tile_rows
    sc = common.noncausal_schedule(kind, 128, 1500, d, 80, 163, tile_rows,
                                   item)
    step = 8 if item == 4 else 16
    max_tile = max(b - a for a, b in zip(tile_rows, tile_rows[1:]))
    assert sc.dp == common.round_up(d, step) and sc.dk < sc.dp
    assert sc.dk % step == 0 and sc.ldx >= sc.dk
    assert max_tile <= sc.slab_cap <= sc.ldp
    assert sc.smem_bytes <= common.SMEM_PER_BLOCK
    # the kernels' layout (rm_featurize_mma.cuh smem_layout) adds up to it
    layout = (common.round_up(sc.slab_cap * sc.ldx * item, 16)
              + common.round_up(64 * sc.ldx * item, 16)
              + sc.b_rows * sc.ldb * 4 + 64 * sc.ldz * 4 + 64 * sc.ldp * 4
              + (64 * 4 if kind == "apply" else 0))
    assert layout == sc.smem_bytes


def _deep_column_plan(d):
    """A hand-built FeaturePlan whose last 3 columns have degree 96 (one
    column tile of 96 slots: 768 slab rows), beside 30 shallow ones."""
    from repro_torch.core.plan import FeaturePlan

    return FeaturePlan(degrees=(1, 2, 96), counts=(20, 10, 3),
                       scales=(1.0, 0.5, 0.25), const=0.0, h01=False,
                       h01_a0=0.0, h01_a1=0.0, input_dim=d, num_random=33,
                       coefs_host=(0.0,) * 100, seed=0)


@pytest.mark.parametrize("kind", ["state", "apply"])
@pytest.mark.parametrize("item,d,pieces", [(4, 80, True), (2, 80, False),
                                           (4, 128, True), (2, 640, True)])
def test_schedule_takes_a_column_of_degree_96(kind, item, d, pieces):
    """B3 and B4 schedule a column tile of depth 96, which the earlier
    schedule refused (a tile deeper than about 80 slots): where its slab
    rows do not fit even at the narrowest depth chunk, in pieces of whole
    slots (``slot_rows``) that fit the slab and the projection tile; where
    they fit (bf16 at d 80), whole."""
    plan = _deep_column_plan(d)
    deg = plan.column_degrees()
    assert deg.max() == 96
    tile_rows = tuple(int(r) for r in slab_layout(deg)[0])
    sc = common.noncausal_schedule(kind, 2, 300, d, 64, len(deg), tile_rows,
                                   item)
    max_tile = max(b - a for a, b in zip(tile_rows, tile_rows[1:]))
    assert max_tile == 8 * 96
    assert sc.smem_bytes <= common.SMEM_PER_BLOCK
    if pieces:
        assert sc.dk < sc.dp and 8 <= sc.slot_rows < max_tile
        assert sc.slot_rows % 8 == 0 and sc.slot_rows <= sc.slab_cap <= \
            sc.ldp
    else:
        assert sc.slot_rows == 0 and sc.slab_cap >= max_tile

