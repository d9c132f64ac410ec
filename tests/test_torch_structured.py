"""The port's Hadamard-structured family (repro_torch.structured, the
"structured" registry entry) against the reference's (repro.structured):
plans and their JSON equal exactly (the same host-side numpy arithmetic),
``pack_structured`` bit-exact on the reference's signs, kernel B8's plain
version within 1e-5 of the reference's, the map within 1e-5 of the
reference's dense-H oracle in fp32 and within the reference's structured
bf16 feature budget (2e-2, the default of tests/test_precision.py) in
bf16, ``estimate_gram`` within 1e-4, the kernel's butterfly order against
the Sylvester matrix, and the port's own draws held by statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import registry as jreg
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro.structured import plan as jst
from repro.structured import ref as jstref
from repro_torch.configs import get_config
from repro_torch.core import registry
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp
from repro_torch.core.plan import plan_columns
from repro_torch.kernels import common
from repro_torch.kernels.structured_feature.ops import (
    structured_feature_fused,
)
from repro_torch.models.attention import rm_plan_for
from repro_torch.structured import plan as tst
from repro_torch.structured import ref as tstref

BF16_FEATURE_ATOL = 2e-2      # the reference's default bf16 feature budget
MODELS = [("qwen3-1.7b", True), ("qwen3-1.7b", False),
          ("hubert-xlarge", False)]
MODEL_IDS = ["qwen3-SMOKE", "qwen3-FULL", "hubert-FULL"]


def _model_plans(arch, smoke):
    jcfg = jax_get_config(arch, smoke=smoke, attention_mode="rm",
                          estimator="structured")
    tcfg = get_config(arch, smoke=smoke, attention_mode="rm",
                      estimator="structured")
    dh = tcfg.resolved_head_dim
    return jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh)


def _assert_same_plan(a, b):
    assert tuple(a) == tuple(b)          # every field, exact
    np.testing.assert_array_equal(a.padded_column_degrees(),
                                  b.padded_column_degrees())
    np.testing.assert_array_equal(a.padded_column_scales(),
                                  b.padded_column_scales())
    for prop in ("d_pad", "stacks_per_bucket", "total_stacks", "total_slots",
                 "max_degree", "num_prefix_columns", "num_random_cols",
                 "padded_num_cols", "output_dim"):
        assert getattr(a, prop) == getattr(b, prop), prop


def _signs(jplan, seed):
    """The reference's sign tables, handed across through numpy."""
    p = jst.init_structured_params(jplan, jax.random.PRNGKey(seed))
    d1, d2 = np.asarray(p["d1"]), np.asarray(p["d2"])
    return ({"d1": jnp.asarray(d1), "d2": jnp.asarray(d2)},
            {"d1": torch.from_numpy(d1.copy()),
             "d2": torch.from_numpy(d2.copy())})


def _unit_rows(n, d, seed, radius=1.0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return radius * x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_model_structured_plan_equals_reference(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    assert isinstance(tp, tst.StructuredPlan)
    _assert_same_plan(jp, tp)
    assert tp.truncation_bias(1.0) == jp.truncation_bias(1.0)
    if not smoke:   # 6 stacks of d_pad 128: 768 computed, 255 kept
        assert tp.d_pad == 128 and tp.stacks_per_bucket == (2, 1, 1, 1, 1)
        assert tp.padded_num_cols == 768 and tp.output_dim == 256


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_structured_plan_json_crosses_both_ways(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    _assert_same_plan(tst.StructuredPlan.from_json(jp.to_json()), tp)
    _assert_same_plan(jst.StructuredPlan.from_json(tp.to_json()), jp)


@pytest.mark.parametrize("h01,measure,stratified", [
    (False, "geometric", True), (True, "geometric", True),
    (False, "proportional", True), (True, "proportional", False)])
def test_structured_plan_variants_equal_reference(h01, measure, stratified):
    kw = dict(measure=measure, h01=h01, n_max=7, seed=5,
              stratified=stratified)
    _assert_same_plan(jst.make_structured_plan(JExp(0.8), 12, 60, **kw),
                      tst.make_structured_plan(TExp(0.8), 12, 60, **kw))


def test_truncation_bias_equals_reference_and_is_monotone():
    """The reference's conformance row (tests/test_estimator_conformance.py):
    non-increasing in n_max, and still positive at n_max 16."""
    biases = []
    for n_max in (4, 8, 12, 16):
        kw = dict(measure="proportional", n_max=n_max, seed=0)
        jp = jst.make_structured_plan(JExp(1.0), 8, 512, **kw)
        tp = tst.make_structured_plan(TExp(1.0), 8, 512, **kw)
        assert tp.truncation_bias(1.0) == jp.truncation_bias(1.0)
        biases.append(tp.truncation_bias(1.0))
    assert biases[-1] > 0.0
    assert all(lo <= hi + 1e-12 for lo, hi in zip(biases[1:], biases)), \
        biases


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_pack_structured_bit_exact(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _signs(jp, 1)
    for g, w in zip(tst.pack_structured(tp, tparams),
                    jst.pack_structured(jp, jparams)):
        assert g.is_contiguous() and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [1, 2, 4, 16, 128, 1024])
def test_hadamard_matrix_equals_reference(m):
    np.testing.assert_array_equal(tstref.hadamard_matrix(m),
                                  jstref.hadamard_matrix(m))


def _kernel_butterfly(u, m):
    """The transform as kernel B8 computes it (csrc/structured_feature.cu,
    on a numpy row): stages h = 1, 2, ..., m/2 in order, point i (lane i %
    32, register i / 32; on the block path thread i % 256, register i /
    256) taking v[i] + v[i ^ h] where bit h of i is clear and v[i ^ h] -
    v[i] where it is set, whether the partner comes by a shuffle, through
    shared memory or from the thread's own registers."""
    v = u.astype(np.float64).copy()
    i = np.arange(m)
    h = 1
    while h < m:
        partner = v[i ^ h]
        v = np.where(i & h, partner - v, v + partner)
        h *= 2
    return v


@pytest.mark.parametrize("m", [1, 2, 8, 128, 1024, 2048])
def test_kernel_butterfly_order_is_sylvester(m):
    """The kernel's pair order gives H u for the reference's Sylvester H,
    exactly on integer inputs (d_pad 1 is the identity)."""
    u = np.random.default_rng(m).integers(-4, 5, size=m).astype(np.float32)
    want = jstref.hadamard_matrix(m).astype(np.float64) @ u
    np.testing.assert_array_equal(_kernel_butterfly(u, m), want)


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_plain_version_matches_reference_fused_ref(arch, smoke):
    """Kernel B8's plain version against the reference's jnp mirror of its
    Pallas kernel, on the same packed signs: 1e-5. The port's takes x at
    its true width (hubert: 80 of d_pad 128) and pads it itself."""
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _signs(jp, 2)
    x = _unit_rows(70, tp.input_dim, 3)
    xp = np.pad(x, ((0, 0), (0, jp.d_pad - jp.input_dim)))
    jd1, jd2 = jst.pack_structured(jp, jparams)
    want = np.asarray(jstref.structured_feature_fused_ref(
        jnp.asarray(xp), jd1, jd2, jnp.asarray(jp.padded_column_degrees()),
        jnp.asarray(jp.padded_column_scales())))
    td1, td2 = tst.pack_structured(tp, tparams)
    cd, cs = plan_columns(tp, "cpu")
    got = tstref.structured_feature_fused_ref(torch.from_numpy(x), td1, td2,
                                              cd, cs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # surplus columns come out exactly 0 (their scale is 0)
    assert not got.numpy()[:, tp.padded_column_scales() == 0].any()
    blocks = tstref.structured_blocks_ref(tp, tparams, torch.from_numpy(x))
    np.testing.assert_allclose(blocks.numpy(), got.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("precision,atol", [("fp32", 1e-5),
                                            ("bf16", BF16_FEATURE_ATOL)])
@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_apply_matches_reference_oracle(arch, smoke, precision, atol):
    """The port's map (B8's plain version, then the surplus slice) against
    the reference's dense-H oracle (``use_pallas=False``) on the same
    signs; batch dims kept."""
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _signs(jp, 4)
    x = _unit_rows(3 * 7, tp.input_dim, 5).reshape(3, 7, -1)
    want = np.asarray(jst.apply_structured_plan(
        jp, jparams, jnp.asarray(x), use_pallas=False, precision=precision))
    got = tst.apply_structured_plan(tp, tparams, torch.from_numpy(x),
                                    precision=precision)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    again = tst.apply_structured_plan(
        tp, tparams, torch.from_numpy(x), precision=precision,
        packed=tst.pack_structured(tp, tparams))
    assert torch.equal(again, got)


@pytest.mark.parametrize("precision,atol", [("fp32", 1e-5),
                                            ("bf16", BF16_FEATURE_ATOL)])
@pytest.mark.parametrize("arch,smoke", MODELS[:2], ids=MODEL_IDS[:2])
def test_apply_kept_columns_equal_full_width_sliced(arch, smoke, precision,
                                                    atol):
    """``apply_structured_plan`` writes each bucket's kept columns straight
    into the map (``structured_keep``): bitwise the full-width B8 output
    sliced by bucket after the prefix columns, and within the reference's
    dense-H oracle's tolerance."""
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _signs(jp, 14)
    x = _unit_rows(33, tp.input_dim, 15)
    xt = torch.from_numpy(x)
    cdt = torch.bfloat16 if precision == "bf16" else torch.float32
    d1, d2 = (t.to(cdt) for t in tst.pack_structured(tp, tparams))
    cd, cs = plan_columns(tp, "cpu")
    full = structured_feature_fused(xt.to(cdt), d1, d2, cd, cs)
    pieces, off = [], 0
    for c, n_stacks in zip(tp.counts, tp.stacks_per_bucket):
        pieces.append(full[:, off: off + c])
        off += n_stacks * tp.d_pad
    from repro_torch.core.plan import prefix_columns

    sliced = torch.cat(prefix_columns(tp, xt, cdt) + pieces, dim=-1)
    got = tst.apply_structured_plan(tp, tparams, xt, precision=precision)
    assert torch.equal(got, sliced)
    want = np.asarray(jst.apply_structured_plan(
        jp, jparams, jnp.asarray(x), use_pallas=False, precision=precision))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_structured_keep_places_every_kept_column_once(arch, smoke):
    """``structured_keep``: the stacks' kept columns tile the map's random
    section, in bucket and stack order, each bucket's surplus tail
    dropped."""
    _, tp = _model_plans(arch, smoke)
    keep = tst.structured_keep(tp)
    assert len(keep.first) == len(keep.count) == tp.total_stacks
    cols = [f + c for f, n in zip(keep.first, keep.count) for c in range(n)]
    assert cols == list(range(tp.num_prefix_columns, tp.output_dim))
    i = 0
    for c, n_stacks in zip(tp.counts, tp.stacks_per_bucket):
        assert keep.count[i: i + n_stacks] == tuple(
            min(tp.d_pad, c - j * tp.d_pad) for j in range(n_stacks))
        i += n_stacks


def test_structured_wrapper_writes_only_kept_columns():
    """With ``out`` and ``keep`` the plain path writes each stack's kept
    columns where ``keep`` puts them and leaves every other element of
    ``out`` as it was; ``out`` without ``keep``, or a place past ``out``,
    raises."""
    from repro_torch.kernels.structured_feature.ops import StructuredKeep

    _, tp = _model_plans("qwen3-1.7b", True)
    params = tst.init_structured_params(tp, torch.Generator().manual_seed(2))
    d1, d2 = tst.pack_structured(tp, params)
    cd, cs = plan_columns(tp, "cpu")
    x = torch.from_numpy(_unit_rows(6, tp.input_dim, 16))
    full = structured_feature_fused(x, d1, d2, cd, cs)
    m, n_st = tp.d_pad, tp.total_stacks
    keep = StructuredKeep(tuple(3 + 17 * s for s in range(n_st)),
                          tuple(min(m, 1 + 3 * s) for s in range(n_st)))
    out = torch.full((6, 17 * n_st + 3), float("nan"))
    got = structured_feature_fused(x, d1, d2, cd, cs, out=out, keep=keep)
    assert got is out
    written = torch.zeros(out.shape, dtype=torch.bool)
    for s, (f, c) in enumerate(zip(keep.first, keep.count)):
        assert torch.equal(out[:, f: f + c], full[:, s * m: s * m + c])
        written[:, f: f + c] = True
    assert out[~written].isnan().all()
    with pytest.raises(ValueError, match="together"):
        structured_feature_fused(x, d1, d2, cd, cs, out=out)
    far = StructuredKeep(keep.first[:-1] + (out.shape[1],), keep.count)
    with pytest.raises(ValueError, match="does not place"):
        structured_feature_fused(x, d1, d2, cd, cs, out=out, keep=far)


@pytest.mark.parametrize("h01", [False, True])
def test_apply_prefix_columns_match_reference(h01):
    kw = dict(measure="proportional", h01=h01, n_max=5)
    jp = jst.make_structured_plan(JExp(1.0), 10, 48, **kw)
    tp = tst.make_structured_plan(TExp(1.0), 10, 48, **kw)
    jparams, tparams = _signs(jp, 6)
    x = _unit_rows(9, 10, 7)
    want = np.asarray(jreg.get("structured").apply(
        jp, jparams, jnp.asarray(x), use_pallas=False))
    got = registry.get("structured").apply(tp, tparams, torch.from_numpy(x))
    assert got.shape == (9, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("edge", ["zero_rows", "input_dim_1",
                                  "max_degree_1", "const_only"])
def test_edges_apply_cleanly(edge):
    d, f, n_max, rows = 6, 40, 8, 5
    if edge == "zero_rows":
        rows = 0
    elif edge == "input_dim_1":
        d = 1                          # d_pad 1: the transform is identity
    elif edge == "max_degree_1":
        n_max = 1
    else:
        f = 1
    jp = jst.make_structured_plan(JExp(1.0), d, f, n_max=n_max)
    tp = tst.make_structured_plan(TExp(1.0), d, f, n_max=n_max)
    _assert_same_plan(jp, tp)
    if edge == "input_dim_1":
        assert tp.d_pad == 1
    if edge == "max_degree_1":
        assert tp.max_degree == 1
    if edge == "const_only":
        assert tp.num_random_cols == 0 and tp.output_dim == 1
    jparams, tparams = _signs(jp, 8)
    x = _unit_rows(max(rows, 1), d, 9)[:rows]
    want = np.asarray(jst.apply_structured_plan(jp, jparams, jnp.asarray(x),
                                                use_pallas=False))
    got = tst.apply_structured_plan(tp, tparams, torch.from_numpy(x))
    assert got.shape == want.shape == (rows, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_estimate_gram_matches_reference():
    """``registry.estimate_gram`` over the fused map, row-chunked, against
    the reference's over its dense-H oracle: 1e-4."""
    jp, tp = _model_plans("qwen3-1.7b", True)
    jparams, tparams = _signs(jp, 10)
    x = _unit_rows(40, tp.input_dim, 11)
    y = _unit_rows(9, tp.input_dim, 12)
    want = np.asarray(jreg.estimate_gram(
        lambda a: jreg.get("structured").apply(jp, jparams, a,
                                               use_pallas=False),
        jnp.asarray(x), jnp.asarray(y), row_chunk=16))
    got = registry.estimate_gram(
        lambda a: registry.get("structured").apply(tp, tparams, a),
        torch.from_numpy(x), torch.from_numpy(y), row_chunk=16)
    assert got.shape == (40, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_registry_structured_entry():
    est = registry.get("structured")
    assert not est.fused_attention_supported and est.pack_fused is None
    _, tp = _model_plans("qwen3-1.7b", True)
    params = est.init_params(tp, torch.Generator().manual_seed(0))
    assert params["d1"].shape == params["d2"].shape == (tp.total_slots,
                                                        tp.d_pad)
    packed = est.pack(tp, params, torch.bfloat16)
    assert [t.dtype for t in packed] == [torch.bfloat16] * 2
    assert packed[0].shape == (tp.max_degree, tp.total_stacks, tp.d_pad)
    for g, w in zip(packed, tst.pack_structured(tp, params)):
        assert torch.equal(g.float(), w)            # lossless in bf16
    cd, cs = plan_columns(tp, "cpu")
    assert cd.shape == cs.shape == (tp.padded_num_cols,)
    x = torch.from_numpy(_unit_rows(5, tp.input_dim, 13))
    assert est.apply(tp, params, x).shape == (5, est.output_dim(tp))


def test_structured_kernel_wrapper_edges():
    _, tp = _model_plans("qwen3-1.7b", True)
    params = tst.init_structured_params(tp, torch.Generator().manual_seed(1))
    d1, d2 = tst.pack_structured(tp, params)
    cd, cs = plan_columns(tp, "cpu")
    cols = tp.padded_num_cols
    assert structured_feature_fused(torch.ones(0, tp.input_dim), d1, d2, cd,
                                    cs).shape == (0, cols)
    before = structured_feature_fused.launches
    out = structured_feature_fused(torch.ones(2, 3, tp.input_dim), d1, d2,
                                   cd, cs)
    assert out.shape == (2, 3, cols)
    assert structured_feature_fused.launches == before   # CPU: plain version
    none = structured_feature_fused(torch.ones(4, tp.input_dim), d1[:0],
                                    d2[:0], cd, cs)
    np.testing.assert_array_equal(none.numpy(), np.tile(cs.numpy(), (4, 1)))
    with pytest.raises(ValueError, match="d_pad"):
        structured_feature_fused(torch.ones(2, tp.d_pad + 1), d1, d2, cd,
                                 cs)
    x = torch.ones(2, tp.input_dim, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        structured_feature_fused(x, d1, d2, cd, cs)


def test_wrapper_raises_beyond_the_kernels_d_pad():
    """The kernel takes every power-of-two d_pad (past
    ``STRUCTURED_BLOCK_MAX_DPAD`` its split path), so the wrapper refuses
    only a d_pad that is not one, on the CPU as on the card; at twice the
    block path's widest the plain version runs (H of a ones row is d_pad
    at column 0, 0 elsewhere)."""
    m = common.STRUCTURED_BLOCK_MAX_DPAD * 2
    d1 = torch.ones(1, 1, m)
    cd = torch.ones(m, dtype=torch.int32)
    z = structured_feature_fused(torch.ones(2, m), d1, d1, cd, torch.ones(m))
    assert z.shape == (2, m)
    assert (z[:, 0] == m).all() and not z[:, 1:].any()
    bad = 3 * common.STRUCTURED_BLOCK_MAX_DPAD // 2
    d1 = torch.ones(1, 1, bad)
    cd = torch.ones(bad, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        structured_feature_fused(torch.ones(2, bad), d1, d1, cd,
                                 torch.ones(bad))


# (d_pad, rows, stacks) -> (wide, lanes a row, rows a warp, points a lane,
# warps a block): the warp path to 1024 points (half a warp a row where the
# card is full), the block path past it
@pytest.mark.parametrize("m,b,stacks,want", [
    (1, 70, 3, (False, 1, 32, 1, 1)),       # d_pad 1: 32 rows a warp
    (16, 512, 7, (False, 16, 2, 1, 8)),     # SMOKE head: 224 blocks of 8
    (16, 64, 3, (False, 16, 2, 1, 1)),      # SMOKE decode: 96 one-warp blocks
    (128, 64, 6, (False, 32, 1, 4, 2)),     # decode: 192 blocks of 2 warps
    (128, 512, 6, (False, 16, 2, 8, 8)),    # bucket 32: 192 blocks of 8
    (128, 4096, 6, (False, 16, 2, 8, 8)),   # bucket 256 / Gram: 1536 blocks
    (1024, 70, 1, (False, 32, 1, 32, 1)),   # the widest warp path
    (2048, 9, 1, (True, 0, 0, 8, 8)),       # the block path: 8 points a thread
    (8192, 4, 2, (True, 0, 0, 32, 8)),      # the widest block path
])
def test_structured_schedule(m, b, stacks, want):
    sched = common.structured_schedule(m, b, stacks)
    assert (sched.wide, sched.lanes_per_row, sched.rows_per_warp,
            sched.elems_per_lane, sched.warps) == want
    assert sched.d_pad == m
    if sched.wide:
        assert sched.elems_per_lane * common.STRUCTURED_WIDE_THREADS == m
        assert sched.blocks == b * stacks
    else:
        # a warp's 32 lanes hold whole rows, each row's points spread
        # evenly over its lanes
        assert sched.rows_per_warp * sched.lanes_per_row == 32
        assert sched.elems_per_lane * sched.lanes_per_row == m
        assert sched.elems_per_lane <= 32
        per_block = sched.warps * sched.rows_per_warp
        assert sched.blocks == -(-b // per_block) * stacks
        # the most warps whose grid still fills the card
        fills = sched.blocks >= common.NUM_SMS
        assert fills or sched.warps == 1
        if sched.warps < 8:
            more = 2 * sched.warps
            assert -(-b // (more * sched.rows_per_warp)) * stacks \
                < common.NUM_SMS


@pytest.mark.parametrize("m", [0, 3, 3 * common.STRUCTURED_BLOCK_MAX_DPAD // 2])
def test_structured_schedule_rejects_bad_sizes(m):
    with pytest.raises(ValueError, match="power of two"):
        common.structured_schedule(m, 64, 1)


# d_pad -> the split path's passes (log2 sizes): the run pass's 1024
# points, then at most 32 points at a stride a thread, as even as they come
@pytest.mark.parametrize("m,passes", [
    (16384, (10, 4)),           # d 9000
    (32768, (10, 5)),
    (65536, (10, 3, 3)),        # d 40000
    (2 ** 21, (10, 4, 4, 3)),
])
def test_structured_schedule_split_path(m, passes):
    sched = common.structured_schedule(m, 64, 3)
    assert sched.wide and sched.passes == passes
    assert sum(passes) == m.bit_length() - 1
    assert all(p <= common.STRUCTURED_PASS_MAX_LG for p in passes[1:])
    assert sched.blocks == m // 8192 * 64 * 3     # the run pass, a slot
    for b, m_rows in ((5, 5), (10 ** 6, 65535)):
        assert common.structured_split_rows(b, m, 3, 4) == min(
            m_rows, max(1, common.STRUCTURED_SCRATCH_BYTES // (4 * 12 * m)))
    assert common.structured_split_rows(3, 2 ** 30, 4, 4) == 1


def _split_butterfly(u, m):
    """The split path of kernel B8 (csrc/structured_feature.cu) on a numpy
    row, indexed as the kernel indexes it: the run pass (run r, lane l,
    register e holds point r 1024 + l + 32 e: lane stages h = 1 .. 16 by
    its lane bits, then register stages h = 32 .. 512), then each pass of
    2^k points a thread at stride 2^lo (thread q: its points
    ``split_base(q) + e 2^lo``, register stages in ascending h)."""
    v = u.astype(np.float64).copy()
    passes = common.structured_split_passes(m)
    runs = v.reshape(m // 1024, 32, 32)        # [run, e, lane]
    lane = np.arange(32)
    for k in range(5):
        partner = runs[:, :, lane ^ (1 << k)]
        runs = np.where((lane >> k) & 1, partner - runs, runs + partner)
    for hr in (1, 2, 4, 8, 16):
        e = np.arange(32)
        lo = (e & hr) == 0
        a, b = runs[:, e[lo], :].copy(), runs[:, e[lo] + hr, :].copy()
        runs[:, e[lo], :], runs[:, e[lo] + hr, :] = a + b, a - b
    v = runs.reshape(m)
    lo_bit = passes[0]
    for k in passes[1:]:
        t, n_pts = 1 << lo_bit, 1 << k
        for q in range(m // n_pts):
            base = ((q >> lo_bit) << (lo_bit + k)) + (q & (t - 1))
            idx = base + t * np.arange(n_pts)
            w = v[idx]
            hr = 1
            while hr < n_pts:
                for e in range(n_pts):
                    if not e & hr:
                        w[e], w[e + hr] = w[e] + w[e + hr], w[e] - w[e + hr]
                hr *= 2
            v[idx] = w
        lo_bit += k
    return v


@pytest.mark.parametrize("m", [16384, 65536])
def test_kernel_split_path_order_is_sylvester(m):
    """The split path's passes give the butterfly of the other paths (the
    same stages in the same ascending order, so bit for bit on floats) and
    so H u, exactly on integer inputs."""
    rng = np.random.default_rng(m)
    u = rng.integers(-4, 5, size=m).astype(np.float32)
    want = _kernel_butterfly(u, m)
    np.testing.assert_array_equal(_split_butterfly(u, m), want)
    np.testing.assert_array_equal(
        tstref.wht(torch.from_numpy(u.astype(np.float64))).numpy(), want)
    f = rng.normal(size=m)
    np.testing.assert_array_equal(_split_butterfly(f, m),
                                  _kernel_butterfly(f, m))


def test_apply_past_the_block_path_matches_reference():
    """d 9000 (d_pad 16384, past the block path's 8192): the port's plan
    and map (B8's plain version, butterflies) against the reference's
    ``make_structured_plan`` / ``apply_structured_plan`` (its dense-H
    oracle) on the same signs, shape [3, 40], within 1e-5 x max(1, max
    |ref|)."""
    kw = dict(measure="proportional", n_max=4, seed=0)
    jp = jst.make_structured_plan(JExp(1.0), 9000, 40, **kw)
    tp = tst.make_structured_plan(TExp(1.0), 9000, 40, **kw)
    _assert_same_plan(jp, tp)
    assert tp.d_pad == 16384
    jparams, tparams = _signs(jp, 6)
    x = _unit_rows(3, 9000, 7)
    try:
        want = np.asarray(jst.apply_structured_plan(
            jp, jparams, jnp.asarray(x), use_pallas=False))
    finally:
        jstref.hadamard_matrix.cache_clear()     # 1 GiB at this size
    got = tst.apply_structured_plan(tp, tparams, torch.from_numpy(x))
    assert want.shape == (3, 40) and got.shape == (3, 40)
    tol = 1e-5 * max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= tol


# ---------------------------------------------------------------------------
# the port's own draws, held by statistics
# ---------------------------------------------------------------------------
def test_signs_are_balanced():
    plan = tst.make_structured_plan(TExp(1.0), 64, 4096)
    p = tst.init_structured_params(plan, torch.Generator().manual_seed(3))
    for name in ("d1", "d2"):
        s = p[name]
        assert set(torch.unique(s).tolist()) == {-1.0, 1.0}
        # standard error 1 / sqrt(n) < 0.01 here
        assert abs(s.mean().item()) < 0.03, (name, s.mean().item())
    assert not torch.equal(p["d1"], p["d2"])


def _exp_gram(x, sigma2=1.0):
    return np.exp(x @ x.T / sigma2)


def test_mean_gram_is_unbiased_for_the_exponential_kernel():
    """Averaged over 64 seeds of the port's own draws, the Gram estimate
    approaches the exact exponential Gram (truncation at n_max 8 leaves
    < 3e-6 at |x| <= 0.8); the gap is the seed average's noise."""
    d, f = 12, 256
    x = _unit_rows(10, d, 14, radius=0.8)
    k_exact = _exp_gram(x)
    plan = tst.make_structured_plan(TExp(1.0), d, f, measure="proportional",
                                    n_max=8)
    grams = []
    for s in range(64):
        params = tst.init_structured_params(plan,
                                            torch.Generator().manual_seed(s))
        grams.append(registry.estimate_gram(
            lambda a: tst.apply_structured_plan(plan, params, a),
            torch.from_numpy(x)).numpy())
    gap = np.abs(np.mean(grams, axis=0) - k_exact).max()
    assert gap < 0.05 * np.abs(k_exact).max(), gap


def test_structured_gram_mse_leq_rm_at_matched_budget():
    """The ordering the reference pins (tests/test_structured.py:263): at
    the same budget F the structured Gram MSE on the exponential kernel is
    <= the rm one, here with the port's own draws (60 fixed seeds each)."""
    d, f, n_draws = 8, 256, 60
    x = torch.from_numpy(_unit_rows(12, d, 15, radius=0.9))
    k_exact = _exp_gram(x.numpy())
    mse = {}
    for name in ("rm", "structured"):
        est = registry.get(name)
        plan = est.make_plan(TExp(1.0), d, f, measure="proportional")
        errs = []
        for s in range(n_draws):
            params = est.init_params(plan,
                                     torch.Generator().manual_seed(1000 + s))
            g = registry.estimate_gram(
                lambda a: est.apply(plan, params, a), x).numpy()
            errs.append(np.mean((g - k_exact) ** 2))
        mse[name] = float(np.mean(errs))
    assert mse["structured"] <= mse["rm"], mse
