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
    """The transform as kernel B8 computes it, pair by pair: stage h maps
    pair p of a row to (lo, lo + h), lo = (p / h) 2h + p % h (the index
    arithmetic of csrc/structured_feature.cu, on a numpy row)."""
    v = u.astype(np.float64).copy()
    lgm = m.bit_length() - 1
    for lgh in range(lgm):
        h = 1 << lgh
        for p in range(m // 2):
            lo = ((p >> lgh) << (lgh + 1)) + (p & (h - 1))
            a, b = v[lo], v[lo + h]
            v[lo], v[lo + h] = a + b, a - b
    return v


@pytest.mark.parametrize("m", [1, 2, 8, 128, 1024])
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
    m = common.STRUCTURED_MAX_DPAD * 2
    d1 = torch.ones(1, 1, m)
    cd = torch.ones(m, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two no larger"):
        structured_feature_fused(torch.ones(2, m), d1, d1, cd,
                                 torch.ones(m))


@pytest.mark.parametrize("m,b,stacks,want", [
    (128, 64, 6, 2),       # decode: no tile fills the card, most blocks
    (128, 512, 6, 8),      # bucket 32: 8 rows (1024 elements) give 384
    (128, 4096, 6, 8),     # bucket 256 / Gram: 3072 blocks
    (16, 512, 7, 16),      # SMOKE head: 16 rows keep 256 elements a block
    (16, 64, 3, 16),       # SMOKE decode: 16 rows is the least that fills
    (1, 70, 3, 64),        # d_pad 1: 64 rows, the cap
    (1024, 70, 1, 1),      # a one-row block is already 1024 elements
    (8192, 4, 2, 1),       # the widest the kernel takes: one row
])
def test_structured_row_tile(m, b, stacks, want):
    rows = common.pick_structured_rows(m, b, stacks)
    assert rows == want
    assert rows <= 64
    assert rows * m <= max(common.STRUCTURED_TILE_ELEMS, m)
    assert rows * m <= common.STRUCTURED_MAX_DPAD


@pytest.mark.parametrize("m", [0, 3, 2 * common.STRUCTURED_MAX_DPAD])
def test_structured_row_tile_rejects_bad_sizes(m):
    with pytest.raises(ValueError, match="power of two"):
        common.pick_structured_rows(m, 64, 1)


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
