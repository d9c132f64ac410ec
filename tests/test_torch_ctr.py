"""The port's complex-to-real family (repro_torch.ctr, the "ctr" registry
entry) against the reference's (repro.ctr): plans and their JSON equal
exactly (the same host-side numpy arithmetic), ``pack_ctr`` bit-exact on
the reference's rows, kernel B7's plain version within 1e-5 of the
reference's, the map within 1e-5 of the reference's complex64 oracle in
fp32 and within the reference's ctr bf16 feature budget (5e-3,
tests/test_precision.py) in bf16, ``estimate_gram`` within 1e-4, and the
port's own draws held by statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import registry as jreg
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.ctr import plan as jct
from repro.ctr import ref as jctref
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro_torch.configs import get_config
from repro_torch.core import registry
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp
from repro_torch.ctr import plan as tct
from repro_torch.ctr import ref as tctref
from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused
from repro_torch.models.attention import rm_plan_for

BF16_FEATURE_ATOL = 5e-3      # the reference's ctr bf16 feature budget
MODELS = [("qwen3-1.7b", True), ("qwen3-1.7b", False),
          ("hubert-xlarge", False)]
MODEL_IDS = ["qwen3-SMOKE", "qwen3-FULL", "hubert-FULL"]


def _model_plans(arch, smoke):
    jcfg = jax_get_config(arch, smoke=smoke, attention_mode="rm",
                          estimator="ctr")
    tcfg = get_config(arch, smoke=smoke, attention_mode="rm",
                      estimator="ctr")
    dh = tcfg.resolved_head_dim
    return jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh)


def _assert_same_plan(a, b):
    assert tuple(a) == tuple(b)          # every field, exact
    np.testing.assert_array_equal(a.column_degrees(), b.column_degrees())
    np.testing.assert_array_equal(a.column_scales(), b.column_scales())
    for prop in ("output_dim", "num_complex", "total_rows", "max_degree",
                 "num_prefix_columns"):
        assert getattr(a, prop) == getattr(b, prop), prop


def _rows(jplan, seed):
    """The reference's complex rows, handed across through numpy."""
    p = jct.init_ctr_params(jplan, jax.random.PRNGKey(seed))
    wr, wi = np.asarray(p["wr"]), np.asarray(p["wi"])
    return ({"wr": jnp.asarray(wr), "wi": jnp.asarray(wi)},
            {"wr": torch.from_numpy(wr.copy()),
             "wi": torch.from_numpy(wi.copy())})


def _unit_rows(n, d, seed, radius=1.0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return radius * x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_model_ctr_plan_equals_reference(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    assert isinstance(tp, tct.CtrPlan)
    _assert_same_plan(jp, tp)
    assert tp.truncation_bias(1.0) == jp.truncation_bias(1.0)
    if not smoke:   # F = 1 const + 2 x 127: B5 runs at a ragged width
        assert tp.counts == (74, 37, 12, 3, 1) and tp.output_dim == 255


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_ctr_plan_json_crosses_both_ways(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    _assert_same_plan(tct.CtrPlan.from_json(jp.to_json()), tp)
    _assert_same_plan(jct.CtrPlan.from_json(tp.to_json()), jp)


@pytest.mark.parametrize("h01,measure,stratified", [
    (False, "geometric", True), (True, "geometric", True),
    (False, "proportional", True), (True, "proportional", False)])
def test_ctr_plan_variants_equal_reference(h01, measure, stratified):
    kw = dict(measure=measure, h01=h01, n_max=7, seed=5,
              stratified=stratified)
    _assert_same_plan(jct.make_ctr_plan(JExp(0.8), 12, 60, **kw),
                      tct.make_ctr_plan(TExp(0.8), 12, 60, **kw))


def test_truncation_bias_equals_reference_and_is_monotone():
    """The reference's conformance row (tests/test_estimator_conformance.py):
    non-increasing in n_max, and still positive at n_max 16 (the tail
    window)."""
    biases = []
    for n_max in (4, 8, 12, 16):
        kw = dict(measure="proportional", n_max=n_max, seed=0)
        jp = jct.make_ctr_plan(JExp(1.0), 8, 512, **kw)
        tp = tct.make_ctr_plan(TExp(1.0), 8, 512, **kw)
        assert tp.truncation_bias(1.0) == jp.truncation_bias(1.0)
        biases.append(tp.truncation_bias(1.0))
    assert biases[-1] > 0.0
    assert all(lo <= hi + 1e-12 for lo, hi in zip(biases[1:], biases)), \
        biases


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_pack_ctr_bit_exact(arch, smoke):
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _rows(jp, 1)
    for g, w in zip(tct.pack_ctr(tp, tparams), jct.pack_ctr(jp, jparams)):
        assert g.is_contiguous() and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_plain_version_matches_reference_fused_ref(arch, smoke):
    """Kernel B7's plain version against the reference's jnp mirror of its
    Pallas kernel, on the same packed rows: 1e-5."""
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _rows(jp, 2)
    x = _unit_rows(70, tp.input_dim, 3)
    jwr, jwi = jct.pack_ctr(jp, jparams)
    want = np.asarray(jctref.ctr_feature_fused_ref(
        jnp.asarray(x), jwr, jwi, jnp.asarray(jp.column_degrees()),
        jnp.asarray(jp.column_scales())))
    twr, twi = tct.pack_ctr(tp, tparams)
    got = tctref.ctr_feature_fused_ref(
        torch.from_numpy(x), twr, twi, torch.from_numpy(tp.column_degrees()),
        torch.from_numpy(tp.column_scales()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and the reference's complex64 oracle within the port
    blocks = tctref.ctr_blocks_ref(tp, tparams, torch.from_numpy(x))
    np.testing.assert_allclose(blocks.numpy(), got.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("precision,atol", [("fp32", 1e-5),
                                            ("bf16", BF16_FEATURE_ATOL)])
@pytest.mark.parametrize("arch,smoke", MODELS, ids=MODEL_IDS)
def test_apply_matches_reference_oracle(arch, smoke, precision, atol):
    """The port's map (B7's plain version) against the reference's
    complex64 oracle (``use_pallas=False``) on the same rows; batch dims
    kept. In bf16 the port rounds x and the packed rows (exact) and the
    reference rounds x."""
    jp, tp = _model_plans(arch, smoke)
    jparams, tparams = _rows(jp, 4)
    x = _unit_rows(3 * 7, tp.input_dim, 5).reshape(3, 7, -1)
    want = np.asarray(jct.apply_ctr_plan(jp, jparams, jnp.asarray(x),
                                         use_pallas=False,
                                         precision=precision))
    got = tct.apply_ctr_plan(tp, tparams, torch.from_numpy(x),
                             precision=precision)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    again = tct.apply_ctr_plan(tp, tparams, torch.from_numpy(x),
                               precision=precision,
                               packed=tct.pack_ctr(tp, tparams))
    assert torch.equal(again, got)


@pytest.mark.parametrize("h01", [False, True])
def test_apply_prefix_columns_match_reference(h01):
    kw = dict(measure="proportional", h01=h01, n_max=5)
    jp = jct.make_ctr_plan(JExp(1.0), 16, 48, **kw)
    tp = tct.make_ctr_plan(TExp(1.0), 16, 48, **kw)
    jparams, tparams = _rows(jp, 6)
    x = _unit_rows(9, 16, 7)
    want = np.asarray(jreg.get("ctr").apply(jp, jparams, jnp.asarray(x),
                                            use_pallas=False))
    got = registry.get("ctr").apply(tp, tparams, torch.from_numpy(x))
    assert got.shape == (9, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("edge", ["zero_rows", "input_dim_1",
                                  "max_degree_1", "const_only"])
def test_edges_apply_cleanly(edge):
    d, f, n_max, rows = 6, 40, 8, 5
    if edge == "zero_rows":
        rows = 0
    elif edge == "input_dim_1":
        d = 1
    elif edge == "max_degree_1":
        n_max = 1
    else:
        f = 1                   # the halved budget funds no complex column
    jp = jct.make_ctr_plan(JExp(1.0), d, f, n_max=n_max)
    tp = tct.make_ctr_plan(TExp(1.0), d, f, n_max=n_max)
    _assert_same_plan(jp, tp)
    if edge == "max_degree_1":
        assert tp.max_degree == 1
    if edge == "const_only":
        assert tp.num_complex == 0 and tp.output_dim == 1
    jparams, tparams = _rows(jp, 8)
    x = _unit_rows(max(rows, 1), d, 9)[:rows]
    want = np.asarray(jct.apply_ctr_plan(jp, jparams, jnp.asarray(x),
                                         use_pallas=False))
    got = tct.apply_ctr_plan(tp, tparams, torch.from_numpy(x))
    assert got.shape == want.shape == (rows, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_estimate_gram_matches_reference():
    """``registry.estimate_gram`` over the fused map, row-chunked, against
    the reference's over its complex64 oracle: 1e-4."""
    jp, tp = _model_plans("qwen3-1.7b", True)
    jparams, tparams = _rows(jp, 10)
    x = _unit_rows(40, tp.input_dim, 11)
    y = _unit_rows(9, tp.input_dim, 12)
    want = np.asarray(jreg.estimate_gram(
        lambda a: jreg.get("ctr").apply(jp, jparams, a, use_pallas=False),
        jnp.asarray(x), jnp.asarray(y), row_chunk=16))
    got = registry.estimate_gram(
        lambda a: registry.get("ctr").apply(tp, tparams, a),
        torch.from_numpy(x), torch.from_numpy(y), row_chunk=16)
    assert got.shape == (40, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_registry_ctr_entry():
    est = registry.get("ctr")
    assert not est.fused_attention_supported and est.pack_fused is None
    assert registry.list_estimators() == tuple(sorted(
        jreg.list_estimators()))
    _, tp = _model_plans("qwen3-1.7b", True)
    params = est.init_params(tp, torch.Generator().manual_seed(0))
    assert params["wr"].shape == params["wi"].shape == (tp.total_rows,
                                                        tp.input_dim)
    packed = est.pack(tp, params, torch.bfloat16)
    assert [t.dtype for t in packed] == [torch.bfloat16] * 2
    assert packed[0].shape == (tp.max_degree, tp.num_complex, tp.input_dim)
    for g, w in zip(packed, tct.pack_ctr(tp, params)):
        assert torch.equal(g.float(), w)            # lossless in bf16
    x = torch.from_numpy(_unit_rows(5, tp.input_dim, 13))
    assert est.apply(tp, params, x).shape == (5, est.output_dim(tp))


def test_ctr_kernel_wrapper_edges():
    _, tp = _model_plans("qwen3-1.7b", True)
    params = tct.init_ctr_params(tp, torch.Generator().manual_seed(1))
    wr, wi = tct.pack_ctr(tp, params)
    cd = torch.from_numpy(tp.column_degrees())
    cs = torch.from_numpy(tp.column_scales())
    fc = tp.num_complex
    assert ctr_feature_fused(torch.ones(0, tp.input_dim), wr, wi, cd,
                             cs).shape == (0, 2 * fc)
    before = ctr_feature_fused.launches
    out = ctr_feature_fused(torch.ones(2, 3, tp.input_dim), wr, wi, cd, cs)
    assert out.shape == (2, 3, 2 * fc)
    assert ctr_feature_fused.launches == before       # CPU: plain version
    # no slots: every column is the empty product (1, 0) times its scale
    none = ctr_feature_fused(torch.ones(4, tp.input_dim), wr[:0], wi[:0],
                             cd, cs)
    np.testing.assert_array_equal(none.numpy(), np.tile(np.concatenate(
        [tp.column_scales(), np.zeros(fc, np.float32)]), (4, 1)))
    x = torch.ones(2, tp.input_dim, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        ctr_feature_fused(x, wr, wi, cd, cs)


# ---------------------------------------------------------------------------
# the port's own draws, held by statistics
# ---------------------------------------------------------------------------
def test_draws_are_fourth_roots_of_unity_uniformly():
    plan = tct.make_ctr_plan(TExp(1.0), 64, 512)
    p = tct.init_ctr_params(plan, torch.Generator().manual_seed(3))
    z = torch.complex(p["wr"], p["wi"]).flatten()
    n = z.numel()
    for root in (1, 1j, -1, -1j):
        share = (z == root).sum().item() / n
        # binomial standard error sqrt(3/16 / n) < 2e-3 here
        assert abs(share - 0.25) < 0.01, (root, share)
    assert ((z.real.abs() + z.imag.abs()) == 1).all()


def _exp_gram(x, sigma2=1.0):
    return np.exp(x @ x.T / sigma2)


def test_mean_gram_is_unbiased_for_the_exponential_kernel():
    """Averaged over 64 seeds of the port's own draws, the Gram estimate
    approaches the exact exponential Gram (truncation at n_max 8 leaves
    < 3e-6 at |x| <= 0.8); the gap is the seed average's noise."""
    d, f = 12, 256
    x = _unit_rows(10, d, 14, radius=0.8)
    k_exact = _exp_gram(x)
    plan = tct.make_ctr_plan(TExp(1.0), d, f, measure="proportional",
                             n_max=8)
    grams = []
    for s in range(64):
        params = tct.init_ctr_params(plan, torch.Generator().manual_seed(s))
        grams.append(registry.estimate_gram(
            lambda a: tct.apply_ctr_plan(plan, params, a),
            torch.from_numpy(x)).numpy())
    gap = np.abs(np.mean(grams, axis=0) - k_exact).max()
    assert gap < 0.05 * np.abs(k_exact).max(), gap


def test_ctr_gram_mse_leq_rm_at_matched_budget():
    """The ordering the reference pins (tests/test_ctr.py): at the same
    real budget F the ctr Gram MSE on the exponential kernel is <= the rm
    one, here with the port's own draws (60 fixed seeds each)."""
    d, f, n_draws = 8, 256, 60
    x = torch.from_numpy(_unit_rows(12, d, 15, radius=0.9))
    k_exact = _exp_gram(x.numpy())
    mse = {}
    for name in ("rm", "ctr"):
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
    assert mse["ctr"] <= mse["rm"], mse
