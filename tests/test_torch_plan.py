"""The port's feature plan equals the reference's (repro_torch.core.plan vs
repro.core.plan): the same host-side numpy arithmetic, so degrees, counts,
scales and column vectors must be EXACTLY equal, the JSON must cross both
ways, and pack_omegas on the reference's omegas must be bit-exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import plan as jplan
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro_torch.configs import get_config
from repro_torch.core import plan as tplan
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp
from repro_torch.models.attention import rm_plan_for


def _assert_same_plan(a, b):
    assert tuple(a) == tuple(b)          # every field, exact
    np.testing.assert_array_equal(a.column_degrees(), b.column_degrees())
    np.testing.assert_array_equal(a.column_scales(), b.column_scales())
    assert a.output_dim == b.output_dim
    assert a.max_degree == b.max_degree


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_qwen3_rm_plan_equals_reference(smoke):
    jcfg = jax_get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm")
    tcfg = get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm")
    dh = tcfg.resolved_head_dim
    assert dh == jcfg.resolved_head_dim
    _assert_same_plan(jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh))


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_plan_json_crosses_both_ways(smoke):
    jcfg = jax_get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm")
    tcfg = get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm")
    dh = tcfg.resolved_head_dim
    jp, tp = jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh)
    _assert_same_plan(tplan.FeaturePlan.from_json(jp.to_json()), tp)
    _assert_same_plan(jplan.FeaturePlan.from_json(tp.to_json()), jp)


# Beyond the qwen3 plans: the H0/1 block, the iid (Algorithm 1) sampler and
# the paper's geometric measure all go through the same allocation code.
@pytest.mark.parametrize("h01,stratified,measure", [
    (False, True, "proportional"),
    (False, False, "geometric"),
    (True, True, "geometric"),
    (True, False, "proportional"),
])
def test_plan_variants_equal_reference(h01, stratified, measure):
    kw = dict(measure=measure, h01=h01, stratified=stratified, n_max=6,
              seed=3)
    a = jplan.make_feature_plan(JExp(0.7), 12, 40, **kw)
    b = tplan.make_feature_plan(TExp(0.7), 12, 40, **kw)
    _assert_same_plan(a, b)


@pytest.mark.parametrize("h01", [False, True])
def test_pack_omegas_bit_exact_on_reference_omegas(h01):
    kw = dict(measure="proportional", h01=h01, n_max=5)
    jp = jplan.make_feature_plan(JExp(1.0), 16, 48, **kw)
    tp = tplan.make_feature_plan(TExp(1.0), 16, 48, **kw)
    om = np.array(jplan.init_omegas(jp, jax.random.PRNGKey(4)))
    want = np.asarray(jplan.pack_omegas(jp, om))
    got = tplan.pack_omegas(tp, torch.from_numpy(om)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h01", [False, True])
def test_flat_apply_matches_reference(h01):
    """Tolerance 1e-5: both are fp32 matmuls plus segmented products; only
    the summation order of the projection differs."""
    import jax.numpy as jnp

    kw = dict(measure="proportional", h01=h01, n_max=5)
    jp = jplan.make_feature_plan(JExp(1.0), 16, 48, **kw)
    tp = tplan.make_feature_plan(TExp(1.0), 16, 48, **kw)
    om = np.array(jplan.init_omegas(jp, jax.random.PRNGKey(5)))
    x = np.random.default_rng(0).normal(size=(9, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    want = np.asarray(jplan._apply_plan_flat(
        jp, jnp.asarray(om), jnp.asarray(x), jnp.float32, jnp.float32))
    got = tplan._apply_plan_flat(tp, torch.from_numpy(om),
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 1e-5)])
def test_registry_apply_matches_reference(precision, tol):
    """The "rm" entry's ``apply`` (one fused-map launch; the plain version
    on CPU) against the reference registry's jnp path on the same omegas:
    within 1e-5 for both policies, since each rounds x (and the exact +-1
    omegas) to the policy's dtype and accumulates in fp32."""
    from repro.core import registry as jreg
    from repro_torch.core import registry

    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    tcfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    dh = tcfg.resolved_head_dim
    jp, tp = jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh)
    om = np.array(jplan.init_omegas(jp, jax.random.PRNGKey(6)))
    x = np.random.default_rng(1).normal(size=(3, 5, dh)).astype(np.float32)
    want = np.asarray(jreg.get("rm").apply(
        jp, {"omegas": om}, x, use_pallas=False, precision=precision))
    got = registry.get("rm").apply(tp, {"omegas": torch.from_numpy(om)},
                                   torch.from_numpy(x), precision=precision)
    assert got.shape == want.shape == (3, 5, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_registry_rm_entry_and_unknown_names():
    from repro_torch.core import registry

    est = registry.get("rm")
    assert est.fused_attention_supported and est.pack_fused is not None
    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator().manual_seed(0)
    params = est.init_params(plan, gen)
    om = params["omegas"]
    assert om.shape == (plan.total_rows, plan.input_dim)
    assert set(torch.unique(om).tolist()) <= {-1.0, 1.0}
    w, cd, cs = est.pack_fused(plan, params)
    assert w.shape == (plan.max_degree, est.output_dim(plan),
                       plan.input_dim)
    assert cd.dtype == torch.int32 and cs.dtype == torch.float32
    np.testing.assert_array_equal(cd.numpy(), plan.column_degrees())
    np.testing.assert_array_equal(cs.numpy(), plan.column_scales())
    for name in ("ctr", "structured"):     # ported: they resolve
        assert registry.get(name).name == name
    with pytest.raises(KeyError, match="available: \\('ctr', 'rm', "
                                       "'structured', 'tensor_sketch'\\)"):
        registry.get("nope")


def test_other_archs_raise_not_implemented():
    # every reference arch resolves; rm is refused where nothing attends
    assert get_config("jamba-v0.1-52b").mamba is not None
    with pytest.raises(ValueError, match="attention-free"):
        get_config("xlstm-350m", attention_mode="rm")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_config("qwen3-1.7b", attention_mode="rm")
    assert dataclasses.asdict(cfg)["rm"]["num_features"] == 256
