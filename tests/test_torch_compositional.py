"""Algorithm 2 in the port (repro_torch.core.compositional: the Rademacher
and RFF inner maps, CompositionalFeatureMap, make_compositional_feature_map;
repro_torch.core.static_plan) against the reference's
(repro.core.compositional, repro.core.static_plan):

* the reference's maps handed across (``repro_torch.convert``): features
  within 1e-5 x max(1, max |ref|) and the Gram estimate likewise, for
  Rademacher and RFF inner maps, stratified and not;
* the reference's three rows of tests/test_core_compositional.py on the
  port's own draws (a dot inner map recovers Algorithm 1; exp of RBF;
  output_dim and a rebuilt map);
* the Rademacher bucket is B9's plain version, bitwise (on the card each
  such bucket is one launch of kernel B9);
* ``make_plan_meta`` equal to the reference's plan, field by field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import static_plan as jstatic
import repro_torch.core as T
from repro_torch.convert import compositional_from_jax
from repro_torch.core import static_plan as tstatic
from repro_torch.kernels.rm_feature import (
    rm_feature_bucket,
    rm_feature_bucket_ref,
)


def _unit_ball(n, d, seed, shrink=1.05):
    x = np.random.default_rng(seed).normal(size=(n, d))
    return (x / (np.linalg.norm(x, axis=1, keepdims=True) * shrink)
            ).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _ref_map(kind, d, num_features, seed, **kw):
    if kind == "rademacher":
        kern = J.PolynomialKernel(4, 1.0)
        factory = lambda k, n: J.RademacherInnerMap.create(k, n, d)  # noqa
    else:
        kern = J.ExponentialDotProductKernel(1.0)
        factory = lambda k, n: J.RFFInnerMap.create(k, n, d, sigma=0.8)  # noqa
        kw.setdefault("inner_bound", 2.0)
    return J.make_compositional_feature_map(
        kern, factory, input_dim=d, num_features=num_features,
        key=jax.random.PRNGKey(seed), **kw)


CASES = [("rademacher", 8, {}), ("rademacher", 8, {"stratified": False}),
         ("rademacher", 8, {"measure": "proportional"}),
         ("rff", 6, {"measure": "proportional"}),
         ("rff", 6, {"measure": "proportional", "stratified": False})]
CASE_IDS = ["rademacher", "rademacher-iid", "rademacher-prop", "rff",
            "rff-iid"]


@pytest.mark.parametrize("kind,d,kw", CASES, ids=CASE_IDS)
def test_handed_over_maps_match_reference(kind, d, kw):
    jcfm = _ref_map(kind, d, 512, 3, **kw)
    tcfm = compositional_from_jax(jcfm)
    assert tcfm.degrees == jcfm.degrees and tcfm.counts == jcfm.counts
    assert tcfm.output_dim == jcfm.output_dim
    assert (tcfm.const is None) == (jcfm.const is None)
    x = _unit_ball(3 * 5, d, 4).reshape(3, 5, d)
    want = np.asarray(jcfm(jnp.asarray(x)))
    got = tcfm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _scaled_err(got.numpy(), want) <= 1e-5
    X, Y = _unit_ball(9, d, 5), _unit_ball(7, d, 6)
    gw = np.asarray(jcfm.estimate_gram(jnp.asarray(X), jnp.asarray(Y)))
    gg = tcfm.estimate_gram(torch.from_numpy(X), torch.from_numpy(Y))
    assert gg.shape == (9, 7) and _scaled_err(gg.numpy(), gw) <= 1e-5
    assert _scaled_err(tcfm.estimate_gram(torch.from_numpy(X)).numpy(),
                       np.asarray(jcfm.estimate_gram(jnp.asarray(X)))) <= 1e-5


@pytest.mark.parametrize("kind,d", [("rademacher", 8), ("rff", 6)])
def test_inner_maps_match_reference(kind, d):
    """One inner map batch alone: its columns and its exact kernel."""
    key = jax.random.PRNGKey(7)
    if kind == "rademacher":
        jin = J.RademacherInnerMap.create(key, 40, d)
        tin = T.RademacherInnerMap(omega=torch.from_numpy(np.array(jin.omega)))
        assert tin.bound == jin.bound == np.inf
        assert set(np.unique(np.asarray(jin.omega))) == {-1.0, 1.0}
    else:
        jin = J.RFFInnerMap.create(key, 40, d, sigma=0.7)
        tin = T.RFFInnerMap(w=torch.from_numpy(np.array(jin.w)),
                            b=torch.from_numpy(np.array(jin.b)), sigma=0.7)
        assert tin.bound == pytest.approx(jin.bound)
    X, Y = _unit_ball(6, d, 8), _unit_ball(5, d, 9)
    assert _scaled_err(tin.apply(torch.from_numpy(X)).numpy(),
                       np.asarray(jin.apply(jnp.asarray(X)))) <= 1e-5
    assert _scaled_err(
        tin.exact_kernel(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
        np.asarray(jin.exact_kernel(jnp.asarray(X), jnp.asarray(Y)))) <= 1e-5


# ---------------------------------------------------------------------------
# the reference's rows (tests/test_core_compositional.py) on the port's
# own draws
# ---------------------------------------------------------------------------
def test_compositional_with_dot_inner_recovers_algorithm1():
    """K_dp composed with the plain dot product == the dot product kernel."""
    kern = T.PolynomialKernel(4, 1.0)
    X = torch.from_numpy(_unit_ball(24, 8, 0))
    exact = kern.gram(X).numpy()
    gen = torch.Generator().manual_seed(0)
    cfm = T.make_compositional_feature_map(
        kern, lambda g, num: T.RademacherInnerMap.create(g, num, 8),
        input_dim=8, num_features=4096, generator=gen,
        measure="proportional", inner_bound=1.0)
    approx = cfm.estimate_gram(X).numpy()
    assert np.mean(np.abs(approx - exact)) / np.abs(exact).max() < 0.02


def test_compositional_exp_of_rbf():
    """K_co = exp(K_rbf(x, y)) via RFF inner maps (paper §5)."""
    dp = T.ExponentialDotProductKernel(1.0)
    X = torch.from_numpy(_unit_ball(24, 6, 1))
    gen = torch.Generator().manual_seed(1)
    inner = T.RFFInnerMap.create(gen, 1, 6, sigma=1.0)
    exact = np.exp(inner.exact_kernel(X, X).numpy())
    cfm = T.make_compositional_feature_map(
        dp, lambda g, num: T.RFFInnerMap.create(g, num, 6, sigma=1.0),
        input_dim=6, num_features=8192,
        generator=torch.Generator().manual_seed(2), measure="proportional",
        inner_bound=2.0)
    approx = cfm.estimate_gram(X).numpy()
    assert np.mean(np.abs(approx - exact)) < 0.25


def test_compositional_output_dim_and_rebuilt_map():
    dp = T.PolynomialKernel(3, 1.0)
    cfm = T.make_compositional_feature_map(
        dp, lambda g, num: T.RademacherInnerMap.create(g, num, 4),
        input_dim=4, num_features=64,
        generator=torch.Generator().manual_seed(0))
    x = torch.ones(5, 4) * 0.3
    z = cfm(x)
    assert z.shape == (5, cfm.output_dim)
    # a map rebuilt from its fields (the reference's pytree round trip)
    rebuilt = T.CompositionalFeatureMap(
        cfm.degrees, cfm.counts, list(cfm.inner_maps), list(cfm.scales),
        cfm.const, cfm.input_dim)
    assert torch.equal(rebuilt(x), z)
    assert torch.equal(cfm.to("cpu")(x), z)


def test_compositional_draws_follow_the_generator():
    """The same generator seed draws the same map; the degree seed of the
    iid allocation is drawn from the generator first."""
    def build(seed, stratified):
        return T.make_compositional_feature_map(
            T.ExponentialDotProductKernel(1.0),
            lambda g, num: T.RademacherInnerMap.create(g, num, 5), 5, 300,
            torch.Generator().manual_seed(seed), stratified=stratified)
    x = torch.from_numpy(_unit_ball(4, 5, 2))
    for stratified in (True, False):
        a, b = build(3, stratified), build(3, stratified)
        assert a.counts == b.counts and torch.equal(a(x), b(x))
    assert build(3, False).counts != build(4, False).counts or not \
        torch.equal(build(3, False)(x), build(4, False)(x))


def test_rademacher_bucket_is_b9_plain_version_bitwise():
    """Each Rademacher bucket's columns are ``rm_feature_bucket_ref`` on
    its omega rows, bit for bit (on the card: one B9 launch a bucket, the
    launch count untouched on the CPU); the const column is the const."""
    cfm = T.make_compositional_feature_map(
        T.ExponentialDotProductKernel(1.0),
        lambda g, num: T.RademacherInnerMap.create(g, num, 7), 7, 900,
        torch.Generator().manual_seed(5), measure="proportional")
    assert cfm.const is not None and len(cfm.degrees) >= 3
    x = torch.from_numpy(_unit_ball(11, 7, 3))
    before = rm_feature_bucket.launches
    z = cfm(x)
    assert rm_feature_bucket.launches == before
    assert torch.equal(z[:, 0], torch.full((11,), cfm.const))
    off = 1
    for deg, cnt, inner, scale in zip(cfm.degrees, cfm.counts,
                                      cfm.inner_maps, cfm.scales):
        want = rm_feature_bucket_ref(x, inner.omega, deg, scale)
        assert torch.equal(z[:, off: off + cnt], want)
        off += cnt
    assert off == cfm.output_dim


def test_compositional_map_on_no_rows_and_bf16_rows():
    cfm = T.make_compositional_feature_map(
        T.PolynomialKernel(3, 1.0),
        lambda g, num: T.RademacherInnerMap.create(g, num, 4), 4, 64,
        torch.Generator().manual_seed(0))
    assert cfm(torch.zeros(0, 4)).shape == (0, cfm.output_dim)
    x = torch.from_numpy(_unit_ball(3, 4, 1))
    zb = cfm(x.to(torch.bfloat16))
    assert zb.dtype == torch.float32
    assert torch.equal(zb, cfm(x.to(torch.bfloat16).float()))


@pytest.mark.parametrize("kw", [{}, {"measure": "geometric"},
                                {"n_max": 8, "stratified": False, "seed": 5}])
def test_make_plan_meta_equals_reference(kw):
    jp = jstatic.make_plan_meta(J.ExponentialDotProductKernel(1.0), 16, 256,
                                **kw)
    tp = tstatic.make_plan_meta(T.ExponentialDotProductKernel(1.0), 16, 256,
                                **kw)
    assert tstatic.PlanMeta is T.FeaturePlan
    assert tuple(tp) == tuple(jp)
    assert tp.to_json() == jp.to_json()
    assert tstatic.plan_output_dim(tp) == jstatic.plan_output_dim(jp)
    omegas = tstatic.init_omegas(tp, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_unit_ball(3, 16, 0))
    assert tstatic.apply_plan(tp, omegas, x).shape == (3, tp.output_dim)
