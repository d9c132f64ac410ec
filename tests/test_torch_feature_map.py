"""The paper's library path in the port (repro_torch.core: the kernel zoo,
bounds, make_feature_map / RMFeatureMap, the truncated map, the family map
objects; repro_torch.data) against the reference's (repro.core,
repro.data):

* the zoo's coefficients, closed forms and bounds equal the reference's
  exactly (the same float64 host arithmetic), its Gram within 1e-6
  relative (fp32 products in another order);
* plans and their JSON equal the reference's bit for bit for every zoo
  kernel, measure, H0/1 and eps/delta budget;
* on the reference's plans and draws handed across, the port's fused,
  flat and per-bucket paths (B1's and B9's plain versions) within 1e-5 x
  max(1, max |ref|) of the reference's fused jnp path and of its per-bucket
  path through the real Pallas kernel B9 in interpret mode; the three
  family map objects within 1e-5 (features) and 1e-4 (Gram);
* the port's own draws held by statistics: the cases of
  tests/test_core_feature_map.py and tests/test_statistical_bounds.py,
  re-run on maps drawn from torch.Generators.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import repro.core as J
from repro.core import bounds as jbounds
from repro.kernels.rm_feature import (
    apply_feature_map_bucketed as jax_bucketed,
)
import repro_torch.core as T
from repro_torch.core import bounds as tbounds
from repro_torch.core import registry
from repro_torch.core.feature_map import RMFeatureMap
from repro_torch.core.plan import FeaturePlan, _apply_plan_flat
from repro_torch.ctr import CtrFeatureMap, CtrPlan
from repro_torch.data import (
    UCI_LIKE_SPECS,
    make_classification_dataset,
    unit_ball_points,
)
from repro_torch.kernels.rm_feature import (
    apply_feature_map,
    apply_feature_map_bucketed,
    rm_feature_bucket,
)
from repro_torch.sketch import SketchFeatureMap, SketchPlan
from repro_torch.structured import StructuredFeatureMap, StructuredPlan

ROOT = Path(__file__).resolve().parent.parent

# (reference kernel, port kernel) pairs: every class of the zoo
ZOO = [
    (J.HomogeneousPolynomialKernel(3), T.HomogeneousPolynomialKernel(3)),
    (J.HomogeneousPolynomialKernel(10), T.HomogeneousPolynomialKernel(10)),
    (J.PolynomialKernel(7, 1.0), T.PolynomialKernel(7, 1.0)),
    (J.PolynomialKernel(10, 1.0), T.PolynomialKernel(10, 1.0)),
    (J.PolynomialKernel(3, 0.5), T.PolynomialKernel(3, 0.5)),
    (J.ExponentialDotProductKernel(1.0), T.ExponentialDotProductKernel(1.0)),
    (J.ExponentialDotProductKernel(0.5), T.ExponentialDotProductKernel(0.5)),
    (J.VovkRealKernel(4), T.VovkRealKernel(4)),
    (J.VovkInfiniteKernel(), T.VovkInfiniteKernel()),
    (J.MaclaurinKernel(coef_fn=lambda n: 1.0 / (n + 1) ** 2, label="inv2"),
     T.MaclaurinKernel(coef_fn=lambda n: 1.0 / (n + 1) ** 2, label="inv2")),
]
ZOO_IDS = [j.name for j, _ in ZOO]
# the reference's parity grid (tests/test_rm_feature_fused.py)
GRID = [ZOO[5], ZOO[2], ZOO[0], ZOO[7]]     # exp, poly7, homog3, vovk_real4
GRID_IDS = [j.name for j, _ in GRID]


def _unit_ball(n, d, seed, shrink=1.05):
    x = np.random.default_rng(seed).normal(size=(n, d))
    return (x / (np.linalg.norm(x, axis=1, keepdims=True) * shrink)
            ).astype(np.float32)


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _port_rm_map(jfm) -> RMFeatureMap:
    """The reference map's plan (through its JSON) and omegas, handed
    across."""
    return RMFeatureMap(plan=FeaturePlan.from_json(jfm.plan.to_json()),
                        omegas=torch.from_numpy(np.array(jfm.omegas)))


# ---------------------------------------------------------------------------
# the kernel zoo and the bounds: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", ZOO, ids=ZOO_IDS)
def test_zoo_coefficients_and_closed_forms_equal_reference(pair):
    jk, tk = pair
    assert jk.name == tk.name and jk.radius == tk.radius
    np.testing.assert_array_equal(jk.coefs(30), tk.coefs(30))
    xs = np.linspace(-0.45, 0.45, 19)
    for fn in ("f", "fprime", "series_eval"):
        np.testing.assert_array_equal(np.asarray(getattr(jk, fn)(xs)),
                                      np.asarray(getattr(tk, fn)(xs)))
    assert float(jk.f(0.3)) == float(tk.f(0.3))
    assert float(jk.fprime(0.3)) == float(tk.fprime(0.3))


@pytest.mark.parametrize("pair", ZOO, ids=ZOO_IDS)
def test_zoo_gram_on_tensors_matches_reference(pair):
    """Tolerance 1e-6 relative to max(1, max |K|): fp32 inner products in
    another order, then the same closed form."""
    jk, tk = pair
    X, Y = _unit_ball(9, 6, 0, 1.5), _unit_ball(7, 6, 1, 1.5)
    want = np.asarray(jk.gram(jnp.asarray(X), jnp.asarray(Y)))
    got = tk.gram(torch.from_numpy(X), torch.from_numpy(Y))
    assert got.dtype == torch.float32 and got.shape == (9, 7)
    assert _scaled_err(got.numpy(), want) <= 1e-6
    sym = tk.gram(torch.from_numpy(X))
    assert torch.equal(sym, sym.T)


@pytest.mark.parametrize("pair", ZOO, ids=ZOO_IDS)
def test_self_gram_is_bitwise_symmetric_under_a_skewed_matmul(pair,
                                                              monkeypatch):
    """``gram(X)`` is symmetric bit for bit whatever order the BLAS sums
    in: here a product that comes back 1 ulp high above its diagonal (as
    an asymmetric summation order may) still gives ``K == K.T`` exactly,
    within 1e-6 of the reference's Gram."""
    real = torch.Tensor.__matmul__

    def skewed(a, b):
        out = real(a, b)
        if out.dim() == 2 and out.shape[0] == out.shape[1]:
            upper = torch.ones_like(out, dtype=torch.bool).triu(1)
            out = torch.where(upper, torch.nextafter(
                out, torch.full_like(out, float("inf"))), out)
        return out

    monkeypatch.setattr(torch.Tensor, "__matmul__", skewed)
    monkeypatch.setattr(torch, "matmul", skewed)
    jk, tk = pair
    X = _unit_ball(9, 6, 0, 1.5)
    assert not torch.equal(torch.from_numpy(X) @ torch.from_numpy(X).T,
                           (torch.from_numpy(X) @ torch.from_numpy(X).T).T)
    K = tk.gram(torch.from_numpy(X))
    assert torch.equal(K, K.T)
    want = np.asarray(jk.gram(jnp.asarray(X)))
    assert _scaled_err(K.numpy(), want) <= 1e-6


def test_kernel_from_name_and_validation_match_reference():
    for name, kw in (("exp", {"sigma2": 2.0}), ("poly", {"degree": 4}),
                     ("homogeneous", {"degree": 2}), ("vovk_real", {}),
                     ("vovk_infinite", {})):
        assert J.kernel_from_name(name, **kw).name == \
            T.kernel_from_name(name, **kw).name
    with pytest.raises(ValueError, match="unknown"):
        T.kernel_from_name("rbf")
    bad = T.MaclaurinKernel(coef_fn=lambda n: -1.0 if n == 2 else 1.0)
    with pytest.raises(ValueError, match="negative Maclaurin"):
        bad.validate_positive_definite()
    for cls, kw in ((T.HomogeneousPolynomialKernel, {"degree": 0}),
                    (T.PolynomialKernel, {"r": -1.0}),
                    (T.ExponentialDotProductKernel, {"sigma2": 0.0})):
        with pytest.raises(ValueError):
            cls(**kw)


BOUND_KERNELS = {
    "exp": (J.ExponentialDotProductKernel(1.0),
            T.ExponentialDotProductKernel(1.0)),
    "poly": (J.PolynomialKernel(3, 1.0), T.PolynomialKernel(3, 1.0)),
    "homog": (J.HomogeneousPolynomialKernel(2),
              T.HomogeneousPolynomialKernel(2)),
}


@pytest.mark.parametrize("measure", ["geometric", "proportional"])
@pytest.mark.parametrize("kname", sorted(BOUND_KERNELS))
def test_bounds_equal_reference_on_roundtrip_grid(kname, measure):
    """tests/test_bounds_roundtrip.py's grid, every calculator: exactly
    equal (the same float64 arithmetic)."""
    jk, tk = BOUND_KERNELS[kname]
    jc = jbounds.constants_for(jk, 0.5, 8)
    tc = tbounds.constants_for(tk, 0.5, 8)
    assert tuple(getattr(jc, f) for f in ("radius", "dim", "p", "c_omega",
                                          "c_proportional", "lipschitz")) \
        == tuple(getattr(tc, f) for f in ("radius", "dim", "p", "c_omega",
                                          "c_proportional", "lipschitz"))
    for eps, delta in ((0.1, 0.05), (0.05, 0.01), (0.3, 0.2), (1e-3, 1e-6),
                       (10.0, 0.99), (1e6, 0.05)):
        d = jc.required_d(eps, delta, measure)
        assert d == tc.required_d(eps, delta, measure)
        assert jbounds.uniform_failure_prob(jc, d, eps, measure) == \
            tbounds.uniform_failure_prob(tc, d, eps, measure)
        assert jbounds.pointwise_failure_prob(jc, d, eps, measure) == \
            tbounds.pointwise_failure_prob(tc, d, eps, measure)
        assert jbounds.required_num_features(jk, 0.5, 8, eps, delta,
                                             measure=measure) == \
            tbounds.required_num_features(tk, 0.5, 8, eps, delta,
                                          measure=measure)
    for eps, n_pairs in ((0.1, 136), (0.02, 10), (0.5, 1000)):
        assert jbounds.required_features_for_pairs(
            jk, 0.5, 8, eps, n_pairs, 0.05, measure=measure) == \
            tbounds.required_features_for_pairs(tk, 0.5, 8, eps, n_pairs,
                                                0.05, measure=measure)
    for d in (64, 1024):
        assert jc.eps_at(d, 0.05, measure) == tc.eps_at(d, 0.05, measure)
        assert jbounds.pairwise_eps(jk, 0.5, 8, d, 136, 0.05,
                                    measure=measure) == \
            tbounds.pairwise_eps(tk, 0.5, 8, d, 136, 0.05, measure=measure)


def test_bounds_guards_match_reference():
    with pytest.raises(ValueError, match="radius"):
        tbounds.constants_for(T.VovkInfiniteKernel(), radius=1.0, dim=4)
    with pytest.raises(ValueError, match="n_pairs"):
        tbounds.pairwise_eps(T.ExponentialDotProductKernel(), 0.5, 8, 128,
                             0, 0.05)
    with pytest.raises(ValueError, match="delta"):
        tbounds.constants_for(T.ExponentialDotProductKernel(), 0.5,
                              8).required_d(0.1, 1.0)
    c = tbounds.constants_for(T.ExponentialDotProductKernel(1.0), 1.0, 16)
    assert np.isclose(c.c_omega, 2.0 * np.e**2)
    assert np.isclose(c.c_proportional, np.e)


@pytest.mark.parametrize("pair,radius", [
    (GRID[0], 1.0), (GRID[1], 0.5), (ZOO[6], 0.8), (ZOO[7], 0.9)],
    ids=["exp", "poly7", "exp_s0.5", "vovk_real4"])
def test_truncation_degree_equals_reference(pair, radius):
    jk, tk = pair
    for eps in (1e-2, 1e-4, 1e-6):
        assert J.truncation_degree(jk, radius, eps) == \
            T.truncation_degree(tk, radius, eps)
    jfm = J.make_truncated_feature_map(jk, 6, 400, jax.random.PRNGKey(0),
                                       radius=radius, eps_trunc=1e-3)
    tfm = T.make_truncated_feature_map(tk, 6, 400,
                                       torch.Generator().manual_seed(0),
                                       radius=radius, eps_trunc=1e-3,
                                       device="cpu")
    assert tuple(tfm.plan) == tuple(jfm.plan)
    assert tfm.truncation_bias(radius) == jfm.truncation_bias(radius)


# ---------------------------------------------------------------------------
# make_feature_map: plans and JSON exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", ZOO[:9], ids=ZOO_IDS[:9])
def test_make_feature_map_plans_and_json_equal_reference(pair):
    """Every zoo kernel x measure x H0/1 (where H0/1 is defined), at a
    fixed budget and at an eps/delta budget: plans equal field for field,
    and each package's JSON loads in the other to the same plan."""
    jk, tk = pair
    gen = torch.Generator().manual_seed(0)
    radius = 0.5
    # an accuracy target of one estimator bound C = p f(p R^2): a budget
    # of hundreds to thousands of features for every kernel here
    eps = tbounds.constants_for(tk, radius, 4).c_omega
    for measure in ("geometric", "proportional"):
        for h01 in (False, True):
            if h01 and jk.coef(0) == 0.0 and jk.coef(1) == 0.0:
                continue
            for budget in ({"num_features": 192},
                           {"eps": eps, "delta": 0.1}):
                kw = dict(measure=measure, h01=h01, n_max=12, radius=radius,
                          **budget)
                jfm = J.make_feature_map(jk, 4, key=jax.random.PRNGKey(1),
                                         **kw)
                tfm = T.make_feature_map(tk, 4, key=gen, device="cpu", **kw)
                assert tuple(tfm.plan) == tuple(jfm.plan), (measure, h01,
                                                            budget)
                assert tfm.plan.to_json() == jfm.plan.to_json()
                assert FeaturePlan.from_json(jfm.plan.to_json()) == tfm.plan
                assert tfm.omegas.shape == jfm.omegas.shape
                assert tfm.output_dim == jfm.output_dim
                assert tfm.truncation_bias(radius) == \
                    jfm.truncation_bias(radius)


def test_rm_map_surface_matches_reference():
    kern = (J.ExponentialDotProductKernel(1.0),
            T.ExponentialDotProductKernel(1.0))
    jfm = J.make_feature_map(kern[0], 8, 128, jax.random.PRNGKey(0),
                             h01=True)
    tfm = _port_rm_map(jfm)
    for prop in ("degrees", "counts", "scales", "const", "h01", "h01_coefs",
                 "input_dim", "num_random", "coefs_host", "output_dim"):
        assert getattr(tfm, prop) == getattr(jfm, prop), prop
    for a, b in zip(tfm.bucket_omegas(), jfm.bucket_omegas()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.data_ptr() >= tfm.omegas.data_ptr()     # views, no copies
    assert sum(b.shape[0] for b in tfm.bucket_omegas()) == \
        tfm.plan.total_rows


# ---------------------------------------------------------------------------
# the featurize paths on handed-over draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("h01", [False, True])
@pytest.mark.parametrize("stratified", [False, True])
def test_paths_match_reference_fused_and_pallas_bucketed(pair, h01,
                                                         stratified):
    """The reference's grid (tests/test_rm_feature_fused.py:44): the port's
    fused (B1's plain version), flat and per-bucket (B9's plain version)
    paths on the reference's plan and omegas, against the reference's fused
    jnp path and its per-bucket path through the Pallas kernel B9 in
    interpret mode. Tolerance 1e-5 x max(1, max |ref|)."""
    jk, _ = pair
    if h01 and jk.coef(0) == 0.0 and jk.coef(1) == 0.0:
        pytest.skip("H0/1 undefined for homogeneous kernels (paper §6.2)")
    jfm = J.make_feature_map(jk, 24, 192, jax.random.PRNGKey(5), h01=h01,
                             stratified=stratified)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (11, 24)) * 0.25)
    want = np.asarray(jfm(jnp.asarray(x)))
    want_b = np.asarray(jax_bucketed(jfm, jnp.asarray(x), use_pallas=True,
                                     interpret=True))
    tfm = _port_rm_map(jfm)
    xt = torch.from_numpy(x)
    before = rm_feature_bucket.launches
    for got in (tfm(xt), tfm.apply(xt), apply_feature_map(tfm, xt),
                _apply_plan_flat(tfm.plan, tfm.omegas, xt),
                apply_feature_map_bucketed(tfm, xt)):
        assert got.shape == (11, jfm.output_dim)
        assert _scaled_err(got.numpy(), want) <= 1e-5
        assert _scaled_err(got.numpy(), want_b) <= 1e-5
    assert rm_feature_bucket.launches == before       # plain versions
    zb = apply_feature_map_bucketed(tfm, xt.reshape(1, 11, 24))
    assert zb.shape == (1, 11, jfm.output_dim)


@pytest.mark.parametrize("kernel,h01", [
    ("poly", False), ("poly", True), ("exp", False), ("exp", True),
    ("homogeneous", False)])
def test_bucketed_path_writes_map_in_place_like_reference(kernel, h01,
                                                          monkeypatch):
    """The port's per-bucket path assembles the map in place (no
    concatenate: ``torch.cat`` raises while it runs; the prefix columns and
    each bucket written into their columns) and equals the reference's
    per-bucket path through its plain jnp version (``use_pallas=False``),
    whose columns it concatenates: the const column (poly and exp without
    H0/1), the H0/1 block, every bucket. Tolerance 1e-5 x max(1, max
    |ref|)."""
    jk = {"poly": J.PolynomialKernel(7, 1.0),
          "exp": J.ExponentialDotProductKernel(1.0),
          "homogeneous": J.HomogeneousPolynomialKernel(4)}[kernel]
    jfm = J.make_feature_map(jk, 24, 300, jax.random.PRNGKey(7), h01=h01)
    tfm = _port_rm_map(jfm)
    x = _unit_ball(37, 24, 8)
    want = np.asarray(jax_bucketed(jfm, jnp.asarray(x), use_pallas=False))

    def no_cat(*args, **kwargs):
        raise AssertionError("the per-bucket path concatenated")

    monkeypatch.setattr(torch, "cat", no_cat)
    got = apply_feature_map_bucketed(tfm, torch.from_numpy(x))
    monkeypatch.undo()
    assert got.shape == want.shape == (37, jfm.output_dim)
    assert (tfm.plan.num_prefix_columns > 0) == (kernel != "homogeneous")
    assert _scaled_err(got.numpy(), want) <= 1e-5


def test_bucket_writes_into_given_map_columns():
    """``rm_feature_bucket(..., out=, col=)`` writes the plain version's
    bucket into columns ``[col, col + count)`` of the map, leaves the rest,
    and returns those columns (a view); a map without the rows or columns
    is refused."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 10)).astype(np.float32))
    omega = torch.from_numpy(
        (2.0 * rng.integers(0, 2, size=(12, 10)) - 1.0).astype(np.float32))
    out = torch.full((6, 9), -1.0)
    view = rm_feature_bucket(x, omega, 3, 0.5, out=out, col=2)
    want = rm_feature_bucket(x, omega, 3, 0.5)
    assert torch.equal(out[:, 2:6], want) and torch.equal(view, want)
    assert view.data_ptr() == out[:, 2:].data_ptr()
    assert (out[:, :2] == -1.0).all() and (out[:, 6:] == -1.0).all()
    with pytest.raises(ValueError, match="columns"):
        rm_feature_bucket(x, omega, 3, 0.5, out=out, col=6)
    with pytest.raises(ValueError, match="rows"):
        rm_feature_bucket(x[:5], omega, 3, 0.5, out=out, col=0)
    with pytest.raises(TypeError, match="fp32"):
        rm_feature_bucket(x, omega, 3, 0.5, out=out.double(), col=0)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_rm_apply_and_gram_match_reference(precision):
    """apply under both precision policies and estimate_gram (chunked
    across 3 row chunks) on handed-over draws. Tolerances x max(1, max
    |ref|): 1e-5 on features, 1e-4 on the Gram (sums of 250 features)."""
    jk = J.PolynomialKernel(10, 1.0)
    jfm = J.make_feature_map(jk, 57, 500, jax.random.PRNGKey(2))
    tfm = _port_rm_map(jfm)
    x = _unit_ball(40, 57, 3)
    want = np.asarray(jfm.apply(jnp.asarray(x), use_pallas=False,
                                precision=precision))
    got = tfm.apply(torch.from_numpy(x), precision=precision).numpy()
    assert _scaled_err(got, want) <= 1e-5
    want_g = np.asarray(jfm.estimate_gram(jnp.asarray(x), use_pallas=False,
                                          precision=precision))
    got_g = tfm.estimate_gram(torch.from_numpy(x), row_chunk=16,
                              precision=precision).numpy()
    assert _scaled_err(got_g, want_g) <= 1e-4


FAMILIES = [("tensor_sketch", SketchFeatureMap, SketchPlan),
            ("ctr", CtrFeatureMap, CtrPlan),
            ("structured", StructuredFeatureMap, StructuredPlan)]


@pytest.mark.parametrize("name,cls,plan_cls,h01",
                         [(*f, False) for f in FAMILIES] + [(*FAMILIES[1],
                                                             True)],
                         ids=[f[0] for f in FAMILIES] + ["ctr-h01"])
def test_family_maps_match_reference_maps(name, cls, plan_cls, h01):
    """SketchFeatureMap / CtrFeatureMap / StructuredFeatureMap on the
    reference map's plan and params: ``__call__``, ``apply`` and
    ``estimate_gram`` against the reference map's. Tolerances x max(1,
    max |ref|): 1e-5 on features, 1e-4 on the Gram."""
    jk = J.ExponentialDotProductKernel(1.0)
    jfm = J.make_feature_map(jk, 12, 256, jax.random.PRNGKey(4),
                             estimator=name, h01=h01)
    tfm = cls(plan=plan_cls.from_json(jfm.plan.to_json()),
              params={k: torch.from_numpy(np.array(v))
                      for k, v in jfm.params.items()})
    assert tuple(tfm.plan) == tuple(jfm.plan)
    assert tfm.output_dim == jfm.output_dim
    assert tfm.truncation_bias(0.7) == jfm.truncation_bias(0.7)
    x = _unit_ball(30, 12, 5)
    want = np.asarray(jfm(jnp.asarray(x)))
    for got in (tfm(torch.from_numpy(x)), tfm.apply(torch.from_numpy(x))):
        assert _scaled_err(got.numpy(), want) <= 1e-5
    got_g = tfm.estimate_gram(torch.from_numpy(x), torch.from_numpy(x[:7]),
                              row_chunk=8).numpy()
    want_g = np.asarray(jfm.estimate_gram(jnp.asarray(x), jnp.asarray(x[:7]),
                                          use_pallas=False))
    assert got_g.shape == (30, 7)
    assert _scaled_err(got_g, want_g) <= 1e-4


# ---------------------------------------------------------------------------
# make_feature_map's arguments
# ---------------------------------------------------------------------------
def test_make_feature_map_routes_estimators_through_the_registry():
    kern = T.ExponentialDotProductKernel(1.0)
    for name, cls, _ in FAMILIES + [("rm", RMFeatureMap, FeaturePlan)]:
        entry = registry.get(name)
        assert entry.make_map is not None
        fm = T.make_feature_map(kern, 6, 64, seed=0, estimator=name,
                                device="cpu")
        assert type(fm) is cls and fm.estimator == name
        z = fm(torch.from_numpy(_unit_ball(5, 6, 0)))
        assert z.shape == (5, fm.output_dim) and torch.isfinite(z).all()
        direct = entry.make_map(kern, 6, 64, torch.Generator().manual_seed(0),
                                device="cpu")
        assert type(direct) is cls


def test_make_feature_map_arguments():
    kern = T.ExponentialDotProductKernel(1.0)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(TypeError, match="key"):
        T.make_feature_map(kern, 4, 64, device="cpu")
    with pytest.raises(TypeError, match="not both"):
        T.make_feature_map(kern, 4, 64, gen, seed=1, device="cpu")
    with pytest.raises(ValueError, match="BOTH"):
        T.make_feature_map(kern, 4, key=gen, eps=0.1, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        T.make_feature_map(kern, 4, 64, gen, eps=0.1, delta=0.1,
                           device="cpu")
    with pytest.raises(ValueError, match="num_features"):
        T.make_feature_map(kern, 4, key=gen, device="cpu")
    # num_shards= (no mesh): the sharded construction's host loop
    sfm = T.make_feature_map(kern, 4, 64, seed=0, num_shards=2,
                             device="cpu")
    assert type(sfm).__name__ == "ShardedFeatureMap"
    assert sfm.num_shards == 2 and sfm.output_dim == 2 * sfm.shard_output_dim
    assert sfm.params["omegas"].shape[0] == 2
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    x = x / x.norm(dim=1, keepdim=True)
    torch.testing.assert_close(sfm.estimate_gram(x),
                               sfm.apply(x) @ sfm.apply(x).T, rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="divide evenly"):
        T.make_feature_map(kern, 4, 63, seed=0, num_shards=2, device="cpu")
    assert T.make_feature_map(kern, 4, 64, gen, precision="bf16",
                              device="cpu").omegas.dtype == torch.bfloat16
    assert T.make_feature_map(kern, 4, 64, gen, precision="bf16",
                              omega_dtype=torch.float32,
                              device="cpu").omegas.dtype == torch.float32
    fm = T.make_feature_map(kern, 4, 300, gen, stratified=False,
                            device="cpu")
    assert fm.num_random == 300 and sum(fm.counts) <= 300
    assert 0 <= fm.plan.seed < 2**31 - 1
    # the same seed gives the same map; the draws are +-1
    a = T.make_feature_map(kern, 4, 64, seed=3, device="cpu")
    b = T.make_feature_map(kern, 4, 64, seed=3, device="cpu")
    assert torch.equal(a.omegas, b.omegas)
    assert set(torch.unique(a.omegas).tolist()) <= {-1.0, 1.0}


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch.core.truncated import make_truncated_feature_map
    from repro_torch.ctr import make_ctr_feature_map
    from repro_torch.sketch import make_sketch_feature_map
    from repro_torch.structured import make_structured_feature_map

    fns = (T.make_feature_map, make_truncated_feature_map,
           make_sketch_feature_map, make_ctr_feature_map,
           make_structured_feature_map, make_classification_dataset)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    kern = T.ExponentialDotProductKernel(1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.make_feature_map(kern, 4, 64, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sketch_feature_map(kern, 4, 64, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_classification_dataset("spambase")


# ---------------------------------------------------------------------------
# the port's own draws, held by statistics (tests/test_core_feature_map.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("stratified", [False, True])
def test_gram_approximation_converges(pair, stratified):
    _, kern = pair
    X = torch.from_numpy(_unit_ball(32, 10, 42))
    exact = kern.gram(X).double()
    scale = max(1.0, exact.abs().max().item())
    errs = []
    for D in (128, 2048):
        e = 0.0
        for s in range(3):
            fm = T.make_feature_map(
                kern, 10, D, seed=7 + s, stratified=stratified,
                measure="proportional" if stratified else "geometric",
                device="cpu")
            approx = fm.estimate_gram(X).double()
            e += (approx - exact).abs().mean().item() / scale
        errs.append(e / 3.0)
    assert errs[1] < errs[0] / 1.6 or errs[1] < 0.01, errs
    assert errs[1] < 0.15, errs


@pytest.mark.parametrize("pair", GRID, ids=GRID_IDS)
def test_unbiasedness_over_map_draws(pair):
    """E over map draws of <Z(x), Z(y)> equals K(x, y) (iid mode): the
    mean of 48 maps of 256 features within the reference's 0.05 x max(1,
    max |K|). The reference averages 12 maps; the iid geometric draws of
    poly7 are heavy-tailed, and 12 of the port's maps gave 0.057 (the
    Monte-Carlo error alone, not a bias), so the port averages 4x as many
    to halve it."""
    _, kern = pair
    X = torch.from_numpy(_unit_ball(8, 6, 0))
    exact = kern.gram(X).double()
    acc = torch.zeros_like(exact)
    reps = 48
    for i in range(reps):
        fm = T.make_feature_map(kern, 6, 256, seed=100 + i, stratified=False,
                                device="cpu")
        acc += fm.estimate_gram(X).double()
    scale = max(1.0, exact.abs().max().item())
    assert (acc / reps - exact).abs().mean().item() / scale < 0.05


def test_homogeneous_h01_and_measures():
    fm = T.make_feature_map(T.HomogeneousPolynomialKernel(5), 8, 256, seed=0,
                            device="cpu")
    assert fm.degrees == (5,) and fm.counts == (256,) and fm.const is None
    with pytest.raises(ValueError, match="no-op"):
        T.make_feature_map(T.HomogeneousPolynomialKernel(4), 5, 64, seed=0,
                           h01=True, device="cpu")
    # H0/1: the degree <= 1 part of (1 + x)^2 is exact
    kern = T.PolynomialKernel(2, 1.0)
    X = torch.from_numpy(_unit_ball(16, 5, 3))
    fm = T.make_feature_map(kern, 5, 4096, seed=3, h01=True, device="cpu")
    assert (fm.estimate_gram(X) - kern.gram(X)).abs().mean() < 0.05
    z = fm(X)[:, :6]
    np.testing.assert_allclose((z @ z.T).numpy(),
                               (1.0 + 2.0 * X @ X.T).numpy(),
                               rtol=1e-4, atol=1e-4)
    for kind in ("geometric", "geometric_ge2", "proportional"):
        q = T.degree_measure(T.ExponentialDotProductKernel(1.0), 24,
                             kind=kind)
        assert abs(q.sum() - 1.0) < 1e-12 and (q >= 0).all()
    qh = T.degree_measure(T.HomogeneousPolynomialKernel(3), 24)
    assert qh[3] == 1.0


def test_truncation_monotone_and_truncated_bias_bounded():
    kern = T.ExponentialDotProductKernel(1.0)
    k1, t1 = T.truncation_degree(kern, 1.0, 1e-2)
    k2, t2 = T.truncation_degree(kern, 1.0, 1e-6)
    assert k2 > k1 and t1 <= 1e-2 and t2 <= 1e-6
    fm = T.make_truncated_feature_map(kern, 6, 2000,
                                      torch.Generator().manual_seed(0),
                                      radius=1.0, eps_trunc=1e-3,
                                      device="cpu")
    assert fm.truncation_bias(1.0) < 2e-3
    with pytest.raises(ValueError, match="tail mass"):
        T.truncation_degree(kern, 1.0, 1e-30, n_max=5)


# ---------------------------------------------------------------------------
# the port's own draws: tests/test_statistical_bounds.py at its sizes
# ---------------------------------------------------------------------------
KERN = T.ExponentialDotProductKernel(1.0)
RADIUS, DIM, N_POINTS, DELTA = 0.9, 8, 16, 0.05
D_SWEEP, MAP_SEEDS = (128, 512, 2048), (100, 101, 102)
_N_PAIRS = N_POINTS * (N_POINTS + 1) // 2


def _dataset():
    X = np.random.default_rng(0).normal(size=(N_POINTS, DIM))
    radii = np.linspace(0.3, RADIUS, N_POINTS)[:, None]
    return torch.from_numpy(
        (X / np.linalg.norm(X, axis=1, keepdims=True) * radii)
        .astype(np.float32))


def _eps_bound(num_features):
    c = tbounds.constants_for(KERN, RADIUS, DIM).c_proportional
    return math.sqrt(8.0 * c * c * math.log(2.0 * _N_PAIRS / DELTA)
                     / num_features)


def _sup_err(name, num_features, seed):
    fm = T.make_feature_map(KERN, DIM, num_features, seed=seed,
                            estimator=name, measure="proportional",
                            device="cpu")
    X = _dataset()
    return (fm.estimate_gram(X) - KERN.gram(X)).abs().max().item()


@pytest.mark.parametrize("name", registry.list_estimators())
def test_sup_error_under_eps_bound_and_shrinking(name):
    """Every seed x D under the Hoeffding + union bound eps(D); the largest
    D at half of it; 16x the features cut the mean sup error to <= 0.6x."""
    means = {}
    for D in D_SWEEP:
        errs = [_sup_err(name, D, s) for s in MAP_SEEDS]
        assert all(np.isfinite(errs))
        assert max(errs) <= _eps_bound(D), (name, D, errs)
        means[D] = np.mean(errs)
    assert means[D_SWEEP[-1]] <= 0.5 * _eps_bound(D_SWEEP[-1]), name
    assert means[D_SWEEP[-1]] <= 0.6 * means[D_SWEEP[0]], (name, means)


def test_required_d_delivers_its_eps():
    eps_target = 0.75
    c = tbounds.constants_for(KERN, RADIUS, DIM).c_proportional
    D = int(math.ceil(8.0 * c * c / eps_target**2
                      * math.log(2.0 * _N_PAIRS / DELTA)))
    for name in registry.list_estimators():
        assert _sup_err(name, D, MAP_SEEDS[0]) <= eps_target, name


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_classification_dataset_protocol():
    for name in ("nursery", "spambase"):
        ds = make_classification_dataset(name, device="cpu")
        n, d = UCI_LIKE_SPECS[name]
        n_train = int(0.6 * n)
        assert ds["x_train"].shape == (n_train, d)
        assert ds["x_test"].shape == (n - n_train, d)
        for split in ("train", "test"):
            x, y = ds[f"x_{split}"], ds[f"y_{split}"]
            assert x.dtype == torch.float32
            np.testing.assert_allclose(x.norm(dim=1).numpy(), 1.0, atol=1e-5)
            assert set(torch.unique(y).tolist()) == {-1.0, 1.0}
            assert 0.4 < (y > 0).float().mean().item() < 0.6  # median split
    a = make_classification_dataset("spambase", device="cpu")
    b = make_classification_dataset("spambase", seed=1, device="cpu")
    assert torch.equal(a["x_train"],
                       make_classification_dataset("spambase",
                                                   device="cpu")["x_train"])
    assert not torch.equal(a["x_train"], b["x_train"])
    pts = unit_ball_points(torch.Generator().manual_seed(0), 500, 5)
    assert pts.shape == (500, 5) and (pts.norm(dim=1) <= 1.0 + 1e-6).all()


def test_dataset_seed_is_stable_across_processes():
    """The seed is a digest of the name, not ``hash(name)`` (salted per
    process): two interpreters with different hash seeds give the same
    data."""
    code = ("import torch; from repro_torch.data import "
            "make_classification_dataset as m; "
            "print(float(m('nursery', device='cpu')['x_train'].sum()))")
    outs = set()
    for hash_seed in ("1", "2"):
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONHASHSEED=hash_seed,
                                  PYTHONPATH=str(ROOT / "src")))
        assert res.returncode == 0, res.stderr
        outs.add(res.stdout.strip())
    assert len(outs) == 1
