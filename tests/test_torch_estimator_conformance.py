"""The registry-wide estimator conformance suite, ported
(tests/test_estimator_conformance.py's rows that need no growth): ONE
parametrized contract over every family of the port's registry ("rm",
"tensor_sketch", "ctr", "structured"), each row held against the
reference's registry on the same plan and the same draws handed across:

  * ``apply`` produces ``output_dim(plan)`` columns, batch dims kept;
  * plans are hashable and equal when built twice (usable as cache keys,
    as the reference's ride through jit as static arguments);
  * ``to_json`` / ``from_json`` is a lossless round trip;
  * the port's plain path (the kernels' plain versions on the CPU) within
    1e-5 of the reference's oracle (``use_pallas=False``);
  * the fused-attention capability contract, and the fused causal op
    against featurize-then-attend for the capable family;
  * ``truncation_bias`` monotone non-increasing in n_max, and (near-)zero
    for a polynomial the plan covers;
  * the five edge rows: batch 0, d 1, a single tile, n_max 1, strided
    inputs and uneven row chunks.

and the reference's growth rows (``core.doubling``): the raw prefix
bitwise across ``grow()`` and path independent, the scaled output the raw
times ``1/sqrt(G)``, ``eps_at`` tightening with every doubling and
``estimate_gram`` the scaled features' Gram (against the reference's map
handed across, within 1e-5), the JSON round trip, and the generation
layout: a G-generation map's raw features are generation g's draws by the
keying rule, concatenated (the contract shards will reuse; the reference
holds it against its S = G shard draw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.core import ExponentialDotProductKernel as JExp
from repro.core import PolynomialKernel as JPoly
from repro.core import registry as jreg
from repro_torch.core import ExponentialDotProductKernel as TExp
from repro_torch.core import PolynomialKernel as TPoly
from repro_torch.core import registry

ESTIMATORS = registry.list_estimators()
JKERN, TKERN = JExp(1.0), TExp(1.0)


def test_port_registry_lists_the_reference_families():
    assert ESTIMATORS == tuple(jreg.list_estimators()) == (
        "ctr", "rm", "structured", "tensor_sketch")
    assert all(registry.get(n) is registry.get(n) for n in ESTIMATORS)
    with pytest.raises(KeyError, match="available"):
        registry.get("nope")


def _build(name, *, input_dim=10, num_features=192, **kw):
    """The reference's plan and draws, and the port's: its own plan (equal
    to the reference's field by field) and the reference's params."""
    kw.setdefault("measure", "proportional")
    kw.setdefault("seed", 0)
    jest, est = jreg.get(name), registry.get(name)
    jplan = jest.make_plan(JKERN, input_dim, num_features, **kw)
    plan = est.make_plan(TKERN, input_dim, num_features, **kw)
    assert tuple(plan) == tuple(jplan)
    jparams = jest.init_params(jplan, jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return jest, jplan, jparams, est, plan, params


def _x(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _matches_reference(jest, jplan, jparams, est, plan, params, x):
    want = jest.apply(jplan, jparams, jnp.asarray(x), use_pallas=False)
    got = est.apply(plan, params, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    return got


@pytest.mark.parametrize("name", ESTIMATORS)
def test_apply_shape_matches_output_dim(name):
    _, _, _, est, plan, params = _build(name)
    x = torch.from_numpy(_x(1, (7, 10)))
    z = est.apply(plan, params, x)
    assert z.shape == (7, est.output_dim(plan))
    assert torch.isfinite(z).all()
    z3 = est.apply(plan, params, x.reshape(7, 1, 10))
    assert z3.shape == (7, 1, est.output_dim(plan))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_plan_hashable_and_equal_when_built_twice(name):
    _, _, _, est, plan, params = _build(name)
    _, _, _, _, plan2, _ = _build(name)
    assert plan == plan2 and plan is not plan2
    assert hash(plan) == hash(plan2)
    cache = {plan: "first"}
    assert cache[plan2] == "first"              # one cache entry for both
    x = torch.from_numpy(_x(2, (4, 10)))
    assert torch.equal(est.apply(plan, params, x),
                       est.apply(plan2, params, x))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_plan_json_round_trip(name):
    _, jplan, _, _, plan, _ = _build(name, seed=1234)
    rt = type(plan).from_json(plan.to_json())
    assert rt == plan and hash(rt) == hash(plan)
    assert rt.seed == 1234
    # and across packages, both ways
    assert plan.to_json() == jplan.to_json()
    assert type(plan).from_json(jplan.to_json()) == plan


@pytest.mark.parametrize("name", ESTIMATORS)
def test_plain_path_matches_reference_oracle(name):
    """The reference's Pallas row (interpret mode against its oracle) in
    the port: the port's CPU path against the reference's oracle, 1e-5."""
    case = _build(name)
    _matches_reference(*case, _x(3, (9, 10), 0.25))


# which families carry the fused featurize+attention capability
_EXPECTED_FUSED_ATTENTION = {"rm": True, "tensor_sketch": False,
                             "ctr": False, "structured": False}


@pytest.mark.parametrize("name", ESTIMATORS)
def test_fused_attention_capability_contract(name):
    """``fused_attention_supported`` and ``pack_fused`` travel together, as
    in the reference, and the packed tensors have the layout the fused
    attention kernels take: w [max_degree, F, d], per-column degree <=
    max_degree, finite scales."""
    jest, _, _, est, plan, params = _build(name)
    assert est.fused_attention_supported == _EXPECTED_FUSED_ATTENTION[name]
    assert est.fused_attention_supported == jest.fused_attention_supported
    if not est.fused_attention_supported:
        assert est.pack_fused is None
        return
    w, col_deg, col_scale = est.pack_fused(plan, params)
    assert w.ndim == 3 and w.shape[2] == 10
    assert col_deg.shape == (w.shape[1],) and col_scale.shape == (w.shape[1],)
    assert col_deg.dtype == torch.int32 and col_scale.dtype == torch.float32
    assert 0 <= int(col_deg.min()) and int(col_deg.max()) <= w.shape[0]
    assert torch.isfinite(col_scale).all()


@pytest.mark.parametrize("name", ESTIMATORS)
def test_fused_attention_matches_two_launch(name):
    """For the capable family the fused causal op over the packed tensors
    equals featurize-then-attend within 1e-5; the other families are the
    ones the model layers route to the two-launch path."""
    from repro_torch.kernels.rm_attention import (
        rm_attention_causal,
        rm_attention_fused_causal,
    )

    _, _, _, est, plan, params = _build(name)
    if not est.fused_attention_supported:
        assert est.pack_fused is None      # the two-launch path, by contract
        return
    w, col_deg, col_scale = est.pack_fused(plan, params)
    b, h, t, dv = 1, 2, 24, 6
    q = torch.from_numpy(_x(21, (b, h, t, 10)))
    k = torch.from_numpy(_x(22, (b, h, t, 10)))
    v = torch.from_numpy(_x(23, (b, h, t, dv), 1.0))
    got = rm_attention_fused_causal(q, k, v, w, col_deg, col_scale, chunk=8)
    z = est.apply(plan, params, torch.cat([q, k], dim=0))
    want = rm_attention_causal(z[:b], z[b:], v, chunk=8)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", ESTIMATORS)
def test_truncation_bias_monotone_in_n_max(name):
    est = registry.get(name)
    biases = []
    for n_max in (4, 8, 12, 16):
        plan = est.make_plan(TKERN, 8, 512, measure="proportional",
                             n_max=n_max, seed=0)
        biases.append(est.truncation_bias(plan, 1.0))
    assert all(b >= 0.0 for b in biases)
    assert biases[-1] > 0.0
    for lo, hi in zip(biases[1:], biases[:-1]):
        assert lo <= hi + 1e-12, biases


@pytest.mark.parametrize("name", ESTIMATORS)
def test_truncation_bias_zero_radius_and_poly(name):
    """Finite-series kernels covered by n_max report (near-)zero bias, as
    the reference's do on the same plan."""
    est, jest = registry.get(name), jreg.get(name)
    plan = est.make_plan(TPoly(3, 1.0), 6, 256, measure="proportional",
                         n_max=8, seed=0)
    jplan = jest.make_plan(JPoly(3, 1.0), 6, 256, measure="proportional",
                           n_max=8, seed=0)
    assert est.truncation_bias(plan, 1.0) == pytest.approx(0.0, abs=1e-12)
    assert est.truncation_bias(plan, 1.0) == jest.truncation_bias(jplan, 1.0)


# ---------------------------------------------------------------------------
# the edge rows, each held against the reference's oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ESTIMATORS)
def test_edge_batch_zero(name):
    _, _, _, est, plan, params = _build(name)
    z = est.apply(plan, params, torch.zeros(0, 10))
    assert z.shape == (0, est.output_dim(plan))
    z3 = est.apply(plan, params, torch.zeros(2, 0, 10))
    assert z3.shape == (2, 0, est.output_dim(plan))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_edge_input_dim_one(name):
    case = _build(name, input_dim=1, num_features=32)
    _matches_reference(*case, _x(11, (5, 1)))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_edge_single_tile(name):
    case = _build(name, input_dim=4, num_features=8)
    _matches_reference(*case, _x(12, (8, 4)))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_edge_max_degree_one(name):
    case = _build(name, num_features=48, n_max=1)
    assert case[4].max_degree <= 1
    _matches_reference(*case, _x(13, (6, 10)))


@pytest.mark.parametrize("name", ESTIMATORS)
def test_edge_noncontiguous_and_uneven_chunks(name):
    """Strided inputs and uneven row chunks agree with the contiguous
    single-shot application (1e-6), which agrees with the reference."""
    case = _build(name)
    _, _, _, est, plan, params = case
    X = torch.from_numpy(_x(14, (33, 10)))
    strided = X[::2]
    assert not strided.is_contiguous()
    ref = est.apply(plan, params, strided.contiguous())
    got = est.apply(plan, params, strided)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    full = _matches_reference(*case, X.numpy())
    chunked = registry.featurize_chunked(
        lambda Z: est.apply(plan, params, Z), X, row_chunk=5)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# progressive growth (core.doubling): every family doubles its budget
# without redrawing
# ---------------------------------------------------------------------------
from repro.core import make_growable_feature_map as jax_growable  # noqa: E402
from repro_torch.convert import growable_from_jax  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GrowableFeatureMap,
    make_growable_feature_map,
)
from repro_torch.core.doubling import generation_generator  # noqa: E402


def _growable(name, **kw):
    kw.setdefault("base_features", 48)
    kw.setdefault("measure", "proportional")
    return make_growable_feature_map(TKERN, 10, 5, estimator=name,
                                     device="cpu", **kw)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_growth_prefix_bit_identical(name):
    gm = _growable(name)
    X = torch.from_numpy(_x(6, (5, 10)))
    raw1 = gm.apply(X, rescale=False)
    g2 = gm.grow()
    g4 = g2.grow()
    assert (g2.n_generations, g4.n_generations) == (2, 4)
    raw2, raw4 = g2.apply(X, rescale=False), g4.apply(X, rescale=False)
    assert raw2.shape[1] == 2 * raw1.shape[1]
    assert torch.equal(raw2[:, :raw1.shape[1]], raw1)
    assert torch.equal(raw4[:, :raw2.shape[1]], raw2)
    assert torch.equal(gm.grow_to_generations(4).apply(X, rescale=False),
                       raw4)
    _close(g4.apply(X).numpy(), raw4.numpy() / np.sqrt(4.0), 1e-6)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_growth_eps_monotone_and_gram(name):
    """eps_at tightens with every doubling; on the reference's map handed
    across at G = 4, estimate_gram equals the reference's and the scaled
    features' Gram within 1e-5."""
    gm = _growable(name)
    eps = [gm.eps_at(0.05)]
    maps = [gm]
    for _ in range(3):
        maps.append(maps[-1].grow())
        eps.append(maps[-1].eps_at(0.05))
    assert all(b < a for a, b in zip(eps, eps[1:])), eps
    jgm = jax_growable(JKERN, 10, jax.random.PRNGKey(5), estimator=name,
                       base_features=48, measure="proportional")
    jg4 = jgm.grow().grow()
    assert [jgm.eps_at(0.05), jg4.eps_at(0.05)] == [eps[0], eps[2]]
    tg4 = growable_from_jax(jg4, kernel=TKERN)
    X = _x(7, (6, 10))
    got = tg4.estimate_gram(torch.from_numpy(X))
    want = jax.jit(lambda a: jg4.estimate_gram(a, use_pallas=False))(
        jnp.asarray(X))
    _close(got.numpy(), want)
    Z = tg4.apply(torch.from_numpy(X))
    _close(got.numpy(), (Z @ Z.T).numpy())


@pytest.mark.parametrize("name", ESTIMATORS)
def test_growth_json_round_trip(name):
    gm = _growable(name).grow_to_generations(3)
    rt = GrowableFeatureMap.from_json(gm.to_json(), kernel=TKERN,
                                      device="cpu")
    assert rt.n_generations == 3 and rt.plan == gm.plan
    X = torch.from_numpy(_x(8, (4, 10)))
    assert torch.equal(rt.apply(X, rescale=False), gm.apply(X, rescale=False))
    assert rt.eps_at(0.05) == pytest.approx(gm.eps_at(0.05))
    bare = GrowableFeatureMap.from_json(gm.to_json(), device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        bare.eps_at(0.05)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_growth_matches_generation_layout(name):
    """A 2-generation map's raw features are each generation's draws
    (``generation_generator(seed, g)``) applied and concatenated."""
    gm = _growable(name).grow_to_generations(2)
    est = registry.get(name)
    X = torch.from_numpy(_x(9, (3, 10)))
    want = torch.cat([est.apply(gm.plan, est.init_params(
        gm.plan, generation_generator(5, g, "cpu")), X) for g in range(2)],
        dim=-1)
    assert torch.equal(gm.apply(X, rescale=False), want)


# ---------------------------------------------------------------------------
# a family registered from outside: ``register`` and ``available``
# ---------------------------------------------------------------------------
import dataclasses  # noqa: E402

TOY = "rm_toy"


@pytest.fixture
def toy_family():
    """``rm``'s entry under a new name in both registries (the reference's
    ``register`` too, so the rows that compare with it run); both
    registries are put back as they were after the test."""
    saved = (dict(registry._ENTRIES), dict(registry._REGISTERED),
             dict(jreg._REGISTRY))
    jreg.register(dataclasses.replace(jreg.get("rm"), name=TOY))
    entry = registry.register(dataclasses.replace(registry.get("rm"),
                                                  name=TOY))
    yield entry
    for live, old in zip((registry._ENTRIES, registry._REGISTERED,
                          jreg._REGISTRY), saved):
        live.clear()
        live.update(old)


def test_register_before_the_first_build_is_kept():
    """A family registered before the built-ins are built (the lazy
    ``_entries()``) is listed beside all four of them, and ``get`` finds
    it; the registry is put back afterwards."""
    saved = dict(registry._ENTRIES), dict(registry._REGISTERED)
    toy = dataclasses.replace(registry._make_rm_entry(), name=TOY)
    try:
        registry._ENTRIES.clear()
        assert registry.register(toy) is toy
        assert not registry._ENTRIES              # nothing built yet
        assert registry.list_estimators() == tuple(sorted(ESTIMATORS +
                                                          (TOY,)))
        assert registry.get(TOY) is toy
        assert registry.get("rm").name == "rm"
    finally:
        registry._ENTRIES.clear()
        registry._ENTRIES.update(saved[0])
        registry._REGISTERED.clear()
        registry._REGISTERED.update(saved[1])
    assert registry.list_estimators() == ESTIMATORS


def test_registered_family_listed_and_resolved(toy_family):
    names = registry.list_estimators()
    assert names == tuple(sorted(ESTIMATORS + (TOY,)))
    assert registry.available is registry.list_estimators
    assert registry.available() == names == tuple(jreg.available())
    assert registry.get(TOY) is toy_family
    assert registry.get(TOY).fused_attention_supported
    # replacing an entry under its name
    again = registry.register(dataclasses.replace(toy_family))
    assert registry.get(TOY) is again and again is not toy_family


# the conformance rows above, each run over the registered family
_TOY_ROWS = [test_apply_shape_matches_output_dim,
             test_plan_hashable_and_equal_when_built_twice,
             test_plan_json_round_trip,
             test_plain_path_matches_reference_oracle,
             test_fused_attention_matches_two_launch,
             test_truncation_bias_monotone_in_n_max,
             test_truncation_bias_zero_radius_and_poly,
             test_edge_batch_zero, test_edge_single_tile,
             test_edge_noncontiguous_and_uneven_chunks]


@pytest.mark.parametrize("row", _TOY_ROWS, ids=lambda f: f.__name__[5:])
def test_registered_family_passes_the_conformance_rows(toy_family, row):
    """Everything that iterates ``list_estimators()`` picks the registered
    family up: the conformance rows and the sharded estimator."""
    assert TOY in registry.list_estimators()
    row(TOY)


def test_registered_family_through_the_sharded_estimator(toy_family):
    from repro_torch.distributed import estimator as dest

    plan = registry.get(TOY).make_plan(TKERN, 10, 64,
                                       measure="proportional", seed=0)
    params = dest.shard_init_params(TOY, plan, 3, 2, device="cpu")
    rm_params = dest.shard_init_params("rm", plan, 3, 2, device="cpu")
    x = torch.from_numpy(_x(31, (5, 10)))
    got = dest.sharded_apply(TOY, plan, params, x, None)
    assert got.shape == (5, 2 * registry.get(TOY).output_dim(plan))
    assert torch.equal(got, dest.sharded_apply("rm", plan, rm_params, x,
                                               None))
