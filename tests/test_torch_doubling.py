"""The port's growable feature map (``repro_torch.core.doubling``) against
the reference's (``repro.core.doubling``), for all four registry families.

The reference's map is handed across with
``repro_torch.convert.growable_from_jax`` (its stacked ``[G, ...]`` params
generation by generation): raw and scaled ``apply`` and ``estimate_gram``
within 1e-5 on the same numpy inputs from a seed; ``eps_at``,
``required_generations`` and the eps-mode generation count equal to the
reference's exactly (the same plan, the same bound arithmetic). Then the
port's own draws: the raw prefix bitwise equal across growth, 1 -> 4 equal
to 1 -> 2 -> 4, generation g's params a function of (seed, g) alone, and
the JSON round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.core import ExponentialDotProductKernel as JExp
from repro.core import make_growable_feature_map as jax_growable
from repro_torch.common.seeds import mix_seed
from repro_torch.convert import growable_from_jax
from repro_torch.core import ExponentialDotProductKernel as TExp
from repro_torch.core import (
    GrowableFeatureMap,
    make_growable_feature_map,
    registry,
)
from repro_torch.core.doubling import generation_generator

ESTIMATORS = registry.list_estimators()
JKERN, TKERN = JExp(1.0), TExp(1.0)
TOL = 1e-5   # fp32 sums of <= 10-term products, summed over <= 4 Grams


def _x(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _japply(jgm, X, rescale=True):
    """The reference map's apply, jitted (one compile, not op by op)."""
    return jax.jit(lambda a: jgm.apply(a, rescale=rescale,
                                       use_pallas=False))(jnp.asarray(X))


def _jgram(jgm, X, Y=None):
    fn = jax.jit(lambda a, b: jgm.estimate_gram(a, b, use_pallas=False))
    return fn(jnp.asarray(X), None if Y is None else jnp.asarray(Y))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ESTIMATORS)
def handed(request):
    """A 3-generation reference map and the port's copy of it."""
    name = request.param
    jgm = jax_growable(JKERN, 10, jax.random.PRNGKey(5), estimator=name,
                       base_features=48, measure="proportional")
    jgm = jgm.grow_to_generations(3)
    return name, jgm, growable_from_jax(jgm, kernel=TKERN)


def test_handed_map_applies_as_the_reference(handed):
    _, jgm, tgm = handed
    X = _x(0, (7, 10))
    assert tgm.n_generations == 3 and tgm.output_dim == jgm.output_dim
    assert tgm.generation_output_dim == jgm.generation_output_dim
    for rescale in (False, True):
        want = _japply(jgm, X, rescale)
        got = tgm.apply(torch.from_numpy(X), rescale=rescale)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)
    # batch dims pass through
    got3 = tgm.apply(torch.from_numpy(X.reshape(7, 1, 10)))
    assert got3.shape == (7, 1, tgm.output_dim)


def test_handed_map_gram_as_the_reference(handed):
    _, jgm, tgm = handed
    X, Y = _x(1, (6, 10)), _x(2, (4, 10))
    _close(tgm.estimate_gram(torch.from_numpy(X)).numpy(), _jgram(jgm, X))
    _close(tgm.estimate_gram(torch.from_numpy(X),
                             torch.from_numpy(Y)).numpy(),
           _jgram(jgm, X, Y))
    # the per-generation sum is the scaled features' Gram
    Z = tgm.apply(torch.from_numpy(X))
    _close(tgm.estimate_gram(torch.from_numpy(X)).numpy(), (Z @ Z.T).numpy())


def test_handed_map_bounds_equal_the_reference(handed):
    _, jgm, tgm = handed
    assert tgm.eps_at(0.05) == jgm.eps_at(0.05)
    assert tgm.eps_at(0.1, 4096) == jgm.eps_at(0.1, 4096)
    for eps, delta in ((0.5, 0.05), (2.0, 0.1), (0.25, 0.01)):
        assert tgm.required_generations(eps, delta) == \
            jgm.required_generations(eps, delta)
    assert tgm.truncation_bias(0.7) == jgm.truncation_bias(0.7)


@pytest.mark.parametrize("name", ESTIMATORS)
def test_eps_mode_generation_count_equals_reference(name):
    for eps, delta in ((4.0, 0.1), (2.0, 0.05)):
        jgm = jax_growable(JKERN, 6, jax.random.PRNGKey(0), estimator=name,
                           base_features=512, measure="proportional",
                           eps=eps, delta=delta, radius=0.7)
        tgm = make_growable_feature_map(TKERN, 6, 0, estimator=name,
                                        base_features=512,
                                        measure="proportional", eps=eps,
                                        delta=delta, radius=0.7,
                                        device="cpu")
        assert tgm.n_generations == jgm.n_generations
        assert tgm.plan == type(tgm.plan).from_json(jgm.plan.to_json())
    with pytest.raises(ValueError, match="BOTH"):
        make_growable_feature_map(TKERN, 6, 0, estimator=name, eps=1.0,
                                  device="cpu")


@pytest.mark.parametrize("name", ESTIMATORS)
def test_port_prefix_bitwise_and_path_independent(name):
    gm = make_growable_feature_map(TKERN, 10, 5, estimator=name,
                                   base_features=48,
                                   measure="proportional", device="cpu")
    X = torch.from_numpy(_x(3, (5, 10)))
    raw1 = gm.apply(X, rescale=False)
    g2, g4 = gm.grow(), gm.grow().grow()
    raw2, raw4 = g2.apply(X, rescale=False), g4.apply(X, rescale=False)
    assert torch.equal(raw2[:, :raw1.shape[1]], raw1)
    assert torch.equal(raw4[:, :raw2.shape[1]], raw2)
    direct = gm.grow_to_generations(4)
    assert torch.equal(direct.apply(X, rescale=False), raw4)
    # the prefix is the same tensors, not a redraw
    for a, b in zip(gm.params[0].values(), g4.params[0].values()):
        assert a is b
    # generation g's params are a function of (seed, g) alone
    est = registry.get(name)
    for g in range(4):
        want = est.init_params(gm.plan, generation_generator(5, g, "cpu"))
        for k, v in want.items():
            assert torch.equal(g4.params[g][k], v)
    torch.testing.assert_close(g4.apply(X), raw4 / 2.0, rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="shrink"):
        g4.grow_to_generations(2)
    with pytest.raises(ValueError, match=">= 2"):
        g4.grow(1)
    assert g4.grow_to(g4.output_dim) is g4


@pytest.mark.parametrize("name", ESTIMATORS)
def test_port_json_round_trip(name):
    gm = make_growable_feature_map(TKERN, 10, 7, estimator=name,
                                   base_features=48,
                                   measure="proportional",
                                   device="cpu").grow_to_generations(3)
    rt = GrowableFeatureMap.from_json(gm.to_json(), kernel=TKERN,
                                      device="cpu")
    assert (rt.n_generations, rt.seed, rt.plan) == (3, 7, gm.plan)
    X = torch.from_numpy(_x(4, (4, 10)))
    assert torch.equal(rt.apply(X, rescale=False), gm.apply(X, rescale=False))
    assert rt.eps_at(0.05) == gm.eps_at(0.05)
    bare = GrowableFeatureMap.from_json(gm.to_json(), device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        bare.eps_at(0.05)


def test_reference_json_is_refused_and_keying_rule():
    jgm = jax_growable(JKERN, 6, jax.random.PRNGKey(0), base_features=32)
    with pytest.raises(ValueError, match="growable_from_jax"):
        GrowableFeatureMap.from_json(jgm.to_json(), device="cpu")
    # the rule: generation g seeds mix_seed(seed, g); generations and seeds
    # give distinct streams
    assert generation_generator(3, 2, "cpu").initial_seed() == mix_seed(3, 2)
    seeds = {mix_seed(s, g) for s in range(8) for g in range(8)}
    assert len(seeds) == 64


def test_handed_map_grows_with_the_port_rule(handed):
    """A grown hand-over keeps the reference's generations and draws the
    new ones by the port's rule at its seed."""
    name, jgm, tgm = handed
    g6 = tgm.grow()
    X = torch.from_numpy(_x(5, (3, 10)))
    per = tgm.generation_output_dim
    raw = g6.apply(X, rescale=False)
    assert torch.equal(raw[:, :3 * per], tgm.apply(X, rescale=False))
    want = registry.get(name).init_params(
        tgm.plan, generation_generator(tgm.seed, 3, "cpu"))
    for k, v in want.items():
        assert torch.equal(g6.params[3][k], v)
