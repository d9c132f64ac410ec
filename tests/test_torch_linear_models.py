"""The port's linear and kernel classifiers (repro_torch.core.linear_models)
against the reference's (repro.core.linear_models), on features, Grams and
labels handed across through numpy:

* ``train_kernel_ridge`` within 1e-10 (the same host fp64 numpy solve and
  active-set refinement);
* ``train_kernel_svm``'s alphas within 1e-5 x max(1, max |alpha|): 40
  epochs of sequential fp32 coordinate steps, each a d-long fp32 dot
  product summed in another order (measured gap 8.2e-7);
* ``train_linear``'s decision values within 2e-3 (squared hinge) and 1e-4
  (logistic) x max |decision| on well-conditioned problems (lam 1e-3, more
  points than features; measured 5.5e-5 and 4.4e-7; the iteration is
  sensitive to fp32 rounding where it has not converged, so the margin is
  wide), and its predictions identical except where |decision| is below
  that tolerance;
* the paper's pipeline (featurize, fit, predict) on a handed-over map.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_models as jl
from repro.core import PolynomialKernel as JPoly
from repro.core import make_feature_map as jax_make_feature_map
from repro_torch.core import linear_models as tl
from repro_torch.core import PolynomialKernel as TPoly
from repro_torch.core.feature_map import RMFeatureMap
from repro_torch.core.plan import FeaturePlan

LINEAR_TOL = {"squared_hinge": 2e-3, "logistic": 1e-4}


def _problem(n, d, seed):
    """Points in the unit ball (drawn from ``seed``) with labels +-1 from
    one quadratic boundary per width d, so a test split drawn from another
    seed shares its training split's boundary."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x = x / np.linalg.norm(x, axis=1, keepdims=True) * rng.uniform(
        0.3, 1.0, (n, 1))
    w = np.random.default_rng(1000 + d).normal(size=d)
    y = np.sign(x @ w + 0.5 * (x @ w) ** 2 - 0.1)
    y[y == 0] = 1.0
    return x.astype(np.float32), y.astype(np.float32)


def _features(x, num_features, seed):
    jfm = jax_make_feature_map(JPoly(10, 1.0), x.shape[1], num_features,
                               jax.random.PRNGKey(seed))
    return jfm, np.asarray(jfm(jnp.asarray(x)))


@pytest.mark.parametrize("refine", ["auto", True, False])
@pytest.mark.parametrize("labels", ["binary", "real"])
def test_kernel_ridge_matches_reference(refine, labels):
    x, y = _problem(120, 6, 0)
    if labels == "real":
        y = (y * np.random.default_rng(1).uniform(0.5, 2.0, y.shape)
             ).astype(np.float32)
    gram = np.asarray(JPoly(3, 1.0).gram(jnp.asarray(x)))
    ja, jclf = jl.train_kernel_ridge(jnp.asarray(gram), jnp.asarray(y),
                                     lam=1e-3, refine=refine,
                                     kernel_fn=JPoly(3, 1.0).gram,
                                     X_train=jnp.asarray(x))
    ta, tclf = tl.train_kernel_ridge(torch.from_numpy(gram),
                                     torch.from_numpy(y), lam=1e-3,
                                     refine=refine,
                                     kernel_fn=TPoly(3, 1.0).gram,
                                     X_train=torch.from_numpy(x))
    assert ta.dtype == torch.float32 and ta.shape == (120,)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-10)
    xt, _ = _problem(30, 6, 2)
    jd = np.asarray(jclf.decision(jnp.asarray(xt)))
    td = tclf.decision(torch.from_numpy(xt)).numpy()
    assert np.abs(td - jd).max() <= 1e-5 * max(1.0, np.abs(jd).max())


def test_chol_solve_falls_back_on_a_singular_system():
    a = np.ones((4, 4))
    rhs = np.arange(4.0)
    np.testing.assert_array_equal(tl._chol_solve(a, rhs),
                                  jl._chol_solve(a, rhs))


@pytest.mark.parametrize("n,d", [(80, 6), (200, 10)])
def test_kernel_svm_matches_reference(n, d):
    x, y = _problem(n, d, 3)
    kern_j, kern_t = JPoly(3, 1.0), TPoly(3, 1.0)
    gram = np.asarray(kern_j.gram(jnp.asarray(x)))
    ja, jclf = jl.train_kernel_svm(jnp.asarray(gram), jnp.asarray(y), C=1.0,
                                   kernel_fn=kern_j.gram,
                                   X_train=jnp.asarray(x))
    ta, tclf = tl.train_kernel_svm(torch.from_numpy(gram),
                                   torch.from_numpy(y), C=1.0,
                                   kernel_fn=kern_t.gram,
                                   X_train=torch.from_numpy(x))
    ja = np.asarray(ja)
    assert (ta.numpy() >= 0).all()
    assert np.abs(ta.numpy() - ja).max() <= 1e-5 * max(1.0, np.abs(ja).max())
    xt, yt = _problem(50, d, 4)
    assert tclf.accuracy(torch.from_numpy(xt), torch.from_numpy(yt)) == \
        pytest.approx(jclf.accuracy(jnp.asarray(xt), jnp.asarray(yt)))
    with pytest.raises(ValueError, match="kernel_fn"):
        tl.train_kernel_svm(torch.from_numpy(gram),
                            torch.from_numpy(y))[1].decision(
            torch.from_numpy(xt))


def test_kernel_svm_eager_loop_on_the_cpu_matches_reference(monkeypatch):
    """On a CPU Gram ``train_kernel_svm`` runs its plain version, the
    Python loop of coordinate steps (no CUDA graph is made), and its
    alphas stay within 1e-5 x max(1, max |alpha|) of the reference's on a
    60-row Gram; fewer epochs, and none, match too."""
    def no_graph(*a, **k):
        raise AssertionError("a CPU Gram must not capture a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    x, y = _problem(60, 5, 11)
    gram = np.asarray(JPoly(3, 1.0).gram(jnp.asarray(x)))
    for epochs in (40, 3, 0):
        ja, _ = jl.train_kernel_svm(jnp.asarray(gram), jnp.asarray(y),
                                    C=0.5, n_epochs=epochs)
        ta, _ = tl.train_kernel_svm(torch.from_numpy(gram),
                                    torch.from_numpy(y), C=0.5,
                                    n_epochs=epochs)
        ja = np.asarray(ja)
        assert ta.dtype == torch.float32 and ta.shape == (60,)
        assert np.abs(ta.numpy() - ja).max() <= 1e-5 * max(
            1.0, np.abs(ja).max()), epochs


@pytest.mark.parametrize("loss", ["squared_hinge", "logistic"])
@pytest.mark.parametrize("n,d,num_features", [(400, 8, 100),
                                              (600, 12, 200)])
def test_train_linear_matches_reference(loss, n, d, num_features):
    x, y = _problem(n, d, 5)
    _, z = _features(x, num_features, 1)
    jc = jl.train_linear(jnp.asarray(z), jnp.asarray(y), lam=1e-3, loss=loss)
    tc = tl.train_linear(torch.from_numpy(z), torch.from_numpy(y), lam=1e-3,
                         loss=loss)
    jd = np.asarray(jc.decision(jnp.asarray(z)))
    td = tc.decision(torch.from_numpy(z)).numpy()
    tol = LINEAR_TOL[loss] * np.abs(jd).max()
    assert np.abs(td - jd).max() <= tol
    near_zero = np.abs(jd) <= tol
    np.testing.assert_array_equal(np.sign(td)[~near_zero],
                                  np.sign(jd)[~near_zero])
    assert tc.accuracy(torch.from_numpy(z), torch.from_numpy(y)) == \
        pytest.approx(jc.accuracy(jnp.asarray(z), jnp.asarray(y)),
                      abs=near_zero.mean() + 1e-12)


def test_train_linear_rejects_an_unknown_loss():
    with pytest.raises(ValueError, match="unknown loss"):
        tl.train_linear(torch.ones(4, 2), torch.ones(4), loss="hinge")


def test_featurized_pipeline_matches_reference():
    """train_featurized_linear on a handed-over map: the Classifier takes
    raw inputs and gives the reference's decisions within the squared
    hinge's tolerance."""
    x, y = _problem(500, 8, 6)
    jfm, _ = _features(x, 150, 2)
    tfm = RMFeatureMap(plan=FeaturePlan.from_json(jfm.plan.to_json()),
                       omegas=torch.from_numpy(np.array(jfm.omegas)))
    jc = jl.train_featurized_linear(jfm, jnp.asarray(x), jnp.asarray(y),
                                    lam=1e-3, use_pallas=False)
    tc = tl.train_featurized_linear(tfm, torch.from_numpy(x),
                                    torch.from_numpy(y), lam=1e-3)
    xt, yt = _problem(200, 8, 7)
    jd = np.asarray(jc.decision(jnp.asarray(xt)))
    td = tc.decision(torch.from_numpy(xt)).numpy()
    assert np.abs(td - jd).max() <= LINEAR_TOL["squared_hinge"] * \
        np.abs(jd).max()
    assert tc.accuracy(torch.from_numpy(xt), torch.from_numpy(yt)) > 0.8


def test_classifier_predicts_signs():
    clf = tl.Classifier(decision_fn=lambda z: z[:, 0] - 0.5)
    z = torch.tensor([[0.0], [1.0], [0.5]])
    assert clf.predict(z).tolist() == [-1.0, 1.0, 0.0]
    assert clf.accuracy(z, torch.tensor([-1.0, 1.0, 1.0])) == \
        pytest.approx(2 / 3)
