"""The port's five examples (``repro_torch.examples``), each ``main`` on the
CPU at a reduced size, under the port's API only; where the reference's
example prints the same metric, the port's number is held against the
reference's API on the same inputs (handed across as arrays) within a
stated statistical bound. Random draws do not cross packages, so a metric
of one random map is held against the spread of the reference's maps:
within ``SPREAD`` standard deviations of the mean of ``DRAWS`` reference
draws.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro import core as jcore
from repro_torch.examples import (
    estimator_comparison,
    kernel_approximation,
    quickstart,
    serve_lm,
    train_lm,
)

DRAWS = 4       # reference maps a metric is held against
SPREAD = 5.0    # standard deviations of those draws
# accuracies of two linear models on independent maps of one test set:
# about three binomial standard errors of their difference at ~1400 test
# rows and accuracy ~0.75 (2 x 0.012), plus the maps' own spread
ACC_TOL = 0.05


JKERNELS = {"homogeneous_poly10": jcore.HomogeneousPolynomialKernel(10),
            "poly10_r1": jcore.PolynomialKernel(10, 1.0),
            "exp_dot_s1": jcore.ExponentialDotProductKernel(1.0)}


def _ref_spread(fn):
    vals = np.asarray([fn(jax.random.PRNGKey(1000 + s))
                       for s in range(DRAWS)])
    return vals.mean(), vals.std()


def _ref_gram_err(kern, x, D, **kw):
    x = jnp.asarray(x)
    exact = np.asarray(kern.gram(x))
    return _ref_spread(lambda key: float(np.abs(np.asarray(
        jcore.make_feature_map(kern, x.shape[1], D, key, **kw)
        .estimate_gram(x)) - exact).mean()))


def test_quickstart():
    from repro_torch.data.toy import make_classification_dataset

    out = quickstart.main(["--device", "cpu", "--svm-rows", "100",
                           "--features", "100,1000", "--rf-features", "200",
                           "--h01-features", "50"])
    # section 1: each kernel's Gram error at D 1000 on the same rows
    x = quickstart.unit_rows(100, 20, torch.Generator().manual_seed(0))
    for name, kern in JKERNELS.items():
        mean, std = _ref_gram_err(kern, x.numpy(), 1000)
        got = out["approx"][(name, 1000)]
        assert abs(got - mean) <= SPREAD * std, (name, got, mean, std)
        assert got < out["approx"][(name, 100)]
    # section 2 on the same data: the exact SVM (coordinate ascent in the
    # same order) to a test row; the RM linear model within ACC_TOL
    ds = {k: v.numpy() for k, v in
          make_classification_dataset("spambase", device="cpu").items()}
    kern = jcore.PolynomialKernel(10, 1.0)
    xs, ys = jnp.asarray(ds["x_train"][:100]), jnp.asarray(ds["y_train"][:100])
    _, ksvm = jcore.train_kernel_svm(kern.gram(xs), ys, C=1.0,
                                     kernel_fn=kern.gram, X_train=xs)
    acc_k = ksvm.accuracy(jnp.asarray(ds["x_test"]),
                          jnp.asarray(ds["y_test"]))
    assert abs(out["acc_kernel"] - float(acc_k)) <= 1.0 / len(ds["y_test"])

    def rf_acc(key):
        fm = jcore.make_feature_map(kern, ds["x_train"].shape[1], 200, key)
        lin = jcore.train_linear(fm(jnp.asarray(ds["x_train"])),
                                 jnp.asarray(ds["y_train"]), lam=1e-5)
        return float(lin.accuracy(fm(jnp.asarray(ds["x_test"])),
                                  jnp.asarray(ds["y_test"])))

    mean, _ = _ref_spread(rf_acc)
    assert abs(out["acc_rf"] - mean) <= ACC_TOL, (out["acc_rf"], mean)
    assert 0.5 < out["acc_h01"] <= 1.0
    # section 4 is deterministic
    c = jcore.constants_for(jcore.ExponentialDotProductKernel(1.0),
                            radius=1.0, dim=20)
    assert out["required_d"] == (c.required_d(0.2, 0.1),
                                 c.required_d(0.2, 0.1, "proportional"))


def test_kernel_approximation_writes_its_csv(tmp_path):
    path = tmp_path / "sub" / "fig1.csv"
    rows = kernel_approximation.main(
        ["--device", "cpu", "--out", str(path), "--dims", "10",
         "--features", "10,100", "--reps", "3"])
    with open(path) as f:
        written = list(csv.DictReader(f))
    # 3 kernels x 3 variants but h01 of the homogeneous kernel, 2 D each
    assert len(rows) == len(written) == 16
    assert {r["variant"] for r in written} == {"rf", "h01", "proportional"}
    got = {(r["kernel"], r["D"], r["variant"]): r for r in rows}
    x = quickstart.unit_rows(100, 10, torch.Generator().manual_seed(10))
    # the stratified rows: one plan shape for every reference draw
    for kname, jname in (("exponential", "exp_dot_s1"),
                         ("homogeneous", "homogeneous_poly10")):
        mean, std = _ref_gram_err(JKERNELS[jname], x.numpy(), 100,
                                  measure="proportional", stratified=True)
        row = got[(kname, 100, "proportional")]
        # the port's row is a mean of 3 draws
        assert abs(row["mean_abs_err"] - mean) <= SPREAD * std, \
            (kname, row, mean, std)


def test_estimator_comparison_with_shards():
    from repro_torch.data.toy import make_classification_dataset

    out = estimator_comparison.main(
        ["--device", "cpu", "--shards", "2", "--train-rows", "300",
         "--test-rows", "256", "--features", "128"])
    assert sorted(out) == ["ctr", "rm", "structured", "tensor_sketch"]
    xte = jnp.asarray(make_classification_dataset(
        "adult", seed=0, device="cpu")["x_test"][:256].numpy())
    kern = jcore.ExponentialDotProductKernel(1.0)
    exact = np.asarray(kern.gram(xte))
    for name, row in out.items():
        mean, std = _ref_spread(lambda key: float(np.sqrt(np.mean((
            np.asarray(jcore.make_feature_map(
                kern, xte.shape[1], 128, key, estimator=name,
                measure="proportional").estimate_gram(xte))
            - exact) ** 2))))
        for key in ("gram_rmse", "sharded_rmse"):
            assert abs(row[key] - mean) <= SPREAD * std, \
                (name, key, row[key], mean, std)
        assert 0.5 < row["test_acc"] <= 1.0


@pytest.mark.parametrize("mode", ["rm", "exact"])
def test_serve_lm(mode):
    done = serve_lm.main(["--device", "cpu", "--attention-mode", mode,
                          "--requests", "4", "--slots", "2", "--max-new",
                          "5"])
    assert sorted(done) == [0, 1, 2, 3]
    assert all(len(s.generated) == 5 and s.finish_reason == "max_new_tokens"
               for s in done.values())


def test_train_lm_learns_and_resumes(tmp_path):
    args = ["--device", "cpu", "--preset", "quick", "--ckpt-dir",
            str(tmp_path), "--steps", "20"]
    trainer, state = train_lm.main(args)
    ce = [r["ce"] for r in trainer.metrics_log]
    assert ce[-1] < ce[0] - 0.3
    assert int(state["step"]) == 20
    # a second run resumes from the last checkpoint and has nothing to do
    again, state2 = train_lm.main(args)
    assert int(state2["step"]) == 20 and not again.metrics_log
