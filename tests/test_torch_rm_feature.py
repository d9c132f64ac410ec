"""Kernel B1 (the whole Random Maclaurin map) in the port: its plain
version against the reference's jnp oracle
(repro.kernels.rm_feature.ref.rm_feature_fused_ref), the wrapper's dispatch
and edge shapes (the CUDA kernel against its plain version is in
tests/test_torch_cuda_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.kernels.rm_feature.ref import rm_feature_fused_ref as jax_ref
from repro_torch.kernels.rm_feature.ops import rm_feature_fused
from repro_torch.kernels.rm_feature.ref import rm_feature_fused_ref

# tests/test_precision.py's documented bf16 budget for the rm family:
# max |z_bf16 - z_fp32| elementwise on unit-ball inputs.
RM_BF16_FEATURE_ATOL = 5e-3


def _packed(d, num_features, n_max, pad_cols, seed=0):
    """A packed plan (reference omegas) with ``pad_cols`` padding columns
    (degree 0, scale 0) appended, as a wrapper pads F to its block."""
    plan = jplan.make_feature_plan(JExp(1.0), d, num_features,
                                   measure="proportional", n_max=n_max)
    om = jplan.init_omegas(plan, jax.random.PRNGKey(seed))
    w = np.asarray(jplan.pack_omegas(plan, om))
    deg = plan.column_degrees()
    scale = plan.column_scales()
    w = np.pad(w, ((0, 0), (0, pad_cols), (0, 0)))
    deg = np.pad(deg, (0, pad_cols))
    scale = np.pad(scale, (0, pad_cols))
    return w, deg.astype(np.int32), scale.astype(np.float32)


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# F = output_dim + padding: 42 + 5 = 47 and 163 + 29 = 192 columns — neither
# plan width is a multiple of the kernel's 64-column block.
CASES = [
    dict(d=16, num_features=64, n_max=6, pad_cols=5, rows=37),
    dict(d=128, num_features=256, n_max=8, pad_cols=29, rows=128),
]


@pytest.mark.parametrize("case", CASES, ids=["smoke", "qwen3_head"])
def test_plain_matches_reference_fp32(case):
    """Tolerance 1e-5: fp32 products and sums of at most 5 x 128 terms;
    only the summation order differs from the jnp oracle."""
    w, deg, scale = _packed(case["d"], case["num_features"], case["n_max"],
                            case["pad_cols"])
    x = _unit_rows(case["rows"], case["d"], 1)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(deg), jnp.asarray(scale)))
    got = rm_feature_fused_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(deg),
                               torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # padding columns are 1 * 0 = 0
    assert np.all(got[:, -case["pad_cols"]:] == 0.0)


@pytest.mark.parametrize("case", CASES, ids=["smoke", "qwen3_head"])
def test_plain_bf16_within_rm_budget(case):
    """bf16 inputs, fp32 accumulation: against the fp32 oracle within the
    rm bf16 budget of tests/test_precision.py, and against the oracle on
    the same bf16-rounded inputs within 1e-5 (the products of bf16 values
    are exact in fp32, so only the summation order differs)."""
    w, deg, scale = _packed(case["d"], case["num_features"], case["n_max"],
                            case["pad_cols"])
    x = _unit_rows(case["rows"], case["d"], 2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = rm_feature_fused(xt, wt, torch.from_numpy(deg),
                           torch.from_numpy(scale)).numpy()
    want32 = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(deg), jnp.asarray(scale)))
    assert np.abs(got - want32).max() <= RM_BF16_FEATURE_ATOL
    want16 = np.asarray(jax_ref(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(deg), jnp.asarray(scale)))
    np.testing.assert_allclose(got, want16, atol=1e-5, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    w, deg, scale = _packed(16, 64, 6, 0)
    x = torch.from_numpy(_unit_rows(6, 16, 3)).reshape(2, 3, 16)
    before = rm_feature_fused.launches
    got = rm_feature_fused(x, torch.from_numpy(w), torch.from_numpy(deg),
                           torch.from_numpy(scale))
    assert rm_feature_fused.launches == before
    assert got.shape == (2, 3, w.shape[1]) and got.dtype == torch.float32
    want = rm_feature_fused_ref(x.reshape(6, 16), torch.from_numpy(w),
                                torch.from_numpy(deg),
                                torch.from_numpy(scale))
    assert torch.equal(got.reshape(6, -1), want)


def test_edge_shapes_give_their_arithmetic_result():
    x = torch.ones(3, 4)
    w = torch.ones(2, 5, 4)
    deg = torch.tensor([0, 1, 2, 0, 1], dtype=torch.int32)
    scale = torch.arange(5, dtype=torch.float32)
    assert rm_feature_fused(torch.ones(0, 4), w, deg, scale).shape == (0, 5)
    assert rm_feature_fused(x, torch.ones(2, 0, 4),
                            deg[:0], scale[:0]).shape == (3, 0)
    # no degree slots: every column is an empty product (1) times its scale
    out = rm_feature_fused(x, torch.ones(0, 5, 4), deg * 0, scale)
    assert torch.equal(out, scale.expand(3, 5))


def test_wrapper_refuses_autograd():
    x = torch.ones(2, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        rm_feature_fused(x, torch.ones(1, 3, 4),
                         torch.ones(3, dtype=torch.int32), torch.ones(3))
