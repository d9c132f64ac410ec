"""Kernels B1 (the whole Random Maclaurin map) and B9 (one degree bucket)
in the port: B1's plain version against the reference's jnp oracle
(repro.kernels.rm_feature.ref.rm_feature_fused_ref), B9's plain version
against the reference's real Pallas kernel in interpret mode
(repro.kernels.rm_feature.ops.rm_feature_bucket, use_pallas=True), the
wrappers' dispatch and edge shapes (the CUDA kernels against their plain
versions are in tests/test_torch_cuda_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.core import plan as jplan
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.kernels.rm_feature.ops import rm_feature_bucket as jax_bucket
from repro.kernels.rm_feature.ref import rm_feature_fused_ref as jax_ref
from repro_torch.kernels.rm_feature.ops import (
    rm_feature_bucket,
    rm_feature_fused,
)
from repro_torch.kernels.rm_feature.ref import (
    rm_feature_bucket_ref,
    rm_feature_fused_ref,
)

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


# the reference's own B9 grid (tests/test_kernels_rm_feature.py SHAPES):
# (batch, d, count, degree)
BUCKET_SHAPES = [
    (8, 16, 32, 1),
    (8, 16, 32, 2),
    (32, 64, 128, 3),
    (7, 33, 19, 4),
    (128, 128, 128, 5),
    (1, 8, 1, 7),
    (64, 256, 64, 10),
]


def _bucket_inputs(b, d, count, degree, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.normal(size=(b, d))).astype(np.float32)
    omega = (2.0 * rng.integers(0, 2, size=(count * degree, d))
             - 1.0).astype(np.float32)
    return x, omega


@pytest.mark.parametrize("b,d,count,degree", BUCKET_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_plain_matches_reference_pallas_interpret(b, d, count, degree,
                                                         dtype):
    """B9's plain version against the reference's Pallas kernel (interpret
    mode), both on the same inputs rounded to ``dtype``. Tolerance x
    max(1, max |ref|): fp32 1e-5 (fp32 sums of d products in another
    order, then the same product over j); bf16 the rm bf16 budget
    (products of bf16 values are exact in fp32, so the measured gap is the
    fp32 one)."""
    x, omega = _bucket_inputs(b, d, count, degree, degree * 1000 + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax_bucket(jnp.asarray(x, jdt), jnp.asarray(omega, jdt),
                                 degree, 0.37, use_pallas=True,
                                 interpret=True))
    got = rm_feature_bucket(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(omega).to(tdt), degree,
                            0.37).numpy()
    assert got.shape == want.shape == (b, count)
    tol = 1e-5 if dtype == "float32" else RM_BF16_FEATURE_ATOL
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_bucket_batch_dims_match_reference_pallas_interpret():
    x, omega = _bucket_inputs(6, 16, 5, 2, 0)
    x = x.reshape(2, 3, 16)
    want = np.asarray(jax_bucket(jnp.asarray(x), jnp.asarray(omega), 2, 1.0,
                                 use_pallas=True, interpret=True))
    got = rm_feature_bucket(torch.from_numpy(x), torch.from_numpy(omega), 2,
                            1.0)
    assert got.shape == (2, 3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bucket_wrapper_dispatch_and_edges(monkeypatch):
    x, omega = _bucket_inputs(4, 8, 3, 2, 1)
    xt, om = torch.from_numpy(x), torch.from_numpy(omega)
    before = rm_feature_bucket.launches
    got = rm_feature_bucket(xt, om, 2, 0.5)
    assert rm_feature_bucket.launches == before     # plain version on cpu
    assert torch.equal(got, rm_feature_bucket_ref(xt, om, 2, 0.5))
    assert rm_feature_bucket(xt[:0], om, 2, 0.5).shape == (0, 3)
    # degree 0: the reference dies on a division by zero; the port names it
    with pytest.raises(ValueError, match="degree >= 1"):
        rm_feature_bucket(xt, om, 0, 0.5)
    with pytest.raises(ValueError, match="rows"):
        rm_feature_bucket(xt, om[:5], 2, 0.5)
    # a meta tensor takes the plain version: shapes only (a dry run)
    before = rm_feature_bucket.launches
    z = rm_feature_bucket(xt.to("meta"), om.to("meta"), 2, 0.5)
    assert z.device.type == "meta" and z.shape == (4, 3)
    assert rm_feature_bucket.launches == before
    # a device neither plain nor cuda raises (no silent fallback): meta
    # taken out of the plain devices stands for one
    from repro_torch.kernels.rm_feature import ops as rm_ops

    monkeypatch.setattr(rm_ops, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        rm_feature_bucket(xt.to("meta"), om.to("meta"), 2, 0.5)
    with pytest.raises(NotImplementedError, match="backward"):
        rm_feature_bucket(xt.requires_grad_(), om, 2, 0.5)


# chip_smoke.py phase 22's B9 shapes as (rows, count, d, degree) and the
# kernel bucket_schedule takes there: the one large bucket (homog10 at D
# 4000) on the tile at Table 1's 20000-row cap and at Fig. 1's 100 rows
# (4000 columns); every spambase bucket at its 1840-row split, exp's
# deepest bucket and the ragged 70 x1 on chains; the adult map's buckets
# at 8000 rows (the wide low-degree ones on the tile); the tile's shared
# memory limit at degree 2 (d 208 fp32 fits, d 216 does not), a deep d
# and degree 24
SCHEDULE_CASES = [
    ((20000, 4000, 50, 10), "tile"), ((100, 4000, 50, 10), "tile"),
    ((1840, 125, 57, 1), "chain"), ((1840, 63, 57, 2), "chain"),
    ((1840, 16, 57, 4), "chain"), ((1840, 1, 57, 8), "chain"),
    ((100, 1, 50, 11), "chain"), ((70, 1, 57, 1), "chain"),
    ((8000, 1000, 123, 1), "tile"), ((8000, 250, 123, 3), "tile"),
    ((8000, 2, 123, 10), "chain"), ((4096, 256, 208, 2), "tile"),
    ((4096, 256, 216, 2), "chain"), ((20000, 4000, 1000, 3), "chain"),
    ((20000, 4000, 50, 24), "tile"),
]


@pytest.mark.parametrize("item", [4, 2])
@pytest.mark.parametrize("shape,kernel", SCHEDULE_CASES)
def test_bucket_schedule_choice_and_cover(shape, kernel, item):
    """B9's schedule: the kernel at each phase-22 shape (bf16 the same as
    fp32, but for d 216, whose bf16 rows fit the tile), a tile block's
    shared memory within the block's limit and its two run buffers where
    two blocks an SM fit, and a grid whose blocks cover every row and
    every column tile exactly once."""
    from repro_torch.kernels.common import (
        BUCKET_CHAIN_WARPS,
        SMEM_PER_BLOCK,
        bucket_schedule,
        bucket_tile_smem,
    )

    rows, count, d, degree = shape
    s = bucket_schedule(rows, count, d, degree, item)
    if item == 2 and d == 216:
        kernel = "tile"
    assert s.kernel == kernel
    n_ct = -(-count // 8)
    assert s.grid[0] * s.rows >= rows > (s.grid[0] - 1) * s.rows
    if s.kernel == "tile":
        assert s.rows == 256 and 1 <= s.runs <= 32
        assert s.smem == bucket_tile_smem(d, degree, s.ct_per_warp,
                                          s.buffers, item) <= SMEM_PER_BLOCK
        per_block = s.ct_per_warp * s.runs
    else:
        assert s.rows == 16 and s.runs == 1 and s.smem == 0
        per_block = BUCKET_CHAIN_WARPS * s.ct_per_warp
    assert s.grid[1] * per_block >= n_ct > (s.grid[1] - 1) * per_block
    assert s.grid[1] <= 65535
    assert bucket_schedule(rows, count, d, degree, item,
                           kernel="chain").kernel == "chain"
    if s.kernel == "chain" and d >= 216 and item == 4:
        with pytest.raises(ValueError, match="fit"):
            bucket_schedule(rows, count, d, degree, item, kernel="tile")
