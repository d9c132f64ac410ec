"""The port's Mamba mixer (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``) on the CPU, at jamba SMOKE widths
(d_model 64, d_inner 128, d_state 8, scan_chunk 16), with the
reference's weights carried across leaf by leaf:

* ``mamba_forward`` and ``mamba_prefill_cache`` (output, conv window and
  ssm carry) at T 1, 12, 16 (= ``scan_chunk``) and 37 (not a multiple of
  it, so the last chunk is padded): fp32 within 1e-5 relative to the
  output's scale, bf16 compute within 2e-2 relative (the default bf16
  budget of ``tests/test_precision.py``, taken at the output's scale: the
  outputs here are O(1e-4));
* ``mamba_decode`` against the reference's step, and rolled T times from a
  zero cache equal to the prefill's carry and outputs;
* the doubling scan against a step-by-step recurrence, and the cache's
  dtypes (``conv`` in the compute dtype, ``ssm`` fp32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jget
from repro.models import mamba as jmamba
from repro_torch.configs import get_config
from repro_torch.models import mamba as tmamba

FP32_TOL = 1e-5     # relative: fp32 sums of <= d_inner terms
BF16_TOL = 2e-2     # relative: tests/test_precision.py's default budget
ARCH = "jamba-v0.1-52b"
T_CASES = [1, 12, 16, 37]
DTYPES = {"float32": (torch.float32, FP32_TOL),
          "bfloat16": (torch.bfloat16, BF16_TOL)}

_prefill = jax.jit(jmamba.mamba_prefill_cache, static_argnums=(1, 4))
_decode = jax.jit(jmamba.mamba_decode, static_argnums=1)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _setup(dtype_name):
    """Both configs at ``compute_dtype`` and one set of weights: the
    reference's drawn in fp32 then cast to the compute dtype (as its
    ``cast_params_to_compute`` does), the port's the same values."""
    jcfg = dataclasses.replace(jget(ARCH, smoke=True),
                               compute_dtype=dtype_name)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype=dtype_name)
    jp = jmamba.init_mamba(jcfg, jax.random.PRNGKey(1), jnp.float32)
    jp = {k: v.astype(dtype_name) for k, v in jp.items()}
    tdt = DTYPES[dtype_name][0]
    tp = {k: torch.from_numpy(np.array(_np(v))).to(tdt)
          for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def _x(b, t, seed):
    return np.random.default_rng(seed).normal(size=(b, t, 64)).astype(
        np.float32)


def test_config_and_init_leaves():
    cfg = get_config(ARCH, smoke=True)
    assert cfg.mamba == dataclasses.replace(cfg.mamba, d_state=8, d_conv=4,
                                            expand=2, scan_chunk=16)
    tp = tmamba.init_mamba(cfg, torch.Generator().manual_seed(0),
                           torch.bfloat16)
    jp = jmamba.init_mamba(jget(ARCH, smoke=True), jax.random.PRNGKey(0),
                           jnp.bfloat16)
    assert set(tp) == set(jp)
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    # the deterministic leaves equal the reference's (log(1..N) to an ulp:
    # the port rounds the float64 log once)
    for k in ("d_skip", "conv_b", "dt_bias"):
        np.testing.assert_array_equal(tp[k].float().numpy(), _np(jp[k]))
    np.testing.assert_allclose(tp["a_log"].numpy(), _np(jp["a_log"]),
                               rtol=2e-7, atol=0)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("t", T_CASES)
def test_forward_and_prefill_cache_match_reference(dtype_name, t):
    jcfg, jp, tcfg, tp = _setup(dtype_name)
    tdt, tol = DTYPES[dtype_name]
    x = _x(2, t, t)
    want, jcache = _prefill(jp, jcfg, jnp.asarray(x).astype(dtype_name),
                            None, 64)
    xt = torch.from_numpy(x).to(tdt)
    got, cache = tmamba.mamba_prefill_cache(tp, tcfg, xt)
    fwd = tmamba.mamba_forward(tp, tcfg, xt)
    assert got.dtype == tdt and torch.equal(fwd, got)
    assert _rel(got.float(), _np(want)) <= tol
    assert cache["conv"].dtype == tdt and cache["ssm"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (2, 3, 128)
    assert tuple(cache["ssm"].shape) == (2, 128, 8)
    assert _rel(cache["ssm"], _np(jcache["ssm"])) <= tol
    assert _rel(cache["conv"].float(), _np(jcache["conv"])) <= tol


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_decode_step_matches_reference(dtype_name):
    """One step from a nonzero cache (a 12-token prefill's)."""
    jcfg, jp, tcfg, tp = _setup(dtype_name)
    tdt, tol = DTYPES[dtype_name]
    x = _x(2, 13, 3)
    _, jcache = _prefill(jp, jcfg, jnp.asarray(x[:, :12]).astype(dtype_name),
                         None, 64)
    _, cache = tmamba.mamba_prefill_cache(
        tp, tcfg, torch.from_numpy(x[:, :12]).to(tdt))
    want, jnew = _decode(jp, jcfg, jnp.asarray(x[:, 12:]).astype(dtype_name),
                         jcache)
    got, new = tmamba.mamba_decode(tp, tcfg,
                                   torch.from_numpy(x[:, 12:]).to(tdt), cache)
    assert _rel(got.float(), _np(want)) <= tol
    assert _rel(new["ssm"], _np(jnew["ssm"])) <= tol
    assert new["conv"].dtype == tdt and new["ssm"].dtype == torch.float32
    assert _rel(new["conv"].float(), _np(jnew["conv"])) <= tol


@pytest.mark.parametrize("t", [12, 37])
def test_rolling_decode_equals_prefill(t):
    """Decoding the T tokens one at a time from a zero cache gives the
    prefill's outputs and its carry (fp32)."""
    _, _, tcfg, tp = _setup("float32")
    x = torch.from_numpy(_x(2, t, 7))
    want, want_cache = tmamba.mamba_prefill_cache(tp, tcfg, x)
    cache = tmamba.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for i in range(t):
        y, cache = tmamba.mamba_decode(tp, tcfg, x[:, i:i + 1], cache)
        outs.append(y)
    assert _rel(torch.cat(outs, dim=1), want) <= FP32_TOL
    assert _rel(cache["ssm"], want_cache["ssm"]) <= FP32_TOL
    # the window holds the last inputs' projections (x @ w_in of one row
    # against of T rows: the products may round differently)
    assert _rel(cache["conv"], want_cache["conv"]) <= FP32_TOL


def test_chunk_scan_is_the_recurrence():
    """The doubling scan of one chunk equals h_t = a_t h_{t-1} + u_t from
    h = 0, step by step, at a ragged chunk length (13)."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 3, 13, 5, 4), generator=g)
    u = torch.randn((2, 3, 13, 5, 4), generator=g)
    cum_a, cum_u = tmamba._chunk_scan(a, u)
    h = torch.zeros((2, 3, 5, 4))
    prod = torch.ones((2, 3, 5, 4))
    for i in range(13):
        h = a[:, :, i] * h + u[:, :, i]
        prod = prod * a[:, :, i]
        torch.testing.assert_close(cum_u[:, :, i], h, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(cum_a[:, :, i], prod, rtol=1e-6,
                                   atol=0)
