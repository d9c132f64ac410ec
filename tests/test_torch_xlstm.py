"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``) on the CPU, at xlstm SMOKE widths
(d_model 64, 4 heads; the mLSTM's d_up 128, its chunk 64), with the
reference's weights carried across leaf by leaf:

* ``mlstm_forward`` / ``slstm_forward`` and their prefill caches (the
  mLSTM's closed-form (C, n, m) and conv window, the sLSTM's carry) at T
  12 (below the chunk), 64 (equal to it) and 70 (not a multiple of it, so
  the second chunk is padded with the -1e30 sentinels): fp32 within 1e-5
  relative to the output's scale, bf16 compute within 2e-2 relative (the
  default bf16 budget of ``tests/test_precision.py``), every value finite;
* ``mlstm_decode`` / ``slstm_decode`` against the reference's step from a
  prefilled cache;
* the reference's own claim, on the port: the chunked mLSTM equals
  ``mlstm_decode`` rolled T times, and its closed-form prefill state the
  rolled state; the sLSTM's prefill carry equals its decode rolled."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import xlstm as txlstm

FP32_TOL = 1e-5     # relative: fp32 sums of <= chunk x dh terms
BF16_TOL = 2e-2     # relative: tests/test_precision.py's default budget
ARCH = "xlstm-350m"
T_CASES = [12, 64, 70]
CELLS = ["mlstm", "slstm"]
DTYPES = {"float32": (torch.float32, FP32_TOL),
          "bfloat16": (torch.bfloat16, BF16_TOL)}

_JIT = {(cell, fn): jax.jit(getattr(jxlstm, f"{cell}_{fn}"),
                            static_argnums=(1, 4) if fn == "prefill_cache"
                            else 1)
        for cell in CELLS for fn in ("prefill_cache", "decode")}


def _rel(got, want, floor=1e-30):
    """max |got - want| over max(max |want|, floor)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), floor)


def _state_rel(key, got, want):
    """A state's error: ``m`` is a log-domain stabilizer (an exponent, of
    O(1e-3) here), held at max(1, max |m|); the rest at their scale."""
    return _rel(got, want, 1.0 if key == "m" else 1e-30)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _setup(cell, dtype_name):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True),
                               compute_dtype=dtype_name)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype=dtype_name)
    jp = getattr(jxlstm, f"init_{cell}")(jcfg, jax.random.PRNGKey(2),
                                         jnp.float32)
    # the compute copy: every fp32 leaf (r_rec included) in the compute
    # dtype, as both packages' cast_params_to_compute make it
    jp = {k: v.astype(dtype_name) for k, v in jp.items()}
    tdt = DTYPES[dtype_name][0]
    tp = {k: torch.from_numpy(np.array(_np(v))).to(tdt)
          for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def _x(t, seed):
    return np.random.default_rng(seed).normal(size=(2, t, 64)).astype(
        np.float32)


def test_config_and_init_leaves():
    cfg = get_config(ARCH, smoke=True)
    jcfg = jget(ARCH, smoke=True)
    assert dataclasses.asdict(cfg.xlstm) == dataclasses.asdict(jcfg.xlstm)
    for cell in CELLS:
        tp = getattr(txlstm, f"init_{cell}")(
            cfg, torch.Generator().manual_seed(0), torch.bfloat16)
        jp = getattr(jxlstm, f"init_{cell}")(jcfg, jax.random.PRNGKey(0),
                                             jnp.bfloat16)
        assert set(tp) == set(jp), cell
        for k in tp:
            assert tuple(tp[k].shape) == jp[k].shape, (cell, k)
            assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
        for k in ("b_in", "b_if", "gn_scale", "conv_b"):
            if k in tp:
                np.testing.assert_array_equal(tp[k].float().numpy(),
                                              _np(jp[k]))
    # r_rec stays fp32 in the masters whatever the param dtype
    assert tp["r_rec"].dtype == torch.float32


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("cell", CELLS)
def test_forward_and_prefill_cache_match_reference(cell, t, dtype_name):
    jcfg, jp, tcfg, tp = _setup(cell, dtype_name)
    tdt, tol = DTYPES[dtype_name]
    x = _x(t, t)
    want, jcache = _JIT[cell, "prefill_cache"](
        jp, jcfg, jnp.asarray(x).astype(dtype_name), None, 64)
    xt = torch.from_numpy(x).to(tdt)
    got, cache = getattr(txlstm, f"{cell}_prefill_cache")(tp, tcfg, xt)
    fwd = getattr(txlstm, f"{cell}_forward")(tp, tcfg, xt)
    assert got.dtype == tdt and torch.equal(fwd, got)
    assert torch.isfinite(got).all()
    assert _rel(got.float(), _np(want)) <= tol
    assert set(cache) == set(jcache)
    for k, v in cache.items():
        want_dtype = tdt if k == "conv" else torch.float32
        assert v.dtype == want_dtype, k
        assert torch.isfinite(v).all(), k
        assert _state_rel(k, v.float(), _np(jcache[k])) <= tol, k


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("cell", CELLS)
def test_decode_step_matches_reference(cell, dtype_name):
    """One step from a 12-token prefill's cache."""
    jcfg, jp, tcfg, tp = _setup(cell, dtype_name)
    tdt, tol = DTYPES[dtype_name]
    x = _x(13, 5)
    _, jcache = _JIT[cell, "prefill_cache"](
        jp, jcfg, jnp.asarray(x[:, :12]).astype(dtype_name), None, 64)
    _, cache = getattr(txlstm, f"{cell}_prefill_cache")(
        tp, tcfg, torch.from_numpy(x[:, :12]).to(tdt))
    want, jnew = _JIT[cell, "decode"](
        jp, jcfg, jnp.asarray(x[:, 12:]).astype(dtype_name), jcache)
    got, new = getattr(txlstm, f"{cell}_decode")(
        tp, tcfg, torch.from_numpy(x[:, 12:]).to(tdt), cache)
    assert _rel(got.float(), _np(want)) <= tol
    for k, v in new.items():
        assert v.dtype == cache[k].dtype, k
        assert _state_rel(k, v.float(), _np(jnew[k])) <= tol, k


@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("cell", CELLS)
def test_rolling_decode_equals_chunked(cell, t):
    """The reference's claim on the port (fp32): the chunked (mLSTM) or
    scanned (sLSTM) forward equals the decode step rolled T times from a
    zero cache, and the prefill's state equals the rolled state."""
    _, _, tcfg, tp = _setup(cell, "float32")
    x = torch.from_numpy(_x(t, 11))
    want, want_cache = getattr(txlstm, f"{cell}_prefill_cache")(tp, tcfg, x)
    cache = getattr(txlstm, f"init_{cell}_cache")(tcfg, 2, torch.float32,
                                                  "cpu")
    outs = []
    for i in range(t):
        y, cache = getattr(txlstm, f"{cell}_decode")(tp, tcfg, x[:, i:i + 1],
                                                     cache)
        outs.append(y)
    assert _rel(torch.cat(outs, dim=1), want) <= FP32_TOL
    for k, v in cache.items():
        assert _state_rel(k, v, want_cache[k]) <= FP32_TOL, k


def test_padded_chunk_stays_off_real_positions():
    """At T 70 (chunk 64) the second chunk's 58 padded steps carry the
    -1e30 sentinel gate: every real row is finite, and the first chunk's
    rows equal the T 64 cell's bit for bit."""
    _, _, tcfg, _ = _setup("mlstm", "float32")
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 70, 4, 32), generator=g) for _ in range(3))
    i_log = torch.randn((2, 70, 4), generator=g)
    f_log = torch.randn((2, 70, 4), generator=g) + 3.0
    out = txlstm._mlstm_cell_chunked(tcfg, q, k, v, i_log, f_log)
    assert out.shape == (2, 70, 4, 32) and torch.isfinite(out).all()
    head = txlstm._mlstm_cell_chunked(tcfg, q[:, :64], k[:, :64], v[:, :64],
                                      i_log[:, :64], f_log[:, :64])
    torch.testing.assert_close(out[:, :64], head, rtol=0, atol=0)
