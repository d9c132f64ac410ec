"""The port's TensorSketch family (repro_torch.sketch, the "tensor_sketch"
registry entry) against the reference's (repro.sketch): the plan and its
JSON equal exactly (same host-side numpy arithmetic), ``pack_sketch`` on the
reference's hash tables within 1e-6, the fused map (kernel B6's plain
version on the CPU) within 1e-5 of the reference's ``jnp.fft`` path, and
the registry's ``estimate_gram`` on top of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import registry as jreg
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro.sketch import plan as jsk
from repro.sketch import ref as jskref
from repro_torch.configs import get_config
from repro_torch.core import registry
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp
from repro_torch.kernels import common
from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused
from repro_torch.models.attention import rm_plan_for
from repro_torch.sketch import plan as tsk
from repro_torch.sketch import ref as tskref


def _qwen3_plans(smoke):
    jcfg = jax_get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm",
                          estimator="tensor_sketch")
    tcfg = get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm",
                      estimator="tensor_sketch")
    dh = tcfg.resolved_head_dim
    return jax_rm_plan_for(jcfg, dh), rm_plan_for(tcfg, dh)


def _assert_same_plan(a, b):
    assert tuple(a) == tuple(b)          # every field, exact
    np.testing.assert_array_equal(a.column_degrees(), b.column_degrees())
    np.testing.assert_array_equal(a.column_scales(), b.column_scales())
    assert a.output_dim == b.output_dim
    assert a.num_sketch_cols == b.num_sketch_cols
    assert a.max_degree == b.max_degree and a.num_funcs == b.num_funcs


def _tables(jplan, seed):
    """The reference's CountSketch tables, handed across through numpy."""
    p = jsk.init_sketch_params(jplan, jax.random.PRNGKey(seed))
    h, s = np.asarray(p["h"]), np.asarray(p["s"])
    return ({"h": jnp.asarray(h), "s": jnp.asarray(s)},
            {"h": torch.from_numpy(h.copy()), "s": torch.from_numpy(s.copy())})


def _unit_rows(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_qwen3_sketch_plan_equals_reference(smoke):
    jp, tp = _qwen3_plans(smoke)
    assert isinstance(tp, tsk.SketchPlan)
    _assert_same_plan(jp, tp)
    assert tp.truncation_bias(1.0) == jp.truncation_bias(1.0)
    starts = tp.block_starts()
    assert starts[0] == 0 and starts[-1] == tp.num_sketch_cols
    assert np.diff(starts).tolist() == list(tp.counts)
    if not smoke:   # qwen3-1.7b's head: F = 1 + 255 columns for B5
        assert tp.counts == (149, 74, 25, 6, 1) and tp.output_dim == 256


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_sketch_plan_json_crosses_both_ways(smoke):
    jp, tp = _qwen3_plans(smoke)
    _assert_same_plan(tsk.SketchPlan.from_json(jp.to_json()), tp)
    _assert_same_plan(jsk.SketchPlan.from_json(tp.to_json()), jp)


@pytest.mark.parametrize("h01,measure", [(False, "geometric"),
                                         (True, "geometric"),
                                         (False, "proportional"),
                                         (True, "proportional")])
def test_sketch_plan_variants_equal_reference(h01, measure):
    kw = dict(measure=measure, h01=h01, n_max=7, seed=5)
    _assert_same_plan(jsk.make_sketch_plan(JExp(0.8), 12, 60, **kw),
                      tsk.make_sketch_plan(TExp(0.8), 12, 60, **kw))


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_pack_sketch_matches_reference(smoke):
    """Within 1e-6: both reduce phases mod c in int32 and compute angles,
    cos and sin in fp32; only the libraries' cos/sin may differ by an ulp."""
    jp, tp = _qwen3_plans(smoke)
    jparams, tparams = _tables(jp, 1)
    want = jsk.pack_sketch(jp, jparams)
    got = tsk.pack_sketch(tp, tparams)
    for name, g, w in zip(("wr", "wi", "mr", "mi"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_apply_matches_reference_fft_path(smoke):
    """The port's map (kernel B6's plain version) against the reference's
    ``jnp.fft`` oracle (``use_pallas=False``) on the same tables: 1e-5."""
    jp, tp = _qwen3_plans(smoke)
    jparams, tparams = _tables(jp, 2)
    x = _unit_rows(3 * 7, tp.input_dim, 3).reshape(3, 7, -1)
    want = np.asarray(jsk.apply_sketch_plan(jp, jparams, jnp.asarray(x),
                                            use_pallas=False))
    got = tsk.apply_sketch_plan(tp, tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    packed = tsk.pack_sketch(tp, tparams)
    again = tsk.apply_sketch_plan(tp, tparams, torch.from_numpy(x),
                                  packed=packed)
    assert torch.equal(again, got)


@pytest.mark.parametrize("h01", [False, True])
def test_apply_prefix_columns_match_reference(h01):
    kw = dict(measure="proportional", h01=h01, n_max=5)
    jp = jsk.make_sketch_plan(JExp(1.0), 16, 48, **kw)
    tp = tsk.make_sketch_plan(TExp(1.0), 16, 48, **kw)
    jparams, tparams = _tables(jp, 4)
    x = _unit_rows(9, 16, 5)
    want = np.asarray(jsk.apply_sketch_plan(jp, jparams, jnp.asarray(x),
                                            use_pallas=False))
    got = tsk.apply_sketch_plan(tp, tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# bf16 policy: the port's map rounds x AND the packed cos/sin tensors to
# bf16 (the reference's fused kernel does the same), while the reference's
# CPU path is the FFT oracle, which rounds x only. The budget is the
# reference's own tensor_sketch bf16 feature budget (tests/test_precision.py
# "feature_atol"); the measured gap is 3.0e-3 at |z| <= 1 on the SMOKE head
# (2.0e-3 on the full head) — ROADMAP queue C.
BF16_APPLY_ATOL = 2e-2


@pytest.mark.parametrize("precision,atol", [("fp32", 1e-5),
                                            ("bf16", BF16_APPLY_ATOL)])
def test_registry_apply_matches_reference(precision, atol):
    jp, tp = _qwen3_plans(True)
    jparams, tparams = _tables(jp, 6)
    x = _unit_rows(12, tp.input_dim, 7)
    want = np.asarray(jreg.get("tensor_sketch").apply(
        jp, jparams, jnp.asarray(x), use_pallas=False, precision=precision))
    got = registry.get("tensor_sketch").apply(
        tp, tparams, torch.from_numpy(x), precision=precision)
    assert got.shape == want.shape == (12, tp.output_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("smoke", [True, False], ids=["SMOKE", "FULL"])
def test_fft_oracle_matches_fused_plain_version(smoke):
    """Within the port: the ``torch.fft`` oracle against kernel B6's plain
    version (frequency-domain running product + dense inverse DFT)."""
    _, tp = _qwen3_plans(smoke)
    gen = torch.Generator().manual_seed(8)
    params = tsk.init_sketch_params(tp, gen)
    x = torch.from_numpy(_unit_rows(10, tp.input_dim, 9))
    wr, wi, mr, mi = tsk.pack_sketch(tp, params)
    fused = tskref.tensor_sketch_fused_ref(
        x, wr, wi, torch.from_numpy(tp.column_degrees()), mr, mi,
        torch.from_numpy(tp.column_scales()))
    fft = tskref.tensor_sketch_blocks_ref(tp, params, x)
    np.testing.assert_allclose(fused.numpy(), fft.numpy(), atol=1e-5,
                               rtol=0)


def test_oracles_match_reference_oracles():
    jp, tp = _qwen3_plans(True)
    jparams, tparams = _tables(jp, 10)
    x = _unit_rows(6, tp.input_dim, 11)
    cs_want = np.asarray(jskref.count_sketch_ref(
        jnp.asarray(x), jparams["h"][0], jparams["s"][0], tp.counts[0]))
    cs_got = tskref.count_sketch_ref(torch.from_numpy(x), tparams["h"][0],
                                     tparams["s"][0], tp.counts[0])
    np.testing.assert_allclose(cs_got.numpy(), cs_want, atol=1e-6, rtol=0)
    want = np.asarray(jskref.tensor_sketch_blocks_ref(jp, jparams,
                                                      jnp.asarray(x)))
    got = tskref.tensor_sketch_blocks_ref(tp, tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    packed = jsk.pack_sketch(jp, jparams)
    jdeg, jscale = jnp.asarray(jp.column_degrees()), jnp.asarray(
        jp.column_scales())
    want_f = np.asarray(jskref.tensor_sketch_fused_ref(
        jnp.asarray(x), packed[0], packed[1], jdeg, packed[2], packed[3],
        jscale))
    tpk = [torch.from_numpy(np.array(a)) for a in packed]
    got_f = tskref.tensor_sketch_fused_ref(
        torch.from_numpy(x), tpk[0], tpk[1],
        torch.from_numpy(tp.column_degrees()), tpk[2], tpk[3],
        torch.from_numpy(tp.column_scales()))
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=1e-5, rtol=0)


def test_estimate_gram_matches_reference():
    """``registry.estimate_gram`` over the fused map, row-chunked, against
    the reference's over its FFT path: 1e-5 (Gram entries are O(1))."""
    jp, tp = _qwen3_plans(True)
    jparams, tparams = _tables(jp, 12)
    x = _unit_rows(40, tp.input_dim, 13)
    y = _unit_rows(9, tp.input_dim, 14)
    want = np.asarray(jreg.estimate_gram(
        lambda a: jreg.get("tensor_sketch").apply(jp, jparams, a,
                                                  use_pallas=False),
        jnp.asarray(x), jnp.asarray(y), row_chunk=16))
    apply_fn = lambda a: registry.get("tensor_sketch").apply(  # noqa: E731
        tp, tparams, a)
    got = registry.estimate_gram(apply_fn, torch.from_numpy(x),
                                 torch.from_numpy(y), row_chunk=16)
    assert got.shape == (40, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    whole = registry.featurize_chunked(apply_fn, torch.from_numpy(x))
    parts = registry.featurize_chunked(apply_fn, torch.from_numpy(x),
                                       row_chunk=7)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)


def test_registry_tensor_sketch_entry():
    est = registry.get("tensor_sketch")
    assert not est.fused_attention_supported and est.pack_fused is None
    _, tp = _qwen3_plans(True)
    params = est.init_params(tp, torch.Generator().manual_seed(0))
    assert params["h"].dtype == torch.int32
    assert params["h"].shape == params["s"].shape == (tp.num_funcs,
                                                      tp.input_dim)
    assert set(torch.unique(params["s"]).tolist()) <= {-1.0, 1.0}
    row = 0
    for n, c in zip(tp.degrees, tp.counts):
        block = params["h"][row:row + n]
        assert int(block.min()) >= 0 and int(block.max()) < c
        row += n
    packed = est.pack(tp, params, torch.bfloat16)
    assert [t.dtype for t in packed] == [torch.bfloat16] * 4
    assert packed[0].shape == (tp.max_degree, tp.num_sketch_cols,
                               tp.input_dim)
    x = torch.from_numpy(_unit_rows(5, tp.input_dim, 15))
    assert est.apply(tp, params, x).shape == (5, est.output_dim(tp))


def test_sketch_kernel_wrapper_edges():
    _, tp = _qwen3_plans(True)
    params = tsk.init_sketch_params(tp, torch.Generator().manual_seed(1))
    wr, wi, mr, mi = tsk.pack_sketch(tp, params)
    cd = torch.from_numpy(tp.column_degrees())
    cs = torch.from_numpy(tp.column_scales())
    empty = tensor_sketch_fused(torch.ones(0, tp.input_dim), wr, wi, cd, mr,
                                mi, cs, tp.block_starts())
    assert empty.shape == (0, tp.num_sketch_cols)
    before = tensor_sketch_fused.launches
    out = tensor_sketch_fused(torch.ones(2, 3, tp.input_dim), wr, wi, cd,
                              mr, mi, cs, tp.block_starts())
    assert out.shape == (2, 3, tp.num_sketch_cols)
    assert tensor_sketch_fused.launches == before      # CPU: plain version
    x = torch.ones(2, tp.input_dim, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        tensor_sketch_fused(x, wr, wi, cd, mr, mi, cs, tp.block_starts())


QWEN_BLOCKS = (0, 149, 223, 248, 254, 255)   # qwen3-1.7b's head, Fs 255


def _exp_d4000_blocks():
    """The paper's exp map at d 50, D 4000: 12 degree blocks, the widest
    (degree 1) 2000 columns."""
    plan = tsk.make_sketch_plan(TExp(), 50, 4000)
    return plan.block_starts()


def _many_blocks(n):
    starts = [0]
    for i in range(n):
        starts.append(starts[-1] + 1 + (7 * i) % 13)
    return tuple(starts)


def _assert_items_cover(sc, starts):
    """Every output column of every degree block in exactly one item, each
    item inside its block and at most ``group`` wide."""
    seen = set()
    for n in range(sc.n_items):
        c0, c, g0 = sc.items[3 * n: 3 * n + 3]
        assert (c0, c0 + c) in set(zip(starts, starts[1:]))
        assert 0 <= g0 < c
        for g in range(g0, min(g0 + sc.group, c)):
            assert (c0 + g) not in seen
            seen.add(c0 + g)
    assert seen == set(range(starts[-1]))


@pytest.mark.parametrize("starts,b,d,warps,group", [
    (QWEN_BLOCKS, 64, 128, 8, 16),    # decode: the most blocks in flight
    (QWEN_BLOCKS, 512, 128, 4, 64),   # bucket 32
    (QWEN_BLOCKS, 1024, 128, 4, 160),  # bucket 64: one item a degree block
    (QWEN_BLOCKS, 2048, 128, 4, 160),  # bucket 128
    (QWEN_BLOCKS, 4096, 128, 4, 160),  # bucket 256 / the Gram path
    (QWEN_BLOCKS, 70, 128, 8, 16),    # a ragged row count
    ("exp", 100, 50, 8, 160),         # Fig. 1's 100 rows at D 4000
])
def test_sketch_row_tile_fits_shared_memory(starts, b, d, warps, group):
    """The schedule's warps a block (8 up to SKETCH_WIDE_ROWS rows, else 4)
    and output group (at most the 160 columns whose Mr / Mi slices a block
    stages in shared memory), and items that cover every output column
    once."""
    starts = _exp_d4000_blocks() if starts == "exp" else starts
    sc = common.sketch_schedule(starts, b, d)
    assert (sc.warps, sc.group) == (warps, group)
    assert sc.group <= max(common.SKETCH_GROUPS) == 160
    _assert_items_cover(sc, starts)


@pytest.mark.parametrize("starts,b", [("exp", 100), ("exp", 20000),
                                      ("many", 64), ("many", 4096)])
def test_sketch_schedule_takes_any_block_width_and_count(starts, b):
    """A degree block of any width (the exp map's 2000 columns, which the
    former kernel could not hold in shared memory) and any number of blocks
    (80, past the former limit of 64) schedule, and bad starts raise."""
    starts = _exp_d4000_blocks() if starts == "exp" else _many_blocks(80)
    assert len(starts) - 1 in (12, 80)
    sc = common.sketch_schedule(starts, b, 50)
    _assert_items_cover(sc, starts)
    for bad in ((1, 5), (0, 5, 5), (0,)):
        with pytest.raises(ValueError, match="rise strictly"):
            common.sketch_schedule(bad, b, 50)
