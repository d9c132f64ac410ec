"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips itself without a
CUDA device; the file imports neither jax nor the reference, so it runs on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import init_omegas, pack_omegas, plan_columns
from repro_torch.kernels.rm_attention.ops import (
    rm_attention_causal,
    rm_attention_chunked,
    rm_attention_fused_causal,
    rm_attention_fused_decode_step,
    rm_attention_fused_noncausal,
    rm_attention_fused_prefill,
    rm_fused_apply,
    rm_fused_causal,
    rm_fused_state,
)
from repro_torch.kernels.rm_attention.ref import (
    causal_chunked_ref,
    featurize_ref4,
    rm_attention_decode_ref,
    rm_attention_ref,
    rm_fused_apply_ref,
    rm_fused_causal_ref,
    rm_fused_state_ref,
)
from repro_torch.ctr.plan import init_ctr_params, pack_ctr
from repro_torch.ctr.ref import ctr_feature_fused_ref
from repro_torch.kernels.ctr_feature.ops import ctr_feature_fused
from repro_torch.kernels.structured_feature.ops import (
    structured_feature_fused,
)
from repro_torch.kernels.tensor_sketch.ops import tensor_sketch_fused
from repro_torch.structured.plan import (
    init_structured_params,
    make_structured_plan,
    pack_structured,
)
from repro_torch.structured.ref import structured_feature_fused_ref
from repro_torch.core.maclaurin import ExponentialDotProductKernel
from repro_torch.sketch.plan import init_sketch_params, pack_sketch
from repro_torch.sketch.ref import tensor_sketch_fused_ref
from repro_torch.kernels.rm_feature.ops import (
    apply_feature_map_bucketed,
    rm_feature_bucket,
    rm_feature_fused,
)
from repro_torch.kernels.rm_feature.ref import (
    rm_feature_bucket_ref,
    rm_feature_fused_ref,
)
from repro_torch.models.attention import rm_plan_for

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _plan_tensors(smoke, device, seed=0, arch="qwen3-1.7b"):
    cfg = get_config(arch, smoke=smoke, attention_mode="rm")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, device)
    return cfg.resolved_head_dim, w, cd, cs, gen


def _unit(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return x / x.norm(dim=-1, keepdim=True)


def _close(got, want, tol):
    """max |got - want| <= tol x max(1, max |want|)."""
    err = (got - want).abs().max().item()
    assert err <= tol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [128, 4096, 70])
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
def test_rm_feature_kernel_matches_plain(cuda, dtype, rows, smoke):
    """Tolerance 1e-5: fp32 accumulation in both, only the order of the
    sums differs (bf16 inputs upcast exactly)."""
    d, w, cd, cs, gen = _plan_tensors(smoke, cuda)
    x = _unit((rows, d), gen, cuda).to(dtype)
    w = w.to(dtype)
    before = rm_feature_fused.launches
    got = rm_feature_fused(x, w, cd, cs)
    torch.cuda.synchronize()
    assert rm_feature_fused.launches == before + 1
    _close(got, rm_feature_fused_ref(x, w, cd, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pad", [(256, 56), (40, 9), (5, 0)])
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
def test_rm_fused_causal_kernel_matches_plain(cuda, dtype, t, pad, smoke):
    """Tolerance 1e-4: fp32 sums of up to T x F terms in another order."""
    d, w, cd, cs, gen = _plan_tensors(smoke, cuda, seed=1)
    q = _unit((2, 8, t, d), gen, cuda).to(dtype)
    k = _unit((2, 8, t, d), gen, cuda).to(dtype)
    v = torch.randn((2, 8, t, d), generator=gen, device=cuda)
    kvalid = torch.ones((2, t), device=cuda)
    if pad:
        kvalid[1, t - pad:] = 0.0
    args = (q, k, v, kvalid, w.to(dtype), cd, cs)
    before = rm_fused_causal.launches
    got = rm_fused_causal(*args, 1e-4)
    torch.cuda.synchronize()
    assert rm_fused_causal.launches == before + 1
    for g, w_ in zip(got, rm_fused_causal_ref(*args, chunk=128, eps=1e-4)):
        assert g.shape == w_.shape
        _close(g, w_, 1e-4)


def test_decode_step_launches_one_featurize(cuda):
    d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=2)
    f = w.shape[1]
    q, k = _unit((4, 16, d), gen, cuda), _unit((4, 16, d), gen, cuda)
    v = torch.randn((4, 16, d), generator=gen, device=cuda)
    s0 = torch.zeros((4, 16, f, d), device=cuda)
    n0 = torch.zeros((4, 16, f), device=cuda)
    before = rm_feature_fused.launches
    got = rm_attention_fused_decode_step(q, k, v, s0, n0, w, cd, cs)
    torch.cuda.synchronize()
    assert rm_feature_fused.launches == before + 1
    zq = rm_feature_fused_ref(q.reshape(-1, d), w, cd, cs).reshape(4, 16, f)
    zk = rm_feature_fused_ref(k.reshape(-1, d), w, cd, cs).reshape(4, 16, f)
    for g, w_ in zip(got, rm_attention_decode_ref(zq, zk, v, s0, n0)):
        _close(g, w_, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kern,d,dim,rows", [
    ("poly10", 123, 4000, 2000),    # the adult-shaped map of the paper
    ("poly10", 57, 500, 1840),      # spambase: d % 4 != 0 (plain loads)
    ("exp", 50, 4000, 100),         # deeper columns (degree up to 11)
])
def test_rm_feature_kernel_paper_maps(cuda, dtype, kern, d, dim, rows):
    """B1 on the paper path's maps (``make_feature_map``, ``pack_omegas``:
    F up to 4001 columns, d not a multiple of the 32-byte run) against its
    plain version at 1e-5 x max(1, max |plain|)."""
    from repro_torch.core import (ExponentialDotProductKernel,
                                  PolynomialKernel, make_feature_map)

    kernel = PolynomialKernel(10, 1.0) if kern == "poly10" else \
        ExponentialDotProductKernel(1.0)
    fm = make_feature_map(kernel, d, dim, seed=1, device=cuda)
    w = pack_omegas(fm.plan, fm.omegas).to(dtype)
    cd, cs = plan_columns(fm.plan, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = _unit((rows, d), gen, cuda).to(dtype)
    got = rm_feature_fused(x, w, cd, cs)
    _close(got, rm_feature_fused_ref(x, w, cd, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f,d,kdeg", [(128, 29, 24, 4), (70, 13, 33, 6),
                                           (300, 163, 80, 5),
                                           (4096, 163, 80, 5),
                                           (3000, 200, 33, 6),
                                           (2000, 100, 500, 3)])
def test_rm_feature_kernel_general_omegas(cuda, dtype, rows, f, d, kdeg):
    """B1 with degrees in no order, ragged F and d, and Gaussian omegas
    (not TF32 numbers: fp32 runs all three 3xTF32 terms), on both of its
    kernels (the chain kernel at the first three shapes and at d 500, the
    tile kernel at 3000 and 4096 rows) against its plain version at 1e-5 x
    max(1, max |plain|)."""
    from repro_torch.kernels.common import pick_feature_tiles

    gen = torch.Generator(device=cuda).manual_seed(12)
    w, cd, cs = _ragged_omegas(f, d, kdeg, gen, cuda, seed=4)
    w = (w * torch.randn(w.shape, generator=gen, device=cuda).abs()).to(
        dtype)
    x = _unit((rows, d), gen, cuda).to(dtype)
    tile = pick_feature_tiles(rows, f, d, x.element_size())[0]
    assert tile == (64 if rows in (3000, 4096) else 16)
    _close(rm_feature_fused(x, w, cd, cs),
           rm_feature_fused_ref(x, w, cd, cs), 1e-5)


@pytest.mark.parametrize("t,f_budget,pad", [(256, 256, 56), (4096, 256, 100),
                                            (256, 3400, 30), (2100, 256, 52)])
def test_rm_fused_causal_kernel_3xtf32_and_repeatable(cuda, t, f_budget,
                                                      pad):
    """fp32 B2 (3xTF32 throughout) holds out, S and n within 1e-5 x max(1,
    max |plain|) of its plain version at the prefill shape (BH 16, T 256,
    F 163), a 4096-token prompt (two segments of 32 chunks), 2100 tokens
    (a segment of 32 chunks and one of a ragged chunk) and a wide feature
    axis (F above 2048, which the earlier one-block kernel refused), and
    two calls are bitwise equal (a fixed order of sums, no atomics). The
    plans are qwen3's rm head's (d 128) at a feature budget of 256 (F 163)
    and 3400."""
    from repro_torch.core.maclaurin import ExponentialDotProductKernel
    from repro_torch.core.plan import make_feature_plan

    d = 128
    plan = make_feature_plan(ExponentialDotProductKernel(1.0), d, f_budget,
                             measure="proportional", n_max=8)
    gen = torch.Generator(device=cuda).manual_seed(13)
    w = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, cuda)
    assert w.shape[1] == (163 if f_budget == 256 else w.shape[1])
    assert f_budget == 256 or w.shape[1] >= 2048
    q = _unit((1, 16, t, d), gen, cuda)
    k = _unit((1, 16, t, d), gen, cuda)
    v = torch.randn((1, 16, t, d), generator=gen, device=cuda)
    kvalid = torch.ones((1, t), device=cuda)
    kvalid[0, t - pad:] = 0.0
    args = (q, k, v, kvalid, w, cd, cs)
    got = rm_fused_causal(*args, 1e-4)
    again = rm_fused_causal(*args, 1e-4)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w_ in zip(got, rm_fused_causal_ref(*args, chunk=128, eps=1e-4)):
        _close(g, w_, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv,f,kdeg", [(33, 37, 29, 4), (200, 136, 13, 6),
                                         (16, 1, 42, 6)])
def test_rm_fused_causal_kernel_general_shapes(cuda, dtype, d, dv, f, kdeg):
    """B2 on shapes the model does not give it (odd d and dv: plain loads;
    d 200, dv 136: three value groups in pass B; one value column;
    degrees in no order) against its plain version, tolerance
    1e-4 x max(1, max |plain|), and against the plain version at the
    kernel's 64-position chunk, the kernel's order of sums."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    w, cd, cs = _ragged_omegas(f, d, kdeg, gen, cuda, seed=5)
    w = w.to(dtype)
    q = _unit((2, 3, 150, d), gen, cuda).to(dtype)
    k = _unit((2, 3, 150, d), gen, cuda).to(dtype)
    v = torch.randn((2, 3, 150, dv), generator=gen, device=cuda)
    kvalid = torch.ones((2, 150), device=cuda)
    kvalid[1, 120:] = 0.0
    args = (q, k, v, kvalid, w, cd, cs)
    got = rm_fused_causal(*args, 1e-4)
    for g, w_ in zip(got, rm_fused_causal_ref(*args, chunk=128, eps=1e-4)):
        _close(g, w_, 1e-4)
    for g, w_ in zip(got, rm_fused_causal_ref(*args, chunk=64, eps=1e-4)):
        _close(g, w_, 1e-4)


@pytest.mark.parametrize("t", [256, 4096, 32768])
def test_rm_fused_causal_scratch_is_bounded(cuda, t):
    """A B2 call allocates its outputs and a scratch of at most 32 chunk
    states (``CausalSchedule.scratch_bytes``), whatever T: the device
    memory it takes above its inputs stays within that (qwen3's rm head,
    BH 16, F 163, fp32)."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    plan = rm_plan_for(get_config("qwen3-1.7b", attention_mode="rm"), 128)
    w = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, cuda)
    q = _unit((1, 16, t, 128), gen, cuda)
    k = _unit((1, 16, t, 128), gen, cuda)
    v = torch.randn((1, 16, t, 128), generator=gen, device=cuda)
    kvalid = torch.ones((1, t), device=cuda)
    f = w.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out, s, n = rm_fused_causal(q, k, v, kvalid, w, cd, cs, 1e-4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    sched = rm_fused_causal.last_schedule
    assert sched.seg_chunks == min(t // 64, 32)
    assert sched.scratch_bytes == 4 * 16 * sched.seg_chunks * f * 129
    outputs = 4 * 16 * (t * 128 + f * 129)
    assert peak <= outputs + sched.scratch_bytes + (1 << 20)
    assert torch.isfinite(out).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("dtype,d", [(torch.float32, 640),
                                     (torch.bfloat16, 1088),
                                     (torch.float32, 392)])
def test_noncausal_kernels_tile_deep_d(cuda, dtype, d):
    """B3 and B4 past the depth they take whole (d 384 fp32 / 768 bf16 for
    B3, 536 / 1072 for B4 on the depth-5 rm plans, where the kernels
    raised before d was tiled): d is tiled in the featurize, and both
    match their plain versions (fp32 within 1e-5 x max(1, max |plain|),
    the 3xTF32 gate; bf16 within 1e-4); B3 stays bitwise repeatable. The
    plan is the hubert rm head's at head width d (F 163, degrees up to
    5)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    plan = rm_plan_for(get_config("hubert-xlarge", attention_mode="rm"), d)
    w = pack_omegas(plan, init_omegas(plan, gen)).to(dtype)
    cd, cs = plan_columns(plan, cuda)
    bh, t = 8, 300
    k = _unit((bh, t, d), gen, cuda).to(dtype)
    q = _unit((bh, t, d), gen, cuda).to(dtype)
    v = torch.randn((bh, t, 80), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    kvalid[-1, t - 40:] = 0.0
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs)
    sched3 = rm_fused_state.last_schedule
    s2, n2 = rm_fused_state(k, v, kvalid, w, cd, cs)
    assert torch.equal(s, s2) and torch.equal(n, n2)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    _close(s, s_ref, tol)
    _close(n, n_ref, tol)
    out = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4)
    sched4 = rm_fused_apply.last_schedule
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), tol)
    if d > 536:
        assert sched3.dk < sched3.dp and sched4.dk < sched4.dp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 1024, 2048, 4096, 70])
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
def test_tensor_sketch_kernel_matches_plain(cuda, dtype, rows, smoke):
    """Kernel B6 (block-diagonal inverse DFT) against its plain version
    (dense inverse DFT). Tolerance 1e-5: fp32 accumulation in both, only
    the order of the sums differs."""
    cfg = get_config("qwen3-1.7b", smoke=smoke, attention_mode="rm",
                     estimator="tensor_sketch")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(3)
    packed = [t.to(dtype) for t in pack_sketch(
        plan, init_sketch_params(plan, gen))]
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, plan.input_dim), gen, cuda).to(dtype)
    wr, wi, mr, mi = packed
    before = tensor_sketch_fused.launches
    got = tensor_sketch_fused(x, wr, wi, cd, mr, mi, cs, plan.block_starts())
    torch.cuda.synchronize()
    assert tensor_sketch_fused.launches == before + 1
    _close(got, tensor_sketch_fused_ref(x, wr, wi, cd, mr, mi, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [100, 1000])
def test_tensor_sketch_kernel_paper_width_d4000(cuda, dtype, rows):
    """B6 on the paper's exp map at d 50, D 4000: 12 degree blocks, the
    widest 2000 columns, which the earlier kernel could not hold in shared
    memory (it raised); against its plain version within 1e-5 x max(1, max
    |plain|) (fp32 sums of 2000 inverse-DFT terms in another order)."""
    from repro_torch.sketch.plan import make_sketch_plan

    plan = make_sketch_plan(ExponentialDotProductKernel(), 50, 4000)
    assert max(plan.counts) == 2000 and len(plan.counts) == 12
    gen = torch.Generator(device=cuda).manual_seed(11)
    wr, wi, mr, mi = (t.to(dtype) for t in pack_sketch(
        plan, init_sketch_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, 50), gen, cuda).to(dtype)
    got = tensor_sketch_fused(x, wr, wi, cd, mr, mi, cs, plan.block_starts())
    _close(got, tensor_sketch_fused_ref(x, wr, wi, cd, mr, mi, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 4096])
def test_sketch_and_ctr_kernels_are_bitwise_repeatable(cuda, dtype, rows):
    """Two calls of B6 and of B7 on the same inputs are bitwise equal
    (every output element written by one thread in one order, no
    atomics), at the decode rows and a bucket-256 prefill's."""
    cfg = get_config("qwen3-1.7b", attention_mode="rm",
                     estimator="tensor_sketch")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(12)
    wr, wi, mr, mi = (t.to(dtype) for t in pack_sketch(
        plan, init_sketch_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, plan.input_dim), gen, cuda).to(dtype)
    a = tensor_sketch_fused(x, wr, wi, cd, mr, mi, cs, plan.block_starts())
    b = tensor_sketch_fused(x, wr, wi, cd, mr, mi, cs, plan.block_starts())
    assert torch.equal(a, b)
    ccfg = get_config("qwen3-1.7b", attention_mode="rm", estimator="ctr")
    cplan = rm_plan_for(ccfg, ccfg.resolved_head_dim)
    cwr, cwi = (t.to(dtype) for t in pack_ctr(cplan,
                                              init_ctr_params(cplan, gen)))
    ccd, ccs = plan_columns(cplan, cuda)
    assert torch.equal(ctr_feature_fused(x, cwr, cwi, ccd, ccs),
                       ctr_feature_fused(x, cwr, cwi, ccd, ccs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,f,pad", [(256, 256, 56), (32, 256, 0),
                                     (256, 255, 56), (40, 163, 9),
                                     (20, 64, 0)])
def test_rm_attention_chunked_kernel_matches_plain(cuda, dtype, t, f, pad):
    """Kernel B5 through ``rm_attention_causal`` (chunk min(128, T)) against
    the plain chunked formulation, evaluated in float64 (``causal_chunked_ref``
    keeps float64 inputs in float64). Tolerance 1e-4 x max(1, max |plain|):
    these signed features put some denominators near zero, where outputs
    reach hundreds and fp32 arithmetic itself (the plain version's in fp32)
    lands close to that tolerance off the float64 value."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    zq = (0.3 * torch.randn((2, 8, t, f), generator=gen, device=cuda))
    zk = (0.3 * torch.randn((2, 8, t, f), generator=gen, device=cuda))
    zq[..., 0] = zk[..., 0] = 1.0
    if pad:
        zk[1, :, t - pad:] = 0.0
    zq, zk = zq.to(dtype), zk.to(dtype)
    v = torch.randn((2, 8, t, 128), generator=gen, device=cuda)
    before = rm_attention_chunked.launches
    got = rm_attention_causal(zq, zk, v, chunk=128, eps=1e-4)
    torch.cuda.synchronize()
    assert rm_attention_chunked.launches == before + 1
    want = causal_chunked_ref(zq.double(), zk.double(), v.double(), 128,
                              1e-4)
    assert got.shape == want.shape
    _close(got.double(), want, 1e-4)


def _chunked_inputs(t, f, pad, dtype, device, seed=17):
    """Features of ``[2, 8, t, f]`` with a constant first column and 0.1 x
    N(0, 1) entries past it, so each score is 1 +- 0.1 sqrt(f - 1) x 0.1
    and every denominator stays near its prefix length: there fp32
    arithmetic is good to about 1e-7 and a product in plain TF32 (about
    5e-4 per term) shows above the 3xTF32 gate 1e-5."""
    gen = torch.Generator(device=device).manual_seed(seed)
    zq = 0.1 * torch.randn((2, 8, t, f), generator=gen, device=device)
    zk = 0.1 * torch.randn((2, 8, t, f), generator=gen, device=device)
    zq[..., 0] = zk[..., 0] = 1.0
    if pad:
        zk[1, :, t - pad:] = 0.0
    v = torch.randn((2, 8, t, 128), generator=gen, device=device)
    return zq.to(dtype), zk.to(dtype), v


@pytest.mark.parametrize("t,f,pad,chunk", [(256, 256, 56, 128),
                                           (32, 256, 0, 128),
                                           (256, 255, 56, 128),
                                           (40, 163, 9, 128), (20, 64, 0, 128),
                                           (256, 256, 56, 32),
                                           (256, 255, 30, 64)])
def test_rm_attention_chunked_kernel_3xtf32_and_repeatable(cuda, t, f, pad,
                                                           chunk):
    """fp32 B5 runs its three products in 3xTF32: pass B within 1e-5 x
    max(1, max |plain|) of its plain version (in float64) on the same
    prefixes, at the shapes of
    ``test_rm_attention_chunked_kernel_matches_plain`` and at chunks 32 and
    64, on features whose denominators stay clear of 0
    (``_chunked_inputs``); two calls are bitwise equal (a fixed order of
    sums, no atomics)."""
    from repro_torch.kernels.rm_attention.ref import (
        chunk_states,
        rm_attention_chunked_ref,
    )

    zq, zk, v = _chunked_inputs(t, f, pad, torch.float32, cuda)
    c = min(chunk, t)
    tp = -(-t // c) * c
    zq, zk, v = (torch.nn.functional.pad(a, (0, 0, 0, tp - t))
                 for a in (zq, zk, v))
    s_prev, n_prev = chunk_states(zk, v, c)
    n = tp // c
    args = (zq.reshape(16, tp, f), zk.reshape(16, tp, f),
            v.reshape(16, tp, 128), s_prev.reshape(16, n, f, 128),
            n_prev.reshape(16, n, f))
    got = rm_attention_chunked(*args, chunk=c, eps=1e-4)
    again = rm_attention_chunked(*args, chunk=c, eps=1e-4)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = rm_attention_chunked_ref(*(a.double() for a in args), chunk=c,
                                    eps=1e-4)
    _close(got.double(), want, 1e-5)
    sched = rm_attention_chunked.last_schedule
    assert sched.blocks == 2 * 16 * n * sched.q_tiles


def test_rm_attention_chunked_kernel_prefill_grid(cuda):
    """At the bucket-256 prefill (BH 16, T 256, chunk 128, F 256, dv 128) B5
    launches at least two blocks an SM: 16-row query tiles of two blocks,
    512 blocks."""
    zq, zk, v = _chunked_inputs(256, 256, 56, torch.float32, cuda)
    zq, zk, v = (a.reshape(1, 16, 256, -1) for a in (zq, zk, v))
    rm_attention_causal(zq, zk, v, chunk=128, eps=1e-4)
    sched = rm_attention_chunked.last_schedule
    assert sched.rows == 16 and sched.blocks == 512 >= 2 * 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dv,chunk", [(300, 64), (37, 40), (1, 20),
                                      (300, 1024)])
def test_rm_attention_chunked_kernel_ragged_values(cuda, dtype, dv, chunk):
    """B5 at value widths the models do not give it: two value groups (dv
    300), an odd width (4-byte copies), a single column, and a chunk of
    1024 keys (two windows of scores, formed again for the second value
    group), on a ragged F 45,
    against its plain version in float64: within 1e-4 x max(1, max
    |plain|) for bf16 features, the 3xTF32 gate 1e-5 for fp32 (features as
    ``_chunked_inputs``)."""
    from repro_torch.kernels.rm_attention.ref import (
        chunk_states,
        rm_attention_chunked_ref,
    )

    gen = torch.Generator(device=cuda).manual_seed(18)
    bh, t, f = 3, 4 * chunk, 45
    zq = 0.1 * torch.randn((bh, t, f), generator=gen, device=cuda)
    zk = 0.1 * torch.randn((bh, t, f), generator=gen, device=cuda)
    zq[..., 0] = zk[..., 0] = 1.0
    v = torch.randn((bh, t, dv), generator=gen, device=cuda)
    zq, zk = zq.to(dtype), zk.to(dtype)
    s_prev, n_prev = chunk_states(zk[None], v[None], chunk)
    args = (zq, zk, v, s_prev[0], n_prev[0])
    got = rm_attention_chunked(*args, chunk=chunk, eps=1e-4)
    want = rm_attention_chunked_ref(*(a.double() for a in args), chunk=chunk,
                                    eps=1e-4)
    _close(got.double(), want, 1e-5 if dtype == torch.float32 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,pad,dv", [(128, 1536, 36, 80), (128, 1500, 0, 80),
                                         (16, 32768, 0, 80), (8, 70, 9, 80),
                                         (4, 33, 0, 200), (16, 256, 0, 16)])
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
def test_rm_fused_state_and_apply_kernels_match_plain(cuda, dtype, bh, t,
                                                      pad, dv, smoke):
    """Kernels B3 and B4 on the hubert head (d 80, F 163; SMOKE d 16, F
    42) against their plain versions: the encode's shape (8 clips x 16
    heads, 1500 frames: T ragged against the 64-row tile) and the long
    encode's (16 heads, 32768 frames: the longest sums), padded keys, dv 80
    and 16 (one value slice, masked), dv 200 (two slices). Tolerance 1e-4:
    fp32 sums of up to T x F terms in another order."""
    d, w, cd, cs, gen = _plan_tensors(smoke, cuda, seed=5,
                                      arch="hubert-xlarge")
    k = _unit((bh, t, d), gen, cuda).to(dtype)
    q = _unit((bh, t, d), gen, cuda).to(dtype)
    v = torch.randn((bh, t, dv), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    if pad:
        kvalid[bh // 2:, t - pad:] = 0.0
    w = w.to(dtype)
    before = (rm_fused_state.launches, rm_fused_apply.launches)
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs)
    out = rm_fused_apply(q, s, n, w, cd, cs, 1e-4)
    torch.cuda.synchronize()
    assert (rm_fused_state.launches, rm_fused_apply.launches) == (
        before[0] + 1, before[1] + 1)
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    _close(s, s_ref, 1e-4)
    _close(n, n_ref, 1e-4)
    # B4 on the plain state, so its check does not inherit B3's error
    out_b4 = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4)
    _close(out_b4, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4),
           1e-4)
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), 1e-4)


@pytest.mark.parametrize("t,pad", [(256, 30), (40, 0), (1500, 36)])
def test_rm_fused_noncausal_op_matches_quadratic(cuda, t, pad):
    """The whole op (B3, B4 on the unpadded rows) against the O(T^2) direct evaluation
    ``(Zq Zk^T) V / clamp(rowsum)``, fp32. Tolerance 1e-4."""
    d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=6,
                                      arch="hubert-xlarge")
    q = _unit((2, 8, t, d), gen, cuda)
    k = _unit((2, 8, t, d), gen, cuda)
    v = torch.randn((2, 8, t, d), generator=gen, device=cuda)
    kvalid = torch.ones((2, t), device=cuda)
    if pad:
        kvalid[1, t - pad:] = 0.0
    got = rm_attention_fused_noncausal(q, k, v, w, cd, cs, kvalid=kvalid)
    zq = featurize_ref4(q, w, cd, cs)
    zk = featurize_ref4(k, w, cd, cs) * kvalid[:, None, :, None]
    want = rm_attention_ref(zq, zk, v, causal=False)
    assert got.shape == want.shape
    _close(got, want, 1e-4)


def _ragged_omegas(f, d, kdeg, gen, device, seed=0):
    """A plan of degrees 0..kdeg in no order (F ragged against the
    8-column tile, two degree-0 columns), +-1 omegas on the slots a column
    uses, scales in [0.2, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    deg = torch.randint(0, kdeg + 1, (f,), generator=g, dtype=torch.int32)
    deg[0] = deg[f // 2] = 0
    w = torch.randint(0, 2, (kdeg, f, d), generator=g).float() * 2 - 1
    w = w * (torch.arange(kdeg)[:, None] < deg[None, :])[..., None]
    scale = 0.2 + 1.3 * torch.rand(f, generator=g)
    return w.to(device), deg.to(device), scale.to(device)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 80),
                                     (torch.bfloat16, 80),
                                     (torch.float32, 128)])
def test_noncausal_kernels_take_a_column_of_degree_96(cuda, dtype, d):
    """B3 and B4 on a hand-built plan with a column tile of depth 96 (three
    columns of degree 96 beside 30 shallow ones), which the earlier
    schedule refused: in fp32 its slab rows do not fit even a depth chunk
    at a time, so they go in pieces of whole slots (``slot_rows``), the
    running product carried across the pieces; both kernels match their
    plain versions (fp32 within 1e-5 x max(1, max |plain|), the 3xTF32
    gate; bf16 within 1e-4, the B3 / B4 gate). Rows near a coordinate axis
    keep each of the 96 factors near +-1, so a missing or repeated slot
    shows."""
    from repro_torch.core.plan import FeaturePlan

    plan = FeaturePlan(degrees=(1, 2, 96), counts=(20, 10, 3),
                       scales=(1.0, 0.5, 0.25), const=0.0, h01=False,
                       h01_a0=0.0, h01_a1=0.0, input_dim=d, num_random=33,
                       coefs_host=(0.0,) * 100, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(16)
    w = pack_omegas(plan, init_omegas(plan, gen)).to(dtype)
    cd, cs = plan_columns(plan, cuda)
    bh, t = 2, 300

    def rows():
        x = torch.zeros((bh, t, d), device=cuda)
        x[..., 0] = 1.0
        x += 0.02 / d ** 0.5 * torch.randn((bh, t, d), generator=gen,
                                           device=cuda)
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    k, q = rows(), rows()
    v = torch.randn((bh, t, 64), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    kvalid[-1, t - 50:] = 0.0
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs)
    sched3 = rm_fused_state.last_schedule
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    assert n_ref.abs().max().item() > 1.0      # the deep features count
    _close(s, s_ref, tol)
    _close(n, n_ref, tol)
    out = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4)
    sched4 = rm_fused_apply.last_schedule
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), tol)
    if dtype == torch.float32:
        assert sched3.slot_rows > 0 and sched4.slot_rows > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,d,f,kdeg,dv", [
    (2, 700, 24, 29, 4, 37),     # ragged T, F, dv (dv % 4: plain loads)
    (3, 130, 33, 13, 6, 1),      # odd d (plain loads), one value column
    (2, 300, 80, 163, 5, 136),   # dv > 128: two value groups
    (2, 200, 256, 64, 8, 64),    # the slab does not fit: chunks
    (1, 4000, 16, 42, 6, 16),    # few rows, long T: many splits
])
def test_noncausal_kernels_general_shapes(cuda, dtype, bh, t, d, f, kdeg,
                                          dv):
    """B3 and B4 on plans and shapes the encoder does not give them,
    against their plain versions (tolerance 1e-4 x max(1, max |plain|)),
    and B3's split order against its plain model
    (``state_by_splits_ref`` at the kernel's own schedule)."""
    from repro_torch.kernels.rm_attention.noncausal import (
        state_by_splits_ref,
    )

    gen = torch.Generator(device=cuda).manual_seed(9)
    w, cd, cs = _ragged_omegas(f, d, kdeg, gen, cuda)
    w = w.to(dtype)
    k = _unit((bh, t, d), gen, cuda).to(dtype)
    q = _unit((bh, t, d), gen, cuda).to(dtype)
    v = torch.randn((bh, t, dv), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    kvalid[-1, t - t // 3:] = 0.0
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs)
    sched = rm_fused_state.last_schedule
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    _close(s, s_ref, 1e-4)
    _close(n, n_ref, 1e-4)
    s_split, n_split = state_by_splits_ref(
        k, v, kvalid, w, cd, cs, splits=sched.splits,
        tiles_per_split=sched.tiles_per_split)
    _close(s, s_split, 1e-4)
    _close(n, n_split, 1e-4)
    out = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4)
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), 1e-4)


@pytest.mark.parametrize("bh,t,d,dv", [(4, 700, 80, 80), (2, 300, 33, 37)])
def test_noncausal_kernels_full_3xtf32(cuda, bh, t, d, dv):
    """Gaussian omegas (not TF32 numbers, so the fp32 kernels run all
    three 3xTF32 terms) against the plain versions, tolerance 1e-4 x
    max(1, max |plain|)."""
    from repro_torch.kernels.rm_attention.noncausal import pack_noncausal

    gen = torch.Generator(device=cuda).manual_seed(10)
    w, cd, cs = _ragged_omegas(40, d, 4, gen, cuda, seed=3)
    w = w * torch.randn(w.shape, generator=gen, device=cuda).abs()
    pack = pack_noncausal(w, cd, cs)
    assert not pack.tf32_exact
    k = _unit((bh, t, d), gen, cuda)
    q = _unit((bh, t, d), gen, cuda)
    v = torch.randn((bh, t, dv), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs, pack=pack)
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    _close(s, s_ref, 1e-4)
    _close(n, n_ref, 1e-4)
    out = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4, pack=pack)
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), 1e-4)


@pytest.mark.parametrize("omegas,bh,t", [("rm", 128, 1500),
                                          ("rm", 16, 32768),
                                          ("gaussian", 4, 700)])
def test_noncausal_kernels_are_3xtf32_accurate(cuda, omegas, bh, t):
    """fp32 B3 and B4 hold S, n and out within 1e-5 x max(1, max |plain|)
    of their plain versions: 3xTF32 reads about 2e-6 to 7e-6 at the
    encode's and the long encode's shapes, while plain TF32 in the
    projection fails here and still passes the 1e-4 tolerance at those
    shapes. ``rm``: the hubert plan's +-1 omegas (two TF32 terms in the
    projection); ``gaussian``: all three."""
    from repro_torch.kernels.rm_attention.noncausal import pack_noncausal

    if omegas == "rm":
        d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=5,
                                          arch="hubert-xlarge")
    else:
        d = 80
        gen = torch.Generator(device=cuda).manual_seed(10)
        w, cd, cs = _ragged_omegas(40, d, 4, gen, cuda, seed=3)
        w = w * torch.randn(w.shape, generator=gen, device=cuda).abs()
    pack = pack_noncausal(w, cd, cs)
    assert pack.tf32_exact == (omegas == "rm")
    k = _unit((bh, t, d), gen, cuda)
    q = _unit((bh, t, d), gen, cuda)
    v = torch.randn((bh, t, d), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    s, n = rm_fused_state(k, v, kvalid, w, cd, cs, pack=pack)
    s_ref, n_ref = rm_fused_state_ref(k, v, kvalid, w, cd, cs)
    _close(s, s_ref, 1e-5)
    _close(n, n_ref, 1e-5)
    out = rm_fused_apply(q, s_ref, n_ref, w, cd, cs, 1e-4, pack=pack)
    _close(out, rm_fused_apply_ref(q, s_ref, n_ref, w, cd, cs, 1e-4), 1e-5)


@pytest.mark.parametrize("bh,t", [(16, 32768), (128, 1500), (3, 100)])
def test_rm_fused_state_is_bitwise_repeatable(cuda, bh, t):
    """No atomics: two calls sum in the same order, so S and n are
    bitwise equal (the split path, the encode shape, one split)."""
    d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=8,
                                      arch="hubert-xlarge")
    k = _unit((bh, t, d), gen, cuda)
    v = torch.randn((bh, t, d), generator=gen, device=cuda)
    kvalid = torch.ones((bh, t), device=cuda)
    s1, n1 = rm_fused_state(k, v, kvalid, w, cd, cs)
    s2, n2 = rm_fused_state(k, v, kvalid, w, cd, cs)
    assert torch.equal(s1, s2) and torch.equal(n1, n2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 512, 4096, 70])
@pytest.mark.parametrize("arch,smoke", [("qwen3-1.7b", False),
                                        ("qwen3-1.7b", True),
                                        ("hubert-xlarge", False)])
def test_ctr_kernel_matches_plain(cuda, dtype, rows, arch, smoke):
    """Kernel B7 against its plain version: the decode rows (4 slots x 16
    heads), prefill rows, a ragged count; Fc 127 (ragged against a block's
    32 columns), head widths 128, 16 and 80. Tolerance 1e-5: fp32
    accumulation in both, only the order of the sums differs."""
    cfg = get_config(arch, smoke=smoke, attention_mode="rm", estimator="ctr")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(7)
    wr, wi = (t.to(dtype) for t in pack_ctr(plan, init_ctr_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, plan.input_dim), gen, cuda).to(dtype)
    before = ctr_feature_fused.launches
    got = ctr_feature_fused(x, wr, wi, cd, cs)
    torch.cuda.synchronize()
    assert ctr_feature_fused.launches == before + 1
    assert got.shape == (rows, 2 * plan.num_complex)
    _close(got, ctr_feature_fused_ref(x, wr, wi, cd, cs), 1e-5)


@pytest.mark.parametrize("rows,d", [(64, 128), (3000, 128), (100, 33)])
def test_ctr_kernel_general_fp32_weights(cuda, rows, d):
    """B7 given fp32 weights that are not TF32 numbers (the plans' are
    {0, +-1}): the warp vote finds their remainders and keeps the third
    3xTF32 term, so the kernel holds its plain version within 1e-5 x
    max(1, max |plain|); at the decode rows, many rows, and an odd d (plain
    loads)."""
    cfg = get_config("qwen3-1.7b", attention_mode="rm", estimator="ctr")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(13)
    cd, cs = plan_columns(plan, cuda)
    shape = (plan.max_degree, plan.num_complex, d)
    wr = torch.randn(shape, generator=gen, device=cuda) / d ** 0.5
    wi = torch.randn(shape, generator=gen, device=cuda) / d ** 0.5
    x = _unit((rows, d), gen, cuda)
    _close(ctr_feature_fused(x, wr, wi, cd, cs),
           ctr_feature_fused_ref(x, wr, wi, cd, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 512, 4096, 70])
@pytest.mark.parametrize("arch,smoke", [("qwen3-1.7b", False),
                                        ("qwen3-1.7b", True),
                                        ("hubert-xlarge", False)])
def test_structured_kernel_matches_plain(cuda, dtype, rows, arch, smoke):
    """Kernel B8 against its plain version on the model plans (d_pad 128
    and 16; hubert's x at its true width 80 of 128). Tolerance 1e-5: fp32
    products of 128-term butterflies in another order; the surplus
    columns (scale 0) come out exactly 0."""
    cfg = get_config(arch, smoke=smoke, attention_mode="rm",
                     estimator="structured")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(8)
    d1, d2 = (t.to(dtype) for t in pack_structured(
        plan, init_structured_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, plan.input_dim), gen, cuda).to(dtype)
    before = structured_feature_fused.launches
    got = structured_feature_fused(x, d1, d2, cd, cs)
    torch.cuda.synchronize()
    assert structured_feature_fused.launches == before + 1
    _close(got, structured_feature_fused_ref(x, d1, d2, cd, cs), 1e-5)
    assert not got[:, cs == 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(1, 70), (2, 5), (8, 64), (32, 300),
                                    (100, 33), (256, 64), (512, 9),
                                    (1024, 70), (1024, 4096)])
def test_structured_kernel_every_d_pad(cuda, dtype, d, rows):
    """Kernel B8 at d_pad 1 (the identity transform) to 1024, x narrower
    than d_pad where d is not a power of two. Tolerance 1e-5 x max(1,
    max |plain|): the butterfly's sums grow with d_pad."""
    plan = make_structured_plan(ExponentialDotProductKernel(1.0), d, 600,
                                measure="proportional", n_max=4)
    gen = torch.Generator(device=cuda).manual_seed(9)
    d1, d2 = (t.to(dtype) for t in pack_structured(
        plan, init_structured_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, d), gen, cuda).to(dtype)
    got = structured_feature_fused(x, d1, d2, cd, cs)
    torch.cuda.synchronize()
    _close(got, structured_feature_fused_ref(x, d1, d2, cd, cs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(2048, 9), (3000, 5), (8192, 3)])
def test_structured_kernel_block_path(cuda, dtype, d, rows):
    """B8's block path (d_pad 2048 to 8192: one block of 256 threads a row,
    the stages past a warp through shared memory) against its plain
    version, tolerance 1e-5 x max(1, max |plain|), and bitwise equal over
    two calls."""
    plan = make_structured_plan(ExponentialDotProductKernel(1.0), d, 2 * d,
                                measure="proportional", n_max=3)
    gen = torch.Generator(device=cuda).manual_seed(19)
    d1, d2 = (t.to(dtype) for t in pack_structured(
        plan, init_structured_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, d), gen, cuda).to(dtype)
    got = structured_feature_fused(x, d1, d2, cd, cs)
    assert structured_feature_fused.last_schedule.wide
    assert torch.equal(got, structured_feature_fused(x, d1, d2, cd, cs))
    _close(got, structured_feature_fused_ref(x, d1, d2, cd, cs), 1e-5)


@pytest.mark.parametrize("d", [1, 2, 8, 16, 33, 100, 128, 256, 512, 1024,
                               2048, 8192])
def test_structured_kernel_kept_columns_equal_full_width(cuda, d):
    """B8 writing only each bucket's kept columns into the map
    (``apply_structured_plan``, ``structured_keep``) equals the full-width
    output sliced by bucket, at every d_pad from 1 to 8192, and no column
    outside the kept ones is written; two calls are bitwise equal."""
    from repro_torch.core.plan import prefix_columns
    from repro_torch.structured.plan import (
        apply_structured_plan,
        structured_keep,
    )

    plan = make_structured_plan(ExponentialDotProductKernel(1.0), d,
                                max(40, 3 * d), measure="proportional",
                                n_max=4)
    gen = torch.Generator(device=cuda).manual_seed(20)
    params = init_structured_params(plan, gen)
    d1, d2 = pack_structured(plan, params)
    cd, cs = plan_columns(plan, cuda)
    x = _unit((70, d), gen, cuda)
    full = structured_feature_fused(x, d1, d2, cd, cs)
    pieces, off = [], 0
    for c, n_st in zip(plan.counts, plan.stacks_per_bucket):
        pieces.append(full[:, off: off + c])
        off += n_st * plan.d_pad
    want = torch.cat(prefix_columns(plan, x, torch.float32) + pieces, dim=-1)
    got = apply_structured_plan(plan, params, x)
    assert torch.equal(got, want)
    assert torch.equal(got, apply_structured_plan(plan, params, x))
    out = torch.full((70, plan.output_dim), float("nan"), device=cuda)
    structured_feature_fused(x, d1, d2, cd, cs, out=out,
                             keep=structured_keep(plan))
    p = plan.num_prefix_columns
    assert out[:, :p].isnan().all() and not out[:, p:].isnan().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 4096, 70])
def test_structured_kernel_is_bitwise_repeatable(cuda, dtype, rows):
    """Two calls of B8 on the same inputs are bitwise equal (each output
    written by one lane in one order, no atomics), at full width and
    through ``apply_structured_plan``."""
    from repro_torch.structured.plan import apply_structured_plan

    cfg = get_config("qwen3-1.7b", attention_mode="rm",
                     estimator="structured")
    plan = rm_plan_for(cfg, cfg.resolved_head_dim)
    gen = torch.Generator(device=cuda).manual_seed(21)
    params = init_structured_params(plan, gen)
    d1, d2 = (t.to(dtype) for t in pack_structured(plan, params))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, plan.input_dim), gen, cuda)
    xd = x.to(dtype)
    assert torch.equal(structured_feature_fused(xd, d1, d2, cd, cs),
                       structured_feature_fused(xd, d1, d2, cd, cs))
    prec = "bf16" if dtype == torch.bfloat16 else "fp32"
    assert torch.equal(apply_structured_plan(plan, params, x, prec),
                       apply_structured_plan(plan, params, x, prec))


# the reference's SHAPES grid (tests/test_kernels_rm_feature.py) as (batch,
# d, count, degree), then the paper path's ragged shapes: d 8, 22, 50, 57,
# 123 (rows of 16-, 8- and 4-byte alignment), counts 1 to 4000 (ragged
# against the 8-column tile), degrees 1 to 11; then the tile kernel at
# 20000 and 4096 rows, d 208 (its x tile and one run buffer just fit
# shared memory in fp32) and past the tile's limit (d 216 fp32, d 1000:
# the chain kernel), degree 24 (n_max), a count that is no multiple of 8
# and a single row
BUCKET_SHAPES = [
    (8, 16, 32, 1), (8, 16, 32, 2), (32, 64, 128, 3), (7, 33, 19, 4),
    (128, 128, 128, 5), (1, 8, 1, 7), (64, 256, 64, 10),
    (70, 57, 125, 1), (1840, 57, 63, 2), (65, 123, 1000, 1),
    (33, 8, 1, 9), (100, 50, 4000, 10), (3, 22, 2, 11), (129, 22, 65, 6),
    (1840, 57, 1, 8),
    (20000, 50, 500, 10), (4096, 208, 256, 2), (4096, 216, 256, 2),
    (2048, 1000, 40, 3), (600, 57, 21, 24), (4096, 123, 333, 3),
    (1, 57, 13, 2),
]
# shapes at which both of B9's kernels run (forced through the schedule):
# ragged rows, counts and d of every copy width, odd and even degrees
BUCKET_BOTH_SHAPES = [
    (7, 33, 19, 4), (129, 22, 65, 6), (300, 57, 13, 3), (1000, 64, 125, 1),
    (640, 50, 40, 5), (520, 57, 33, 7), (256, 123, 250, 2),
    (1000, 50, 16, 24),
]


def _bucket_case(b, d, count, degree, dtype, device, gaussian=False):
    gen = torch.Generator(device=device).manual_seed(degree * 1000 + d)
    x = (0.3 * torch.randn((b, d), generator=gen, device=device)).to(dtype)
    if gaussian:
        omega = torch.randn((count * degree, d), generator=gen,
                            device=device).to(dtype)
    else:
        bits = torch.randint(0, 2, (count * degree, d), generator=gen,
                             device=device)
        omega = (2 * bits - 1).to(dtype)
    return x, omega


def _bucket_forced(x, omega, degree, scale, kernel):
    """B9 under the schedule ``bucket_schedule(..., kernel=kernel)``."""
    from repro_torch.kernels.common import bucket_schedule
    from repro_torch.kernels.rm_feature.ops import _bucket_launch

    b, d = x.shape
    count = omega.shape[0] // degree
    out = torch.full((b, count), float("nan"), device=x.device)
    sched = bucket_schedule(b, count, d, degree, x.element_size(),
                            kernel=kernel)
    _bucket_launch(x, omega, out, 0, degree, scale, sched)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,count,degree", BUCKET_SHAPES)
def test_rm_feature_bucket_kernel_matches_plain(cuda, dtype, b, d, count,
                                                degree):
    """Kernel B9 against its plain version. Tolerance 1e-5 x max(1,
    max |plain|): fp32 accumulation in both, only the order of the d-long
    sums differs (bf16 inputs upcast exactly), and the products run in the
    same order j = 0, 1, ..."""
    x, omega = _bucket_case(b, d, count, degree, dtype, cuda)
    before = rm_feature_bucket.launches
    got = rm_feature_bucket(x, omega, degree, 0.37)
    torch.cuda.synchronize()
    assert rm_feature_bucket.launches == before + 1
    assert got.shape == (b, count) and got.dtype == torch.float32
    _close(got, rm_feature_bucket_ref(x, omega, degree, 0.37), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["chain", "tile"])
@pytest.mark.parametrize("b,d,count,degree", BUCKET_BOTH_SHAPES)
def test_rm_feature_bucket_both_kernels_match_plain(cuda, dtype, kernel, b,
                                                    d, count, degree):
    """Each of B9's two kernels, forced, against the plain version at
    shapes either can take; every output written (the map starts as NaN).
    Tolerance 1e-5 x max(1, max |plain|), as above."""
    x, omega = _bucket_case(b, d, count, degree, dtype, cuda)
    got = _bucket_forced(x, omega, degree, 0.37, kernel)
    assert not got.isnan().any()
    _close(got, rm_feature_bucket_ref(x, omega, degree, 0.37), 1e-5)


@pytest.mark.parametrize("kernel", ["chain", "tile"])
@pytest.mark.parametrize("b,d,count,degree", [(300, 57, 13, 3),
                                              (1000, 50, 40, 10),
                                              (256, 123, 250, 2)])
def test_rm_feature_bucket_gaussian_omega_fp32(cuda, kernel, b, d, count,
                                               degree):
    """A general omega (Gaussian, not +-1): the omegas' TF32 remainder
    term must run, or the error exceeds 1e-5 x max(1, max |plain|)."""
    x, omega = _bucket_case(b, d, count, degree, torch.float32, cuda,
                            gaussian=True)
    got = _bucket_forced(x, omega, degree, 0.37, kernel)
    _close(got, rm_feature_bucket_ref(x, omega, degree, 0.37), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,count,degree", [(100, 50, 4000, 10),
                                              (4096, 50, 800, 10),
                                              (1840, 57, 125, 1)])
def test_rm_feature_bucket_is_bitwise_repeatable(cuda, dtype, b, d, count,
                                                 degree):
    """No atomics and a fixed order: two calls give the same bits."""
    x, omega = _bucket_case(b, d, count, degree, dtype, cuda)
    first = rm_feature_bucket(x, omega, degree, 0.37)
    assert torch.equal(first, rm_feature_bucket(x, omega, degree, 0.37))


def test_rm_feature_bucket_writes_into_map_columns(cuda):
    """``out=, col=``: the bucket lands in its columns of a wider map
    (odd row stride and offset) and nothing else of the map changes."""
    x, omega = _bucket_case(4096, 50, 333, 3, torch.float32, cuda)
    want = rm_feature_bucket_ref(x, omega, 3, 0.37)
    for kernel in ("chain", "tile"):
        from repro_torch.kernels.common import bucket_schedule
        from repro_torch.kernels.rm_feature.ops import _bucket_launch

        out = torch.full((4096, 341), -7.0, device=cuda)
        _bucket_launch(x, omega, out, 5, 3, 0.37,
                       bucket_schedule(4096, 333, 50, 3, 4, kernel=kernel))
        torch.cuda.synchronize()
        _close(out[:, 5:338], want, 1e-5)
        assert (out[:, :5] == -7.0).all() and (out[:, 338:] == -7.0).all()
    out = torch.zeros((4096, 340), device=cuda)
    view = rm_feature_bucket(x, omega, 3, 0.37, out=out, col=7)
    assert view.data_ptr() == out[:, 7:].data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(out[:, 7:], rm_feature_bucket(x, omega, 3, 0.37))


def test_rm_feature_bucket_kernel_batch_dims_and_checks(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = 0.2 * torch.randn((2, 3, 16), generator=gen, device=cuda)
    omega = (2 * torch.randint(0, 2, (10, 16), generator=gen, device=cuda)
             - 1).float()
    got = rm_feature_bucket(x, omega, 2, 1.0)
    torch.cuda.synchronize()
    _close(got.reshape(6, 5),
           rm_feature_bucket_ref(x.reshape(6, 16), omega, 2, 1.0), 1e-5)
    with pytest.raises(TypeError, match="dtype"):
        rm_feature_bucket(x, omega.to(torch.bfloat16), 2, 1.0)
    with pytest.raises(ValueError, match="degree"):
        rm_feature_bucket(x, omega, 0, 1.0)


@pytest.mark.parametrize("kernel,d,num_features,h01", [
    ("poly", 123, 4000, False), ("poly", 57, 500, True),
    ("homogeneous", 50, 4000, False), ("exp", 50, 1000, True)])
def test_bucketed_path_matches_fused_on_the_card(cuda, kernel, d,
                                                 num_features, h01):
    """The per-bucket path (one B9 launch a degree bucket) against the
    fused path (one B1 launch) on the same map: tolerance 1e-5 x max(1,
    max |fused|), two fp32 kernels summing in different orders."""
    from repro_torch.core import kernel_from_name, make_feature_map

    kern = kernel_from_name(kernel, degree=10) if kernel != "exp" else \
        kernel_from_name("exp")
    fm = make_feature_map(kern, d, num_features, seed=1, h01=h01,
                          device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _unit((300, d), gen, cuda)
    before = (rm_feature_bucket.launches, rm_feature_fused.launches)
    want = fm.apply(x)
    torch.cuda.synchronize()
    # the map is allocated once and written in place: the call's device
    # memory beyond its output stays within the prefix's temporaries (the
    # scaled H0/1 block, the const column), where a list of bucket outputs
    # and a concatenate would hold the map twice
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = apply_feature_map_bucketed(fm, x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - got.numel() * 4
    assert extra <= 300 * (d + 2) * 4 + 4096, extra
    assert (rm_feature_bucket.launches - before[0],
            rm_feature_fused.launches - before[1]) == (len(fm.degrees), 1)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(9000, 5), (40000, 3), (16384, 2)])
def test_structured_kernel_split_path(cuda, dtype, d, rows):
    """B8's split path (d_pad past 8192: a pass over runs of 1024 points,
    passes of at most 32 points at a stride, an fp32 scratch between)
    against its plain version, tolerance 1e-5 x max(1, max |plain|), two
    calls bitwise equal, surplus columns 0."""
    plan = make_structured_plan(ExponentialDotProductKernel(1.0), d, 600,
                                measure="proportional", n_max=4)
    gen = torch.Generator(device=cuda).manual_seed(29)
    d1, d2 = (t.to(dtype) for t in pack_structured(
        plan, init_structured_params(plan, gen)))
    cd, cs = plan_columns(plan, cuda)
    x = _unit((rows, d), gen, cuda).to(dtype)
    got = structured_feature_fused(x, d1, d2, cd, cs)
    assert structured_feature_fused.last_schedule.passes
    assert torch.equal(got, structured_feature_fused(x, d1, d2, cd, cs))
    assert not got[:, cs == 0].any()
    _close(got, structured_feature_fused_ref(x, d1, d2, cd, cs), 1e-5)


def test_structured_kernel_split_path_chunks_and_kept_columns(cuda,
                                                              monkeypatch):
    """The split path run a few rows at a time (a scratch budget of 2
    rows) equals one chunk bitwise, and through ``apply_structured_plan``
    its kept columns equal the full width sliced, bitwise."""
    from repro_torch.core.plan import prefix_columns
    from repro_torch.kernels import common
    from repro_torch.structured.plan import apply_structured_plan

    plan = make_structured_plan(ExponentialDotProductKernel(1.0), 9000,
                                4000, measure="proportional", n_max=6)
    gen = torch.Generator(device=cuda).manual_seed(30)
    params = init_structured_params(plan, gen)
    d1, d2 = pack_structured(plan, params)
    cd, cs = plan_columns(plan, cuda)
    x = _unit((7, 9000), gen, cuda)
    full = structured_feature_fused(x, d1, d2, cd, cs)
    monkeypatch.setattr(common, "STRUCTURED_SCRATCH_BYTES",
                        2 * plan.max_degree * plan.total_stacks
                        * plan.d_pad * 4)
    assert common.structured_split_rows(7, plan.d_pad, plan.total_stacks,
                                        plan.max_degree) == 2
    assert torch.equal(structured_feature_fused(x, d1, d2, cd, cs), full)
    pieces, off = [], 0
    for c, n_st in zip(plan.counts, plan.stacks_per_bucket):
        pieces.append(full[:, off: off + c])
        off += n_st * plan.d_pad
    want = torch.cat(prefix_columns(plan, x, torch.float32) + pieces, dim=-1)
    assert torch.equal(apply_structured_plan(plan, params, x), want)


def test_kernel_svm_graph_equals_the_eager_loop_bitwise(cuda):
    """``train_kernel_svm`` on a CUDA Gram replays one captured epoch: the
    same kernels in the same order as the eager loop, so its alphas are
    bitwise the loop's (300 rows, 40 epochs)."""
    from repro_torch.core import PolynomialKernel, train_kernel_svm
    from repro_torch.core.linear_models import _svm_epoch

    gen = torch.Generator(device=cuda).manual_seed(31)
    x = _unit((300, 12), gen, cuda) * 0.9
    y = torch.sign(x[:, 0] * x[:, 1] + 0.05)
    gram = PolynomialKernel(10, 1.0).gram(x)
    alpha, _ = train_kernel_svm(gram, y, C=1.0)
    q_diag = torch.diagonal(gram) + 0.5
    eager = torch.zeros(300, device=cuda)
    ay = torch.zeros_like(eager)
    for _ in range(40):
        _svm_epoch(gram, y, q_diag, eager, ay, 1.0, range(300))
    torch.cuda.synchronize()
    assert (alpha > 0).any()
    assert torch.equal(alpha, eager)


def test_compositional_map_runs_b9_once_a_rademacher_bucket(cuda):
    """Algorithm 2 with Rademacher inner maps on the card: one B9 launch a
    bucket, within 1e-5 x max(1, max |Z|) of the CPU's plain path; an RFF
    map launches no kernel and matches the CPU within 1e-5."""
    from repro_torch.core import (
        ExponentialDotProductKernel as Exp,
        PolynomialKernel,
        RademacherInnerMap,
        RFFInnerMap,
        make_compositional_feature_map,
    )

    gen = torch.Generator(device=cuda).manual_seed(32)
    cfm = make_compositional_feature_map(
        PolynomialKernel(10, 1.0),
        lambda g, n: RademacherInnerMap.create(g, n, 123), 123, 4000, gen)
    x = _unit((500, 123), gen, cuda)
    before = rm_feature_bucket.launches
    z = cfm(x)
    torch.cuda.synchronize()
    assert rm_feature_bucket.launches - before == len(cfm.degrees)
    _close(z.cpu(), cfm.to("cpu")(x.cpu()), 1e-5)
    rff = make_compositional_feature_map(
        Exp(1.0), lambda g, n: RFFInnerMap.create(g, n, 50), 50, 1000, gen,
        measure="proportional", inner_bound=2.0)
    xr = _unit((100, 50), gen, cuda)
    before = rm_feature_bucket.launches
    zr = rff(xr)
    assert rm_feature_bucket.launches == before
    _close(zr.cpu(), rff.to("cpu")(xr.cpu()), 1e-5)


def _rm_counts():
    return (rm_fused_causal.launches, rm_attention_chunked.launches,
            rm_fused_state.launches, rm_fused_apply.launches,
            rm_feature_fused.launches)


@pytest.mark.parametrize("op", ["fused_causal", "fused_noncausal",
                                "two_launch_causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_functions_grads_card_vs_cpu(cuda, op, dtype):
    """The three differentiable ops on the card: the forward is the
    forward-only wrapper's output bitwise and launches its kernels once
    (B2; B3 and B4; B5), the backward launches no RM kernel, and the q, k,
    v cotangents (in the inputs' dtype) match the CPU's within 1e-4 x
    max(1, max |g|): the same fp32 formulation differentiated on both, its
    sums in another order. bf16 inputs get their cotangents rounded once
    from fp32 to bf16 on both devices, so a sum near a rounding boundary
    may land one bf16 step (2^-8 relative) apart: 2^-8 x max(1, max |g|)
    there."""
    arch = "hubert-xlarge" if op == "fused_noncausal" else "qwen3-1.7b"
    d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=40, arch=arch)
    b, h, t = 2, 4, 200
    q = _unit((b, h, t, d), gen, cuda).to(dtype)
    k = _unit((b, h, t, d), gen, cuda).to(dtype)
    v = torch.randn((b, h, t, d), generator=gen, device=cuda).to(dtype)
    kvalid = torch.ones((b, t), device=cuda)
    kvalid[1, t - 37:] = 0.0
    w = w.to(dtype)
    if op == "two_launch_causal":
        q = featurize_ref4(q, w, cd, cs)
        k = featurize_ref4(k, w, cd, cs) * kvalid[:, None, :, None]
        fn = lambda q, k, v: rm_attention_causal(q, k, v)  # noqa: E731
        forward_only = fn
        kernel = 1
    elif op == "fused_causal":
        fn = lambda q, k, v: rm_attention_fused_causal(  # noqa: E731
            q, k, v, w, cd, cs, kvalid=kvalid)
        forward_only = lambda q, k, v: rm_fused_causal(  # noqa: E731
            q, k, v, kvalid, w, cd, cs, 1e-4)[0]
        kernel = 0
    else:
        fn = lambda q, k, v: rm_attention_fused_noncausal(  # noqa: E731
            q, k, v, w, cd, cs, kvalid=kvalid)
        forward_only = fn
        kernel = 2
    with torch.no_grad():
        plain = forward_only(q, k, v)
    cot = torch.randn(plain.shape, generator=gen, device=cuda)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    before = _rm_counts()
    out = fn(*xs)
    torch.cuda.synchronize()
    moved = [a - b_ for a, b_ in zip(_rm_counts(), before)]
    want_moved = [0] * 5
    want_moved[kernel] = 1
    if op == "fused_noncausal":
        want_moved[3] = 1
    assert moved == want_moved
    assert torch.equal(out.detach(), plain)
    grads = torch.autograd.grad(out, xs, cot)
    torch.cuda.synchronize()
    assert list(_rm_counts()) == [a + m for a, m in zip(before, moved)]
    xc = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    if op == "two_launch_causal":
        out_c = rm_attention_causal(*xc)
    elif op == "fused_causal":
        out_c = rm_attention_fused_causal(*xc, w.cpu(), cd.cpu(), cs.cpu(),
                                          kvalid=kvalid.cpu())
    else:
        out_c = rm_attention_fused_noncausal(*xc, w.cpu(), cd.cpu(),
                                             cs.cpu(), kvalid=kvalid.cpu())
    want = torch.autograd.grad(out_c, xc, cot.cpu())
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    for g, g_cpu, x in zip(grads, want, xs):
        assert g.dtype == x.dtype
        _close(g.float().cpu(), g_cpu.float(), tol)


# ---------------------------------------------------------------------------
# kernel spans and exact attention on the card
# ---------------------------------------------------------------------------
def test_kernel_span_per_launch(cuda):
    """With a tracer installed, each wrapper records one ``kernel/<name>``
    span for each call that launches its kernel (the non-causal op one span
    for its B3 + B4 pair, as in the reference), with its analytic cost; the
    training backward of the fused causal op adds no span; without a
    tracer nothing is recorded."""
    from repro_torch.obs import Tracer, clock, install_tracer

    d, w, cd, cs, gen = _plan_tensors(False, cuda, seed=5)
    x = _unit((64, d), gen, cuda)
    q, k = _unit((1, 4, 40, d), gen, cuda), _unit((1, 4, 40, d), gen, cuda)
    v = torch.randn((1, 4, 40, d), generator=gen, device=cuda)
    tr = Tracer(now=clock.FakeClock(),
                provenance={"backend": "cuda", "device_kind": "test",
                            "interpret": False, "jax_version": None})
    calls = [
        ("kernel/rm_feature", rm_feature_fused,
         lambda: rm_feature_fused(x, w, cd, cs)),
        ("kernel/rm_attn_fused", rm_fused_causal,
         lambda: rm_attention_fused_prefill(q, k, v, w, cd, cs)),
    ]
    prev = install_tracer(tr)
    try:
        for name, counter, call in calls:
            before, spans = counter.launches, len(tr.spans(name))
            call()
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert len(tr.spans(name)) == spans + 1
            sp = tr.spans(name)[-1]
            assert sp["attrs"]["flops"] > 0 and sp["attrs"]["hbm_bytes"] > 0
            assert sp["attrs"]["traced"] is False
        before = (rm_fused_state.launches, rm_fused_apply.launches)
        n = len(tr.spans("kernel/rm_attn_fused"))
        rm_attention_fused_noncausal(q, k, v, w, cd, cs)
        torch.cuda.synchronize()
        assert (rm_fused_state.launches, rm_fused_apply.launches) == \
            (before[0] + 1, before[1] + 1)
        (sp,) = tr.spans("kernel/rm_attn_fused")[n:]
        assert sp["attrs"]["mode"] == "noncausal"
        qg = q.detach().requires_grad_()
        out = rm_attention_fused_causal(qg, k, v, w, cd, cs)
        n = len(tr.spans())
        out.sum().backward()
        torch.cuda.synchronize()
        assert len(tr.spans()) == n
    finally:
        install_tracer(prev)
    before = len(tr.records)
    rm_feature_fused(x, w, cd, cs)
    assert len(tr.records) == before


@pytest.mark.parametrize("window", [0, 8])
def test_exact_attention_card_matches_cpu(cuda, window):
    """qwen3 SMOKE exact attention in fp32 on the card against the CPU:
    the prefill and decode logits through the ring buffer past its wrap,
    and a 2500-token forward through the blockwise path; no RM kernel
    launches."""
    import dataclasses

    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              compute_dtype="float32",
                              sliding_window=window)
    assert cfg.attention_mode == "exact"
    p_cpu = tt.init_model(cfg, torch.Generator().manual_seed(0))
    p_gpu = {"embed": {k_: v_.to(cuda) for k_, v_ in p_cpu["embed"].items()},
             "final_norm": {k_: v_.to(cuda)
                            for k_, v_ in p_cpu["final_norm"].items()},
             "layers": [{m: {k_: v_.to(cuda) for k_, v_ in sub.items()}
                         for m, sub in lay.items()}
                        for lay in p_cpu["layers"]]}
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    launches = rm_feature_fused.launches, rm_fused_causal.launches
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), (cuda, p_gpu)):
            lg, cache = tt.prefill(params, cfg, {"tokens": toks.to(dev)},
                                   16)
            seq = [lg[:, -1]]
            for i in range(8):
                nt = toks[:, i:i + 1].to(dev)
                pos = torch.full((2,), 12 + i, dtype=torch.int32,
                                 device=dev)
                lg, cache = tt.decode_step(params, cfg, cache, nt, pos)
                seq.append(lg[:, 0])
            out[str(dev)] = torch.stack(seq).cpu()
        assert (rm_feature_fused.launches, rm_fused_causal.launches) == \
            launches
        _close(out["cuda"], out["cpu"], 1e-4)
        q, k, v = (torch.randn((1, 2500, 2, 16), generator=gen)
                   for _ in range(3))
        pos = torch.arange(2500, dtype=torch.int32)[None]
        want = attn_mod._softmax_attention(cfg, q, k, v, pos, pos)
        got = attn_mod._softmax_attention(cfg, q.to(cuda), k.to(cuda),
                                          v.to(cuda), pos.to(cuda),
                                          pos.to(cuda))
    _close(got.cpu(), want, 1e-4)


def _mla_plan_tensors(device, seed):
    """deepseek-v2-lite-16b's rm plan at MLA's q/k width (128 nope + 64
    rope = 192) against its value width 128."""
    from repro_torch.models.mla import mla_qk_dim

    cfg = get_config("deepseek-v2-lite-16b", attention_mode="rm")
    d = mla_qk_dim(cfg)
    plan = rm_plan_for(cfg, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = pack_omegas(plan, init_omegas(plan, gen))
    cd, cs = plan_columns(plan, device)
    return d, cfg.mla.v_head_dim, w, cd, cs, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pad", [(256, 56), (32, 27)])
def test_rm_fused_causal_kernel_mla_width(cuda, dtype, t, pad):
    """B2 at deepseek's prefill shapes (16 heads, q/k width 192, values
    128): fp32 within 1e-5 x max(1, max |plain|) of its plain version
    (3xTF32), bf16 within 1e-4, two calls bitwise equal."""
    d, dv, w, cd, cs, gen = _mla_plan_tensors(cuda, 21)
    assert (d, dv) == (192, 128)
    q = _unit((1, 16, t, d), gen, cuda).to(dtype)
    k = _unit((1, 16, t, d), gen, cuda).to(dtype)
    v = torch.randn((1, 16, t, dv), generator=gen, device=cuda)
    kvalid = torch.ones((1, t), device=cuda)
    kvalid[0, t - pad:] = 0.0
    args = (q, k, v, kvalid, w.to(dtype), cd, cs)
    got = rm_fused_causal(*args, 1e-4)
    again = rm_fused_causal(*args, 1e-4)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    for g, w_ in zip(got, rm_fused_causal_ref(*args, chunk=128, eps=1e-4)):
        assert g.shape == w_.shape
        _close(g, w_, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_mla_width(cuda, dtype):
    """B1 at deepseek's decode shape (4 slots x 16 heads, q and k stacked:
    x [128, 192]) within 1e-5 of its plain version, and the decode step
    (one B1 launch) against the plain state update."""
    d, dv, w, cd, cs, gen = _mla_plan_tensors(cuda, 22)
    w = w.to(dtype)
    f = w.shape[1]
    x = _unit((128, d), gen, cuda).to(dtype)
    _close(rm_feature_fused(x, w, cd, cs), rm_feature_fused_ref(x, w, cd, cs),
           1e-5)
    q = _unit((4, 16, d), gen, cuda).to(dtype)
    k = _unit((4, 16, d), gen, cuda).to(dtype)
    v = torch.randn((4, 16, dv), generator=gen, device=cuda)
    s0 = torch.zeros((4, 16, f, dv), device=cuda)
    n0 = torch.zeros((4, 16, f), device=cuda)
    before = rm_feature_fused.launches
    got = rm_attention_fused_decode_step(q, k, v, s0, n0, w, cd, cs)
    torch.cuda.synchronize()
    assert rm_feature_fused.launches == before + 1
    zq = rm_feature_fused_ref(q.reshape(-1, d), w, cd, cs).reshape(4, 16, f)
    zk = rm_feature_fused_ref(k.reshape(-1, d), w, cd, cs).reshape(4, 16, f)
    for g, w_ in zip(got, rm_attention_decode_ref(zq, zk, v, s0, n0)):
        _close(g, w_, 1e-4)
