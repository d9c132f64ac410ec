"""The rm attention gradient at a position whose denominator nears its
clamp, in bf16 and in fp32: the port's kernel-B2 op against the
reference's formulation, on the CPU.

qwen3-1.7b rm's bf16 training gradient at one layer parts between runs
on the card (ROADMAP.md, measured gaps). Near the clamp ``sign(den) *
max(|den|, eps)`` the output's gradient grows as 1 / den^2, and rounding
q and k to bf16 moves den by more than its size; whether the port does
there what the reference does is what this test settles. It builds that
case on purpose at qwen3
SMOKE's head geometry (d 16, its rm plan, +-1 omegas, q and k rows of
norm 2: a learned scale at which the RM estimate of the kernel sums can
turn negative) from a numpy seed: the query of one position is moved
along a line until its signed denominator is 3 eps, then q, k and v go
through

* the reference: ``jax.vjp`` of ``_fused_causal_jnp``
  (``repro.kernels.rm_attention.ops``), the formulation its custom VJP
  ``_fused_causal_bwd`` differentiates (the Pallas B2 itself does not
  trace under jax 0.9.0);
* the port: ``rm_attention_fused_causal``, whose
  ``_FusedCausal.backward`` differentiates the port of that formulation,

each with its inputs in bf16 and in fp32 (the cotangent fp32, as both
backward passes cast it), and the exact gradient: the same formulation
in float64 with autograd, at the fp32 inputs and at the bf16-rounded ones.
The fp32 gradient is about 3e9 at its largest there, so fp32 arithmetic
itself is off by 1e-2 of it in either package:

* the port is no further from the exact gradient than the reference is
  (within a factor of 1.5), at either dtype;
* the port's bf16 gradient is within the bf16 budget (2e-2 of its size)
  of the reference's bf16 gradient;
* the exact gradient at the bf16-rounded inputs parts from the one at the
  fp32 inputs by more than half its size: rounding q and k to bf16 moves
  the gradient there in exact arithmetic. The gap between the card's bf16
  and fp32 gradients is the formulation's, shared with the reference, and
  not a fault of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.kernels.rm_attention import ops as jops
from repro.models.attention import rm_plan_for as jax_rm_plan_for
from repro_torch.kernels.rm_attention import ops as tops
from repro_torch.kernels.rm_attention.ref import featurize_ref4

B, H, T, DV, CHUNK = 1, 2, 16, 8, 8
POS = 11               # the position put near the clamp (head 0)
R = 2.0                # the pre-scaled rows' norm (softplus(rm_scale))
ACCURACY = 1.5         # port's error over the reference's, vs the exact
BF16_TOL = 2e-2        # port vs reference in bf16, x max |g|
APART = 0.5            # exact: bf16-rounded vs fp32 inputs, x max |g|


def _plan():
    cfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    plan = jax_rm_plan_for(cfg, cfg.resolved_head_dim)
    return (cfg.resolved_head_dim,
            np.asarray(plan.column_degrees(), np.int32),
            np.asarray(plan.column_scales(), np.float32), cfg.rm.eps)


def _den(q_row, k, w, deg, scale):
    """The signed denominator at POS of head 0, in float64: z(q) . sum
    of z(k_s) over s <= POS."""
    to = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    zq = featurize_ref4(to(q_row)[None, None, None], to(w), torch.as_tensor(
        deg), to(scale))
    zk = featurize_ref4(to(k[:1, :1, :POS + 1]), to(w), torch.as_tensor(deg),
                        to(scale))
    return float((zq[0, 0, 0] * zk[0, 0].sum(0)).sum())


def _near_clamp(seed=0):
    """Operands with den(POS) = 3 eps: q[0, 0, POS] on the norm-R path
    between a query of positive and one of negative denominator, found by
    bisection."""
    d, deg, scale, eps = _plan()
    rng = np.random.default_rng(seed)
    w = rng.choice([-1.0, 1.0], size=(int(deg.max()), len(deg), d))
    q, k = (rng.standard_normal((B, H, T, d)) for _ in range(2))
    q *= R / np.linalg.norm(q, axis=-1, keepdims=True)
    k *= R / np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((B, H, T, DV))
    cands = rng.standard_normal((64, d))
    cands *= R / np.linalg.norm(cands, axis=-1, keepdims=True)
    dens = [_den(c, k, w, deg, scale) for c in cands]
    pos = cands[int(np.argmax(dens))]
    neg = cands[int(np.argmin(dens))]
    assert max(dens) > 3 * eps > 0 > min(dens)

    def at(a):
        r = (1 - a) * pos + a * neg
        return r * R / np.linalg.norm(r)

    lo, hi = 0.0, 1.0              # den(at(lo)) > 3 eps > den(at(hi))
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _den(at(mid), k, w, deg, scale) > 3 * eps:
            lo = mid
        else:
            hi = mid
    q[0, 0, POS] = at(lo)
    cot = rng.standard_normal((B, H, T, DV))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(q), f32(k), f32(v), np.ones((B, T), np.float32), f32(w),
            deg, scale, eps, f32(cot))


def _exact(q, k, v, w, deg, scale, eps, cot):
    """The gradient of q, k, v in float64: featurize, the causal sums and
    the clamped denominator, as the formulation computes them."""
    ts = [torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(True)
          for a in (q, k, v)]
    w64 = torch.from_numpy(w).double()
    mask = (torch.arange(w64.shape[0])[:, None]
            < torch.as_tensor(deg).long()[None, :])[:, None, None, None]

    def feat(x):
        proj = torch.einsum("bhtd,kfd->kbhtf", x, w64)
        return (torch.where(mask, proj, torch.ones_like(proj)).prod(0)
                * torch.as_tensor(scale, dtype=torch.float64))

    a = torch.einsum("bhtf,bhsf->bhts", feat(ts[0]), feat(ts[1])).tril()
    den = a.sum(-1)
    den = torch.where(den.abs() < eps, torch.where(
        den >= 0, eps, -eps) * torch.ones_like(den), den)
    out = (a @ ts[2]) / den[..., None]
    return [g.numpy() for g in torch.autograd.grad(
        out, ts, torch.from_numpy(cot).double())]


@pytest.fixture(scope="module")
def grads():
    q, k, v, kvalid, w, deg, scale, eps, cot = _near_clamp()
    out = {"eps": eps, "den": _den(q[0, 0, POS], k, w, deg, scale)}
    rounded = [torch.from_numpy(a).bfloat16().double().numpy()
               for a in (q, k, v)]
    exact = {"fp32": _exact(q, k, v, w, deg, scale, eps, cot),
             "bf16": _exact(*rounded, w, deg, scale, eps, cot)}
    ref = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda a, b, c: jops._fused_causal_jnp(
            a, b, c, jnp.asarray(kvalid), jnp.asarray(w), jnp.asarray(deg),
            jnp.asarray(scale), CHUNK, eps), q, k, v)[1](g))
    for label, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                            ("bf16", jnp.bfloat16, torch.bfloat16)):
        want = ref(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                   jnp.asarray(cot))
        ts = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (q, k, v)]
        o = tops.rm_attention_fused_causal(
            *ts, torch.from_numpy(w), deg, scale,
            kvalid=torch.from_numpy(kvalid), chunk=CHUNK, eps=eps)
        got = torch.autograd.grad(o, ts, torch.from_numpy(cot))
        out[label] = {
            "port": [g.float().numpy() for g in got],
            "reference": [np.asarray(g.astype(jnp.float32)) for g in want],
            "exact": exact[label]}
    return out


def _gap(got, want):
    """max |got - want| / max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_the_case_sits_at_the_clamp(grads):
    """The signed denominator at the fp32 inputs is within eps of 3 eps
    (float64 evaluation)."""
    assert abs(grads["den"] - 3 * grads["eps"]) < grads["eps"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_is_as_accurate_as_the_reference(grads, dtype, capsys):
    g = grads[dtype]
    for i, name in enumerate(("dq", "dk", "dv")):
        port = _gap(g["port"][i], g["exact"][i])
        ref = _gap(g["reference"][i], g["exact"][i])
        with capsys.disabled():
            print(f"\n[clamp] {dtype} {name}: from the exact gradient, port "
                  f"{port:.2e}, reference {ref:.2e}; port vs reference "
                  f"{_gap(g['port'][i], g['reference'][i]):.2e}")
        assert port <= ACCURACY * ref + 1e-6, name


def test_bf16_port_gradient_within_budget_of_the_reference(grads):
    g = grads["bf16"]
    for i in range(3):
        assert _gap(g["port"][i], g["reference"][i]) <= BF16_TOL


def test_bf16_rounding_moves_the_exact_gradient(grads, capsys):
    """The exact gradient at the bf16-rounded inputs parts from the one at
    the fp32 inputs by more than ``APART`` of its size, and the port's and
    the reference's bf16 gradients part from their fp32 ones alike."""
    parts = [_gap(grads["bf16"]["exact"][i], grads["fp32"]["exact"][i])
             for i in range(3)]
    sides = {side: _gap(grads["bf16"][side][0], grads["fp32"][side][0])
             for side in ("port", "reference")}
    with capsys.disabled():
        print("\n[clamp] exact bf16-rounded vs fp32 inputs: dq dk dv "
              + " ".join(f"{x:.3f}" for x in parts)
              + f"; dq bf16 vs fp32: port {sides['port']:.3f}, reference "
              f"{sides['reference']:.3f}")
    assert min(parts) > APART
    assert min(sides.values()) > APART
