"""The two SSM configs of the port — jamba-v0.1-52b (one attention + seven
Mamba mixers a period, MoE on alternate layers) and xlstm-350m (mLSTM +
sLSTM, attention-free) — held against the reference on the CPU with the
reference's weights carried across by ``repro_torch.convert.
params_from_jax``, fp32 compute. jamba runs in rm fused (B2's plain
version), rm two-launch (B1 and B5's plain versions) and exact mode;
xlstm in its own (no attention):

* SMOKE logits and aux losses within 1e-4 relative;
* ``loss_fn`` and every trainable leaf's gradient against ``jax.grad`` of
  the reference's within 1e-4 x max(1, max |g|) (plain autograd through
  the Mamba scan and the xLSTM cells; the fused attention op's backward);
* prefill + decode continuing the forward over the extended sequence
  (jamba's MoE at capacity 8.0, so nothing drops and the paths compare,
  as ``tests/test_prefill_decode.py`` lifts it);
* greedy tokens through the port's Scheduler equal to the reference
  Scheduler's (exact-length prompts: an SSM config is not bucketed).

jamba's MoE capacity counts every token of a call, so no test here holds a
request alone against batched."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jget
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.common.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import is_frozen
from repro_torch.serve import Request, Scheduler
from repro_torch.train.steps import loss_grads

_jforward = jax.jit(jt.forward, static_argnums=1)

LOGITS_TOL = 1e-4   # relative: fp32 logits through 4-8 layers
GRAD_TOL = 1e-4     # x max(1, max |g|), per trainable leaf
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-350m"
CASES = [(JAMBA, "rm_on"), (JAMBA, "rm_off"), (JAMBA, "exact"),
         (XLSTM, "exact")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _cfgs(arch, mode, **moe_kw):
    """The reference's and the port's SMOKE config in fp32 compute; rm
    fused runs the reference's fused jnp formulation (``fuse_featurize=
    "on"``), two-launch ``"off"`` on both sides."""
    am = "exact" if mode == "exact" else "rm"
    jcfg = dataclasses.replace(jget(arch, smoke=True, attention_mode=am),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True,
                                          attention_mode=am),
                               compute_dtype="float32")
    if mode != "exact":
        fuse = "on" if mode == "rm_on" else "off"
        jcfg = dataclasses.replace(jcfg, rm=dataclasses.replace(
            jcfg.rm, fuse_featurize=fuse))
        tcfg = dataclasses.replace(tcfg, rm=dataclasses.replace(
            tcfg.rm, fuse_featurize="auto" if fuse == "on" else "off"))
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_kw))
    return jcfg, tcfg


_WEIGHTS = {}


def _models(arch, mode, **moe_kw):
    """Both configs of ``mode`` and one set of weights per (arch, attention
    mode): the reference's and the port's copy."""
    key = (arch, mode == "exact")
    if key not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, mode)
        jp = jax.jit(jt.init_model, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
        _WEIGHTS[key] = (jp, tp)
    jcfg, tcfg = _cfgs(arch, mode, **moe_kw)
    return (jcfg, _WEIGHTS[key][0], tcfg, _WEIGHTS[key][1])


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t))


def test_layer_stacks_and_params_cross():
    """The port's layers, in the reference's group-major order, with the
    fp32 SSM leaves carried across in fp32 and no norm2 on the kinds
    without an FFN."""
    jcfg, jp, tcfg, tp = _models(JAMBA, "exact")
    assert tt.layer_kinds(tcfg) == list(tcfg.block_pattern)
    layers = tp["layers"]
    assert set(layers[0]) == {"norm1", "attn", "norm2", "moe"}
    assert set(layers[1]) == {"norm1", "mamba", "norm2", "mlp"}
    assert set(layers[2]) == {"norm1", "mamba", "norm2", "moe"}
    for leaf in ("a_log", "d_skip"):
        assert layers[3]["mamba"][leaf].dtype == torch.float32
        np.testing.assert_array_equal(
            layers[3]["mamba"][leaf].numpy(),
            np.asarray(jp["groups"]["b3_mamba_mlp"]["mamba"][leaf][0]))
    # the compute copy packs no estimator weights into a Mamba layer
    _, _, rcfg, rp = _models(JAMBA, "rm_on")
    cp = tt.cast_params_to_compute(rp, rcfg)
    assert "rm_w" in cp["layers"][0]["attn"]
    assert "rm_w" not in cp["layers"][1]["mamba"]

    xcfg = get_config(XLSTM, smoke=True)
    assert tt.layer_kinds(xcfg) == ["mlstm", "mlstm", "mlstm", "slstm"]
    _, xjp, _, xtp = _models(XLSTM, "exact")
    assert [set(layer) for layer in xtp["layers"]] == [
        {"norm1", "mlstm"}] * 3 + [{"norm1", "slstm"}]
    r_rec = xtp["layers"][3]["slstm"]["r_rec"]
    assert r_rec.dtype == torch.float32 and tuple(r_rec.shape) == (
        4, 4, 16, 16)
    np.testing.assert_array_equal(
        r_rec.numpy(), np.asarray(xjp["groups"]["b3_slstm"]["slstm"][
            "r_rec"][0]))
    # decode caches: conv windows in the compute dtype, the rest fp32
    cache = tt.init_decode_cache(get_config(XLSTM, smoke=True), 2, 64, "cpu")
    assert cache["layers"][0]["conv"].dtype == torch.bfloat16
    assert {k: v.dtype for k, v in cache["layers"][3].items()} == {
        k: torch.float32 for k in ("h", "c", "n", "m")}


@pytest.mark.parametrize("arch,mode", CASES)
def test_smoke_logits_and_loss_grads_match_reference(arch, mode):
    jcfg, jp, tcfg, tp = _models(arch, mode)
    toks = _tokens(2, 21, jcfg.vocab_size, 1)
    want, jaux = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :20])})
    with torch.no_grad():
        got, taux = tt.forward(tp, tcfg,
                               {"tokens": torch.from_numpy(toks[:, :20])})
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), np.asarray(want)) <= LOGITS_TOL
    assert set(taux) == set(jaux)
    for k in taux:
        assert abs(float(taux[k]) - float(jaux[k])) <= LOGITS_TOL
    if mode == "rm_off":
        return     # the two-launch featurize kernels have no backward
    jb = {"tokens": jnp.asarray(toks[:, :20]),
          "targets": jnp.asarray(toks[:, 1:])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    wantg = flatten_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg))
    grads, metrics = loss_grads(tcfg, tp, {
        "tokens": torch.from_numpy(toks[:, :20]),
        "targets": torch.from_numpy(toks[:, 1:])})
    loss = float(metrics["loss"])
    assert abs(loss - float(jloss)) <= LOGITS_TOL * abs(float(jloss))
    gotg = {k: g for k, g in flatten_dict(grads).items()
            if not is_frozen(tuple(k.split("/"))) and g.is_floating_point()}
    assert set(gotg) == {k for k in wantg if "rm_est" not in k}
    for key, g in gotg.items():
        assert torch.isfinite(g).all(), key
        assert _rel(g.numpy(), wantg[key]) <= GRAD_TOL, (key, _rel(
            g.numpy(), wantg[key]))


@pytest.mark.parametrize("arch,mode", CASES)
def test_prefill_then_decode_continues_forward(arch, mode):
    """Capacity 8.0 for jamba's MoE: routing is dropless, so the prompt's
    prefill, each decoded token and the forward over the extended sequence
    compare position by position."""
    kw = {"capacity_factor": 8.0} if arch == JAMBA else {}
    _, _, tcfg, tp = _models(arch, mode, **kw)
    b, t_prompt, t_extra = 2, 12, 3
    toks = torch.from_numpy(_tokens(b, t_prompt + t_extra, tcfg.vocab_size,
                                    6))
    with torch.no_grad():
        full, _ = tt.forward(tp, tcfg, {"tokens": toks})
        pre, cache = tt.prefill(tp, tcfg, {"tokens": toks[:, :t_prompt]},
                                max_len=32)
        assert _rel(pre.numpy(), full[:, :t_prompt].numpy()) <= LOGITS_TOL
        for i in range(t_extra):
            p = t_prompt + i
            step, cache = tt.decode_step(
                tp, tcfg, cache, toks[:, p:p + 1],
                torch.full((b,), p, dtype=torch.int32))
            assert _rel(step[:, 0].numpy(), full[:, p].numpy()) <= \
                LOGITS_TOL, (i, mode)


@pytest.mark.parametrize("arch,mode", [(JAMBA, "rm_on"), (XLSTM, "exact")])
def test_scheduler_tokens_equal_reference(arch, mode):
    """Greedy tokens through both Schedulers (two slots), exact-length
    prompts, with the reference's weights."""
    jcfg, jp, tcfg, tp = _models(arch, mode)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n)
               for n in (5, 17, 9)]
    ref = JScheduler(jcfg, jp, num_slots=2, max_len=64)
    port = Scheduler(tcfg, tp, num_slots=2, max_len=64, device="cpu")
    assert not port.executor.bucketed and port.executor.bucket_for(17) == 17
    for i, p in enumerate(prompts):
        ref.submit(JRequest(i, p, max_new_tokens=5))
        port.submit(Request(i, p, max_new_tokens=5))
    want, got = ref.run(), port.run()
    assert {r: s.generated for r, s in got.items()} == {
        r: s.generated for r, s in want.items()}
    assert all(len(s.generated) == 5 for s in got.values())
