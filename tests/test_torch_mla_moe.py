"""MLA and MoE in the port (``repro_torch.models.mla``, ``models.moe``) and
the two configs that use them (deepseek-v2-lite-16b, mixtral-8x7b), held
against the reference on the CPU with the reference's weights carried
across by ``repro_torch.convert.params_from_jax``, fp32 compute:

* ``apply_moe``, local and einsum dispatch, at a capacity that drops
  tokens: output and aux losses within 1e-5 (inputs without tied router
  probabilities: ``torch.topk`` and ``jax.lax.top_k`` may order ties
  differently);
* ``mla_forward`` in rm fused (B2's plain version), rm two-launch (B1 and
  B5's plain versions) and exact mode, within 1e-5; blockwise exact
  attention with dv != dh against the small path;
* deepseek and mixtral SMOKE logits within 1e-4 relative in each mode, and
  ``loss_fn`` with its aux losses;
* prefill + decode continuing the forward (capacity 8.0, so no token
  drops and the paths compare; the reference's own test lifts it so);
* greedy tokens through the port's Scheduler equal to the reference
  Scheduler's on deepseek SMOKE rm.

A MoE request's tokens depend on what it is batched with (the capacity
counts every routed token, padding included), so no test here asserts
"alone == batched" for these models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jget
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, Scheduler

# the reference's functions, jitted (cfg static): one compile a shape
# instead of eager op-by-op dispatch
_jforward = jax.jit(jt.forward, static_argnums=1)
_jloss = jax.jit(jt.loss_fn, static_argnums=1)
_jmla = jax.jit(jmla.mla_forward, static_argnums=1)
_jmoe = jax.jit(jmoe.apply_moe, static_argnums=1)

LAYER_TOL = 1e-5    # fp32 layer outputs of O(0.1) values, sums of <= 64 terms
LOGITS_TOL = 1e-4   # relative: fp32 logits through 2-3 layers
MODES = ["rm_on", "rm_off", "exact"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _cfgs(arch, mode, **moe_kw):
    """The reference's and the port's SMOKE config in fp32 compute; the
    reference's fused mode runs its fused jnp formulation
    (``fuse_featurize="on"``), the two-launch mode ``"off"`` on both
    sides."""
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
    """Both configs of ``mode`` and one set of weights an arch (drawn in
    rm mode: exact attention ignores the estimator leaves, and the MoE
    options change no leaf), the reference's and the port's copy."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, "rm_on")
        # jitted: one compile instead of the eager init's op-by-op calls
        jp = jax.jit(jt.init_model, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
        _WEIGHTS[arch] = (jp, tp)
    jcfg, tcfg = _cfgs(arch, mode, **moe_kw)
    return (jcfg, *_WEIGHTS[arch][:1], tcfg, _WEIGHTS[arch][1])


def _tokens(b, t, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t))


def _leaves(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs and the layer stack
# ---------------------------------------------------------------------------
def test_configs_resolve_and_layer_kinds():
    ds = get_config("deepseek-v2-lite-16b")
    assert (ds.num_layers, ds.d_model, ds.num_heads, ds.first_k_dense) == (
        27, 2048, 16, 1)
    for arch in ("deepseek-v2-lite-16b", "mixtral-8x7b"):
        for smoke in (False, True):
            # every field the port has equals the reference's (it leaves
            # out the scan switch)
            ours = dataclasses.asdict(get_config(arch, smoke=smoke))
            theirs = dataclasses.asdict(jget(arch, smoke=smoke))
            assert ours == {k: theirs[k] for k in ours}
            assert set(theirs) - set(ours) == {"scan_unroll"}
    assert tt.layer_kinds(ds) == ["mla_mlp"] + ["mla_moe"] * 26
    assert tt.layer_kinds(get_config("mixtral-8x7b", smoke=True)) == [
        "attn_moe"] * 2
    bad = dataclasses.replace(ds, moe=None)
    with pytest.raises(ValueError, match="moe config"):
        bad.validate()


def test_params_cross_with_dense_layer_first():
    jcfg, jp, tcfg, tp = _models("deepseek-v2-lite-16b", "rm_on")
    layers = tp["layers"]
    assert len(layers) == 3
    assert set(layers[0]) == {"norm1", "mla", "norm2", "mlp"}
    assert set(layers[1]) == {"norm1", "mla", "norm2", "moe"}
    np.testing.assert_array_equal(layers[0]["mlp"]["w_gate"].numpy(),
                                  np.asarray(jp["dense_0"]["mlp"]["w_gate"]))
    stacked = np.asarray(jp["groups"]["b0_mla_moe"]["moe"]["w_up"])
    assert layers[2]["moe"]["w_up"].shape == stacked.shape[1:] == (8, 64, 32)
    np.testing.assert_array_equal(layers[2]["moe"]["w_up"].numpy(),
                                  stacked[1])
    om = np.asarray(jp["groups"]["b0_mla_moe"]["mla"]["rm_est"]["omegas"])
    np.testing.assert_array_equal(
        layers[1]["mla"]["rm_est"]["omegas"].numpy(), om[0])
    assert om.shape[-1] == tmla.mla_qk_dim(tcfg) == 24
    # the compute copy packs the MLA plan (width nope + rope)
    cp = tt.cast_params_to_compute(tp, tcfg)
    assert cp["layers"][1]["mla"]["rm_w"].shape[2] == 24


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
@pytest.mark.parametrize("dispatch", ["local", "einsum"])
def test_apply_moe_matches_reference_with_drops(arch, dispatch):
    jcfg, tcfg = _cfgs(arch, "exact", capacity_factor=0.5,
                       dispatch=dispatch)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    x = (np.random.default_rng(4).normal(size=(2, 24, jcfg.d_model))
         ).astype(np.float32)
    want, jaux = _jmoe(jp, jcfg, jnp.asarray(x))
    tp = _leaves(jp)
    got, taux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    for k in ("moe_load_balance", "moe_router_z"):
        assert abs(float(taux[k]) - float(jaux[k])) <= LAYER_TOL
    # the capacity drops tokens here, and no router probabilities tie
    _, probs, _, top_idx = tmoe._route(tp, tcfg.moe,
                                       torch.from_numpy(x.reshape(-1, 64)))
    cap = tmoe._capacity(tcfg.moe, 48)
    per_expert = torch.bincount(top_idx.reshape(-1),
                                minlength=tcfg.moe.num_experts)
    assert int(per_expert.max()) > cap
    srt = torch.sort(probs, dim=-1).values
    assert float((srt[:, 1:] - srt[:, :-1]).min()) > 0.0
    # a mesh needs a process group behind it (the mesh path itself is held
    # in tests/test_torch_tensor_parallel.py)
    from repro_torch.distributed.sharding import AbstractMesh

    with pytest.raises(RuntimeError, match="initialized process group"):
        tmoe.apply_moe(tp, tcfg, torch.from_numpy(x),
                       mesh=AbstractMesh((1, 2), ("data", "model")))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_mla_forward_matches_reference(mode):
    jcfg, jp, tcfg, tp = _models("deepseek-v2-lite-16b", mode)
    x = (np.random.default_rng(5).normal(size=(2, 20, jcfg.d_model))
         ).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    jlayer = jax.tree_util.tree_map(lambda a: a[0],
                                    jp["groups"]["b0_mla_moe"]["mla"])
    want = _jmla(jlayer, jcfg, jnp.asarray(x), jnp.asarray(pos))
    layer = tt.cast_params_to_compute(tp, tcfg)["layers"][1]["mla"]
    with torch.no_grad():
        got = tmla.mla_forward(layer, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


def test_blockwise_exact_attention_dv_ne_dh(monkeypatch):
    """Blockwise softmax with v_head_dim (16) != the q/k width (24)
    against the small path and the reference."""
    jcfg, jp, tcfg, tp = _models("deepseek-v2-lite-16b", "exact")
    toks = _tokens(2, 48, jcfg.vocab_size, 1)
    with torch.no_grad():
        small, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        monkeypatch.setattr(tattn, "_BLOCKWISE_THRESHOLD", 16)
        monkeypatch.setattr(tattn, "_BLOCK_Q", 16)
        monkeypatch.setattr(tattn, "_BLOCK_K", 16)
        block, _ = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(block).all()
    assert _rel(block.numpy(), small.numpy()) <= LOGITS_TOL
    want, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    assert _rel(block.numpy(), np.asarray(want)) <= LOGITS_TOL


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x7b"])
@pytest.mark.parametrize("mode", MODES)
def test_smoke_logits_and_loss_match_reference(arch, mode):
    jcfg, jp, tcfg, tp = _models(arch, mode)
    toks = _tokens(2, 20, jcfg.vocab_size, 1)
    want, jaux = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, taux = tt.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), np.asarray(want)) <= LOGITS_TOL
    assert set(taux) == set(jaux) == {"moe_load_balance", "moe_router_z"}
    for k in taux:
        assert abs(float(taux[k]) - float(jaux[k])) <= LOGITS_TOL
    if mode == "rm_off":
        return     # the two-launch featurize kernels have no backward
    tgt = _tokens(2, 20, jcfg.vocab_size, 2)
    tgt[0, :3] = -1
    jloss, jm = _jloss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                  "targets": jnp.asarray(tgt)})
    # the last router as a leaf that takes a gradient (on a copy of the
    # layer list: the weights are shared between tests)
    router = tp["layers"][-1]["moe"]["router"].clone().requires_grad_()
    last = {**tp["layers"][-1], "moe": {**tp["layers"][-1]["moe"],
                                        "router": router}}
    tp2 = {**tp, "layers": tp["layers"][:-1] + [last]}
    tloss, tm = tt.loss_fn(tp2, tcfg, {"tokens": torch.from_numpy(toks),
                                       "targets": torch.from_numpy(tgt)})
    assert set(tm) == set(jm)
    for k in tm:
        want_k = float(jm[k])
        assert abs(float(tm[k].detach()) - want_k) <= LOGITS_TOL * max(
            1.0, abs(want_k)), k
    tloss.backward()
    assert torch.isfinite(router.grad).all() and router.grad.abs().sum() > 0


@pytest.mark.parametrize("arch,mode", [("deepseek-v2-lite-16b", "rm_on"),
                                       ("deepseek-v2-lite-16b", "rm_off"),
                                       ("deepseek-v2-lite-16b", "exact"),
                                       ("mixtral-8x7b", "exact")])
def test_prefill_then_decode_continues_forward(arch, mode):
    """Capacity 8.0: routing is dropless, so the prompt's prefill, each
    decoded token and the full forward compare position by position."""
    _, _, tcfg, tp = _models(arch, mode, capacity_factor=8.0)
    b, t_prompt, t_extra = 2, 12, 3
    toks = torch.from_numpy(_tokens(b, t_prompt + t_extra,
                                    tcfg.vocab_size, 6))
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


def test_scheduler_tokens_equal_reference():
    """Greedy tokens of deepseek SMOKE rm through both Schedulers (prompt
    buckets 32 and 64, two slots), with the reference's weights."""
    jcfg, jp, tcfg, tp = _models("deepseek-v2-lite-16b", "rm_on")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n)
               for n in (5, 17, 40, 9)]
    ref = JScheduler(jcfg, jp, num_slots=2, max_len=64)
    port = Scheduler(tcfg, tp, num_slots=2, max_len=64, device="cpu")
    assert port.executor.bucketed and port.executor.bucket_for(40) == 64
    for i, p in enumerate(prompts):
        ref.submit(JRequest(i, p, max_new_tokens=6))
        port.submit(Request(i, p, max_new_tokens=6))
    want, got = ref.run(), port.run()
    assert {r: s.generated for r, s in got.items()} == {
        r: s.generated for r, s in want.items()}
    assert all(len(s.generated) == 6 for s in got.values())
