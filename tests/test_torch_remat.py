"""Activation checkpointing (``ModelConfig.remat``, on by default as in the
reference): each ``block_pattern`` group after the ``first_k_dense`` layers
runs under ``torch.utils.checkpoint`` (non-reentrant) when a gradient is
taken, as the reference wraps its scanned group in ``jax.checkpoint``.

1. fp32 SMOKE losses and every gradient leaf are bitwise equal with remat
   on and off, for qwen3 (one-layer groups), deepseek (a ``first_k_dense``
   layer outside the groups, MoE aux losses through them), jamba (one
   8-layer group), hubert (an encoder) and xlstm (a 4-layer group);
2. with remat on (the default) the gradients are the reference's: qwen3
   and hubert in ``test_torch_train_grads.py``, jamba and xlstm in
   ``test_torch_ssm_models.py`` (those tests run with the default), and
   deepseek here, against ``jax.grad`` of the reference's ``loss_fn``
   (its ``remat`` on too) within their tolerances: the loss 1e-4
   relative, each trainable leaf 1e-4 x max(1, max |g|);
3. the bytes autograd saves for backward outside the checkpointed groups
   (a ``saved_tensors_hooks`` pack hook around ``loss_fn``) are far fewer
   with remat, each pinned: the groups keep only their inputs;
4. FSDP over ``"data"`` on (2, 1) and ``"act_seq"`` on (1, 2), 2 gloo
   ranks, 2 Trainer steps each: losses and ``grad_norm`` bitwise equal
   with remat on and off; under FSDP a rank's all-gathers over ``"data"``
   a step are one a block in forward and one a block in the recompute,
   and none is left to the saved-tensor hook (without remat the hook
   makes the second).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h
from repro.configs import get_config as jget
from repro.models import transformer as jt
from repro_torch.common.tree import flatten_dict, tree_map_with_path
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import is_frozen
from repro_torch.train.steps import init_params, loss_grads

ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "hubert-xlarge", "xlstm-350m")
LOSS_TOL = 1e-4     # relative, as the SMOKE parity tests
GRAD_TOL = 1e-4     # x max(1, max |g|), per trainable leaf
# bytes saved for backward outside the groups (remat on, off): 2 x 32
# tokens, fp32 compute (shapes alone decide them)
SAVED = {"qwen3-1.7b": (510728, 2062536),
         "deepseek-v2-lite-16b": (1307880, 3549928),
         "jamba-v0.1-52b": (494344, 39548328),
         "hubert-xlarge": (149768, 1170120),
         "xlstm-350m": (477960, 5798888)}


def _mode(arch):
    return "exact" if arch == "xlstm-350m" else "rm"


def _cfgs(arch):
    mode = _mode(arch)
    jcfg = dataclasses.replace(jget(arch, smoke=True, attention_mode=mode),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True,
                                          attention_mode=mode),
                               compute_dtype="float32")
    if mode == "rm":
        jcfg = dataclasses.replace(jcfg, rm=dataclasses.replace(
            jcfg.rm, fuse_featurize="on"))
    return jcfg, tcfg


def _models(arch, handed=False):
    """The SMOKE weights (the port's own draw; with ``handed``, the
    reference's and the port's copy of them) and a batch of 2 x 32
    positions in both packages."""
    jcfg, tcfg = _cfgs(arch)
    if handed:
        jp = jax.jit(jt.init_model, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    else:
        jp, tp = None, init_params(tcfg, 0, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 33))
    if jcfg.frontend == "audio_stub":
        x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
        jb = {"embeds": jnp.asarray(x),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"embeds": torch.from_numpy(x),
              "targets": torch.from_numpy(toks[:, 1:])}
    else:
        jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"tokens": torch.from_numpy(toks[:, :-1]),
              "targets": torch.from_numpy(toks[:, 1:])}
    return jcfg, jp, jb, tcfg, tp, tb


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _grads(tcfg, tp, tb, remat):
    cfg = dataclasses.replace(tcfg, remat=remat)
    grads, metrics = loss_grads(cfg, tp, tb)
    return flatten_dict(grads), metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bitwise_equal(arch):
    _, _, _, tcfg, tp, tb = _models(arch)
    assert tcfg.remat is True                   # the reference's default
    on, m_on = _grads(tcfg, tp, tb, True)
    off, m_off = _grads(tcfg, tp, tb, False)
    assert set(on) == set(off)
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    for k in on:
        assert torch.equal(on[k], off[k]), k
    if arch == "deepseek-v2-lite-16b":
        assert tcfg.first_k_dense == 1 and "moe_load_balance" in m_on
    if arch == "jamba-v0.1-52b":
        assert len(tcfg.block_pattern) == tcfg.num_layers == 8


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b"])
def test_remat_grads_match_reference(arch):
    jcfg, jp, jb, tcfg, tp, tb = _models(arch, handed=True)
    assert jcfg.remat and tcfg.remat
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    want = flatten_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg))
    got, metrics = _grads(tcfg, tp, tb, True)
    loss = float(metrics["loss"])
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    got = {k: g for k, g in got.items()
           if not is_frozen(tuple(k.split("/"))) and g.is_floating_point()}
    assert set(got) == {k for k in want if "rm_est" not in k}
    for key, g in got.items():
        assert _rel(g.numpy(), want[key]) <= GRAD_TOL, (key, _rel(
            g.numpy(), want[key]))


def _saved_bytes(tcfg, tp, tb, remat):
    cfg = dataclasses.replace(tcfg, remat=remat)
    live = tree_map_with_path(
        lambda path, p: p.detach().requires_grad_(True)
        if p.is_floating_point() and not is_frozen(path) else p, tp)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tt.loss_fn(live, cfg, tb)
    return total[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_saves_fewer_bytes_for_backward(arch):
    _, _, _, tcfg, tp, tb = _models(arch)
    got = (_saved_bytes(tcfg, tp, tb, True),
           _saved_bytes(tcfg, tp, tb, False))
    # pinned: the ratios are qwen3 0.248, deepseek 0.368, jamba 0.0125,
    # hubert 0.128, xlstm 0.0824
    assert got == SAVED[arch]
    assert got[0] < got[1]


# ---------------------------------------------------------------------------
# FSDP and "act_seq" on gloo ranks
# ---------------------------------------------------------------------------
STEPS = 2


def _train(shape, remat, rules, out):
    """STEPS Trainer steps of qwen3 SMOKE rm (fp32) on ``shape`` with
    ``remat`` -> (loss and grad_norm rows, a step's all-gathers, those the
    saved-tensor hook made)."""
    import contextlib

    from repro_torch.distributed import collectives, fsdp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(h.port_config("qwen3-1.7b", "rm"),
                              remat=remat)
    mesh = make_mesh(shape, ("data", "model"))
    ctx = contextlib.nullcontext() if rules is None else \
        logical_rules_context(mesh, rules)
    regathers = [0]
    unpack = fsdp._Regather.unpack

    def counting(obj):
        if isinstance(obj, tuple) and obj[0].cache is None:
            regathers[0] += 1
        return unpack(obj)

    fsdp._Regather.unpack = staticmethod(counting)
    try:
        with ctx:
            trainer = Trainer(cfg, h.hyper(STEPS), h.dataset(cfg), mesh=mesh,
                              log_every=1, device="cpu")
            state = trainer.init_or_restore()
            before = collectives.all_gather.calls
            trainer.train(STEPS, state)
            gathers = collectives.all_gather.calls - before
    finally:
        fsdp._Regather.unpack = staticmethod(unpack)
    rows = [(r["loss"], r["grad_norm"]) for r in trainer.metrics_log]
    return rows, gathers // STEPS, regathers[0] // STEPS


def worker(rank, world, store, out):
    h.init_gloo(rank, world, store)
    report = {}
    for label, shape, rules in (("fsdp", (2, 1), {"act_seq": None}),
                                ("seq", (1, 2), {"fsdp": None})):
        for remat in (True, False):
            report[f"{label}/{remat}"] = _train(shape, remat, rules, out)
    (Path(out) / f"remat_{rank}.json").write_text(json.dumps(report))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat")
    h.spawn(worker, 2, out)
    return [json.loads((out / f"remat_{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("label", ["fsdp", "seq"])
def test_mesh_runs_with_remat_equal_remat_off(mesh_runs, label):
    for report in mesh_runs:
        on, off = report[f"{label}/True"], report[f"{label}/False"]
        assert len(on[0]) == STEPS
        assert on[0] == off[0], (label, on[0], off[0])


def test_fsdp_gathers_under_remat(mesh_runs):
    """qwen3 SMOKE: 2 layers, one group each; its embedding is tied (no
    ``unembed`` leaf), and the table and the norms are not cut over
    "data", so every gather is a block's."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    assert cfg.tie_embeddings
    layers = cfg.num_layers
    for report in mesh_runs:
        _, gathers_on, hook_on = report["fsdp/True"]
        _, gathers_off, hook_off = report["fsdp/False"]
        # forward: one a block; backward: the recompute's, one a block;
        # none left to the saved-tensor hook
        assert (gathers_on, hook_on) == (2 * layers, 0)
        # without remat the hook gathers every block again instead
        assert (gathers_off, hook_off) == (2 * layers, layers)
