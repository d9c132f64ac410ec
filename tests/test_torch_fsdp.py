"""FSDP over ``"data"`` (``distributed.fsdp``, the Trainer's default on a
data axis above 1) and ``"act_seq"`` sequence sharding over ``"model"``
(``tensor_parallel.sequence_sharding``) on gloo ranks on the CPU: qwen3
SMOKE rm (fused, fp32 compute), 3 steps of 4 x 32 tokens from the
reference's train state (a step-0 checkpoint each run restores onto its
mesh), held against the port's replicated path (the same mesh with the
rule switched off: ``logical_rules_context(mesh, rules={"fsdp": None})``
or ``{"act_seq": None}``) and against the reference's own
mesh runs (one subprocess, ``torch_mesh_harness``), which apply both
rules by default:

1. under FSDP each leaf of params, ``mu`` and ``nu`` is this data rank's
   slice along its ``"fsdp"`` dim (``fsdp.data_dims``), a state's cut
   and join are a bitwise round trip, and the seed's draw cut block by
   block (``init_local_params(fsdp_cut=True)``) is the cut of the full
   draw;
2. FSDP on (2, 1) and FSDP with ``"act_seq"`` on (2, 2), and
   ``"act_seq"`` on (1, 2): every step's loss and ``grad_norm`` within
   1e-6 relative of the replicated path's and within 1e-5 of the
   reference's mesh run; the gathered final state within 1e-6 relative
   2-norm of the replicated path's;
3. ``"act_seq"`` cuts the residual stream: a forward on (1, 2) makes one
   sequence all-gather a block entry (none with the rule off), and the
   final norm's input is a rank's half of the sequence;
4. the checkpoint FSDP wrote on (2, 1) restores bitwise on one device, at
   model 2 (gathered back) and on (2, 1) (the trained shards);
5. ``int8_pod`` on a (pod 2, data 2, model 1) mesh: each residual is a
   data slice, and the losses are within 1e-6 of the same run with FSDP
   off (each leaf's int8 scale is shared over its data slices).
"""
import json
import pickle
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h

ARCH, MODE = "qwen3-1.7b", "rm"
STEPS = 3
TRAIN = ((2, 1), (2, 2), (1, 2))
SAME = 1e-6            # relative: the port's paths against each other
TOL = 1e-5             # relative: against the reference's mesh run

ORACLE = r'''
cfg = config("ARCH", "MODE")
state = init_state(cfg)
hand_over({"state": state})
ref = {shape: train_on_mesh(cfg, state, shape) for shape in TRAIN}
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(ref, f)
'''.replace("ARCH", ARCH).replace("MODE", MODE).replace("TRAIN", repr(TRAIN))


def _config():
    return h.port_config(ARCH, MODE)


def _ckpt(out, tag):
    return Path(out) / f"ckpt_{tag}"


def _train(out, shape, tag, rules=None, hyper=None, axes=("data", "model")):
    """Train on a mesh of ``shape`` over ``axes`` (under ``rules``) from
    the step-0 checkpoint ``tag`` -> (rows, trainer, local state)."""
    import contextlib

    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = _config()
    mesh = make_mesh(shape, axes)
    ctx = contextlib.nullcontext() if rules is None else \
        logical_rules_context(mesh, rules)
    with ctx:
        trainer = Trainer(cfg, hyper or h.hyper(STEPS), h.dataset(cfg),
                          mesh=mesh, ckpt_dir=str(_ckpt(out, tag)),
                          log_every=1, checkpoint_every=10 ** 9,
                          device="cpu")
        state = trainer.train(STEPS, trainer.init_or_restore())
    rows = [(r["loss"], r["grad_norm"]) for r in trainer.metrics_log]
    return rows, trainer, state


def _layout(trainer, state):
    """Whether every leaf of params, mu, nu (and residuals) is this
    rank's data slice of the full leaf, and how many leaves are cut."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.distributed import fsdp

    dims = flatten_dict(fsdp.data_dims(trainer._template, trainer.mesh))
    full = flatten_dict(trainer._template)
    trees = [state["params"], state["opt"]["mu"], state["opt"]["nu"]]
    if "residuals" in state:
        trees.append(state["residuals"])
    ok, cut = True, 0
    for tree in trees:
        for k, v in flatten_dict(tree).items():
            want = list(full[k].shape)
            if dims[k] is not None:
                want[dims[k]] //= 2
                cut += 1
            ok = ok and list(v.shape) == want
    return ok, cut


def _seq_collectives(out):
    """All-gathers in one forward on (1, 2) with "act_seq" on and off, and
    the final norm input's length with it on."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, transformer as tt

    handed = pickle.loads((Path(out) / "handed.pkl").read_bytes())
    cfg = _config()
    mesh = make_mesh((1, 2), ("data", "model"))
    local = tp.shard_params(params_from_jax(handed["state"]["params"], cfg),
                            mesh, cfg)
    lcfg = tp.local_config(cfg, 2)
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.long)}
    seen, counts, logits = [], {}, {}
    norm = layers.apply_norm

    def spy(params, cfg_, x):
        seen.append(x.shape[1])
        return norm(params, cfg_, x)

    for label, rules in (("on", None), ("off", {"act_seq": None})):
        with logical_rules_context(mesh, rules), tp.local_view(mesh), \
                torch.no_grad():
            calls = collectives.all_gather.calls
            tt.apply_norm = spy
            try:
                logits[label] = tp.gather_vocab(
                    tt.forward(local, lcfg, batch)[0], lcfg)
            finally:
                tt.apply_norm = norm
            counts[label] = collectives.all_gather.calls - calls
    return {"gathers": counts, "norm_len": seen[len(seen) // 2 - 1],
            "logits_equal": bool(torch.equal(logits["on"], logits["off"])),
            "blocks": cfg.num_layers}


def worker(rank, world, store, out):
    h.init_gloo(rank, world, store)
    out = Path(out)
    from repro_torch.common.tree import flatten_dict
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh
    from repro_torch.train.steps import TrainHyper

    report = {"train": {}}

    def run(shape, tag, rules=None, **kw):
        rows, trainer, state = _train(out, shape, tag, rules, **kw)
        report["train"][tag] = rows
        full = trainer.full_state(state)
        if rank == 0:
            torch.save(flatten_dict(full), out / f"state_{tag}.pt")
        return trainer, state

    if world == 2:
        trainer, state = run((2, 1), "fsdp2x1")
        report["layout"] = _layout(trainer, state)
        full = trainer.full_state(state)
        again = tp.gather_state(tp.shard_state(full, trainer.mesh, _config(),
                                               fsdp_cut=True),
                                trainer.mesh, trainer._template)
        a, b = flatten_dict(full), flatten_dict(again)
        report["round_trip"] = set(a) == set(b) and all(
            torch.equal(a[k], b[k]) for k in a)
        # the streamed draw cut over "data" is the cut of the full draw
        from repro_torch.train.steps import init_params

        drawn, _ = tp.init_local_params(_config(), 0, trainer.mesh, "cpu",
                                        fsdp_cut=True)
        want = flatten_dict(tp.shard_params(init_params(_config(), 0, "cpu"),
                                            trainer.mesh, _config(),
                                            fsdp_cut=True))
        report["init_local"] = all(torch.equal(v, want[k]) for k, v in
                                   flatten_dict(drawn).items())
        ckpt = CheckpointManager(_ckpt(out, "fsdp2x1"))
        _, back = elastic_remesh(ckpt, lambda: trainer.mesh, cfg=_config())
        t, g = flatten_dict(state), flatten_dict(back)
        report["restore_fsdp"] = set(t) == set(g) and all(
            torch.equal(t[k], g[k]) for k in t)
        m2 = make_mesh((1, 2), ("data", "model"))
        _, back = elastic_remesh(ckpt, lambda: m2, cfg=_config())
        g = flatten_dict(tp.gather_state(back, m2, trainer._template))
        report["restore_model2"] = all(torch.equal(a[k], g[k]) for k in a)
        run((2, 1), "off2x1", {"fsdp": None})
        run((1, 2), "seq1x2")
        run((1, 2), "off1x2", {"act_seq": None})
        report["seq"] = _seq_collectives(out)
    else:
        run((2, 2), "fsdp2x2")
        run((2, 2), "off2x2", {"fsdp": None, "act_seq": None})
        int8 = TrainHyper(**{**h.hyper(STEPS).__dict__,
                             "grad_compression": "int8_pod"})
        axes = ("pod", "data", "model")
        trainer, state = run((2, 2, 1), "int8", hyper=int8, axes=axes)
        report["int8_layout"] = _layout(trainer, state)
        run((2, 2, 1), "int8off", {"fsdp": None}, hyper=int8, axes=axes)
    (out / f"report{world}_{rank}.json").write_text(json.dumps(report))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.common.tree import flatten_dict, tree_map_with_path
    from repro_torch.convert import train_state_from_jax
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    out = tmp_path_factory.mktemp("fsdp")
    proc = h.start_oracle(ORACLE, out)
    h.wait_for(proc, out / "handed.pkl")
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    cfg = _config()
    state0 = train_state_from_jax(handed["state"], cfg)
    for tag in ("fsdp2x1", "off2x1", "seq1x2", "off1x2", "fsdp2x2",
                "off2x2"):
        CheckpointManager(_ckpt(out, tag)).save(0, state0)
    # int8_pod's state carries the error-feedback residuals
    state0["residuals"] = tree_map_with_path(
        lambda _, p: torch.zeros_like(p), state0["params"])
    for tag in ("int8", "int8off"):
        CheckpointManager(_ckpt(out, tag)).save(0, state0)
    h.spawn(worker, 2, out)
    h.spawn(worker, 4, out)
    trainer = Trainer(cfg, h.hyper(STEPS), h.dataset(cfg), log_every=1,
                      device="cpu")
    trainer.train(STEPS, train_state_from_jax(handed["state"], cfg))
    return {"out": out, "ref": h.finish(proc, out),
            "reports": {w: [json.loads((out / f"report{w}_{r}.json")
                                       .read_text()) for r in range(w)]
                        for w in (2, 4)},
            "one_device": CheckpointManager(_ckpt(out, "fsdp2x1")).restore(
                device="cpu"),
            "single_rows": [(r["loss"], r["grad_norm"])
                            for r in trainer.metrics_log],
            "flatten": flatten_dict}


def _rows(runs, world, tag):
    reps = runs["reports"][world]
    for rep in reps:
        assert rep["train"][tag] == reps[0]["train"][tag], tag
    return reps[0]["train"][tag]


def test_fsdp_cuts_every_state_tree_along_its_fsdp_dim(runs):
    for rep in runs["reports"][2]:
        ok, cut = rep["layout"]
        assert ok and cut > 0
        assert rep["round_trip"] and rep["init_local"]
    for rep in runs["reports"][4]:
        ok, cut = rep["int8_layout"]
        assert ok and cut > 0


CASES = (("fsdp2x1", "off2x1", 2, (2, 1)), ("fsdp2x2", "off2x2", 4, (2, 2)),
         ("seq1x2", "off1x2", 2, (1, 2)))


@pytest.mark.parametrize("tag,off,world,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_the_replicated_path_and_the_reference(runs, tag, off, world,
                                                       shape, capsys):
    got = _rows(runs, world, tag)
    base = _rows(runs, world, off)
    want = runs["ref"][shape]
    gaps = {}
    for name, other in (("replicated", base), ("reference", want)):
        for i, metric in enumerate(("loss", "grad_norm")):
            gaps[f"{name}/{metric}"] = h.rel_gaps([g[i] for g in got],
                                                  [o[i] for o in other])
    with capsys.disabled():
        print(f"\n[fsdp] {tag}: " + "; ".join(
            f"{k} " + " ".join(f"{v:.1e}" for v in vals)
            for k, vals in gaps.items()))
    for k, vals in gaps.items():
        assert max(vals) <= (SAME if k.startswith("replicated") else TOL), k
    a = torch.load(runs["out"] / f"state_{tag}.pt")
    b = torch.load(runs["out"] / f"state_{off}.pt")
    assert h.state_gap(a, b) <= SAME


def test_act_seq_cuts_the_residual_stream(runs):
    seq = runs["reports"][2][0]["seq"]
    assert seq["gathers"]["off"] == 1                # the vocab gather
    # one sequence gather a block entry (mixer and MLP) and the head's
    assert seq["gathers"]["on"] == 1 + 2 * seq["blocks"] + 1
    assert seq["norm_len"] == 16                      # 32 positions / 2
    assert seq["logits_equal"]


def test_fsdp_checkpoint_restores_anywhere(runs):
    gathered = torch.load(runs["out"] / "state_fsdp2x1.pt")
    one = runs["flatten"](runs["one_device"])
    assert set(one) == set(gathered)
    assert all(torch.equal(one[k], v) for k, v in gathered.items())
    for rep in runs["reports"][2]:
        assert rep["restore_fsdp"] and rep["restore_model2"]


def test_int8_pod_under_fsdp_matches_fsdp_off(runs):
    got = _rows(runs, 4, "int8")
    want = _rows(runs, 4, "int8off")
    assert max(h.rel_gaps([g[0] for g in got], [w[0] for w in want])) <= SAME
    assert got[-1][0] < got[0][0]
