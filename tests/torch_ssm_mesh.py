"""The SSM tensor-parallel runs shared by ``test_torch_ssm_tensor_parallel``
(jamba SMOKE: Mamba, one attention layer in rm mode, the MoE) and
``test_torch_xlstm_tensor_parallel`` (xlstm SMOKE: mLSTM and sLSTM).

The reference (one subprocess, ``torch_mesh_harness``) draws the model's
train state (fp32 compute) and three prompts of 8 tokens, hands them
over, then trains 3 steps on each mesh shape of the case under its
default rules (FSDP over ``"data"``, ``"act_seq"`` over ``"model"``) and
serves the prompts greedily with its ``Scheduler`` (no mesh). The port's
ranks restore that state from a step-0 checkpoint onto their mesh (one
spawn a world size), train the same steps, serve the same prompts through
``Scheduler(mesh=)`` from their shards, and cut and join every parameter
and decode-cache leaf (``shard_params`` / ``gather_params``,
``shard_cache`` / ``gather_cache``).
"""
import json
import pickle
from pathlib import Path

import numpy as np
import torch

import torch_mesh_harness as h

MODELS = {"jamba": ("jamba-v0.1-52b", "rm"), "xlstm": ("xlstm-350m", None)}
MAX_NEW = 4

ORACLE = r'''
NAME, TRAIN = "NAME", TRAIN_SHAPES
arch, mode = MODELS[NAME]
cfg = config(arch, mode)
state = init_state(cfg)
rng = np.random.default_rng(1)
prompts = [rng.integers(0, cfg.vocab_size, size=8) for _ in range(3)]
hand_over({"state": state, "prompts": prompts,
           "shapes": shard_shapes(state["params"], (1, 2))})
ref = {"train": {}}
for shape in TRAIN:
    ref["train"][shape] = train_on_mesh(cfg, state, shape)
ref["tokens"] = serve(cfg, state["params"], prompts, MAX_NEW)
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(ref, f)
'''


def oracle(name, train):
    return (ORACLE.replace("NAME", name).replace("TRAIN_SHAPES", repr(train))
            .replace("MODELS", repr(MODELS))
            .replace("MAX_NEW", str(MAX_NEW)))


def config(name):
    return h.port_config(*MODELS[name])


def ckpt_dir(out, shape):
    return Path(out) / f"ckpt{shape[0]}x{shape[1]}"


def serve(cfg, params, prompts, mesh=None):
    """The prompts through a port Scheduler -> {request id: tokens}."""
    from repro_torch.serve import Request, Scheduler

    sched = Scheduler(cfg, params, num_slots=2, max_len=32, device="cpu",
                      mesh=mesh)
    for i, p in enumerate(prompts):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=MAX_NEW))
    done = sched.run()
    return {r: [int(t) for t in done[r].generated] for r in sorted(done)}


def _round_trips(name, handed, mesh, report):
    """Every parameter and decode-cache leaf cut and joined back; the
    local shapes; the mesh's prefill cache against the cut of one
    device's; a fresh decode cache at the local config's widths."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import transformer as tt

    cfg = config(name)
    full = params_from_jax(handed["state"]["params"], cfg)
    local = tp.shard_params(full, mesh, cfg)
    back = tp.gather_params(local, mesh, tp.meta_template(full))
    a, b = flatten_dict(full), flatten_dict(back)
    report["round_trip"] = set(a) == set(b) and all(
        torch.equal(a[k], b[k]) for k in a)
    report["shapes"] = {k: list(v.shape)
                        for k, v in flatten_dict(local).items()}
    # the streamed draw (a block cut as soon as it is drawn) is the cut of
    # the full draw
    from repro_torch.train.steps import init_params

    drawn, _ = tp.init_local_params(cfg, 0, mesh, "cpu")
    want = flatten_dict(tp.shard_params(init_params(cfg, 0, "cpu"), mesh,
                                        cfg))
    report["init_local"] = all(torch.equal(v, want[k]) for k, v in
                               flatten_dict(drawn).items())
    batch = {"tokens": torch.from_numpy(handed["prompts"][0][None]).long()}
    with torch.no_grad():
        _, cache = tt.prefill(full, cfg, batch, 32)
        lcfg = tp.local_config(cfg, tp.model_size_of(mesh))
        with tp.local_view(mesh):
            _, mesh_cache = tt.prefill(local, lcfg, batch, 32)
    cut = tp.shard_cache(cache, mesh, cfg)
    again = tp.gather_cache(cut, mesh, tp.meta_template(cache))
    a, b = flatten_dict(cache), flatten_dict(again)
    report["cache_round_trip"] = set(a) == set(b) and all(
        torch.equal(a[k], b[k]) for k in a)
    c, m = flatten_dict(cut), flatten_dict(mesh_cache)
    report["cache_gap"] = max(
        float((m[k].float() - c[k].float()).abs().max()
              / c[k].float().abs().max().clamp_min(1.0)) for k in c)
    fresh = flatten_dict(tt.init_decode_cache(lcfg, 1, 32, "cpu"))
    report["cache_shapes"] = all(
        fresh[k].shape == c[k].shape and fresh[k].dtype == c[k].dtype
        for k in c) and set(fresh) == set(c)
    report["cut_leaves"] = sorted(k for k in a if c[k].shape != a[k].shape)
    # each SSM mixer alone, relative to its output's size (the block's
    # residual stream at init is far larger than a mixer's output); Mamba
    # without its skip term, which at init is 1e6 times the scan's
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    report["mixer_gaps"] = {}
    with torch.no_grad():
        for layer in full["layers"]:
            kind = next((k for k in ("mamba", "mlstm", "slstm")
                         if k in layer), None)
            if kind is None or kind in report["mixer_gaps"]:
                continue
            mp = dict(layer[kind])
            if kind == "mamba":
                mp["d_skip"] = torch.zeros_like(mp["d_skip"])
            cut = tp.shard_params({"block": {kind: mp}}, mesh, cfg)
            fwd = tt._MIXER_FWD[kind]
            want = fwd(mp, cfg, x, None)
            with tp.local_view(mesh):
                got = fwd(cut["block"][kind], lcfg, x, None)
            report["mixer_gaps"][kind] = float(
                (got - want).abs().max() / want.abs().max())


def worker(rank, world, store, out, name, train, serve_shapes):
    """This world's round trips (2 ranks), trainings and servings; every
    rank writes its report, rank 0 each gathered final state."""
    h.init_gloo(rank, world, store)
    out = Path(out)
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = config(name)
    report = {"train": {}, "tokens": {}}
    if world == 2:
        _round_trips(name, handed, make_mesh((1, 2), ("data", "model")),
                     report)
    for shape in train:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(shape, ("data", "model"))
        trainer = Trainer(cfg, h.hyper(3), h.dataset(cfg), mesh=mesh,
                          ckpt_dir=str(ckpt_dir(out, shape)), log_every=1,
                          checkpoint_every=10 ** 9, device="cpu")
        state = trainer.train(3, trainer.init_or_restore())
        full = trainer.full_state(state)
        report["train"][str(shape)] = [(r["loss"], r["grad_norm"])
                                       for r in trainer.metrics_log]
        if rank == 0:
            torch.save(flatten_dict(full),
                       out / f"state{shape[0]}x{shape[1]}.pt")
    for shape in serve_shapes:
        if shape[0] * shape[1] != world:
            continue
        mesh = make_mesh(shape, ("data", "model"))
        local = tp.shard_params(params_from_jax(
            handed["state"]["params"], cfg), mesh, cfg,
            fsdp_cut=fsdp.enabled(mesh))
        report["tokens"][str(shape)] = serve(cfg, local, handed["prompts"],
                                             mesh)
    (out / f"report{world}_{rank}.json").write_text(json.dumps(report))


def run(tmp_path_factory, name, train, serve_shapes):
    """The oracle and the port's spawns, overlapped; then the port's one
    device: its training from the same state and its tokens."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    out = tmp_path_factory.mktemp(name)
    proc = h.start_oracle(oracle(name, train), out)
    h.wait_for(proc, out / "handed.pkl")
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    cfg = config(name)
    state0 = train_state_from_jax(handed["state"], cfg)
    for shape in train:
        CheckpointManager(ckpt_dir(out, shape)).save(0, state0)
    worlds = sorted({a * b for a, b in list(train) + list(serve_shapes)})
    for world in worlds:
        h.spawn(worker, world, out, name, train, serve_shapes)
    trainer = Trainer(cfg, h.hyper(3), h.dataset(cfg), log_every=1,
                      device="cpu")
    single = trainer.train(3, train_state_from_jax(handed["state"], cfg))
    reports = {w: [json.loads((out / f"report{w}_{r}.json").read_text())
                   for r in range(w)] for w in worlds}
    return {
        "out": out, "handed": handed, "ref": h.finish(proc, out),
        "reports": reports,
        "single_rows": [(r["loss"], r["grad_norm"])
                        for r in trainer.metrics_log],
        "single_state": flatten_dict(single),
        "single_tokens": serve(cfg, params_from_jax(
            handed["state"]["params"], cfg), handed["prompts"]),
    }
