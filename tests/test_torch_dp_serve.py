"""Serving on meshes (``Scheduler(mesh=)``, ``StepExecutor(mesh=)``, the
serve launcher's ``--data-parallel``) on gloo ranks on the CPU, held
against the port's ``mesh=None`` and against the reference's own
``Scheduler(mesh=)`` on the same mesh shapes.

The reference's runs come from one subprocess with 8 forced host devices
and its Auto meshes (``repro.launch.mesh.make_mesh``): the script below,
written to ``tmp_path``. It draws qwen3 SMOKE rm weights (fp32 compute),
writes them out for the port, then serves 8 greedy requests on no mesh,
(data 2, model 1), (1, 2) and (2, 2) with 4 slots, and on (2, 1) with 3
slots (which data 2 does not divide: every rank holds every slot). It does
the same for deepseek SMOKE rm (MLA and a MoE) on (2, 1) and (2, 2): the
reference's single-controller step routes every slot together, so its MoE
counts capacity over the whole decode batch, and the port keeps every
slot on every rank for a MoE. The port serves the same requests from the
same weights (each rank's shards, ``tensor_parallel.shard_params``) on one
2-rank spawn ((2, 1), (1, 2), (2, 1) with 3 slots, deepseek's (2, 1), then
the launcher) and one 4-rank spawn (the (2, 2) cases), each over a
``FileStore`` with a timeout. Every rank's tokens must be identical to
``mesh=None``'s and to the reference's.
"""
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

SPAWN_TIMEOUT = 150
ORACLE_TIMEOUT = 240
REQUESTS, MAX_NEW, MAX_LEN = 8, 6, 64
CASES = (("qwen3", (2, 1), 4), ("qwen3", (1, 2), 4), ("qwen3", (2, 2), 4),
         ("qwen3", (2, 1), 3), ("deepseek", (2, 1), 4),
         ("deepseek", (2, 2), 4))
ARCHS = {"qwen3": "qwen3-1.7b", "deepseek": "deepseek-v2-lite-16b"}

ORACLE = r'''
import dataclasses, os, pickle, sys
import jax, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import transformer as jt
from repro.serve.engine import Request
from repro.serve.scheduler import Scheduler

out = sys.argv[1]
assert len(jax.devices()) == 8
cfgs, params, handed = {}, {}, {}
for name, arch in ARCHS.items():
    cfg = get_config(arch, smoke=True, attention_mode="rm")
    cfgs[name] = dataclasses.replace(
        cfg, compute_dtype="float32",
        rm=dataclasses.replace(cfg.rm, fuse_featurize="on"))
    params[name] = jax.jit(jt.init_model, static_argnums=0)(
        cfgs[name], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    handed[name] = {
        "params": jax.tree_util.tree_map(np.asarray, params[name]),
        "prompts": [rng.integers(0, cfg.vocab_size,
                                 size=int(rng.integers(3, 20)))
                    for _ in range(REQUESTS)]}
with open(os.path.join(out, "handed.tmp"), "wb") as f:
    pickle.dump(handed, f)
os.replace(os.path.join(out, "handed.tmp"), os.path.join(out, "handed.pkl"))

tokens = {}
for name, label, shape, slots in [(a, f"{a}/none", None, 4) for a in ARCHS] \
        + [(a, f"{a}/{s[0]}x{s[1]}/{n}", s, n) for a, s, n in CASES]:
    mesh = None if shape is None else make_mesh(shape, ("data", "model"))
    sched = Scheduler(cfgs[name], params[name], num_slots=slots,
                      max_len=MAX_LEN, mesh=mesh)
    for i, p in enumerate(handed[name]["prompts"]):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=MAX_NEW))
    done = sched.run()
    tokens[label] = {r: [int(t) for t in done[r].generated]
                     for r in sorted(done)}
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(tokens, f)
'''.replace("REQUESTS", str(REQUESTS)).replace("MAX_NEW", str(MAX_NEW)) \
    .replace("MAX_LEN", str(MAX_LEN)).replace("CASES", repr(CASES)) \
    .replace("ARCHS", repr(ARCHS))


def _config(name):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(ARCHS[name], smoke=True, attention_mode="rm")
    return dataclasses.replace(cfg, compute_dtype="float32")


def _serve(handed, name, mesh, slots):
    """Every request of ``name`` through a port Scheduler (on a mesh, each
    rank's shards of the handed weights) -> {request id: tokens}."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.serve import Request, Scheduler

    cfg = _config(name)
    handed = handed[name]
    params = params_from_jax(handed["params"], cfg)
    if mesh is not None:
        params = tp.shard_params(params, mesh, cfg)
    sched = Scheduler(cfg, params, num_slots=slots, max_len=MAX_LEN,
                      device="cpu", mesh=mesh)
    for i, p in enumerate(handed["prompts"]):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=MAX_NEW))
    done = sched.run()
    return {r: [int(t) for t in done[r].generated] for r in sorted(done)}


def _worker(rank, world, store, out):
    """This world's cases, every rank's tokens written out; on 2 ranks
    also the launcher's ``--data-parallel`` (it ends the process group)."""
    import contextlib
    import io

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = Path(out)
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import main

    got = {}
    for name, shape, slots in CASES:
        if shape[0] * shape[1] == world:
            label = f"{name}/{shape[0]}x{shape[1]}/{slots}"
            calls = collectives.broadcast.calls
            got[label] = _serve(handed, name,
                                make_mesh(shape, ("data", "model")), slots)
            got[label + "/broadcasts"] = collectives.broadcast.calls - calls
    if world == 2:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            main(["--smoke", "--device", "cpu", "--data-parallel",
                  "--requests", "2", "--max-new", "3"])
        got["launcher"] = log.getvalue()
    else:
        dist.destroy_process_group()
    (out / f"serve{world}_{rank}.json").write_text(json.dumps(got))


def _spawn(fn, world, out):
    ctx = multiprocessing.get_context("spawn")
    store = str(out / f"store{world}")
    procs = [ctx.Process(target=fn, args=(r, world, store, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} ranks still running after " \
                     f"{SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The oracle, overlapped with the port's spawns once it has written
    the weights; then ``mesh=None``'s tokens."""
    out = tmp_path_factory.mktemp("dps")
    (out / "oracle.py").write_text(ORACLE)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, str(out / "oracle.py"),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + ORACLE_TIMEOUT
    while not (out / "handed.pkl").exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError("the reference's oracle stopped: "
                                 + proc.communicate()[0].decode()[-3000:])
        time.sleep(0.2)
    _spawn(_worker, 2, out)
    _spawn(_worker, 4, out)
    try:
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.decode()[-3000:]
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    ranks = {}
    for world in (2, 4):
        for r in range(world):
            ranks[(world, r)] = json.loads(
                (out / f"serve{world}_{r}.json").read_text())
    return {"ref": pickle.loads((out / "ref.pkl").read_bytes()),
            "ranks": ranks,
            "single": {name: _serve(handed, name, None, 4)
                       for name in ARCHS}}


def _keyed(tokens):
    return {int(k): v for k, v in tokens.items()}


def test_reference_meshes_agree_with_its_single_device(runs):
    """The oracle itself: the reference's tokens are the same on every
    mesh shape, and equal the port's ``mesh=None``'s."""
    ref = runs["ref"]
    for label, tokens in ref.items():
        name = label.split("/")[0]
        assert _keyed(tokens) == _keyed(ref[f"{name}/none"]), label
    for name in ARCHS:
        assert runs["single"][name] == _keyed(ref[f"{name}/none"]), name
        assert all(len(t) == MAX_NEW
                   for t in runs["single"][name].values())


@pytest.mark.parametrize("name,shape,slots", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}-slots{n}"
                              for a, s, n in CASES])
def test_mesh_tokens_equal_one_device_and_the_reference(runs, name, shape,
                                                        slots):
    """Every rank of the mesh samples every slot alike: its greedy tokens
    are identical to ``mesh=None``'s and to the reference's
    ``Scheduler(mesh=)`` on the same mesh shape. Slots split over "data"
    (qwen3's 4 on data 2) broadcast each admission's first logits row from
    its owner, one broadcast an admission; 3 slots on data 2, and a MoE's
    slots (deepseek), are replicated (no broadcast)."""
    label = f"{name}/{shape[0]}x{shape[1]}/{slots}"
    world = shape[0] * shape[1]
    want = _keyed(runs["ref"][label])
    for r in range(world):
        got = runs["ranks"][(world, r)]
        assert _keyed(got[label]) == runs["single"][name] == want, (label, r)
        split = (shape[0] > 1 and slots % shape[0] == 0
                 and name != "deepseek")
        assert got[label + "/broadcasts"] == (REQUESTS if split else 0)


def test_serve_launcher_data_parallel(runs):
    """``--data-parallel`` on a 2-rank default group: a (2, 1) host mesh;
    rank 0 prints the mesh and every request, rank 1 nothing."""
    log0 = runs["ranks"][(2, 0)]["launcher"]
    log1 = runs["ranks"][(2, 1)]["launcher"]
    assert "[serve] mesh {'data': 2, 'model': 1} over 2 ranks" in log0
    assert "[serve] 2 requests, 6 tokens" in log0
    assert "req 1: 3 tokens (max_new_tokens)" in log0
    assert log1 == ""
