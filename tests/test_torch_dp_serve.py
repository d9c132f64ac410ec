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
counts capacity over the whole decode batch; the port splits a MoE's
slots over "data" like a dense model's, and its MoE layers all-gather the
decode tokens to route them together, so a rank's decode cache is half
the cache of every slot. The port serves the same requests from the
same weights (each rank's shards, ``tensor_parallel.shard_params``; on a
data axis above 1 they are cut over "data" too, ``fsdp_cut=True``, as the
reference's specs place them, and qwen3's cases also run with them whole,
``rules={"fsdp": None}``, for tokens, logits and bytes) on one
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
import torch_threads  # noqa: F401  (one intra-op thread)

SPAWN_TIMEOUT = 150
ORACLE_TIMEOUT = 240
REQUESTS, MAX_NEW, MAX_LEN = 8, 6, 64
CASES = (("qwen3", (2, 1), 4), ("qwen3", (1, 2), 4), ("qwen3", (2, 2), 4),
         ("qwen3", (2, 1), 3), ("deepseek", (2, 1), 4),
         ("deepseek", (2, 2), 4))
ARCHS = {"qwen3": "qwen3-1.7b", "deepseek": "deepseek-v2-lite-16b"}
# the meshes the serving cut over "data" is held on against the whole
# weights (rules={"fsdp": None})
CUT = ((2, 1), (2, 2))

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
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.sharding import (logical_rules_context,
                                        params_partition_specs)
spec_bytes = {}
for shape in CUT:
    mesh = make_mesh(shape, ("data", "model"))
    with logical_rules_context(mesh) as rules:
        specs = params_partition_specs(params["qwen3"], mesh, rules)
    spec_bytes[f"{shape[0]}x{shape[1]}"] = int(sum(
        np.prod(NamedSharding(mesh, s).shard_shape(a.shape))
        * a.dtype.itemsize for a, s in zip(
            jax.tree_util.tree_leaves(params["qwen3"]),
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda s: isinstance(s, P)))))
with open(os.path.join(out, "ref_bytes.pkl"), "wb") as f:
    pickle.dump(spec_bytes, f)
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(tokens, f)
'''.replace("REQUESTS", str(REQUESTS)).replace("MAX_NEW", str(MAX_NEW)) \
    .replace("MAX_LEN", str(MAX_LEN)).replace("CASES", repr(CASES)) \
    .replace("ARCHS", repr(ARCHS)).replace("CUT", repr(CUT))


def _config(name):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(ARCHS[name], smoke=True, attention_mode="rm")
    return dataclasses.replace(cfg, compute_dtype="float32")


def _serve(handed, name, mesh, slots, rules=None):
    """Every request of ``name`` through a port Scheduler (on a mesh, each
    rank's shards of the handed weights; built under ``rules``) ->
    ({request id: tokens}, the bytes of the executor's weights, the
    executor)."""
    import contextlib

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.serve import Request, Scheduler

    cfg = _config(name)
    handed = handed[name]
    params = params_from_jax(handed["params"], cfg)
    ctx = contextlib.nullcontext() if rules is None else \
        logical_rules_context(mesh, rules)
    with ctx:
        if mesh is not None:
            params = tp.shard_params(params, mesh, cfg,
                                     fsdp_cut=fsdp.enabled(mesh))
        sched = Scheduler(cfg, params, num_slots=slots, max_len=MAX_LEN,
                          device="cpu", mesh=mesh)
    for i, p in enumerate(handed["prompts"]):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=MAX_NEW))
    done = sched.run()
    return ({r: [int(t) for t in done[r].generated] for r in sorted(done)},
            _weight_bytes(sched.executor.params), sched.executor)


def _cache_bytes(executor):
    """A rank's decode-cache bytes, and those of the cache of every slot
    at the rank's model widths."""
    from repro_torch.models.transformer import init_decode_cache

    whole = init_decode_cache(executor.model_cfg, executor.num_slots,
                              executor.max_len, "cpu")
    return _weight_bytes(executor.cache), _weight_bytes(whole)


def _weight_bytes(params):
    from repro_torch.common.tree import tree_leaves

    return sum(p.numel() * p.element_size() for p in tree_leaves(params))


def _spec_bytes(name, mesh):
    """A rank's bytes under the port's ``params_partition_specs`` of the
    full weights (the cut over "data" and over "model")."""
    from repro_torch.distributed.sharding import (mesh_axes,
                                                  params_partition_specs)
    from repro_torch.common.tree import tree_get, tree_map_with_path
    from repro_torch.models.transformer import meta_params

    template = meta_params(_config(name))
    specs = params_partition_specs(template, mesh)
    sizes = mesh_axes(mesh)
    total = [0]

    def one(path, p):
        shape = list(p.shape)
        for d, entry in enumerate(tree_get(specs, path)):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    shape[d] //= sizes[axis]
        total[0] += int(np.prod(shape)) * p.element_size()

    tree_map_with_path(one, template)
    return total[0]


def _decode_logits(handed, name, mesh, rules=None):
    """Two admissions and three greedy decode steps through a
    ``StepExecutor`` on ``mesh`` (built under ``rules``) -> every logits
    row, in order."""
    import contextlib

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import logical_rules_context
    from repro_torch.serve.executor import StepExecutor

    cfg = _config(name)
    ctx = contextlib.nullcontext() if rules is None else \
        logical_rules_context(mesh, rules)
    with ctx:
        params = tp.shard_params(
            params_from_jax(handed[name]["params"], cfg), mesh, cfg,
            fsdp_cut=fsdp.enabled(mesh))
        ex = StepExecutor(cfg, params, 4, MAX_LEN, device="cpu", mesh=mesh)
    rows, lens = [], []
    for slot in (0, 1):
        prompt = handed[name]["prompts"][slot]
        row, _ = ex.admit(slot, prompt)
        rows.append(row)
        lens.append(len(prompt))
    tokens = torch.zeros((4, 1), dtype=torch.long)
    positions = torch.full((4,), ex.scratch_position, dtype=torch.int32)
    for step in range(3):
        for slot in (0, 1):
            tokens[slot, 0] = int(rows[-2 + slot].argmax())
            positions[slot] = lens[slot] + step
        logits = ex.decode(tokens, positions)
        rows.extend([logits[0, 0][None], logits[1, 0][None]])
    return rows


def _whole_refused(handed, name, mesh):
    """Whether a ``StepExecutor`` under the "fsdp" rule refuses weights
    not cut over "data" (the message)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.serve.executor import StepExecutor

    cfg = _config(name)
    params = tp.shard_params(params_from_jax(handed[name]["params"], cfg),
                             mesh, cfg)
    try:
        StepExecutor(cfg, params, 4, MAX_LEN, device="cpu", mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


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
            mesh = make_mesh(shape, ("data", "model"))
            calls = collectives.broadcast.calls
            got[label], got[label + "/bytes"], executor = _serve(
                handed, name, mesh, slots)
            got[label + "/broadcasts"] = collectives.broadcast.calls - calls
            got[label + "/cache_bytes"] = _cache_bytes(executor)
            if name == "qwen3" and shape in CUT and slots == 4:
                calls = collectives.broadcast.calls
                got[label + "/whole"], got[label + "/whole_bytes"], _ = \
                    _serve(handed, name, mesh, slots, {"fsdp": None})
                got[label + "/whole_broadcasts"] = \
                    collectives.broadcast.calls - calls
                got[label + "/spec_bytes"] = _spec_bytes(name, mesh)
                cut = _decode_logits(handed, name, mesh)
                whole = _decode_logits(handed, name, mesh, {"fsdp": None})
                got[label + "/logits_equal"] = len(cut) == len(whole) == 8 \
                    and all(torch.equal(a, b) for a, b in zip(cut, whole))
                got[label + "/whole_refused"] = _whole_refused(handed, name,
                                                               mesh)
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
            "ref_bytes": pickle.loads((out / "ref_bytes.pkl").read_bytes()),
            "ranks": ranks,
            "single": {name: _serve(handed, name, None, 4)[0]
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
    its owner, one broadcast an admission, whether the weights are cut
    over "data" (the default "fsdp" rule: the other data ranks join the
    owner's gathers) or whole (``rules={"fsdp": None}``); a MoE's slots
    (deepseek) are split alike, a rank's decode cache half the cache of
    every slot; 3 slots on data 2 are replicated (no broadcast)."""
    label = f"{name}/{shape[0]}x{shape[1]}/{slots}"
    world = shape[0] * shape[1]
    want = _keyed(runs["ref"][label])
    for r in range(world):
        got = runs["ranks"][(world, r)]
        assert _keyed(got[label]) == runs["single"][name] == want, (label, r)
        split = shape[0] > 1 and slots % shape[0] == 0
        assert got[label + "/broadcasts"] == (REQUESTS if split else 0)
        rank_bytes, all_slots = got[label + "/cache_bytes"]
        assert rank_bytes * (shape[0] if split else 1) == all_slots
        if label + "/whole" in got:
            assert got[label + "/whole_broadcasts"] == REQUESTS


@pytest.mark.parametrize("shape", CUT, ids=[f"{s[0]}x{s[1]}" for s in CUT])
def test_weights_cut_over_data_serve_as_the_whole_weights(runs, shape):
    """qwen3 SMOKE, 4 slots: with the weights cut over "data" (the
    default), each rank's tokens and every logits row of two admissions
    and three decode steps are bitwise those of the same mesh with the
    weights whole (``rules={"fsdp": None}``); a rank holds the bytes of
    its spec (the port's ``params_partition_specs`` and the
    reference's), about half of the whole weights' on data 2. Under the
    "fsdp" rule the executor refuses weights not cut over "data"."""
    label = f"qwen3/{shape[0]}x{shape[1]}/4"
    world = shape[0] * shape[1]
    for r in range(world):
        got = runs["ranks"][(world, r)]
        assert got[label] == got[label + "/whole"], r
        assert got[label + "/logits_equal"] is True, r
        assert got[label + "/bytes"] == got[label + "/spec_bytes"] == \
            runs["ref_bytes"][f"{shape[0]}x{shape[1]}"], r
        assert got[label + "/bytes"] < 0.7 * got[label + "/whole_bytes"]
        assert "is not cut over 'data'" in got[label + "/whole_refused"], r


def test_serve_launcher_data_parallel(runs):
    """``--data-parallel`` on a 2-rank default group: a (2, 1) host mesh;
    rank 0 prints the mesh and every request, rank 1 nothing."""
    log0 = runs["ranks"][(2, 0)]["launcher"]
    log1 = runs["ranks"][(2, 1)]["launcher"]
    assert "[serve] mesh {'data': 2, 'model': 1} over 2 ranks" in log0
    assert "[serve] 2 requests, 6 tokens" in log0
    assert "req 1: 3 tokens (max_new_tokens)" in log0
    assert log1 == ""
