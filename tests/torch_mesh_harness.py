"""Shared plumbing of the mesh tests that hold the port's gloo ranks
against the reference's own mesh runs (``test_torch_ssm_tensor_parallel``,
``test_torch_xlstm_tensor_parallel``, ``test_torch_fsdp``).

The reference runs as ONE subprocess a test file, with 8 forced host
devices and its Auto meshes (``repro.launch.mesh.make_mesh``; a script
kept in the test module and written to ``tmp_path``). It writes what it
hands over first (``handed.pkl``), so the port's spawns start while it
goes on, then its results (``ref.pkl``). The port's ranks are one spawn a
world size (``multiprocessing`` spawn context, one thread each) over a
``FileStore`` in ``tmp_path``: no TCP port.
"""
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

SPAWN_TIMEOUT = 150
ORACLE_TIMEOUT = 240

# the reference's side: the config, the train step on a mesh, the
# Scheduler; prepended to every oracle script
ORACLE_PRELUDE = r'''
import dataclasses, os, pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data.synthetic import SyntheticLMDataset
from repro.distributed.sharding import (batch_partition_specs,
    logical_rules_context, params_partition_specs)
from repro.launch.mesh import make_mesh
from repro.train import steps as jsteps

out = sys.argv[1]
assert len(jax.devices()) == 8
STEPS = 3
hyper = jsteps.TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS,
                          adamw=jsteps.AdamWConfig(weight_decay=0.0))


def config(arch, mode):
    cfg = get_config(arch, smoke=True, attention_mode=mode)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if mode == "rm":                      # the fused jnp formulation
        cfg = dataclasses.replace(cfg, rm=dataclasses.replace(
            cfg.rm, fuse_featurize="on"))
    return cfg


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shardings(mesh, specs):
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda s: isinstance(s, P))


def init_state(cfg):
    return host(jax.jit(lambda k: jsteps.init_train_state(cfg, k, hyper))(
        jax.random.PRNGKey(0)))


def shard_shapes(tree, shape):
    mesh = make_mesh(shape, ("data", "model"))
    return jax.tree_util.tree_map(
        lambda s, a: tuple(NamedSharding(mesh, s).shard_shape(a.shape)),
        params_partition_specs(tree, mesh), tree,
        is_leaf=lambda s: isinstance(s, P))


def hand_over(handed):
    with open(os.path.join(out, "handed.tmp"), "wb") as f:
        pickle.dump(handed, f)
    os.replace(os.path.join(out, "handed.tmp"),
               os.path.join(out, "handed.pkl"))


def train_on_mesh(cfg, state, shape):
    """STEPS train steps on a (data, model) mesh under the default rules
    (FSDP over "data", "act_seq" over "model") -> [(loss, grad_norm)]."""
    mesh = make_mesh(shape, ("data", "model"))
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4)
    batches = [data.batch_at(i) for i in range(STEPS)]
    with logical_rules_context(mesh) as rules:
        ps = params_partition_specs(state["params"], mesh, rules)
        sshard = shardings(mesh, {"params": ps, "opt": {
            "mu": ps, "nu": ps, "step": P()}, "step": P()})
        bshard = shardings(mesh, batch_partition_specs(batches[0], mesh,
                                                       rules))
        step = jax.jit(jsteps.make_train_step(cfg, hyper),
                       in_shardings=(sshard, bshard),
                       out_shardings=(sshard, None))
        state = jax.device_put(state, sshard)
        rows = []
        for b in batches:
            state, m = step(state, jax.device_put(b, bshard))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


def serve(cfg, params, prompts, max_new, mesh=None):
    from repro.serve.engine import Request
    from repro.serve.scheduler import Scheduler

    sched = Scheduler(cfg, params, num_slots=2, max_len=32, mesh=mesh)
    for i, p in enumerate(prompts):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=max_new))
    done = sched.run()
    return {r: [int(t) for t in done[r].generated] for r in sorted(done)}
'''


def start_oracle(script: str, out: Path) -> subprocess.Popen:
    """``ORACLE_PRELUDE + script`` in a subprocess with 8 forced host
    devices; it is given ``out``."""
    path = out / "oracle.py"
    path.write_text(ORACLE_PRELUDE + script)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen([sys.executable, str(path), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def wait_for(proc: subprocess.Popen, path: Path):
    """Block until ``path`` exists (the oracle's hand-over) or it fails."""
    deadline = time.monotonic() + ORACLE_TIMEOUT
    while not path.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError("the reference's oracle stopped: "
                                 + proc.communicate()[0].decode()[-3000:])
        time.sleep(0.2)


def finish(proc: subprocess.Popen, out: Path):
    """Wait for the oracle; its results."""
    try:
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.decode()[-3000:]
    return pickle.loads((out / "ref.pkl").read_bytes())


def spawn(fn, world, out, *args):
    """Run ``fn(rank, world, store_path, out, *args)`` in ``world``
    spawned processes; fail on a non-zero exit or past
    ``SPAWN_TIMEOUT``."""
    ctx = multiprocessing.get_context("spawn")
    store = str(out / f"store{world}")
    procs = [ctx.Process(target=fn, args=(r, world, store, str(out), *args))
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


def init_gloo(rank, world, store):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def port_config(arch, mode):
    """The port's config of an oracle model (fp32 compute)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True, attention_mode=mode)
    return dataclasses.replace(cfg, compute_dtype="float32")


def hyper(steps):
    """The oracle's: no weight decay, since the reference decays its
    layer-stacked 1-D leaves (the norm scales) and the port does not
    (ROADMAP.md, faults of the reference)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainHyper

    return TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=steps,
                      adamw=AdamWConfig(weight_decay=0.0))


def dataset(cfg):
    from repro_torch.data.synthetic import SyntheticLMDataset

    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4, device="cpu")


def rel_gaps(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)]


def state_gap(got, want) -> float:
    """The largest relative 2-norm gap of a flattened state's float
    leaves (integer leaves must be equal)."""
    import torch

    assert set(got) == set(want)
    worst = 0.0
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), k
            continue
        gap = (got[k].double() - v.double()).norm() / v.double().norm() \
            .clamp_min(1e-30)
        worst = max(worst, float(gap))
    return worst
