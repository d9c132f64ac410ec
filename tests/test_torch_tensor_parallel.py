"""Tensor parallelism over ``"model"`` (``repro_torch.distributed.
tensor_parallel``, the Trainer, ``models.moe.apply_moe(mesh=)``) on gloo
ranks on the CPU, held against the reference's own mesh runs.

The oracle is the reference on Auto meshes (``repro.launch.mesh.
make_mesh``) in one subprocess with 8 forced host devices: the script
below, written to ``tmp_path``. It draws the weights and the train states
first and writes them out, so the port's gloo ranks start from the same
arrays while the reference goes on. Everything is fp32 SMOKE:

1. ``shard_params`` / ``gather_params`` round trips are bitwise, and each
   local shape is ``NamedSharding(mesh, spec).shard_shape`` of the
   reference's spec on the same mesh shape, except the MoE stacks, which
   follow the reference's ff compute layout;
2. qwen3 rm training on (1, 2), (2, 2) and (1, 4) (its 2 kv heads on 4
   model ranks: each rank keeps the kv head its query heads read), hubert
   rm and deepseek rm on (1, 2), 4 steps from the reference's state (a
   step-0 checkpoint each mesh's Trainer restores onto its mesh): each
   step's loss and ``grad_norm`` within 1e-5 relative of the reference's
   mesh run, and for qwen3 every gathered leaf of the final params and
   AdamW moments within 1e-5 relative 2-norm of the port's ``mesh=None``
   run;
3. forward logits on (1, 2) within 1e-4 relative of the reference's for
   qwen3 rm fused, tensor_sketch two-launch and exact, hubert rm (B3 + B4)
   and deepseek rm (MLA + MoE);
4. mixtral on (2, 2): at the default capacity the logits and aux losses
   (and one layer's ``apply_moe(mesh=)``) within 1e-5 of the reference's
   mesh run, a case that differs from ``mesh=None`` by more than that; at
   capacity 8.0 equal to ``mesh=None``'s within 1e-5;
5. a checkpoint saved at model 2 restores bitwise at model 1 and at data
   2, and at model 2 into the shards trained;
6. Mamba and xLSTM take a model axis of 2 (``local_config`` halves their
   heads and inner widths: ``tests/test_torch_ssm_tensor_parallel.py`` and
   ``test_torch_xlstm_tensor_parallel.py`` hold them); a part whose width
   the model axis divides in neither direction is kept whole
   (``tests/test_torch_whole_parts.py`` holds it against the reference).

Each multi-rank run is one spawn (2 ranks, then 4) over a ``FileStore`` in
``tmp_path``, with a timeout a spawn.
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

STEPS = 4
LOSS_TOL = 1e-5        # relative, a step's loss and grad_norm
STATE_TOL = 1e-5       # relative 2-norm of a gathered leaf's gap
LOGIT_TOL = 1e-4       # relative to max(1, max |reference|)
MOE_TOL = 1e-5         # absolute, mixtral's logits and aux losses
SPAWN_TIMEOUT = 150
ORACLE_TIMEOUT = 240
FORWARD = ("qwen3_rm", "qwen3_ts", "qwen3_exact", "hubert_rm",
           "deepseek_rm")
TRAIN = (("qwen3_rm", (1, 2)), ("qwen3_rm", (2, 2)), ("qwen3_rm", (1, 4)),
         ("hubert_rm", (1, 2)), ("deepseek_rm", (1, 2)))

ORACLE = r'''
import dataclasses, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.data.synthetic import SyntheticLMDataset
from repro.distributed.sharding import (batch_partition_specs,
    logical_rules_context, params_partition_specs)
from repro.launch.mesh import make_mesh
from repro.models import moe as jmoe, transformer as jt
from repro.train import steps as jsteps

out = sys.argv[1]
assert len(jax.devices()) == 8
MODELS = {
    "qwen3_rm": ("qwen3-1.7b", "rm", None),
    "qwen3_ts": ("qwen3-1.7b", "rm", "tensor_sketch"),
    "qwen3_exact": ("qwen3-1.7b", "exact", None),
    "hubert_rm": ("hubert-xlarge", "rm", None),
    "deepseek_rm": ("deepseek-v2-lite-16b", "rm", None),
    "mixtral": ("mixtral-8x7b", "exact", None),
}


def config(name, **moe):
    arch, mode, est = MODELS[name]
    cfg = get_config(arch, smoke=True, attention_mode=mode, estimator=est)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if mode == "rm" and est is None:      # the fused jnp formulation
        cfg = dataclasses.replace(cfg, rm=dataclasses.replace(
            cfg.rm, fuse_featurize="on"))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shardings(mesh, specs):
    return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda s: isinstance(s, P))


def batch(name, b, t, seed):
    cfg = config(name)
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.frontend == "audio_stub":
        out["embeds"] = rng.standard_normal((b, t, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(
            np.int32)
    return out


# no weight decay: the reference decays its layer-stacked 1-D leaves (norm
# scales), which the port does not (ROADMAP.md, faults of the reference)
hyper = jsteps.TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=4,
                          adamw=jsteps.AdamWConfig(weight_decay=0.0))
init = jax.jit(jt.init_model, static_argnums=0)
handed = {"params": {}, "states": {}, "batches": {}, "specs": {}}
for name in MODELS:
    cfg = config(name)
    handed["params"][name] = host(init(cfg, jax.random.PRNGKey(0)))
for name in ("qwen3_rm", "hubert_rm", "deepseek_rm"):
    cfg = config(name)
    handed["states"][name] = host(jax.jit(
        lambda k, cfg=cfg: jsteps.init_train_state(cfg, k, hyper))(
            jax.random.PRNGKey(0)))
handed["batches"]["hubert_train"] = [batch("hubert_rm", 4, 32, 10 + i)
                                     for i in range(4)]
for name in MODELS:
    handed["batches"][name] = batch(name, 4 if name == "mixtral" else 2,
                                    24, 1)
handed["moe_x"] = np.random.default_rng(3).standard_normal(
    (4, 8, 64)).astype(np.float32)
for name in ("qwen3_rm", "deepseek_rm", "mixtral", "hubert_rm"):
    mesh = make_mesh((1, 2), ("data", "model"))
    handed["specs"][name] = jax.tree_util.tree_map(
        lambda s, a, mesh=mesh: tuple(NamedSharding(mesh, s).shard_shape(
            a.shape)),
        params_partition_specs(handed["params"][name], mesh),
        handed["params"][name], is_leaf=lambda s: isinstance(s, P))
with open(os.path.join(out, "handed.tmp"), "wb") as f:
    pickle.dump(handed, f)
os.replace(os.path.join(out, "handed.tmp"), os.path.join(out, "handed.pkl"))

ref = {"train": {}, "forward": {}, "moe": {}}
for name, shape in TRAIN:
    cfg = config(name)
    mesh = make_mesh(shape, ("data", "model"))
    if name == "hubert_rm":
        batches = handed["batches"]["hubert_train"]
    else:
        data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4)
        batches = [data.batch_at(i) for i in range(4)]
    with logical_rules_context(mesh) as rules:
        state = handed["states"][name]
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
    ref["train"][f"{name}{shape}"] = rows


def mesh_forward(name, shape, params, b, cfg=None):
    cfg = cfg or config(name)
    mesh = make_mesh(shape, ("data", "model"))
    with logical_rules_context(mesh) as rules:
        pshard = shardings(mesh, params_partition_specs(params, mesh,
                                                        rules))
        fwd = jax.jit(lambda p, x: jt.forward(p, cfg, x))
        logits, aux = fwd(jax.device_put(params, pshard),
                          {k: v for k, v in b.items() if k != "targets"})
    return np.asarray(logits), {k: float(v) for k, v in aux.items()}


for name in FORWARD:
    ref["forward"][name] = mesh_forward(name, (1, 2),
                                        handed["params"][name],
                                        handed["batches"][name])[0]
mp = handed["params"]["mixtral"]
for label, moe in (("default", {}), ("lifted", {"capacity_factor": 8.0})):
    ref["moe"][label] = mesh_forward("mixtral", (2, 2), mp,
                                     handed["batches"]["mixtral"],
                                     config("mixtral", **moe))
layer = jax.tree_util.tree_map(lambda a: a[0],
                               mp["groups"]["b0_attn_moe"]["moe"])
mesh = make_mesh((2, 2), ("data", "model"))
with logical_rules_context(mesh):
    y, aux = jax.jit(lambda p, x: jmoe.apply_moe(p, config("mixtral"), x))(
        layer, jnp.asarray(handed["moe_x"]))
ref["moe"]["layer"] = (np.asarray(y), {k: float(v) for k, v in aux.items()})
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(ref, f)
'''.replace("FORWARD", repr(FORWARD)).replace("TRAIN", repr(TRAIN))


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------
def _configs(name, **moe):
    """The port's config of an oracle model (fp32 compute; rm fused where
    the reference runs its fused formulation)."""
    import dataclasses

    from repro_torch.configs import get_config

    arch, mode, est = {
        "qwen3_rm": ("qwen3-1.7b", "rm", None),
        "qwen3_ts": ("qwen3-1.7b", "rm", "tensor_sketch"),
        "qwen3_exact": ("qwen3-1.7b", "exact", None),
        "hubert_rm": ("hubert-xlarge", "rm", None),
        "deepseek_rm": ("deepseek-v2-lite-16b", "rm", None),
        "mixtral": ("mixtral-8x7b", "exact", None),
    }[name]
    cfg = get_config(arch, smoke=True, attention_mode=mode, estimator=est)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


class _Batches:
    """``batch_at(step)`` over fixed numpy batches (the hubert frames)."""

    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return {k: torch.from_numpy(v).long() if k == "targets"
                else torch.from_numpy(v) for k, v in
                self.batches[step].items()}


def _dataset(name, handed):
    from repro_torch.data.synthetic import SyntheticLMDataset

    if name == "hubert_rm":
        return _Batches(handed["batches"]["hubert_train"])
    return SyntheticLMDataset(vocab_size=_configs(name).vocab_size,
                              seq_len=32, global_batch=4, device="cpu")


def _hyper():
    """The oracle's: no weight decay, since the reference decays its
    layer-stacked 1-D leaves (the norm scales) and the port does not
    (ROADMAP.md, faults of the reference); that alone moves ``grad_norm``
    by 6e-5 relative by the fourth step."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainHyper

    return TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS,
                      adamw=AdamWConfig(weight_decay=0.0))


def _batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _ckpt_dir(out, name, shape):
    return out / f"ckpt_{name}{shape}"


def _train(rank, name, shape, out):
    """Train ``name`` on a ``shape`` mesh from the reference's state (the
    step-0 checkpoint the fixture wrote, restored onto the mesh); write the
    metrics and, on rank 0, the gathered final state."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    cfg = _configs(name)
    mesh = make_mesh(shape, ("data", "model"))
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    ckpt = _ckpt_dir(out, name, shape)
    trainer = Trainer(cfg, _hyper(), _dataset(name, handed), mesh=mesh,
                      ckpt_dir=str(ckpt), log_every=1,
                      checkpoint_every=10 ** 9, device="cpu")
    state = trainer.train(STEPS, trainer.init_or_restore())
    full = tp.gather_state(state, mesh,
                           CheckpointManager(ckpt).shapes()["params"])
    tag = f"{name}{shape}"
    if rank == 0:
        torch.save(flatten_dict(full), out / f"state_{tag}.pt")
        (out / f"train_{tag}.json").write_text(json.dumps(
            [(r["loss"], r["grad_norm"]) for r in trainer.metrics_log]))
    return mesh, state


def _forward(rank, name, shape, params, batch, out, cfg=None):
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tt

    cfg = cfg or _configs(name)
    mesh = make_mesh(shape, ("data", "model"))
    local = tp.shard_params(params_from_jax(params, cfg), mesh, cfg)
    lcfg = tp.local_config(cfg, tp.model_size_of(mesh))
    index, parts = tp.batch_index(mesh)
    b = _batch({k: v for k, v in batch.items() if k != "targets"})
    rows = next(iter(b.values())).shape[0] // parts
    b = {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}
    with tp.local_view(mesh):
        logits, aux = tt.forward(local, lcfg, b)
        logits = tp.gather_vocab(logits, lcfg)
    return logits, {k: float(v) for k, v in aux.items()}, index, rows


def _worker2(rank, world, store, out):
    """The 2-rank runs: shard round trips and shapes, the (1, 2) training
    runs (qwen3's with a checkpoint), its restores, the forwards, the SSM
    and the parts kept whole where a width is indivisible."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = Path(out)
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    from repro_torch.common.tree import flatten_dict
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh

    report = {"shapes": {}, "round_trip": {}}
    mesh = make_mesh((1, 2), ("data", "model"))
    for name in ("qwen3_rm", "deepseek_rm", "mixtral", "hubert_rm"):
        cfg = _configs(name)
        full = params_from_jax(handed["params"][name], cfg)
        local = tp.shard_params(full, mesh, cfg)
        back = tp.gather_params(local, mesh, tp.meta_template(full))
        a, b = flatten_dict(full), flatten_dict(back)
        report["round_trip"][name] = set(a) == set(b) and all(
            torch.equal(a[k], b[k]) for k in a)
        report["shapes"][name] = {k: list(v.shape) for k, v in
                                  flatten_dict(local).items()}
    from repro_torch.train.steps import init_params

    cfg = _configs("deepseek_rm")
    local, template = tp.init_local_params(cfg, 0, mesh, "cpu")
    full = init_params(cfg, 0, "cpu")
    a = flatten_dict(local)
    b = flatten_dict(tp.shard_params(full, mesh, cfg))
    t = flatten_dict(template)
    report["init_local"] = set(a) == set(b) == set(t) and all(
        torch.equal(a[k], b[k]) and t[k].device.type == "meta"
        and t[k].shape == v.shape and t[k].dtype == v.dtype
        for k, v in flatten_dict(full).items())
    for name, shape in TRAIN:
        if shape == (1, 2):
            m, state = _train(rank, name, shape, out)
            if name == "qwen3_rm":
                ckpt = CheckpointManager(_ckpt_dir(out, name, shape))
                trained = flatten_dict(state)
                _, restored = elastic_remesh(ckpt, lambda: m,
                                             cfg=_configs(name))
                got = flatten_dict(restored)
                report["restore_model2"] = set(got) == set(trained) and all(
                    torch.equal(got[k], trained[k]) for k in trained)
                mesh_d2, restored = elastic_remesh(
                    ckpt, lambda: make_mesh((2, 1), ("data", "model")))
                if rank == 0:
                    torch.save(flatten_dict(restored), out / "restore_d2.pt")
    for name in FORWARD:
        logits, _, _, _ = _forward(rank, name, (1, 2),
                                   handed["params"][name],
                                   handed["batches"][name], out)
        if rank == 0:
            torch.save(logits, out / f"fwd_{name}.pt")
    refusals = {}
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        lcfg = tp.local_config(get_config(arch, smoke=True), 2)
        refusals[arch] = [lcfg.num_heads, tp.shards_of(lcfg)]
        lcfg = tp.local_config(get_config(arch, smoke=True), 8)
        refusals[f"{arch}/8"] = [list(lcfg.whole), lcfg.num_heads]
    import dataclasses

    odd = dataclasses.replace(_configs("qwen3_rm"), num_heads=6,
                              num_kv_heads=3)
    for label, m_size in (("heads", 4), ("kv", 2)):
        lcfg = tp.local_config(odd, m_size)
        refusals[label] = [list(lcfg.whole), lcfg.num_heads,
                           lcfg.num_kv_heads]
    report["refusals"] = refusals
    if rank == 0:
        (out / "report2.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def _worker4(rank, world, store, out):
    """The 4-rank runs: qwen3 training on (2, 2) and (1, 4); mixtral's MoE
    on (2, 2) at the default and a lifted capacity, and one layer's
    ``apply_moe(mesh=)``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = Path(out)
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe

    for name, shape in TRAIN:
        if shape[0] * shape[1] == world:
            _train(rank, name, shape, out)
    res = {}
    for label, moe in (("default", {}), ("lifted", {"capacity_factor": 8.0})):
        cfg = _configs("mixtral", **moe)
        logits, aux, index, rows = _forward(
            rank, "mixtral", (2, 2), handed["params"]["mixtral"],
            handed["batches"]["mixtral"], out, cfg)
        res[label] = (logits, aux, index, rows)
    cfg = _configs("mixtral")
    mesh = make_mesh((2, 2), ("data", "model"))
    full = params_from_jax(handed["params"]["mixtral"], cfg)
    local = tp.shard_params(full, mesh, cfg)["layers"][0]["moe"]
    y, aux = tmoe.apply_moe(local, cfg, torch.from_numpy(handed["moe_x"]),
                            mesh=mesh)
    res["layer"] = (y, {k: float(v) for k, v in aux.items()})
    torch.save(res, out / f"moe{rank}.pt")
    dist.destroy_process_group()


def spawn(fn, world, tmp_path):
    """Run ``fn(rank, world, store_path, out)`` in ``world`` spawned
    processes; fail on a non-zero exit or past ``SPAWN_TIMEOUT``."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"store{world}")
    procs = [ctx.Process(target=fn, args=(r, world, store, str(tmp_path)))
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


def start_oracle(script: str, out: Path) -> subprocess.Popen:
    """The reference's script in a subprocess with 8 forced host devices."""
    path = out / "oracle.py"
    path.write_text(script)
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


def finish(proc: subprocess.Popen):
    try:
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.decode()[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The oracle and the port's two spawns, overlapped: the spawns start
    once the oracle has written the weights."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.train.checkpoint import CheckpointManager

    out = tmp_path_factory.mktemp("tp")
    proc = start_oracle(ORACLE, out)
    wait_for(proc, out / "handed.pkl")
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    for name, shape in TRAIN:
        # the reference's state as a step-0 checkpoint: each mesh run
        # restores it onto its mesh, and saves its final state beside it
        CheckpointManager(_ckpt_dir(out, name, shape)).save(
            0, train_state_from_jax(handed["states"][name], _configs(name)))
    spawn(_worker2, 2, out)
    spawn(_worker4, 4, out)
    finish(proc)
    return {"out": out, "handed": handed,
            "ref": pickle.loads((out / "ref.pkl").read_bytes()),
            "report": json.loads((out / "report2.json").read_text())}


@pytest.fixture(scope="module")
def single_qwen3(runs):
    """qwen3 rm trained 4 steps with ``mesh=None`` from the reference's
    state: its flattened final state."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import train_state_from_jax
    from repro_torch.train.trainer import Trainer

    cfg = _configs("qwen3_rm")
    trainer = Trainer(cfg, _hyper(), _dataset("qwen3_rm", runs["handed"]),
                      log_every=1, device="cpu")
    state = trainer.train(STEPS, train_state_from_jax(
        runs["handed"]["states"]["qwen3_rm"], cfg))
    return flatten_dict(state)


def _rel(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)]


# ---------------------------------------------------------------------------
# 1. the cut
# ---------------------------------------------------------------------------
_MOE_FF_DIM = {"w_gate": 2, "w_up": 2, "w_down": 1, "shared_gate": 1,
               "shared_up": 1, "shared_down": 0}


@pytest.mark.parametrize("name", ["qwen3_rm", "deepseek_rm", "mixtral",
                                  "hubert_rm"])
def test_shard_round_trip_and_shapes_follow_the_reference(runs, name):
    """Bitwise round trip; every local shape is the reference's
    ``shard_shape`` on (1, 2), the MoE's experts excepted: their stacks
    and the shared experts are cut along their ff dim, the layout the
    reference computes them in (``P(None, None, "model")``, ``P(None,
    "model")``), where its stacked specs put the expert or the layer dim
    on ``"model"``."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, specs_from_jax

    cfg = _configs(name)
    assert runs["report"]["round_trip"][name]
    # the streamed draw (a block cut as soon as it is drawn) is the cut of
    # the full draw
    assert runs["report"]["init_local"]
    got = runs["report"]["shapes"][name]
    want = flatten_dict(specs_from_jax(runs["handed"]["specs"][name], cfg))
    full = {k: list(v.shape) for k, v in flatten_dict(params_from_jax(
        runs["handed"]["params"][name], cfg)).items()}
    assert set(got) == set(want) == set(full)
    ff_cut = 0
    for k, shape in got.items():
        leaf = k.rsplit("/", 1)[1]
        if "/moe/" in k and leaf in _MOE_FF_DIM:
            expect = list(full[k])
            expect[_MOE_FF_DIM[leaf]] //= 2
            assert shape == expect, k
            ff_cut += 1
            continue
        assert shape == list(want[k]), k
    assert (ff_cut > 0) == (cfg.moe is not None)


# ---------------------------------------------------------------------------
# 2. training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,shape", TRAIN,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in TRAIN])
def test_training_matches_the_reference_mesh_run(runs, name, shape, capsys):
    """Every step's loss and ``grad_norm`` (the global norm the clip uses:
    a rank-local norm, or a gradient summed twice, moves it where the
    clip hides it from the losses) within 1e-5 relative of the
    reference's run on the same mesh shape."""
    tag = f"{name}{shape}"
    got = json.loads((runs["out"] / f"train_{tag}.json").read_text())
    want = runs["ref"]["train"][tag]
    loss_gap = _rel([g[0] for g in got], [w[0] for w in want])
    norm_gap = _rel([g[1] for g in got], [w[1] for w in want])
    with capsys.disabled():
        print(f"\n[tp] {tag}: loss gaps "
              + " ".join(f"{v:.1e}" for v in loss_gap) + "; grad_norm gaps "
              + " ".join(f"{v:.1e}" for v in norm_gap))
    assert max(loss_gap) <= LOSS_TOL
    assert max(norm_gap) <= LOSS_TOL


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
def test_training_state_matches_one_device(runs, single_qwen3, shape):
    """Every gathered leaf of qwen3's final params and AdamW moments
    within 1e-5 relative 2-norm of the port's ``mesh=None`` run."""
    got = torch.load(runs["out"] / f"state_qwen3_rm{shape}.pt")
    assert set(got) == set(single_qwen3)
    for k, v in single_qwen3.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), k
            continue
        gap = (got[k].double() - v.double()).norm() / v.double().norm() \
            .clamp_min(1e-30)
        assert float(gap) <= STATE_TOL, k


# ---------------------------------------------------------------------------
# 3. forward logits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FORWARD)
def test_forward_logits_match_the_reference_mesh_run(runs, name):
    got = torch.load(runs["out"] / f"fwd_{name}.pt").numpy()
    want = runs["ref"]["forward"][name]
    assert got.shape == want.shape
    gap = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert gap <= LOGIT_TOL, gap


# ---------------------------------------------------------------------------
# 4. the MoE over the mesh
# ---------------------------------------------------------------------------
def _moe_rows(runs, label):
    """The ranks' logits joined by rows (the two data ranks' halves; the
    model ranks agree) and rank 0's aux."""
    parts = [torch.load(runs["out"] / f"moe{r}.pt")[label] for r in range(4)]
    by_index = {}
    for logits, aux, index, _ in parts:
        if index in by_index:
            assert torch.equal(by_index[index][0], logits)
        by_index[index] = (logits, aux)
    logits = torch.cat([by_index[i][0] for i in sorted(by_index)]).numpy()
    return logits, parts[0][1]


def _single_mixtral(runs, **moe):
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer as tt

    cfg = _configs("mixtral", **moe)
    b = _batch({k: v for k, v in runs["handed"]["batches"]["mixtral"].items()
                if k != "targets"})
    logits, aux = tt.forward(params_from_jax(
        runs["handed"]["params"]["mixtral"], cfg), cfg, b)
    return logits.detach().numpy(), {k: float(v) for k, v in aux.items()}


def test_moe_per_shard_capacity_matches_the_reference(runs, capsys):
    """At the default capacity each data shard drops its own overflow: the
    port's (2, 2) logits and aux losses are within 1e-5 of the
    reference's mesh run, and that run is more than 1e-5 from
    ``mesh=None``'s, so the per-shard capacity is what is held."""
    got, aux = _moe_rows(runs, "default")
    want, want_aux = runs["ref"]["moe"]["default"]
    single, single_aux = _single_mixtral(runs)
    gap = np.abs(got - want).max()
    apart = np.abs(single - want).max()
    with capsys.disabled():
        print(f"\n[tp] mixtral (2, 2): {gap:.2e} from the reference's mesh "
              f"run, which is {apart:.2e} from mesh=None's")
    assert gap <= MOE_TOL
    assert apart > MOE_TOL
    for k in want_aux:
        assert abs(aux[k] - want_aux[k]) <= MOE_TOL, k


def test_apply_moe_mesh_matches_the_reference(runs):
    """One layer's ``apply_moe(mesh=)`` on the whole batch (4 rows split
    over the 2 data ranks): every rank's ``y`` and aux within 1e-5 of the
    reference's ``apply_moe`` under its (2, 2) rules context."""
    want, want_aux = runs["ref"]["moe"]["layer"]
    for r in range(4):
        y, aux = torch.load(runs["out"] / f"moe{r}.pt")["layer"]
        assert np.abs(y.numpy() - want).max() <= MOE_TOL
        for k in want_aux:
            assert abs(aux[k] - want_aux[k]) <= MOE_TOL, k


def test_moe_lifted_capacity_equals_one_device(runs):
    got, aux = _moe_rows(runs, "lifted")
    single, single_aux = _single_mixtral(runs, capacity_factor=8.0)
    want, _ = runs["ref"]["moe"]["lifted"]
    assert np.abs(got - single).max() <= MOE_TOL
    assert np.abs(got - want).max() <= MOE_TOL
    for k in single_aux:
        assert abs(aux[k] - single_aux[k]) <= MOE_TOL, k


# ---------------------------------------------------------------------------
# 5. checkpoints move between model sizes
# ---------------------------------------------------------------------------
def test_checkpoint_at_model_two_restores_anywhere(runs):
    """Saved at model 2 (rank 0 wrote the gathered state beside the
    step-0 state it started from): bitwise the gathered final state at
    model 1 (one device), at data 2 (each rank the whole state) and, at
    model 2, the shards the ranks trained."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.train.checkpoint import CheckpointManager

    out = runs["out"]
    gathered = torch.load(out / "state_qwen3_rm(1, 2).pt")
    ckpt = CheckpointManager(_ckpt_dir(out, "qwen3_rm", (1, 2)))
    assert ckpt.available_steps() == [0, STEPS]
    one = flatten_dict(ckpt.restore(device="cpu"))
    d2 = torch.load(out / "restore_d2.pt")
    for got in (one, d2):
        assert set(got) == set(gathered)
        assert all(got[k].dtype == v.dtype and torch.equal(got[k], v)
                   for k, v in gathered.items())
    assert runs["report"]["restore_model2"]


# ---------------------------------------------------------------------------
# 6. parts kept whole
# ---------------------------------------------------------------------------
def test_ssm_mixers_and_indivisible_widths_raise(runs):
    ref = runs["report"]["refusals"]
    """Where the model axis divides a width in neither direction the part
    is kept whole at its full widths (the reference's dedupe replicates
    such a dim): 4 heads on 8 ranks (jamba's attention, xlstm's mixers), 6
    heads on 4, 6 heads over 3 kv heads on 2."""
    for arch in ("jamba-v0.1-52b", "xlstm-350m"):
        assert ref[arch] == [2, 2], arch            # 4 heads, 2 ranks
    assert ref["jamba-v0.1-52b/8"] == [["attn"], 4]
    assert ref["xlstm-350m/8"] == [["mlstm", "slstm"], 4]
    assert ref["heads"] == [["attn"], 6, 3]
    assert ref["kv"] == [["attn"], 6, 3]
