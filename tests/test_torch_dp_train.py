"""Data-parallel training of the port (``train.trainer.Trainer(mesh=)``,
``train.steps`` with ``grad_compression="int8_pod"``,
``train.fault.elastic_remesh``, ``launch.mesh``) on gloo process groups on
the CPU, held against the port's own single-device Trainer (the
reference's multi-device tests fail in this sandbox's run, so they are no
oracle here; the reference's DP/TP check allows 1e-3).

qwen3-1.7b SMOKE, fp32 compute, 4 steps of 4 x 32 tokens:

* 2 ranks on a ``("data", "model")`` (2, 1) mesh, each training on its 2
  rows (FSDP by default: the states compared are the gathered ones,
  ``Trainer.full_state``): every step's loss within 1e-4 relative of ``mesh=None``'s (the
  gaps measured are 0 to 8e-8), every step's ``grad_norm`` within 1e-6
  (measured: 0) and every leaf of the final params and AdamW moments
  within 1e-5 in relative 2-norm (measured: at most 6.5e-7), the loss
  falls, both ranks hold bitwise equal states, and rank 0 alone wrote the
  checkpoint;
* ``int8_pod`` on a ``("pod", "data", "model")`` (2, 1, 1) mesh: it runs,
  its loss falls, residuals are carried;
* a model axis that divides the kv heads in neither direction (qwen3
  SMOKE with 6 heads and 3 kv heads on a ``"model"`` axis of 2) and
  ``make_production_mesh`` on 2 ranks raise;
* ``elastic_remesh`` from those 2 ranks onto 1: the checkpoint restores
  bitwise rank 0's final state.

Each multi-rank run is one spawn over a ``FileStore`` (no TCP port) with
its own timeout.
"""
import json
import multiprocessing
import time

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

STEPS, BATCH, SEQ = 4, 4, 32
LOSS_TOL = 1e-4        # relative: a mean of rank means vs one mean
GRAD_NORM_TOL = 1e-6   # relative, per step (measured: 0)
STATE_TOL = 1e-5       # relative 2-norm of a leaf's gap (measured: 6.5e-7)
SPAWN_TIMEOUT = 120


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store_path, *args)`` in ``world`` spawned
    processes; fail on a non-zero exit or past ``SPAWN_TIMEOUT``."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"store{world}")
    procs = [ctx.Process(target=fn, args=(r, world, store, *args))
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


def _setup(compression="none"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.train.steps import TrainHyper

    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=SEQ,
                              global_batch=BATCH, device="cpu")
    hyper = TrainHyper(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS,
                       grad_compression=compression)
    return cfg, data, hyper


def _losses(trainer):
    return [row["loss"] for row in trainer.metrics_log]


def _grad_norms(trainer):
    return [row["grad_norm"] for row in trainer.metrics_log]


def _dp_worker(rank, world, store, out):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.common.tree import flatten_dict
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import (
        make_host_mesh,
        make_mesh,
        make_production_mesh,
    )
    from repro_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    report = {}
    cfg, data, hyper = _setup()
    trainer = Trainer(cfg, hyper, data, ckpt_dir=str(out / "ckpt"),
                      mesh=make_host_mesh(), log_every=1,
                      checkpoint_every=10 ** 9, device="cpu")
    state = trainer.train(STEPS)
    report["losses"] = _losses(trainer)
    report["grad_norms"] = _grad_norms(trainer)
    torch.save(flatten_dict(trainer.full_state(state)),
               out / f"state{rank}.pt")
    cfg, data, hyper8 = _setup("int8_pod")
    pod = make_mesh((world, 1, 1), ("pod", "data", "model"))
    trainer = Trainer(cfg, hyper8, data, mesh=pod, log_every=1, device="cpu")
    state = trainer.train(STEPS)
    report["int8_losses"] = _losses(trainer)
    report["residual_max"] = max(
        float(v.abs().max()) for v in flatten_dict(state["residuals"])
        .values())
    odd = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              num_heads=6, num_kv_heads=3)
    for label, build in (
            ("model_axis", lambda: Trainer(
                odd, hyper, data,
                mesh=make_mesh((1, world), ("data", "model")),
                device="cpu")),
            ("production", make_production_mesh)):
        try:
            build()
            report[label] = "no error"
        except (ValueError, RuntimeError) as e:
            report[label] = f"{type(e).__name__}: {e}"
    (out / f"dp{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def _remesh_worker(rank, world, store, out):
    import torch.distributed as dist

    from repro_torch.common.tree import flatten_dict
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault import elastic_remesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh, state = elastic_remesh(CheckpointManager(out / "ckpt"),
                                 make_host_mesh)
    want = torch.load(out / "state0.pt")
    got = flatten_dict(state)
    same = set(got) == set(want) and all(
        got[k].dtype == v.dtype and torch.equal(got[k], v)
        for k, v in want.items())
    (out / "remesh.json").write_text(json.dumps(
        {"same": same, "mesh": list(mesh.shape), "step": int(state["step"])}))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The 2-rank runs, then the remesh onto 1 rank; the reports."""
    out = tmp_path_factory.mktemp("dp")
    spawn(_dp_worker, 2, out, out)
    spawn(_remesh_worker, 1, out, out)
    reports = [json.loads((out / f"dp{r}.json").read_text())
               for r in range(2)]
    return out, reports, json.loads((out / "remesh.json").read_text())


@pytest.fixture(scope="module")
def single_run():
    """The same 4 steps on one device (``mesh=None``): its trainer and
    flattened final state."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.train.trainer import Trainer

    cfg, data, hyper = _setup()
    single = Trainer(cfg, hyper, data, log_every=1, device="cpu")
    state = single.train(STEPS)
    return single, flatten_dict(state)


def _rel_gaps(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)]


def test_data_parallel_losses_match_one_device(dp_run, single_run, capsys):
    _, reports, _ = dp_run
    want = _losses(single_run[0])
    assert reports[0]["losses"] == reports[1]["losses"]
    gaps = _rel_gaps(reports[0]["losses"], want)
    with capsys.disabled():
        print(f"\n[dp] 2 gloo ranks vs one device, {STEPS} steps: loss gaps "
              + " ".join(f"{g:.2e}" for g in gaps))
    assert max(gaps) <= LOSS_TOL
    assert reports[0]["losses"][-1] < reports[0]["losses"][0]


def test_data_parallel_grads_and_state_match_one_device(dp_run, single_run,
                                                        capsys):
    """``grad_norm`` is taken from the averaged gradients, before the clip
    to 1.0: a summed instead of averaged (or wrongly weighted) gradient
    moves it, where the clip and AdamW's scale invariance would leave the
    losses alone. The final params and AdamW moments of a rank, leaf by
    leaf, against one device's."""
    out, reports, _ = dp_run
    single, want = single_run
    assert reports[0]["grad_norms"] == reports[1]["grad_norms"]
    norm_gaps = _rel_gaps(reports[0]["grad_norms"], _grad_norms(single))
    got = torch.load(out / "state0.pt")
    assert set(got) == set(want)
    state_gaps = {}
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), k
            continue
        diff = (got[k].double() - v.double()).norm()
        state_gaps[k] = float(diff / v.double().norm().clamp_min(1e-30))
    worst = max(state_gaps, key=state_gaps.get)
    with capsys.disabled():
        print(f"\n[dp] grad_norm gaps "
              + " ".join(f"{g:.2e}" for g in norm_gaps)
              + f"; worst state leaf {worst} {state_gaps[worst]:.2e}")
    assert max(norm_gaps) <= GRAD_NORM_TOL
    assert state_gaps[worst] <= STATE_TOL, worst


def test_data_parallel_ranks_hold_one_state(dp_run):
    out, _, _ = dp_run
    a, b = torch.load(out / "state0.pt"), torch.load(out / "state1.pt")
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    from repro_torch.train.checkpoint import CheckpointManager

    assert CheckpointManager(out / "ckpt").available_steps() == [STEPS]


def test_int8_pod_compression_trains(dp_run):
    _, reports, _ = dp_run
    for r in reports:
        assert r["int8_losses"][-1] < r["int8_losses"][0]
        assert 0.0 < r["residual_max"] < 1.0
    assert reports[0]["int8_losses"] == reports[1]["int8_losses"]


def test_model_axis_and_production_mesh_raise(dp_run):
    _, reports, _ = dp_run
    for r in reports:
        # 6 heads over 3 kv heads on a model axis of 2: the kv heads and
        # the axis divide in neither direction, so the attention is kept
        # whole (the reference's dedupe rule) and the Trainer builds
        assert r["model_axis"] == "no error"
        assert r["production"].startswith("RuntimeError")
        assert "256 ranks" in r["production"]


def test_elastic_remesh_two_ranks_to_one(dp_run):
    _, _, remesh = dp_run
    assert remesh == {"same": True, "mesh": [1, 1], "step": STEPS}
