"""The port's training slice on the CPU: the train step against the
reference's from one handed-over state, gradient accumulation, the
synthetic LM data bit for bit, checkpointing and fault tolerance (the
cases of ``tests/test_checkpoint_fault.py``; ``elastic_remesh`` onto a
mesh of one), the Trainer (the cases of ``tests/test_trainer_integration.py`` on a tiny rm
config), the launcher in-process, and the entry points' CUDA default."""
import contextlib
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLMDataset as JaxDataset
from repro.data.synthetic import byte_tokenize as jax_byte_tokenize
from repro.train import steps as jsteps
from repro_torch.common.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.synthetic import SyntheticLMDataset, byte_tokenize
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig, RMAttentionConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import (
    StragglerMonitor,
    elastic_remesh,
    run_with_restarts,
)
from repro_torch.train.steps import (
    TrainHyper,
    init_train_state,
    make_decode_step,
    make_train_step,
)
from repro_torch.train.trainer import Trainer

CPU = "cpu"
CFG = ModelConfig(name="itiny", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=128,
                  tie_embeddings=True, attention_mode="rm",
                  rm=RMAttentionConfig(num_features=64, n_max=6)).validate()


# -- one train step against the reference -----------------------------------
def test_train_step_matches_reference():
    """One ``make_train_step`` of both packages from the same state: the
    reference's state after one step (so the moments are not zero and the
    learning rate is past its warm-up), handed over by
    ``train_state_from_jax``. Metrics within 1e-4 relative. Params within
    1e-6 absolute: the gradients agree to 1e-7 of their scale and a step
    moves a param by lr (1e-3) times an Adam ratio of O(1), so 1e-6 leaves
    a factor 10 over the 1e-7 seen; the reference's decay of its stacked
    1-D leaves (tests/test_torch_optim.py) is added back first."""
    jcfg = jax_get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    jcfg = dataclasses.replace(
        jcfg, compute_dtype="float32",
        rm=dataclasses.replace(jcfg.rm, fuse_featurize="on"))
    tcfg = dataclasses.replace(
        get_config("qwen3-1.7b", smoke=True, attention_mode="rm"),
        compute_dtype="float32")
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jhyper, hyper = jsteps.TrainHyper(**kw), TrainHyper(**kw)
    jdata = JaxDataset(vocab_size=jcfg.vocab_size, seq_len=32,
                       global_batch=4)
    data = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=32,
                              global_batch=4, device=CPU)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jhyper))
    jstate, _ = jstep(jsteps.init_train_state(jcfg, jax.random.PRNGKey(0),
                                              jhyper), jdata.batch_at(0))
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 tcfg)
    old = {k: v.clone() for k, v in flatten_dict(state["params"]).items()}
    jstate, jm = jstep(jstate, jdata.batch_at(1))
    state, m = make_train_step(tcfg, hyper)(state, data.batch_at(1))
    assert set(m) == set(jm)
    for key in jm:
        want = float(jm[key])
        assert abs(float(m[key]) - want) <= 1e-4 * max(abs(want), 1e-30), key
    want = flatten_dict(train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg))
    lr, wd = float(jm["lr"]), hyper.adamw.weight_decay
    assert int(state["step"]) == 2 and int(state["opt"]["step"]) == 2
    for key, leaf in flatten_dict(state).items():
        w = want[key].double()
        if key.startswith("params/layers/") and leaf.ndim == 1:
            w = w + lr * wd * old[key[len("params/"):]].double()
        tol = 1e-6 if key.startswith("params/") else 1e-7
        assert (leaf.double() - w).abs().max() <= tol, key


def test_grad_accumulation_matches_one_batch():
    """grad_accum 2 gives the step of grad_accum 1 on the same batch
    (gradients and metrics are means): ce and grad_norm within 1e-5
    relative, params within 1e-5 after a step from moments a first step
    made."""
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    data = SyntheticLMDataset(vocab_size=128, seq_len=32, global_batch=4,
                              device=CPU)
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    out = []
    for accum in (1, 2):
        state = init_train_state(cfg, 0, TrainHyper(**kw), device=CPU)
        state, _ = make_train_step(cfg, TrainHyper(**kw))(
            state, data.batch_at(0))
        state, m = make_train_step(cfg, TrainHyper(grad_accum=accum, **kw))(
            state, data.batch_at(1))
        out.append((flatten_dict(state["params"]), m))
    (p1, m1), (p2, m2) = out
    for key in ("ce", "grad_norm", "loss"):
        assert abs(float(m1[key]) - float(m2[key])) <= 1e-5 * abs(
            float(m1[key]))
    assert float(m1["tokens"]) == 2 * float(m2["tokens"])   # per microbatch
    for key in p1:
        assert (p1[key] - p2[key]).abs().max() <= 1e-5, key
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, TrainHyper(grad_accum=3, **kw))(
            state, data.batch_at(2))


# -- data -------------------------------------------------------------------
@pytest.mark.parametrize("order,hosts", [(1, 1), (2, 1), (1, 2)])
def test_synthetic_batches_bitwise_reference(order, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=151936, seq_len=48, global_batch=4, seed=5,
                  order=order, num_hosts=hosts, host_index=host)
        jd, td = JaxDataset(**kw), SyntheticLMDataset(device=CPU, **kw)
        for step in (0, 3, 17):
            want, got = jd.batch_at(step), td.batch_at(step)
            for key in ("tokens", "targets"):
                assert got[key].dtype == torch.int64
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(),
                                              np.asarray(want[key]))
    text = "Random Maclaurin features, ünïcode"
    np.testing.assert_array_equal(byte_tokenize(text, 97).numpy(),
                                  jax_byte_tokenize(text, 97))


def test_dataset_host_sharding_partitions_batch():
    full = SyntheticLMDataset(vocab_size=64, seq_len=16, global_batch=4,
                              seed=7, device=CPU)
    parts = [SyntheticLMDataset(vocab_size=64, seq_len=16, global_batch=4,
                                seed=7, num_hosts=2, host_index=i,
                                device=CPU) for i in range(2)]
    b0, b1 = parts[0].batch_at(3), parts[1].batch_at(3)
    assert b0["tokens"].shape == b1["tokens"].shape == (2, 16)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(b0["tokens"], parts[0].batch_at(3)["tokens"])
    assert torch.equal(full.batch_at(3)["tokens"],
                       full.batch_at(3)["tokens"])
    assert torch.equal(b0["targets"][:, :-1], b0["tokens"][:, 1:])
    with pytest.raises(ValueError, match="split"):
        SyntheticLMDataset(global_batch=3, num_hosts=2, device=CPU)


# -- checkpoint and fault tolerance (tests/test_checkpoint_fault.py) ---------
def _state(v=0.0):
    return {"params": {"w": torch.full((4, 8), v), "b": torch.zeros(8),
                       "layers": [{"s": torch.full((3,), v)}]},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(10, _state(1.0))
    out = mgr.restore(device=CPU)
    assert torch.equal(out["params"]["w"], torch.full((4, 8), 1.0))
    assert torch.equal(out["params"]["layers"][0]["s"], torch.ones(3))
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 1
    assert (tmp_path / "step_0000000010" / "meta.json").exists()


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.available_steps() == [3, 4]


def test_checkpoint_structure_mismatch_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state())
    bad = {"params": {"w": torch.zeros(4, 8)}, "extra": torch.zeros(())}
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(template=bad, device=CPU)
    mgr.restore(template=_state(), device=CPU)


def test_checkpoint_atomic_publish(tmp_path):
    """A leftover tmp dir never shadows a valid checkpoint."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _state(5.0))
    (tmp_path / "tmp.6.999").mkdir()          # a crashed partial write
    assert mgr.latest_step() == 5
    assert int(mgr.restore(device=CPU)["step"]) == 5


def test_checkpoint_restores_a_train_state_bitwise(tmp_path):
    """Every leaf of a train state (fp32 masters, moments, int32 steps, a
    bf16 leaf) comes back bitwise, and an empty checkpoint dir raises."""
    state = init_train_state(CFG, seed=3, device=CPU)
    state["params"]["extra_bf16"] = torch.randn(5, 3).bfloat16()
    mgr = CheckpointManager(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        mgr.restore(device=CPU)
    mgr.save(7, state)
    back = mgr.restore(template=state, device=CPU)
    flat, got = flatten_dict(state), flatten_dict(back)
    assert set(flat) == set(got)
    for key, leaf in flat.items():
        assert got[key].dtype == leaf.dtype and torch.equal(got[key], leaf)


def test_run_with_restarts_recovers(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    crashed = {"count": 0}

    def step_fn(state, step):
        if step == 7 and crashed["count"] == 0:
            crashed["count"] += 1
            raise RuntimeError("simulated node failure")
        return {**state, "step": torch.tensor(step + 1, dtype=torch.int32)}

    final = run_with_restarts(step_fn, _state(), num_steps=12,
                              ckpt_manager=mgr, checkpoint_every=5,
                              max_restarts=2, device=CPU)
    assert crashed["count"] == 1
    assert int(final["step"]) == 12


def test_run_with_restarts_gives_up(tmp_path):
    mgr = CheckpointManager(tmp_path)

    def always_fail(state, step):
        raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="persistent"):
        run_with_restarts(always_fail, _state(), 5, mgr, max_restarts=2,
                          device=CPU)


def test_straggler_monitor():
    seen = []
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2,
                           on_straggler=lambda *a: seen.append(a))
    flags = [mon.record(i, 0.1) for i in range(8)]
    assert not any(flags)
    assert mon.record(8, 0.5)          # 5x the mean -> flagged
    assert len(mon.events) == 1 and mon.events[0]["step"] == 8
    assert seen and seen[0][0] == 8


@contextlib.contextmanager
def _world_of_one(tmp_path):
    """A gloo default process group of one rank in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_remesh_restores_onto_a_mesh(tmp_path):
    """A checkpoint restored onto a one-rank host mesh, bitwise; the
    shardings function may name the device. (From 2 ranks to 1:
    tests/test_torch_dp_train.py.)"""
    from repro_torch.launch.mesh import make_host_mesh

    state = init_train_state(CFG, seed=2, device=CPU)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(5, state)
    with _world_of_one(tmp_path):
        for shardings in (None, lambda mesh: torch.device(CPU)):
            mesh, back = elastic_remesh(mgr, make_host_mesh, shardings)
            assert tuple(mesh.mesh_dim_names) == ("data", "model")
            a, b = flatten_dict(state), flatten_dict(back)
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_init_local_params_refuses_a_draw_that_is_not_a_leaf(
        tmp_path, monkeypatch):
    """Each weight is cut as it is drawn, so an init that changes a draw
    before it becomes a leaf is refused, never drawn whole and cut."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention

    draw = attention.normal_init
    monkeypatch.setattr(attention, "normal_init",
                        lambda *a: draw(*a) * 1.0)
    with _world_of_one(tmp_path):
        with pytest.raises(ValueError, match="part 'layers'"):
            tp.init_local_params(CFG, 0, make_host_mesh(), CPU)


# -- the Trainer (tests/test_trainer_integration.py) -------------------------
def _mk_trainer(tmp=None, steps=24):
    data = SyntheticLMDataset(vocab_size=128, seq_len=64, global_batch=4,
                              num_contexts=64, device=CPU)
    hyper = TrainHyper(peak_lr=5e-3, warmup_steps=3, total_steps=steps)
    return Trainer(CFG, hyper, data, ckpt_dir=tmp, log_every=100,
                   checkpoint_every=10, device=CPU)


def test_loss_decreases(capsys):
    tr = _mk_trainer(steps=25)
    tr.train(25)
    first, last = tr.metrics_log[0]["ce"], tr.metrics_log[-1]["ce"]
    assert last < first - 0.2, (first, last)
    assert "[train] step=    0 loss=" in capsys.readouterr().out
    assert {"loss", "ce", "grad_norm", "lr", "sec_per_step"} <= set(
        tr.metrics_log[-1])


def test_checkpoint_resume_is_deterministic(tmp_path):
    state_a = _mk_trainer(str(tmp_path / "a"), steps=20).train(20)
    _mk_trainer(str(tmp_path / "b"), steps=20).train(10)    # then "crash"
    state_b = _mk_trainer(str(tmp_path / "b"), steps=20).train(20)
    wa = state_a["params"]["embed"]["embedding"]
    wb = state_b["params"]["embed"]["embedding"]
    np.testing.assert_allclose(wa.numpy(), wb.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert int(state_a["step"]) == int(state_b["step"]) == 20
    assert CheckpointManager(tmp_path / "b").available_steps() == [10, 20]


def test_trainer_on_a_mesh_of_one_equals_one_device(tmp_path):
    """``Trainer(mesh=make_host_mesh())`` on one gloo rank: every loss and
    the final state bitwise ``mesh=None``'s (the all-reduce of one rank
    and the token weight 1 change nothing). An xLSTM model on a "model"
    axis its heads do not divide keeps its mixers whole
    (``tensor_parallel.local_config``, the reference's dedupe rule), and
    an unknown axis is refused before any group is touched."""
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.mesh import make_host_mesh

    single = _mk_trainer(steps=3)
    state_a = single.train(3)
    with _world_of_one(tmp_path):
        data = SyntheticLMDataset(vocab_size=128, seq_len=64,
                                  global_batch=4, num_contexts=64,
                                  device=CPU)
        meshed = Trainer(CFG, TrainHyper(peak_lr=5e-3, warmup_steps=3,
                                         total_steps=3), data,
                         mesh=make_host_mesh(), log_every=100, device=CPU)
        state_b = meshed.train(3)
    assert [r["loss"] for r in meshed.metrics_log] == \
        [r["loss"] for r in single.metrics_log]
    a, b = flatten_dict(state_a), flatten_dict(state_b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    from repro_torch.distributed import tensor_parallel as tp

    lcfg = tp.local_config(get_config("xlstm-350m", smoke=True), 8)
    assert lcfg.whole == ("mlstm", "slstm") and lcfg.num_heads == 4
    assert tp.shards_of(lcfg, "mlstm") == tp.shards_of(lcfg, "slstm") == 1
    with pytest.raises(ValueError, match="axes"):
        Trainer(CFG, TrainHyper(), None, device=CPU,
                mesh=AbstractMesh((2,), ("fsdp",)))
    with pytest.raises(ValueError, match="pod_group"):
        Trainer(CFG, TrainHyper(grad_compression="int8_pod"), None,
                device=CPU)


def test_launcher_trains_on_a_host_mesh(capsys):
    """``--mesh host`` on the CPU: a world of one over a FileStore, torn
    down at the end."""
    import torch.distributed as dist

    state = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                               "--batch", "2", "--seq", "32", "--mesh",
                               "host"])
    assert int(state["step"]) == 2
    assert not dist.is_initialized()
    assert "[train] step=    1" in capsys.readouterr().out


def test_launcher_trains_in_process(tmp_path, capsys):
    state = launch_train.main(["--smoke", "--device", "cpu", "--steps", "3",
                               "--batch", "2", "--seq", "32", "--ckpt-dir",
                               str(tmp_path)])
    assert int(state["step"]) == 3
    assert capsys.readouterr().out.count("[train] step=") == 2
    assert CheckpointManager(tmp_path).latest_step() == 3
    with pytest.raises(SystemExit, match="modality"):
        launch_train.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                           "cpu"])


def test_decode_step_is_the_models():
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    params = init_train_state(cfg, seed=1, device=CPU)["params"]
    cache = tt.init_decode_cache(cfg, 2, 16, CPU)
    batch = {"tokens": torch.tensor([[3], [9]]),
             "positions": torch.tensor([0, 0])}
    logits, new_cache = make_decode_step(cfg)(params, cache, batch)
    with torch.no_grad():
        want, _ = tt.decode_step(params, cfg, cache, batch["tokens"],
                                 batch["positions"])
    assert torch.equal(logits, want)
    assert len(new_cache["layers"]) == cfg.num_layers


def test_entry_points_target_cuda():
    """The slice's entry points default to the card and refuse to run on
    the CPU unless asked."""
    for fn in (init_train_state, SyntheticLMDataset, Trainer,
               CheckpointManager.restore, run_with_restarts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(CFG, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLMDataset()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1"])
