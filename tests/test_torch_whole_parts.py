"""Parts a model axis divides in neither direction, kept whole on every
model rank (``tensor_parallel.local_config``'s ``LocalConfig.whole``; the
reference's ``_dedupe_spec`` replicates such a dim). SMOKE configs made
indivisible with ``dataclasses.replace``, on gloo ranks on the CPU, held
against the reference's own mesh runs (``torch_mesh_harness``: one
reference subprocess, one spawn a world size):

* ``attn3``: qwen3 SMOKE rm with 3 heads over 1 kv head on (1, 2): the
  attention whole, its MLP and vocabulary cut;
* ``xlstm3``: xlstm SMOKE at d_model 48 with 3 heads on (1, 2): the mLSTM
  and the sLSTM whole, the vocabulary cut;
* ``vocab513``: qwen3 SMOKE rm with a vocabulary of 513 on (1, 2) and (2,
  2): the embedding, logits and cross entropy whole, the blocks cut.

For each: ``shard_params`` -> ``gather_params`` bitwise (a whole leaf is
the rank's own tensor) and ``init_local_params`` the cut of the full
draw; 3 fp32 training steps from the reference's state, every loss and
``grad_norm`` within 2e-7 relative of the reference's mesh run and of the
port's one device, the gathered final train state (params and AdamW's
moments) within 1e-5 relative 2-norm of one device's, as the other mesh
tests hold it (the cut parts sum in another order);
greedy tokens through ``Scheduler(mesh=)`` equal to one device's. An
MLA head count, a Mamba ``d_inner``, a ``d_ff`` or an experts' ff the
axis does not divide raises ``ValueError``.
"""
import dataclasses
import json
import pickle
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h

# name -> (arch, attention mode, the fields made indivisible)
MODELS = {
    "attn3": ("qwen3-1.7b", "rm", {"num_heads": 3, "num_kv_heads": 1}),
    "xlstm3": ("xlstm-350m", None, {"d_model": 48, "num_heads": 3,
                                    "num_kv_heads": 3}),
    "vocab513": ("qwen3-1.7b", "rm", {"vocab_size": 513}),
}
WHOLE = {"attn3": ("attn",), "xlstm3": ("mlstm", "slstm"),
         "vocab513": ("vocab",)}
TRAIN = (("attn3", (1, 2)), ("xlstm3", (1, 2)), ("vocab513", (1, 2)),
         ("vocab513", (2, 2)))
TOL = 2e-7
STATE_TOL = 1e-5
MAX_NEW = 4

ORACLE = r'''
MODELS, TRAIN = MODELS_, TRAIN_
cfgs, states = {}, {}
for name, (arch, mode, fields) in MODELS.items():
    cfgs[name] = dataclasses.replace(config(arch, mode), **fields)
    states[name] = init_state(cfgs[name])
rng = np.random.default_rng(1)
prompts = [rng.integers(0, 480, size=8) for _ in range(3)]
hand_over({"states": states, "prompts": prompts})
ref = {"train": {}}
for name, shape in TRAIN:
    ref["train"][(name, shape)] = train_on_mesh(cfgs[name], states[name],
                                                shape)
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(ref, f)
'''.replace("MODELS_", repr(MODELS)).replace("TRAIN_", repr(TRAIN))


def _config(name):
    arch, mode, fields = MODELS[name]
    return dataclasses.replace(h.port_config(arch, mode),
                               **fields).validate()


def _ckpt(out, name, shape):
    return out / f"ckpt_{name}_{shape[0]}x{shape[1]}"


def _serve(cfg, params, prompts, mesh=None):
    from repro_torch.serve import Request, Scheduler

    sched = Scheduler(cfg, params, num_slots=2, max_len=32, device="cpu",
                      mesh=mesh)
    for i, p in enumerate(prompts):
        sched.submit(Request(request_id=i, prompt=p, max_new_tokens=MAX_NEW))
    done = sched.run()
    return {r: [int(t) for t in done[r].generated] for r in sorted(done)}


def _round_trip(cfg, full, mesh):
    """Whether every leaf cut and joined back is bitwise the original,
    each whole part's leaf the rank's own tensor, and the streamed draw
    the cut of the full one."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.train.steps import init_params

    local = tp.shard_params(full, mesh, cfg)
    back = flatten_dict(tp.gather_params(local, mesh,
                                         tp.meta_template(full)))
    a, cut = flatten_dict(full), flatten_dict(local)
    whole = tp.local_config(cfg, tp.model_size_of(mesh)).whole
    kept = [k for k in a if k.split("/")[2 if k.startswith("layers") else 0]
            in whole + (("embed",) if "vocab" in whole else ())]
    drawn, _ = tp.init_local_params(cfg, 0, mesh, "cpu")
    want = flatten_dict(tp.shard_params(init_params(cfg, 0, "cpu"), mesh,
                                        cfg))
    return (set(a) == set(back) and all(torch.equal(a[k], back[k])
                                        for k in a)
            and bool(kept) and all(cut[k] is a[k] for k in kept)
            and all(torch.equal(v, want[k])
                    for k, v in flatten_dict(drawn).items()))


def _worker(rank, world, store, out):
    h.init_gloo(rank, world, store)
    from pathlib import Path

    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    out = Path(out)
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    report = {"train": {}, "tokens": {}, "round_trip": {}}
    for name, shape in TRAIN:
        if shape[0] * shape[1] != world:
            continue
        cfg = _config(name)
        key = f"{name}/{shape[0]}x{shape[1]}"
        mesh = make_mesh(shape, ("data", "model"))
        full = params_from_jax(handed["states"][name]["params"], cfg)
        report["round_trip"][key] = _round_trip(cfg, full, mesh)
        trainer = Trainer(cfg, h.hyper(3), h.dataset(cfg), mesh=mesh,
                          ckpt_dir=str(_ckpt(out, name, shape)), log_every=1,
                          checkpoint_every=10 ** 9, device="cpu")
        state = trainer.train(3, trainer.init_or_restore())
        report["train"][key] = [(r["loss"], r["grad_norm"])
                                for r in trainer.metrics_log]
        gathered = trainer.full_state(state)
        if rank == 0:
            torch.save(flatten_dict(gathered), out / f"state_{key.replace('/', '_')}.pt")
        local = tp.shard_params(full, mesh, cfg, fsdp_cut=fsdp.enabled(mesh))
        report["tokens"][key] = _serve(cfg, local, handed["prompts"], mesh)
    (out / f"report{world}_{rank}.json").write_text(json.dumps(report))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    out = tmp_path_factory.mktemp("whole")
    proc = h.start_oracle(ORACLE, out)
    h.wait_for(proc, out / "handed.pkl")
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    for name, shape in TRAIN:
        CheckpointManager(_ckpt(out, name, shape)).save(
            0, train_state_from_jax(handed["states"][name], _config(name)))
    # both spawns at once, one device's runs in this process meanwhile
    with ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(h.spawn, _worker, world, out)
                  for world in (2, 4)]
        single = {}
        for name in MODELS:
            cfg = _config(name)
            trainer = Trainer(cfg, h.hyper(3), h.dataset(cfg), log_every=1,
                              device="cpu")
            state = trainer.train(3, train_state_from_jax(
                handed["states"][name], cfg))
            single[name] = {
                "rows": [(r["loss"], r["grad_norm"])
                         for r in trainer.metrics_log],
                "state": flatten_dict(state),
                "tokens": _serve(cfg, params_from_jax(
                    handed["states"][name]["params"], cfg),
                    handed["prompts"])}
        for spawn in spawns:
            spawn.result()
    reports = {w: [json.loads((out / f"report{w}_{r}.json").read_text())
                   for r in range(w)] for w in (2, 4)}
    return {"out": out, "ref": h.finish(proc, out), "reports": reports,
            "single": single}


def _ids(cases):
    return [f"{n}-{s[0]}x{s[1]}" for n, s in cases]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_local_config_keeps_the_indivisible_part_whole(name):
    """The whole part at its full widths; every other width cut."""
    from repro_torch.distributed import tensor_parallel as tp

    cfg = _config(name)
    lcfg = tp.local_config(cfg, 2)
    assert lcfg.whole == WHOLE[name]
    heads_whole = name != "vocab513"
    assert lcfg.num_heads == (cfg.num_heads if heads_whole
                              else cfg.num_heads // 2)
    assert lcfg.vocab_size == (cfg.vocab_size if name == "vocab513"
                               else cfg.vocab_size // 2)


# arch -> (fields made indivisible by a model axis of 2, the dim named)
# (a dict: fields of the sub-config)
RAISES = {"mamba": ("jamba-v0.1-52b", {"d_model": 63, "num_heads": 3,
                                        "num_kv_heads": 1,
                                        "mamba": {"expand": 1}},
                    "mamba d_inner"),
          "mlp": ("qwen3-1.7b", {"d_ff": 129}, "d_ff"),
          "moe": ("mixtral-8x7b", {"moe": {"d_ff_expert": 129}},
                  "moe.d_ff_expert"),
          "mla": ("deepseek-v2-lite-16b", {"num_heads": 3}, "num_heads")}


@pytest.mark.parametrize("part", sorted(RAISES))
def test_other_indivisible_widths_raise(part):
    """Only the head mixers and the vocabulary are kept whole: an MLA head
    count, a Mamba ``d_inner``, a ``d_ff`` or an experts' ff the model
    axis does not divide raises, naming the dim and the axis."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp

    arch, fields, dim = RAISES[part]
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in fields.items()})
    with pytest.raises(ValueError, match=f"{dim}=.* is not divisible by "
                       "the mesh's model axis of 2"):
        tp.local_config(cfg, 2)


@pytest.mark.parametrize("name,shape", TRAIN, ids=_ids(TRAIN))
def test_round_trips_are_bitwise(runs, name, shape):
    world = shape[0] * shape[1]
    key = f"{name}/{shape[0]}x{shape[1]}"
    for rep in runs["reports"][world]:
        assert rep["round_trip"][key] is True, key


@pytest.mark.parametrize("name,shape", TRAIN, ids=_ids(TRAIN))
def test_training_matches_the_reference_and_one_device(runs, name, shape,
                                                       capsys):
    world = shape[0] * shape[1]
    key = f"{name}/{shape[0]}x{shape[1]}"
    got = runs["reports"][world][0]["train"][key]
    for rep in runs["reports"][world]:
        assert rep["train"][key] == got, key
    want = runs["ref"]["train"][(name, shape)]
    one = runs["single"][name]["rows"]
    gaps = {}
    for label, other in (("reference", want), ("one device", one)):
        gaps[label] = (h.rel_gaps([g[0] for g in got], [w[0] for w in other])
                       + h.rel_gaps([g[1] for g in got],
                                    [w[1] for w in other]))
    with capsys.disabled():
        print(f"\n[whole] {key}: loss and grad_norm gaps, reference "
              + " ".join(f"{v:.1e}" for v in gaps["reference"])
              + "; one device " + " ".join(f"{v:.1e}"
                                           for v in gaps["one device"]))
    assert max(gaps["reference"]) <= TOL and max(gaps["one device"]) <= TOL


@pytest.mark.parametrize("name,shape", TRAIN, ids=_ids(TRAIN))
def test_training_state_matches_one_device(runs, name, shape):
    key = f"{name}_{shape[0]}x{shape[1]}"
    got = torch.load(runs["out"] / f"state_{key}.pt")
    assert h.state_gap(got, runs["single"][name]["state"]) <= STATE_TOL


@pytest.mark.parametrize("name,shape", TRAIN, ids=_ids(TRAIN))
def test_greedy_tokens_match(runs, name, shape):
    world = shape[0] * shape[1]
    key = f"{name}/{shape[0]}x{shape[1]}"
    want = runs["single"][name]["tokens"]
    assert all(len(t) == MAX_NEW for t in want.values())
    for rep in runs["reports"][world]:
        assert {int(k): v for k, v in rep["tokens"][key].items()} == want
