"""The dry run's last three sharding levers as rules the port's model code
reads, on gloo ranks on the CPU, held against the reference's own mesh
runs under the same ``rules_override`` (``torch_mesh_harness``: one
reference subprocess for the file, one spawn a world size):

* ``vocab_unsharded`` (``{"vocab": None}``): the vocabulary whole on every
  model rank (``LocalConfig.whole``). qwen3 SMOKE rm, 3 fp32 train steps
  on (1, 2) and (2, 2): every loss and ``grad_norm`` within 2e-7 relative
  of the reference's mesh run and of one device; greedy tokens through
  ``Scheduler(mesh=)`` equal to one device's.
* ``kv_seq_shard`` (``{"kv_seq": "model", "kv_heads": None}``): every kv
  head on every model rank (``LocalConfig.kv_group``; ``wk`` / ``wv``
  whole, their gradients summed over the ranks) and the exact and MLA
  decode caches cut by sequence over ``"model"``, the decode a split-K
  over the ranks' slots combined by log-sum-exp. qwen3 SMOKE exact,
  deepseek SMOKE exact (MLA) and qwen3 with a sliding window of 8 (a
  12-token prompt, so the ring buffer wraps across the ranks) through
  ``StepExecutor(mesh=)`` on (1, 2) and (2, 2): the prefill's last logits
  and 4 decode steps' within 1e-4 relative of the reference's jitted
  prefill and decode on its mesh under the same rules, a rank's cache at
  1/2 of the sequence, ``shard_cache`` -> ``gather_cache`` bitwise,
  greedy tokens through ``Scheduler(mesh=)`` equal to one device's; 3
  train steps of qwen3 SMOKE exact under the rules on (1, 2) and (2, 2)
  against the reference's.
* ``sp_data`` (``{"act_seq": ("data",)}``): at batch 1 the rows are
  replicated over ``"data"`` and the residual stream's sequence is cut
  over it. qwen3 SMOKE rm, 3 fp32 train steps on (2, 1) and (2, 2): losses
  and ``grad_norm`` within 2e-7 relative of the reference's and of one
  device, the gathered final train state within 1e-5 relative 2-norm of
  one device's; greedy tokens through ``Scheduler(mesh=)`` under the rule
  equal to one device's (a prefill only the slot's owner runs cuts no
  sequence over "data"). The reference's own run under this override raises
  (its ``constrain`` maps ``"batch"`` and ``"act_seq"`` both to
  ``"data"`` and does not dedupe the spec), so its batch-1 run on the
  same mesh under the default rules stands in: the same numbers.
"""
import dataclasses
import json
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h

VOCAB_RULES = {"vocab": None}
KV_RULES = {"kv_seq": "model", "kv_heads": None}
SP_RULES = {"act_seq": ("data",)}
# name -> (arch, attention mode, rules, global batch, mesh shapes)
TRAIN = {
    "vocab_unsharded": ("qwen3-1.7b", "rm", VOCAB_RULES, 4,
                        ((1, 2), (2, 2))),
    "kv_seq_shard": ("qwen3-1.7b", "exact", KV_RULES, 4, ((1, 2), (2, 2))),
    "sp_data": ("qwen3-1.7b", "rm", SP_RULES, 1, ((2, 1), (2, 2))),
}
# name -> (arch, fields, prompt length, max_len): the decode cases
DECODE = {
    "qwen3": ("qwen3-1.7b", {}, 10, 32),
    # capacity for every token: no drop, so the MoE's routing does not
    # depend on which rows share a batch (the reference's (1, 2) prefill
    # routes both prompts together, the executor admits one at a time)
    "deepseek": ("deepseek-v2-lite-16b", {"moe": {"capacity_factor": 8.0}},
                 10, 32),
    "qwen3_window": ("qwen3-1.7b", {"sliding_window": 8}, 12, 16),
}
DECODE_SHAPES = ((1, 2), (2, 2))
STEPS = 4
TOL = 2e-7
STATE_TOL = 1e-5
LOGIT_TOL = 1e-4
MAX_NEW = 4

ORACLE = r'''
from repro.distributed.sharding import cache_partition_specs
from repro.models import init_model
import jax.numpy as jnp

TRAIN, DECODE, DECODE_SHAPES, NSTEPS = @TRAIN@, @DECODE@, @SHAPES@, @STEPS@
KV_RULES = @KV@


def with_fields(cfg, fields):
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in fields.items()})


def train_rules(cfg, state, shape, rules, batch):
    """train_on_mesh under a rules override and a global batch."""
    mesh = make_mesh(shape, ("data", "model"))
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=batch)
    batches = [data.batch_at(i) for i in range(STEPS)]
    with logical_rules_context(mesh, rules) as r:
        ps = params_partition_specs(state["params"], mesh, r)
        sshard = shardings(mesh, {"params": ps, "opt": {
            "mu": ps, "nu": ps, "step": P()}, "step": P()})
        bshard = shardings(mesh, batch_partition_specs(batches[0], mesh, r))
        step = jax.jit(jsteps.make_train_step(cfg, hyper),
                       in_shardings=(sshard, bshard),
                       out_shardings=(sshard, None))
        state = jax.device_put(state, sshard)
        rows = []
        for b in batches:
            state, m = step(state, jax.device_put(b, bshard))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


def decode_on_mesh(cfg, params, shape, rules, tokens, feed, max_len):
    """The prefill's last logits, then one decode step a row of ``feed``,
    jitted with the rules' shardings of the params, batch and cache."""
    mesh = make_mesh(shape, ("data", "model"))
    b, t = tokens.shape
    pbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "positions": jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32),
                                            (b, t))}
    with logical_rules_context(mesh, rules) as r:
        pshard = shardings(mesh, params_partition_specs(params, mesh, r))
        pre = jsteps.make_prefill_step(cfg, max_len)
        cache_sds = jax.eval_shape(pre, params, pbatch)[1]
        cshard = shardings(mesh, cache_partition_specs(cache_sds, mesh, r))
        bshard = shardings(mesh, batch_partition_specs(pbatch, mesh, r))
        ps = jax.device_put(params, pshard)
        logits, cache = jax.jit(pre, in_shardings=(pshard, bshard),
                                out_shardings=(None, cshard))(
            ps, jax.device_put(pbatch, bshard))
        rows = [np.asarray(logits[:, -1])]
        dec = jax.jit(jsteps.make_decode_step(cfg),
                      in_shardings=(pshard, cshard, None),
                      out_shardings=(None, cshard))
        for i, tok in enumerate(feed):
            lg, cache = dec(ps, cache, {
                "tokens": jnp.asarray(tok[:, None], jnp.int32),
                "positions": jnp.full((b,), t + i, jnp.int32)})
            rows.append(np.asarray(lg[:, 0]))
    return np.stack(rows)


states, dparams, dcfgs, cases = {}, {}, {}, {}
for name, (arch, mode, rules, batch, shapes) in TRAIN.items():
    states[name] = init_state(config(arch, mode))
for name, (arch, fields, t, max_len) in DECODE.items():
    dcfgs[name] = with_fields(config(arch, "exact"), fields)
    dparams[name] = host(jax.jit(
        lambda k, c=dcfgs[name]: init_model(c, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    cases[name] = {"tokens": rng.integers(0, 480, size=(2, t)),
                   "feed": rng.integers(0, 480, size=(NSTEPS, 2)),
                   "prompts": [rng.integers(0, 480, size=n)
                               for n in (t, 5, t - 3)]}
hand_over({"states": states, "params": dparams, "cases": cases})
ref = {"train": {}, "decode": {}}
for name, (arch, fields, t, max_len) in DECODE.items():
    for shape in DECODE_SHAPES:
        ref["decode"][(name, shape)] = decode_on_mesh(
            dcfgs[name], dparams[name], shape, KV_RULES,
            cases[name]["tokens"], cases[name]["feed"], max_len)
for name, (arch, mode, rules, batch, shapes) in TRAIN.items():
    for shape in shapes:
        # the reference's constrain() does not dedupe: under sp_data its
        # ("batch", "act_seq") spec names "data" twice and raises, so its
        # batch-1 mesh run under the default rules stands in
        ref["train"][(name, shape)] = train_rules(
            config(arch, mode), states[name], shape,
            None if name == "sp_data" else rules, batch)
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(ref, f)
'''.replace("@TRAIN@", repr(TRAIN)).replace("@DECODE@", repr(DECODE)) \
    .replace("@SHAPES@", repr(DECODE_SHAPES)).replace("@STEPS@", repr(STEPS)) \
    .replace("@KV@", repr(KV_RULES))


def _train_config(name):
    arch, mode, *_ = TRAIN[name]
    return h.port_config(arch, mode)


def _decode_config(name):
    arch, fields, *_ = DECODE[name]
    cfg = h.port_config(arch, "exact")
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in fields.items()}).validate()


def _dataset(cfg, batch):
    from repro_torch.data.synthetic import SyntheticLMDataset

    return SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=batch, device="cpu")


def _key(name, shape):
    return f"{name}/{shape[0]}x{shape[1]}"


def _ckpt(out, name, shape):
    return out / f"ckpt_{name}_{shape[0]}x{shape[1]}"


def _rules(mesh, rules):
    from repro_torch.distributed.sharding import logical_rules_context

    return logical_rules_context(mesh, rules)


def _serve(cfg, params, prompts, max_len, mesh=None, rules=None):
    """Greedy tokens through the Scheduler (under ``rules`` on a mesh: the
    executor reads them at its construction)."""
    import contextlib

    from repro_torch.serve import Request, Scheduler

    with _rules(mesh, rules) if mesh is not None else \
            contextlib.nullcontext():
        sched = Scheduler(cfg, params, num_slots=2, max_len=max_len,
                          device="cpu", mesh=mesh)
        for i, p in enumerate(prompts):
            sched.submit(Request(request_id=i, prompt=p,
                                 max_new_tokens=MAX_NEW))
        done = sched.run()
    return {r: [int(t) for t in done[r].generated] for r in sorted(done)}


def _decode(cfg, params, case, max_len, mesh=None, rules=None):
    """The executor's first logits of both prompts (one admission each, no
    padding: the prompt length is a bucket) and one batched decode step a
    row of ``feed`` -> ``[steps + 1, 2, V]``, and its cache."""
    import contextlib

    from repro_torch.serve.executor import StepExecutor

    tokens, feed = case["tokens"], case["feed"]
    t = tokens.shape[1]
    with _rules(mesh, rules) if mesh is not None else \
            contextlib.nullcontext():
        ex = StepExecutor(cfg, params, 2, max_len, buckets=(t, max_len),
                          device="cpu", mesh=mesh)
        rows = [torch.cat([ex.admit(s, tokens[s])[0] for s in (0, 1)])]
        for i, tok in enumerate(feed):
            rows.append(ex.decode(
                torch.from_numpy(tok[:, None]).long(),
                torch.full((2,), t + i, dtype=torch.int32))[:, 0])
    return torch.stack(rows).numpy(), ex


def _cache_round_trip(cfg, params, case, max_len, mesh) -> bool:
    """One device's prefill cache cut by the rules and joined back is
    bitwise the original, each rank's piece the slots it owns."""
    from repro_torch.common.tree import flatten_dict
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.transformer import prefill

    t = case["tokens"].shape[1]
    batch = {"tokens": torch.from_numpy(case["tokens"]).long(),
             "positions": torch.arange(t, dtype=torch.int32).expand(2, t)}
    with torch.inference_mode():
        _, full = prefill(params, cfg, batch, max_len)
    with _rules(mesh, KV_RULES):
        local = tp.shard_cache(full, mesh, cfg)
        back = tp.gather_cache(local, mesh, tp.meta_template(full))
    a, b, cut = flatten_dict(full), flatten_dict(back), flatten_dict(local)
    rank = tp.local_view_of(mesh).model_rank
    own = all(torch.equal(cut[k], v.chunk(2, dim=1)[rank])
              for k, v in a.items() if k.split("/")[-1] in ("k", "v", "c_kv",
                                                              "k_pe"))
    return own and set(a) == set(b) and all(torch.equal(a[k], b[k])
                                            for k in a)


def _gathers_a_step(cfg, mesh, rules) -> int:
    """The all-gathers of one batch-1 train step from the seed by a
    Trainer built under ``rules`` (the step runs outside the rules
    context: the Trainer keeps the rules it was built under)."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.train.trainer import Trainer

    with _rules(mesh, rules):
        trainer = Trainer(cfg, h.hyper(1), _dataset(cfg, 1), mesh=mesh,
                          log_every=1, device="cpu")
    state = trainer.init_or_restore()
    before = all_gather.calls
    trainer.train(1, state)
    return all_gather.calls - before


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
    report = {"train": {}, "tokens": {}, "decode": {}, "cache": {},
              "round_trip": {}, "gathers": {}}
    for name, (arch, mode, rules, batch, shapes) in TRAIN.items():
        for shape in shapes:
            if shape[0] * shape[1] != world:
                continue
            cfg = _train_config(name)
            key = _key(name, shape)
            mesh = make_mesh(shape, ("data", "model"))
            with _rules(mesh, rules):
                trainer = Trainer(cfg, h.hyper(3), _dataset(cfg, batch),
                                  mesh=mesh, log_every=1,
                                  ckpt_dir=str(_ckpt(out, name, shape)),
                                  checkpoint_every=10 ** 9, device="cpu")
                state = trainer.train(3, trainer.init_or_restore())
                gathered = trainer.full_state(state)
            report["train"][key] = [(r["loss"], r["grad_norm"])
                                    for r in trainer.metrics_log]
            if rank == 0:
                torch.save(flatten_dict(gathered),
                           out / f"state_{key.replace('/', '_')}.pt")
            if name == "sp_data":
                report["gathers"][key] = [
                    _gathers_a_step(cfg, mesh, r) for r in
                    (rules, {"act_seq": None})]
            if name in ("vocab_unsharded", "sp_data"):
                # sp_data: a prefill only the slot's owner runs cuts no
                # sequence over "data" (the other data ranks do not join)
                full = params_from_jax(handed["states"][name]["params"], cfg)
                with _rules(mesh, rules):
                    local = tp.shard_params(full, mesh, cfg,
                                            fsdp_cut=fsdp.enabled(mesh))
                report["tokens"][key] = _serve(
                    cfg, local, handed["cases"]["qwen3"]["prompts"], 32,
                    mesh, rules)
    for name, (arch, fields, t, max_len) in DECODE.items():
        for shape in DECODE_SHAPES:
            if shape[0] * shape[1] != world:
                continue
            cfg = _decode_config(name)
            key = _key(name, shape)
            mesh = make_mesh(shape, ("data", "model"))
            full = params_from_jax(handed["params"][name], cfg)
            case = handed["cases"][name]
            with _rules(mesh, KV_RULES):
                local = tp.shard_params(full, mesh, cfg,
                                        fsdp_cut=fsdp.enabled(mesh))
            logits, ex = _decode(cfg, local, case, max_len, mesh, KV_RULES)
            report["decode"][key] = logits.tolist()
            report["cache"][key] = {
                k: list(v.shape) for k, v in
                flatten_dict(ex.cache).items() if k.startswith("layers/0/")}
            report["round_trip"][key] = _cache_round_trip(
                cfg, full, case, max_len, mesh)
            report["tokens"][key] = _serve(cfg, local, case["prompts"],
                                           max_len, mesh, KV_RULES)
    (out / f"report{world}_{rank}.json").write_text(json.dumps(report))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer

    out = tmp_path_factory.mktemp("levers")
    proc = h.start_oracle(ORACLE, out)
    h.wait_for(proc, out / "handed.pkl")
    handed = pickle.loads((out / "handed.pkl").read_bytes())
    for name, (*_, shapes) in TRAIN.items():
        for shape in shapes:
            CheckpointManager(_ckpt(out, name, shape)).save(
                0, train_state_from_jax(handed["states"][name],
                                        _train_config(name)))
    # both spawns at once, one device's runs in this process meanwhile
    with ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(h.spawn, _worker, world, out)
                  for world in (2, 4)]
        single = {"train": {}, "decode": {}, "tokens": {}}
        for name, (arch, mode, rules, batch, shapes) in TRAIN.items():
            cfg = _train_config(name)
            trainer = Trainer(cfg, h.hyper(3), _dataset(cfg, batch),
                              log_every=1, device="cpu")
            state = trainer.train(3, train_state_from_jax(
                handed["states"][name], cfg))
            single["train"][name] = {
                "rows": [(r["loss"], r["grad_norm"])
                         for r in trainer.metrics_log],
                "state": flatten_dict(state)}
        for name in ("vocab_unsharded", "sp_data"):
            cfg = _train_config(name)
            single["tokens"][name] = _serve(
                cfg, params_from_jax(handed["states"][name]["params"], cfg),
                handed["cases"]["qwen3"]["prompts"], 32)
        for name, (arch, fields, t, max_len) in DECODE.items():
            cfg = _decode_config(name)
            params = params_from_jax(handed["params"][name], cfg)
            case = handed["cases"][name]
            single["decode"][name] = _decode(cfg, params, case, max_len)[0]
            single["tokens"][name] = _serve(cfg, params, case["prompts"],
                                            max_len)
        for spawn in spawns:
            spawn.result()
    reports = {w: [json.loads((out / f"report{w}_{r}.json").read_text())
                   for r in range(w)] for w in (2, 4)}
    return {"out": out, "ref": h.finish(proc, out), "reports": reports,
            "single": single}


def _train_cases():
    return [(n, s) for n, (*_, shapes) in TRAIN.items() for s in shapes]


def _decode_cases():
    return [(n, s) for n in DECODE for s in DECODE_SHAPES]


def _ids(cases):
    return [f"{n}-{s[0]}x{s[1]}" for n, s in cases]


def _world(shape):
    return shape[0] * shape[1]


@pytest.mark.parametrize("name,shape", _train_cases(),
                         ids=_ids(_train_cases()))
def test_training_matches_the_reference_and_one_device(runs, name, shape,
                                                       capsys):
    key = _key(name, shape)
    got = runs["reports"][_world(shape)][0]["train"][key]
    for rep in runs["reports"][_world(shape)]:
        assert rep["train"][key] == got, key
    want = runs["ref"]["train"][(name, shape)]
    one = runs["single"]["train"][name]["rows"]
    gaps = {}
    for label, other in (("reference", want), ("one device", one)):
        gaps[label] = (h.rel_gaps([g[0] for g in got], [w[0] for w in other])
                       + h.rel_gaps([g[1] for g in got],
                                    [w[1] for w in other]))
    with capsys.disabled():
        print(f"\n[levers] {key}: loss and grad_norm gaps, reference "
              + " ".join(f"{v:.1e}" for v in gaps["reference"])
              + "; one device " + " ".join(f"{v:.1e}"
                                           for v in gaps["one device"]))
    assert max(gaps["one device"]) <= TOL
    # sp_data's stand-in (the reference's default rules on the mesh) is
    # held on its losses; the gradients against one device's, here and in
    # the final state
    held = gaps["reference"][:3] if name == "sp_data" else gaps["reference"]
    assert max(held) <= TOL


@pytest.mark.parametrize("shape", TRAIN["sp_data"][4],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sp_data_gathers_the_sequence_over_data(runs, shape):
    """Under ``sp_data`` every block entry all-gathers the sequence over
    ``"data"``: a step makes more all-gathers than with ``"act_seq"``
    off."""
    for rep in runs["reports"][_world(shape)]:
        on, off = rep["gathers"][_key("sp_data", shape)]
        assert on > off, (on, off)


@pytest.mark.parametrize("name,shape", _train_cases(),
                         ids=_ids(_train_cases()))
def test_training_state_matches_one_device(runs, name, shape):
    key = f"{name}_{shape[0]}x{shape[1]}"
    got = torch.load(runs["out"] / f"state_{key}.pt")
    assert h.state_gap(got, runs["single"]["train"][name]["state"]) \
        <= STATE_TOL


@pytest.mark.parametrize("name,shape", _decode_cases(),
                         ids=_ids(_decode_cases()))
def test_split_k_decode_logits_match_the_reference(runs, name, shape):
    """The prefill's and 4 decode steps' logits within 1e-4 relative of
    the reference's mesh run under the same rules and of one device, the
    same on every rank."""
    key = _key(name, shape)
    reps = runs["reports"][_world(shape)]
    got = np.asarray(reps[0]["decode"][key])
    for rep in reps:
        assert np.array_equal(np.asarray(rep["decode"][key]), got)
    for want in (runs["ref"]["decode"][(name, shape)],
                 runs["single"]["decode"][name]):
        assert got.shape == want.shape
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= LOGIT_TOL, (key, gap)


@pytest.mark.parametrize("name,shape", _decode_cases(),
                         ids=_ids(_decode_cases()))
def test_cache_is_cut_by_sequence(runs, name, shape):
    """A rank's cache holds 1/2 of the sequence and every kv head, and
    ``shard_cache`` -> ``gather_cache`` is bitwise."""
    cfg = _decode_config(name)
    _, _, t, max_len = DECODE[name]
    size = min(max_len, cfg.sliding_window or max_len)
    lanes = 2 // shape[0]
    for rep in runs["reports"][_world(shape)]:
        cache = rep["cache"][_key(name, shape)]
        if name == "deepseek":
            m = cfg.mla
            assert cache == {"layers/0/c_kv": [lanes, size // 2,
                                               m.kv_lora_rank],
                             "layers/0/k_pe": [lanes, size // 2,
                                               m.qk_rope_head_dim]}
        else:
            want = [lanes, size // 2, cfg.num_kv_heads,
                    cfg.resolved_head_dim]
            assert cache == {"layers/0/k": want, "layers/0/v": want}
        assert rep["round_trip"][_key(name, shape)] is True


_SERVED = _decode_cases() + [(n, s) for n in ("vocab_unsharded", "sp_data")
                              for s in TRAIN[n][4]]


@pytest.mark.parametrize("name,shape", _SERVED, ids=_ids(_SERVED))
def test_greedy_tokens_match_one_device(runs, name, shape):
    want = runs["single"]["tokens"][name]
    assert all(len(t) == MAX_NEW for t in want.values())
    for rep in runs["reports"][_world(shape)]:
        got = rep["tokens"][_key(name, shape)]
        assert {int(k): v for k, v in got.items()} == want


# -- the local config and the cuts under each rule (no process group) --------
def _abstract(shape):
    from repro_torch.distributed.sharding import AbstractMesh

    return AbstractMesh(shape, ("data", "model"))


def test_vocab_rule_keeps_the_vocabulary_whole():
    from repro_torch.distributed import tensor_parallel as tp

    cfg = _train_config("vocab_unsharded")
    assert tp.local_config(cfg, 2).vocab_size == cfg.vocab_size // 2
    with _rules(_abstract((1, 2)), VOCAB_RULES):
        lcfg = tp.local_config(cfg, 2)
    assert lcfg.whole == ("vocab",) and lcfg.vocab_size == cfg.vocab_size
    assert lcfg.num_heads == cfg.num_heads // 2


def test_kv_rules_keep_every_kv_head_and_cut_the_sequence():
    from repro_torch.distributed import tensor_parallel as tp

    cfg = _decode_config("qwen3")
    with _rules(_abstract((1, 2)), KV_RULES):
        lcfg = tp.local_config(cfg, 2)
    assert (lcfg.num_heads, lcfg.num_kv_heads) == (cfg.num_heads // 2,
                                                   cfg.num_kv_heads)
    assert lcfg.kv_group == cfg.num_heads // cfg.num_kv_heads
    assert lcfg.kv_seq and lcfg.whole == ()
    base = tp.local_config(cfg, 2)
    assert (base.kv_group, base.kv_seq) == (0, False)
    with _rules(_abstract((1, 2)), {"kv_heads": None}):
        only = tp.local_config(cfg, 2)
    assert only.kv_group and not only.kv_seq


def test_kv_seq_without_whole_kv_heads_and_odd_max_len_raise():
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.transformer import init_decode_cache

    cfg = _decode_config("qwen3")
    with _rules(_abstract((1, 2)), {"kv_seq": "model"}):
        with pytest.raises(NotImplementedError, match="kv_heads"):
            tp.local_config(cfg, 2)
    with _rules(_abstract((1, 2)), {"kv_seq": "data"}):
        with pytest.raises(NotImplementedError, match="kv_seq"):
            tp.local_config(cfg, 2)
    for name in ("qwen3", "deepseek"):
        with _rules(_abstract((1, 2)), KV_RULES):
            lcfg = tp.local_config(_decode_config(name), 2)
        with pytest.raises(ValueError, match="max_len.*not divisible by "
                           "the mesh's model axis of 2"):
            init_decode_cache(lcfg, 2, 31, "cpu")


def test_act_seq_over_other_axes_raises():
    """Only "model" and ("data",) cut the residual stream."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.dryrun import dry_world
    from repro_torch.launch.mesh import make_mesh

    assert not dist.is_initialized()
    with dry_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with _rules(mesh, {"act_seq": ("data", "model")}), \
                tp.local_view(mesh, batch_sharded=False):
            with pytest.raises(NotImplementedError, match="act_seq"):
                with tp.sequence_sharding(32):
                    pass
        with _rules(mesh, SP_RULES):
            with tp.local_view(mesh, batch_sharded=False):
                with tp.sequence_sharding(32) as on:
                    assert on and tp.active().seq_axis == "data"
                with tp.sequence_sharding(1) as on:
                    assert not on
            # rows split over "data": the batch takes the axis first
            with tp.local_view(mesh, batch_sharded=True):
                with tp.sequence_sharding(32) as on:
                    assert not on
