"""The dry run (``repro_torch.launch.dryrun``, ``launch.hillclimb``): one
rank's step on ``meta`` tensors over PyTorch's fake process group, on the
CPU.

1. The counterpart of the reference's ``tests/dist_scripts/
   run_dryrun_tiny.py``: qwen3, mixtral, jamba and xlstm SMOKE train
   steps on a (2, 2, 2) ``("pod", "data", "model")`` mesh count FLOPs,
   temp and argument bytes above 0, and collective bytes above 0 (the
   model axis is 2); nothing is allocated. The bytes that ``memory_s``
   reads (the counted products' operands and results) are above 0 and
   below the unfused count of every operator.
2. A rank's param bytes on the 16 x 16 mesh (its shards over ``"model"``
   and ``"data"``) equal the bytes of the reference's
   ``params_partition_specs`` on a ``jax.sharding.AbstractMesh`` but for
   the listed departures, each pinned: a kv head copied to every rank
   where the model axis exceeds the kv heads (``attn/wk``, ``attn/wv``:
   Megatron's rule; the reference splits inside a head), and mixtral's
   router, which the reference's stacked spec cuts along the 32-layer
   stack over ``"model"`` and the port keeps whole a layer; and the parts
   16 divides in neither direction, which the port keeps whole where the
   reference's fused 2-D weight still divides and GSPMD splits inside a
   head (qwen2-7b's and internvl2-1b's attention, xlstm-350m's mixers;
   hubert-xlarge's vocabulary of 504 is replicated by both). The train
   state is three times the params and two int32 steps in both.
   ``local_config`` names those parts (``LocalConfig.whole``), and one
   formerly failing cell of each of those archs runs on a small fake mesh
   where a SMOKE width is made indivisible the same way; a MoE's decode
   step splits its slots over ``"data"`` (a rank's cache its share).
3. The counted FLOPs of qwen3 SMOKE (exact attention) equal the step's
   matrix products counted by hand, at 2 FLOPs a multiply-add; beside the
   reference's ``lower_cell`` on a one-device Auto mesh they are within a
   factor of 2 (XLA's CPU cost analysis counts other work than the matrix
   products: measured 1.47x).
4. Each experiment whose lever the port lacks raises
   ``NotImplementedError`` and writes nothing; ``no_fsdp`` does switch the
   serving cut off (a decode step's weights whole over ``"data"``, no
   gather).
"""
import json
import math
import os

import jax
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

from repro.configs import get_config as jget
from repro.distributed.sharding import logical_rules_context as jrules
from repro.distributed.sharding import params_partition_specs as jspecs
from repro.models import transformer as jt
from repro_torch.analysis.roofline import HW_H100
from repro_torch.common.tree import flatten_dict, tree_bytes
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import dryrun as dr
from repro_torch.launch import hillclimb
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models.transformer import meta_params
from repro_torch.train.steps import train_state_from_params

TINY = ("qwen3-1.7b", "mixtral-8x7b", "jamba-v0.1-52b", "xlstm-350m")
# bytes a rank holds beyond the reference's specs on 16 x 16, by leaf
DEPARTURES = {
    "qwen3-1.7b": {"attn/wk": 917504, "attn/wv": 917504},
    "h2o-danube-3-4b": {"attn/wk": 1382400, "attn/wv": 1382400},
    "olmo-1b": {},
    "mixtral-8x7b": {"attn/wk": 2097152, "attn/wv": 2097152,
                     "moe/router": 3932160},
    "deepseek-v2-lite-16b": {},
    "jamba-v0.1-52b": {"attn/wk": 262144, "attn/wv": 262144},
    # the parts 16 divides in neither direction, kept whole by the port
    # where GSPMD splits the reference's fused 2-D weight inside a head
    "qwen2-7b": {"attn/wq": 84295680, "attn/wk": 12042240,
                 "attn/wv": 12042240, "attn/wo": 84295680,
                 "attn/bq": 376320, "attn/bk": 53760, "attn/bv": 53760},
    "internvl2-1b": {"attn/wq": 4515840, "attn/wk": 645120,
                     "attn/wv": 645120, "attn/wo": 4515840,
                     "attn/bq": 80640, "attn/bk": 11520, "attn/bv": 11520},
    "hubert-xlarge": {},
    "xlstm-350m": {"mlstm/w_up": 17694720, "mlstm/conv_w": 552960,
                   "mlstm/conv_b": 138240, "mlstm/wq": 17694720,
                   "mlstm/wk": 17694720, "mlstm/wv": 17694720,
                   "mlstm/w_down": 8847360, "slstm/w_in": 5898240},
}
# 16 divides neither way (the cells PR 29's dry run recorded as failed):
# the parts kept whole
WHOLE16 = {"qwen2-7b": ("attn",), "internvl2-1b": ("attn", "vocab"),
           "hubert-xlarge": ("vocab",), "xlstm-350m": ("mlstm", "slstm")}
# one formerly failing cell of each on a small fake mesh: (shape kind,
# sequence length, mesh, the SMOKE fields made indivisible there the same
# way); internvl2's prompt holds its 256 patch embeddings
SMALL_CELLS = {
    "qwen2-7b": ("train", 32, (2, 2), {"num_heads": 3, "num_kv_heads": 1}),
    "internvl2-1b": ("prefill", 288, (1, 2), {
        "num_heads": 3, "num_kv_heads": 1, "vocab_size": 513}),
    "hubert-xlarge": ("train", 32, (2, 2), {"vocab_size": 65}),
    "xlstm-350m": ("decode", 32, (1, 8), {}),
}


def test_every_arch_is_listed():
    assert set(DEPARTURES) == set(list_archs())
    assert set(WHOLE16) <= set(DEPARTURES)


@pytest.mark.parametrize("arch", TINY)
def test_tiny_train_step_on_a_2x2x2_mesh(arch):
    cfg = get_config(arch, smoke=True)
    with dr.dry_world(8):
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        rec = dr.measure(cfg, ShapeSpec("tiny", 32, 8, "train"), mesh,
                         "tiny")
    assert rec["per_device_flops"] > 0
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["argument_size_in_bytes"] > 0
    assert rec["per_device_collective_bytes"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    assert rec["inner_loop_flops_correction"] == 0.0
    assert 0 < rec["per_device_bytes"] < rec["per_device_bytes_unfused"]
    assert rec["memory_s"] == rec["per_device_bytes"] / HW_H100.hbm_bw
    assert rec["memory_s_unfused"] == \
        rec["per_device_bytes_unfused"] / HW_H100.hbm_bw
    assert not torch.distributed.is_initialized()


def _by_leaf_ref(arch):
    """Bytes a device holds under the reference's specs on 16 x 16, by
    the leaf's last two path keys."""
    from jax.sharding import AbstractMesh, PartitionSpec as P

    cfg = jget(arch)
    sds = jax.eval_shape(lambda: jt.init_model(cfg, jax.random.PRNGKey(0)))
    mesh = AbstractMesh((16, 16), ("data", "model"))
    with jrules(mesh) as rules:
        specs = jspecs(sds, mesh, rules)
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(sds)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, P))
    for (path, leaf), spec in zip(leaves, spec_leaves, strict=True):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                shape[d] //= 16 ** len(axes)
        keys = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path[-2:])
        out[keys] = out.get(keys, 0) + math.prod(shape) * leaf.dtype.itemsize
    return out


@pytest.fixture
def single():
    """The 16 x 16 mesh over a dry world of 256 ranks (made in
    milliseconds; each test's own, since a process holds one)."""
    with dr.dry_world(256):
        yield dr._mesh("single")


@pytest.mark.parametrize("arch", sorted(DEPARTURES))
def test_rank_bytes_on_16x16_equal_reference_specs(arch, single):
    cfg = get_config(arch)
    local = tp.shard_params(meta_params(cfg), single, cfg, fsdp_cut=True)
    mine = {}
    for k, v in flatten_dict(local).items():
        if k.endswith("__empty_dict__"):    # a parameter-free norm
            continue
        key = "/".join(k.split("/")[-2:])
        mine[key] = mine.get(key, 0) + v.numel() * v.element_size()
    ref = _by_leaf_ref(arch)
    assert set(mine) == set(ref)
    assert {k: mine[k] - ref[k] for k in mine
            if mine[k] != ref[k]} == DEPARTURES[arch]
    state = train_state_from_params(local)
    assert tree_bytes(state) == 3 * sum(mine.values()) + 8


@pytest.mark.parametrize("arch", sorted(WHOLE16))
def test_archs_16_does_not_divide_raise(arch, single):
    """They no longer raise: the indivisible parts are kept whole at their
    full widths (their rank bytes are pinned above)."""
    cfg = get_config(arch)
    lcfg = tp.local_config(cfg, 16)
    assert lcfg.whole == WHOLE16[arch]
    if "attn" in lcfg.whole or "mlstm" in lcfg.whole:
        assert lcfg.num_heads == cfg.num_heads
    if "vocab" in lcfg.whole:
        assert lcfg.vocab_size == cfg.vocab_size
    local = tp.shard_params(meta_params(cfg), single, cfg, fsdp_cut=True)
    assert tp.param_cuts(meta_params(cfg), single, cfg) is not None
    assert flatten_dict(local)


@pytest.mark.parametrize("arch", sorted(SMALL_CELLS))
def test_formerly_failing_cell_on_a_small_fake_mesh(arch):
    import dataclasses

    from repro_torch.launch.mesh import make_mesh

    kind, seq, shape, fields = SMALL_CELLS[arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **fields)
    lcfg = tp.local_config(cfg, shape[1])
    assert lcfg.whole == WHOLE16[arch]
    with dr.dry_world(shape[0] * shape[1]):
        mesh = make_mesh(shape, ("data", "model"))
        rec = dr.measure(cfg, ShapeSpec("tiny", seq, 8, kind), mesh, "tiny")
    assert rec["per_device_flops"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert not torch.distributed.is_initialized()


def test_moe_decode_cache_split_over_data():
    """deepseek SMOKE rm's decode step on (2, 1) holds half the slots of
    one rank's: its cache is half the bytes (PR 29's run kept every slot on
    every rank for a MoE), and the MoE gathers the lanes (all-gathers)."""
    from repro_torch.launch.mesh import make_mesh

    cfg = get_config("deepseek-v2-lite-16b", smoke=True,
                     attention_mode="rm")
    spec = ShapeSpec("tiny", 32, 8, "decode")
    caches = {}
    for shape in ((1, 1), (2, 1)):
        with dr.dry_world(shape[0]):
            rec = dr.measure(cfg, spec, make_mesh(shape, ("data", "model")),
                             "tiny")
        caches[shape] = rec["memory_analysis"]["argument_parts"]["cache"]
        if shape == (2, 1):
            assert rec["collectives"]["all-gather"]["count"] > 0
    assert caches[(2, 1)] * 2 == caches[(1, 1)]


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's dry-run module. Importing it puts 512 forced host
    devices into XLA_FLAGS: jax's backend is started first (with this
    process's own flags) and the variable is restored after the test."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdr

    return jdr


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_counted_flops_beside_reference(kind, jdryrun, monkeypatch):
    from repro.launch import shapes as jshapes
    from repro.launch.mesh import make_mesh as jmesh

    b, t = 8, 64
    monkeypatch.setitem(jshapes.SHAPES, "tiny",
                        jshapes.ShapeSpec("tiny", t, b, kind))
    ref = jdryrun.lower_cell(
        "qwen3-1.7b", "tiny", jmesh((1, 1), ("data", "model")), "one",
        "exact", cfg_override=lambda _: jget("qwen3-1.7b", smoke=True))
    cfg = get_config("qwen3-1.7b", smoke=True)
    with dr.dry_world(1):
        rec = dr.measure(cfg, ShapeSpec("tiny", t, b, kind),
                         dr._mesh("one"), "one")
    # the forward's matrix products a token, 2 FLOPs a multiply-add: the
    # projections and MLP of each layer, QK^T and PV over all t keys, the
    # (tied) unembedding
    d, h, kv, dh, ff, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
    groups = 2 * (d * h * dh * 2 + d * kv * dh * 2 + 3 * d * ff
                  + 2 * t * h * dh)
    unembed = 2 * d * v
    fwd = (groups * cfg.num_layers + unembed) * b * t
    if kind == "prefill":
        assert rec["per_device_flops"] == fwd
    else:
        # forward, the groups' recompute, and a backward of twice the
        # forward but for the attention's gradients into its inputs
        assert rec["per_device_flops"] > fwd + groups * cfg.num_layers * \
            b * t
    ratio = rec["per_device_flops"] / ref["per_device_flops"]
    assert 0.5 <= ratio <= 2.0, ratio


_DECODE_BASE = {}


def _decode_base(mesh):
    """qwen3-1.7b's ``decode_32k`` record on the 16 x 16 mesh (measured
    once a process)."""
    if not _DECODE_BASE:
        _DECODE_BASE["rec"] = dr.measure(get_config("qwen3-1.7b"),
                                         SHAPES["decode_32k"], mesh,
                                         "single")
    return _DECODE_BASE["rec"]


@pytest.mark.parametrize("exp", ["kv_seq_shard", "sp_data",
                                 "vocab_unsharded"])
def test_levers_record(exp, tmp_path, single):
    """Each of the reference's last three levers runs on the 16 x 16 mesh
    and writes its record, its ``rules`` the reference's override
    (``src/repro/launch/hillclimb.py``: ``sp_data`` ``{"act_seq":
    ("data",)}``, ``kv_seq_shard`` ``{"kv_seq": "model", "kv_heads":
    None}``, ``vocab_unsharded`` ``{"vocab": None}``), with the change the
    lever makes to the counts."""
    want = {"sp_data": {"act_seq": ("data",)},
            "kv_seq_shard": {"kv_seq": "model", "kv_heads": None},
            "vocab_unsharded": {"vocab": None}}[exp]
    assert hillclimb.EXPERIMENTS[exp]["rules_override"] == want
    rec = hillclimb.run_experiment("qwen3-1.7b", "decode_32k", exp, single,
                                   out_dir=tmp_path)
    path = tmp_path / f"qwen3-1.7b__decode_32k__{exp}.json"
    assert json.loads(path.read_text())["rules"] == \
        {k: list(v) if isinstance(v, tuple) else v for k, v in want.items()}
    assert rec["experiment"] == exp and rec["rules"] == want
    base = _decode_base(single)
    parts = (base["memory_analysis"]["argument_parts"],
             rec["memory_analysis"]["argument_parts"])
    colls = (base["collectives"], rec["collectives"])
    if exp == "sp_data":
        # a T = 1 decode: no sequence to cut, the baseline's record
        for key in ("per_device_flops", "per_device_bytes"):
            assert rec[key] == base[key]
        assert colls[1] == colls[0] and parts[1] == parts[0]
    elif exp == "vocab_unsharded":
        # the embedding and unembedding whole over "model": more weight
        # bytes, and no vocab-parallel embedding all-reduce
        assert parts[1]["params"] > parts[0]["params"]
        assert colls[1]["all-reduce"]["count"] < \
            colls[0]["all-reduce"]["count"]
    else:
        # every kv head on every rank, 1/16 of the sequence: a rank's
        # cache is 8 kv heads x 2048 slots against the baseline's 1 kv
        # head (Megatron's replication at 16 ranks) x 32768
        cfg = get_config("qwen3-1.7b")
        rows = SHAPES["decode_32k"].global_batch // 16
        per_layer = 2 * rows * cfg.resolved_head_dim * 2        # k, v bf16
        assert parts[0]["cache"] == cfg.num_layers * per_layer * 32768
        assert parts[1]["cache"] == cfg.num_layers * per_layer * 8 * 2048
        # the split-K's partials [B, H, dh + 2] fp32 all-gathered once a
        # layer, with the queries
        assert colls[1]["all-gather"]["count"] > \
            colls[0]["all-gather"]["count"]


def test_baseline_records_the_cell_with_no_override(tmp_path, single):
    """``baseline`` writes the record the levers are read against: the
    default rules' counts."""
    rec = hillclimb.run_experiment("qwen3-1.7b", "decode_32k", "baseline",
                                   single, out_dir=tmp_path)
    assert (tmp_path / "qwen3-1.7b__decode_32k__baseline.json").exists()
    base = _decode_base(single)
    assert rec["experiment"] == "baseline"
    for key in ("per_device_flops", "per_device_bytes", "collectives",
                "memory_analysis"):
        assert rec[key] == base[key], key


@pytest.mark.parametrize("rules", [{"kv_seq": "data"}, {"heads": None},
                                   {"act_seq": ("data", "model")}],
                         ids=["kv_seq-data", "heads-none", "act_seq-2d"])
def test_inexpressible_override_raises(rules, single):
    with pytest.raises(NotImplementedError, match="not expressible"):
        dr.measure(get_config("qwen3-1.7b"), SHAPES["decode_32k"], single,
                   "single", rules=rules)


def test_no_fsdp_switches_the_serving_cut_off(tmp_path, single):
    base = dr.measure(get_config("qwen3-1.7b"), SHAPES["decode_32k"],
                      single, "single")
    off = hillclimb.run_experiment("qwen3-1.7b", "decode_32k", "no_fsdp",
                                   single, out_dir=tmp_path)
    assert (tmp_path / "qwen3-1.7b__decode_32k__no_fsdp.json").exists()
    assert off["experiment"] == "no_fsdp" and off["rules"] == {"fsdp": None}
    params = (base["memory_analysis"]["argument_parts"]["params"],
              off["memory_analysis"]["argument_parts"]["params"])
    # 4.50x: the embedding table (vocab over "model" only) is whole over
    # "data" either way
    assert params[1] > 4 * params[0]
    assert base["collectives"]["all-gather"]["count"] > \
        off["collectives"]["all-gather"]["count"]
