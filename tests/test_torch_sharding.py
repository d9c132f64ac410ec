"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``) on the CPU, with no
process group: both packages' spec functions take an abstract mesh (axis
names and sizes).

For every arch's SMOKE parameters (rm mode where the arch attends, and
qwen3 with tensor_sketch), its decode cache and a train batch, and for the
sharded estimator's stacked params of the four families,
``params_partition_specs``, ``cache_partition_specs``,
``batch_partition_specs`` and ``estimator_param_specs`` equal the
reference's on the meshes (2, 4) ``("data", "model")``, (2, 16, 16)
``("pod", "data", "model")`` and (8,) ``("rm_features",)``. The reference
stacks scanned layers on a leading axis; ``convert.specs_from_jax`` lays
its specs out per layer, as the port's tree is. Then the rules context,
``constrain``, ``spec_for`` and the DTensor placements."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.distributed import estimator as jest
from repro.distributed import sharding as jsh
from repro.models import transformer as jt
from repro_torch.configs import get_config, supports_rm
from repro_torch.convert import specs_from_jax
from repro_torch.core import ExponentialDotProductKernel
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.estimator import make_sharded_feature_map
from repro_torch.models import transformer as tt
from repro_torch.train.steps import init_params

MESHES = [((2, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8,), ("rm_features",))]
MESH_IDS = ["data2_model4", "pod2_data16_model16", "rm_features8"]
FAMILIES = ["rm", "tensor_sketch", "ctr", "structured"]
CASES = [(arch, "rm" if supports_rm(get_config(arch, smoke=True)) else None,
          "rm") for arch in jlist()] + [("qwen3-1.7b", "rm", "tensor_sketch")]
CASE_IDS = [f"{a}-{m or 'own'}-{e}" for a, m, e in CASES]


def _configs(arch, mode, estimator):
    jcfg = jget(arch, smoke=True, attention_mode=mode)
    cfg = get_config(arch, smoke=True, attention_mode=mode)
    if estimator != "rm":
        import dataclasses

        jcfg = dataclasses.replace(jcfg, rm=dataclasses.replace(
            jcfg.rm, estimator=estimator))
        cfg = dataclasses.replace(cfg, rm=dataclasses.replace(
            cfg.rm, estimator=estimator))
    return jcfg, cfg


def _tuples(tree):
    """A spec tree (dicts, lists, specs) with each spec as a tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tree)


@pytest.fixture(scope="module")
def port_params():
    cache = {}

    def get(arch, mode, estimator):
        key = (arch, mode, estimator)
        if key not in cache:
            cache[key] = init_params(_configs(*key)[1], 0, "cpu")
        return cache[key]

    return get


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch,mode,estimator", CASES, ids=CASE_IDS)
def test_param_and_cache_specs_equal_reference(arch, mode, estimator, shape,
                                               names, port_params):
    jcfg, cfg = _configs(arch, mode, estimator)
    jmesh, mesh = JAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
    sds = jax.eval_shape(lambda: jt.init_model(jcfg, jax.random.PRNGKey(0)))
    want = specs_from_jax(jsh.params_partition_specs(sds, jmesh), cfg)
    got = _tuples(tsh.params_partition_specs(port_params(arch, mode,
                                                         estimator), mesh))
    assert got == want
    # not vacuous: a TP mesh splits some weight over "model"
    assert ("'model'" in repr(got)) == ("model" in names)
    if not cfg.causal:
        return
    for batch in (4, 32):
        jcache = jax.eval_shape(lambda: jt.init_decode_cache(jcfg, batch,
                                                             64))
        want = specs_from_jax(jsh.cache_partition_specs(jcache, jmesh), cfg)
        cache = tt.init_decode_cache(cfg, batch, 64, "meta")
        assert _tuples(tsh.cache_partition_specs(cache, mesh)) == want


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_batch_specs_equal_reference(shape, names):
    jmesh, mesh = JAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
    for rows in (8, 64, 1):
        jbatch = {"tokens": np.zeros((rows, 33), np.int32),
                  "targets": np.zeros((rows, 33), np.int32),
                  "embeds": np.zeros((rows, 33, 16), np.float32),
                  "step": np.zeros((), np.int32)}
        batch = {k: torch.empty(v.shape, device="meta")
                 for k, v in jbatch.items()}
        for seq in (False, True):
            want = jax.tree_util.tree_map(
                tuple, jsh.batch_partition_specs(jbatch, jmesh,
                                                 seq_sharded=seq),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
            got = _tuples(tsh.batch_partition_specs(batch, mesh,
                                                    seq_sharded=seq))
            assert got == want, (rows, seq)
        rules = {"seq": ("pod", "data")}
        want = jax.tree_util.tree_map(
            tuple, jsh.batch_partition_specs(jbatch, jmesh, rules, True),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert _tuples(tsh.batch_partition_specs(batch, mesh, rules,
                                                 True)) == want


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_estimator_specs_equal_reference(family, shape, names):
    """The stacked per-shard params (S 8, and S 3, which no axis divides):
    the port's shapes are the reference's, and so are their specs."""
    from repro.core import ExponentialDotProductKernel as JExp

    jmesh, mesh = JAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
    for shards in (8, 3):
        jfm = jest.make_sharded_feature_map(
            JExp(1.0), 12, 96 * shards, jax.random.PRNGKey(0),
            num_shards=shards, estimator=family, measure="proportional")
        fm = make_sharded_feature_map(
            ExponentialDotProductKernel(1.0), 12, 96 * shards, seed=0,
            num_shards=shards, estimator=family, measure="proportional",
            device="cpu")
        assert {k: tuple(v.shape) for k, v in fm.params.items()} == {
            k: tuple(v.shape) for k, v in jfm.params.items()}
        want = {k: tuple(v) for k, v in
                jsh.estimator_param_specs(jfm.params, jmesh).items()}
        got = {k: tuple(v) for k, v in
               tsh.estimator_param_specs(fm.params, mesh).items()}
        assert got == want


def test_rules_context_constrain_and_spec_for():
    mesh = tsh.AbstractMesh((2, 4), ("data", "model"))
    x = torch.zeros(4, 8, 16)
    assert tsh.spec_for(("batch", None)) == tsh.P()
    assert tsh.constrain(x, ("batch",)) is x          # no context: no-op
    with tsh.logical_rules_context(mesh) as rules:
        # "pod" dropped: this mesh has none
        assert rules["batch"] == ("data",)
        assert rules["heads"] == "model"
        assert tsh.spec_for(("batch", "act_seq", None)) == tsh.P(
            ("data",), "model", None)
        assert tsh.constrain(x, ("batch", "act_seq", "embed")) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            tsh.constrain(x, ("batch", "act_seq"))
    assert tsh.constrain(x, ("batch",)) is x          # context closed
    jmesh = JAbstractMesh((2, 4), ("data", "model"))
    with jsh.logical_rules_context(jmesh) as jrules:
        with tsh.logical_rules_context(mesh, {"seq": ("pod", "data")}) as r:
            assert r["seq"] == ("data",)
            assert {k: v for k, v in r.items() if k != "seq"} == {
                k: v for k, v in jrules.items() if k != "seq"}


def test_placements_and_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tsh.AbstractMesh((2, 4), ("data", "model"))
    assert tsh.mesh_axes(mesh) == {"data": 2, "model": 4}
    assert tsh.placements(tsh.P(None, "model"), mesh) == [Replicate(),
                                                          Shard(1)]
    assert tsh.placements(tsh.P(("data",), None), mesh) == [Shard(0),
                                                            Replicate()]
    assert tsh.placements(tsh.P(), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="split over"):
        tsh.placements(tsh.P(("data", "model")), mesh)
    with pytest.raises(ValueError, match="not in"):
        tsh.placements(tsh.P("pod"), mesh)
    with pytest.raises(ValueError, match="sizes for axes"):
        tsh.AbstractMesh((2,), ("data", "model"))


# ---------------------------------------------------------------------------
# launch/shapes.py: the cells and their abstract inputs
# ---------------------------------------------------------------------------
def _ref_layers(tree, cfg):
    """The reference's decode cache (ShapeDtypeStructs) per layer, as
    ``{path: (shape, dtype)}``: a scanned group's leaves without the
    stacked layer dim."""
    def flat(node, drop):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update({f"{k}/{kk}": vv for kk, vv in flat(v, drop)
                            .items()})
            else:
                out[k] = (tuple(v.shape[drop:]), str(v.dtype))
        return out

    layers = [flat(tree[f"dense_{i}"], 0) for i in range(cfg.first_k_dense)]
    for _ in range(cfg.num_scanned_groups):
        for j, kind in enumerate(cfg.block_pattern):
            layers.append(flat(tree["groups"][f"b{j}_{kind}"], 1))
    return layers


def _port_leaves(node):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update({f"{k}/{kk}": vv for kk, vv in _port_leaves(v)
                            .items()})
            else:
                out[k] = (tuple(v.shape), str(v.dtype).removeprefix(
                    "torch."))
        return out
    raise TypeError(type(node))


def test_cells_equal_reference():
    from repro.launch import shapes as jshapes
    from repro_torch.configs import list_archs
    from repro_torch.launch import shapes as tshapes

    archs = list_archs()
    want = jshapes.enumerate_cells(archs, {a: jget(a) for a in archs})
    got = tshapes.enumerate_cells(archs, {a: get_config(a) for a in archs})
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert sum(c.skipped for c in got) == 2          # hubert's two decodes
    some = ["qwen3-1.7b", "hubert-xlarge"]
    assert tshapes.enumerate_cells(
        some, {a: get_config(a) for a in some}, ["long_500k"]) == [
        tshapes.Cell("qwen3-1.7b", "long_500k", "rm"),
        tshapes.Cell("hubert-xlarge", "long_500k", "exact", True,
                     "encoder-only: no decode step")]


@pytest.mark.parametrize("arch", jlist())
def test_input_specs_equal_reference(arch):
    """Every shape's batch (and for a decode, cache) specs: the port's
    ``meta`` tensors carry the reference's shapes and dtypes, at FULL
    width and depth, with nothing allocated."""
    from repro.launch import shapes as jshapes
    from repro_torch.launch import shapes as tshapes

    jcfg, cfg = jget(arch), get_config(arch)
    for sname, spec in tshapes.SHAPES.items():
        if spec.kind == "decode" and not cfg.causal:
            continue
        want, got = jshapes.input_specs(jcfg, sname), \
            tshapes.input_specs(cfg, sname)
        assert sorted(got) == sorted(want)
        assert _port_leaves(got["batch"]) == {
            k: (tuple(v.shape), str(v.dtype))
            for k, v in want["batch"].items()}
        assert all(t.device.type == "meta"
                   for t in got["batch"].values())
        if "cache" in want:
            assert [_port_leaves(layer) for layer in got["cache"]["layers"]
                    ] == _ref_layers(want["cache"], jcfg)
