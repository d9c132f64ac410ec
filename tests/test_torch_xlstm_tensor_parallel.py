"""Tensor parallelism for the xLSTM mixers over ``"model"``: xlstm SMOKE
(3 mLSTM layers and one sLSTM layer; 4 heads, so a model axis of 4 is the
widest) on gloo ranks on the CPU, held against the reference's own mesh
runs (``torch_ssm_mesh``: one reference subprocess, one spawn a world
size):

1. every parameter leaf and every decode-cache leaf (the mLSTM's
   ``conv`` by channel and ``c`` / ``n`` / ``m`` by head, the sLSTM's
   ``h`` / ``c`` / ``n`` / ``m`` by head) cut and joined back on (1, 2) is
   bitwise the original; each local shape is the reference's
   ``shard_shape`` on (1, 2) but for the per-head leaves the reference's
   spec replicates and the port cuts by head (the mLSTM's ``w_if``,
   ``b_if``, ``gn_scale``; the sLSTM's ``r_rec``, ``b_in``, ``gn_scale``)
   and the sLSTM feed-forward, whose odd width (``int(1.3333 * 64)``) the
   model axis does not divide, so it runs whole on every rank as the
   reference's dedupe replicates it;
2. a rank's prefill cache on (1, 2) is the cut of one device's, and a
   fresh decode cache at ``local_config``'s widths has the cut's shapes;
3. 3 fp32 training steps on (1, 2) and (1, 4), restored from the
   reference's state: every step's loss and ``grad_norm`` within 1e-5
   relative of the reference's mesh run, and the gathered final state
   within 1e-5 relative 2-norm of the port's ``mesh=None`` run;
4. greedy tokens through ``Scheduler(mesh=)`` on (1, 2) and (1, 4)
   identical to ``mesh=None``'s and to the reference's ``Scheduler``'s;
5. a model axis the heads do not divide keeps both mixers whole (the
   reference's dedupe replicates such a dim); the vocabulary stays cut.
"""
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h
import torch_ssm_mesh as ssm

TRAIN = ((1, 2), (1, 4))
SERVE = ((1, 2), (1, 4))
TOL = 1e-5
# the leaves the reference's spec replicates and the port cuts by head:
# leaf name -> the dim it halves on (1, 2)
_HEAD_CUTS = {"w_if": 1, "b_if": 0, "gn_scale": 0, "r_rec": 1, "b_in": 0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ssm.run(tmp_path_factory, "xlstm", TRAIN, SERVE)


def test_round_trips_are_bitwise(runs):
    report = runs["reports"][2][0]
    assert report["round_trip"]
    assert report["init_local"]
    assert report["cache_round_trip"]
    cut = {k.rsplit("/", 1)[1] for k in report["cut_leaves"]}
    assert {"conv", "c", "n", "m", "h"} <= cut


def test_local_shapes_follow_the_reference(runs):
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, specs_from_jax

    cfg = ssm.config("xlstm")
    got = runs["reports"][2][0]["shapes"]
    want = flatten_dict(specs_from_jax(runs["handed"]["shapes"], cfg))
    full = {k: list(v.shape) for k, v in flatten_dict(params_from_jax(
        runs["handed"]["state"]["params"], cfg)).items()}
    assert set(got) == set(want) == set(full)
    head_cut = 0
    for k, shape in got.items():
        leaf = k.rsplit("/", 1)[1]
        if ("/mlstm/" in k or "/slstm/" in k) and leaf in _HEAD_CUTS:
            expect = list(full[k])
            expect[_HEAD_CUTS[leaf]] //= 2
            assert list(want[k]) == full[k], k      # replicated there
            assert shape == expect, k
            head_cut += 1
            continue
        assert shape == list(want[k]), k
    assert head_cut == 3 * 3 + 3                     # 3 mLSTM + 1 sLSTM
    ff = [k for k in got if k.endswith("/ff_up")]
    assert ff and all(got[k] == full[k] for k in ff)


def test_prefill_cache_is_the_cut_of_one_devices(runs):
    report = runs["reports"][2][0]
    assert report["cache_gap"] <= TOL
    assert report["cache_shapes"]


def test_each_mixer_on_the_mesh_matches_one_device(runs):
    """The mixer alone on (1, 2), inside the local view, against one
    device's on the same input: within 1e-5 of its largest output."""
    gaps = runs["reports"][2][0]["mixer_gaps"]
    assert set(gaps) == {"mlstm", "slstm"}
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("shape", TRAIN, ids=["1x2", "1x4"])
def test_training_matches_the_reference_mesh_run(runs, shape, capsys):
    world = shape[0] * shape[1]
    for rep in runs["reports"][world]:
        assert rep["train"][str(shape)] == \
            runs["reports"][world][0]["train"][str(shape)]
    got = runs["reports"][world][0]["train"][str(shape)]
    want = runs["ref"]["train"][shape]
    loss = h.rel_gaps([g[0] for g in got], [w[0] for w in want])
    norm = h.rel_gaps([g[1] for g in got], [w[1] for w in want])
    with capsys.disabled():
        print(f"\n[ssm-tp] xlstm {shape}: loss gaps "
              + " ".join(f"{v:.1e}" for v in loss) + "; grad_norm gaps "
              + " ".join(f"{v:.1e}" for v in norm))
    assert max(loss) <= TOL and max(norm) <= TOL


@pytest.mark.parametrize("shape", TRAIN, ids=["1x2", "1x4"])
def test_training_state_matches_one_device(runs, shape):
    got = torch.load(runs["out"] / f"state{shape[0]}x{shape[1]}.pt")
    assert h.state_gap(got, runs["single_state"]) <= TOL


@pytest.mark.parametrize("shape", SERVE, ids=["1x2", "1x4"])
def test_greedy_tokens_match(runs, shape):
    want = {str(k): v for k, v in runs["single_tokens"].items()}
    assert want == {str(k): v for k, v in runs["ref"]["tokens"].items()}
    world = shape[0] * shape[1]
    for rep in runs["reports"][world]:
        assert rep["tokens"][str(shape)] == want


def test_a_model_axis_the_heads_do_not_divide_raises():
    from repro_torch.distributed import tensor_parallel as tp

    cfg = ssm.config("xlstm")
    lcfg = tp.local_config(cfg, 8)
    assert lcfg.whole == ("mlstm", "slstm")
    assert lcfg.num_heads == cfg.num_heads == 4
    assert tp.shards_of(lcfg, "mlstm") == tp.shards_of(lcfg, "slstm") == 1
    assert lcfg.vocab_size == cfg.vocab_size // 8
