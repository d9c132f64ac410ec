"""Tensor parallelism for the Mamba mixer over ``"model"``: jamba SMOKE
(rm mode, fused; 7 Mamba layers, one attention layer, the MoE on
alternate layers) on gloo ranks on the CPU, held against the reference's
own mesh runs (``torch_ssm_mesh``: one reference subprocess, one spawn a
world size):

1. every parameter leaf and every decode-cache leaf (Mamba's ``conv`` /
   ``ssm`` by channel, the rm state by head) cut and joined back on (1, 2)
   is bitwise the original; each local shape is the reference's
   ``shard_shape`` on (1, 2) but for the leaves the port cuts otherwise
   (the MoE's ff slices, Mamba's ``w_in`` halves cut one by one, which
   the spec's contiguous cut of the fused dim would not do);
2. a rank's prefill cache on (1, 2) is the cut of one device's, and a
   fresh decode cache at ``local_config``'s widths has the cut's shapes;
3. 3 fp32 training steps on (1, 2) and on (2, 2) (FSDP over ``"data"``,
   ``"act_seq"`` and the MoE's per-shard capacity as in the reference's
   run), restored from the reference's state: every step's loss and
   ``grad_norm`` within 1e-5 relative of the reference's mesh run; on
   (1, 2) the gathered final state within 1e-5 relative 2-norm of the
   port's ``mesh=None`` run;
4. greedy tokens through ``Scheduler(mesh=)`` on (1, 2) and (2, 2)
   identical to ``mesh=None``'s and to the reference's ``Scheduler``'s.
"""
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import torch_mesh_harness as h
import torch_ssm_mesh as ssm

TRAIN = ((1, 2), (2, 2))
SERVE = ((1, 2), (2, 2))
TOL = 1e-5
# leaves the port cuts where the reference's spec does not, or otherwise:
# leaf name -> the dim the port halves
_PORT_CUTS = {"w_gate": 2, "w_up": 2, "w_down": 1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ssm.run(tmp_path_factory, "jamba", TRAIN, SERVE)


def test_round_trips_are_bitwise(runs):
    report = runs["reports"][2][0]
    assert report["round_trip"]
    assert report["init_local"]
    assert report["cache_round_trip"]
    # the Mamba state and the rm state are cut
    assert any(k.endswith("/ssm") for k in report["cut_leaves"])
    assert any(k.endswith("/conv") for k in report["cut_leaves"])
    assert any(k.endswith("/rm_s") for k in report["cut_leaves"])


def test_local_shapes_follow_the_reference(runs):
    from repro_torch.common.tree import flatten_dict
    from repro_torch.convert import params_from_jax, specs_from_jax

    cfg = ssm.config("jamba")
    got = runs["reports"][2][0]["shapes"]
    want = flatten_dict(specs_from_jax(runs["handed"]["shapes"], cfg))
    full = {k: list(v.shape) for k, v in flatten_dict(params_from_jax(
        runs["handed"]["state"]["params"], cfg)).items()}
    assert set(got) == set(want) == set(full)
    for k, shape in got.items():
        leaf = k.rsplit("/", 1)[1]
        if "/moe/" in k and leaf in _PORT_CUTS:
            expect = list(full[k])
            expect[_PORT_CUTS[leaf]] //= 2
            assert shape == expect, k
            continue
        assert shape == list(want[k]), k


def test_prefill_cache_is_the_cut_of_one_devices(runs):
    report = runs["reports"][2][0]
    assert report["cache_gap"] <= TOL
    assert report["cache_shapes"]


def test_each_mixer_on_the_mesh_matches_one_device(runs):
    """The mixer alone on (1, 2), inside the local view, against one
    device's on the same input: within 1e-5 of its largest output."""
    gaps = runs["reports"][2][0]["mixer_gaps"]
    assert set(gaps) == {"mamba"}
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("shape", TRAIN, ids=["1x2", "2x2"])
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
        print(f"\n[ssm-tp] jamba {shape}: loss gaps "
              + " ".join(f"{v:.1e}" for v in loss) + "; grad_norm gaps "
              + " ".join(f"{v:.1e}" for v in norm))
    assert max(loss) <= TOL and max(norm) <= TOL


def test_training_state_matches_one_device(runs):
    got = torch.load(runs["out"] / "state1x2.pt")
    assert h.state_gap(got, runs["single_state"]) <= TOL


@pytest.mark.parametrize("shape", SERVE, ids=["1x2", "2x2"])
def test_greedy_tokens_match(runs, shape):
    want = {str(k): v for k, v in runs["single_tokens"].items()}
    assert want == {str(k): v for k, v in runs["ref"]["tokens"].items()}
    world = shape[0] * shape[1]
    for rep in runs["reports"][world]:
        assert rep["tokens"][str(shape)] == want
