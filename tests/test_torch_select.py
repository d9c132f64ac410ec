"""The port's budget selection (``repro_torch.core.select``) against the
reference's (``repro.core.select``): the cases of tests/test_adaptive.py's
CostModel, select_budget, relative-mode, selection-section and CLI
sections on the same payload, each port decision's ``to_dict()`` equal to
the reference's (exactly: both are the same float arithmetic on the same
numbers), plus the platform guard, the launchers' budget flags and
``apply_budget_selection``."""
import argparse
import dataclasses
import json

import numpy as np
import pytest

from repro.core import ExponentialDotProductKernel as JExp
from repro.core import PolynomialKernel as JPoly
from repro.core import select as jsel
from repro_torch.core import ExponentialDotProductKernel as TExp
from repro_torch.core import PolynomialKernel as TPoly
from repro_torch.core import BudgetDecision, CostModel, select_budget
from repro_torch.core import select as tsel
from repro_torch.core.bounds import constants_for

KERNELS = [(JExp(1.0), TExp(1.0)), (JPoly(3, 1.0), TPoly(3, 1.0)),
           (JPoly(7, 0.5), TPoly(7, 0.5))]


def _payload():
    """The reference test's two-shape payload."""
    return {
        "schema_version": 2,
        "backend": "cpu",
        "interpret": True,
        "results": {
            "s1": {"kernel": "exp", "d": 16, "F": 128, "batch": 64,
                   "cells": {
                       "rm/fp32": {"fused_feats_per_s": 1e7},
                       "rm/bf16": {"fused_feats_per_s": 2e7},
                       "ctr/fp32": {"fused_feats_per_s": 5e6},
                   }},
            "s2": {"kernel": "exp", "d": 16, "F": 512, "batch": 64,
                   "cells": {
                       "rm/fp32": {"fused_feats_per_s": 4e7},
                       "rm/bf16": {"fused_feats_per_s": 2e7},
                       "ctr/fp32": {"fused_feats_per_s": 5e6},
                   }},
        },
    }


def _same(tdec, jdec):
    assert isinstance(tdec, BudgetDecision)
    assert tdec.to_dict() == jdec.to_dict()


def test_cost_model_rows_and_coverage():
    cm = CostModel.from_payload(_payload())
    jcm = jsel.CostModel.from_payload(_payload())
    assert cm.rows == jcm.rows and cm.backend == "cpu" and cm.interpret
    assert cm.covers("rm", "fp32") and not cm.covers("tensor_sketch", "fp32")
    assert cm.missing_cells(["rm", "tensor_sketch"], ["fp32", "bf16"]) == [
        "tensor_sketch/fp32", "tensor_sketch/bf16"]
    for f in (8, 128, 256, 512, 10**6):
        assert cm.throughput("rm", "fp32", f) == jcm.throughput("rm", "fp32",
                                                                f)
    assert cm.throughput("rm", "fp32", 128) == pytest.approx(1e7)
    assert 1e7 < cm.throughput("rm", "fp32", 256) < 4e7
    assert cm.predict_latency_s("rm", "fp32", 128, 64) == pytest.approx(
        64 * 128 / 1e7)
    with pytest.raises(KeyError, match="tensor_sketch/fp32"):
        cm.throughput("tensor_sketch", "fp32", 128)


@pytest.mark.parametrize("kernels", KERNELS, ids=lambda k: k[0].name)
@pytest.mark.parametrize("eps,delta", [(0.5, 0.05), (0.1, 0.01),
                                       (2.0, 0.5)])
def test_decision_certifies_target(kernels, eps, delta):
    jk, tk = kernels
    dec = select_budget(tk, 12, eps, delta, measure="proportional",
                        radius=0.8)
    _same(dec, jsel.select_budget(jk, 12, eps, delta,
                                  measure="proportional", radius=0.8))
    consts = constants_for(tk, 0.8, 12, 2.0)
    assert dec.eps_certified <= eps
    assert dec.eps_certified == consts.eps_at(dec.num_features, delta,
                                              "proportional")


def test_latency_ranking_and_budget_flag():
    cm = CostModel.from_payload(_payload())
    jcm = jsel.CostModel.from_payload(_payload())
    for budget in (None, 1e-12, 1e9):
        kw = dict(measure="proportional", radius=0.7, batch=64,
                  latency_budget_s=budget)
        dec = select_budget(TExp(1.0), 16, 1.0, 0.1, cost_model=cm, **kw)
        _same(dec, jsel.select_budget(JExp(1.0), 16, 1.0, 0.1,
                                      cost_model=jcm, **kw))
        priced = [c["predicted_latency_s"] for c in dec.candidates
                  if c["predicted_latency_s"] is not None]
        assert dec.predicted_latency_s == min(priced)
        assert dec.meets_latency_budget is (None if budget is None
                                            else budget > 1.0)


def test_estimator_pin_and_platform_guard():
    cm = CostModel.from_payload(_payload())
    dec = select_budget(TExp(1.0), 16, 1.0, 0.1, estimator="ctr",
                        cost_model=cm, measure="proportional", radius=0.7)
    assert dec.estimator == "ctr"
    assert {c["estimator"] for c in dec.candidates} == {"ctr"}
    with pytest.raises(KeyError, match="unknown"):
        select_budget(TExp(1.0), 16, 1.0, 0.1, estimator="nope")
    # a card decision priced from CPU rows is refused
    with pytest.raises(ValueError, match="platform"):
        select_budget(TExp(1.0), 16, 1.0, 0.1, cost_model=cm,
                      platform="gpu")
    gpu = CostModel.from_payload({**_payload(), "backend": "gpu",
                                  "interpret": False})
    ok = select_budget(TExp(1.0), 16, 1.0, 0.1, cost_model=gpu,
                       platform="gpu", measure="proportional", radius=0.7)
    assert ok.backend == "gpu"
    assert select_budget(TExp(1.0), 16, 1.0, 0.1, cost_model=cm,
                         platform="cpu").backend == "cpu"


def test_relative_mode():
    eps_abs = tsel.relative_to_additive_eps(TExp(1.0), 0.8, 0.5)
    assert eps_abs == jsel.relative_to_additive_eps(JExp(1.0), 0.8, 0.5)
    assert eps_abs == pytest.approx(0.5 * np.exp(-0.64), rel=1e-3)
    dec = select_budget(TExp(1.0), 8, 0.5, 0.1, relative=True, radius=0.8,
                        measure="proportional")
    _same(dec, jsel.select_budget(JExp(1.0), 8, 0.5, 0.1, relative=True,
                                  radius=0.8, measure="proportional"))
    assert dec.eps_certified <= dec.eps
    with pytest.raises(ValueError, match="relative"):
        tsel.relative_to_additive_eps(TPoly(3, 0.0), 1.0, 0.5)
    with pytest.raises(ValueError, match="eps_rel"):
        tsel.relative_to_additive_eps(TExp(1.0), 1.0, 0.0)


def test_selection_section_equals_reference():
    sec = tsel.selection_section(_payload(), targets=[(0.5, 0.1)])
    assert sec == jsel.selection_section(_payload(), targets=[(0.5, 0.1)])
    for (dec,) in sec["decisions"].values():
        assert dec["eps_certified"] <= dec["eps"]
        assert dec["predicted_latency_s"] is not None
    # the default targets, on the committed payload's shapes
    with open("BENCH_core.json") as f:
        core = json.load(f)
    assert tsel.selection_section(core) == jsel.selection_section(core)
    assert tsel.make_kernel("poly7") == TPoly(7, 1.0)
    with pytest.raises(ValueError, match="unknown bench kernel"):
        tsel.make_kernel("rbf")


def test_select_cli(tmp_path, capsys):
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_payload()))
    argv = ["--kernel", "exp", "--dim", "16", "--eps", "1.0", "--delta",
            "0.1", "--bench", str(bench)]
    assert tsel.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert jsel.main(argv) == 0
    assert out == json.loads(capsys.readouterr().out)
    assert out["eps_certified"] <= out["eps"]
    assert tsel.main(["--bench", str(bench), "--check-coverage"]) == 1
    assert "missing" in capsys.readouterr().out
    assert tsel.main(["--bench", str(tmp_path / "none.json"),
                      "--check-coverage"]) == 1
    full = {**_payload(), "results": {"s": {
        "kernel": "exp", "d": 16, "F": 128, "batch": 64,
        "cells": {f"{e}/{p}": {"fused_feats_per_s": 1e7}
                  for e in ("rm", "ctr", "structured", "tensor_sketch")
                  for p in ("fp32", "bf16")}}}}
    bench.write_text(json.dumps(full))
    assert tsel.main(["--bench", str(bench), "--check-coverage"]) == 0
    assert "covers the full 4 x 2 grid" in capsys.readouterr().out


def _args(**kw):
    ap = argparse.ArgumentParser()
    from repro_torch.launch.budget import add_budget_args

    add_budget_args(ap)
    ns = ap.parse_args([])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_apply_budget_selection(tmp_path, capsys):
    from repro.launch.budget import apply_budget_selection as japply
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    from repro_torch.launch.budget import apply_budget_selection

    cfg = get_config("qwen3-1.7b", smoke=True, attention_mode="rm")
    same, dec = apply_budget_selection(cfg, _args(), tag="t")
    assert same is cfg and dec is None
    # the default payload is the card's; absent here, selection is unpriced
    assert _args().bench == tsel.DEFAULT_BENCH
    bench = tmp_path / "b.json"
    bench.write_text(json.dumps(_payload()))
    args = _args(eps=1.0, delta=0.1, bench=str(bench))
    new, dec = apply_budget_selection(cfg, args, tag="t")
    jargs = _args(eps=1.0, delta=0.1, bench=str(bench))
    jnew, jdec = japply(jget("qwen3-1.7b", smoke=True, attention_mode="rm"),
                        jargs, tag="t")
    assert dec.to_dict() == jdec.to_dict()
    assert (new.rm.estimator, new.rm.precision, new.rm.num_features) == (
        jnew.rm.estimator, jnew.rm.precision, jnew.rm.num_features)
    assert new.rm.num_features == dec.num_features
    assert "priced on backend cpu" in capsys.readouterr().out
    _, dec = apply_budget_selection(
        cfg, _args(eps=1.0, delta=0.1, bench=str(tmp_path / "no.json")))
    assert dec.predicted_latency_s is None
    assert "without a cost model" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="together"):
        apply_budget_selection(cfg, _args(eps=1.0))
    exact = dataclasses.replace(cfg, attention_mode="exact")
    with pytest.raises(SystemExit, match="attention-mode rm"):
        apply_budget_selection(exact, _args(eps=1.0, delta=0.1))
