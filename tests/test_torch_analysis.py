"""The dry run's analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

1. ``count_params`` (total, active) of ``models.transformer.meta_params``
   equals the reference's over ``jax.eval_shape(init_model)``, for all ten
   archs at full width (the port's layer list and the reference's stacked
   groups hold the same leaves);
2. ``model_flops`` and ``analytic_inner_loop_flops`` are equal for every
   cell of ``enumerate_cells`` (both packages' cells, which are the same);
3. ``dryrun_table`` and ``roofline_table`` equal the reference's on one
   set of hand-written records (the reference's report pointed at a
   temporary directory by monkeypatch), once the renamed columns and notes
   (``report.RENAMED``) are mapped back; ``roofline_from_counts`` keeps the
   reference's keys; the H100 row is the card's.
"""
import json

import jax
import pytest

from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.launch import shapes as jshapes
from repro.models import transformer as jt
from repro_torch.analysis import report, roofline
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import shapes
from repro_torch.models.transformer import meta_params

ARCHS = list_archs()


def test_the_archs_are_the_references():
    assert ARCHS == list(jlist())


def _moe_fraction(cfg):
    return None if cfg.moe is None else cfg.moe.top_k / cfg.moe.num_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_reference(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    sds = jax.eval_shape(lambda: jt.init_model(jcfg, jax.random.PRNGKey(0)))
    want = jroof.count_params(sds, _moe_fraction(jcfg))
    got = roofline.count_params(meta_params(tcfg), _moe_fraction(tcfg))
    assert got == want
    assert roofline.count_params(meta_params(tcfg)) == \
        jroof.count_params(sds)


def test_model_and_inner_loop_flops_equal_reference_for_every_cell():
    tcells = shapes.enumerate_cells(ARCHS, {a: get_config(a)
                                            for a in ARCHS})
    jcells = jshapes.enumerate_cells(ARCHS, {a: jget(a) for a in ARCHS})
    assert [(c.arch, c.shape, c.attention_mode, c.skipped) for c in tcells] \
        == [(c.arch, c.shape, c.attention_mode, c.skipped) for c in jcells]
    n = 0
    for cell in tcells:
        if cell.skipped:
            continue
        spec = shapes.SHAPES[cell.shape]
        tcfg = get_config(cell.arch, attention_mode=cell.attention_mode)
        jcfg = jget(cell.arch, attention_mode=cell.attention_mode)
        assert roofline.analytic_inner_loop_flops(
            tcfg, spec.seq_len, spec.global_batch, spec.kind) == \
            jroof.analytic_inner_loop_flops(jcfg, spec.seq_len,
                                            spec.global_batch, spec.kind)
        kind = "train" if spec.kind == "train" else "serve"
        for n_active in (1, 1_700_000_000, 2_400_000_000):
            assert roofline.model_flops(kind, n_active, spec.seq_len) == \
                jroof.model_flops(kind, n_active, spec.seq_len)
        n += 1
    assert n == 38          # 40 cells, hubert's two decode shapes skipped


def test_hardware_row_is_the_cards():
    hw = roofline.HW_H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert not hasattr(roofline, "HW_V5E")


def test_roofline_from_counts_keys():
    colls = {k: {"bytes": 0.0, "count": 0} for k in roofline.COLLECTIVES}
    colls["all-gather"] = {"bytes": 4.5e9, "count": 3}
    rec = roofline.roofline_from_counts(9.89e14, 3.35e12, colls, 256,
                                        memory={"temp_size_in_bytes": 1})
    assert set(rec) == {"hw", "num_devices", "per_device_flops",
                        "per_device_bytes", "per_device_collective_bytes",
                        "collectives", "compute_s", "memory_s",
                        "collective_s", "dominant", "memory_analysis"}
    assert (rec["compute_s"], rec["memory_s"], rec["collective_s"]) == (
        1.0, 1.0, 0.01)
    assert rec["dominant"] in ("compute", "memory")


def _records():
    """Hand-written records: one train cell with its grad_accum, one
    collective-bound prefill, one decode, one skip. Each holds the
    reference's keys and the port's (``meta_s``; ``memory_analysis``
    stands for the reference's ``memory_analysis_scanned`` too)."""
    colls = {k: {"bytes": 0.0, "count": 0} for k in jroof._COLLECTIVES}
    mem = {"argument_size_in_bytes": 3.2e9, "temp_size_in_bytes": 41.5e9}

    def rec(arch, shape, kind, mode, comp, memory, coll, ag=0.0, accum=1):
        c = json.loads(json.dumps(colls))
        c["all-reduce"]["bytes"] = 1.25e9
        c["all-gather"]["bytes"] = ag
        return {"arch": arch, "shape": shape, "kind": kind, "mesh": "single",
                "attention_mode": mode, "compile_s": 12.4, "meta_s": 12.4,
                "fits_hbm": True, "memory_analysis": mem,
                "memory_analysis_scanned": mem, "collectives": c,
                "grad_accum": accum, "compute_s": comp,
                "compute_s_corrected": comp, "memory_s": memory,
                "collective_s": coll, "model_flops": 3.1e15,
                "hlo_flops_corrected": 4.2e15, "useful_flops_ratio": 0.738,
                "skipped": False}

    return {
        "qwen3-1.7b__train_4k": rec("qwen3-1.7b", "train_4k", "train",
                                    "exact", 0.9, 0.4, 0.1, accum=4),
        "qwen3-1.7b__prefill_32k": rec("qwen3-1.7b", "prefill_32k",
                                       "prefill", "exact", 0.1, 0.2, 0.7,
                                       ag=9.5e9),
        "qwen3-1.7b__decode_32k": rec("qwen3-1.7b", "decode_32k", "decode",
                                      "exact", 0.01, 0.2, 0.1),
        "hubert-xlarge__decode_32k": {"arch": "hubert-xlarge",
                                      "shape": "decode_32k",
                                      "mesh": "single", "skipped": True,
                                      "skip_reason": "encoder-only"},
    }


def test_report_tables_match_reference(tmp_path, monkeypatch):
    for name, rec in _records().items():
        (tmp_path / "single").mkdir(exist_ok=True)
        (tmp_path / "single" / f"{name}.json").write_text(json.dumps(rec))
    (tmp_path / "single" / "olmo-1b__train_4k.FAILED.json").write_text(
        json.dumps({"arch": "olmo-1b", "shape": "train_4k",
                    "error": "ValueError: heads"}))
    monkeypatch.setattr(jreport, "RESULTS", tmp_path)
    monkeypatch.setattr(report, "RESULTS", tmp_path)

    def back(table):
        for theirs, ours in report.RENAMED.items():
            table = table.replace(ours, theirs)
        return table

    for fn in ("dryrun_table", "roofline_table"):
        want = getattr(jreport, fn)("single")
        got = getattr(report, fn)("single")
        # two header rows, then a row a record (no skip in the roofline)
        assert len(got.splitlines()) == (6 if fn == "dryrun_table" else 5)
        assert got != want          # the renamed columns are renamed
        assert back(got) == want, fn
    assert report.failures_table("single").splitlines()[-1] == \
        "| olmo-1b | train_4k | ValueError: heads |"
