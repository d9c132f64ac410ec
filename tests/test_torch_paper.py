"""The port's paper scripts (repro_torch.paper: Figure 1, Table 1 and the
CSV entry point) against the reference's (benchmarks/fig1_approx.py,
table1_svm.py), on the CPU, each fed the reference's data and draws. The
reference seeds its datasets with Python's salted ``hash``; here they are
made with the port's crc32 rule instead (``fixed_datasets``), so every
process and every worker tests on the same data:

* every row the reference's ``run()`` prints, by name and in order;
* Figure 1's Gram errors within 1e-5 of the reference's, on its points and
  its maps handed across;
* Table 1's features within 1e-5 x max(1, max |ref|) of the reference's,
  and its accuracies equal to the reference's up to one test point. The
  accuracies are held at ``train_linear``'s lam 1e-3, where it converges
  (at the scripts' lam 1e-5 neither package's fit has converged and the
  two differ by up to 2 x max |decision|; ROADMAP queue C), by running
  both scripts with their ``train_linear`` at lam 1e-3.

Figure 2 is held the same way in tests/test_torch_paper_fig2.py."""
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread)

import repro.core as J
import repro_torch.core as T
from repro.data import toy as jtoy
from repro_torch.core.feature_map import RMFeatureMap
from repro_torch.core.plan import FeaturePlan
from repro_torch.paper import fig1_approx, table1_svm

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import fig1_approx as ref_fig1  # noqa: E402
from benchmarks import table1_svm as ref_table1  # noqa: E402

CONVERGED_LAM = 1e-3


def port_map(jfm) -> RMFeatureMap:
    """The reference map's plan (through its JSON) and omegas, handed
    across."""
    return RMFeatureMap(plan=FeaturePlan.from_json(jfm.plan.to_json()),
                        omegas=torch.from_numpy(np.array(jfm.omegas)))


def record_maps(monkeypatch, module):
    """Record every map the reference script makes, keyed ``(kernel name,
    d, D, h01)``."""
    made = {}

    def recording(kern, d, num_features, key, **kw):
        fm = J.make_feature_map(kern, d, num_features, key, **kw)
        made[(kern.name, d, num_features, bool(kw.get("h01", False)))] = fm
        return fm

    monkeypatch.setattr(module, "make_feature_map", recording)
    return made


def handed_over(made):
    def make_map(kernel, d, num_features, seed, h01=False):
        return port_map(made[(kernel.name, d, num_features, bool(h01))])

    return make_map


def crc32_of_name(name: str) -> int:
    """The port's dataset seed rule (``repro_torch.data.toy``): a stable
    digest of the name, the same in every process."""
    return zlib.crc32(name.encode())


def fixed_datasets(monkeypatch, module, names):
    """The reference's datasets made once, handed to its script and
    returned as numpy for the port. The reference seeds a dataset with
    ``hash(name)``, which Python salts per process, so its module global
    ``hash`` is the port's crc32 of the name while they are made: the
    data is then the same in every process and every worker."""
    with monkeypatch.context() as m:
        m.setattr(jtoy, "hash", crc32_of_name, raising=False)
        data = {n: jtoy.make_classification_dataset(n) for n in names}
    monkeypatch.setattr(module, "make_classification_dataset",
                        lambda n, **kw: data[n])
    return {n: {k: np.asarray(v) for k, v in ds.items()}
            for n, ds in data.items()}


def at_converged_lam(monkeypatch, module, port_module):
    """Both scripts' ``train_linear`` at lam 1e-3, where it converges (to
    within fp32 Newton-CG's reach: see tests/test_torch_paper_fig2.py).
    Returns ``{"ref": [...], "port": [...]}``, each script's classifiers
    in the order it trained them."""
    fits = {"ref": [], "port": []}

    def train(z, y, lam=1e-4, **kw):
        fits["ref"].append(J.train_linear(z, y, lam=CONVERGED_LAM, **kw))
        return fits["ref"][-1]

    def port_train(z, y, lam=1e-4, **kw):
        assert lam == port_module.LAM == 1e-5       # the script's own
        fits["port"].append(T.train_linear(z, y, lam=CONVERGED_LAM, **kw))
        return fits["port"][-1]

    monkeypatch.setattr(module, "train_linear", train)
    monkeypatch.setattr(port_module, "train_linear", port_train)
    return fits


def parse(rows):
    out = {}
    for r in rows:
        name, us, derived = r.split(",")
        out[name] = (float(us), float(derived))
    return out


def test_fig1_rows_and_errors_match_reference(monkeypatch):
    made = record_maps(monkeypatch, ref_fig1)
    want = ref_fig1.run()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (100, 50)))
    details = {}
    got = fig1_approx.run(device="cpu", datasets={"x": x},
                          make_map=handed_over(made), details=details)
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    for name, (_, err) in parse(want).items():
        # the reference's error is printed to 5 decimals
        assert abs(details[name]["err"] - err) <= 1e-5 + 5e-6, name
        assert details[name]["gram"].shape == (100, 100)
    # the error shrinks with D for every kernel, as the paper's Figure 1
    for kname in fig1_approx.KERNELS:
        errs = [details[f"fig1/{kname}/D{D}"]["err"]
                for D in fig1_approx.BUDGETS]
        assert errs[-1] < errs[0]


def test_table1_rows_features_and_accuracies_match_reference(monkeypatch):
    made = record_maps(monkeypatch, ref_table1)
    data = fixed_datasets(monkeypatch, ref_table1, ref_table1.DATASETS)
    at_converged_lam(monkeypatch, ref_table1, table1_svm)
    want = parse(ref_table1.run())
    details = {}
    got_rows = table1_svm.run(device="cpu", datasets=data,
                              make_map=handed_over(made), details=details)
    got = parse(got_rows)
    assert list(got) == list(want)
    for name in table1_svm.DATASETS:
        n_te = data[name]["x_test"].shape[0]
        for m in ("kernel", "rf", "h01"):
            acc = got[f"table1/{name}/{m}_test"][1]
            # one test point, and the 4-decimal rounding of both rows
            assert abs(acc - want[f"table1/{name}/{m}_test"][1]) <= \
                1.0 / n_te + 1e-4, (name, m)
            assert details[f"{name}/{m}"]["pred"].shape == (n_te,)
            assert details[f"{name}/{m}"]["train_s"] > 0
    # the features: the port's maps (the reference's draws) against the
    # reference's on its test split
    for (_, d, num, h01), jfm in made.items():
        name = next(n for n in table1_svm.DATASETS
                    if data[n]["x_train"].shape[1] == d)
        x = data[name]["x_test"]
        ref = np.asarray(jfm(x))
        z = port_map(jfm)(torch.from_numpy(np.array(x))).numpy()
        assert z.shape == ref.shape == (x.shape[0], jfm.output_dim)
        assert np.abs(z - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_paper_entry_point_prints_suites_and_reports_a_failure(
        monkeypatch, capsys):
    """``python -m repro_torch.paper``: the CSV header, each suite's rows
    in order, a suite that raises as ``<suite>/ERROR,0,0`` (the others
    still run) and exit code 1; the device reaches every suite. The
    suites are stand-ins here: the real ones run in the tests above."""
    import repro_torch.paper as paper
    from repro_torch.paper.__main__ import main

    seen = []

    def suite(name, fail=False):
        def fn(device="cuda"):
            seen.append((name, device))
            if fail:
                raise ValueError("boom")
            return [f"{name}/row,1.0,0.5"]
        return fn

    assert [n for n, _ in paper.SUITES] == ["fig1", "table1", "fig2"]
    monkeypatch.setattr(paper, "SUITES", (("fig1", suite("fig1")),
                                          ("table1", suite("table1", True)),
                                          ("fig2", suite("fig2"))))
    assert main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out.splitlines() == ["name,us_per_call,derived",
                                    "fig1/row,1.0,0.5", "table1/ERROR,0,0",
                                    "fig2/row,1.0,0.5"]
    assert "boom" in out.err
    assert seen == [("fig1", "cpu"), ("table1", "cpu"), ("fig2", "cpu")]
    monkeypatch.setattr(paper, "SUITES", (("fig1", suite("fig1")),))
    assert main(["--device", "cpu"]) == 0


def test_paper_scripts_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (fig1_approx, table1_svm):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run()
