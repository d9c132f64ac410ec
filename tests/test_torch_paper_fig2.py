"""The port's Figure 2 script (repro_torch.paper.fig2_h01) against the
reference's (benchmarks/fig2_h01.py) on the CPU, fed the reference's data
and maps: every row by name and in order, the features within 1e-5 x
max(1, max |ref|), and the accuracies equal up to one test point at
``train_linear``'s lam 1e-3 (both scripts run with that lam; at the
scripts' lam 1e-5 neither fit has converged, ROADMAP queue C). The
helpers are tests/test_torch_paper.py's."""
import numpy as np
import torch

from repro_torch.paper import fig2_h01
from test_torch_paper import (
    at_converged_lam,
    fixed_datasets,
    handed_over,
    parse,
    port_map,
    record_maps,
)

from benchmarks import fig2_h01 as ref_fig2  # noqa: E402  (path set there)


def test_fig2_rows_features_and_accuracies_match_reference(monkeypatch):
    made = record_maps(monkeypatch, ref_fig2)
    data = fixed_datasets(monkeypatch, ref_fig2, fig2_h01.DATASETS)
    at_converged_lam(monkeypatch, ref_fig2, fig2_h01)
    want = parse(ref_fig2.run())
    details = {}
    got = parse(fig2_h01.run(device="cpu", datasets=data,
                             make_map=handed_over(made), details=details))
    assert list(got) == list(want)
    assert len(got) == 12
    for name, (_, acc) in got.items():
        ds = name.split("/")[1]
        n_te = data[ds]["x_test"].shape[0]
        assert abs(acc - want[name][1]) <= 1.0 / n_te + 1e-4, name
        assert details[name]["pred"].shape == (n_te,)
    for (_, d, num, h01), jfm in made.items():
        ds = next(n for n in fig2_h01.DATASETS
                  if data[n]["x_train"].shape[1] == d)
        x = data[ds]["x_test"]
        ref = np.asarray(jfm(x))
        z = port_map(jfm)(torch.from_numpy(np.array(x))).numpy()
        assert z.shape == ref.shape
        assert np.abs(z - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
