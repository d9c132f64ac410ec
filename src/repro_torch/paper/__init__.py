"""repro_torch.paper — the paper's own evaluation on the port (ports of
``benchmarks/fig1_approx.py``, ``fig2_h01.py``, ``table1_svm.py`` and the
first three suites of ``benchmarks/run.py``).

Each module's ``run(device="cuda", datasets=None, make_map=None, ...)``
returns its rows in the reference's ``name,us_per_call,derived`` format,
at the reference's settings. ``datasets`` takes arrays handed over (numpy
or tensors) in place of the port's own draws, and ``make_map(kernel, d, D,
seed, h01)`` builds each feature map in place of ``make_feature_map(...,
seed=seed)``, so a test can feed both packages the same data and draws.
``details``, a dict where given, receives per row what a check reads
(errors unrounded, test predictions, maps, train walls). Times are taken
on the host clock with the device synchronized around the timed work.
``python -m repro_torch.paper`` prints the three suites' CSV on the card;
nothing is written to a file.
"""
from repro_torch.paper import fig1_approx, fig2_h01, table1_svm

__all__ = ["fig1_approx", "fig2_h01", "table1_svm", "SUITES"]

# the reference's order (benchmarks/run.py)
SUITES = (("fig1", fig1_approx.run), ("table1", table1_svm.run),
          ("fig2", fig2_h01.run))
