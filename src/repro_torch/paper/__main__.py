"""``python -m repro_torch.paper [--device cuda|cpu]``: the paper's three
suites (Figure 1, Table 1, Figure 2, the reference's ``benchmarks/run.py``
order) as ``name,us_per_call,derived`` CSV on standard output. A suite
that raises prints ``<suite>/ERROR,0,0`` and its traceback on standard
error, and the exit code is then 1."""
from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.paper import SUITES

    print("name,us_per_call,derived")
    failed = False
    for name, fn in SUITES:
        try:
            for row in fn(device=args.device):
                print(row, flush=True)
        except Exception:  # noqa: BLE001 - one suite's failure is reported
            failed = True
            print(f"{name}/ERROR,0,0", flush=True)
            traceback.print_exc(file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
