"""Shared test configuration.

Hypothesis runs DERANDOMIZED by default so tier-1 is bit-reproducible: the
same examples are generated on every run/machine (CI included), and
``deadline=None`` keeps jit-compile time from tripping per-example
deadlines. Export ``HYPOTHESIS_PROFILE=dev`` locally to hunt with fresh
random examples.
"""
import os

try:
    from hypothesis import settings

    settings.register_profile("ci", derandomize=True, deadline=None,
                              max_examples=20)
    settings.register_profile("dev", deadline=None)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:  # hypothesis is optional (tests importorskip it)
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; the test skips itself without "
        "one (on the card: python -m pytest -m cuda "
        "tests/test_torch_cuda_kernels.py)")
