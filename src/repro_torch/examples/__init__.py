"""Runnable examples of the port's API (ports of the reference's
``examples/``): ``python -m repro_torch.examples.<name>`` for ``quickstart``,
``kernel_approximation``, ``estimator_comparison``, ``serve_lm`` and
``train_lm``. Each runs on the CUDA device by default and on the CPU with
``--device cpu``; each ``main(argv)`` returns what it printed as numbers.
"""
