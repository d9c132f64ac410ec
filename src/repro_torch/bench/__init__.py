"""Benchmark helpers of the port (port of ``repro.bench``): only
:func:`roofline.launch_cost`, which the kernel spans attach, so far. The
runner, the load generator and the roofline rows are still to be ported
(ROADMAP.md queue A item 2)."""
