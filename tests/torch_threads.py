"""One intra-op thread for the port's tests on the CPU.

The suite runs several test processes at once (``pytest -n``). With
torch's default of one intra-op thread a core, each process spreads its
small ops over every core and the processes contend for them: the port's
tests then take about 1.5x the wall time and twice the CPU time. Every
``tests/test_torch_*.py`` module imports this one, so each test process
(and each process that collects them) runs torch on one thread; the
spawned ranks of the mesh tests set theirs themselves.
"""
import torch

torch.set_num_threads(1)
