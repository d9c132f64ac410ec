"""Dry-run analysis (port of ``repro.analysis``): the roofline terms of a
step from the port's counted work (:mod:`.roofline`) and the tables over
the dry run's records (:mod:`.report`)."""
from repro_torch.analysis.roofline import (
    HW_H100,
    HardwareSpec,
    model_flops,
    roofline_from_counts,
)

__all__ = [
    "HW_H100",
    "HardwareSpec",
    "roofline_from_counts",
    "model_flops",
]
