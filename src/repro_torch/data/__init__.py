"""repro_torch.data — the paper's toy datasets (port of ``repro.data``;
the LM data of ``repro.data.synthetic`` comes with the training slice)."""
from repro_torch.data.toy import (
    UCI_LIKE_SPECS,
    make_classification_dataset,
    unit_ball_points,
)

__all__ = ["unit_ball_points", "make_classification_dataset",
           "UCI_LIKE_SPECS"]
