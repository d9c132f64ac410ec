"""repro_torch.data — the paper's toy datasets and the synthetic LM
stream (port of ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticLMDataset, byte_tokenize
from repro_torch.data.toy import (
    UCI_LIKE_SPECS,
    make_classification_dataset,
    unit_ball_points,
)

__all__ = ["unit_ball_points", "make_classification_dataset",
           "UCI_LIKE_SPECS", "SyntheticLMDataset", "byte_tokenize"]
