from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.steps import (
    TrainHyper,
    TrainState,
    init_params,
    init_train_state,
    make_decode_step,
    make_eval_step,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager",
    "TrainHyper",
    "TrainState",
    "init_params",
    "init_train_state",
    "make_decode_step",
    "make_eval_step",
    "make_prefill_step",
    "make_train_step",
]
