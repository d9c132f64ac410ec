from repro_torch.train.steps import (
    init_params,
    make_eval_step,
    make_prefill_step,
)

__all__ = ["init_params", "make_eval_step", "make_prefill_step"]
