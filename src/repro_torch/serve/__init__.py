from repro_torch.serve.engine import Request, RequestState, ServingEngine
from repro_torch.serve.executor import (
    DEFAULT_BUCKETS,
    StepExecutor,
    effective_buckets,
)
from repro_torch.serve.sampler import sample_token
from repro_torch.serve.scheduler import Scheduler, StepInfo

__all__ = [
    "DEFAULT_BUCKETS",
    "Request",
    "RequestState",
    "Scheduler",
    "ServingEngine",
    "StepExecutor",
    "StepInfo",
    "effective_buckets",
    "sample_token",
]
