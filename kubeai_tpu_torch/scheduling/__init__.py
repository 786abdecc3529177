"""SLO-aware request scheduling: the engine's pending queue (priority
bands, weighted fair queueing, deadline admission). Counterpart of
kubeai_tpu/scheduling."""

from kubeai_tpu_torch.scheduling.scheduler import (
    CLASS_BATCH,
    CLASS_RANK,
    CLASS_REALTIME,
    CLASS_STANDARD,
    DeadlineInfeasible,
    PRIORITY_CLASSES,
    RequestScheduler,
    SchedulingPolicy,
)

__all__ = [
    "CLASS_BATCH",
    "CLASS_RANK",
    "CLASS_REALTIME",
    "CLASS_STANDARD",
    "DeadlineInfeasible",
    "PRIORITY_CLASSES",
    "RequestScheduler",
    "SchedulingPolicy",
]
