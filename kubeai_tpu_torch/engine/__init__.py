"""Serving engine: paged continuous batching, sampling, the HTTP server.
Counterpart of kubeai_tpu/engine."""

from kubeai_tpu_torch.engine.engine import (
    Engine,
    EngineBusy,
    EngineConfig,
    EngineDraining,
    StepEvent,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams

__all__ = [
    "Engine",
    "EngineBusy",
    "EngineConfig",
    "EngineDraining",
    "SamplingParams",
    "StepEvent",
]
