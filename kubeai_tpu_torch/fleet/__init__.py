"""Fleet telemetry: the engine's step profiler. Counterpart of
kubeai_tpu/fleet, of which only the profiler is ported."""

from kubeai_tpu_torch.fleet.profiler import PHASES, StepProfiler, phase_totals

__all__ = ["PHASES", "StepProfiler", "phase_totals"]
