"""Prometheus-text instruments, the flight recorder and tracing for the
engine server. Counterpart of kubeai_tpu/metrics, of which the registry,
`flightrecorder` and `tracing` are ported."""

from kubeai_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    lint_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "lint_registry"]
