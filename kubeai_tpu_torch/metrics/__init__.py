"""Prometheus-text instruments for the engine server. Counterpart of
kubeai_tpu/metrics, of which only the registry is ported."""

from kubeai_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    lint_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "lint_registry"]
