"""Shared helpers. Counterpart of kubeai_tpu/utils, of which only
`retryafter` is ported."""
