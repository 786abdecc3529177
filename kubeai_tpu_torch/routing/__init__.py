"""Routing helpers shared with the load balancer. Counterpart of
kubeai_tpu/routing; only the page-hash chain is ported."""
