"""Disaggregated prefill/decode serving. Counterpart of kubeai_tpu/disagg:
the same wire format and transports, so that a JAX replica and a port
replica can stand on either side of a hop.

Long prefills and short decode steps have opposite resource shapes:
prefill is compute-bound and bursty, decode is memory-bandwidth-bound
and latency-sensitive. Co-batching them on one replica lets a prefill
burst stall every in-flight stream's next token. This package splits
them: prefill-role engines run (chunked) prefill and EXPORT the paged
KV as a `KVHandoff`; decode-role engines IMPORT handoffs straight into
slots and only ever run decode steps. The control plane stays the JAX
package's: its router orchestrates the two-hop flow
(kubeai_tpu/routing/proxy.py), its operator renders per-role pod groups
and its autoscaler scales each role from its own bottleneck signal.

Roles (crd.metadata.ROLE_*): "prefill", "decode", and the default
"unified" which serves both phases monolithically — the fallback pool
when no disaggregated capacity exists.
"""

from kubeai_tpu_torch.disagg.handoff import (
    HandoffError,
    KVHandoff,
    deserialize,
    serialize,
)
from kubeai_tpu_torch.disagg.transport import (
    HandoffStore,
    HTTPTransport,
    InProcessTransport,
    TransferError,
    TransferResult,
    read_chunked_body,
)

__all__ = [
    "HandoffError",
    "KVHandoff",
    "serialize",
    "deserialize",
    "HandoffStore",
    "HTTPTransport",
    "InProcessTransport",
    "TransferError",
    "TransferResult",
    "read_chunked_body",
]
