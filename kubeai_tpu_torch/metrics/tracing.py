"""OTel-compatible distributed tracing, stdlib-only.

A copy of kubeai_tpu/metrics/tracing.py: the tracer is host-side Python
with no JAX in it, and the port keeps its own copy so that it imports
nothing of the JAX package. Both engines emit the same spans and the
same OTLP payload, apart from the instrumentation scope's name.

  - W3C `traceparent` context propagation: the engine server continues
    the trace that the front door and the proxy started, so one trace
    spans the stack.
  - Spans export as OTLP/HTTP JSON (the protobuf-JSON mapping every
    OpenTelemetry collector accepts on /v1/traces) from a background
    batcher. Endpoint from `OTEL_EXPORTER_OTLP_TRACES_ENDPOINT` or
    `OTEL_EXPORTER_OTLP_ENDPOINT` (standard env) or `configure()`;
    without one, span objects are still created so propagation headers
    flow, but nothing is buffered or sent.

Span timestamps are unix-epoch nanoseconds, ids are random per the W3C
spec (16-hex span / 32-hex trace, non-zero).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import re
import threading
import time
import urllib.request

logger = logging.getLogger(__name__)

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# OTLP span kinds (opentelemetry-proto trace.proto).
KIND_INTERNAL = 1
KIND_SERVER = 2
KIND_CLIENT = 3

# The OTLP instrumentation scope of every exported span.
SCOPE_NAME = "kubeai_tpu_torch.metrics.tracing"

_STATUS_UNSET = 0
_STATUS_OK = 1
_STATUS_ERROR = 2


# Module-private PRNG seeded from the OS: the global `random` is vulnerable
# to user `random.seed()` calls, which would yield colliding trace/span ids
# across processes. Forked children re-seed (a module-level Random is
# otherwise duplicated across fork just like the global one).
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))
if hasattr(os, "register_at_fork"):  # not on Windows
    os.register_at_fork(
        after_in_child=lambda: _id_rng.seed(
            int.from_bytes(os.urandom(16), "big")
        )
    )


def _rand_hex(nbytes: int) -> str:
    # PRNG (not uuid4) — cheap, and the spec only wants non-zero random.
    while True:
        h = _id_rng.getrandbits(nbytes * 8)
        if h:
            return format(h, "0{}x".format(nbytes * 2))


class SpanContext:
    """W3C trace context: ids + sampled flag."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Parse an incoming `traceparent`; None on absence/malformation (the
    spec says restart the trace rather than guess)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, int(flags, 16))


class Span:
    __slots__ = (
        "name", "context", "parent_span_id", "kind", "start_ns", "end_ns",
        "attributes", "status", "_tracer",
    )

    def __init__(self, tracer, name, context, parent_span_id, kind, attrs):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_span_id = parent_span_id
        self.kind = kind
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes = dict(attrs or {})
        self.status = _STATUS_UNSET

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def end(self, error: str | None = None) -> None:
        if self.end_ns:
            return  # idempotent
        self.end_ns = time.time_ns()
        if error is not None:
            self.status = _STATUS_ERROR
            self.attributes.setdefault("error.message", error)
        else:
            self.status = _STATUS_OK
        self._tracer._record(self)

    # context-manager sugar: ends with ERROR on exception.
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.end(error=str(ev) if ev is not None else None)
        return False


def _otlp_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


class Tracer:
    """Creates spans and exports them as OTLP/HTTP JSON batches.

    Thread-safe; the exporter is one daemon thread. Spans are dropped (and
    counted) rather than blocking the request path when the buffer is
    full or the collector is down."""

    def __init__(
        self,
        service_name: str = "kubeai-tpu",
        endpoint: str | None = None,
        flush_interval_s: float = 2.0,
        max_buffer: int = 2048,
        max_batch: int = 512,
    ):
        self.service_name = service_name
        self.endpoint = endpoint
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self.dropped = 0
        self._q: queue.Queue[Span] = queue.Queue(maxsize=max_buffer)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._err_logged = 0.0
        if self.endpoint:
            self._thread = threading.Thread(
                target=self._export_loop, daemon=True
            )
            self._thread.start()

    @property
    def exporting(self) -> bool:
        return self.endpoint is not None

    def start_span(
        self,
        name: str,
        parent: SpanContext | None = None,
        kind: int = KIND_INTERNAL,
        attributes: dict | None = None,
    ) -> Span:
        if parent is not None:
            ctx = SpanContext(parent.trace_id, _rand_hex(8), parent.flags)
            parent_id = parent.span_id
        else:
            ctx = SpanContext(_rand_hex(16), _rand_hex(8))
            parent_id = ""
        return Span(self, name, ctx, parent_id, kind, attributes)

    def _record(self, span: Span) -> None:
        if not self.endpoint:
            return
        t = self._thread
        if t is None or not t.is_alive():
            # Nothing will ever drain the queue: enqueueing would just
            # strand the span (and eventually wedge flush callers on a
            # growing task counter). Count it as dropped — the
            # kubeai_tracing_dropped_spans_total counter surfaces the
            # dead exporter instead of silence.
            self.dropped += 1
            return
        try:
            self._q.put_nowait(span)
        except queue.Full:
            self.dropped += 1

    # -- export ----------------------------------------------------------------

    def _drain(self) -> list[Span]:
        out = []
        try:
            while len(out) < self.max_batch:
                out.append(self._q.get_nowait())
        except queue.Empty:
            pass
        return out

    def _export_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            batch = self._drain()
            if batch:
                self._send(batch)
        for batch in iter(self._drain, []):  # final flush
            self._send(batch)

    def _ack(self, batch: list[Span]) -> None:
        """Mark drained spans done on the queue's task counter — what
        flush() joins on."""
        for _ in batch:
            self._q.task_done()

    def _payload(self, batch: list[Span]) -> dict:
        return {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name},
                }]},
                "scopeSpans": [{
                    "scope": {"name": SCOPE_NAME},
                    "spans": [{
                        "traceId": s.context.trace_id,
                        "spanId": s.context.span_id,
                        **(
                            {"parentSpanId": s.parent_span_id}
                            if s.parent_span_id else {}
                        ),
                        "name": s.name,
                        "kind": s.kind,
                        "startTimeUnixNano": str(s.start_ns),
                        "endTimeUnixNano": str(s.end_ns),
                        "attributes": [
                            {"key": k, "value": _otlp_value(v)}
                            for k, v in s.attributes.items()
                        ],
                        "status": (
                            {"code": s.status}
                            if s.status != _STATUS_UNSET else {}
                        ),
                    } for s in batch],
                }],
            }]
        }

    def _send(self, batch: list[Span]) -> None:
        body = json.dumps(self._payload(batch)).encode()
        req = urllib.request.Request(
            self.endpoint.rstrip("/") + "/v1/traces",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()
        except Exception as e:
            # Broad on purpose: a misconfigured endpoint raises ValueError
            # (not OSError) from urlopen, and an escaped exception would
            # kill the exporter thread permanently — export must degrade
            # to counted drops, never die.
            self.dropped += len(batch)
            now = time.monotonic()
            if now - self._err_logged > 60:  # throttle
                self._err_logged = now
                logger.warning("OTLP trace export failed: %s", e)
        finally:
            self._ack(batch)

    def flush(self, timeout_s: float = 5.0) -> None:
        """Push buffered spans out now (tests, shutdown).

        Returns immediately when no exporter thread is alive — nothing
        will ever drain the queue, so spinning on it could only burn the
        whole timeout. Otherwise waits on the queue's task counter
        (Queue.join with a deadline) instead of sleep-polling emptiness:
        empty() flips before the last batch is SENT, and polling wakes
        20ms late per batch where the condition wakes exactly when the
        exporter acks."""
        t = self._thread
        if t is None or not t.is_alive():
            return
        deadline = time.monotonic() + timeout_s
        self._wake.set()
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._wake.set()
                self._q.all_tasks_done.wait(min(remaining, 0.1))

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)


# -- module default -----------------------------------------------------------

_default: Tracer | None = None
_default_lock = threading.Lock()


def configure(
    endpoint: str | None = None, service_name: str = "kubeai-tpu", **kw
) -> Tracer:
    """Install the process-wide tracer. Endpoint resolution order:
    explicit arg → OTEL_EXPORTER_OTLP_TRACES_ENDPOINT →
    OTEL_EXPORTER_OTLP_ENDPOINT → no export (propagation only)."""
    global _default
    endpoint = (
        endpoint
        or os.environ.get("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT")
        or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
    )
    with _default_lock:
        if _default is not None:
            _default.shutdown()
        _default = Tracer(service_name=service_name, endpoint=endpoint, **kw)
        return _default


def tracer() -> Tracer:
    global _default
    # Lock-free fast path: this sits on every request of the engine
    # server; after first initialization the lock would only serialize a
    # read.
    d = _default
    if d is not None:
        return d
    with _default_lock:
        if _default is None:
            _default = Tracer(
                endpoint=os.environ.get("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT")
                or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
            )
        return _default
