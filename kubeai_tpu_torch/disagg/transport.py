"""Handoff transports: how a prefilled request's KV reaches a decode
engine. A copy of kubeai_tpu/disagg/transport.py.

Two implementations behind one `send(handoff, ...) -> TransferResult`
shape:

  * `InProcessTransport` — hands the KVHandoff object straight to a
    `HandoffStore` (the same store a decode `EngineServer` admits from).
    Zero-copy, for tests and single-process topologies.
  * `HTTPTransport` — serializes and POSTs to the decode engine's
    `POST /v1/kv/import` with a CHUNKED upload (KV blobs are tens to
    hundreds of MB at production sequence lengths; chunking keeps the
    sender's memory flat at `chunk_bytes` past the one serialized copy
    and lets the receiver start draining immediately).

Both record transfer bytes + wall seconds so the caller can feed the
engine's kv-transfer metrics.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import uuid
from collections import OrderedDict

from kubeai_tpu_torch.disagg.handoff import KVHandoff, serialize


class TransferError(RuntimeError):
    """The decode side refused or the connection failed mid-transfer."""


@dataclasses.dataclass(frozen=True)
class TransferResult:
    handoff_id: str
    bytes: int
    seconds: float


class HandoffStore:
    """Bounded id → KVHandoff buffer on the decode side. Entries are
    consumed exactly once (pop) by the generate request that references
    them; the cap evicts oldest-first so an orchestrator that crashed
    between the two hops cannot leak pool-sized blobs forever."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, KVHandoff]" = OrderedDict()
        self.evicted = 0

    def put(self, handoff: KVHandoff, handoff_id: str | None = None) -> str:
        hid = handoff_id or f"kvh-{uuid.uuid4().hex[:16]}"
        with self._lock:
            self._entries[hid] = handoff
            self._entries.move_to_end(hid)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evicted += 1
        return hid

    def pop(self, handoff_id: str) -> KVHandoff | None:
        with self._lock:
            return self._entries.pop(handoff_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class InProcessTransport:
    """Deliver handoffs to a local HandoffStore (tests, co-located
    prefill/decode engines)."""

    def __init__(self, store: HandoffStore):
        self.store = store

    def send(
        self, handoff: KVHandoff, handoff_id: str | None = None
    ) -> TransferResult:
        t0 = time.monotonic()
        hid = self.store.put(handoff, handoff_id)
        return TransferResult(
            handoff_id=hid,
            bytes=handoff.nbytes(),
            seconds=time.monotonic() - t0,
        )


class HTTPTransport:
    """Push a serialized handoff to `POST http://{addr}/v1/kv/import`
    with Transfer-Encoding: chunked."""

    def __init__(
        self,
        addr: str,
        timeout: float = 30.0,
        chunk_bytes: int = 256 * 1024,
    ):
        self.addr = addr
        self.timeout = timeout
        self.chunk_bytes = max(1, chunk_bytes)

    def send(
        self, handoff: KVHandoff, handoff_id: str | None = None
    ) -> TransferResult:
        blob = serialize(handoff)
        host, _, port = self.addr.partition(":")
        t0 = time.monotonic()
        conn = http.client.HTTPConnection(
            host, int(port or 80), timeout=self.timeout
        )
        try:
            conn.putrequest("POST", "/v1/kv/import")
            conn.putheader("Content-Type", "application/x-kv-handoff")
            conn.putheader("Transfer-Encoding", "chunked")
            if handoff_id:
                conn.putheader("X-Handoff-Id", handoff_id)
            conn.endheaders()
            for off in range(0, len(blob), self.chunk_bytes):
                chunk = blob[off : off + self.chunk_bytes]
                conn.send(f"{len(chunk):x}\r\n".encode())
                conn.send(chunk)
                conn.send(b"\r\n")
            conn.send(b"0\r\n\r\n")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                msg = body.decode(errors="replace")[:500]
                raise TransferError(
                    f"kv import to {self.addr} failed: HTTP {resp.status} "
                    f"{msg}"
                )
            try:
                payload = json.loads(body or b"{}")
            except json.JSONDecodeError:
                payload = {}
            hid = str(payload.get("handoff_id") or handoff_id or "")
            if not hid:
                raise TransferError(
                    f"kv import to {self.addr} returned no handoff_id"
                )
            return TransferResult(
                handoff_id=hid,
                bytes=len(blob),
                seconds=time.monotonic() - t0,
            )
        except (OSError, http.client.HTTPException) as e:
            raise TransferError(
                f"kv import to {self.addr} failed: {e}"
            ) from e
        finally:
            conn.close()


def read_chunked_body(rfile, max_bytes: int = 0) -> bytes:
    """Parse a Transfer-Encoding: chunked request body off `rfile`
    (http.server does NOT decode chunked uploads). `max_bytes` > 0 caps
    the accepted size — the CRD's transfer limit — raising TransferError
    past it so a runaway upload cannot balloon the receiver."""
    parts: list[bytes] = []
    total = 0
    while True:
        size_line = rfile.readline(64)
        if not size_line:
            raise TransferError("truncated chunked upload (no size line)")
        try:
            size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
        except ValueError as e:
            raise TransferError(
                f"bad chunk size line {size_line!r}"
            ) from e
        if size == 0:
            # Trailer section ends with a blank line.
            while True:
                line = rfile.readline(1024)
                if line in (b"\r\n", b"\n", b""):
                    break
            return b"".join(parts)
        total += size
        if max_bytes and total > max_bytes:
            raise TransferError(
                f"chunked upload exceeds the {max_bytes}-byte transfer limit"
            )
        chunk = rfile.read(size)
        if len(chunk) != size:
            raise TransferError("truncated chunked upload (short chunk)")
        parts.append(chunk)
        rfile.read(2)  # trailing CRLF
