"""The object-store leg of the cluster KV-sharing tier: `KVSpillStore`.
Counterpart of `KVSpillStore` in kubeai_tpu/objstore.py, with its
in-memory backend only. The object-store clients (gs://, s3://, oss://)
are not ported; a non-empty URL raises, naming the ROADMAP item that
brings them."""

from __future__ import annotations

from collections import OrderedDict


class KVSpillStore:
    """Spill/fill store for evicted hot-prefix KV pages. Each entry is one
    serialized single-page `KVPageExport` blob keyed by its chain hash
    (hex), so a fill is a plain get and needs no index.

    The in-memory LRU (url="") keeps spill a node-local optimization with
    a hard byte cap. Every method is best-effort by contract: the callers
    (the eviction hook, the fetch fallback) treat any failure as a miss
    and recompute."""

    def __init__(self, url: str = "", max_bytes: int = 256 << 20):
        if url:
            raise NotImplementedError(
                f"KV spill to an object store ({url!r}) is not ported yet "
                "(ROADMAP A item 9); an empty URL spills in memory"
            )
        self.url = url
        self.max_bytes = max_bytes
        self._mem: "OrderedDict[str, bytes]" = OrderedDict()
        self._mem_bytes = 0
        self.puts = 0
        self.gets = 0
        self.hits = 0

    def put(self, hash_hex: str, blob: bytes) -> None:
        self.puts += 1
        if len(blob) > self.max_bytes:
            return
        old = self._mem.pop(hash_hex, None)
        if old is not None:
            self._mem_bytes -= len(old)
        self._mem[hash_hex] = blob
        self._mem_bytes += len(blob)
        while self._mem_bytes > self.max_bytes and self._mem:
            _h, dropped = self._mem.popitem(last=False)
            self._mem_bytes -= len(dropped)

    def get(self, hash_hex: str) -> bytes | None:
        self.gets += 1
        blob = self._mem.get(hash_hex)
        if blob is not None:
            self._mem.move_to_end(hash_hex)
            self.hits += 1
        return blob
