"""Paged KV cache: block-table paging over a shared page pool.
Counterpart of kubeai_tpu/engine/paged_cache.py.

Layout:
  k_pages / v_pages: [NL, n_pages, page_size, KVH, D] torch tensors, or
                     int8 QuantizedPools (ops/kv_quant.py: int8 pages and
                     f32 scales [NL, n_pages, page_size, KVH])
  block_tables:      [slots, max_pages_per_slot] int32 (page ids; -1 free)
  host allocator:    free-list of page ids (bookkeeping on the host)

The pools are torch tensors that the engine updates IN PLACE (index
writes through the block tables); the JAX version is functional and
returns new arrays. The allocator is host-side Python, copied from the
JAX package unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from kubeai_tpu_torch.ops.kv_quant import (
    QuantizedPool,
    dequantize_kv,
    make_quantized_pool,
)


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor | QuantizedPool  # [NL, n_pages, page, KVH, D]
    v_pages: torch.Tensor | QuantizedPool
    block_tables: torch.Tensor  # [slots, max_pages] int32, -1 = unallocated

    @property
    def quantized(self) -> bool:
        return isinstance(self.k_pages, QuantizedPool)

    @property
    def pages_shape(self) -> tuple:
        """The page-array shape, quantized or not."""
        return tuple(self.k_pages.shape)

    def nbytes(self) -> int:
        """Resident pool bytes (pages, and scales when quantized)."""
        return int(self.k_pages.nbytes + self.v_pages.nbytes)

    @staticmethod
    def create(
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_slots: int,
        max_seq_len: int,
        kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ) -> "PagedKVCache":
        max_pages = -(-max_seq_len // page_size)
        shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
        if dtype in (torch.int8, "int8"):
            k_pages = make_quantized_pool(shape, device)
            v_pages = make_quantized_pool(shape, device)
        else:
            k_pages = torch.zeros(shape, dtype=dtype, device=device)
            v_pages = torch.zeros(shape, dtype=dtype, device=device)
        return PagedKVCache(
            k_pages=k_pages,
            v_pages=v_pages,
            block_tables=torch.full(
                (num_slots, max_pages), -1, dtype=torch.int32, device=device
            ),
        )


class SequenceTooLong(RuntimeError):
    pass


class PageAllocator:
    """Host-side free-list with optional prefix-cache sharing. The device
    never sees allocation — only the resulting block tables.

    Page 0 is RESERVED as a scratch page and never handed out: jit-safe
    ops clamp unallocated block-table entries (-1) to 0, so reads hit
    masked junk and writes land in scratch — never in a live sequence.

    Prefix caching (the vLLM automatic-prefix-cache idea, host-side
    bookkeeping only): immutable full-page prompt prefixes register under
    a content-hash chain. A later prompt whose leading pages hash to a
    registered chain ADOPTS those pages read-only instead of recomputing
    them — pages then carry a slot refcount, and pages whose refcount
    drops to zero park in an LRU idle pool (still lookupable) that the
    free path evicts from only when the free list runs dry. The reference
    exploits engine prefix caches only ACROSS replicas (CHWBL routing,
    docs/benchmarks/prefix-aware-load-balancing.md); this gives the
    in-tree engine the per-replica half of that headline."""

    def __init__(
        self, num_pages: int, page_size: int,
        max_pages_per_slot: int | None = None,
    ):
        from collections import OrderedDict

        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self._free = list(range(1, num_pages))  # page 0 reserved
        # slot -> allocated page ids, in order.
        self._owned: dict[int, list[int]] = {}
        # Prefix-cache state. A page is in exactly one of: _free, owned
        # (refcount >= 1), or _idle (refcount 0 but still registered).
        self._ref: dict[int, int] = {}
        self._hash_to_page: dict[bytes, int] = {}
        self._page_to_hash: dict[int, bytes] = {}
        self._idle: "OrderedDict[int, None]" = OrderedDict()  # LRU -> MRU
        # Optional spill hook: called as on_evict(page, hash) just before
        # an idle page's registration is destroyed by eviction, while the
        # device page still holds the registered content. Wired by the
        # engine when KV objstore spill is enabled; must never raise.
        self.on_evict = None

    @property
    def free_pages(self) -> int:
        """Pages an ensure() can still obtain (idle cached pages are
        reclaimable by eviction)."""
        return len(self._free) + len(self._idle)

    @property
    def cached_idle_pages(self) -> int:
        return len(self._idle)

    def pages_for(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, []))

    def _take_free(self) -> int | None:
        if self._free:
            return self._free.pop()
        if self._idle:
            # Eviction MUST strip both hash mappings atomically with the
            # idle-pool removal: once holdings are published cluster-wide
            # a stale _hash_to_page entry would let lookup() adopt a page
            # whose content has been overwritten by its new owner —
            # silently corrupting token-identity. Regression-tested in
            # tests/unit/test_paged_cache.py.
            page, _ = self._idle.popitem(last=False)  # evict LRU
            h = self._page_to_hash.pop(page)
            del self._hash_to_page[h]
            if self.on_evict is not None:
                try:
                    self.on_evict(page, h)
                except Exception:
                    pass
            del self._ref[page]
            return page
        return None

    def ensure(self, slot: int, length: int) -> list[int]:
        """Grow slot's allocation to cover `length` tokens. Returns the page
        list. Raises OutOfPages when the pool is exhausted (pages taken in
        the failed call are rolled back, so a deferred admission holds
        nothing) and SequenceTooLong past the per-slot block-table cap."""
        need = -(-length // self.page_size)
        if self.max_pages_per_slot is not None and need > self.max_pages_per_slot:
            raise SequenceTooLong(
                f"{length} tokens need {need} pages > per-slot cap "
                f"{self.max_pages_per_slot}"
            )
        owned = self._owned.setdefault(slot, [])
        # Capacity check BEFORE touching the idle cache: _take_free
        # destroys an evicted page's hash entries, so an allocation that
        # cannot succeed must not strip the cache on its way to the
        # OutOfPages it was always going to raise.
        if need - len(owned) > len(self._free) + len(self._idle):
            raise OutOfPages(
                f"page pool exhausted ({need} needed for slot {slot})"
            )
        taken: list[int] = []
        while len(owned) + len(taken) < need:
            page = self._take_free()
            if page is None:  # unreachable given the check above
                self._free.extend(taken)
                raise OutOfPages(
                    f"page pool exhausted ({need} needed for slot {slot})"
                )
            taken.append(page)
        for page in taken:
            self._ref[page] = 1
        owned.extend(taken)
        return list(owned)

    def _decref(self, page: int) -> None:
        n = self._ref.get(page, 1) - 1
        if n > 0:
            self._ref[page] = n
        elif page in self._page_to_hash:
            # Still registered: park in the idle LRU, content intact.
            self._ref[page] = 0
            self._idle[page] = None
        else:
            self._ref.pop(page, None)
            self._free.append(page)

    def release(self, slot: int) -> None:
        for page in self._owned.pop(slot, []):
            self._decref(page)

    # ---- prefix cache ------------------------------------------------------

    def lookup(self, hashes: list[bytes]) -> list[int]:
        """Longest registered prefix of the hash chain -> its pages, in
        order. Hit pages are NOT reserved — call adopt() to take refs."""
        pages: list[int] = []
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def adopt(self, slot: int, pages: list[int]) -> None:
        """Prepend shared pages to slot's allocation (before any ensure()
        growth), taking a reference on each; idle pages come off the LRU."""
        owned = self._owned.setdefault(slot, [])
        assert not owned, "adopt() must seed an empty slot"
        for page in pages:
            self._ref[page] = self._ref.get(page, 0) + 1
            self._idle.pop(page, None)
        owned.extend(pages)

    def unadopt(self, slot: int) -> None:
        """Roll back an adopt() whose follow-up ensure() failed."""
        for page in self._owned.pop(slot, []):
            self._decref(page)

    def register(self, hashes: list[bytes], pages: list[int]) -> None:
        """Publish a slot's immutable full prompt pages under their chain
        hashes. First registration of a hash wins (concurrent identical
        prompts produce identical content anyway); a page already
        registered under another hash keeps its original entry."""
        for h, page in zip(hashes, pages):
            if h in self._hash_to_page or page in self._page_to_hash:
                continue
            self._hash_to_page[h] = page
            self._page_to_hash[page] = h

    def holdings(self) -> list[bytes]:
        """Every chain hash currently registered (owned-and-registered or
        parked idle) — the replica's advertisable prefix-cache contents.
        Advisory only: routing built on this is a hint; admission always
        re-verifies through lookup(), so staleness can cost performance
        but never correctness."""
        return list(self._hash_to_page.keys())

    def seed_unowned(self, hashes: list[bytes]) -> list[int] | None:
        """Allocate pages for externally fetched prefix content (peer KV
        fetch / objstore fill): one page per NOVEL hash, registered and
        parked straight into the idle LRU with refcount 0 — no slot owns
        them; the next admission adopts them through the ordinary
        lookup()/adopt() path. Returns the page ids aligned with `hashes`
        (None entries mark hashes that were already registered locally and
        need no write), or None if the pool cannot supply every novel page
        (partial seeding is rolled back so a failed fetch holds nothing).
        """
        # Novelty is decided ONCE, before any page is taken: taking pages
        # can evict idle entries, which may deregister a hash classified
        # as already-held — it must still consume no page (its chain link
        # just breaks, shortening future lookups; never a correctness
        # issue because admission re-verifies content by hash).
        novel = {h for h in hashes if h not in self._hash_to_page}
        taken: list[int] = []
        for _ in range(len(novel)):
            page = self._take_free()
            if page is None:
                self._free.extend(taken)
                return None
            taken.append(page)
        it = iter(taken)
        out: list[int | None] = []
        for h in hashes:
            if h not in novel:
                out.append(None)
                continue
            page = next(it)
            self._hash_to_page[h] = page
            self._page_to_hash[page] = h
            self._ref[page] = 0
            self._idle[page] = None
            out.append(page)
        return out


def gather_slot_kv(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """The virtual contiguous view [NL, slots, L_max, KVH, D] of every
    slot, L_max = max_pages_per_slot * page_size; quantized pools
    dequantize to bf16. Unallocated pages (-1) read scratch page 0. The
    functional reference: the decode kernels read pages in place."""
    bt = cache.block_tables.long().clamp(min=0)
    if cache.quantized:
        k = dequantize_kv(cache.k_pages.q8[:, bt], cache.k_pages.scale[:, bt])
        v = dequantize_kv(cache.v_pages.q8[:, bt], cache.v_pages.scale[:, bt])
    else:
        k = cache.k_pages[:, bt]  # [NL, slots, max_pages, page, KVH, D]
        v = cache.v_pages[:, bt]
    nl, slots, mp, page, kvh, d = k.shape
    return (k.reshape(nl, slots, mp * page, kvh, d),
            v.reshape(nl, slots, mp * page, kvh, d))


def set_block_table(
    block_tables: torch.Tensor, slot: int, pages: list[int]
) -> torch.Tensor:
    """Write slot's row (pages, then -1) in place; returns the table."""
    row = torch.full(
        (block_tables.shape[1],), -1, dtype=torch.int32,
        device=block_tables.device,
    )
    if pages:
        row[: len(pages)] = torch.as_tensor(pages, dtype=torch.int32)
    block_tables[slot] = row
    return block_tables
