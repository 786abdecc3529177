"""KV handoff: the wire format of a prefilled request. A copy of
kubeai_tpu/disagg/handoff.py: the magic, the header JSON and the body
layout are byte-identical, so a JAX replica and a port replica read each
other's blobs. One difference: bfloat16 pages travel on the host as their
raw 16-bit words, numpy uint16 (numpy has no bfloat16 and the port does
not depend on ml_dtypes); the header still says "bfloat16", and the
engine turns the words back into a torch.bfloat16 tensor by a view, never
by a cast.

A `KVHandoff` is everything a decode-role engine needs to resume a
request at its FIRST decode step without re-running prefill: the token
ids (prompt), the first sampled token, the per-layer paged KV written by
prefill, the sampling state (seed, temperature, top-k/p, budget) and the
page-aligned prefix-hash chain (so a decode engine with the prefix cache
enabled can publish the imported pages).

Serialization is dtype- and page-layout-preserving: the K/V pages ship
as raw buffer bytes in the exporting pool's dtype and page size, with
geometry in a JSON header. Import re-pages into the receiving pool's own
page size by flattening to token order first — the VALUES are copied
bit-exactly either way, which is what makes a disaggregated stream
token-identical to a unified run (same KV bytes + same seeded sampler +
same decode graph ⇒ same logits ⇒ same tokens).

Wire format (all integers little-endian):

    b"KVH1" | u32 header_len | header JSON (utf-8) | K bytes | V bytes

    header: version, dtype, num_layers, kv_heads, head_dim, page_size,
            n_pages, plen, token_ids, first_token, first_finish,
            sampling {seed, temperature, top_k, top_p, max_tokens, stop},
            prefix_hashes (hex), adapter, client, priority, model,
            kv_quant (int8 pools only)

K/V arrays are [num_layers, n_pages, page_size, kv_heads, head_dim]
packed pages covering exactly the sequence (the partial last page ships
whole; junk past `plen` is masked by position on the decode side exactly
as it is in the exporting pool).

Quantized pools (dtype "int8", ops/kv_quant.py): the header carries a
`kv_quant` block {"scheme": "int8-token-head", "scale_dtype": "float32"}
and the body grows two trailing scale arrays,

    ... | K bytes | V bytes | K scales | V scales

each [num_layers, n_pages, page_size, kv_heads] f32 — the per-token-
per-head scales travel WITH their pages, so a quantized handoff or page
export round-trips byte-exactly (the importer scatters the int8 values
and scales verbatim; nothing is ever re-quantized on the wire). A peer
whose pool dtype differs must refuse with `HandoffError` — casting in
either direction would silently alter KV values the exporter's chain
hashes and token stream vouch for.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

MAGIC = b"KVH1"
VERSION = 1

# Partial-chain page export (the cluster KV-sharing tier): same framing
# as KVH1 but a distinct magic, so the two blob kinds can never be
# confused — a KVP1 blob carries CACHE CONTENT (idle-pool prefix pages
# keyed by their hash chain), not a request in flight.
PAGES_MAGIC = b"KVP1"


class HandoffError(ValueError):
    """Malformed or incompatible handoff blob."""


# The one quantization scheme the wire speaks (ops/kv_quant.py): int8
# values with per-token-per-head float32 scales. The header block names
# it explicitly so a future coarser scheme can't be confused for it.
KV_QUANT_SCHEME = "int8-token-head"
_SCALE_DTYPE = np.dtype(np.float32)


def _quant_header(dtype: str, k_scales, v_scales) -> dict | None:
    """Validate scale presence against the dtype and build the header
    block (None for unquantized blobs — the wire stays v1-compatible)."""
    if dtype == "int8":
        if k_scales is None or v_scales is None:
            raise HandoffError("int8 KV requires k_scales/v_scales")
        return {"scheme": KV_QUANT_SCHEME, "scale_dtype": "float32"}
    if k_scales is not None or v_scales is not None:
        raise HandoffError(
            f"scales supplied for non-quantized dtype {dtype!r}"
        )
    return None


def _check_quant_block(header: dict, kind: str) -> bool:
    """True when the blob is quantized; typed refusal on any mismatch
    between the dtype and the kv_quant block."""
    quant = header.get("kv_quant")
    if header.get("dtype") == "int8":
        if not isinstance(quant, dict):
            raise HandoffError(f"int8 {kind} is missing its kv_quant block")
        if quant.get("scheme") != KV_QUANT_SCHEME:
            raise HandoffError(
                f"unsupported KV quant scheme {quant.get('scheme')!r}"
            )
        if quant.get("scale_dtype", "float32") != "float32":
            raise HandoffError(
                f"unsupported scale dtype {quant.get('scale_dtype')!r}"
            )
        return True
    if quant is not None:
        raise HandoffError(
            f"kv_quant block on non-int8 {kind} "
            f"(dtype {header.get('dtype')!r})"
        )
    return False


# The host dtype of each wire dtype whose numpy name differs: bfloat16
# words are carried as uint16 (same width, same bytes).
_HOST_DTYPES = {"bfloat16": np.dtype(np.uint16)}


def _resolve_dtype(name: str) -> np.dtype:
    """Host dtype of a wire dtype name: bfloat16 as its raw uint16 words,
    every other name as numpy's own dtype."""
    if name in _HOST_DTYPES:
        return _HOST_DTYPES[name]
    try:
        return np.dtype(name)
    except TypeError as e:
        raise HandoffError(f"unknown KV dtype {name!r}") from e


@dataclasses.dataclass
class KVHandoff:
    token_ids: list[int]  # the prefilled sequence (prompt tokens)
    first_token: int  # sampled at prefill; decode resumes after it
    first_finish: str  # "" | "stop" | "length": finished at token one
    page_size: int
    dtype: str  # "bfloat16" | "float32" | ...
    # [NL, n_pages, page, KVH, D]; bfloat16 pages as uint16 words.
    k_pages: np.ndarray
    v_pages: np.ndarray
    # Sampling state: the decode engine continues the SAME seeded sampler
    # the prefill engine's first sample came from.
    seed: int
    temperature: float
    top_k: int
    top_p: float
    max_tokens: int
    stop: tuple[str, ...] = ()
    # Page-aligned content-hash chain (hex) over the prompt — lets a
    # prefix-cache-enabled decode pool publish the imported pages.
    prefix_hashes: tuple[str, ...] = ()
    adapter: str = ""
    client: str = ""
    priority: str = ""
    model: str = ""
    # Int8 pools only: per-token-per-head f32 scales riding with their
    # pages, [NL, n_pages, page, KVH]. None for unquantized handoffs.
    k_scales: np.ndarray | None = None
    v_scales: np.ndarray | None = None

    @property
    def plen(self) -> int:
        return len(self.token_ids)

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    def contiguous_kv(self) -> tuple[np.ndarray, np.ndarray]:
        """Flatten the packed pages to token order [NL, plen, KVH, D] —
        the page-size-independent view import scatters from."""
        nl, n_pages, page, kvh, d = self.k_pages.shape
        k = self.k_pages.reshape(nl, n_pages * page, kvh, d)[:, : self.plen]
        v = self.v_pages.reshape(nl, n_pages * page, kvh, d)[:, : self.plen]
        return k, v

    def contiguous_scales(self) -> tuple[np.ndarray, np.ndarray]:
        """Token-order view [NL, plen, KVH] of the scale arrays (int8
        handoffs only) — scattered alongside contiguous_kv()."""
        nl, n_pages, page, kvh = self.k_scales.shape
        ks = self.k_scales.reshape(nl, n_pages * page, kvh)[:, : self.plen]
        vs = self.v_scales.reshape(nl, n_pages * page, kvh)[:, : self.plen]
        return ks, vs

    def nbytes(self) -> int:
        n = int(self.k_pages.nbytes + self.v_pages.nbytes)
        if self.quantized:
            n += int(self.k_scales.nbytes + self.v_scales.nbytes)
        return n


def serialize(h: KVHandoff) -> bytes:
    nl, n_pages, page, kvh, d = h.k_pages.shape
    if h.v_pages.shape != h.k_pages.shape:
        raise HandoffError(
            f"K/V shape mismatch: {h.k_pages.shape} vs {h.v_pages.shape}"
        )
    quant = _quant_header(h.dtype, h.k_scales, h.v_scales)
    if quant is not None and h.k_scales.shape != (nl, n_pages, page, kvh):
        raise HandoffError(
            f"scale shape {h.k_scales.shape} does not match pages "
            f"{(nl, n_pages, page, kvh)}"
        )
    header = {
        "version": VERSION,
        "dtype": h.dtype,
        "num_layers": nl,
        "n_pages": n_pages,
        "page_size": page,
        "kv_heads": kvh,
        "head_dim": d,
        "plen": h.plen,
        "token_ids": list(map(int, h.token_ids)),
        "first_token": int(h.first_token),
        "first_finish": h.first_finish,
        "sampling": {
            "seed": int(h.seed),
            "temperature": float(h.temperature),
            "top_k": int(h.top_k),
            "top_p": float(h.top_p),
            "max_tokens": int(h.max_tokens),
            "stop": list(h.stop),
        },
        "prefix_hashes": list(h.prefix_hashes),
        "adapter": h.adapter,
        "client": h.client,
        "priority": h.priority,
        "model": h.model,
    }
    if quant is not None:
        header["kv_quant"] = quant
    hdr = json.dumps(header).encode()
    k = np.ascontiguousarray(h.k_pages)
    v = np.ascontiguousarray(h.v_pages)
    parts = [MAGIC, struct.pack("<I", len(hdr)), hdr, k.tobytes(), v.tobytes()]
    if quant is not None:
        parts.append(
            np.ascontiguousarray(h.k_scales, _SCALE_DTYPE).tobytes()
        )
        parts.append(
            np.ascontiguousarray(h.v_scales, _SCALE_DTYPE).tobytes()
        )
    return b"".join(parts)


def deserialize(blob: bytes) -> KVHandoff:
    if len(blob) < 8 or blob[:4] != MAGIC:
        raise HandoffError("not a KV handoff blob (bad magic)")
    (hdr_len,) = struct.unpack("<I", blob[4:8])
    if len(blob) < 8 + hdr_len:
        raise HandoffError("truncated handoff header")
    try:
        header = json.loads(blob[8 : 8 + hdr_len])
    except json.JSONDecodeError as e:
        raise HandoffError(f"bad handoff header: {e}") from e
    if header.get("version") != VERSION:
        raise HandoffError(
            f"unsupported handoff version {header.get('version')!r}"
        )
    dtype = _resolve_dtype(header["dtype"])
    quantized = _check_quant_block(header, "handoff")
    shape = (
        header["num_layers"],
        header["n_pages"],
        header["page_size"],
        header["kv_heads"],
        header["head_dim"],
    )
    count = int(np.prod(shape))
    scale_count = int(np.prod(shape[:-1])) if quantized else 0
    body = blob[8 + hdr_len :]
    expected = 2 * count * dtype.itemsize
    expected += 2 * scale_count * _SCALE_DTYPE.itemsize
    if len(body) != expected:
        raise HandoffError(
            f"handoff body is {len(body)} bytes, expected {expected}"
        )
    k = np.frombuffer(body[: count * dtype.itemsize], dtype=dtype).reshape(
        shape
    )
    v = np.frombuffer(
        body[count * dtype.itemsize : 2 * count * dtype.itemsize],
        dtype=dtype,
    ).reshape(shape)
    k_scales = v_scales = None
    if quantized:
        off = 2 * count * dtype.itemsize
        sz = scale_count * _SCALE_DTYPE.itemsize
        k_scales = np.frombuffer(
            body[off : off + sz], dtype=_SCALE_DTYPE
        ).reshape(shape[:-1])
        v_scales = np.frombuffer(
            body[off + sz :], dtype=_SCALE_DTYPE
        ).reshape(shape[:-1])
    plen = int(header["plen"])
    if not 0 < plen <= header["n_pages"] * header["page_size"]:
        raise HandoffError(f"plen {plen} outside shipped pages")
    s = header.get("sampling") or {}
    return KVHandoff(
        token_ids=[int(t) for t in header["token_ids"]],
        first_token=int(header["first_token"]),
        first_finish=str(header.get("first_finish", "")),
        page_size=int(header["page_size"]),
        dtype=str(header["dtype"]),
        k_pages=k,
        v_pages=v,
        seed=int(s.get("seed", 0)),
        temperature=float(s.get("temperature", 1.0)),
        top_k=int(s.get("top_k", 0)),
        top_p=float(s.get("top_p", 1.0)),
        max_tokens=int(s.get("max_tokens", 16)),
        stop=tuple(s.get("stop") or ()),
        prefix_hashes=tuple(header.get("prefix_hashes") or ()),
        adapter=str(header.get("adapter", "")),
        client=str(header.get("client", "")),
        priority=str(header.get("priority", "")),
        model=str(header.get("model", "")),
        k_scales=k_scales,
        v_scales=v_scales,
    )


@dataclasses.dataclass
class KVPageExport:
    """A run of consecutive prefix pages keyed by their hash chain — the
    transfer unit of the cluster KV-sharing tier. Unlike `KVHandoff`
    (one request's full state), this carries only CACHE CONTENT: every
    shipped page is a FULL page whose bytes are immutable under the
    chain hash, so the importer can park them unowned in its idle pool
    and let ordinary admission adopt them. An empty export (zero pages)
    is valid and round-trips — it is how a holder answers "I no longer
    hold any of that chain"."""

    prefix_hashes: tuple[str, ...]  # hex chain, one hash per page
    page_size: int
    dtype: str
    k_pages: np.ndarray  # [NL, n_pages, page, KVH, D]
    v_pages: np.ndarray
    model: str = ""
    # Int8 pools only: [NL, n_pages, page, KVH] f32 scales.
    k_scales: np.ndarray | None = None
    v_scales: np.ndarray | None = None

    @property
    def n_pages(self) -> int:
        return int(self.k_pages.shape[1])

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    def nbytes(self) -> int:
        n = int(self.k_pages.nbytes + self.v_pages.nbytes)
        if self.quantized:
            n += int(self.k_scales.nbytes + self.v_scales.nbytes)
        return n


def serialize_pages(e: KVPageExport) -> bytes:
    nl, n_pages, page, kvh, d = e.k_pages.shape
    if e.v_pages.shape != e.k_pages.shape:
        raise HandoffError(
            f"K/V shape mismatch: {e.k_pages.shape} vs {e.v_pages.shape}"
        )
    if len(e.prefix_hashes) != n_pages:
        raise HandoffError(
            f"{len(e.prefix_hashes)} hashes for {n_pages} pages"
        )
    quant = _quant_header(e.dtype, e.k_scales, e.v_scales)
    if quant is not None and e.k_scales.shape != (nl, n_pages, page, kvh):
        raise HandoffError(
            f"scale shape {e.k_scales.shape} does not match pages "
            f"{(nl, n_pages, page, kvh)}"
        )
    header = {
        "version": VERSION,
        "dtype": e.dtype,
        "num_layers": nl,
        "n_pages": n_pages,
        "page_size": page,
        "kv_heads": kvh,
        "head_dim": d,
        "prefix_hashes": list(e.prefix_hashes),
        "model": e.model,
    }
    if quant is not None:
        header["kv_quant"] = quant
    hdr = json.dumps(header).encode()
    k = np.ascontiguousarray(e.k_pages)
    v = np.ascontiguousarray(e.v_pages)
    parts = [
        PAGES_MAGIC, struct.pack("<I", len(hdr)), hdr, k.tobytes(),
        v.tobytes(),
    ]
    if quant is not None:
        parts.append(
            np.ascontiguousarray(e.k_scales, _SCALE_DTYPE).tobytes()
        )
        parts.append(
            np.ascontiguousarray(e.v_scales, _SCALE_DTYPE).tobytes()
        )
    return b"".join(parts)


def deserialize_pages(blob: bytes) -> KVPageExport:
    if len(blob) < 8 or blob[:4] != PAGES_MAGIC:
        raise HandoffError("not a KV page-export blob (bad magic)")
    (hdr_len,) = struct.unpack("<I", blob[4:8])
    if len(blob) < 8 + hdr_len:
        raise HandoffError("truncated page-export header")
    try:
        header = json.loads(blob[8 : 8 + hdr_len])
    except json.JSONDecodeError as e:
        raise HandoffError(f"bad page-export header: {e}") from e
    if header.get("version") != VERSION:
        raise HandoffError(
            f"unsupported page-export version {header.get('version')!r}"
        )
    dtype = _resolve_dtype(header["dtype"])
    shape = (
        header["num_layers"],
        header["n_pages"],
        header["page_size"],
        header["kv_heads"],
        header["head_dim"],
    )
    count = int(np.prod(shape))
    quantized = _check_quant_block(header, "page-export")
    scale_count = int(np.prod(shape[:-1])) if quantized else 0
    body = blob[8 + hdr_len :]
    expected = 2 * count * dtype.itemsize + 2 * scale_count * 4
    if len(body) != expected:
        raise HandoffError(
            f"page-export body is {len(body)} bytes, expected {expected}"
        )
    k = np.frombuffer(body[: count * dtype.itemsize], dtype=dtype).reshape(
        shape
    )
    v = np.frombuffer(
        body[count * dtype.itemsize : 2 * count * dtype.itemsize],
        dtype=dtype,
    ).reshape(shape)
    k_scales = v_scales = None
    if quantized:
        off = 2 * count * dtype.itemsize
        k_scales = np.frombuffer(
            body[off : off + scale_count * 4], dtype=_SCALE_DTYPE
        ).reshape(shape[:-1])
        v_scales = np.frombuffer(
            body[off + scale_count * 4 :], dtype=_SCALE_DTYPE
        ).reshape(shape[:-1])
    hashes = tuple(header.get("prefix_hashes") or ())
    if len(hashes) != header["n_pages"]:
        raise HandoffError(
            f"{len(hashes)} hashes for {header['n_pages']} pages"
        )
    return KVPageExport(
        prefix_hashes=hashes,
        page_size=int(header["page_size"]),
        dtype=str(header["dtype"]),
        k_pages=k,
        v_pages=v,
        model=str(header.get("model", "")),
        k_scales=k_scales,
        v_scales=v_scales,
    )
