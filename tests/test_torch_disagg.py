"""Disaggregated prefill/decode in kubeai_tpu_torch, against the JAX
package, on the CPU: the port's counterpart of tests/unit/test_disagg.py.

- The wire: the port's `serialize` and `serialize_pages` are byte for
  byte the JAX package's for the same handoff or page export, in float32,
  bfloat16 (the port carries bf16 pages as uint16 words; the JAX side's
  arrays are built with ml_dtypes) and int8 with scales; each side reads
  the other's blobs to equal arrays; malformed blobs get the JAX errors;
  `HandoffStore` pops once and evicts.
- The engine: for the same prompt the port's `export_handoff` gives the
  JAX engine's first token, prefix hashes and sampling state, and pages
  equal to the JAX engine's within 1e-6 (f32 prefill in XLA and in torch
  differs by an ulp; within the port, exported pages are bit-equal to the
  pool's, and an import writes the blob's bits). Importing it continues
  token-identically to the JAX engine's unified stream: greedy and
  seeded, per_layer, fused, speculate=2 and a chunked export
  (prefill_chunk=8), overlap on and off. A JAX handoff continues in a
  port engine and a port handoff in a JAX engine. Capacity gives
  EngineBusy and a first token that finishes takes no slot, as in JAX.
- Over HTTP: a JAX prefill server feeds a port decode server, a port
  prefill server feeds a JAX server, and a port feeds a port; streamed
  and unary, the text equals the JAX unified server's. The reference
  proxy routes a Disaggregation(enabled=True) model over pods labelled
  with POD_ROLE_LABEL, in both directions, to the same text. Refusals,
  /v1/state and the transfer metrics answer as the JAX servers do.

Weights: the same tiny f32 llama on both sides (params_from_numpy).
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu.crd import metadata as md
from kubeai_tpu.crd.model import Disaggregation, LoadBalancing, Model, ModelSpec
from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.disagg import transport as jtransport
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.engine import EngineBusy as JEngineBusy
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.metrics import Metrics
from kubeai_tpu.metrics import registry as jregistry
from kubeai_tpu.models import llama as jl
from kubeai_tpu.operator.k8s.store import KubeStore
from kubeai_tpu.routing.loadbalancer import LoadBalancer
from kubeai_tpu.routing.modelclient import ModelClient
from kubeai_tpu.routing.proxy import ModelProxy
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.disagg.transport import HandoffStore, InProcessTransport
from kubeai_tpu_torch.engine import Engine, EngineBusy, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.engine import (
    EngineDraining,
    _pages_to_device,
    _pages_to_host,
)
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

pytestmark = pytest.mark.disagg

TOK = ByteTokenizer()
PROMPT = "the quick brown fox jumps over"
BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4)
LAYOUTS = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=2, spec_adaptive=False),
    # The 30-token prompt is exported through four staged chunks.
    "chunked": dict(prefill_chunk=8),
}
SAMPLING = {
    "greedy": dict(temperature=0.0, seed=11),
    "seeded": dict(temperature=0.8, top_k=8, seed=11),
}
MAX_TOKENS = 16
# f32 prefill in XLA and in torch: K/V differ by about an ulp (1.5e-7 read).
PAGES_ATOL = 1e-6


# ---- the wire ------------------------------------------------------------------------

WIRE_DTYPES = ("float32", "bfloat16", "int8")


def _wire_arrays(dtype: str, shape, seed: int):
    """(JAX-side pages, port-side pages, scales or None) for one array of
    `shape`: the same bits, bf16 as ml_dtypes on the JAX side and as
    uint16 words in the port."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        q = rng.integers(-127, 128, size=shape, dtype=np.int8)
        scales = rng.random(shape[:-1], dtype=np.float32) + 1e-3
        return q, q.copy(), scales
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "float32":
        return x, x.copy(), None
    b = x.astype(ml_dtypes.bfloat16)
    return b, b.view(np.uint16).copy(), None


def _handoff_pair(dtype: str, page_size: int, plen: int):
    n_pages = -(-plen // page_size)
    shape = (2, n_pages, page_size, 2, 4)
    jk, tk, ks = _wire_arrays(dtype, shape, plen)
    jv, tv, vs = _wire_arrays(dtype, shape, plen + 1)
    fields = dict(
        token_ids=list(range(1, plen + 1)), first_token=7, first_finish="",
        page_size=page_size, dtype=dtype, seed=123456789, temperature=0.7,
        top_k=5, top_p=0.9, max_tokens=32, stop=("\n\n",),
        prefix_hashes=("aa" * 16, "bb" * 16), adapter="tenant-a", client="c1",
        priority="realtime", model="m1", k_scales=ks, v_scales=vs,
    )
    return (jhandoff.KVHandoff(k_pages=jk, v_pages=jv, **fields),
            handoff.KVHandoff(k_pages=tk, v_pages=tv, **fields))


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes()


@pytest.mark.parametrize("page_size,plen", [(8, 13), (16, 16), (4, 17)])
@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_serialize_byte_identical_to_jax(dtype, page_size, plen):
    jh, th = _handoff_pair(dtype, page_size, plen)
    blob = handoff.serialize(th)
    assert blob == jhandoff.serialize(jh)
    got, want = handoff.deserialize(jhandoff.serialize(jh)), jhandoff.deserialize(blob)
    for mine, theirs in ((got, th), (want, jh)):
        assert mine.dtype == dtype and mine.plen == plen
        assert mine.k_pages.dtype == theirs.k_pages.dtype
        assert _same_bits(mine.k_pages, theirs.k_pages)
        assert _same_bits(mine.v_pages, theirs.v_pages)
        assert mine.quantized == (dtype == "int8")
        if dtype == "int8":
            assert _same_bits(mine.k_scales, theirs.k_scales)
            assert _same_bits(mine.v_scales, theirs.v_scales)
        assert (mine.token_ids, mine.first_token, mine.seed, mine.stop,
                mine.prefix_hashes, mine.adapter, mine.priority, mine.model) == (
            theirs.token_ids, theirs.first_token, theirs.seed, theirs.stop,
            theirs.prefix_hashes, theirs.adapter, theirs.priority, theirs.model)
    assert got.nbytes() == jh.nbytes() == len(blob) - 8 - int.from_bytes(blob[4:8], "little")
    k, _ = got.contiguous_kv()
    assert k.shape[1] == plen


@pytest.mark.parametrize("n_pages", [2, 0])
@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_serialize_pages_byte_identical_to_jax(dtype, n_pages):
    shape = (2, n_pages, 8, 2, 4)
    jk, tk, ks = _wire_arrays(dtype, shape, 1)
    jv, tv, vs = _wire_arrays(dtype, shape, 2)
    fields = dict(prefix_hashes=tuple(f"{i:02x}" * 16 for i in range(n_pages)),
                  page_size=8, dtype=dtype, model="m1", k_scales=ks, v_scales=vs)
    je = jhandoff.KVPageExport(k_pages=jk, v_pages=jv, **fields)
    te = handoff.KVPageExport(k_pages=tk, v_pages=tv, **fields)
    blob = handoff.serialize_pages(te)
    assert blob == jhandoff.serialize_pages(je)
    got, want = handoff.deserialize_pages(jhandoff.serialize_pages(je)), \
        jhandoff.deserialize_pages(blob)
    for mine, theirs in ((got, te), (want, je)):
        assert mine.n_pages == n_pages and mine.prefix_hashes == theirs.prefix_hashes
        assert _same_bits(mine.k_pages, theirs.k_pages)
        assert _same_bits(mine.v_pages, theirs.v_pages)
        if dtype == "int8":
            assert _same_bits(mine.k_scales, theirs.k_scales)


def _malformed():
    _, th = _handoff_pair("float32", 8, 13)
    good = handoff.serialize(th)
    hdr_len = int.from_bytes(good[4:8], "little")
    header = json.loads(good[8:8 + hdr_len])

    def with_header(blob, **changes):
        h = dict(json.loads(blob[8:8 + int.from_bytes(blob[4:8], "little")]), **changes)
        raw = json.dumps(h).encode()
        return blob[:4] + len(raw).to_bytes(4, "little") + raw + \
            blob[8 + int.from_bytes(blob[4:8], "little"):]

    pages = handoff.serialize_pages(handoff.KVPageExport(
        prefix_hashes=("aa" * 16,), page_size=8, dtype="float32",
        k_pages=np.zeros((2, 1, 8, 2, 4), np.float32),
        v_pages=np.zeros((2, 1, 8, 2, 4), np.float32)))
    return {
        "bad-magic": ("deserialize", b"NOPE" + b"\x00" * 16),
        "truncated-body": ("deserialize", good[:-3]),
        "truncated-header": ("deserialize", good[:6]),
        "short-header": ("deserialize", good[:8 + hdr_len - 1]),
        "bad-json": ("deserialize", good[:8] + b"{" * hdr_len + good[8 + hdr_len:]),
        "version": ("deserialize", with_header(good, version=2)),
        "dtype": ("deserialize", with_header(good, dtype="float8_e9")),
        "plen": ("deserialize", with_header(good, plen=header["n_pages"] * 8 + 1)),
        "int8-no-quant-block": ("deserialize", with_header(good, dtype="int8")),
        "quant-block-on-f32": ("deserialize", with_header(
            good, kv_quant={"scheme": "int8-token-head"})),
        "pages-bad-magic": ("deserialize_pages", good),
        "pages-truncated": ("deserialize_pages", pages[:-1]),
        "pages-hash-count": ("deserialize_pages", with_header(pages, prefix_hashes=[])),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_blobs_get_the_jax_errors(case):
    fn, blob = MALFORMED[case]
    with pytest.raises(handoff.HandoffError) as got:
        getattr(handoff, fn)(blob)
    with pytest.raises(jhandoff.HandoffError) as want:
        getattr(jhandoff, fn)(blob)
    assert str(got.value) == str(want.value)


def test_serialize_refusals_match_jax():
    jh, th = _handoff_pair("int8", 8, 13)
    for mine, theirs in (
        (dataclasses.replace(th, k_scales=None), dataclasses.replace(jh, k_scales=None)),
        (dataclasses.replace(th, v_pages=th.v_pages[:, :1]),
         dataclasses.replace(jh, v_pages=jh.v_pages[:, :1])),
        (dataclasses.replace(th, dtype="float32"), dataclasses.replace(jh, dtype="float32")),
    ):
        with pytest.raises(handoff.HandoffError) as got:
            handoff.serialize(mine)
        with pytest.raises(jhandoff.HandoffError) as want:
            jhandoff.serialize(theirs)
        assert str(got.value) == str(want.value)


def test_handoff_store_pop_once_and_eviction():
    _, h = _handoff_pair("float32", 8, 13)
    for store_cls, transport_cls in ((HandoffStore, InProcessTransport),
                                     (jtransport.HandoffStore, jtransport.InProcessTransport)):
        store = store_cls(capacity=2)
        t = transport_cls(store)
        r1 = t.send(h, handoff_id="a")
        assert r1.handoff_id == "a" and r1.bytes == h.nbytes()
        t.send(h, handoff_id="b")
        t.send(h, handoff_id="c")  # evicts "a"
        assert store.pop("a") is None and store.evicted == 1
        assert store.pop("b") is h
        assert store.pop("b") is None  # consumed exactly once
        assert len(store) == 1 and store.put(h).startswith("kvh-")


def test_bf16_pages_cross_by_view():
    """bf16 pages reach the host as their 16-bit words and come back bit
    for bit, NaN payloads and signed zeros included: a view, never a
    cast."""
    words = np.array([0x7FC1, 0xFF81, 0x8000, 0x0000, 0x3F80, 0x0001, 0x7F80, 0xC2F7],
                     np.uint16).reshape(1, 1, 2, 2, 2)
    t = _pages_to_device(words, torch.bfloat16, torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and t.shape == words.shape
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), words)
    assert np.array_equal(_pages_to_host(t), words)
    assert _same_bits(_pages_to_host(t), words.view(ml_dtypes.bfloat16))
    f = torch.randn(2, 3)
    assert torch.equal(_pages_to_device(_pages_to_host(f), torch.float32, torch.device("cpu")), f)
    with pytest.raises(handoff.HandoffError, match="uint16"):
        _pages_to_device(words, torch.float32, torch.device("cpu"))


# ---- the engine ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _port_engine(models, **kw):
    _, _, tcfg, tparams = models
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids, device="cpu")


def _jax_engine(models, **kw):
    jcfg, jparams, _, _ = models
    return JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, **{**BASE, **kw}), eos_token_ids=TOK.eos_token_ids)


def _drain(eng, rid, first=()) -> list[int]:
    out = list(first)
    while eng.has_work():
        out += [ev.token for ev in eng.step() if ev.rid == rid]
    return out


def _continue(eng, h) -> list[int]:
    rid, ev = eng.import_handoff(h)
    assert ev.rid == rid and not ev.finished
    return _drain(eng, rid, [ev.token])


@pytest.fixture(scope="module")
def jax_side(models):
    """The JAX engines' handoffs and unified streams: {(kind, mode): ...}
    with kind "base" (whole-prompt prefill) or "chunked"."""
    out = {}
    for kind, kw in (("base", {}), ("chunked", LAYOUTS["chunked"])):
        eng = _jax_engine(models, **kw)
        for mode, sp in SAMPLING.items():
            params = JSamplingParams(max_tokens=MAX_TOKENS, **sp)
            out["handoff", kind, mode] = eng.export_handoff(TOK.encode(PROMPT), params)
            if kind == "base":
                out["stream", mode] = _drain(eng, eng.add_request(TOK.encode(PROMPT), params))
                out["engine"] = eng
    return out


@pytest.fixture(scope="module")
def port_engines(models):
    return {(layout, overlap): _port_engine(models, step_overlap=overlap, **kw)
            for layout, kw in LAYOUTS.items() for overlap in ("on", "off")}


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("kind", ["base", "chunked"])
def test_export_matches_jax(port_engines, jax_side, kind, mode):
    eng = port_engines["chunked" if kind == "chunked" else "per_layer", "off"]
    got = eng.export_handoff(TOK.encode(PROMPT), SamplingParams(max_tokens=MAX_TOKENS,
                                                                **SAMPLING[mode]))
    want = jax_side["handoff", kind, mode]
    assert got.first_token == want.first_token
    assert got.prefix_hashes == want.prefix_hashes and len(got.prefix_hashes) == 1
    for field in ("token_ids", "first_finish", "page_size", "dtype", "seed",
                  "temperature", "top_k", "top_p", "max_tokens", "stop", "client",
                  "priority", "model", "adapter"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.k_pages.shape == want.k_pages.shape and got.k_pages.dtype == np.float32
    # Positions past the prompt in its last page are masked junk (here,
    # what an earlier stream decoded into a reused page): compare the
    # prompt's tokens.
    for mine, theirs in zip(got.contiguous_kv(), want.contiguous_kv()):
        np.testing.assert_allclose(mine, np.asarray(theirs), atol=PAGES_ATOL, rtol=0)
    # Same header: only the page bytes may differ.
    blob, jblob = handoff.serialize(got), jhandoff.serialize(want)
    assert blob[:8 + int.from_bytes(blob[4:8], "little")] == \
        jblob[:8 + int.from_bytes(jblob[4:8], "little")]
    assert eng.num_active == 0 and not eng.has_work()


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_import_continues_the_unified_stream(port_engines, jax_side, layout, overlap, mode):
    """A port handoff imported into a port engine of each layout continues
    token-identically to the port's unified stream and to the JAX
    engine's."""
    eng = port_engines[layout, overlap]
    assert eng._overlap == (overlap == "on")
    sp = SamplingParams(max_tokens=MAX_TOKENS, **SAMPLING[mode])
    prompt = TOK.encode(PROMPT)
    ref = _drain(eng, eng.add_request(prompt, sp))
    assert ref == jax_side["stream", mode]
    h = handoff.deserialize(handoff.serialize(eng.export_handoff(prompt, sp)))
    before = dict(eng.disagg_stats)
    assert _continue(eng, h) == ref
    assert eng.disagg_stats["imported"] == before["imported"] + 1
    assert eng.disagg_stats["imported_bytes"] == before["imported_bytes"] + h.nbytes()
    assert eng.num_active == 0 and not eng.has_work()


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_handoffs_cross_between_jax_and_port(models, port_engines, jax_side, mode):
    prompt_stream = jax_side["stream", mode]
    # JAX prefill, port decode: the imported pool holds the blob's bits.
    eng = port_engines["per_layer", "on"]
    jh = jhandoff.deserialize(jhandoff.serialize(jax_side["handoff", "base", mode]))
    blob = jhandoff.serialize(jh)
    th = handoff.deserialize(blob)
    rid, ev = eng.import_handoff(th)
    slot = eng._requests[rid].slot
    pages = eng._alloc.pages_for(slot)
    plen = th.plen
    for pool, src in ((eng.cache.k_pages, th.k_pages), (eng.cache.v_pages, th.v_pages)):
        got = pool[:, pages].reshape(pool.shape[0], -1, *pool.shape[3:])[:, :plen]
        want = src.reshape(src.shape[0], -1, *src.shape[3:])[:, :plen]
        assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(want)))
    assert _drain(eng, rid, [ev.token]) == prompt_stream
    # Port prefill, JAX decode.
    th = eng.export_handoff(TOK.encode(PROMPT), SamplingParams(max_tokens=MAX_TOKENS,
                                                               **SAMPLING[mode]))
    jeng = jax_side["engine"]
    assert _continue(jeng, jhandoff.deserialize(handoff.serialize(th))) == prompt_stream


def test_exported_pages_are_the_pool_bits(models):
    """Within the port the export is the pool's bits in table order: the
    prompt's full pages, registered by the prefix cache, gathered back."""
    eng = _port_engine(models, prefill_chunk=8, prefix_cache=True)
    prompt = TOK.encode(PROMPT * 2)  # 60 tokens: three full pages
    h = eng.export_handoff(prompt, SamplingParams(temperature=0.0, max_tokens=4))
    pages = eng._alloc.lookup([bytes.fromhex(x) for x in h.prefix_hashes])
    assert len(pages) == len(h.prefix_hashes) == 3
    assert torch.equal(eng.cache.k_pages[:, pages], torch.from_numpy(h.k_pages[:, :3]))
    assert torch.equal(eng.cache.v_pages[:, pages], torch.from_numpy(h.v_pages[:, :3]))
    assert eng.prefix_stats["prompt_tokens"] == len(prompt)
    assert eng._alloc.cached_idle_pages == 3  # parked on release
    assert eng.disagg_stats["exported"] == 1
    assert eng.disagg_stats["exported_bytes"] == h.nbytes()


def test_import_respects_capacity(models):
    """import_handoff sheds (EngineBusy) when no slot is free, as the JAX
    engine does, instead of queueing."""
    ecfg = dict(num_slots=1, max_seq_len=64, page_size=8, decode_chunk=2)
    sp = dict(temperature=0.0, max_tokens=30, seed=1)
    eng = _port_engine(models, **ecfg)
    h1 = eng.export_handoff([1, 2, 3], SamplingParams(**sp))
    h2 = eng.export_handoff([4, 5, 6], SamplingParams(**sp))
    eng.import_handoff(h1)
    with pytest.raises(EngineBusy) as got:
        eng.import_handoff(h2)
    with pytest.raises(EngineBusy) as busy:
        eng.export_handoff([4, 5, 6], SamplingParams(**sp))
    jeng = _jax_engine(models, **ecfg)
    jsp = JSamplingParams(**sp)
    j1, j2 = (jeng.export_handoff(p, jsp) for p in ([1, 2, 3], [4, 5, 6]))
    jeng.import_handoff(j1)
    with pytest.raises(JEngineBusy) as want:
        jeng.import_handoff(j2)
    with pytest.raises(JEngineBusy) as jbusy:
        jeng.export_handoff([4, 5, 6], jsp)
    assert str(got.value) == str(want.value) == "no free decode slot"
    assert str(busy.value) == str(jbusy.value) == "no free prefill slot"


def test_first_token_finish_short_circuits(models):
    """max_tokens=1 finishes at the prefill-sampled token: the handoff says
    so and the import occupies no slot."""
    eng = _port_engine(models, num_slots=1, max_seq_len=64, page_size=8, decode_chunk=2)
    h = eng.export_handoff([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=1))
    assert h.first_finish == "length"
    rid, ev = eng.import_handoff(h)
    assert ev.finished and ev.finish_reason == "length" and ev.rid == rid
    assert eng.num_active == 0 and not eng.has_work()
    assert eng.disagg_stats["imported"] == 1


def test_import_refusals_match_jax(models, port_engines, jax_side):
    eng = port_engines["per_layer", "off"]
    jeng = jax_side["engine"]
    jh = jax_side["handoff", "base", "greedy"]
    # A bf16 handoff into an f32 pool, a geometry mismatch, a length past
    # the context: refused with the JAX engine's messages, never cast.
    bf16 = dataclasses.replace(
        jh, dtype="bfloat16", k_pages=np.asarray(jh.k_pages).astype(ml_dtypes.bfloat16),
        v_pages=np.asarray(jh.v_pages).astype(ml_dtypes.bfloat16))
    narrow = dataclasses.replace(jh, k_pages=np.asarray(jh.k_pages)[..., :8],
                                 v_pages=np.asarray(jh.v_pages)[..., :8])
    long = dataclasses.replace(jh, token_ids=list(range(1, 129)))
    cases = [(bad, handoff.deserialize(jhandoff.serialize(bad))) for bad in (bf16, narrow)]
    cases.append((long, dataclasses.replace(handoff.deserialize(jhandoff.serialize(jh)),
                                            token_ids=long.token_ids)))
    messages = []
    for theirs, mine in cases:
        with pytest.raises(handoff.HandoffError) as got:
            eng.import_handoff(mine)
        with pytest.raises(jhandoff.HandoffError) as want:
            jeng.import_handoff(theirs)
        assert str(got.value) == str(want.value)
        messages.append(str(got.value))
    assert "casting would break token-identity" in messages[0]
    assert "does not match this model" in messages[1] and ">= max_seq_len" in messages[2]
    with pytest.raises(NotImplementedError, match="ROADMAP A item 8"):
        eng.import_handoff(dataclasses.replace(
            handoff.deserialize(jhandoff.serialize(jh)), adapter="tenant-a"))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 8"):
        eng.export_handoff([1, 2], adapter="tenant-a")
    assert eng.num_active == 0 and not eng.has_work()


def test_export_and_import_refuse_once_draining(models):
    eng = _port_engine(models)
    h = eng.export_handoff([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4))
    eng.begin_drain()
    with pytest.raises(EngineDraining):
        eng.export_handoff([1, 2, 3])
    with pytest.raises(EngineDraining):
        eng.import_handoff(h)


# ---- over HTTP ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(models, jax_side):
    """A JAX prefill server, a JAX unified server (the reference, which
    also accepts handoffs), a port prefill and a port decode server."""
    out = {
        "jax-prefill": JEngineServer(_jax_engine(models), JByteTokenizer(), "tiny",
                                     host="127.0.0.1", port=0, role="prefill"),
        "jax-unified": JEngineServer(jax_side["engine"], JByteTokenizer(), "tiny",
                                     host="127.0.0.1", port=0),
        "port-prefill": EngineServer(_port_engine(models), TOK, "tiny", port=0,
                                     role="prefill"),
        "port-decode": EngineServer(_port_engine(models), TOK, "tiny", port=0,
                                    role="decode"),
    }
    for srv in out.values():
        srv.start()
    yield out
    for srv in out.values():
        srv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _text(raw: bytes, stream: bool) -> tuple[str, str]:
    """(text, finish_reason) of a completions response."""
    if not stream:
        choice = json.loads(raw)["choices"][0]
        return choice["text"], choice["finish_reason"]
    text, finish = "", None
    for line in raw.decode(errors="replace").splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            choice = json.loads(line[6:])["choices"][0]
            text += choice.get("text") or ""
            finish = choice.get("finish_reason") or finish
    return text, finish


def _two_hop(servers, prefill: str, decode: str, req: dict, stream=False):
    status, body = http_post(_addr(servers[prefill]), "/v1/completions", req,
                             headers={"X-Disagg-Transfer": _addr(servers[decode])})
    assert status == 200, body
    receipt = json.loads(body)
    assert receipt["object"] == "kv.handoff" and receipt["transfer"]["bytes"] > 0
    assert receipt["decode_addr"] == _addr(servers[decode])
    return http_post(_addr(servers[decode]), "/v1/completions", dict(req, stream=stream),
                     headers={"X-Disagg-Handoff": receipt["handoff_id"]})


HOPS = {
    "jax-to-port": ("jax-prefill", "port-decode"),
    "port-to-jax": ("port-prefill", "jax-unified"),
    "port-to-port": ("port-prefill", "port-decode"),
}


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("hop", list(HOPS))
def test_http_two_hop_matches_jax_unified(servers, hop, mode, stream):
    req = {"model": "tiny", "prompt": PROMPT, "max_tokens": MAX_TOKENS, **SAMPLING[mode]}
    status, body = http_post(_addr(servers["jax-unified"]), "/v1/completions", req)
    assert status == 200
    want = _text(body, False)
    status, body = _two_hop(servers, *HOPS[hop], req, stream=stream)
    assert status == 200, body
    assert _text(body, stream) == want


def test_refusals_match_jax(servers):
    cases = [
        # A prefill role without X-Disagg-Transfer.
        ("prefill", {}, {"model": "tiny", "prompt": "x", "max_tokens": 4}),
        # An unknown handoff id.
        ("decode", {"X-Disagg-Handoff": "kvh-nope"},
         {"model": "tiny", "prompt": "x", "max_tokens": 4}),
        # n > 1 on the prefill role.
        ("prefill", {"X-Disagg-Transfer": "127.0.0.1:1"},
         {"model": "tiny", "prompt": "x", "n": 2}),
        # Another model's name.
        ("prefill", {"X-Disagg-Transfer": "127.0.0.1:1"},
         {"model": "other", "prompt": "x"}),
    ]
    for role, headers, body in cases:
        jsrv = servers["jax-prefill" if role == "prefill" else "jax-unified"]
        tsrv = servers[f"port-{role}"]
        got = http_post(_addr(tsrv), "/v1/completions", body, headers=headers)
        want = http_post(_addr(jsrv), "/v1/completions", body, headers=headers)
        assert got[0] == want[0] and got[0] in (400, 404), (body, got)
        assert json.loads(got[1]) == json.loads(want[1])
    # A push to a decode server that is not there: 502.
    status, body = http_post(_addr(servers["port-prefill"]), "/v1/completions",
                             {"model": "tiny", "prompt": "x", "max_tokens": 2},
                             headers={"X-Disagg-Transfer": "127.0.0.1:1"})
    assert status == 502 and b"kv import to 127.0.0.1:1 failed" in body


def _post_blob(addr: str, blob: bytes, headers=None) -> tuple[int, dict]:
    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request("POST", "/v1/kv/import", body=blob,
                 headers={"Content-Length": str(len(blob)), **(headers or {})})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read() or b"{}")
    conn.close()
    return out


def test_kv_import_refusals_match_jax(servers, jax_side):
    blob = jhandoff.serialize(jax_side["handoff", "base", "greedy"])
    got = _post_blob(_addr(servers["port-prefill"]), blob)
    want = _post_blob(_addr(servers["jax-prefill"]), blob)
    assert got == want and got[0] == 400
    # A malformed blob: 400 with the wire's error.
    got = _post_blob(_addr(servers["port-decode"]), b"NOPE" + b"\x00" * 16)
    want = _post_blob(_addr(servers["jax-unified"]), b"NOPE" + b"\x00" * 16)
    assert got == want and got[0] == 400
    # Past the transfer limit: 413.
    dec = servers["port-decode"]
    dec.max_transfer_bytes = len(blob) - 1
    try:
        status, err = _post_blob(_addr(dec), blob)
    finally:
        dec.max_transfer_bytes = 0
    assert status == 413 and "transfer limit" in err["error"]["message"]
    # A bf16 handoff reaches the f32 pool's store but its generate is
    # refused, never cast: the JAX server's 400 and message.
    jh = jax_side["handoff", "base", "greedy"]
    bf16 = jhandoff.serialize(dataclasses.replace(
        jh, dtype="bfloat16", k_pages=np.asarray(jh.k_pages).astype(ml_dtypes.bfloat16),
        v_pages=np.asarray(jh.v_pages).astype(ml_dtypes.bfloat16)))
    answers = []
    for name in ("port-decode", "jax-unified"):
        status, receipt = _post_blob(_addr(servers[name]), bf16, {"X-Handoff-Id": "bf16"})
        assert status == 200 and receipt == {"handoff_id": "bf16", "bytes": len(bf16)}
        answers.append(http_post(_addr(servers[name]), "/v1/completions",
                                 {"model": "tiny", "prompt": "x"},
                                 headers={"X-Disagg-Handoff": "bf16"}))
    assert answers[0][0] == answers[1][0] == 400
    assert json.loads(answers[0][1]) == json.loads(answers[1][1])


def test_state_and_transfer_metrics_on_both_sides(servers):
    pre, dec = servers["port-prefill"], servers["port-decode"]
    exported = pre.engine.disagg_stats["exported"]
    status, body = http_post(_addr(pre), "/v1/completions",
                             {"model": "tiny", "prompt": PROMPT, "max_tokens": 4,
                              "temperature": 0},
                             headers={"X-Disagg-Transfer": _addr(dec),
                                      "X-Handoff-Id": "pending-one"})
    assert status == 200 and json.loads(body)["handoff_id"] == "pending-one"
    state = json.loads(http_get(_addr(dec), "/v1/state")[1])
    assert state["role"] == "decode" and state["pending_handoffs"] == 1
    assert state["kv_sharing"] is False and state["kv_holdings"] == []
    assert set(state["kv_share"]) == set(dec.engine.kv_share_stats)
    status, _ = http_post(_addr(dec), "/v1/completions", {"model": "tiny", "prompt": "x"},
                          headers={"X-Disagg-Handoff": "pending-one"})
    assert status == 200
    assert json.loads(http_get(_addr(dec), "/v1/state")[1])["pending_handoffs"] == 0
    assert json.loads(http_get(_addr(pre), "/v1/state")[1])["role"] == "prefill"
    assert pre.engine.disagg_stats["exported"] == exported + 1
    for srv, direction, jsrv in ((pre, "export", servers["jax-prefill"]),
                                 (dec, "import", servers["jax-unified"])):
        text = http_get(_addr(srv), "/metrics")[1].decode()
        for series in ("kubeai_engine_kv_handoffs_total",
                       "kubeai_engine_kv_transfer_bytes_total",
                       "kubeai_engine_kv_transfer_seconds_count"):
            assert f'{series}{{direction="{direction}"}}' in text, series
        role = "prefill" if srv is pre else "decode"
        parsed = jregistry.parse_prometheus_text(text)
        assert parsed[("kubeai_engine_role", (("role", role),))] == 1
        assert parsed[("kubeai_engine_kv_handoffs_total", (("direction", direction),))] >= 1
        # The page gather (export) or scatter (import), as the JAX
        # profiler's standalone kv_transfer phase.
        phase = ("kubeai_engine_step_phase_seconds_count", (("phase", "kv_transfer"),))
        assert parsed[phase] >= 1
        assert jregistry.parse_prometheus_text(
            http_get(_addr(jsrv), "/metrics")[1].decode())[phase] >= 1
        jtext = http_get(_addr(jsrv), "/metrics")[1].decode()
        types = {ln for ln in text.splitlines() if ln.startswith("# TYPE kubeai_engine_kv")}
        assert types == {ln for ln in jtext.splitlines()
                         if ln.startswith("# TYPE kubeai_engine_kv")}


# ---- through the reference proxy -------------------------------------------------------


def _pod(name: str, port: int, role: str) -> dict:
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "default",
                     "labels": {"model": "tiny", md.POD_ROLE_LABEL: role},
                     "annotations": {"model-pod-ip": "127.0.0.1",
                                     "model-pod-port": str(port)}},
        "status": {"conditions": [{"type": "Ready", "status": "True"}],
                   "podIP": "127.0.0.1"},
    }


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("pair", [("jax-prefill", "port-decode"),
                                  ("port-prefill", "jax-unified")],
                         ids=["jax-prefill-port-decode", "port-prefill-jax-decode"])
def test_proxy_two_hop_across_engines(servers, pair, mode):
    store = KubeStore()
    metrics = Metrics()
    lb = LoadBalancer(store, default_timeout=5, metrics=metrics)
    proxy = ModelProxy(lb, ModelClient(store), metrics=metrics)
    try:
        store.create(Model(name="tiny", spec=ModelSpec(
            url="hf://org/x", engine="KubeAITPU", features=["TextGeneration"],
            autoscaling_disabled=True, replicas=1, load_balancing=LoadBalancing(),
            disaggregation=Disaggregation(enabled=True))).to_dict())
        for role, name in zip((md.ROLE_PREFILL, md.ROLE_DECODE), pair):
            store.create(_pod(f"model-tiny-{role}", servers[name].port, role))
        lb.sync_model("tiny")
        req = {"model": "tiny", "prompt": PROMPT, "max_tokens": MAX_TOKENS, **SAMPLING[mode]}
        result = proxy.handle("/v1/completions", json.dumps(req).encode(), {})
        body = b"".join(result.chunks)
        assert result.status == 200, body
        assert metrics.proxy_disagg_requests.get(model="tiny") == 1
        assert metrics.proxy_disagg_fallback.get(model="tiny") == 0
    finally:
        lb.stop()
    status, want = http_post(_addr(servers["jax-unified"]), "/v1/completions", req)
    assert status == 200
    assert _text(body, False) == _text(want, False)
