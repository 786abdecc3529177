"""The cluster KV-sharing tier in kubeai_tpu_torch, against the JAX
package, on the CPU: the port's counterpart of the engine and server half
of tests/unit/test_kv_sharing.py.

- `compute_prefix_chain` equals the JAX engine's and the front door's
  chain (ChainComputer).
- `export_prefix_pages` of the same pool contents and chain is byte for
  byte the JAX engine's blob, truncated and empty exports included; after
  serving the same prompt the two engines export the same chain with
  pages within 1e-6 (f32 prefill in XLA and in torch differs by an ulp).
- A peer fetch over X-KV-Source works from a JAX replica into a port
  replica and from a port replica into a JAX replica, greedy and seeded:
  the stream equals the no-sharing baseline, and pages and hit tokens are
  counted. A dead peer and one that dies mid-transfer fall back to
  recompute. `/v1/kv/export` answers as the JAX server does; an
  in-process export and import keep token identity in every direction.
- Spill: evicted idle pages go to a KVSpillStore and fill back bit for
  bit, through the engine and through the server's pre-admission fetch
  (`filled_pages` counts it); the store's LRU and counters behave as the
  JAX package's in-memory store, and an object-store URL names ROADMAP A
  item 9.

Weights: the same tiny f32 llama on both sides (params_from_numpy).
"""

import dataclasses
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.models import llama as jl
from kubeai_tpu.objstore import KVSpillStore as JKVSpillStore
from kubeai_tpu.routing.prefixchain import ChainComputer
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.objstore import KVSpillStore
from kubeai_tpu_torch.parity import params_from_numpy

pytestmark = pytest.mark.kvshare

TOK = ByteTokenizer()
PAGE = 16
ECFG = dict(num_slots=4, max_seq_len=128, page_size=PAGE, prefill_chunk=32,
            decode_chunk=4, prefix_cache=True)
# > 2 full pages of byte tokens so the routable chain is non-trivial.
PROMPT = "the quick brown fox jumps over the lazy dog, twice"
SAMPLING = {
    "greedy": {"temperature": 0, "seed": 11},
    "seeded": {"temperature": 0.8, "top_k": 8, "seed": 11},
}
# f32 prefill in XLA and in torch: K/V differ by about an ulp.
PAGES_ATOL = 1e-6


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
        cache_dtype=torch.float32, **{**ECFG, **kw}),
        eos_token_ids=TOK.eos_token_ids, device="cpu")


def _jax_engine(models, **kw):
    jcfg, jparams, _, _ = models
    return JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, **{**ECFG, **kw}), eos_token_ids=TOK.eos_token_ids)


@pytest.fixture(scope="module")
def fleet(models):
    """Two KV-sharing replicas, one JAX and one port, each with an
    in-memory spill store, and a sharing-off port baseline."""
    servers = {
        "jax": JEngineServer(_jax_engine(models), JByteTokenizer(), "tiny",
                             host="127.0.0.1", port=0, kv_sharing=True,
                             kv_spill_store=JKVSpillStore()),
        "port": EngineServer(_port_engine(models), TOK, "tiny", port=0,
                             kv_sharing=True, kv_spill_store=KVSpillStore()),
        "base": EngineServer(_port_engine(models), TOK, "tiny", port=0),
    }
    for srv in servers.values():
        srv.start()
    yield servers
    for srv in servers.values():
        srv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _gen(srv, req, headers=None) -> dict:
    status, body = http_post(_addr(srv), "/v1/completions", req, headers=headers)
    assert status == 200, body
    return json.loads(body)["choices"][0]


def test_compute_prefix_chain_matches_jax_and_front_door(models, fleet):
    eng, jeng = fleet["port"].engine, fleet["jax"].engine
    cc = ChainComputer(page_size=PAGE)
    for body, chat in (
        ({"prompt": PROMPT}, False),
        ({"prompt": ""}, False),  # the empty prompt's [0]
        ({"messages": [{"role": "user", "content": PROMPT}]}, True),
    ):
        ids = cc.prompt_ids(body, chat)
        full = eng.compute_prefix_chain(ids)
        assert full == jeng.compute_prefix_chain(ids)
        cap = max(0, (len(ids) - 1) // PAGE)
        assert cc.chain_for_request(body, chat) == full[:cap]
    assert len(eng.compute_prefix_chain(TOK.encode(PROMPT))) == len(PROMPT) // PAGE


def test_export_prefix_pages_byte_identical_to_jax(models):
    """The same pool contents under the same chain export to the same
    blob: seeded into both engines from one page export."""
    eng, jeng = _port_engine(models), _jax_engine(models)
    rng = np.random.default_rng(0)
    shape = (2, 3, PAGE, 2, 16)
    chain = tuple(f"{i:02x}" * 16 for i in (7, 8, 9))
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    assert eng.import_prefix_pages(handoff.KVPageExport(chain, PAGE, "float32", k, v)) == 3
    assert jeng.import_prefix_pages(jhandoff.KVPageExport(chain, PAGE, "float32", k, v)) == 3
    # Already held: nothing is written again.
    assert eng.import_prefix_pages(handoff.KVPageExport(chain, PAGE, "float32", k, v)) == 0
    page_bytes = eng._page_wire_nbytes()
    assert page_bytes == jeng._page_wire_nbytes()
    for hashes, max_bytes, n in ((list(chain), 0, 3), (list(chain), page_bytes * 3 // 2, 1),
                                 (["ff" * 16] + list(chain), 0, 0), (list(chain[:2]), 0, 2)):
        got, want = eng.export_prefix_pages(hashes, max_bytes), \
            jeng.export_prefix_pages(hashes, max_bytes)
        assert got.n_pages == want.n_pages == n
        assert handoff.serialize_pages(got) == jhandoff.serialize_pages(want)
        if n:
            assert np.array_equal(got.k_pages, k[:, :n])
    assert eng.cached_prefix_depth(list(chain)) == jeng.cached_prefix_depth(list(chain)) == 3
    assert eng.cached_prefix_depth(["zz"]) == jeng.cached_prefix_depth(["zz"]) == 0
    assert eng.export_prefix_pages(["zz"]) is None and jeng.export_prefix_pages(["zz"]) is None
    assert eng.kv_share_stats == {**jeng.kv_share_stats}
    assert eng.kv_share_stats["exported_pages"] == 6


def test_served_prefix_exports_match_jax(models, fleet):
    prompt = "served exports: " + PROMPT
    req = {"model": "tiny", "prompt": prompt, "max_tokens": 4, "temperature": 0}
    for name in ("port", "jax"):
        _gen(fleet[name], req)
    chain = fleet["port"].engine.compute_prefix_chain(TOK.encode(prompt))
    got = fleet["port"].engine.export_prefix_pages(chain)
    want = fleet["jax"].engine.export_prefix_pages(chain)
    assert got.n_pages == want.n_pages == len(chain) > 0
    assert got.prefix_hashes == want.prefix_hashes
    np.testing.assert_allclose(got.k_pages, np.asarray(want.k_pages), atol=PAGES_ATOL, rtol=0)
    np.testing.assert_allclose(got.v_pages, np.asarray(want.v_pages), atol=PAGES_ATOL, rtol=0)
    state = json.loads(http_get(_addr(fleet["port"]), "/v1/state")[1])
    assert state["kv_sharing"] is True and set(chain) <= set(state["kv_holdings"])


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("holder,fetcher", [("jax", "port"), ("port", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
def test_peer_fetch_token_identical_to_baseline(fleet, holder, fetcher, mode):
    # Prompts differ from the first token across tests sharing the fleet:
    # a common leading page would already be held by the fetcher.
    prompt = f"{holder}>{fetcher} {mode} {PROMPT}"
    req = {"model": "tiny", "prompt": prompt, "max_tokens": 16, **SAMPLING[mode]}
    ref = _gen(fleet["base"], req)
    _gen(fleet[holder], req)  # warm the holder: its pages park idle
    chain = ChainComputer(PAGE).chain_for_request(req, chat=False)
    state = json.loads(http_get(_addr(fleet[holder]), "/v1/state")[1])
    assert chain and set(chain) <= set(state["kv_holdings"])
    dst, src = fleet[fetcher].engine, fleet[holder].engine
    imported, exported = dst.kv_share_stats["imported_pages"], src.kv_share_stats["exported_pages"]
    hits = dst.prefix_stats["hit_tokens"]
    got = _gen(fleet[fetcher], req, headers={"X-KV-Source": _addr(fleet[holder])})
    assert (got["text"], got["finish_reason"]) == (ref["text"], ref["finish_reason"])
    assert dst.kv_share_stats["imported_pages"] == imported + len(chain)
    assert src.kv_share_stats["exported_pages"] == exported + len(chain)
    assert dst.prefix_stats["hit_tokens"] == hits + len(chain) * PAGE
    assert fleet[fetcher].metrics.kv_fetch_bytes.get() > 0
    assert fleet[fetcher].metrics.kv_fetch_failures.get(source="peer") == 0


def test_dead_peer_degrades_to_recompute(fleet):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    req = {"model": "tiny", "prompt": "an entirely different tale about a dead peer port",
           "max_tokens": 12, "temperature": 0, "seed": 5}
    ref = _gen(fleet["base"], req)
    srv = fleet["port"]
    fails = srv.metrics.kv_fetch_failures.get(source="peer")
    got = _gen(srv, req, headers={"X-KV-Source": dead})
    assert got["text"] == ref["text"]
    assert srv.metrics.kv_fetch_failures.get(source="peer") == fails + 1


def test_mid_transfer_peer_death_degrades_to_recompute(fleet):
    """A peer that dies mid-blob (full Content-Length, half the bytes)
    counts a failed fetch and recomputes: never a partial import."""
    blob = handoff.serialize_pages(handoff.KVPageExport(
        prefix_hashes=("00" * 16,), page_size=PAGE, dtype="float32",
        k_pages=np.zeros((2, 1, PAGE, 2, 16), np.float32),
        v_pages=np.zeros((2, 1, PAGE, 2, 16), np.float32)))

    class HalfBlob(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob[: len(blob) // 2])
            self.wfile.flush()
            self.connection.close()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), HalfBlob)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = {"model": "tiny", "prompt": "yet another story where a peer dies mid-blob",
               "max_tokens": 12, "temperature": 0, "seed": 9}
        ref = _gen(fleet["base"], req)
        srv = fleet["port"]
        fails = srv.metrics.kv_fetch_failures.get(source="peer")
        imported = srv.engine.kv_share_stats["imported_pages"]
        got = _gen(srv, req, headers={"X-KV-Source": f"127.0.0.1:{httpd.server_address[1]}"})
        assert got["text"] == ref["text"]
        assert srv.metrics.kv_fetch_failures.get(source="peer") == fails + 1
        assert srv.engine.kv_share_stats["imported_pages"] == imported
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_export_endpoint_surface_matches_jax(fleet):
    # A sharing-off replica serves no exports.
    status, _ = http_post(_addr(fleet["base"]), "/v1/kv/export",
                          {"prefix_hashes": [], "max_bytes": 0})
    assert status == 404
    for body, want_status in (({"prefix_hashes": "zzz"}, 400),
                              ({"prefix_hashes": ["zz"]}, 400),
                              ({"prefix_hashes": ["ff" * 16], "max_bytes": 0}, 200)):
        got = http_post(_addr(fleet["port"]), "/v1/kv/export", body)
        want = http_post(_addr(fleet["jax"]), "/v1/kv/export", body)
        assert got[0] == want[0] == want_status
        assert got[1] == want[1]  # the error JSON, or the empty KVP1 blob
    assert handoff.deserialize_pages(got[1]).n_pages == 0
    state = json.loads(http_get(_addr(fleet["base"]), "/v1/state")[1])
    assert state["kv_sharing"] is False and state["kv_holdings"] == []


@pytest.mark.parametrize("direction", ["port-to-port", "jax-to-port", "port-to-jax"])
def test_in_process_export_import_token_identity(models, fleet, direction):
    """Export from one engine, import into another, serve there with no
    X-KV-Source: the seeded pages are hit and the stream equals the
    baseline's."""
    prompt = f"in-process sharing check {direction} over two replicas"
    req = {"model": "tiny", "prompt": prompt, "max_tokens": 10, "temperature": 0.7,
           "top_k": 4, "seed": 21}
    ref = _gen(fleet["base"], req)
    src_name, dst_name = direction.split("-to-")
    src = fleet[src_name].engine
    dst = _jax_engine(models) if dst_name == "jax" else _port_engine(models)
    _gen(fleet[src_name], req)  # warm the source
    ids = TOK.encode(prompt)
    chain = src.compute_prefix_chain(ids)[: (len(ids) - 1) // PAGE]
    export = src.export_prefix_pages(chain)
    assert export is not None and export.n_pages == len(chain) > 0
    wire = (jhandoff if src_name == "jax" else handoff).serialize_pages(export)
    received = (jhandoff if dst_name == "jax" else handoff).deserialize_pages(wire)
    assert dst.import_prefix_pages(received) == len(chain)
    assert dst.cached_prefix_depth(chain) == len(chain)
    srv = (JEngineServer(dst, JByteTokenizer(), "tiny", host="127.0.0.1", port=0)
           if dst_name == "jax" else EngineServer(dst, TOK, "tiny", port=0))
    srv.start()
    try:
        got = _gen(srv, req)
    finally:
        srv.stop()
    assert got["text"] == ref["text"]
    assert dst.prefix_stats["hit_tokens"] == len(chain) * PAGE


def test_import_prefix_pages_refusals_match_jax(models, fleet):
    eng, jeng = fleet["port"].engine, fleet["jax"].engine
    k = np.zeros((2, 1, PAGE, 2, 16), np.float32)
    cases = [
        dict(page_size=PAGE, dtype="float32", k_pages=k[..., :8], v_pages=k[..., :8]),
        dict(page_size=8, dtype="float32", k_pages=k[:, :, :8], v_pages=k[:, :, :8]),
        dict(page_size=PAGE, dtype="float16", k_pages=k.astype(np.float16),
             v_pages=k.astype(np.float16)),
    ]
    for fields in cases:
        with pytest.raises(handoff.HandoffError) as got:
            eng.import_prefix_pages(handoff.KVPageExport(prefix_hashes=("ab" * 16,), **fields))
        with pytest.raises(jhandoff.HandoffError) as want:
            jeng.import_prefix_pages(jhandoff.KVPageExport(prefix_hashes=("ab" * 16,), **fields))
        assert str(got.value) == str(want.value)


def test_spill_fills_back_bit_for_bit(models):
    """Evicted idle pages spill to the store; a later request of the same
    prompt fills them back through the server's pre-admission fetch, bit
    for bit, and streams as the baseline does."""
    store = KVSpillStore()
    # One max-length sequence (8 pages) and the scratch page.
    eng = _port_engine(models, num_slots=1, num_pages=9)
    srv = EngineServer(eng, TOK, "tiny", port=0, kv_sharing=True, kv_spill_store=store)
    base = _port_engine(models, num_slots=1)
    srv.start()
    try:
        prompt = "spill me: " + PROMPT  # 60 tokens: three full pages
        req = {"model": "tiny", "prompt": prompt, "max_tokens": 8, "temperature": 0}
        first = _gen(srv, req)
        hashes = [bytes.fromhex(h) for h in eng.compute_prefix_chain(TOK.encode(prompt))]
        pages = eng._alloc.lookup(hashes)
        assert len(pages) == 3
        held = [pool[:, pages].clone() for pool in (eng.cache.k_pages, eng.cache.v_pages)]
        # A long prompt of its own needs every page: the idle ones spill.
        _gen(srv, {"model": "tiny", "prompt": "z" * 110, "max_tokens": 8, "temperature": 0})
        assert eng._alloc.lookup(hashes) == []
        assert eng.kv_share_stats["spilled_pages"] >= 3 and store.puts >= 3
        blob = store.get(hashes[0].hex())
        export = handoff.deserialize_pages(blob)
        assert torch.equal(torch.from_numpy(export.k_pages.copy()), held[0][:, :1])
        fills = srv.metrics.kv_fetch_bytes.get()
        # The two misses before found nothing to fill: each counted a
        # failed spill fetch.
        fails = srv.metrics.kv_fetch_failures.get(source="spill")
        assert fails == 2
        again = _gen(srv, req)
        assert again == first
        assert eng.kv_share_stats["filled_pages"] == 3
        assert srv.metrics.kv_fetch_bytes.get() > fills
        assert srv.metrics.kv_fetch_failures.get(source="spill") == fails
        pages = eng._alloc.lookup(hashes)
        assert len(pages) == 3
        for pool, want in zip((eng.cache.k_pages, eng.cache.v_pages), held):
            assert torch.equal(pool[:, pages], want)
        ref = base.generate([TOK.encode(prompt)], SamplingParams(temperature=0.0, max_tokens=8))
        assert TOK.decode(ref[0]) == first["text"]
        text = http_get(_addr(srv), "/metrics")[1].decode()
        assert 'kubeai_engine_kv_share_pages_total{direction="spilled"}' in text
        assert 'kubeai_engine_kv_share_pages_total{direction="filled"}' in text
    finally:
        srv.stop()


def test_spill_store_matches_jax():
    mine, theirs = KVSpillStore(max_bytes=10), JKVSpillStore(max_bytes=10)
    for store in (mine, theirs):
        store.put("a", b"1234")
        store.put("b", b"5678")
        store.put("a", b"12")  # replaces; a becomes most recent
        store.put("c", b"99999")  # 11 bytes > 10: evicts b
        store.put("huge", b"x" * 11)  # past the cap: dropped
    for key in ("a", "b", "c", "huge", "a"):
        assert mine.get(key) == theirs.get(key)
    assert (mine.puts, mine.gets, mine.hits) == (theirs.puts, theirs.gets, theirs.hits) == (5, 5, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A item 9"):
        KVSpillStore("s3://bucket/spill")
