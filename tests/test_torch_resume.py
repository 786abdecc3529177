"""The continuation request (`kubeai_resume`) in kubeai_tpu_torch, against
the JAX package, on the CPU: the port's counterpart of the resume tests
in tests/unit/test_preemption.py.

- Engine: `add_request(resume_tokens=prefix)` continues a stream
  token-identically to the uninterrupted one, greedy and seeded, in the
  paged, paged-chunked (prefill_chunk=8), speculative (speculate=2) and
  fused layouts, with overlapped stepping on and off; every stream equals
  the JAX engine's. The three refusals carry the JAX engine's messages.
- Server: malformed and too-long continuation bodies get the JAX
  server's status and message; direct resume POSTs, streamed and unary,
  answer the JAX server's text for the same body.
- A mixed fleet: the routing proxy in front of one JAX and one port
  EngineServer; the replica serving a stream dies at its second SSE event
  and the other resumes it, in both directions. The client's text equals
  the uninterrupted stream's, with exactly one [DONE].

Weights: the same tiny f32 llama on both sides, carried across by
kubeai_tpu_torch.parity.params_from_numpy.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_post

from kubeai_tpu.crd.model import LoadBalancing, Model, ModelSpec
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.metrics import Metrics
from kubeai_tpu.models import llama as jl
from kubeai_tpu.operator.k8s.store import KubeStore
from kubeai_tpu.routing import proxy as proxy_mod
from kubeai_tpu.routing.loadbalancer import LoadBalancer
from kubeai_tpu.routing.modelclient import ModelClient
from kubeai_tpu.routing.openai_server import OpenAIServer
from kubeai_tpu.routing.proxy import ModelProxy
from kubeai_tpu.testing.faults import Fault, FaultPlan, faulty_send
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOK = ByteTokenizer()
PROMPT = "the quick brown fox jumps over the lazy dog"
BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=2)
LAYOUTS = {
    "paged": {},
    # The prompt (43 tokens) and every resumed sequence take the
    # staged-chunk path.
    "paged-chunked": dict(prefill_chunk=8),
    "speculate": dict(speculate=2, spec_adaptive=False),
    "fused": dict(decode_kernel="fused"),
}
SAMPLING = {
    "greedy": dict(temperature=0.0, seed=7),
    "seeded": dict(temperature=0.9, top_k=8, seed=7),
}
MAX_TOKENS = 24
# The seeded stream ends at the stop token after 13 tokens: the last cut
# leaves only that token to generate.
CUTS = (1, 5, 12)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
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
        cache_dtype=jnp.float32, **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids)


def _drain(eng, rid) -> list[int]:
    out = []
    while eng.has_work():
        out += [ev.token for ev in eng.step() if ev.rid == rid]
    return out


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's uninterrupted streams with overlap on, per layout
    and sampling mode: one engine per layout."""
    out = {}
    for layout, kw in LAYOUTS.items():
        eng = _jax_engine(models, step_overlap="on", **kw)
        for mode, sp in SAMPLING.items():
            rid = eng.add_request(TOK.encode(PROMPT), JSamplingParams(
                max_tokens=MAX_TOKENS, **sp))
            out[layout, mode] = _drain(eng, rid)
    return out


@pytest.fixture(scope="module")
def port_engines(models):
    """One port engine per layout and overlap setting; an idle engine
    serves the next request as a fresh replica would."""
    return {(layout, overlap): _port_engine(models, step_overlap=overlap, **kw)
            for layout, kw in LAYOUTS.items() for overlap in ("on", "off")}


# ---- the engine ------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_continuation_token_identical(port_engines, jax_streams, layout,
                                             overlap, mode):
    eng = port_engines[layout, overlap]
    assert eng._overlap == (overlap == "on")
    sp = SamplingParams(max_tokens=MAX_TOKENS, **SAMPLING[mode])
    prompt = TOK.encode(PROMPT)
    ref = _drain(eng, eng.add_request(prompt, sp))
    assert ref == jax_streams[layout, mode]
    assert len(ref) > max(CUTS)
    for cut in CUTS:
        rid = eng.add_request(prompt, sp, resume_tokens=ref[:cut])
        assert _drain(eng, rid) == ref[cut:], cut
    assert not eng.has_work() and eng.num_active == 0


def test_engine_continuation_refusals_match_jax(models, port_engines):
    eng = port_engines["paged", "on"]
    jeng = _jax_engine(models)
    prompt = TOK.encode("hello")
    eos = TOK.eos_token_ids[0]
    cases = [
        (3, [1, 2, 3], "max_tokens"),
        (1000, list(range(130)), "max_seq_len"),
        (24, [5, eos], "stop token"),
    ]
    for max_tokens, resume, fragment in cases:
        with pytest.raises(ValueError, match=fragment) as got:
            eng.add_request(prompt, SamplingParams(max_tokens=max_tokens),
                            resume_tokens=resume)
        with pytest.raises(ValueError) as want:
            jeng.add_request(prompt, JSamplingParams(max_tokens=max_tokens),
                             resume_tokens=resume)
        assert str(got.value) == str(want.value)
    assert not eng.has_work()


# ---- the servers and the mixed fleet ----------------------------------------------


def _pod(name: str, port: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": "default",
            "labels": {"model": "m1"},
            "annotations": {"model-pod-ip": "127.0.0.1", "model-pod-port": str(port)},
        },
        "status": {"conditions": [{"type": "Ready", "status": "True"}],
                   "podIP": "127.0.0.1"},
    }


@pytest.fixture(scope="module")
def fleet(models):
    """One JAX and one port EngineServer on the same weights behind the
    routing proxy and the front door (tests/unit/test_preemption.py's
    `stack`, with one replica of each engine)."""
    jsrv = JEngineServer(_jax_engine(models), JByteTokenizer(), "m1",
                         host="127.0.0.1", port=0)
    tsrv = EngineServer(_port_engine(models), TOK, "m1", port=0)
    store = KubeStore()
    metrics = Metrics()
    lb = LoadBalancer(store, default_timeout=5, metrics=metrics)
    mc = ModelClient(store)
    front = OpenAIServer(ModelProxy(lb, mc, metrics=metrics), mc)
    for srv in (jsrv, tsrv, front):
        srv.start()
    store.create(Model(name="m1", spec=ModelSpec(
        url="hf://org/x", engine="KubeAITPU", features=["TextGeneration"],
        autoscaling_disabled=True, replicas=2, load_balancing=LoadBalancing(),
    )).to_dict())
    store.create(_pod("model-m1-jax", jsrv.port))
    store.create(_pod("model-m1-torch", tsrv.port))
    lb.sync_model("m1")
    yield {"jax": jsrv, "torch": tsrv, "front": front, "lb": lb, "metrics": metrics}
    front.stop()
    lb.stop()
    tsrv.stop()
    jsrv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _post_both(fleet, path: str, body: dict) -> tuple:
    """(status, body) from the JAX server and from the port's."""
    out = []
    for name in ("jax", "torch"):
        status, raw = http_post(_addr(fleet[name]), path, body, timeout=60)
        out.append((status, raw.decode()))
    return tuple(out)


def _sse(raw: str) -> tuple[str, list, int, list]:
    """(text, finish reasons, [DONE] count, token ids) of an SSE body."""
    text, finishes, dones, ids = "", [], 0, []
    for line in raw.splitlines():
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            dones += 1
            continue
        chunk = json.loads(data)
        ids += chunk.get("token_ids", [])
        for ch in chunk.get("choices", []):
            delta = (ch.get("delta") or {}).get("content") or ch.get("text")
            if delta:
                text += delta
            if ch.get("finish_reason"):
                finishes.append(ch["finish_reason"])
    return text, finishes, dones, ids


MALFORMED = [
    ({"kubeai_resume": "nope"}, "must be an object"),
    ({"kubeai_resume": {"token_ids": []}}, "non-empty"),
    ({"kubeai_resume": {"token_ids": [1.5]}}, "non-empty int list"),
    ({"kubeai_resume": {"token_ids": [1], "emitted": -1}}, ">= 0"),
    ({"kubeai_resume": {"token_ids": [1]}, "n": 2}, "n == 1"),
]


@pytest.mark.parametrize("bad,fragment", MALFORMED, ids=lambda v: str(v)[:24])
def test_server_rejects_malformed_resume(fleet, bad, fragment):
    base = {"model": "m1", "prompt": "x", "max_tokens": 8, "stream": True}
    (jst, jbody), (tst, tbody) = _post_both(fleet, "/v1/completions", {**base, **bad})
    assert jst == tst == 400, (bad, jbody, tbody)
    assert json.loads(tbody) == json.loads(jbody)
    assert fragment in json.loads(tbody)["error"]["message"]


@pytest.mark.parametrize("body,fragment", [
    ({"max_tokens": 4, "kubeai_resume": {"token_ids": [1, 2, 3, 4, 5]}},
     "nothing left to generate"),
    ({"max_tokens": 200, "kubeai_resume": {"token_ids": list(range(1, 130))}},
     "leaves no room"),
    ({"max_tokens": 8, "kubeai_resume": {"token_ids": [5, TOK.eos_token_ids[0]]}},
     "stop token"),
], ids=["max_tokens", "no_room", "stop_token"])
def test_server_resume_refusals_match_jax(fleet, body, fragment):
    (jst, jbody), (tst, tbody) = _post_both(
        fleet, "/v1/completions", {"model": "m1", "prompt": "x", **body})
    assert jst == tst == 400
    assert json.loads(tbody) == json.loads(jbody)
    assert fragment in json.loads(tbody)["error"]["message"]
    assert fleet["torch"].engine.num_active == fleet["torch"].engine.num_pending == 0


# The HTTP tests' sampling (tests/unit/test_preemption.py's): streams of
# 32 tokens on the chat prompt.
CHAT_SAMPLING = {
    "greedy": dict(temperature=0.0, seed=11),
    "seeded": dict(temperature=0.8, top_k=8, seed=11),
}


def _chat(mode: str, stream: bool) -> dict:
    return {"model": "m1", "messages": [{"role": "user", "content": PROMPT}],
            "max_tokens": 32, "stream": stream, **CHAT_SAMPLING[mode]}


@pytest.mark.parametrize("mode", list(CHAT_SAMPLING))
@pytest.mark.parametrize("stream", [True, False], ids=["stream", "unary"])
def test_direct_resume_matches_jax(fleet, stream, mode):
    """A continuation POSTed straight to each server: the port answers the
    JAX server's bytes; a stream carries only the text past `emitted` and
    the token ids past the cut."""
    (jst, jraw), (tst, traw) = _post_both(fleet, "/v1/chat/completions", _chat(mode, True))
    assert jst == tst == 200
    ref_text, _, _, ref_ids = _sse(traw)
    assert (ref_text, ref_ids) == _sse(jraw)[::3]
    k = 5
    assert len(ref_ids) > k
    emitted = len(TOK.decode(ref_ids[:k])) - 1  # one character never arrived
    body = {**_chat(mode, stream),
            "kubeai_resume": {"token_ids": ref_ids[:k], "emitted": emitted}}
    (jst, jraw), (tst, traw) = _post_both(fleet, "/v1/chat/completions", body)
    assert jst == tst == 200
    if stream:
        text, finishes, dones, ids = _sse(traw)
        assert (text, finishes, dones, ids) == _sse(jraw)
        assert text == ref_text[emitted:] and dones == 1
        # A token with no text of its own rides on the next chunk, or on
        # none at the end of a stream: compare the ids both streams sent.
        n = min(len(ids), len(ref_ids) - k)
        assert n > 0 and ids[:n] == ref_ids[k:k + n]
    else:
        got, want = json.loads(traw), json.loads(jraw)
        assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
        assert got["choices"][0]["message"]["content"] == ref_text
        assert got["usage"]["completion_tokens"] == len(ref_ids)


def _front_stream(front, body: dict) -> str:
    host, _, port = front.address.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/openai/v1/chat/completions", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    raw = resp.read().decode()
    conn.close()
    return raw


@pytest.mark.parametrize("mode", list(CHAT_SAMPLING))
@pytest.mark.parametrize("victim", ["jax", "torch"], ids=["jax_dies", "torch_dies"])
def test_mixed_fleet_resume(fleet, monkeypatch, victim, mode):
    """The replica that serves the stream dies at its second SSE event;
    the proxy resumes it on the other engine. The client sees the
    uninterrupted text, no error and one [DONE]."""
    lb, front, metrics = fleet["lb"], fleet["front"], fleet["metrics"]
    lb.group("m1").reconcile_endpoints({})  # fresh breaker state
    lb.sync_model("m1")
    body = _chat(mode, True)
    # The uninterrupted stream, from the port's server (equal to the JAX
    # server's: test_direct_resume_matches_jax).
    _, raw = http_post(_addr(fleet["torch"]), "/v1/chat/completions", body, timeout=60)
    ref_text, ref_fin, _, _ = _sse(raw.decode())
    victim_addr = _addr(fleet[victim])
    # Least-load picks the other replica only while it holds a request:
    # hold a pick on the survivor so the stream starts on the victim.
    picks = [lb.await_best_address("m1") for _ in range(2)]
    assert {a for a, _ in picks} == {_addr(fleet["jax"]), _addr(fleet["torch"])}
    for addr, done in picks:
        if addr == victim_addr:
            done()
    plan = FaultPlan([Fault(victim_addr, "die_mid_stream", start=1, end=1,
                            after_events=2)])
    monkeypatch.setattr(proxy_mod, "_send", faulty_send(plan, proxy_mod._send))
    resumes = metrics.proxy_stream_resumes.get(model="m1")
    try:
        raw = _front_stream(front, body)
    finally:
        for addr, done in picks:
            if addr != victim_addr:
                done()
    assert "event: error" not in raw and '"finish_reason": "error"' not in raw
    text, finishes, dones, _ = _sse(raw)
    assert dones == 1
    assert text == ref_text and finishes == ref_fin
    assert plan.counts[victim_addr] == 1
    assert metrics.proxy_stream_resumes.get(model="m1") == resumes + 1
