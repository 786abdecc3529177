"""kubeai_tpu_torch.engine.server.EngineServer over a CPU engine, driven
over a real socket on 127.0.0.1: /health, /v1/models, unary and SSE
completions. The greedy content and usage counts equal those of
kubeai_tpu's EngineServer for the same request and weights (f32)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import Engine, EngineConfig
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


ENGINE = dict(num_slots=4, max_seq_len=256, page_size=16, decode_chunk=4)
REQUESTS = [
    ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Hello, how are you?"}],
        "max_tokens": 24, "temperature": 0}),
    ("/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "x" * 90}],
        "max_tokens": 17, "temperature": 0}),
    ("/v1/completions", {"prompt": "Once upon a time", "max_tokens": 20,
                         "temperature": 0}),
    ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "seeded"}],
        "max_tokens": 15, "temperature": 0.9, "top_k": 20, "seed": 5}),
]


@pytest.fixture(scope="module")
def servers():
    tok = ByteTokenizer()
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=tok.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=tok.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **ENGINE),
        eos_token_ids=tok.eos_token_ids)
    teng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **ENGINE),
        eos_token_ids=tok.eos_token_ids, device="cpu")
    jsrv = JEngineServer(jeng, JByteTokenizer(), "tiny", host="127.0.0.1", port=0)
    tsrv = EngineServer(teng, tok, "tiny", port=0)
    jsrv.start()
    tsrv.start()
    yield f"127.0.0.1:{jsrv.port}", f"127.0.0.1:{tsrv.port}"
    tsrv.stop()
    jsrv.stop()


def _sse(body: bytes) -> list:
    events = []
    for line in body.decode().splitlines():
        if line.startswith("data: "):
            events.append(line[6:])
    return events


def test_health_and_models(servers):
    _, addr = servers
    assert http_get(addr, "/health")[0] == 200
    status, body = http_get(addr, "/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(body)["data"]] == ["tiny"]
    assert http_get(addr, "/nope")[0] == 404


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_unary_matches_jax_server(servers, i):
    jaddr, taddr = servers
    path, payload = REQUESTS[i]
    js, jbody = http_post(jaddr, path, payload, timeout=120)
    ts_, tbody = http_post(taddr, path, payload, timeout=120)
    assert js == ts_ == 200
    jr, tr = json.loads(jbody), json.loads(tbody)
    assert tr["object"] == jr["object"] and tr["model"] == jr["model"] == "tiny"
    assert tr["usage"] == jr["usage"]
    assert 0 < tr["usage"]["completion_tokens"] <= payload["max_tokens"]
    assert set(tr["choices"][0]) == set(jr["choices"][0])
    if "messages" in payload:
        assert tr["choices"][0]["message"] == jr["choices"][0]["message"]
    else:
        assert tr["choices"][0]["text"] == jr["choices"][0]["text"]
    assert tr["choices"][0]["finish_reason"] == jr["choices"][0]["finish_reason"]


def test_sse_stream_matches_unary(servers):
    """The stream's text equals the unary content, and its chunks carry
    the same choices and token_ids as the JAX server's stream."""
    jaddr, addr = servers
    path, payload = REQUESTS[0]
    _, unary = http_post(addr, path, payload, timeout=120)
    streams = []
    for a in (jaddr, addr):
        status, body = http_post(a, path, dict(payload, stream=True), timeout=120)
        assert status == 200
        events = _sse(body)
        assert events[-1] == "[DONE]"
        streams.append([json.loads(e) for e in events[:-1]])
    jchunks, chunks = streams
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == json.loads(unary)["choices"][0]["message"]["content"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"

    def shape(cs):
        return [(sorted(c), c["choices"], c.get("token_ids")) for c in cs]

    assert shape(chunks) == shape(jchunks)


def test_stop_string(servers):
    _, addr = servers
    path, payload = REQUESTS[2]
    _, body = http_post(addr, path, payload, timeout=120)
    full = json.loads(body)["choices"][0]["text"]
    stop = full[3:5]
    _, body = http_post(addr, path, dict(payload, stop=stop), timeout=120)
    choice = json.loads(body)["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["text"] == full[: full.find(stop)]


@pytest.mark.parametrize("path,payload,status", [
    ("/v1/chat/completions", {"model": "other", "messages": []}, 404),
    ("/v1/chat/completions", {"messages": [], "max_tokens": 0}, 400),
    ("/v1/chat/completions", {"messages": [], "n": 9}, 400),
    ("/v1/chat/completions", {"messages": [], "top_p": 0.0}, 400),
    ("/v1/completions", {"prompt": "x" * 300}, 400),
])
def test_request_errors(servers, path, payload, status):
    _, addr = servers
    assert http_post(addr, path, payload)[0] == status


def test_bad_json_and_bad_priority(servers):
    import http.client

    _, addr = servers
    host, _, port = addr.partition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request("POST", "/v1/completions", b"{nope", {"Content-Type": "application/json"})
    assert conn.getresponse().status == 400
    conn.close()
    status, _ = http_post(addr, "/v1/completions", {"prompt": "a"},
                          headers={"X-Priority": "urgent"})
    assert status == 400
