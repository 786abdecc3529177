"""The TextEmbedding feature in kubeai_tpu_torch against the JAX package,
on the CPU in f32.

- `llama.hidden_states` (`_trunk` over `trunk_layer`, mean-pooled over
  each row's valid tokens, L2-normalized) within 1e-4 of the JAX
  function on the same weights and right-padded tokens with ragged
  lengths, for a tiny llama and a tiny qwen (q/k/v biases drawn nonzero,
  tied embeddings); padding past the lengths leaves a row's vector
  unchanged.
- The model registry: each family's feature and whether it has an
  embedding forward equal the JAX registry's (whisper: SpeechToText;
  gemma: none).
- `POST /v1/embeddings` on EngineServer against the JAX EngineServer on
  the same weights: every status and body of
  kubeai_tpu/engine/server.py::_handle_embeddings (a string, a list, the
  empty input, the 400s, "input too long", gemma's 400), vectors within
  1e-4, `usage`, and the prompt tokens counted on /metrics. The forward
  runs on the serve loop's thread.
"""

import dataclasses
import json
import threading

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
from kubeai_tpu.models import gemma as jg
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models import registry as jregistry
from kubeai_tpu_torch.engine import Engine, EngineConfig
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.metrics import registry as tregistry
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models import registry as tfamilies
from kubeai_tpu_torch.parity import params_from_numpy

TOK = ByteTokenizer()
# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
ENGINE = dict(num_slots=2, max_seq_len=256, page_size=16, decode_chunk=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(family: str, vocab_size: int = 512):
    """(JAX config, JAX params, port config, port params) in f32; qwen's
    q/k/v biases drawn nonzero and its embeddings tied."""
    extra = dict(attention_bias=True, tie_word_embeddings=True) if family == "qwen" else {}
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=vocab_size),
                               dtype=jnp.float32, **extra)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(8)
    for name in ("bq", "bk", "bv"):
        if name in tree["layers"]:
            tree["layers"][name] = rng.normal(0, 0.1, tree["layers"][name].shape).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    if jcfg.tie_word_embeddings:
        jparams["lm_head"] = jparams["embed"]
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=vocab_size),
                               dtype=torch.float32, **extra)
    return jcfg, jparams, tcfg, params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_hidden_states_matches_jax(family):
    jcfg, jparams, tcfg, tparams = _model(family)
    rng = np.random.default_rng(9)
    lengths = np.array([40, 17, 1, 33], np.int32)
    tokens = np.zeros((4, 48), np.int32)
    for row, n in enumerate(lengths):
        tokens[row, :n] = rng.integers(0, jcfg.vocab_size, n)
    want = np.asarray(jl.hidden_states(jparams, jcfg, jnp.asarray(tokens),
                                       jnp.asarray(lengths)))
    got = tl.hidden_states(tparams, tcfg, torch.from_numpy(tokens).long(),
                           torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, tcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)
    # Right padding is masked: row 1 alone at its own length gives its vector.
    alone = tl.hidden_states(tparams, tcfg, torch.from_numpy(tokens[1:2, :17]).long(),
                             torch.tensor([17]))
    np.testing.assert_allclose(alone.numpy()[0], got.numpy()[1], atol=1e-5, rtol=0)


def test_trunk_layer_matches_jax():
    jcfg, jparams, tcfg, tparams = _model("qwen")
    x = np.random.default_rng(10).normal(0, 1, (2, 24, jcfg.hidden_size)).astype(np.float32)
    lp = {k: v[1] for k, v in jparams["layers"].items()}
    want = np.asarray(jl.trunk_layer(jnp.asarray(x), lp, jcfg))
    got = tl.trunk_layer(torch.from_numpy(x), tl._layer(tparams, 1), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["llama", "qwen", "gemma", "whisper"])
def test_registry_features_match_jax(name):
    want, got = jregistry.get_model_family(name), tfamilies.get_model_family(name)
    assert got.feature == want.feature
    assert (got.hidden_states is None) == (getattr(want, "hidden_states", None) is None)
    assert got.hf_architectures == want.hf_architectures
    assert (got.prefill is None) == (want.prefill is None)


def test_engine_refuses_a_family_it_does_not_serve():
    from kubeai_tpu_torch.models import whisper as tw

    with pytest.raises(ValueError, match="whisper family .*SpeechToText"):
        Engine("whisper", tw.WhisperConfig.tiny(), {}, cfg=EngineConfig(**ENGINE),
               device="cpu")


@pytest.fixture(scope="module")
def servers():
    """{"llama": (JAX server, port server), "gemma": (...)} over the same
    tiny f32 weights."""
    out = {}
    jcfg, jparams, tcfg, tparams = _model("llama", TOK.vocab_size)
    jg_cfg = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=TOK.vocab_size),
                                 dtype=jnp.float32)
    jg_params = jg.init_params(jg_cfg, jax.random.PRNGKey(3))
    tg_cfg = dataclasses.replace(tg.GemmaConfig.tiny(vocab_size=TOK.vocab_size),
                                 dtype=torch.float32)
    tg_params = params_from_numpy(jax.tree.map(np.asarray, jg_params), "cpu")
    for fam, (jc, jp, tc, tp) in {"llama": (jcfg, jparams, tcfg, tparams),
                                  "gemma": (jg_cfg, jg_params, tg_cfg, tg_params)}.items():
        jeng = JEngine(fam, jc, jp, cfg=JEngineConfig(
            cache_dtype=jnp.float32, step_overlap="off", **ENGINE),
            eos_token_ids=TOK.eos_token_ids)
        teng = Engine(fam, tc, tp, cfg=EngineConfig(cache_dtype=torch.float32, **ENGINE),
                      eos_token_ids=TOK.eos_token_ids, device="cpu")
        jsrv = JEngineServer(jeng, JByteTokenizer(), "tiny", host="127.0.0.1", port=0)
        tsrv = EngineServer(teng, TOK, "tiny", port=0)
        jsrv.start()
        tsrv.start()
        out[fam] = (jsrv, tsrv)
    yield out
    for jsrv, tsrv in out.values():
        tsrv.stop()
        jsrv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _prompt_tokens(srv) -> float:
    _, body = http_get(_addr(srv), "/metrics")
    parsed = tregistry.parse_prometheus_text(body.decode())
    return parsed.get(("kubeai_engine_prompt_tokens_total", ()), 0.0)


CASES = {
    "string": {"input": "The quick brown fox"},
    "list": {"input": ["a", "bcd efg", "x" * 100, "a longer sentence, with punctuation."]},
    "empty-string": {"input": ""},
    "no-input": {},
    "at-max-len": {"input": "y" * 256},
    "too-long": {"input": ["ok", "z" * 257]},
    "empty-list": {"input": []},
    "not-strings": {"input": [1, 2]},
    "mixed": {"input": ["a", None]},
    "number": {"input": 5},
}


@pytest.mark.parametrize("case", list(CASES))
def test_embeddings_route_matches_jax_server(servers, case):
    jsrv, tsrv = servers["llama"]
    payload = CASES[case]
    before = _prompt_tokens(tsrv), _prompt_tokens(jsrv)
    js, jbody = http_post(_addr(jsrv), "/v1/embeddings", payload, timeout=120)
    ts_, tbody = http_post(_addr(tsrv), "/v1/embeddings", payload, timeout=120)
    jr, tr = json.loads(jbody), json.loads(tbody)
    assert ts_ == js
    after = _prompt_tokens(tsrv), _prompt_tokens(jsrv)
    assert after[0] - before[0] == after[1] - before[1]
    if js != 200:
        assert tr == jr
        return
    assert {k: v for k, v in tr.items() if k != "data"} == \
        {k: v for k, v in jr.items() if k != "data"}
    assert after[0] - before[0] == tr["usage"]["prompt_tokens"] > 0
    assert len(tr["data"]) == len(jr["data"])
    for got, want in zip(tr["data"], jr["data"]):
        assert {k: v for k, v in got.items() if k != "embedding"} == \
            {k: v for k, v in want.items() if k != "embedding"}
        np.testing.assert_allclose(got["embedding"], want["embedding"], atol=ATOL, rtol=0)


def test_gemma_has_no_embeddings_as_in_jax(servers):
    jsrv, tsrv = servers["gemma"]
    js, jbody = http_post(_addr(jsrv), "/v1/embeddings", {"input": "x"})
    ts_, tbody = http_post(_addr(tsrv), "/v1/embeddings", {"input": "x"})
    assert ts_ == js == 400
    assert json.loads(tbody) == json.loads(jbody) == {
        "error": {"message": "model family gemma has no embedding support"}}


def test_embeddings_run_on_the_serve_loop(servers, monkeypatch):
    """The forward runs between two steps, on the serve loop's thread,
    and gives the in-process hidden_states of the bucket-padded batch."""
    _, tsrv = servers["llama"]
    threads = []
    fam = tsrv.engine.family

    def recording(*a, **kw):
        threads.append(threading.current_thread())
        return tl.hidden_states(*a, **kw)

    monkeypatch.setattr(tsrv.engine, "family", dataclasses.replace(fam, hidden_states=recording))
    texts = ["one", "two words"]
    status, body = http_post(_addr(tsrv), "/v1/embeddings", {"input": texts})
    assert status == 200 and threads == [tsrv._loop_thread]
    ids = [TOK.encode(t) for t in texts]
    bucket = tsrv.engine._bucket(max(map(len, ids)))
    tokens = torch.zeros((2, bucket), dtype=torch.long)
    for row, i in enumerate(ids):
        tokens[row, : len(i)] = torch.tensor(i)
    want = tl.hidden_states(tsrv.engine.params, tsrv.engine.model_cfg, tokens,
                            torch.tensor([len(i) for i in ids]))
    got = [d["embedding"] for d in json.loads(body)["data"]]
    assert got == want.tolist()
