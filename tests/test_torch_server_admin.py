"""The engine Pod's entry point and admin surface in kubeai_tpu_torch,
against the JAX package, on the CPU.

- Loader: `weights.load_params` on tiny Hugging Face llama and qwen
  checkpoints that the test builds with `transformers` (safetensors, and
  `.bin` for llama) gives a dict bit-equal to the JAX loader's tree, and
  prefill logits within the tolerance of tests/unit/test_weights.py of
  the Hugging Face model's; `save_safetensors` round-trips through
  `LazyTensors` and the `safetensors` library; `resolve_model_dir`.
- /metrics and /v1/state: after the same requests, the port's
  EngineServer exposes the JAX server's series (names, types, labels)
  and state keys, minus the named lists of unported features, with
  equal counts, KV facts, prefix and speculation stats. The exposition
  format is the JAX registry's byte for byte.
- Drain and the watchdog, on stub engines as the JAX suite drives them
  (tests/unit/test_resilience.py, tests/unit/test_preemption.py).
- `main` in a subprocess with `--device cpu`: serves, reports its boot
  phases, exits 0 on SIGTERM; every unported flag exits non-zero naming
  its ROADMAP item.
- `load_tokenizer` gives the JAX package's ids and eos ids.
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import weights as jweights
from kubeai_tpu.engine.coldstart import ColdStartTracker as JColdStartTracker
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.engine.tokenizer import load_tokenizer as j_load_tokenizer
from kubeai_tpu.metrics import registry as jregistry
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.device import NoCudaDevice
from kubeai_tpu_torch.engine import Engine, EngineConfig, StepEvent
from kubeai_tpu_torch.engine import weights
from kubeai_tpu_torch.engine.coldstart import ColdStartTracker
from kubeai_tpu_torch.engine.engine import EngineDraining
from kubeai_tpu_torch.engine.server import EngineServer, main
from kubeai_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    load_tokenizer,
)
from kubeai_tpu_torch.fleet.profiler import PHASES
from kubeai_tpu_torch.metrics import registry
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX server's series of features the port does not serve yet: the
# object store (ROADMAP A item 9).
UNPORTED_SERIES = {
    "kubeai_objstore_retries_total",
}
# /v1/state keys of features the port does not serve yet: the adapters
# (ROADMAP A item 8).
UNPORTED_STATE_KEYS = {"adapters"}
# Exposition samples whose values count requests and tokens: equal on
# both servers after the same requests.
COUNT_SAMPLES = (
    "kubeai_engine_requests_total",
    "kubeai_engine_prompt_tokens_total",
    "kubeai_engine_generated_tokens_total",
    "kubeai_engine_prefix_cached_tokens_total",
    "kubeai_engine_prefix_prompt_tokens_total",
    "kubeai_engine_spec_proposed_tokens_total",
    "kubeai_engine_spec_accepted_tokens_total",
    "kubeai_engine_queue_wait_seconds_count",
    "kubeai_engine_prefill_seconds_count",
    "kubeai_engine_ttft_seconds_count",
    "kubeai_engine_inter_token_latency_seconds_count",
    "kubeai_engine_e2e_seconds_count",
)
# The Hugging Face parity tolerance of tests/unit/test_weights.py:60-62.
HF_RTOL = HF_ATOL = 2e-3
# Subprocesses: offline, and transformers without TensorFlow or Flax.
SUBPROCESS_ENV = dict(
    os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
    USE_TF="0", USE_FLAX="0", PYTHONPATH=REPO,
)


# ---- checkpoints -----------------------------------------------------------------


def _hf_config(family: str):
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import Qwen2Config

    common = dict(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, max_position_embeddings=512,
    )
    if family == "qwen":  # q/k/v biases and a tied head
        return Qwen2Config(**common, tie_word_embeddings=True)
    return HFLlamaConfig(**common, tie_word_embeddings=False)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{case: (model dir, HF model)}: llama as safetensors and as
    pytorch_model.bin, qwen as safetensors."""
    from transformers import LlamaForCausalLM, Qwen2ForCausalLM

    out = {}
    for family, cls in (("llama", LlamaForCausalLM), ("qwen", Qwen2ForCausalLM)):
        torch.manual_seed(0)
        model = cls(_hf_config(family)).eval()
        if family == "qwen":
            with torch.no_grad():  # HF zero-initialises the biases
                for layer in model.model.layers:
                    for proj in ("q_proj", "k_proj", "v_proj"):
                        getattr(layer.self_attn, proj).bias.normal_(0, 0.1)
        formats = ("safetensors", "bin") if family == "llama" else ("safetensors",)
        for fmt in formats:
            d = tmp_path_factory.mktemp(f"{family}-{fmt}")
            model.save_pretrained(d, safe_serialization=fmt == "safetensors")
            out[f"{family}-{fmt}"] = (str(d), model)
    return out


def _family(case: str) -> str:
    return case.split("-")[0]


@pytest.mark.parametrize("case", ["llama-safetensors", "llama-bin", "qwen-safetensors"])
def test_load_params_bit_equal_to_jax_loader(checkpoints, case):
    model_dir, _ = checkpoints[case]
    hf = weights.load_hf_config(model_dir)
    assert hf == jweights.load_hf_config(model_dir)
    jcfg = jl.LlamaConfig.from_hf_dict(hf)
    tcfg = tl.LlamaConfig.from_hf_dict(hf)
    if case.endswith("bin"):
        assert not any(f.endswith(".safetensors") for f in os.listdir(model_dir))
    want = params_from_numpy(
        jax.tree.map(np.asarray, jweights.load_llama_params(model_dir, jcfg)), "cpu")
    got = weights.load_params(_family(case), model_dir, tcfg, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    if _family(case) == "qwen":
        assert {"bq", "bk", "bv"} <= set(got["layers"])
        assert got["lm_head"] is got["embed"]  # tied
    leaves = [(k, got[k], want[k]) for k in ("embed", "final_norm", "lm_head")]
    leaves += [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
    for name, g, w in leaves:
        assert g.dtype == w.dtype == torch.bfloat16, name
        assert g.shape == w.shape, name
        assert torch.equal(g.view(torch.int16), w.view(torch.int16)), name


@pytest.mark.parametrize("case", ["llama-safetensors", "llama-bin", "qwen-safetensors"])
def test_prefill_logits_match_hf(checkpoints, case):
    model_dir, hf_model = checkpoints[case]
    cfg = dataclasses.replace(
        tl.LlamaConfig.from_hf_dict(weights.load_hf_config(model_dir)),
        dtype=torch.float32)
    params = weights.load_params(
        _family(case), model_dir, cfg, dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 12))
    with torch.no_grad():
        ours, _, _ = tl.prefill(params, cfg, torch.from_numpy(tokens), torch.tensor([12]))
        theirs = hf_model(torch.from_numpy(tokens)).logits[0, -1]
    np.testing.assert_allclose(ours[0].numpy(), theirs.numpy(), rtol=HF_RTOL, atol=HF_ATOL)


def test_save_safetensors_round_trip(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.f32": torch.randn(7, generator=g),
        "c.f16": torch.randn(2, 2, 2, generator=g).to(torch.float16),
        "d.i64": torch.arange(-4, 5),
        "e.i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "f.u8": torch.arange(250, 256, dtype=torch.uint8),
    }
    config = {"architectures": ["LlamaForCausalLM"], "vocab_size": 7}
    weights.save_safetensors(str(tmp_path), tensors, config)
    assert weights.load_hf_config(str(tmp_path)) == config
    lazy = weights.LazyTensors(str(tmp_path))
    assert set(lazy.keys()) == set(tensors)
    theirs = load_file(str(tmp_path / "model.safetensors"))
    for name, t in tensors.items():
        assert torch.equal(lazy[name], t.to(torch.float32)), name
        assert theirs[name].dtype == t.dtype and torch.equal(theirs[name], t), name
    with pytest.raises(KeyError):
        lazy["missing"]


def test_resolve_model_dir(tmp_path):
    assert weights.resolve_model_dir(str(tmp_path)) == str(tmp_path)
    for url in ("pvc://models/llama/8b", "pvc://models", "pvc://models/x"):
        assert weights.resolve_model_dir(url) == jweights.resolve_model_dir(url)
    assert weights.resolve_model_dir("pvc://models/llama") == "/model/llama"
    assert weights.resolve_model_dir("s3://b/m", model_dir=str(tmp_path)) == str(tmp_path)
    with pytest.raises(weights.WeightLoadError, match="ROADMAP A item 9"):
        weights.resolve_model_dir("s3://bucket/model")
    with pytest.raises(weights.WeightLoadError, match="unsupported model url"):
        weights.resolve_model_dir(str(tmp_path / "absent"))
    with pytest.raises(weights.WeightLoadError, match="no safetensors"):
        weights.LazyTensors(str(tmp_path))
    with pytest.raises(weights.WeightLoadError, match="ROADMAP A item 10"):
        weights.load_params("mixtral", str(tmp_path), None, device="cpu")


# ---- /metrics and /v1/state against the JAX server ---------------------------------

ENGINE = dict(num_slots=4, max_seq_len=256, page_size=16, decode_chunk=4,
              prefill_chunk=32, prefix_cache=True, speculate=2,
              spec_adaptive=False, step_overlap="off")
SYSTEM = "You answer in one word. " * 3  # 72 bytes: four full pages
TRAFFIC = [
    ("/v1/chat/completions", {
        "messages": [{"role": "system", "content": SYSTEM},
                     {"role": "user", "content": "Hello, how are you?"}],
        "max_tokens": 12, "temperature": 0}),
    ("/v1/chat/completions", {  # the same system prompt: a prefix hit
        "messages": [{"role": "system", "content": SYSTEM},
                     {"role": "user", "content": "What is up?"}],
        "max_tokens": 10, "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "Once upon a time", "max_tokens": 9,
                         "temperature": 0.8, "seed": 3}),
]


def _fake_clock():
    t = iter(np.arange(100.0, 200.0, 0.25))
    return lambda: float(next(t))


def _boot(tracker):
    with tracker.phase("load"):
        pass
    with tracker.phase("compile"):
        pass
    with tracker.phase("warmup"):
        pass
    tracker.finish()
    return tracker.snapshot()


def test_cold_start_tracker_matches_jax():
    assert _boot(ColdStartTracker(_fake_clock())) == _boot(JColdStartTracker(_fake_clock()))


@pytest.fixture(scope="module")
def served():
    """One JAX and one port EngineServer over the same tiny f32 weights,
    each after the same TRAFFIC: (JAX server, port server, JAX engine)."""
    tok = ByteTokenizer()
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=tok.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=tok.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, **ENGINE), eos_token_ids=tok.eos_token_ids)
    teng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **ENGINE),
        eos_token_ids=tok.eos_token_ids, device="cpu")
    cold = _boot(ColdStartTracker(_fake_clock()))
    jsrv = JEngineServer(jeng, JByteTokenizer(), "tiny", host="127.0.0.1", port=0,
                         cold_start=cold)
    tsrv = EngineServer(teng, tok, "tiny", port=0, cold_start=cold)
    for srv in (jsrv, tsrv):
        srv.start()
        for path, body in TRAFFIC:
            status, _ = http_post(f"127.0.0.1:{srv.port}", path, body, timeout=120)
            assert status == 200
    yield jsrv, tsrv, jeng
    tsrv.stop()
    jsrv.stop()


def _scrape(srv) -> tuple[str, dict]:
    status, body = http_get(f"127.0.0.1:{srv.port}", "/metrics")
    assert status == 200
    text = body.decode()
    return text, jregistry.parse_prometheus_text(text)


def _types(text: str) -> dict:
    return dict(line.split()[2:4] for line in text.splitlines()
                if line.startswith("# TYPE "))


def _series(parsed: dict) -> set:
    """(sample name, labels) of every exposed sample, with the step
    phase's name masked: the two engines time different phases (the
    port's synchronous loop records its wait on the device as
    overlap_idle), drawn from one vocabulary."""
    step = "kubeai_engine_step_phase_seconds"
    return {(name, tuple((k, "*" if k == "phase" and name.startswith(step) else v)
                         for k, v in labels))
            for name, labels in parsed}


def test_metrics_series_match_jax(served):
    jsrv, tsrv, _ = served
    jtext, jparsed = _scrape(jsrv)
    ttext, tparsed = _scrape(tsrv)
    jtypes, ttypes = _types(jtext), _types(ttext)
    assert UNPORTED_SERIES <= set(jtypes)
    assert ttypes == {k: v for k, v in jtypes.items() if k not in UNPORTED_SERIES}

    def ported(parsed):
        return {k: v for k, v in parsed.items()
                if not any(k[0].startswith(u) for u in UNPORTED_SERIES)}

    assert _series(ported(tparsed)) == _series(ported(jparsed))
    phases = {v for name, labels in tparsed for k, v in labels
              if name.startswith("kubeai_engine_step_phase") and k == "phase"}
    assert phases and phases <= set(PHASES)
    counts = {}
    for name in COUNT_SAMPLES:
        got = {k: v for k, v in tparsed.items() if k[0] == name}
        want = {k: v for k, v in jparsed.items() if k[0] == name}
        assert got == want, name
        counts[name] = sum(got.values())
    assert counts["kubeai_engine_requests_total"] == len(TRAFFIC)
    assert counts["kubeai_engine_ttft_seconds_count"] == len(TRAFFIC)
    assert counts["kubeai_engine_prefix_cached_tokens_total"] > 0
    assert counts["kubeai_engine_spec_proposed_tokens_total"] > 0
    gen = sum(b["max_tokens"] for _, b in TRAFFIC)
    assert counts["kubeai_engine_generated_tokens_total"] == gen
    assert counts["kubeai_engine_inter_token_latency_seconds_count"] == gen - len(TRAFFIC)
    # The same histogram buckets; the TTFT histogram's count read back
    # through hist_buckets.
    for name in ("kubeai_engine_ttft_seconds", "kubeai_engine_inter_token_latency_seconds"):
        tb, tn, _ = registry.hist_buckets(tparsed, name)
        jb, jn, _ = jregistry.hist_buckets(jparsed, name)
        assert [b for b, _ in tb] == [b for b, _ in jb] and tn == jn
    assert registry.lint_registry(tsrv.metrics.registry) == []
    for name in ("kubeai_coldstart_phase_seconds", "kubeai_coldstart_total_seconds",
                 "kubeai_coldstart_restored"):
        assert ({k: v for k, v in tparsed.items() if k[0] == name}
                == {k: v for k, v in jparsed.items() if k[0] == name}), name


def test_exposition_format_is_the_jax_registry_bytes():
    def fill(reg_mod):
        reg = reg_mod.Registry()
        c = reg_mod.Counter("kubeai_x_total", "A counter.", reg)
        g = reg_mod.Gauge("kubeai_g", 'Quotes " and \\ in help.', reg)
        h = reg_mod.Histogram("kubeai_h_seconds", "A histogram.", reg,
                              buckets=(0.001, 0.5, 1, 2.5))
        reg_mod.Gauge("kubeai_empty", "Never set.", reg)
        c.inc(3, model="m")
        c.inc(2.5, model='q"x\\y')
        g.set(2**60, **{"class": "batch"})
        g.set(0.1 + 0.2)
        for v in (0.0005, 0.3, 0.7, 3.0, 3.0):
            h.observe(v, exemplar="rid-1", phase="decode")
        return reg.expose(), h.exemplars(phase="decode"), h.get(phase="decode")

    assert fill(registry) == fill(jregistry)


@pytest.mark.parametrize("seconds", [None, "x", float("nan"), float("inf"), -1.0, 0.0,
                                     0.1, 2.5, 42.0, 1e9])
def test_retry_after_matches_jax(monkeypatch, seconds):
    from kubeai_tpu.utils import retryafter as jretryafter
    from kubeai_tpu_torch.utils import retryafter

    for r in (0.0, 0.37, 1.0):  # the jitter draw, pinned on both sides
        monkeypatch.setattr(retryafter, "_jitter", lambda: r)
        monkeypatch.setattr(jretryafter, "_jitter", lambda: r)
        for kw in ({}, {"min_s": 1.0}):
            got = retryafter.jittered(seconds, **kw)
            assert got == jretryafter.jittered(seconds, **kw)
            assert retryafter.format_header(got) == jretryafter.format_header(got)
    assert retryafter.format_header(seconds) == jretryafter.format_header(seconds)


def test_state_matches_jax(served):
    jsrv, tsrv, jeng = served
    _, jbody = http_get(f"127.0.0.1:{jsrv.port}", "/v1/state")
    _, tbody = http_get(f"127.0.0.1:{tsrv.port}", "/v1/state")
    jstate, tstate = json.loads(jbody), json.loads(tbody)
    assert UNPORTED_STATE_KEYS <= set(jstate)
    assert set(tstate) == set(jstate) - UNPORTED_STATE_KEYS
    for key in ("kv_cache", "prefix_stats", "spec_stats", "cold_start", "model",
                "healthy", "draining", "slots_active", "requests_pending",
                "kv_utilization", "role", "pending_handoffs", "kv_sharing",
                "kv_share"):
        assert tstate[key] == jstate[key], key
    assert tstate["prefix_stats"]["hit_tokens"] > 0
    assert set(tstate["scheduler"]) == set(jstate["scheduler"])
    assert set(tstate["last_step"]) == set(jstate["last_step"])
    # Both servers publish holdings only with KV sharing on; the prefix
    # cache's chain itself equals the JAX engine's.
    assert tstate["kv_holdings"] == jstate["kv_holdings"] == []
    holdings = tsrv.engine.prefix_holdings()
    assert holdings and sorted(holdings) == sorted(jeng.prefix_holdings())
    assert set(tstate["exemplars"]["ttft"].values()) <= {f"rid-{i}" for i in range(10)}


def test_engine_kv_facts_match_jax(served):
    _, tsrv, jeng = served
    assert tsrv.engine.kv_cache_info() == jeng.kv_cache_info()
    assert tsrv.engine.kv_utilization() == jeng.kv_utilization()


# ---- drain and watchdog on stub engines -----------------------------------------


class _ScriptedEngine:
    """Engine stand-in: one token per step per request after a fixed
    step delay (tests/unit/test_resilience.py's, with the port's types)."""

    def __init__(self, step_delay=0.005):
        self.cfg = types.SimpleNamespace(max_seq_len=4096)
        self.step_delay = step_delay
        self._lock = threading.Lock()
        self._next = 0
        self._reqs: dict[int, int] = {}
        self._draining = False

    def add_request(self, prompt, sp, on_admit=None, priority=None, client="",
                    deadline_ms=None):
        with self._lock:
            if self._draining:
                raise EngineDraining("engine is draining")
            rid = self._next
            self._next += 1
            if on_admit is not None:
                on_admit(rid)
            self._reqs[rid] = sp.max_tokens
            return rid

    def begin_drain(self):
        with self._lock:
            self._draining = True

    def cancel(self, rid):
        with self._lock:
            return self._reqs.pop(rid, None) is not None

    def has_work(self):
        return bool(self._reqs)

    def step(self):
        time.sleep(self.step_delay)
        evs = []
        with self._lock:
            for rid in list(self._reqs):
                self._reqs[rid] -= 1
                finished = self._reqs[rid] <= 0
                evs.append(StepEvent(rid, 0x61 + rid % 20, finished,
                                     "stop" if finished else ""))
                if finished:
                    del self._reqs[rid]
        return evs

    @property
    def num_active(self):
        return len(self._reqs)

    num_pending = 0


def _stream_request(port, max_tokens, results, key):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/completions", body=json.dumps(
        {"prompt": "hello", "max_tokens": max_tokens, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    results[key] = {"status": resp.status, "body": resp.read().decode()}
    conn.close()


@pytest.fixture
def scripted_server():
    made = []

    def make(**kw):
        step_delay = kw.pop("step_delay", 0.005)
        srv = EngineServer(_ScriptedEngine(step_delay), ByteTokenizer(), "scripted",
                           port=0, **kw)
        srv.start()
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.stop()


def test_drain_completes_inflight_and_refuses_new(scripted_server):
    srv = scripted_server(drain_timeout=10.0)
    addr = f"127.0.0.1:{srv.port}"
    results: dict = {}
    threads = [threading.Thread(target=_stream_request, args=(srv.port, 60, results, i))
               for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # streams are in flight
    status, body = http_post(addr, "/v1/drain", {})
    assert status == 202 and json.loads(body)["draining"] is True
    status, body = http_get(addr, "/health")
    assert status == 503 and json.loads(body)["draining"] is True
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request("POST", "/v1/completions",
                 body=json.dumps({"prompt": "new", "max_tokens": 4}).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 503
    assert float(resp.getheader("Retry-After")) >= 1.0
    assert (resp.getheader("Connection") or "").lower() == "close"
    assert json.loads(resp.read())["draining"] is True
    conn.close()
    for t in threads:
        t.join(timeout=15)
        assert not t.is_alive()
    assert srv.wait_drained(timeout=15)
    for i in range(3):
        assert results[i]["status"] == 200
        assert '"finish_reason": "stop"' in results[i]["body"]
        assert "data: [DONE]" in results[i]["body"]
    assert http_get(addr, "/v1/drain")[0] == 202  # the preStop GET alias
    assert srv.metrics.draining.get() == 1


def test_drain_budget_expiry_terminates_streams_cleanly(scripted_server):
    srv = scripted_server(drain_timeout=0.3, step_delay=0.02)
    results: dict = {}
    t = threading.Thread(target=_stream_request, args=(srv.port, 1000, results, "r"))
    t.start()
    time.sleep(0.1)
    assert http_post(f"127.0.0.1:{srv.port}", "/v1/drain", {})[0] == 202
    assert srv.wait_drained(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    body = results["r"]["body"]
    assert results["r"]["status"] == 200
    assert '"finish_reason": "length"' in body and "data: [DONE]" in body
    assert srv.metrics.drain_terminated.get() == 1


class _StuckEngine:
    """has_work() forever, step() never progresses: a wedged device."""

    def __init__(self):
        self.cfg = types.SimpleNamespace(max_seq_len=128)
        self._block = threading.Event()

    def has_work(self):
        return True

    def step(self):
        self._block.wait(timeout=30)
        return []

    def cancel(self, rid):
        return False

    num_active = 1
    num_pending = 0


class _IdleEngine(_StuckEngine):
    def has_work(self):
        return False

    def step(self):
        return []


def test_watchdog_flips_health_and_fires_action():
    fired = threading.Event()
    srv = EngineServer(_StuckEngine(), ByteTokenizer(), "m1", port=0,
                       watchdog_timeout=0.2, watchdog_action=fired.set)
    srv.start()
    try:
        assert fired.wait(timeout=5.0), "watchdog never fired"
        assert not srv.healthy() and srv.wedged
        status, body = http_get(f"127.0.0.1:{srv.port}", "/health")
        assert status == 503 and json.loads(body)["status"] == "wedged"
        assert srv.metrics.watchdog_stalls.get() == 1
        assert srv.metrics.watchdog_wedged.get() == 1
    finally:
        srv._stop.set()
        srv.engine._block.set()
        srv.stop()


def test_watchdog_ignores_idle_engine():
    srv = EngineServer(_IdleEngine(), ByteTokenizer(), "m1", port=0,
                       watchdog_timeout=0.1, watchdog_action=lambda: None)
    srv.start()
    try:
        time.sleep(0.5)  # several watchdog polls with zero work
        assert srv.healthy() and not srv.wedged
        assert http_get(f"127.0.0.1:{srv.port}", "/health")[0] == 200
    finally:
        srv.stop()


# ---- main ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# (extra flags, extra environment, a /v1/state stat that must be > 0)
MAIN_CONFIGS = {
    "default": ([], {}, None),
    "speculate": (["--speculate", "2", "--spec-adaptive", "off"], {},
                  ("spec_stats", "windows")),
    "fused-prefix": (["--prefix-cache"], {"KUBEAI_TPU_DECODE_KERNEL": "fused"},
                     ("prefix_stats", "lookups")),
}


@pytest.mark.parametrize("config", list(MAIN_CONFIGS))
def test_main_serves_a_checkpoint_and_drains_on_sigterm(checkpoints, tmp_path, config):
    flags, env, stat = MAIN_CONFIGS[config]
    model_dir, _ = checkpoints["llama-safetensors"]
    port = _free_port()
    log_path = tmp_path / "server.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeai_tpu_torch.engine.server",
             "--model-url", model_dir, "--port", str(port), "--host", "127.0.0.1",
             "--device", "cpu", "--num-slots", "2", "--max-seq-len", "128",
             "--drain-timeout", "10", "--watchdog-timeout", "60", *flags],
            cwd=REPO, env=dict(SUBPROCESS_ENV, **env), stdout=log,
            stderr=subprocess.STDOUT,
        )
    addr = f"127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, log_path.read_text()
            try:
                if http_get(addr, "/health", timeout=2)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "server never became ready"
            time.sleep(0.2)
        status, body = http_post(addr, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
            "temperature": 0}, timeout=60)
        assert status == 200
        assert json.loads(body)["usage"]["completion_tokens"] == 6
        status, body = http_post(addr, "/v1/completions", {
            "prompt": "abc", "max_tokens": 4, "temperature": 0}, timeout=60)
        assert status == 200
        state = json.loads(http_get(addr, "/v1/state")[1])
        assert set(state["cold_start"]["phases"]) == {"load", "compile", "warmup"}
        assert state["cold_start"]["restored"] is False
        assert state["kv_cache"]["slot_capacity"] == 2
        if stat is not None:
            assert state[stat[0]][stat[1]] > 0, state[stat[0]]
        parsed = jregistry.parse_prometheus_text(http_get(addr, "/metrics")[1].decode())
        # The warm-up's two generates are not counted.
        assert parsed[("kubeai_engine_ttft_seconds_count", ())] == 2
        assert parsed[("kubeai_engine_requests_total", (("model", "model"),))] == 2
        assert parsed[("kubeai_coldstart_phase_seconds", (("phase", "load"),))] > 0
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = log_path.read_text()
    assert proc.returncode == 0, out
    assert "tokenizer: ByteTokenizer" in out and "drain complete" in out


@pytest.mark.parametrize("argv,item", [
    (["--tpu-topology", "2x2"], 11),
    (["--num-processes", "2"], 11),
    (["--dcn-coordinator", "10.0.0.1:8476"], 11),
    (["--quantization", "int8"], 9),
    (["--draft-url", "pvc://models/draft"], 10),
    (["--kv-spill-url", "s3://bucket/spill"], 9),
    (["--snapshot-url", "file:///snapshots"], 9),
    (["--snapshot-dir", "/snapshots"], 9),
    (["--snapshot-no-publish"], 9),
    (["--max-adapters", "4"], 8),
], ids=lambda v: v if isinstance(v, int) else "_".join(v).lstrip("-"))
def test_main_refuses_unported_flags(checkpoints, argv, item):
    model_dir, _ = checkpoints["llama-safetensors"]
    with pytest.raises(SystemExit) as e:
        main(["--model-url", model_dir, "--device", "cpu", *argv])
    assert isinstance(e.value.code, str) and f"ROADMAP A item {item}" in e.value.code


class _ServerBuilt(Exception):
    pass


@pytest.mark.parametrize("argv,role,sharing", [
    (["--role", "prefill"], "prefill", False),
    (["--role", "decode", "--max-transfer-mb", "64"], "decode", False),
    (["--kv-sharing", "--kv-spill-url", ""], "unified", True),
    (["--kv-dtype", "int8"], "unified", False),
], ids=["role_prefill", "role_decode", "kv-sharing", "kv-dtype-int8"])
def test_main_serves_roles_and_sharing(checkpoints, monkeypatch, argv, role, sharing):
    """The disaggregation, KV-sharing and KV-dtype flags: main builds the
    engine (int8 pools with --kv-dtype int8) and hands the server the
    role, the transfer limit and, with --kv-sharing, the prefix cache and
    an in-memory spill store."""
    from kubeai_tpu_torch.engine import server as server_mod
    from kubeai_tpu_torch.objstore import KVSpillStore

    args = server_mod.parse_args(["--model-url", "x", *argv])
    assert args.role == role and args.kv_sharing is sharing
    assert args.prefix_cache is sharing and (args.prefill_chunk > 0) is sharing
    built = {}

    def capture(engine, tokenizer, name, **kw):
        built.update(kw, engine=engine)
        raise _ServerBuilt

    monkeypatch.setattr(server_mod, "EngineServer", capture)
    model_dir, _ = checkpoints["llama-safetensors"]
    with pytest.raises(_ServerBuilt):
        main(["--model-url", model_dir, "--device", "cpu", "--num-slots", "2",
              "--max-seq-len", "128", *argv])
    assert built["role"] == role and built["kv_sharing"] is sharing
    assert built["max_transfer_mb"] == (64 if role == "decode" else 0)
    assert isinstance(built["kv_spill_store"], KVSpillStore) is sharing
    assert built["engine"]._prefix_cache is sharing
    assert built["engine"].kv_cache_info()["quantized"] is ("int8" in argv)


@pytest.mark.parametrize("arch,url,reason", [
    ("GemmaForCausalLM", None, "ROADMAP A item 10"),
    ("MixtralForCausalLM", None, "ROADMAP A item 10"),
    ("WhisperForConditionalGeneration", None, "ROADMAP A item 10"),
    (None, "gs://bucket/llama", "ROADMAP A item 9"),
    ("GPT2LMHeadModel", None, "unknown model family"),
    (None, None, "no config.json"),
], ids=["gemma", "mixtral", "whisper", "object-store", "unknown", "no-config"])
def test_main_refuses_unported_models(tmp_path, arch, url, reason):
    if arch is not None:
        (tmp_path / "config.json").write_text(json.dumps({"architectures": [arch]}))
    with pytest.raises(SystemExit) as e:
        main(["--model-url", url or str(tmp_path), "--device", "cpu"])
    assert isinstance(e.value.code, str) and reason in e.value.code


def test_main_without_a_card_raises(checkpoints):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_dir, _ = checkpoints["llama-safetensors"]
    with pytest.raises(NoCudaDevice):
        main(["--model-url", model_dir])


# ---- tokenizer ----------------------------------------------------------------------


def test_load_tokenizer_matches_jax(tmp_path):
    from tokenizers import Tokenizer as RawTokenizer
    from tokenizers import models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["hello", "world", "how", "are", "you", "user:", "assistant:",
             "system:", "be", "brief."]
    vocab = {"[UNK]": 0, "</s>": 1, "<|eot_id|>": 2, "<|im_end|>": 3}
    vocab.update({w: i + 4 for i, w in enumerate(words)})
    raw = RawTokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(
        tokenizer_object=raw, unk_token="[UNK]", eos_token="</s>",
        additional_special_tokens=["<|eot_id|>", "<|im_end|>"],
    ).save_pretrained(tmp_path)
    got, want = load_tokenizer(str(tmp_path)), j_load_tokenizer(str(tmp_path))
    assert isinstance(got, HFTokenizer) and type(want).__name__ == "HFTokenizer"
    # eos, then the end-of-turn tokens (an absent one maps to [UNK], as
    # in the JAX package).
    assert got.eos_token_ids == want.eos_token_ids
    assert got.eos_token_ids[:3] == (1, 2, 3)
    text = "hello world how are you zebra"
    assert got.encode(text) == want.encode(text)
    msgs = [{"role": "system", "content": "be brief."},
            {"role": "user", "content": [{"type": "text", "text": "how are you"}]}]
    assert got.apply_chat_template(msgs) == want.apply_chat_template(msgs)
    ids = got.encode(text)
    assert got.decode(ids + [1]) == want.decode(ids + [1])
    # A checkpoint without tokenizer files (config.json only, which some
    # transformers versions turn into an empty tokenizer), an empty
    # directory, none.
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "config.json").write_text(json.dumps(
        {"architectures": ["LlamaForCausalLM"], "model_type": "llama"}))
    empty = tmp_path / "empty"
    empty.mkdir()
    for model_dir in (str(bare), str(empty), None, str(tmp_path / "absent")):
        assert isinstance(load_tokenizer(model_dir), ByteTokenizer)
    assert ByteTokenizer().encode("hé") == JByteTokenizer().encode("hé")
