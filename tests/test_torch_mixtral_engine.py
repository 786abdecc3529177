"""Mixtral through kubeai_tpu_torch's engine and entry point against the
JAX package's, on the CPU in f32 (the model functions are in
tests/test_torch_mixtral.py, whose tiny model this file serves).

- Streams: greedy and seeded streams identical to the JAX engine's in the
  paged per_layer and fused layouts, the slot cache, chunked prefill with
  the prefix cache (hits), int8 pools, speculate=2 (both fall back to
  vanilla decode: mixtral has no verify forward) and a pool that forces
  preemption.
- Handoffs: a handoff the JAX engine exports continues the JAX stream in
  the port's engine, and the reverse.
- Refusals: a draft model (both engines, the same message), adapters
  (fault C10: the JAX engine loads one and ignores it, the port refuses
  the load), int8 weights (fault C15, at construction and at boot), and
  the card's head-dim check passes Mixtral-8x7B's head_dim 128 on B2, B1,
  B4 and B1-int8.
- `main` on a tiny HF-named mixtral checkpoint: the engine it builds
  serves chat completions over HTTP equal to an in-process engine's;
  /v1/embeddings answers 400 as the JAX server does, and
  /v1/load_lora_adapter 400 naming C10.

The JAX engines run each scenario once per module, with step_overlap off.
"""

import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_post
from torch_mixtral_fixtures import hf_config, mixtral_models, write_mixtral_checkpoint

from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineServer as JEngineServer
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.engine import refuse_kernel_head_dims
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import mixtral as tm
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.ops import kv_quant as tkq

TOK = ByteTokenizer()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return mixtral_models()


BASE = dict(num_slots=4, max_seq_len=64, page_size=8, decode_chunk=4)
# EngineConfig extras of each scenario. "tight" holds 10 pages for 4
# slots of up to 5 pages each: decode preempts.
SCENARIOS = {
    "per_layer": {},
    "fused": dict(decode_kernel="fused"),
    "slot": dict(cache_mode="slot"),
    "prefix": dict(prefill_chunk=16, prefix_cache=True),
    "int8": dict(kv_dtype="int8"),
    "speculate": dict(speculate=2, spec_adaptive=False),
    "tight": dict(num_pages=1 + 10),
}
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=10),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=10, seed=5),
}
MODES = ["greedy", "seeded", "greedy", "seeded", "greedy"]


def _prompts():
    """Five prompts, two over one 18-token system prompt (the prefix
    scenario's hit), more prompts than slots, all in the 32-token prefill
    bucket (one JAX prefill program an engine)."""
    rng = np.random.default_rng(8)
    system = rng.integers(1, 256, 18).tolist()
    return [system + rng.integers(1, 256, 5).tolist(),
            system + rng.integers(1, 256, 9).tolist(),
            rng.integers(1, 256, 20).tolist(),
            rng.integers(1, 256, 27).tolist(),
            rng.integers(1, 256, 19).tolist()]


def _run(eng, sp_cls) -> list[list[int]]:
    rids = [eng.add_request(p, sp_cls(**SAMPLING[m])) for p, m in zip(_prompts(), MODES)]
    out = {rid: [] for rid in rids}
    while eng.has_work():
        for ev in eng.step():
            out[ev.rid].append(ev.token)
    return [out[rid] for rid in rids]


def _jax_engine(models, **kw):
    jcfg, jp, _, _ = models
    return JEngine("mixtral", jcfg, jp, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids)


def _port_engine(models, **kw):
    _, _, tcfg, tp = models
    return Engine("mixtral", tcfg, tp, cfg=EngineConfig(
        cache_dtype=torch.float32, **{**BASE, **kw}),
        eos_token_ids=TOK.eos_token_ids, device="cpu")


@pytest.fixture(scope="module")
def jax_side(models):
    """Each scenario's JAX streams and prefix stats, and the per_layer
    JAX engine (for the handoffs and the server)."""
    out = {}
    for name, kw in SCENARIOS.items():
        eng = _jax_engine(models, **kw)
        out[name] = (_run(eng, JSamplingParams), dict(eng.prefix_stats))
        if name == "per_layer":
            out["engine"] = eng
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_streams_identical_to_jax(models, jax_side, scenario, caplog):
    with caplog.at_level(logging.WARNING):
        eng = _port_engine(models, **SCENARIOS[scenario])
    assert eng._overlap
    preempted = []
    eng.on_preempt = lambda rid, client: preempted.append(rid)
    got = _run(eng, SamplingParams)
    streams, prefix_stats = jax_side[scenario]
    assert got == streams
    assert all(len(s) == 10 for s in got)
    assert eng.prefix_stats == prefix_stats
    assert len({tuple(s) for s in got}) == len(got)  # the prompts lead somewhere apart
    if scenario == "prefix":
        assert eng.prefix_stats["hit_tokens"] > 0
    if scenario == "speculate":  # no verify forward: vanilla decode
        assert eng._spec == 0 and "no verify forward" in caplog.text
    if scenario == "tight":
        assert preempted, "the tight pool must force a preemption"
    if scenario == "int8":
        assert isinstance(eng.cache.k_pages, tkq.QuantizedPool)
    if scenario == "slot":
        assert eng.cache_mode == "slot"


def _drain(eng, rid, first=()) -> list[int]:
    out = list(first)
    while eng.has_work():
        out += [ev.token for ev in eng.step() if ev.rid == rid]
    return out


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_handoffs_cross_between_jax_and_port(models, jax_side, mode):
    """A JAX prefill continues in the port's engine (the imported pool
    holds the blob's bits), and a port prefill in the JAX engine, both
    equal to the JAX engine's unified stream."""
    prompt = _prompts()[3]
    jeng = jax_side["engine"]
    jsp = JSamplingParams(**SAMPLING[mode])
    want = _drain(jeng, jeng.add_request(prompt, jsp))
    jh = jeng.export_handoff(prompt, jsp)
    eng = _port_engine(models)
    th = handoff.deserialize(jhandoff.serialize(jh))
    rid, ev = eng.import_handoff(th)
    pages = eng._alloc.pages_for(eng._requests[rid].slot)
    got = eng.cache.k_pages[:, pages].reshape(eng.cache.k_pages.shape[0], -1,
                                              *eng.cache.k_pages.shape[3:])[:, :th.plen]
    src = th.k_pages.reshape(th.k_pages.shape[0], -1, *th.k_pages.shape[3:])[:, :th.plen]
    assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(src)))
    assert _drain(eng, rid, [ev.token]) == want
    th = eng.export_handoff(prompt, SamplingParams(**SAMPLING[mode]))
    rid, ev = jeng.import_handoff(jhandoff.deserialize(handoff.serialize(th)))
    assert _drain(jeng, rid, [ev.token]) == want


# ---- refusals ------------------------------------------------------------------


def test_draft_refused_as_the_jax_engine_refuses(models):
    jcfg, jp, tcfg, tp = models
    kw = dict(BASE, speculate=2)
    with pytest.raises(ValueError) as want:
        JEngine("mixtral", jcfg, jp, cfg=JEngineConfig(cache_dtype=jnp.float32, **kw),
                draft=(jcfg, jp))
    with pytest.raises(ValueError, match="family verify=False") as got:
        Engine("mixtral", tcfg, tp, cfg=EngineConfig(cache_dtype=torch.float32, **kw),
               draft=(tcfg, tp), device="cpu")
    assert str(got.value) == str(want.value)


def _adapter(cfg, seed=11):
    """An adapter on wq in llama's shapes: the buffers the JAX engine
    builds for mixtral (llama's lora_dims read only the widths)."""
    from kubeai_tpu_torch.models import llama as tl

    rng = np.random.default_rng(seed)
    e, o = tl.lora_dims(cfg)["wq"]
    return {"wq": ((rng.standard_normal((cfg.num_layers, e, 4)) * 0.5).astype(np.float32),
                   (rng.standard_normal((cfg.num_layers, 4, o)) * 0.5).astype(np.float32))}


def test_adapters_refused_fault_c10(models):
    """C10: with max_adapters 4 (the CLI default) the JAX engine loads an
    adapter on mixtral and serves the base model under its name; the port
    builds no adapter buffers and refuses the load naming the family."""
    jcfg, jp, tcfg, tp = models
    kw = dict(num_slots=2, max_seq_len=64, page_size=8, max_adapters=4)
    jeng = JEngine("mixtral", jcfg, jp, cfg=JEngineConfig(cache_dtype=jnp.float32,
                                                          step_overlap="off", **kw))
    jeng.load_adapter("a1", _adapter(jcfg))
    prompt, sp = _prompts()[2], JSamplingParams(**SAMPLING["greedy"])
    assert jeng.generate([prompt], sp, adapter="a1") == jeng.generate([prompt], sp)
    eng = Engine("mixtral", tcfg, tp, cfg=EngineConfig(cache_dtype=torch.float32, **kw),
                 device="cpu")
    assert eng._lora is None and "C10" in eng.adapter_refusal
    with pytest.raises(ValueError, match="mixtral family takes no LoRA adapters"):
        eng.load_adapter("a1", _adapter(jcfg))
    with pytest.raises(ValueError, match="C10"):
        eng.add_request(prompt, SamplingParams(**SAMPLING["greedy"]), adapter="a1")


def test_int8_weights_refused_fault_c15(models):
    _, _, tcfg, tp = models
    with pytest.raises(NotImplementedError, match="C15") as e:
        Engine("mixtral", tcfg, tp, cfg=EngineConfig(quantization="int8", **BASE),
               device="cpu")
    assert "mixtral family" in str(e.value)


def test_card_head_dim_check_passes_mixtral():
    """Mixtral-8x7B's heads (32 over 8 at 128) on the card: B2 in
    whole-prompt prefill, B1 per_layer, B4 fused, B1-int8 on int8 pools
    all have builds; a head_dim none takes is refused."""
    family, cfg = get_model_family("mixtral"), tm.MixtralConfig()
    assert cfg.head_size == 128 and family.prefill_uses_flash(cfg)
    for kw in ({}, dict(decode_kernel="fused"), dict(kv_dtype="int8"),
               dict(cache_mode="slot")):
        ecfg = EngineConfig(**kw)
        refuse_kernel_head_dims(family, cfg, ecfg, ecfg.decode_kernel or "per_layer", 0,
                                torch.device("cuda"), ecfg.cache_mode)
    odd = dataclasses.replace(cfg, hidden_size=3072)  # head_dim 96
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        refuse_kernel_head_dims(family, odd, EngineConfig(), "per_layer", 0,
                                torch.device("cuda"))


# ---- the entry point -------------------------------------------------------------


class _Built(Exception):
    pass


def test_main_serves_mixtral(models, jax_side, tmp_path, monkeypatch):
    """main on a tiny HF-named checkpoint (the default flags, on the CPU)
    builds a mixtral engine; served through an EngineServer with main's
    arguments, greedy chat completions equal an in-process engine's on
    the same checkpoint; /v1/embeddings answers 400 with the JAX server's
    body, /v1/load_lora_adapter 400 naming C10; --quantization int8
    exits at boot naming C15."""
    from kubeai_tpu_torch.engine import server as server_mod
    from kubeai_tpu_torch.engine import weights

    model_dir = write_mixtral_checkpoint(tmp_path, hf_config(), seed=6)
    with pytest.raises(SystemExit) as e:
        server_mod.main(["--model-url", model_dir, "--device", "cpu",
                         "--quantization", "int8"])
    assert "C15" in str(e.value.code) and "mixtral" in str(e.value.code)
    built = {}

    def capture(engine, tokenizer, name, **kw):
        built.update(kw, engine=engine, tokenizer=tokenizer, name=name)
        raise _Built

    monkeypatch.setattr(server_mod, "EngineServer", capture)
    with pytest.raises(_Built):
        server_mod.main(["--model-url", model_dir, "--device", "cpu", "--num-slots", "2",
                         "--max-seq-len", "128"])
    engine = built.pop("engine")
    assert engine.family.name == "mixtral" and engine.cfg.max_adapters == 4
    cfg = tm.MixtralConfig.from_hf_dict(weights.load_hf_config(model_dir))
    params = weights.load_params("mixtral", model_dir, cfg, device="cpu")
    for name, w in params["layers"].items():
        assert torch.equal(engine.params["layers"][name], w), name
    ref = Engine("mixtral", cfg, params, cfg=EngineConfig(num_slots=2, max_seq_len=128),
                 eos_token_ids=TOK.eos_token_ids, device="cpu")
    chats = ["Hello there", "The quick brown fox jumps over the lazy dog."]
    want = ref.generate([TOK.apply_chat_template([{"role": "user", "content": c}])
                         for c in chats], SamplingParams(temperature=0.0, max_tokens=8))
    built.update(host="127.0.0.1", port=0)
    server = EngineServer(engine, built.pop("tokenizer"), built.pop("name"), **built)
    jserver = JEngineServer(jax_side["engine"], JByteTokenizer(), "mixtral", port=0)
    server.start()
    jserver.start()
    try:
        addr = f"127.0.0.1:{server.port}"
        for chat, toks in zip(chats, want):
            status, body = http_post(addr, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": chat}], "max_tokens": 8,
                "temperature": 0})
            assert status == 200
            res = json.loads(body)
            assert res["choices"][0]["message"]["content"] == TOK.decode(toks)
            assert res["usage"]["completion_tokens"] == len(toks)
        embed = {"input": ["hello"], "model": "mixtral"}
        got = http_post(addr, "/v1/embeddings", embed)
        assert got == http_post(f"127.0.0.1:{jserver.port}", "/v1/embeddings", embed)
        assert got[0] == 400 and b"no embedding support" in got[1]
        status, body = http_post(addr, "/v1/load_lora_adapter",
                                 {"lora_name": "a1", "lora_path": str(tmp_path / "none")})
        assert status == 400 and b"C10" in body
    finally:
        server.stop()
        jserver.stop()
