"""The slot KV cache of kubeai_tpu_torch against the JAX package, on the CPU
in f32 (the port's counterpart of tests/unit/test_kvcache.py and of the
slot cases of test_engine_paged.py and test_preemption.py).

- `kvcache.insert_sequence` bit-equal to the JAX function, and the
  batched `insert_sequences` bit-equal to the JAX engine's draft scatter
  (`.at[:, slots, :S].set`), which drops a padding row.
- `llama.decode_step` (GQA, q/k/v biases, llama3 rope scaling, a mixed
  LoRA index) and `gemma.decode_step` (Gemma-1, Gemma-2, Gemma-2 with
  layer_types): logits and both caches within 1e-4 of the JAX functions.
- The engine's slot mode (`EngineConfig(cache_mode="slot")`): greedy and
  seeded streams identical to the JAX engine's on LlamaConfig.tiny() for
  whole-prompt admission, prefill_chunk=16 and continuations with a
  forced token, with overlap on and off; gemma and qwen served in slot
  mode; kv_utilization and kv_cache_info; the JAX engine's refusals of
  int8 pools, the prefix cache and handoffs in slot mode, word for word.

The JAX engines run each scenario once per module, with step_overlap off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine import kvcache as jkv
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import gemma as jg
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import kvcache as tkv
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parity import lora_from_numpy, params_from_numpy, slot_cache_from_numpy

# f32 on both sides through two layers, sums in different orders.
ATOL = 1e-4
BASE = dict(num_slots=4, max_seq_len=128, decode_chunk=4, cache_mode="slot")
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=24),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=20, seed=9),
}
SCENARIOS = {"whole": {}, "chunked": dict(prefill_chunk=16)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---- kvcache ------------------------------------------------------------------


@pytest.mark.parametrize("slot,S", [(0, 16), (2, 5), (3, 32)])
def test_insert_sequence_bit_equal_to_jax(slot, S):
    rng = np.random.default_rng(slot * 100 + S)
    NL, B, L, KVH, D = 2, 4, 32, 2, 8
    ck = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    cv = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    kn = rng.standard_normal((NL, S, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((NL, S, KVH, D)).astype(np.float32)
    jk, jv = jkv.insert_sequence(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
                                 jnp.asarray(vn), jnp.int32(slot))
    cache = slot_cache_from_numpy(ck, cv)
    tk, tv = tkv.insert_sequence(cache.k, cache.v, torch.from_numpy(kn),
                                 torch.from_numpy(vn), slot)
    assert tk is cache.k and tv is cache.v  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(IndexError):
        tkv.insert_sequence(cache.k, cache.v, torch.from_numpy(kn), torch.from_numpy(vn), B)


def test_insert_sequences_drop_padding_rows_as_jax_scatter():
    """The draft admission's batched write: JAX's `.at[:, slots, :S].set`
    drops the padding row whose slot is num_slots; the port skips it."""
    rng = np.random.default_rng(7)
    NL, B, L, KVH, D, S = 2, 4, 32, 2, 8, 16
    ck = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    cv = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    k_all = rng.standard_normal((NL, 4, S, KVH, D)).astype(np.float32)
    v_all = rng.standard_normal((NL, 4, S, KVH, D)).astype(np.float32)
    slots = [3, 0, B, B]
    idx = jnp.asarray(slots)
    jk = jnp.asarray(ck).at[:, idx, :S].set(jnp.asarray(k_all))
    jv = jnp.asarray(cv).at[:, idx, :S].set(jnp.asarray(v_all))
    cache = tkv.KVCache.create(NL, B, L, KVH, D, torch.float32, "cpu")
    cache.k.copy_(torch.from_numpy(ck))
    cache.v.copy_(torch.from_numpy(cv))
    tkv.insert_sequences(cache.k, cache.v, torch.from_numpy(k_all),
                         torch.from_numpy(v_all), slots)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jv))
    assert cache.nbytes() == 2 * ck.nbytes


# ---- decode_step --------------------------------------------------------------

LLAMA_CASES = {
    "gqa": {},
    "qwen": dict(attention_bias=True),
    "rope_scaling": dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    "lora": {},
}


def _slot_inputs(rng, cfg, B, L, vocab):
    NL, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_size
    ck = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    cv = rng.standard_normal((NL, B, L, KVH, D)).astype(np.float32)
    tokens = rng.integers(1, vocab, B).astype(np.int32)
    positions = np.array([17, 0, 40, L - 1][:B], np.int32)
    return ck, cv, tokens, positions


@pytest.mark.parametrize("case", list(LLAMA_CASES))
def test_llama_decode_step_matches_jax(case):
    kw = LLAMA_CASES[case]
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32, **kw)
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    if case == "qwen":
        for b in ("bq", "bk", "bv"):  # non-zero biases
            tree["layers"][b] = (rng.standard_normal(tree["layers"][b].shape) * 0.1
                                 ).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    jkw, tkw = {}, {}
    if case == "lora":
        bufs = jax.tree.map(np.asarray, jl.init_lora_buffers(jcfg, 3, 8))
        for ab in bufs.values():
            for name in ("A", "B"):
                ab[name] = ab[name].copy()
                ab[name][1:] = rng.standard_normal(ab[name][1:].shape) * 0.2
        idx = np.array([2, 0, 1, 1], np.int32)
        jkw = dict(lora=jax.tree.map(jnp.asarray, bufs), lora_idx=jnp.asarray(idx))
        tkw = dict(lora=lora_from_numpy(bufs, "cpu"), lora_idx=torch.from_numpy(idx).long())
    ck, cv, tokens, positions = _slot_inputs(rng, jcfg, 4, 64, jcfg.vocab_size)
    want = jl.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                          jnp.asarray(ck), jnp.asarray(cv), **jkw)
    cache = slot_cache_from_numpy(ck, cv)
    got = tl.decode_step(tp, tcfg, torch.from_numpy(tokens).long(),
                         torch.from_numpy(positions).long(), cache.k, cache.v, **tkw)
    assert got[1] is cache.k and got[2] is cache.v  # written in place
    for g, w in zip(got, want):
        _close(g, w)
    if case == "lora":
        base = jl.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                              jnp.asarray(ck), jnp.asarray(cv))[0]
        moved = np.abs(np.asarray(base) - np.asarray(want[0])).max(axis=1)
        assert (moved[idx > 0] > 1e-3).all() and (moved[idx == 0] < 1e-5).all()


GEMMA2 = dict(sandwich_norms=True, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, query_pre_attn_scalar=16.0,
              sliding_window=8)
GEMMA_CASES = {
    "gemma1": {},
    "gemma2": GEMMA2,
    "gemma2-layer-types": {**GEMMA2, "layer_types": ("full_attention",
                                                     "sliding_attention")},
}


def _gemma_models(kind: str):
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(vocab_size=512), dtype=jnp.float32,
                               **GEMMA_CASES[kind])
    tcfg = tg.GemmaConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg) if f.name != "dtype"},
                          dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jg.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    # Larger logits, so the softcaps and the window move the result.
    tree["layers"]["wq"] = tree["layers"]["wq"] * 25
    tree["layers"]["wk"] = tree["layers"]["wk"] * 25
    tree["embed"] = tree["embed"] * 10
    for name, w in tree["layers"].items():
        if name.endswith("norm"):
            tree["layers"][name] = (rng.standard_normal(w.shape) * 0.1).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree)


@pytest.mark.parametrize("kind", list(GEMMA_CASES))
def test_gemma_decode_step_matches_jax(kind):
    jcfg, jp, tcfg, tp = _gemma_models(kind)
    rng = np.random.default_rng(5)
    ck, cv, tokens, positions = _slot_inputs(rng, jcfg, 4, 48, jcfg.vocab_size)
    want = jg.decode_step(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                          jnp.asarray(ck), jnp.asarray(cv))
    cache = slot_cache_from_numpy(ck, cv)
    got = tg.decode_step(tp, tcfg, torch.from_numpy(tokens).long(),
                         torch.from_numpy(positions).long(), cache.k, cache.v)
    for g, w in zip(got, want):
        _close(g, w)


def test_registry_carries_decode_step():
    assert get_model_family("llama").decode_step is tl.decode_step
    assert get_model_family("qwen").decode_step is tl.decode_step
    assert get_model_family("gemma").decode_step is tg.decode_step
    assert get_model_family("whisper").decode_step is None


# ---- the engine in slot mode ----------------------------------------------------


def _prompts():
    rng = np.random.default_rng(3)
    # Buckets 16, 32, 64 and 128 (chunked past 16), more prompts than slots.
    return [rng.integers(1, 512, n).tolist() for n in (5, 20, 40, 70, 3, 33)]


# Continuations: (prompt index, emitted prefix length) of each request.
RESUMES = ((1, 1), (3, 5), (4, 9))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _run_resumes(eng, sp, prefixes):
    prompts = _prompts()
    rids = [eng.add_request(prompts[i], sp, resume_tokens=prefixes[i])
            for i, _ in RESUMES]
    got = {r: [] for r in rids}
    while eng.has_work():
        for ev in eng.step():
            got[ev.rid].append(ev.token)
    return [got[r] for r in rids]


@pytest.fixture(scope="module")
def jax_streams(models):
    jcfg, jparams, _, _ = models
    out = {}
    for scenario, kw in SCENARIOS.items():
        # One engine a scenario (its jits compile once): a slot admission
        # overwrites the slot's row and state, so runs do not interact.
        eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
            cache_dtype=jnp.float32, step_overlap="off", **BASE, **kw))
        assert eng.cache_mode == "slot"
        for mode, sp in SAMPLING.items():
            out[scenario, mode] = eng.generate(_prompts(), JSamplingParams(**sp))
            # Continuations cut from the uninterrupted streams.
            prefixes = {i: out[scenario, mode][i][:n] for i, n in RESUMES}
            out[scenario, mode, "resume"] = _run_resumes(eng, JSamplingParams(**sp), prefixes)
    return out


def _port_engine(models, **kw):
    _, _, tcfg, tparams = models
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **BASE, **kw), device="cpu")


@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_slot_streams_identical_to_jax(models, jax_streams, scenario, mode, overlap):
    eng = _port_engine(models, step_overlap=overlap, **SCENARIOS[scenario])
    assert eng.cache_mode == "slot" and isinstance(eng.cache, tkv.KVCache)
    assert eng._overlap is (overlap == "on")
    got = eng.generate(_prompts(), SamplingParams(**SAMPLING[mode]))
    assert got == jax_streams[scenario, mode]
    assert all(len(s) == SAMPLING[mode]["max_tokens"] for s in got)
    assert eng.kv_utilization() == 0.0 and sorted(eng._free_slots) == [0, 1, 2, 3]


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_slot_continuations_identical_to_jax(models, jax_streams, scenario, mode):
    """A continuation re-prefills prompt + prefix[:-1] with its last token
    forced and emits only the rest: the JAX engine's tokens, which are
    the uninterrupted stream's tail."""
    eng = _port_engine(models, **SCENARIOS[scenario])
    full = jax_streams[scenario, mode]
    prefixes = {i: full[i][:n] for i, n in RESUMES}
    got = _run_resumes(eng, SamplingParams(**SAMPLING[mode]), prefixes)
    assert got == jax_streams[scenario, mode, "resume"]
    assert got == [full[i][n:] for i, n in RESUMES]


@pytest.mark.parametrize("family", ["qwen", "gemma"])
def test_slot_mode_serves_other_families_as_jax(family):
    if family == "gemma":
        jcfg, jp, tcfg, tp = _gemma_models("gemma2")
    else:
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                                   attention_bias=True)
        tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(2)))
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = (np.random.default_rng(4).standard_normal(
                tree["layers"][b].shape) * 0.1).astype(np.float32)
        jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
        tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                                   attention_bias=True)
    sp = SAMPLING["greedy"]
    prompts = _prompts()[:5]
    want = JEngine(family, jcfg, jp, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **BASE)).generate(
        prompts, JSamplingParams(**sp))
    eng = Engine(family, tcfg, tp, cfg=EngineConfig(cache_dtype=torch.float32, **BASE),
                 device="cpu")
    assert eng.generate(prompts, SamplingParams(**sp)) == want


def test_slot_capacity_reports_match_jax(models):
    jcfg, jparams, _, _ = models
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **BASE))
    eng = _port_engine(models, step_overlap="off")
    assert eng.kv_cache_info() == jeng.kv_cache_info()
    sp = dict(temperature=0.0, max_tokens=30)
    for e, cls in ((jeng, JSamplingParams), (eng, SamplingParams)):
        for p in _prompts()[:3]:
            e.add_request(p, cls(**sp))
        for _ in range(3):
            e.step()
    assert eng.kv_utilization() == pytest.approx(jeng.kv_utilization(), abs=0)
    assert 0 < eng.kv_utilization() < 1


def _raises_alike(fn, jfn, exc):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        jfn()
    assert str(got.value) == str(want.value)


def test_slot_mode_refusals_match_jax(models):
    jcfg, jparams, _, _ = models

    def both(**kw):
        return (lambda: _port_engine(models, **kw),
                lambda: JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
                    cache_dtype=jnp.float32, **BASE, **kw)))

    _raises_alike(*both(kv_dtype="int8"), ValueError)
    _raises_alike(*both(prefill_chunk=16, prefix_cache=True), ValueError)
    with pytest.raises(ValueError, match="unknown cache_mode"):
        Engine("llama", models[2], models[3], cfg=EngineConfig(cache_mode="rows"),
               device="cpu")
    eng = _port_engine(models)
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(cache_dtype=jnp.float32, **BASE))
    _raises_alike(lambda: eng.export_handoff([1, 2, 3]),
                  lambda: jeng.export_handoff([1, 2, 3]), RuntimeError)
    _raises_alike(lambda: eng.import_handoff(None), lambda: jeng.import_handoff(None),
                  RuntimeError)
    assert eng.prefix_holdings() == jeng.prefix_holdings() == []
    assert eng.cached_prefix_depth(["00"]) == jeng.cached_prefix_depth(["00"]) == 0
    assert eng.export_prefix_pages(["00"]) is None
    # Speculation is unavailable in slot mode: vanilla decode, as in JAX.
    assert _port_engine(models, speculate=3)._spec == 0
