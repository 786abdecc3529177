"""Chunked prefill and the automatic prefix cache of kubeai_tpu_torch
against the JAX package, on the CPU in f32.

Ops and model: `chunked_prefill_attention` (ragged chunk starts, a
sliding window, a softcap) and `llama.prefill_chunk` (llama and qwen,
chunk schedules aligned backward and padded forward, stale values in the
staging cache) match the JAX functions at atol 1e-4; the page-hash chain
and the engine's `_prefix_hashes` are bit-equal to the JAX package's.

Engine: each scenario mirrors an engine-level case of
tests/unit/test_prefix_cache.py. The JAX engine runs it once per module
(one engine per scenario, step_overlap off); the port runs it with
overlap on and off, and each call's greedy or seeded streams and the
engine's `prefix_stats` must equal the JAX engine's. The JAX file's
adapter-generation case is tests/test_torch_lora.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import llama as jl
from kubeai_tpu.ops.attention import chunked_prefill_attention as j_chunked_attention
from kubeai_tpu.routing.prefixchain import page_hash_chain as j_page_hash_chain
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.ops.attention import chunked_prefill_attention
from kubeai_tpu_torch.parity import params_from_numpy
from kubeai_tpu_torch.routing.prefixchain import CHAIN_SEED_PREFIX, page_hash_chain

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4  # f32 on both sides (tests/conftest.py pins JAX matmuls to f32)
V = 512  # LlamaConfig.tiny() vocabulary


# ---- ops and model -------------------------------------------------------------


@pytest.mark.parametrize("window,softcap", [
    (None, None), (6, None), (None, 20.0), (6, 20.0),
], ids=["plain", "window", "softcap", "window-softcap"])
def test_chunked_prefill_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(0)
    B, S, H, KVH, D, L = 3, 8, 4, 2, 16, 40
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, D)).astype(np.float32)
    starts = np.array([0, 5, 29], np.int32)  # ragged; keys past each chunk are stale
    want = j_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
        window=window, logit_softcap=softcap,
    )
    got = chunked_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(starts), window=window, logit_softcap=softcap,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _model_pair(family: str, seed: int):
    """(JAX cfg, JAX params, torch cfg, torch params): the same f32 weights;
    qwen gets random q/k/v biases (init_params zeroes k and v's)."""
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(), dtype=jnp.float32, attention_bias=family == "qwen")
    tree = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    if family == "qwen":
        rng = np.random.default_rng(seed)
        for name in ("bk", "bv"):
            tree["layers"][name] = (
                rng.standard_normal(tree["layers"][name].shape) * 0.1
            ).astype(np.float32)
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(), dtype=torch.float32, attention_bias=family == "qwen")
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_numpy(tree, "cpu")


# (start, real tokens) per chunk of a 19-token prompt, C = 8, L = 32: the
# engine's plan (last chunk aligned backward to end at the prompt's end,
# recomputing positions 11-15) and a final chunk padded forward past it.
CHUNKS = {
    "aligned": [(0, 8), (8, 8), (11, 8)],
    "padded": [(0, 8), (8, 8), (16, 3)],
}


@pytest.mark.parametrize("schedule", list(CHUNKS))
@pytest.mark.parametrize("family", ["llama", "qwen"])
def test_prefill_chunk_matches_jax(family, schedule):
    jcfg, jparams, tcfg, tparams = _model_pair(family, seed=4)
    C, L, plen = 8, 32, 19
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, V, plen)
    # Stale values in the staging cache: the causal frontier must mask them.
    shape = (tcfg.num_layers, L, tcfg.num_kv_heads, tcfg.head_size)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    chunks = CHUNKS[schedule]
    for i, (start, n) in enumerate(chunks):
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = prompt[start : start + n]
        last = i == len(chunks) - 1
        jlogits, jk, jv = jl.prefill_chunk(
            jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.int32(start),
            jnp.int32(plen), jk, jv, want_logits=last,
        )
        tlogits, tk2, tv2 = tl.prefill_chunk(
            tparams, tcfg, torch.from_numpy(toks), torch.tensor(start),
            torch.tensor(plen), tk, tv, want_logits=last,
        )
        assert tk2 is tk and tv2 is tv  # written in place
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
        if last:
            assert tlogits.shape == (1, V) and tlogits.dtype == torch.float32
            np.testing.assert_allclose(
                tlogits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
        else:
            assert tlogits is None and jlogits is None


@pytest.mark.parametrize("n,page,adapter,gen", [
    (0, 16, 0, 0), (15, 16, 0, 0), (100, 16, 0, 0), (130, 64, 0, 0), (70, 16, 2, 3),
])
def test_page_hash_chain_bit_equal_to_jax(n, page, adapter, gen):
    tokens = np.random.default_rng(n).integers(0, 128256, n).tolist()
    got = page_hash_chain(tokens, page, adapter, gen)
    assert got == j_page_hash_chain(tokens, page, adapter, gen)
    assert len(got) == n // page and CHAIN_SEED_PREFIX == "apc1"


# ---- the engine against the JAX engine ------------------------------------------

BASE = dict(num_slots=4, max_seq_len=256, page_size=16, prefill_chunk=32,
            decode_chunk=4)
LAYOUTS = {
    "per_layer": dict(decode_kernel="per_layer"),
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=4, spec_adaptive=False),
}
GREEDY = dict(temperature=0.0, max_tokens=12)


def _system_prompts():
    rng = np.random.default_rng(0)
    system = rng.integers(1, V, 80).tolist()
    return [
        system + rng.integers(1, V, 20).tolist(),
        system + rng.integers(1, V, 33).tolist(),
        rng.integers(1, V, 40).tolist(),
    ]


def _scenarios() -> dict:
    """name -> (family, engine settings, [(prompts, sampling), ...]): the
    calls of generate() in order, on one engine."""
    rng = np.random.default_rng(7)
    system = _system_prompts()
    out = {
        f"streams-{layout}": ("llama", dict(BASE, **kw), [(system, GREEDY)] * 2)
        for layout, kw in LAYOUTS.items()
    }
    seeded = dict(temperature=0.8, top_k=20, max_tokens=10, seed=7)
    out["seeded"] = ("llama", BASE, [(system[:2], seeded)] * 2)
    churn = [rng.integers(1, V, 48).tolist() for _ in range(6)]
    out["eviction"] = ("llama", dict(BASE, num_pages=17, num_slots=2),
                       [(churn, dict(temperature=0.0, max_tokens=6))] * 2)
    shared = rng.integers(1, V, 64).tolist()
    four = dict(temperature=0.0, max_tokens=4)
    out["shared"] = ("llama", BASE, [([shared + [5, 6, 7]], four),
                                     ([shared + [8, 9, 10, 11]], four)])
    p104 = rng.integers(1, V, 104).tolist()
    two = dict(temperature=0.0, max_tokens=2)
    out["mutate"] = ("llama", BASE, [([p104], two), ([p104 + [1, 2, 3]], two)])
    short = [rng.integers(1, V, 20).tolist() for _ in range(3)]
    out["short"] = ("llama", BASE, [(short, four)] * 2)
    out["near_max"] = ("llama", BASE, [([rng.integers(1, V, 250).tolist()], four)] * 2)
    qsys = rng.integers(1, V, 48).tolist()
    qwen = [qsys + rng.integers(1, V, 12).tolist() for _ in range(2)]
    out["qwen"] = ("qwen", dict(num_slots=2, max_seq_len=256, page_size=16,
                                prefill_chunk=32),
                   [(qwen, dict(temperature=0.0, max_tokens=8))] * 2)
    psys = rng.integers(1, V, 32).tolist()
    out["preempt"] = ("llama", dict(BASE, num_slots=3, num_pages=1 + 16),
                      [([psys + rng.integers(1, V, 4).tolist() for _ in range(3)],
                        dict(temperature=0.0, max_tokens=120))])
    return out


SCENARIOS = _scenarios()


@pytest.fixture(scope="module")
def models():
    return {family: _model_pair(family, seed=0 if family == "llama" else 2)
            for family in ("llama", "qwen")}


@pytest.fixture(scope="module")
def jax_run(models):
    """name -> [(streams, prefix_stats) after each call] of the JAX engine
    with the prefix cache, computed once per scenario."""
    done = {}

    def run(name):
        if name not in done:
            family, kw, calls = SCENARIOS[name]
            jcfg, jparams, _, _ = models[family]
            eng = JEngine(family, jcfg, jparams, cfg=JEngineConfig(
                cache_dtype=jnp.float32, step_overlap="off", prefix_cache=True, **kw))
            done[name] = [
                (eng.generate(prompts, JSamplingParams(**sp)), dict(eng.prefix_stats))
                for prompts, sp in calls
            ]
        return done[name]

    return run


def _engine(models, family, kw, overlap="on", prefix_cache=True):
    _, _, tcfg, tparams = models[family]
    return Engine(family, tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, step_overlap=overlap, prefix_cache=prefix_cache,
        **kw), device="cpu")


def _check_against_jax(models, jax_run, name, overlap, between=None):
    """Run scenario `name` on a port engine; each call's streams and
    prefix_stats must equal the JAX engine's. `between(eng, i)` runs
    before call i. Returns the engine."""
    family, kw, calls = SCENARIOS[name]
    eng = _engine(models, family, kw, overlap)
    for i, ((prompts, sp), (want, want_stats)) in enumerate(zip(calls, jax_run(name))):
        if between is not None:
            between(eng, i)
        assert eng.generate(prompts, SamplingParams(**sp)) == want, f"call {i}"
        assert eng.prefix_stats == want_stats, f"call {i}"
    # Every page is back: free, or parked in the idle cache.
    assert eng._alloc.free_pages == eng._n_pages - 1
    assert not any(eng._alloc._ref.values())
    return eng


@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streams_equal_jax_and_vanilla(models, jax_run, layout, overlap):
    """Cold (sharing within one batch) and warm (revived from the idle
    pool) runs over a shared 80-token system prompt equal the JAX engine's,
    and the chunked engine's streams without the cache."""
    name = f"streams-{layout}"
    eng = _check_against_jax(models, jax_run, name, overlap)
    (cold, cold_stats), (_, warm_stats) = jax_run(name)
    assert cold_stats["hit_tokens"] > 0
    assert warm_stats["hit_tokens"] > cold_stats["hit_tokens"] + 100
    _, kw, calls = SCENARIOS[name]
    vanilla = _engine(models, "llama", kw, overlap, prefix_cache=False)
    assert vanilla.generate(calls[0][0], SamplingParams(**GREEDY)) == cold
    assert vanilla.prefix_stats == {"lookups": 0, "hit_tokens": 0, "prompt_tokens": 0}
    if layout == "speculate":
        assert eng.spec_stats["windows"] > 0


@pytest.mark.parametrize("name", ["seeded", "eviction", "short", "qwen"])
def test_scenario_equal_jax(models, jax_run, name):
    """Seeded sampling over cached prefixes; a 17-page pool that evicts
    idle prefixes while distinct prompts churn; prompts of at most
    prefill_chunk tokens, which take the batched path and still register
    their full pages; the qwen family (q/k/v biases in every chunk)."""
    eng = _check_against_jax(models, jax_run, name, "on")
    stats = jax_run(name)[-1][1]
    if name == "short":
        assert jax_run(name)[0][1]["prompt_tokens"] == 60
        assert stats["hit_tokens"] >= 48
    if name in ("seeded", "qwen"):
        assert stats["hit_tokens"] > 0
    assert eng.prefix_holdings() == [h.hex() for h in eng._alloc.holdings()]


def test_shared_pages_not_duplicated(models, jax_run):
    """Two requests over one 64-token prefix share its 4 pages."""
    eng = _check_against_jax(models, jax_run, "shared", "on")
    shared = SCENARIOS["shared"][2][0][0][0][:64]
    assert len(eng._alloc.lookup(eng._prefix_hashes(shared))) == 4


@pytest.mark.parametrize("name,prompt_len,cached", [
    ("mutate", 104, 96), ("near_max", 250, 224),
])
def test_hit_never_mutates_adopted_pages(models, jax_run, name, prompt_len, cached):
    """A hit's suffix chunks and final scatter leave the adopted pages
    bit-identical, and no chunk of a hit starts inside the cached prefix:
    with a short suffix (the final chunk padded forward from the cached
    length) and with a prompt near max_seq_len (the hit capped at 14 of
    its 15 pages so the padded chunk fits the staging buffer)."""
    seen = {"starts": []}

    def between(eng, i):
        if i == 1:
            prompt = SCENARIOS[name][2][0][0][0]
            pages = eng._alloc.lookup(eng._prefix_hashes(prompt))
            assert len(pages) == prompt_len // 16
            seen["pages"] = pages
            seen["k"] = eng.cache.k_pages[:, pages].clone()
            seen["v"] = eng.cache.v_pages[:, pages].clone()
            seen["hits"] = eng.prefix_stats["hit_tokens"]
            staging = eng._chunk_staging["ints"]
            upload = staging.upload

            def spy(ints):
                seen["starts"].append(int(ints[0]))
                upload(ints)

            staging.upload = spy

    eng = _check_against_jax(models, jax_run, name, "on", between)
    assert eng.prefix_stats["hit_tokens"] - seen["hits"] == cached
    assert seen["starts"] and min(seen["starts"]) >= cached
    assert torch.equal(eng.cache.k_pages[:, seen["pages"]], seen["k"])
    assert torch.equal(eng.cache.v_pages[:, seen["pages"]], seen["v"])


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_preemption_with_shared_pages(models, jax_run, overlap):
    """Decode exhausts a 16-page pool while live slots share the system
    prefix: preemption drops references instead of freeing shared pages,
    the victims resume by recompute through the chunked path with their
    token forced (never hashed), and the streams equal the JAX engine's."""
    preempted = []

    def between(eng, i):
        eng.on_preempt = lambda rid, client: preempted.append(rid)

    eng = _check_against_jax(models, jax_run, "preempt", overlap, between)
    assert preempted, "the tight pool must force a preemption"
    assert eng._alloc.free_pages == 16


def test_prefix_hashes_equal_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models["llama"]
    kw = dict(num_slots=2, max_seq_len=128, page_size=16, prefill_chunk=32,
              prefix_cache=True)
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(**kw))
    eng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **kw), device="cpu")
    tokens = np.random.default_rng(1).integers(1, V, 100).tolist()
    assert eng._prefix_hashes(tokens) == jeng._prefix_hashes(tokens, 0)
    assert eng.prefix_holdings() == [] and len(eng._prefix_hashes(tokens)) == 6


def test_config_validation(models, caplog):
    """prefix_cache without prefill_chunk raises ValueError, as in the JAX
    engine; a chunk longer than max_seq_len cannot fit the staging
    buffer; a chunk that leaves no adoptable page warns."""
    jcfg, jparams, _, _ = models["llama"]
    kw = dict(num_slots=2, max_seq_len=128, page_size=16)
    with pytest.raises(ValueError, match="prefill_chunk"):
        JEngine("llama", jcfg, jparams, cfg=JEngineConfig(prefix_cache=True, **kw))
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(models, "llama", kw)
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(models, "llama", dict(kw, prefill_chunk=129), prefix_cache=False)
    with caplog.at_level("WARNING"):
        eng = _engine(models, "llama", dict(kw, prefill_chunk=120))
    assert "prefix_cache is inert" in caplog.text
    assert eng._stage_pages_program is not None
    plain = _engine(models, "llama", dict(kw, prefill_chunk=32), prefix_cache=False)
    assert plain._stage_pages_program is None and plain._stage_mid_program is not None
