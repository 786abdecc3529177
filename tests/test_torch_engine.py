"""kubeai_tpu_torch.engine.Engine against kubeai_tpu.engine.Engine: the
same weights (f32, carried across by kubeai_tpu_torch.parity), prompts
and sampling params give IDENTICAL greedy and seeded token streams, over
mixed prompt lengths across prefill buckets and over an oversubscribed
page pool that forces preemption (recompute), in vanilla decoding, with
prompt-lookup speculation (and equal acceptance counts) and with the
fused decode layout. The JAX streams are built once per module."""

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
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4)
POOLS = {"full": {}, "tight": {"num_pages": 1 + 9}}
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=40),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=30, seed=9),
}


def _prompts():
    rng = np.random.default_rng(3)
    # Buckets 16, 32, 64 and 128, more prompts than slots.
    mixed = [rng.integers(1, 512, n).tolist() for n in (5, 20, 40, 70, 3, 33)]
    # Long generations from equal prompts: page growth mid-decode.
    grow = [rng.integers(1, 512, 20).tolist() for _ in range(3)]
    return {"mixed": mixed, "grow": grow}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _torch_engine(models, **kw):
    _, _, tcfg, tparams = models
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **BASE, **kw), device="cpu")


@pytest.fixture(scope="module")
def jax_streams(models):
    jcfg, jparams, _, _ = models
    prompts = _prompts()
    out = {}
    for pool, kw in POOLS.items():
        for mode, sp in SAMPLING.items():
            for name, ps in prompts.items():
                eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
                    cache_dtype=jnp.float32, step_overlap="off", **BASE, **kw))
                out[pool, mode, name] = eng.generate(ps, JSamplingParams(**sp))
    return out


@pytest.mark.parametrize("name", ["mixed", "grow"])
@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("pool", list(POOLS))
def test_streams_identical_to_jax(models, jax_streams, pool, mode, name):
    eng = _torch_engine(models, **POOLS[pool])
    preempted = []
    eng.on_preempt = lambda rid, client: preempted.append(rid)
    got = eng.generate(_prompts()[name], SamplingParams(**SAMPLING[mode]))
    want = jax_streams[pool, mode, name]
    assert got == want
    assert all(len(s) == SAMPLING[mode]["max_tokens"] for s in got)
    if pool == "tight" and name == "grow":
        assert preempted, "the tight pool must force a preemption"
    # Every page comes back.
    assert eng._alloc.free_pages == eng._n_pages - 1


def test_cancel_frees_slot_and_pages(models):
    eng = _torch_engine(models)
    total = eng._alloc.free_pages
    rid = eng.add_request(list(range(1, 30)), SamplingParams(temperature=0.0, max_tokens=50))
    eng.step()
    assert eng.num_active == 1 and eng._alloc.free_pages < total
    assert eng.cancel(rid)
    assert not eng.has_work() and eng._alloc.free_pages == total
    assert not eng.cancel(rid)


def test_stop_token_and_length_finish(models):
    eng = _torch_engine(models)
    prompt = list(range(1, 10))
    first = eng.generate([prompt], SamplingParams(temperature=0.0, max_tokens=6))[0]
    eng = Engine("llama", models[2], models[3], cfg=EngineConfig(
        cache_dtype=torch.float32, **BASE), eos_token_ids=(first[2],), device="cpu")
    rid = eng.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=6))
    events = []
    while eng.has_work():
        events += [e for e in eng.step() if e.rid == rid]
    assert [e.token for e in events] == first[:3]
    assert events[-1].finished and events[-1].finish_reason == "stop"


@pytest.mark.parametrize("kw,item", [
    (dict(quantization="int8"), "A12"),
    (dict(max_adapters=2), "A11"),
    (dict(cache_mode="slot"), "A13"),
])
def test_unported_settings_raise(models, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _torch_engine(models, **kw)


def test_int8_kv_pools_serve(models):
    """kv_dtype="int8" builds int8 pools with their scales and serves;
    the streams against the JAX int8 engine are tests/test_torch_kv_quant.py's."""
    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool

    eng = _torch_engine(models, kv_dtype="int8")
    assert isinstance(eng.cache.k_pages, QuantizedPool) and eng.cache.quantized
    assert eng.cache.k_pages.q8.dtype == torch.int8
    assert eng.cache.k_pages.scale.dtype == torch.float32
    out = eng.generate(_prompts()["mixed"][:2], SamplingParams(temperature=0.0, max_tokens=5))
    assert [len(s) for s in out] == [5, 5]
    assert eng.kv_cache_info()["dtype"] == "int8"


def test_prefix_cache_needs_prefill_chunk(models):
    """prefix_cache without prefill_chunk raises the JAX engine's
    ValueError: a cache hit prefills its suffix through staged chunks."""
    jcfg, jparams, _, _ = models
    kw = dict(num_slots=2, max_seq_len=128, page_size=16, prefix_cache=True)
    with pytest.raises(ValueError, match="prefill_chunk > 0"):
        JEngine("llama", jcfg, jparams, cfg=JEngineConfig(**kw))
    with pytest.raises(ValueError, match="prefill_chunk > 0"):
        _torch_engine(models, prefix_cache=True)


def test_mesh_raises_and_auto_overlap_is_synchronous(models):
    """A mesh raises; step_overlap "auto" resolves to overlapped stepping,
    as in the JAX engine at pp = 1, and "off" to synchronous."""
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="A14"):
        Engine("llama", tcfg, tparams, mesh=object(), device="cpu")
    for overlap, want in (("auto", True), ("on", True), ("off", False)):
        eng = _torch_engine(models, step_overlap=overlap)
        assert eng._overlap is want
        assert eng.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=3))


def test_validation_errors(models):
    eng = _torch_engine(models)
    with pytest.raises(ValueError):
        eng.add_request([], SamplingParams())
    with pytest.raises(ValueError):
        eng.add_request(list(range(BASE["max_seq_len"])), SamplingParams())
    with pytest.raises(ValueError):
        _torch_engine(models, num_pages=4)  # cannot hold one sequence
    eng.begin_drain()
    from kubeai_tpu_torch.engine import EngineDraining

    with pytest.raises(EngineDraining):
        eng.add_request([1], SamplingParams())


# ---- speculative decoding and the fused layout --------------------------------

SPEC = dict(speculate=4, spec_adaptive=False)


def _spec_prompts():
    rng = np.random.default_rng(21)
    return [
        ([7, 8, 9, 10] * 12)[:40],  # repeating n-grams: proposals accepted
        rng.integers(1, 512, 23).tolist(),
        rng.integers(1, 512, 9).tolist(),
        ([3, 4, 5] * 40)[:110],  # runs into max_seq_len mid-window
    ]


@pytest.fixture(scope="module")
def jax_spec_streams(models):
    """(streams, spec_stats) of the JAX engine with speculation, per pool
    and sampling mode; and its fused-layout streams per sampling mode."""
    jcfg, jparams, _, _ = models
    out = {}
    for pool, kw in POOLS.items():
        for mode, sp in SAMPLING.items():
            eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
                cache_dtype=jnp.float32, step_overlap="off", **BASE, **SPEC, **kw))
            out["spec", pool, mode] = (
                eng.generate(_spec_prompts(), JSamplingParams(**sp)), dict(eng.spec_stats))
    for mode, sp in SAMPLING.items():
        eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
            cache_dtype=jnp.float32, step_overlap="off", decode_kernel="fused", **BASE))
        out["fused", mode] = eng.generate(_prompts()["mixed"], JSamplingParams(**sp))
    return out


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("pool", list(POOLS))
def test_speculative_streams_identical_to_jax(models, jax_spec_streams, pool, mode):
    eng = _torch_engine(models, **SPEC, **POOLS[pool])
    assert eng._spec == 4
    preempted = []
    eng.on_preempt = lambda rid, client: preempted.append(rid)
    got = eng.generate(_spec_prompts(), SamplingParams(**SAMPLING[mode]))
    want, want_stats = jax_spec_streams["spec", pool, mode]
    assert got == want
    assert eng.spec_stats == want_stats
    if mode == "greedy":
        assert eng.spec_stats["accepted"] > 0, "no proposal was ever accepted"
    if pool == "tight":
        assert preempted, "the tight pool must force a preemption"
    assert eng._alloc.free_pages == eng._n_pages - 1


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_speculative_streams_equal_vanilla(models, mode):
    sp = SamplingParams(**SAMPLING[mode])
    want = _torch_engine(models).generate(_spec_prompts(), sp)
    assert _torch_engine(models, **SPEC).generate(_spec_prompts(), sp) == want


def test_adaptive_speculation_streams_equal_vanilla(models):
    """The adaptive engine interleaves verify windows and decode chunks by
    measured throughput; the greedy stream is vanilla's either way."""
    sp = SamplingParams(temperature=0.0, max_tokens=40)
    want = _torch_engine(models).generate(_spec_prompts(), sp)
    eng = _torch_engine(models, speculate=4)
    assert eng.generate(_spec_prompts(), sp) == want
    assert eng._mode_calls.get("spec", 0) >= 2 and eng._mode_calls.get("chunk", 0) >= 2


def test_adaptive_pick_sequence_equals_jax(models):
    """The mode chooser makes the same picks as the JAX engine's for the
    same observed throughputs: bootstrap, winner, periodic probe, shift."""
    jcfg, jparams, _, _ = models
    engines = [
        JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
            cache_dtype=jnp.float32, **BASE, speculate=4, spec_probe_every=8)),
        _torch_engine(models, speculate=4, spec_probe_every=8),
    ]
    script = [("spec", 4), ("spec", 4), ("chunk", 16), ("chunk", 16)] + [None] * 16 \
        + [("spec", 100)] * 4 + [None] * 3
    picks = []
    for eng in engines:
        seq = []
        for item in script:
            seq.append(eng._spec_pick())
            if item is not None:
                eng._spec_observe(item[0], item[1], 1.0)
        picks.append(seq)
    assert picks[0] == picks[1]
    assert picks[1].count(False) >= 14 and picks[1][-1] is True
    assert all(_torch_engine(models, **SPEC)._spec_pick() for _ in range(50))


@pytest.mark.parametrize("gamma", [1, 4])
@pytest.mark.parametrize("vocab", [6, 40])
def test_ngram_proposers_equal_jax(gamma, vocab):
    """The incremental-index and the rescan proposers equal the JAX
    engine's on growing random contexts."""
    from types import SimpleNamespace

    rng = np.random.default_rng(vocab * 10 + gamma)
    tokens = rng.integers(1, vocab, 160).astype(np.int32)

    def fresh():
        ctx = np.empty(512, np.int32)
        ctx[:12] = tokens[:12]
        return SimpleNamespace(ctx=ctx, ctx_len=12, ngram_idx={n: {} for n in (3, 2, 1)},
                               ngram_upto={n: 0 for n in (3, 2, 1)})

    jreq, treq = fresh(), fresh()
    for t in tokens[12:]:
        for req in (jreq, treq):
            req.ctx[req.ctx_len] = t
            req.ctx_len += 1
        want = JEngine._ngram_propose_indexed(jreq, gamma)
        got = Engine._ngram_propose_indexed(treq, gamma)
        ctx = treq.ctx[: treq.ctx_len]
        assert got.tolist() == want.tolist(), treq.ctx_len
        assert Engine._ngram_propose(ctx, gamma).tolist() == want.tolist()
        assert JEngine._ngram_propose(ctx, gamma).tolist() == want.tolist()


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_fused_streams_identical_to_jax(models, jax_spec_streams, mode):
    eng = _torch_engine(models, decode_kernel="fused")
    assert eng.decode_kernel == "fused"
    got = eng.generate(_prompts()["mixed"], SamplingParams(**SAMPLING[mode]))
    assert got == jax_spec_streams["fused", mode]


def test_decode_kernel_env_override_matches_jax(models, monkeypatch):
    jcfg, jparams, _, _ = models
    for env, want in (("fused", "fused"), ("bogus", "per_layer")):
        monkeypatch.setenv("KUBEAI_TPU_DECODE_KERNEL", env)
        jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
            cache_dtype=jnp.float32, **BASE))
        assert _torch_engine(models).decode_kernel == jeng.decode_kernel == want
    assert _torch_engine(models, decode_kernel="per_layer").decode_kernel == "per_layer"
    with pytest.raises(ValueError):
        _torch_engine(models, decode_kernel="bogus")


def test_draft_and_int8_refusals(models):
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="A13"):
        Engine("llama", tcfg, tparams, cfg=EngineConfig(**BASE, speculate=3),
               draft=(tcfg, tparams), device="cpu")
    # kv_dtype="int8" is refused as the JAX engine refuses it.
    with pytest.raises(ValueError, match="speculative"):
        _torch_engine(models, kv_dtype="int8", speculate=2)
    with pytest.raises(ValueError, match="fused"):
        _torch_engine(models, kv_dtype="int8", decode_kernel="fused")
