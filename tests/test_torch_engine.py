"""kubeai_tpu_torch.engine.Engine against kubeai_tpu.engine.Engine: the
same weights (f32, carried across by kubeai_tpu_torch.parity), prompts
and sampling params give IDENTICAL greedy and seeded token streams, over
mixed prompt lengths across prefill buckets and over an oversubscribed
page pool that forces preemption (recompute). The JAX streams are built
once per module."""

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
    (dict(step_overlap="on"), "A7"),
    (dict(speculate=2), "A9"),
    (dict(prefill_chunk=32), "A8"),
    (dict(prefix_cache=True), "A8"),
    (dict(kv_dtype="int8"), "A10"),
    (dict(quantization="int8"), "A12"),
    (dict(max_adapters=2), "A11"),
    (dict(cache_mode="slot"), "A13"),
    (dict(decode_kernel="fused"), "B4"),
])
def test_unported_settings_raise(models, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        _torch_engine(models, **kw)


def test_mesh_raises_and_auto_overlap_is_synchronous(models):
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="A14"):
        Engine("llama", tcfg, tparams, mesh=object(), device="cpu")
    for overlap in ("auto", "off"):
        eng = _torch_engine(models, step_overlap=overlap)
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
