"""Draft-model speculation in kubeai_tpu_torch against the JAX package, on
the CPU in f32 (the port's counterpart of tests/unit/test_draft_spec.py,
case by case).

A small same-family draft keeps its own slot cache and proposes each
speculative window with a greedy chain; the target verifies it. The
port's streams and `spec_stats` must equal the JAX draft engine's, and
the streams must equal vanilla decoding, for:
  - a disagreeing draft (smaller, independently initialised), greedy and
    seeded, and over two batches that reuse every slot;
  - the target as its own draft, where greedy acceptance is total while
    prompt lookup on the same random prompts accepts far less;
  - chunked prefill (the draft's own chunked prefill keeps its row in
    step) and the prefix cache (a hit still prefills the whole prompt
    into the draft);
  - adaptive windows, with chunk-mode windows between verify windows:
    the catch-up keeps the draft in step (a scripted mode schedule in
    both packages, and the port's own measured choice);
  - a handoff import, which the JAX engine serves from a stale draft row
    (ROADMAP fault C14) and the port prefills into the draft first;
  - the JAX engine's refusals, word for word.

The JAX engines run once per module.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.disagg import handoff as jhandoff
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.models import gemma as jg
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.disagg import handoff
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.kvcache import KVCache
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4,
            spec_adaptive=False)
GREEDY = dict(temperature=0.0, max_tokens=16)
SEEDED = dict(temperature=0.9, top_k=20, max_tokens=12, seed=31)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny ops: one intra-op thread
    keeps them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _pair(name: str):
    """(JAX config, JAX params, port config, port params) in f32 of the
    "target", or of the "draft": a smaller, independently initialised
    model that disagrees with the target most of the time (the exactness
    cases' worst case). Built on first use, not at import."""
    seed, kw = (0, {}) if name == "target" else (
        7, dict(num_layers=1, hidden_size=32, intermediate_size=64))
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32, **kw)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _prompts(n, seed=42):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, rng.integers(5, 40)).tolist() for _ in range(n)]


def _jax(draft=None, **kw):
    """A JAX engine on the target; `draft` names the draft ("target" or
    "draft") or is None."""
    jcfg, jparams = _pair("target")[:2]
    cfg = JEngineConfig(cache_dtype=jnp.float32, step_overlap="off", **{**BASE, **kw})
    return JEngine("llama", jcfg, jparams, cfg=cfg,
                   draft=None if draft is None else _pair(draft)[:2])


def _port(draft=None, **kw):
    """The port's engine on the target; `draft` as for _jax, or a (config,
    params) pair."""
    tcfg, tparams = _pair("target")[2:]
    if isinstance(draft, str):
        draft = _pair(draft)[2:]
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **{**BASE, **kw}), draft=draft, device="cpu")


def _vanilla(prompts, sp, **kw):
    return _port(**kw).generate(prompts, SamplingParams(**sp))


# Each JAX run: (engine kwargs, draft, [(prompts, sampling), ...]) on one
# engine, in order; the port repeats it on one engine of its own.
RUNS = {
    "disagree": (dict(speculate=3), "draft", [
        (_prompts(5), GREEDY), (_prompts(4, seed=9), SEEDED),
        # More prompts than slots, twice: every slot is reused.
        (_prompts(6, seed=1), dict(GREEDY, max_tokens=8)),
        (_prompts(6, seed=2), dict(GREEDY, max_tokens=8))]),
    "self": (dict(speculate=3), "target", [(_prompts(4, seed=5), GREEDY)]),
    "chunked": (dict(speculate=3, prefill_chunk=16), "draft", [
        ([np.random.default_rng(17).integers(1, 512, n).tolist() for n in (50, 90, 12)],
         GREEDY)]),
}


def _prefix_prompts():
    rng = np.random.default_rng(19)
    system = rng.integers(1, 512, 48).tolist()
    return [system + rng.integers(1, 512, 10).tolist() for _ in range(2)]


def _run(eng, runs, sp_cls):
    """Each (prompts, sampling) of `runs` on `eng` in turn: the streams and
    the spec_stats after each."""
    out = []
    for prompts, sp in runs:
        out.append((eng.generate(prompts, sp_cls(**sp)), dict(eng.spec_stats)))
    return out


def _scripted(eng):
    """Replace the engine's adaptive mode choice by a fixed schedule (two
    verify windows, then a decode chunk), the same in both packages."""
    picks = itertools.cycle([True, True, False])
    eng._spec_pick = lambda: next(picks)
    return eng


@pytest.fixture(scope="module")
def jax_runs():
    out = {name: _run(_jax(draft, **kw), runs, JSamplingParams)
           for name, (kw, draft, runs) in RUNS.items()}
    eng = _jax("target", speculate=3, prefill_chunk=16, prefix_cache=True)
    out["prefix"] = _run(eng, [(_prefix_prompts()[:1], dict(GREEDY, max_tokens=12)),
                               (_prefix_prompts()[1:], dict(GREEDY, max_tokens=12))],
                         JSamplingParams)
    out["prefix_hits"] = eng.prefix_stats["hit_tokens"]
    eng = _scripted(_jax("target", speculate=3, spec_adaptive=True))
    out["adaptive"] = _run(eng, [(_prompts(4, seed=11), dict(GREEDY, max_tokens=24))],
                           JSamplingParams)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_draft_streams_and_stats_equal_jax(jax_runs, name):
    kw, draft, runs = RUNS[name]
    eng = _port(draft, **kw)
    assert eng._draft is (draft is not None)
    got = _run(eng, runs, SamplingParams)
    assert got == jax_runs[name]
    for (streams, _), (prompts, sp) in zip(got, runs):
        assert streams == _vanilla(prompts, sp, prefill_chunk=kw.get("prefill_chunk", 0))
    if draft is not None:
        assert isinstance(eng.draft_cache, KVCache)
        dcfg = _pair(draft)[2]
        assert eng.draft_cache.k.shape == (dcfg.num_layers, 4, 128,
                                           dcfg.num_kv_heads, dcfg.head_size)


def test_self_draft_acceptance_is_total_where_lookup_collapses(jax_runs):
    """Target-as-draft on random prompts: every window accepts all gamma
    proposals, while prompt lookup (the port's, whose stats equal the JAX
    engine's: tests/test_torch_engine.py) accepts far less."""
    s = jax_runs["self"][-1][1]
    eng = _port(speculate=3)
    eng.generate(_prompts(4, seed=5), SamplingParams(**GREEDY))
    lookup = eng.spec_stats
    assert s["windows"] > 0 and s["accepted"] == s["proposed"], s
    assert s["accepted"] / s["proposed"] > lookup["accepted"] / max(1, lookup["proposed"]) + 0.5


def test_draft_with_prefix_cache_matches_jax(jax_runs):
    """A prefix-hit admission still prefills the whole prompt into the
    draft (it shares no pages): self-draft acceptance stays total."""
    eng = _port("target", speculate=3, prefill_chunk=16, prefix_cache=True)
    sp = dict(GREEDY, max_tokens=12)
    got = _run(eng, [(_prefix_prompts()[:1], sp), (_prefix_prompts()[1:], sp)],
               SamplingParams)
    assert got == jax_runs["prefix"]
    assert eng.prefix_stats["hit_tokens"] == jax_runs["prefix_hits"] > 0
    s = eng.spec_stats
    assert s["accepted"] == s["proposed"] > 0
    assert [g[0][0] for g in got] == [
        _vanilla(p, sp, prefill_chunk=16)[0] for p in (_prefix_prompts()[:1],
                                                       _prefix_prompts()[1:])]


def test_scripted_chunk_windows_match_jax(jax_runs):
    """Verify windows and decode chunks in a fixed order: after each
    chunk the catch-up replays it through the draft, so the self-draft
    keeps accepting everything, with the JAX engine's stats."""
    eng = _scripted(_port("target", speculate=3, spec_adaptive=True))
    sp = dict(GREEDY, max_tokens=24)
    got = _run(eng, [(_prompts(4, seed=11), sp)], SamplingParams)
    assert got == jax_runs["adaptive"]
    s = got[0][1]
    assert s["windows"] > 0 and s["accepted"] == s["proposed"], s
    assert got[0][0] == _vanilla(_prompts(4, seed=11), sp)


def test_adaptive_chunk_windows_keep_draft_synced():
    """spec_adaptive with its measured choice (spec_probe_every=2): chunk
    windows run, the streams equal vanilla decoding, and every verify
    window after them still accepts all its proposals."""
    eng = _port("target", speculate=3, spec_adaptive=True, spec_probe_every=2)
    sp = dict(GREEDY, max_tokens=24)
    prompts = _prompts(4, seed=11)
    assert eng.generate(prompts, SamplingParams(**sp)) == _vanilla(prompts, sp)
    assert eng._mode_calls.get("chunk", 0) >= 2
    s = eng.spec_stats
    assert s["windows"] > 0 and s["accepted"] == s["proposed"], s


def _handoff_run(eng, h, sp_cls):
    rid, first = eng.import_handoff(h)
    stream = [first.token]
    while eng.has_work():
        stream += [ev.token for ev in eng.step() if ev.rid == rid]
    return stream


def test_handoff_import_prefills_the_draft():
    """A handoff exported by a prefill engine without a draft (the port's;
    its wire is the JAX package's byte for byte), imported by a
    self-draft engine of each package whose slots hold other requests'
    rows: the streams equal the direct stream in both; the port's
    acceptance equals a direct admission's (total), while the JAX
    engine's falls, because its import leaves the draft's row stale
    (ROADMAP fault C14)."""
    prompt = _prompts(1, seed=23)[0]
    sp = dict(GREEDY, max_tokens=20)
    jeng = _jax("target", speculate=3)
    direct = jeng.generate([prompt], JSamplingParams(**sp))[0]
    direct_stats = dict(jeng.spec_stats)
    assert direct_stats["accepted"] == direct_stats["proposed"] > 0
    # Other prompts first, so the slot the import takes holds stale rows.
    jeng.generate(_prompts(4, seed=29), JSamplingParams(**sp))
    blob = handoff.serialize(_port().export_handoff(prompt, SamplingParams(**sp)))
    h = jhandoff.deserialize(blob)
    before = dict(jeng.spec_stats)
    jstream = _handoff_run(jeng, h, JSamplingParams)
    j_acc = jeng.spec_stats["accepted"] - before["accepted"]
    j_prop = jeng.spec_stats["proposed"] - before["proposed"]

    eng = _port("target", speculate=3)
    eng.generate(_prompts(4, seed=29), SamplingParams(**sp))
    before = dict(eng.spec_stats)
    tstream = _handoff_run(eng, handoff.deserialize(blob), SamplingParams)
    t_acc = eng.spec_stats["accepted"] - before["accepted"]
    t_prop = eng.spec_stats["proposed"] - before["proposed"]
    assert jstream == tstream == direct
    assert t_acc == t_prop == direct_stats["proposed"]
    assert j_acc < j_prop  # fault C14: the JAX draft proposes from a stale row


def _raises_alike(fn, jfn, exc):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        jfn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_refusals_match_jax():
    cases = (
        (dict(speculate=0), "speculate == 0"),
        (dict(speculate=3, cache_mode="slot"), "unavailable"),
        (dict(speculate=3, kv_dtype="int8"), "speculative"),
    )
    for kw, words in cases:
        msg = _raises_alike(lambda: _port("draft", **kw), lambda: _jax("draft", **kw), ValueError)
        assert words in msg
    # Gemma has no verify forward: a draft cannot propose.
    jcfg = dataclasses.replace(jg.GemmaConfig.tiny(), dtype=jnp.float32)
    jparams = jg.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tg.GemmaConfig.tiny(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    msg = _raises_alike(
        lambda: Engine("gemma", tcfg, tparams, cfg=EngineConfig(speculate=3, **{
            k: v for k, v in BASE.items() if k != "spec_adaptive"}),
            draft=(tcfg, tparams), device="cpu"),
        lambda: JEngine("gemma", jcfg, jparams, cfg=JEngineConfig(speculate=3),
                        draft=(jcfg, jparams)),
        ValueError)
    assert "family verify=False" in msg
    # The port's own check: a proposal past the target's table.
    wide = dataclasses.replace(_pair("draft")[2], vocab_size=1024)
    with pytest.raises(ValueError, match="vocabulary"):
        _port((wide, tl.init_params(wide, torch.Generator().manual_seed(0), "cpu")),
              speculate=3)
