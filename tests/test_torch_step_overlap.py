"""Overlapped stepping and the device programs of kubeai_tpu_torch's
engine, on the CPU: the counterpart of tests/unit/test_step_overlap.py.

Token identity: the port's greedy and seeded streams with step_overlap on
equal its streams with overlap off, and both equal the JAX engine's with
overlap on (same f32 weights, carried across by kubeai_tpu_torch.parity),
in the per_layer and fused layouts, with speculation, and under
preemption. The barriers (admission, cancel, drain), the phase
vocabulary, inflight_info, knob parsing and HTTP completions through the
port's EngineServer. And the static-buffer discipline of
engine/graphs.py: on the CPU a dispatch overwrites the program's static
outputs at once, so reading a call after the next dispatch shows whether
its outputs were copied out at dispatch."""

import dataclasses
import json
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_post

from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.fleet import profiler as jprofiler
from kubeai_tpu.models import llama as jl
from kubeai_tpu_torch.engine import Engine, EngineConfig, EngineDraining, SamplingParams
from kubeai_tpu_torch.engine.graphs import DeviceProgram, HostStaging
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.fleet.profiler import PHASES, StepProfiler, phase_totals
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy

TOK = ByteTokenizer()
BASE = dict(num_slots=4, max_seq_len=128, page_size=16, decode_chunk=4)
# Five prompts for four slots: the fifth waits for a slot, so admission
# meets an in-flight chunk.
PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7],
    [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
    [30, 31],
    [7, 8, 9, 10] * 6,  # repeating n-grams: speculation accepts proposals
]
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=24),
    "seeded": dict(temperature=0.9, top_k=8, seed=13, max_tokens=24),
}
LAYOUTS = {
    "per_layer": dict(decode_kernel="per_layer"),
    "fused": dict(decode_kernel="fused"),
    "speculate": dict(speculate=4, spec_adaptive=False),
}
# Pages for ~2 sequences, and no stop token: every request runs to
# max_tokens, so the pool runs out and preempts.
TIGHT = dict(num_pages=1 + 9)
PREEMPT_SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=32),
    "seeded": dict(temperature=0.8, top_k=16, seed=9, max_tokens=24),
}


# 18 tokens short of max_seq_len: the last chunks meet the sequence cap.
CAP_PROMPT = list(range(1, 111))
CAP_SAMPLING = dict(temperature=0.0, max_tokens=40)


def _preempt_prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, TOK.vocab_size, 20).tolist() for _ in range(3)]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(models, overlap, eos=TOK.eos_token_ids, **kw):
    _, _, tcfg, tparams = models
    return Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, step_overlap=overlap, **{**BASE, **kw}),
        eos_token_ids=eos, device="cpu")


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's streams with overlap on: per layout and sampling
    mode over PROMPTS, and per sampling mode over the preempting pool.
    One engine per configuration (an idle engine is reusable)."""
    jcfg, jparams, _, _ = models

    def jengine(eos=TOK.eos_token_ids, **kw):
        return JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
            cache_dtype=jnp.float32, step_overlap="on", **{**BASE, **kw}),
            eos_token_ids=eos)

    out = {}
    for layout, kw in LAYOUTS.items():
        eng = jengine(**kw)
        assert eng._overlap
        for mode, sp in SAMPLING.items():
            out[layout, mode] = eng.generate(PROMPTS, JSamplingParams(**sp))
    eng = jengine(eos=(), **TIGHT)
    for mode, sp in PREEMPT_SAMPLING.items():
        out["tight", mode] = eng.generate(_preempt_prompts(), JSamplingParams(**sp))
    out["cap"] = eng.generate([CAP_PROMPT], JSamplingParams(**CAP_SAMPLING))
    return out


@pytest.fixture(scope="module")
def pair(models):
    """One overlapped and one synchronous per_layer engine, shared by the
    tests that need no fresh engine."""
    return _engine(models, "on"), _engine(models, "off")


def _step_until_inflight(eng, max_steps=64):
    """Step until a decode chunk is in flight; returns the events emitted
    on the way."""
    evs = []
    for _ in range(max_steps):
        evs.extend(eng.step())
        if eng._inflight is not None:
            return evs
    raise AssertionError("engine never held a chunk in flight")


def _collect(out, evs):
    for ev in evs:
        if ev.rid in out:
            out[ev.rid].append(ev.token)


# ---- token identity ------------------------------------------------------------


@pytest.mark.parametrize("mode", list(SAMPLING))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streams_overlap_on_equal_off_and_jax(models, jax_streams, layout, mode):
    on = _engine(models, "on", **LAYOUTS[layout])
    off = _engine(models, "off", **LAYOUTS[layout])
    assert on._overlap and not off._overlap
    sp = SamplingParams(**SAMPLING[mode])
    got_on = on.generate(PROMPTS, sp)
    assert got_on == off.generate(PROMPTS, sp)
    assert got_on == jax_streams[layout, mode]
    if layout == "speculate":
        assert on._inflight is None and on.spec_stats == off.spec_stats
        if mode == "greedy":
            assert on.spec_stats["accepted"] > 0
    for eng in (on, off):
        assert eng._alloc.free_pages == eng._n_pages - 1


@pytest.mark.parametrize("mode", list(PREEMPT_SAMPLING))
def test_preemption_under_overlap_token_identical(models, jax_streams, mode):
    """Pool exhaustion preempts mid-decode; the recompute resume replays
    identically whether or not a chunk was in flight at the eviction."""
    on = _engine(models, "on", eos=(), **TIGHT)
    off = _engine(models, "off", eos=(), **TIGHT)
    preempted = []
    on.on_preempt = lambda rid, client: preempted.append(rid)
    sp = SamplingParams(**PREEMPT_SAMPLING[mode])
    got = on.generate(_preempt_prompts(), sp)
    assert preempted, "the tight pool must force a preemption"
    assert got == off.generate(_preempt_prompts(), sp)
    assert got == jax_streams["tight", mode]


# ---- barriers ------------------------------------------------------------------


def test_sequence_cap_barrier_reaps_before_dispatch(models, jax_streams):
    """Near max_seq_len the in-flight chunk is reaped before the next
    dispatch, and the stream still equals the synchronous one."""
    on = _engine(models, "on", eos=(), **TIGHT)
    off = _engine(models, "off", eos=(), **TIGHT)
    before_dispatch = []
    process = on._process_chunk

    def spy(call):
        # One request, so nothing is pending after its admission: a reap
        # inside step() before this step's dispatch is the cap barrier.
        phases = on._phase_scratch
        before_dispatch.append(phases is not None and "decode" not in phases)
        return process(call)

    on._process_chunk = spy
    sp = SamplingParams(**CAP_SAMPLING)
    got = on.generate([CAP_PROMPT], sp)
    assert any(before_dispatch), "the sequence-cap barrier never reaped"
    assert got == off.generate([CAP_PROMPT], sp) == jax_streams["cap"]
    assert len(CAP_PROMPT) + len(got[0]) == BASE["max_seq_len"] + 1


def test_admission_barrier_reaps_before_admitting(models):
    eng = _engine(models, "on")
    first = eng.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=24))
    _step_until_inflight(eng)
    eng.add_request(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=4))
    inflight = eng._inflight
    before = len(eng._requests[first].out_tokens)
    eng.step()
    # The chunk in flight was reaped before the newcomer took its slot.
    assert len(eng._requests[first].out_tokens) >= before + inflight.chunk_len
    assert eng.num_pending == 0 and eng.num_active == 2


def test_cancel_barriers_inflight_and_survivor_is_identical(models, jax_streams, pair):
    on, off = pair
    sp = SamplingParams(**SAMPLING["greedy"])
    ref = off.generate(PROMPTS[:2], sp)
    assert ref == jax_streams["per_layer", "greedy"][:2]
    r0 = on.add_request(PROMPTS[0], sp)
    r1 = on.add_request(PROMPTS[1], sp)
    out = {r0: [], r1: []}
    _collect(out, _step_until_inflight(on))
    assert on.cancel(r0) is True
    # The barrier reaped before the slot and pages were released.
    assert on._inflight is None
    while on.has_work():
        _collect(out, on.step())
    assert out[r1] == ref[1]
    # The cancelled stream is a clean prefix of the synchronous one.
    assert out[r0] == ref[0][: len(out[r0])]
    assert on._alloc.free_pages == on._n_pages - 1


def test_cancel_barrier_events_reach_the_serve_loop(models):
    """The cancel barrier reaps a chunk that holds the other request's last
    token; with nothing else left to run, has_work() must still wake the
    serve loop to deliver that finish."""
    long_sp = SamplingParams(temperature=0.0, max_tokens=64)
    short = 6
    short_sp = SamplingParams(temperature=0.0, max_tokens=short)
    off = _engine(models, "off", eos=())
    ref = {off.add_request(PROMPTS[0], long_sp): [],
           off.add_request(PROMPTS[1], short_sp): []}
    while off.has_work():
        _collect(ref, off.step())
    ref_short = list(ref.values())[1]
    assert len(ref_short) == short

    eng = _engine(models, "on", eos=())
    r0 = eng.add_request(PROMPTS[0], long_sp)
    r1 = eng.add_request(PROMPTS[1], short_sp)
    out = {r0: [], r1: []}
    for _ in range(64):
        _collect(out, eng.step())
        inflight = eng._inflight
        if inflight is not None and len(out[r1]) + inflight.chunk_len >= short:
            break
    else:
        raise AssertionError("the short request's last chunk never went in flight")
    assert len(out[r1]) < short
    assert eng.cancel(r0) is True
    # Only the barrier's reaped events are left, and they count as work.
    assert eng._inflight is None and not eng._active and not len(eng._sched)
    assert eng._pending_events and eng.has_work()
    srv = EngineServer(eng, TOK, "m", port=0)
    sub = queue.Queue()
    srv._subscribers[r1] = sub
    srv.start()
    try:
        while True:
            ev = sub.get(timeout=30)
            out[r1].append(ev.token)
            if ev.finished:
                break
    finally:
        srv.stop()
    assert out[r1] == ref_short
    assert not eng.has_work()


def test_begin_drain_barriers_inflight_and_finishes_cleanly(models, jax_streams):
    on = _engine(models, "on")  # draining is terminal for an engine
    sp = SamplingParams(**SAMPLING["greedy"])
    rids = [on.add_request(p, sp) for p in PROMPTS]
    out = {r: [] for r in rids}
    _collect(out, _step_until_inflight(on))
    on.begin_drain()
    assert on._inflight is None  # drain decisions see settled state
    while on.has_work():
        _collect(out, on.step())
    assert [out[r] for r in rids] == jax_streams["per_layer", "greedy"]
    with pytest.raises(EngineDraining):
        on.add_request(PROMPTS[0], sp)


def test_inflight_info_and_has_work(models):
    eng = _engine(models, "on")
    assert eng.inflight_info() is None and not eng.has_work()
    rid = eng.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=5))
    t0 = time.monotonic()
    _step_until_inflight(eng)
    info = eng.inflight_info()
    assert t0 <= info["dispatched_at"] <= time.monotonic()
    while eng.num_active:  # the request finishes inside a chunk ...
        eng.step()
    # ... and the overlapped engine still holds a chunk to reap.
    assert eng._requests.get(rid) is None
    assert eng._inflight is not None and eng.has_work()
    while eng.has_work():
        eng.step()
    assert eng.inflight_info() is None and eng._inflight is None


# ---- phases, knobs -------------------------------------------------------------


def test_phase_vocabulary_host_sync_split(models, pair):
    assert PHASES == jprofiler.PHASES
    assert "host_sync" not in PHASES
    for name in ("dispatch", "overlap_idle", "readback"):
        assert name in PHASES
    for eng in pair:
        eng.generate(PROMPTS[:2], SamplingParams(temperature=0.0, max_tokens=12))
        totals = phase_totals(eng.profiler.recent())
        assert "host_sync" not in totals
        for name in ("prefill", "schedule", "decode", "dispatch", "overlap_idle",
                     "readback", "sample"):
            assert name in totals, name
        assert set(totals) <= set(PHASES)
        assert eng.last_step_stats["duration_s"] > 0


def test_step_profiler_stays_bounded(models):
    """Every step closes a record into the profiler; nothing the profiler
    holds may grow past its ring's bound however long the engine runs."""
    eng = _engine(models, "on")
    eng.profiler = StepProfiler(maxlen=4)
    eng.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=24))
    assert eng.profiler.steps_completed > 4
    assert len(eng.profiler.recent()) == 4
    assert [r["step"] for r in eng.profiler.recent()] == list(
        range(eng.profiler.steps_completed - 3, eng.profiler.steps_completed + 1))
    held = sum(len(v) for v in vars(eng.profiler).values()
               if isinstance(v, (list, dict, set, tuple)) or hasattr(v, "maxlen"))
    assert held == 4


@pytest.mark.parametrize("value,want", [
    ("auto", True), ("on", True), (" ON ", True), ("", True), (True, True),
    ("off", False), (False, False),
])
def test_step_overlap_knob_parsing(models, value, want):
    assert _engine(models, value)._overlap is want


def test_step_overlap_rejects_unknown_values(models):
    with pytest.raises(ValueError, match="step_overlap"):
        _engine(models, "sometimes")


# ---- over HTTP -----------------------------------------------------------------


def test_http_completions_identical_overlap_vs_sync(pair):
    on, off = pair
    greedy = {"model": "m", "prompt": "overlap me", "max_tokens": 12, "temperature": 0}
    seeded = {"model": "m", "prompt": "overlap me", "max_tokens": 12,
              "temperature": 0.9, "seed": 13}
    texts = {}
    for name, eng in (("on", on), ("off", off)):
        srv = EngineServer(eng, TOK, "m", port=0)
        srv.start()
        try:
            addr = f"127.0.0.1:{srv.port}"
            got = []
            for body in (greedy, seeded):
                status, raw = http_post(addr, "/v1/completions", body, timeout=60)
                assert status == 200
                got.append(json.loads(raw)["choices"][0]["text"])
            texts[name] = got
        finally:
            srv.stop()
        # The serve loop stepped on until the last chunk was reaped.
        assert eng._inflight is None and not eng.has_work()
    assert texts["on"] == texts["off"]


# ---- the static-buffer discipline of the device programs -----------------------


def test_two_dispatches_before_a_reap_deliver_the_first_chunk(models):
    eng = _engine(models, "on")
    program = eng._decode_program
    assert program.graph is None and program.launches() == {}
    eng.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=64))
    eng.step()  # admission, then chunk 1 in flight
    assert eng._inflight is not None
    first = eng._inflight.ring
    want_first = eng._chunk_out.clone()  # chunk 1, before anything overwrites it
    eng._ensure_decode_pages(inflight_lag=eng._inflight.chunk_len)
    eng._bt_staging.upload(eng._bt_host)
    with torch.no_grad():
        second = program.dispatch()  # overwrites the static output now
    assert second != first
    assert not torch.equal(eng._chunk_out, want_first)
    [got_first] = program.read(first)
    [got_second] = program.read(second)
    np.testing.assert_array_equal(got_first, want_first.numpy())
    np.testing.assert_array_equal(got_second, eng._chunk_out.numpy())
    eng._inflight = None  # both chunks were read here, not by step()


def test_ring_refuses_to_overwrite_an_unread_slot():
    out = torch.zeros(3, dtype=torch.int64)
    calls = []

    def fn():
        calls.append(None)
        out.fill_(len(calls))

    program = DeviceProgram(fn, (out,), torch.device("cpu"), capture=False)
    a, b = program.dispatch(), program.dispatch()
    with pytest.raises(RuntimeError, match="not read"):
        program.dispatch()
    assert [r.tolist() for r in program.read(a)] == [[1, 1, 1]]
    c = program.dispatch()
    assert c == a and program.dispatches == 3
    assert [r.tolist() for r in program.read(b)] == [[2, 2, 2]]
    assert [r.tolist() for r in program.read(c)] == [[3, 3, 3]]


def test_block_table_staging_keeps_a_dispatched_table(models):
    """A host edit after an upload reaches the device table only through
    the next upload: the staging buffers never alias the host mirror."""
    dst = torch.full((2, 3), -1, dtype=torch.int32)
    staging = HostStaging(dst)
    host = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    staging.upload(host)
    host[0, 0] = 99
    assert dst.tolist() == [[1, 2, 3], [4, 5, 6]]
    address = dst.data_ptr()
    staging.upload(host)
    assert dst.tolist() == [[99, 2, 3], [4, 5, 6]]
    assert dst.data_ptr() == address  # updated in place
    # In the engine: the device table is updated in place, never rebound.
    eng = _engine(models, "on")
    table = eng.cache.block_tables
    eng.generate([PROMPTS[0]], SamplingParams(temperature=0.0, max_tokens=6))
    assert eng.cache.block_tables is table
    assert eng._bt_staging.dst is table
    assert not np.shares_memory(eng._bt_host, table.numpy())
