"""The engine server's telemetry surface in kubeai_tpu_torch, against the
JAX package, on the CPU: `POST /v1/profile`, the flight recorder, tracing
and the `--pipeline` flag.

- /v1/profile: the validation, messages and response keys of the JAX
  server (tests/unit/test_fleet_telemetry.py), the fresh capture's wait
  on new steps, and `jax_trace: true`, which writes a torch.profiler
  Chrome trace and names its directory under the JAX key.
- The flight recorder: `bundle_lines`, `state_payload` and the recorder's
  own exposition byte-equal to the JAX recorder's for the same events
  under a fake clock; the server records admissions, deadline sheds,
  preemptions, a watchdog wedge and a crashed loop as the JAX server
  does, and /v1/state carries `flight_recorder`.
- Tracing: `parse_traceparent` agrees with the JAX function on the cases
  of tests/unit/test_tracing.py; the OTLP payload equals the JAX
  tracer's for the same spans, apart from the scope's name; the engine's
  server span continues a client's trace with `request.id`, as the JAX
  server's does, against a fake collector; dropped spans show on
  /metrics.
"""

import dataclasses
import json
import os
import shutil
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
from kubeai_tpu.metrics import flightrecorder as jflightrecorder
from kubeai_tpu.metrics import registry as jregistry
from kubeai_tpu.metrics import tracing as jtracing
from kubeai_tpu.models import llama as jl
from kubeai_tpu.scheduling.scheduler import DeadlineInfeasible as JDeadlineInfeasible
from kubeai_tpu_torch.engine import Engine, EngineConfig
from kubeai_tpu_torch.engine.server import EngineServer, engine_config, parse_args
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.fleet.profiler import StepProfiler
from kubeai_tpu_torch.metrics import flightrecorder, registry, tracing
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.parity import params_from_numpy
from kubeai_tpu_torch.scheduling.scheduler import DeadlineInfeasible

TOK = ByteTokenizer()
ENGINE = dict(num_slots=4, max_seq_len=128, decode_chunk=4)
COMPLETION = {"model": "tiny", "prompt": "hello", "max_tokens": 8, "temperature": 0}


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) over the same tiny f32 weights."""
    jcfg = dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, **ENGINE), eos_token_ids=TOK.eos_token_ids)
    teng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, **ENGINE),
        eos_token_ids=TOK.eos_token_ids, device="cpu")
    jsrv = JEngineServer(jeng, JByteTokenizer(), "tiny", host="127.0.0.1", port=0)
    tsrv = EngineServer(teng, TOK, "tiny", port=0)
    for srv in (jsrv, tsrv):
        srv.start()
        status, _ = http_post(_addr(srv), "/v1/completions", COMPLETION, timeout=120)
        assert status == 200
    yield jsrv, tsrv
    tsrv.stop()
    jsrv.stop()


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _post_json(srv, path: str, body: dict, **kw) -> tuple[int, dict]:
    status, raw = http_post(_addr(srv), path, body, timeout=120, **kw)
    return status, json.loads(raw)


# ---- /v1/profile -------------------------------------------------------------------


def test_profile_reports_multistep_phases(servers):
    jsrv, tsrv = servers
    _, want = _post_json(jsrv, "/v1/profile", {"steps": 32})
    status, got = _post_json(tsrv, "/v1/profile", {"steps": 32})
    assert status == 200
    assert set(got) == set(want)
    assert got["object"] == "engine.profile" and got["model"] == "tiny"
    assert got["steps_requested"] == 32 and got["jax_trace_dir"] is None
    steps = got["steps"]
    # 8 tokens at decode_chunk=4: an admission and at least two chunks.
    assert got["steps_completed_total"] >= 2 and len(steps) >= 2
    assert got["steps_captured"] == len(steps)
    assert {k for s in steps for k in s} == {k for s in want["steps"] for k in s}
    for s in steps:
        assert s["ts"] > 0 and s["duration_s"] >= 0
        assert all(v >= 0 for v in s["phases_s"].values())
    assert any(s["phases_s"].get("prefill", 0) > 0 for s in steps)
    for phase in ("decode", "overlap_idle", "readback"):
        assert any(phase in s["phases_s"] for s in steps), phase
    assert got["phase_totals_s"].get("decode", 0) > 0
    status, body = http_get(_addr(tsrv), "/metrics")
    parsed = registry.parse_prometheus_text(body.decode())
    assert parsed[("kubeai_engine_step_phase_seconds_count", (("phase", "decode"),))] >= 2


def _profile_under_load(srv, body: dict) -> tuple[int, dict, list]:
    """POST /v1/profile while completions run back to back, so that new
    steps come whenever the capture window opens. Returns the profile's
    status and body and the completions' statuses."""
    done = threading.Event()
    statuses: list[int] = []

    def generate():
        while not done.is_set():
            statuses.append(http_post(_addr(srv), "/v1/completions", {
                "model": "tiny", "prompt": "stream me", "max_tokens": 12,
                "temperature": 0}, timeout=120)[0])

    t = threading.Thread(target=generate)
    t.start()
    try:
        status, got = _post_json(srv, "/v1/profile", body)
    finally:
        done.set()
        t.join(timeout=120)
    return status, got, statuses


def test_profile_fresh_capture_waits_for_new_steps(servers):
    _, tsrv = servers
    status, got, statuses = _profile_under_load(
        tsrv, {"steps": 2, "fresh": True, "timeout_s": 60})
    assert status == 200 and got["steps_captured"] >= 2
    assert statuses and set(statuses) == {200}


def test_wait_for_steps_times_out_without_steps():
    prof = StepProfiler()
    t0 = time.monotonic()
    assert prof.wait_for_steps(3, 0.2) == 0
    assert 0.15 < time.monotonic() - t0 < 5
    threading.Timer(0.05, lambda: [prof.observe_step({"decode": 0.1}) for _ in range(3)]).start()
    assert prof.wait_for_steps(3, 10.0) == 3


@pytest.mark.parametrize("body", [
    {"steps": 0}, {"steps": "ten"}, {"steps": True}, {"steps": 10_001},
    {"timeout_s": 600}, {"timeout_s": 0}, {"timeout_s": "x"},
], ids=lambda b: json.dumps(b))
def test_profile_validates_input_as_jax(servers, body):
    jsrv, tsrv = servers
    assert _post_json(tsrv, "/v1/profile", body) == _post_json(jsrv, "/v1/profile", body)
    assert _post_json(tsrv, "/v1/profile", body)[0] == 400


def test_profile_trace_writes_a_chrome_trace(servers):
    _, tsrv = servers
    status, got, statuses = _profile_under_load(
        tsrv, {"steps": 2, "fresh": True, "timeout_s": 60, "jax_trace": True})
    assert status == 200 and got["steps_captured"] >= 2 and set(statuses) == {200}
    trace_dir = got["jax_trace_dir"]
    assert trace_dir and os.path.basename(trace_dir).startswith("kubeai-profile-")
    try:
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    # The window recorded the engine's CPU ops, which the serve loop's
    # thread runs.
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_profile_trace_that_cannot_start_gives_null(servers, monkeypatch):
    _, tsrv = servers
    import torch.profiler

    def refuse(*a, **kw):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    status, got = _post_json(tsrv, "/v1/profile", {"steps": 4, "jax_trace": True})
    assert status == 200 and got["jax_trace_dir"] is None and got["steps"]


# ---- the flight recorder -------------------------------------------------------------


def test_recorder_constants_match_jax():
    for name in ("EVENT_KINDS", "RECORD_KINDS", "TRIGGER_WATCHDOG", "TRIGGER_FAST_BURN",
                 "SCHED_ADMIT", "SCHED_SHED", "SCHED_PREEMPT", "WATCHDOG",
                 "STEP_ANOMALY", "NONDETERMINISTIC_METRICS"):
        assert getattr(flightrecorder, name) == getattr(jflightrecorder, name), name


def _recorder_run(fr_mod, reg_mod):
    """The same decisions, spans, captures and triggers on one recorder
    under a fake clock: (bundle lines, incidents, state, exposition)."""
    clock = iter(np.arange(1000.0, 1100.0, 0.5))
    rec = fr_mod.FlightRecorder(clock=lambda: float(next(clock)), ring_size=3,
                                min_trigger_interval_s=10.0)
    reg = reg_mod.Registry()
    c = reg_mod.Counter("kubeai_x_total", "x", reg)
    rec.capture_metrics(reg)
    rec.record(fr_mod.SCHED_ADMIT, "engine_sched", target="m", trace_id="rid-0",
               priority="standard", choices=1)
    rec.record(fr_mod.SCHED_SHED, "engine_sched", target="m", priority="batch",
               deadline_ms=5.0, reason="infeasible")
    for i in range(3):
        rec.record(fr_mod.SCHED_PREEMPT, "engine_sched", target="m",
                   trace_id=f"rid-{i}", client="c")
    rec.record(fr_mod.WATCHDOG, "engine", target="m", stalled_for_s=1.5, active=2,
               pending=0)
    rec.note_span({"name": "engine /v1/completions", "trace_id": "ab" * 16})
    rec.note_exemplars("ttft", {"0.5": "rid-1"})
    c.inc(3, model="m")
    rec.capture_metrics(reg)
    first = rec.trigger(fr_mod.TRIGGER_WATCHDOG, detail="no step progress")
    debounced = rec.trigger(fr_mod.TRIGGER_WATCHDOG, detail="again")
    with pytest.raises(ValueError):
        rec.record("not_a_kind", "engine")
    lines = rec.bundle_lines(fr_mod.TRIGGER_WATCHDOG, "now", {"sim": "x"})
    return (lines, [i["lines"] for i in rec.incidents], first, debounced,
            rec.state_payload(), rec.events(), rec.metrics.registry.expose())


def test_recorder_bundles_byte_equal_to_jax():
    got = _recorder_run(flightrecorder, registry)
    assert got == _recorder_run(jflightrecorder, jregistry)
    lines = got[0]
    assert json.loads(lines[0])["reason"] == "watchdog_wedge"
    assert {json.loads(x)["record"] for x in lines[1:]} == {
        "flight", "span", "metric_delta", "exemplar"}


class _StubEngine:
    """Engine stand-in for both servers: `mode` picks what it does."""

    def __init__(self, mode: str):
        self.mode = mode
        self.cfg = types.SimpleNamespace(max_seq_len=128)
        self._block = threading.Event()
        self._queued = False
        self.num_active = 1 if mode == "stuck" else 0

    def loaded_adapters(self):
        return []

    def add_request(self, prompt, sp, on_admit=None, **kw):
        if self.mode == "shed":
            exc = JDeadlineInfeasible if self.jax else DeadlineInfeasible
            raise exc("deadline 5ms infeasible: estimated wait 2.000s",
                      retry_after=2.0, estimated_wait=2.0, deadline_s=0.005)
        self._queued = True
        return 0

    def has_work(self):
        return self.mode == "stuck" or self._queued

    def step(self):
        if self.mode == "crash":
            raise RuntimeError("device lost")
        self._block.wait(timeout=30)
        return []

    def cancel(self, rid):
        return False

    num_pending = 0


def _stub_server(server_cls, mode: str, jax_side: bool, **kw):
    eng = _StubEngine(mode)
    eng.jax = jax_side
    tok = JByteTokenizer() if jax_side else TOK
    return server_cls(eng, tok, "m1", host="127.0.0.1", port=0, **kw)


def _post_quietly(srv) -> None:
    try:
        http_post(_addr(srv), "/v1/completions",
                  {"model": "m1", "prompt": "x", "max_tokens": 4}, timeout=2)
    except OSError:
        pass


def _events(srv) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in ("t", "seq")}
            for e in srv.recorder.events()]


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


@pytest.mark.parametrize("mode", ["shed", "stuck", "crash"])
def test_server_records_engine_decisions_as_jax(mode):
    """A deadline shed, a watchdog wedge and a crashed serving loop land
    in the recorder as the JAX server records them, with the watchdog's
    incident bundle and `flight_recorder` in /v1/state."""
    kind = {"shed": "scheduler_shed", "stuck": "engine_watchdog",
            "crash": "engine_step_anomaly"}[mode]
    got = {}
    for jax_side, cls in ((True, JEngineServer), (False, EngineServer)):
        srv = _stub_server(cls, mode, jax_side, watchdog_timeout=0.2,
                           watchdog_action=lambda: None)
        srv.start()
        try:
            if mode == "shed":
                status, _ = http_post(_addr(srv), "/v1/completions",
                                      {"model": "m1", "prompt": "x", "max_tokens": 4},
                                      headers={"X-Deadline-Ms": "5"})
                assert status == 429
            elif mode == "crash":
                # The request waits out its timeout on the dead loop.
                threading.Thread(target=_post_quietly, args=(srv,), daemon=True).start()
            _wait_for(lambda: any(e["kind"] == kind for e in srv.recorder.events()))
            if mode == "stuck":
                _wait_for(lambda: srv.recorder.incidents)
            _, body = http_get(_addr(srv), "/v1/state")
            state = json.loads(body)["flight_recorder"]
            state["incidents"] = [
                {k: v for k, v in i.items() if k != "t"} for i in state["incidents"]]
            events = _events(srv)
            if mode == "stuck":
                for e in events:
                    e["detail"]["stalled_for_s"] = "*"  # wall clock
                    e["detail"]["active"] = "*"
            got[jax_side] = (events, state)
        finally:
            srv._stop.set()
            srv.engine._block.set()
            srv.stop()
    assert got[False] == got[True]
    events, state = got[False]
    # The crashing engine admitted its request before its loop died.
    assert [e["kind"] for e in events] == ["scheduler_admit"] * (mode == "crash") + [kind]
    if mode == "stuck":
        assert [i["reason"] for i in state["incidents"]] == ["watchdog_wedge"]
    if mode == "crash":
        assert events[-1]["detail"] == {"reason": "loop_crash"}


def test_state_flight_recorder_matches_jax(servers):
    """After the same admitted requests both servers' engine_sched rings
    hold the same admissions."""
    jsrv, tsrv = servers
    body = {**COMPLETION, "n": 2, "temperature": 0.7, "seed": 4}

    def rings():
        return [json.loads(http_get(_addr(s), "/v1/state")[1])["flight_recorder"]
                for s in (jsrv, tsrv)]

    before = rings()
    for srv in (jsrv, tsrv):
        assert http_post(_addr(srv), "/v1/completions", body, timeout=120,
                         headers={"X-Priority": "batch"})[0] == 200
    after = rings()
    assert set(after[1]) == set(after[0])
    for b, a in zip(before, after):
        assert a["rings"]["engine_sched"] == b["rings"]["engine_sched"] + 1
    # The last admission of each (the servers served different traffic
    # before), without the engine's rid.
    admits = [[e for e in _events(s) if e["kind"] == "scheduler_admit"][-1]
              for s in (jsrv, tsrv)]
    for e in admits:
        assert e.pop("trace_id").startswith("rid-")
    assert admits[1] == admits[0]
    assert admits[1]["detail"] == {"priority": "batch", "choices": 2}


def test_server_records_preemption():
    """A pool too small for three sequences preempts; each preemption
    lands in the engine_sched ring with the victim's rid."""
    tcfg = dataclasses.replace(
        tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size), dtype=torch.float32)
    tparams = tl.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine("llama", tcfg, tparams, cfg=EngineConfig(
        cache_dtype=torch.float32, num_slots=4, max_seq_len=128, page_size=16,
        decode_chunk=4, num_pages=1 + 9), eos_token_ids=(), device="cpu")
    srv = EngineServer(eng, TOK, "m1", port=0)
    srv.start()
    try:
        rng = np.random.default_rng(3)
        threads = [threading.Thread(target=http_post, args=(
            _addr(srv), "/v1/completions",
            {"model": "m1", "prompt": "".join(chr(c) for c in rng.integers(97, 123, 20)),
             "max_tokens": 32, "temperature": 0}), kwargs={"timeout": 120})
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.stop()
    preempts = [e for e in srv.recorder.events("engine_sched")
                if e["kind"] == "scheduler_preempt"]
    assert preempts
    for e in preempts:
        assert e["target"] == "m1" and e["trace_id"].startswith("rid-")
        assert e["detail"] == {"client": ""}


# ---- tracing --------------------------------------------------------------------------


TRACEPARENTS = [
    None, "", "junk",
    "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "0-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 33 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 17 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "z" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-0g",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-",
    "00 " + "a" * 32 + " " + "b" * 16 + " 01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01\x00",
    "é" * 8,
    "00--" + "b" * 16 + "-01",
    # Valid: plain, uppercase with whitespace, unsampled.
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "  00-" + "AB" * 16 + "-" + "CD" * 8 + "-01  ",
    "00-" + "12" * 16 + "-" + "34" * 8 + "-00",
]


def _ctx(c):
    return None if c is None else (c.trace_id, c.span_id, c.flags, c.traceparent())


@pytest.mark.parametrize("header", TRACEPARENTS, ids=lambda h: repr(h)[:40])
def test_parse_traceparent_matches_jax(header):
    got = _ctx(tracing.parse_traceparent(header))
    assert got == _ctx(jtracing.parse_traceparent(header))
    assert (got is not None) == (header in TRACEPARENTS[-3:])


def _spans(mod, tracer):
    """Three spans with fixed ids, times and attributes: a root, a child
    that errors and an unended-then-OK one."""
    out = []
    for i, (parent, kind, attrs, error) in enumerate([
        ("", mod.KIND_SERVER, {"http.route": "/v1/completions", "request.id": "r-1",
                               "http.status_code": 200, "request.duration_s": 0.25,
                               "ok": True}, None),
        ("1" * 16, mod.KIND_CLIENT, {"endpoint": "10.0.0.1:8000", "n": 3}, "HTTP 503"),
        ("2" * 16, mod.KIND_INTERNAL, {}, None),
    ]):
        span = mod.Span(tracer, f"span-{i}", mod.SpanContext("ab" * 16, f"{i + 1:016x}"),
                        parent, kind, attrs)
        span.start_ns = 1_700_000_000_000_000_000 + i
        span.end_ns = 0
        tracer_record = tracer._record
        tracer._record = lambda s: None  # keep end() from exporting
        try:
            span.end(error=error)
        finally:
            tracer._record = tracer_record
        span.end_ns = span.start_ns + 1000 * (i + 1)
        out.append(span)
    return out


def test_otlp_payload_matches_jax():
    t = tracing.Tracer(service_name="kubeai-tpu-engine.m")
    jt = jtracing.Tracer(service_name="kubeai-tpu-engine.m")
    got = t._payload(_spans(tracing, t))
    want = jt._payload(_spans(jtracing, jt))
    scope = got["resourceSpans"][0]["scopeSpans"][0]["scope"]
    assert scope == {"name": "kubeai_tpu_torch.metrics.tracing"}
    scope["name"] = want["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


class FakeCollector:
    """Minimal OTLP/HTTP collector: keeps the JSON of each POST
    /v1/traces (tests/unit/test_tracing.py's)."""

    def __init__(self):
        coll = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                with coll._lock:
                    coll.batches.append((self.path, payload))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.batches: list = []
        self._lock = threading.Lock()
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def spans(self) -> list[tuple[str, dict]]:
        with self._lock:
            return [(rs["resource"]["attributes"][0]["value"]["stringValue"], s)
                    for _, b in self.batches for rs in b["resourceSpans"]
                    for ss in rs["scopeSpans"] for s in ss["spans"]]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def collector():
    """A fake collector behind both packages' process tracers; the
    tracers are reset afterwards."""
    coll = FakeCollector()
    tracers = (tracing, jtracing)
    for mod in tracers:
        mod.configure(endpoint=coll.endpoint, service_name=f"svc-{mod.__name__}",
                      flush_interval_s=0.05)
    yield coll
    for mod in tracers:
        with mod._default_lock:
            if mod._default is not None:
                mod._default.shutdown()
            mod._default = None
    coll.stop()


def _attrs(span: dict) -> dict:
    return {a["key"]: a["value"] for a in span["attributes"]}


def test_engine_span_continues_the_client_trace(servers, collector):
    jsrv, tsrv = servers
    client_trace, client_span = "a1" * 16, "b2" * 8
    headers = {"traceparent": f"00-{client_trace}-{client_span}-01",
               "X-Request-Id": "req-42"}
    for srv in (jsrv, tsrv):
        assert http_post(_addr(srv), "/v1/completions", COMPLETION, timeout=120,
                         headers=headers)[0] == 200
        assert http_post(_addr(srv), "/v1/completions", {**COMPLETION, "n": 0},
                         headers=headers)[0] == 400
    # Each server ends its span in do_POST's `finally`, after the response
    # is written, so the handler thread may record it after the client has
    # its reply: flush until both services' spans have reached the
    # collector, or the deadline passes.
    deadline = time.monotonic() + 10.0
    while True:
        tracing.tracer().flush()
        jtracing.tracer().flush()
        by_service = {}
        for service, span in collector.spans():
            by_service.setdefault(service, []).append(span)
        port_spans = by_service.get("svc-kubeai_tpu_torch.metrics.tracing", [])
        jax_spans = by_service.get("svc-kubeai_tpu.metrics.tracing", [])
        if (len(port_spans) >= 2 and len(jax_spans) >= 2) or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert all(path == "/v1/traces" for path, _ in collector.batches)
    assert len(port_spans) == len(jax_spans) == 2
    for got, want in zip(port_spans, jax_spans):
        assert got["name"] == want["name"] == "engine /v1/completions"
        assert got["traceId"] == client_trace and got["parentSpanId"] == client_span
        assert got["kind"] == want["kind"] == tracing.KIND_SERVER
        assert got["status"] == want["status"]
        assert set(_attrs(got)) == set(_attrs(want))
        for key in ("http.route", "request.id", "http.status_code", "error.message"):
            assert _attrs(got).get(key) == _attrs(want).get(key), key
    ok, refused = port_spans
    assert _attrs(ok)["request.id"] == {"stringValue": "req-42"}
    assert _attrs(ok)["http.status_code"] == {"intValue": "200"}
    assert float(_attrs(ok)["request.duration_s"]["doubleValue"]) > 0
    assert refused["status"] == {"code": 2}
    assert _attrs(refused)["error.message"] == {"stringValue": "HTTP 400"}


def test_dropped_spans_on_metrics(servers):
    _, tsrv = servers
    t = tracing.configure(endpoint=None)
    try:
        t.dropped = 3
        _, body = http_get(_addr(tsrv), "/metrics")
        parsed = registry.parse_prometheus_text(body.decode())
        assert parsed[("kubeai_tracing_dropped_spans_total", ())] == 3
    finally:
        tracing._default = None


def test_parse_prometheus_text_matches_jax():
    text = (
        '# HELP a_total x\na_total{x="1",y="q\\"}"} 3 1700000000000\n'
        'b +Inf\nc 2e3\nbroken{x="1" 4\nd{le="0.5"} 7\n\n'
    )
    assert registry.parse_prometheus_text(text) == jregistry.parse_prometheus_text(text)


# ---- --pipeline ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,overlap", [
    ([], "auto"),
    (["--pipeline"], "on"),
    (["--pipeline", "--step-overlap", "off"], "off"),
    (["--step-overlap", "on"], "on"),
], ids=["default", "pipeline", "pipeline_off", "on"])
def test_pipeline_means_step_overlap_on(argv, overlap):
    cfg = engine_config(parse_args(["--model-url", "unused", *argv]))
    assert cfg.step_overlap == overlap
    # The JAX EngineConfig resolves the legacy knob the same way.
    j = JEngineConfig(pipeline="--pipeline" in argv,
                      step_overlap="off" if "off" in argv else
                      "on" if argv == ["--step-overlap", "on"] else "auto")
    want = "on" if (j.step_overlap == "auto" and j.pipeline) else j.step_overlap
    assert want == overlap
