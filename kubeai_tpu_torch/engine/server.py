"""The engine's HTTP serving front: what runs inside an engine Pod.
Counterpart of kubeai_tpu/engine/server.py.

Endpoints (the OpenAI-compatible surface and the admin seam the
operator and the fleet read):
  POST /v1/chat/completions   (stream=true: SSE chunks)
  POST /v1/completions
  GET  /v1/models
  GET  /health                readiness and liveness probes
  GET  /metrics               Prometheus text (engine counters)
  GET  /v1/state              admin snapshot (occupancy, KV facts,
                              spec/prefix stats, cold start, the
                              flight recorder's rings)
  POST /v1/drain              graceful drain (GET is the preStop alias)
  POST /v1/profile            an N-step per-phase timeline of the
                              engine loop, optionally with a
                              torch.profiler trace of the window
  POST /v1/kv/import          receive a KV handoff (chunked upload) for a
                              later X-Disagg-Handoff generate
  POST /v1/kv/export          serve a peer's prefix-page fetch (KVP1 blob)

One serve-loop thread steps the engine and fans StepEvents out to
per-request queues; HTTP handler threads tokenize, queue the request
(with the scheduling headers X-Priority / X-Deadline-Ms / X-Client-Id)
and detokenize incrementally, applying stop strings. After each step
the loop folds the engine's counters into the metrics registry. SIGTERM
(or /v1/drain) refuses new work with 503 and a computed Retry-After and
lets in-flight generations finish within the drain budget; a watchdog
flips /health and asks for a restart when a step never returns.

A generate body may carry `kubeai_resume: {token_ids, emitted}`: the
routing proxy's continuation of a stream whose replica died. The engine
recomputes the prefix and the response carries only the text past
`emitted` characters. Every POST opens a server span that continues the
caller's W3C `traceparent` and exports over OTLP/HTTP when an endpoint
is configured. The flight recorder keeps the engine's admissions, sheds,
preemptions, watchdog wedges and loop crashes in bounded rings.

Disaggregated serving (`role`): a prefill-role server answers every
generate with prefill, a KV handoff pushed to the decode server that
X-Disagg-Transfer names, and a JSON receipt; a decode-role (or unified)
server takes handoffs on /v1/kv/import and admits one straight into a
slot for a generate that carries X-Disagg-Handoff. KV sharing
(`kv_sharing`): the server publishes its prefix holdings on /v1/state,
serves them on /v1/kv/export, and before admission pulls the pages of a
prompt's prefix that the X-KV-Source peer (or the spill store) holds.
With `--kv-dtype int8` the pools hold int8 pages and their scales:
handoffs, exported pages and spills carry those bytes, and a blob of the
other dtype is refused (400), as the JAX server refuses it.

Not ported yet: adapters and embeddings, and the routes, series and
/v1/state keys that belong to them (ROADMAP A items 8 and 10), and the
object-store spill (item 9). Tenancy is the front door's; this server
reads only the scheduling headers.

Run: python -m kubeai_tpu_torch.engine.server --model-url <dir> [--port N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import queue
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.engine.coldstart import ColdStartTracker
from kubeai_tpu_torch.disagg.handoff import (
    HandoffError,
    deserialize,
    deserialize_pages,
    serialize_pages,
)
from kubeai_tpu_torch.disagg.transport import (
    HandoffStore,
    HTTPTransport,
    TransferError,
    read_chunked_body,
)
from kubeai_tpu_torch.engine.engine import (
    Engine,
    EngineBusy,
    EngineConfig,
    EngineDraining,
    StepEvent,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from kubeai_tpu_torch.engine.weights import (
    UNPORTED_ARCHITECTURES,
    WeightLoadError,
    load_hf_config,
    load_params,
    resolve_model_dir,
)
from kubeai_tpu_torch.fleet.profiler import phase_totals
from kubeai_tpu_torch.metrics import flightrecorder, tracing
from kubeai_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    TracingDroppedSpans,
)
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.objstore import KVSpillStore
from kubeai_tpu_torch.scheduling.scheduler import (
    PRIORITY_CLASSES,
    DeadlineInfeasible,
    RequestScheduler,
    SchedulingPolicy,
)
from kubeai_tpu_torch.utils import retryafter

logger = logging.getLogger(__name__)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024


# Request-phase latencies: cover sub-ms tiny-model CPU tests through the
# 600s request budget.
REQUEST_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)
# Inter-token gaps sit orders of magnitude below request latencies —
# fused decode chunks emit most tokens ~0 apart, chunk boundaries land in
# the ms range, and anything past 2.5s is a stall worth seeing.
ITL_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


class EngineMetrics:
    def __init__(self):
        self.registry = Registry()
        self.generated_tokens = Counter(
            "kubeai_engine_generated_tokens_total",
            "Tokens generated.",
            self.registry,
        )
        self.prompt_tokens = Counter(
            "kubeai_engine_prompt_tokens_total",
            "Prompt tokens processed.",
            self.registry,
        )
        self.active_requests = Gauge(
            "kubeai_engine_active_requests",
            "Requests currently queued or decoding.",
            self.registry,
        )
        self.requests_total = Counter(
            "kubeai_engine_requests_total", "Requests served.", self.registry
        )
        self.slots_active = Gauge(
            "kubeai_engine_slots_active",
            "Decode slots currently occupied.",
            self.registry,
        )
        self.requests_pending = Gauge(
            "kubeai_engine_requests_pending",
            "Requests queued for a free slot.",
            self.registry,
        )
        self.spec_proposed = Gauge(
            "kubeai_engine_spec_proposed_tokens_total",
            "Speculative tokens proposed (prompt-lookup or draft).",
            self.registry,
        )
        self.spec_accepted = Gauge(
            "kubeai_engine_spec_accepted_tokens_total",
            "Speculative tokens accepted by verify.",
            self.registry,
        )
        # Monotonically-growing totals exported with COUNTER semantics
        # (they were Gauges once — a `_total` metric that can be `set()`
        # backward breaks every rate() over it); sync_engine folds the
        # engine's cumulative stats in as deltas.
        self.prefix_hit_tokens = Counter(
            "kubeai_engine_prefix_cached_tokens_total",
            "Prompt tokens served from the prefix cache (skipped prefill).",
            self.registry,
        )
        self.prefix_prompt_tokens = Counter(
            "kubeai_engine_prefix_prompt_tokens_total",
            "Prompt tokens seen by prefix-cache admission.",
            self.registry,
        )
        # -- disaggregated serving: KV handoff transfer ---------------------
        self.kv_handoffs = Counter(
            "kubeai_engine_kv_handoffs_total",
            "KV handoffs by direction: exported after prefill (prefill "
            "role) / imported into decode slots (decode role).",
            self.registry,
        )
        self.kv_transfer_bytes = Counter(
            "kubeai_engine_kv_transfer_bytes_total",
            "Serialized KV handoff bytes moved, by direction "
            "(export = pushed to a decode pool, import = received on "
            "/v1/kv/import).",
            self.registry,
        )
        self.kv_transfer_seconds = Histogram(
            "kubeai_engine_kv_transfer_seconds",
            "Wall time of one KV handoff transfer (chunked HTTP push or "
            "receive), by direction.",
            self.registry,
            buckets=REQUEST_LATENCY_BUCKETS_S,
        )
        # -- cluster KV-sharing tier (peer prefix fetch / spill) -----------
        self.kv_fetch_attempts = Counter(
            "kubeai_kv_fetch_attempts_total",
            "Prefix KV fetches attempted, by source (peer = /v1/kv/export "
            "on the holding replica, spill = objstore fill).",
            self.registry,
        )
        self.kv_fetch_bytes = Counter(
            "kubeai_kv_fetch_bytes_total",
            "Serialized prefix-page bytes fetched from peers or the "
            "objstore spill tier instead of recomputing prefill.",
            self.registry,
        )
        self.kv_fetch_failures = Counter(
            "kubeai_kv_fetch_failures_total",
            "Prefix KV fetches that failed (timeout, peer death, "
            "malformed blob, pool refusal) and fell back to recompute, "
            "by source.",
            self.registry,
        )
        self.kv_share_pages = Counter(
            "kubeai_engine_kv_share_pages_total",
            "Cluster KV-sharing page movement by direction: exported "
            "(served to a peer), imported (seeded from a peer), spilled "
            "(evicted to objstore), filled (restored from objstore).",
            self.registry,
        )
        self.role_info = Gauge(
            "kubeai_engine_role",
            "1 for this replica's serving role label "
            "(prefill/decode/unified).",
            self.registry,
        )
        self.slot_capacity = Gauge(
            "kubeai_engine_slot_capacity",
            "Configured decode slots — with kubeai_engine_batch_size this "
            "gives the autoscaler slot occupancy.",
            self.registry,
        )
        # -- request-lifecycle latency histograms --------------------------
        self.queue_wait = Histogram(
            "kubeai_engine_queue_wait_seconds",
            "Time a request waited in the pending queue before its "
            "prefill was dispatched.",
            self.registry,
            buckets=REQUEST_LATENCY_BUCKETS_S,
        )
        self.prefill = Histogram(
            "kubeai_engine_prefill_seconds",
            "Prefill dispatch to first sampled token (compute only; "
            "queue wait excluded).",
            self.registry,
            buckets=REQUEST_LATENCY_BUCKETS_S,
        )
        self.ttft = Histogram(
            "kubeai_engine_ttft_seconds",
            "Engine time-to-first-token: request enqueue to first sampled "
            "token (queue wait + prefill).",
            self.registry,
            buckets=REQUEST_LATENCY_BUCKETS_S,
        )
        self.itl = Histogram(
            "kubeai_engine_inter_token_latency_seconds",
            "Gap between consecutive emitted tokens of one request. "
            "Tokens inside one fused decode chunk surface together, so "
            "the distribution is bimodal: ~0 intra-chunk, the device-step "
            "time at chunk boundaries.",
            self.registry,
            buckets=ITL_BUCKETS_S,
        )
        self.e2e = Histogram(
            "kubeai_engine_e2e_seconds",
            "Request enqueue to final token for completed (stop/length) "
            "requests; cancellations are excluded.",
            self.registry,
            buckets=REQUEST_LATENCY_BUCKETS_S,
        )
        self._timing_hist = {
            "queue_wait": self.queue_wait,
            "prefill": self.prefill,
            "ttft": self.ttft,
            "itl": self.itl,
            "e2e": self.e2e,
        }
        # -- per-decode-step engine-loop gauges ----------------------------
        self.batch_size = Gauge(
            "kubeai_engine_batch_size",
            "Running batch size (occupied decode slots) at the last "
            "engine step.",
            self.registry,
        )
        self.kv_utilization = Gauge(
            "kubeai_engine_kv_cache_utilization",
            "Fraction of KV-cache capacity in use (pages allocated / "
            "pool, or token positions / slot capacity).",
            self.registry,
        )
        self.kv_cache_bytes = Gauge(
            "kubeai_engine_kv_cache_bytes",
            "Resident bytes of the KV-cache pool (pages + quantization "
            "scales) — int8 pools report roughly half a bf16 pool of "
            "equal token capacity.",
            self.registry,
        )
        self.kv_quant_enabled = Gauge(
            "kubeai_engine_kv_quant_enabled",
            "1 when the paged KV cache stores int8 quantized pages "
            "(kv_dtype=int8), else 0.",
            self.registry,
        )
        self.kv_quant_capacity_factor = Gauge(
            "kubeai_engine_kv_quant_capacity_factor",
            "Slot-capacity multiplier of the configured KV dtype vs bf16 "
            "at equal HBM budget (2D/(D+4) under int8, 1.0 under bf16) — "
            "what the autoscaler and capacity planner scale the replica's "
            "effective KV capacity by.",
            self.registry,
        )
        self.tokens_per_step = Gauge(
            "kubeai_engine_tokens_per_step",
            "Tokens emitted by the last engine step (all requests).",
            self.registry,
        )
        self.step_duration = Gauge(
            "kubeai_engine_step_duration_seconds",
            "Wall duration of the last engine step's decode dispatch + "
            "fetch.",
            self.registry,
        )
        # -- engine step profiler (kubeai_tpu/fleet/profiler) ---------------
        self.step_phase = Histogram(
            "kubeai_engine_step_phase_seconds",
            "Wall time per engine-step phase (label `phase`: schedule / "
            "prefill / decode / dispatch / overlap_idle / readback / "
            "sample / kv_transfer) — the per-phase answer to 'why is ITL "
            "high'. decode is the async jit DISPATCH; the device wait "
            "surfaces as overlap_idle at reap (shrinking toward zero "
            "under the overlapped step pipeline) and the token transfer "
            "as readback.",
            self.registry,
            buckets=ITL_BUCKETS_S,
        )
        self.tracing_dropped = TracingDroppedSpans(
            "kubeai_tracing_dropped_spans_total",
            "Spans dropped by the OTLP exporter (queue full or exporter "
            "thread dead) instead of blocking the request path.",
            self.registry,
        )
        # -- scheduler queue-pressure signal (per priority class) ----------
        self.queue_depth = Gauge(
            "kubeai_engine_queue_depth",
            "Requests waiting in the scheduler, per priority class — the "
            "autoscaler's queue-pressure depth signal.",
            self.registry,
        )
        self.queue_oldest_wait = Gauge(
            "kubeai_engine_queue_oldest_wait_seconds",
            "Age of the oldest waiting request per priority class — the "
            "autoscaler's queue-pressure staleness signal.",
            self.registry,
        )
        self.queue_admitted = Gauge(
            "kubeai_engine_queue_admitted_total",
            "Requests dispatched out of the scheduler per priority class.",
            self.registry,
        )
        self.queue_shed = Gauge(
            "kubeai_engine_queue_shed_total",
            "Requests shed at enqueue (infeasible deadline) per priority "
            "class.",
            self.registry,
        )
        self.queue_mean_wait = Gauge(
            "kubeai_engine_queue_mean_wait_seconds",
            "Mean queue wait of dispatched requests per priority class.",
            self.registry,
        )
        self.sched_service_rate = Gauge(
            "kubeai_engine_sched_service_rate",
            "Scheduler drain-rate estimate (requests/second) used for "
            "deadline feasibility and the computed Retry-After.",
            self.registry,
        )
        # -- graceful drain ------------------------------------------------
        self.draining = Gauge(
            "kubeai_engine_draining",
            "1 while the server is draining (refusing new work, "
            "completing in-flight generations), else 0.",
            self.registry,
        )
        self.drain_terminated = Gauge(
            "kubeai_engine_drain_terminated_requests_total",
            "In-flight requests terminated because the drain budget "
            "expired before they completed.",
            self.registry,
        )
        # -- step watchdog ---------------------------------------------------
        self.watchdog_wedged = Gauge(
            "kubeai_engine_watchdog_wedged",
            "1 after the step watchdog detected a hung device step "
            "(health flipped, restart requested), else 0.",
            self.registry,
        )
        self.watchdog_stalls = Counter(
            "kubeai_engine_watchdog_stalls_total",
            "Hung-device-step detections by the engine watchdog.",
            self.registry,
        )
        # -- cold start: snapshot restore-first boot (engine/coldstart) -----
        self.coldstart_phase = Gauge(
            "kubeai_coldstart_phase_seconds",
            "Wall time of each boot phase (label `phase`: fetch/restore "
            "on the snapshot path, load on the full HF-conversion path, "
            "compile/warmup on both) — the per-phase answer to 'why was "
            "this replica slow to Ready'.",
            self.registry,
        )
        self.coldstart_total = Gauge(
            "kubeai_coldstart_total_seconds",
            "End-to-end boot wall time (model resolve through warm-up) — "
            "the measured cold-start cost the capacity planner prices "
            "into prewarm and preemption choices.",
            self.registry,
        )
        self.coldstart_restored = Gauge(
            "kubeai_coldstart_restored",
            "1 when this boot restored the engine snapshot (params + "
            "compilation cache), 0 on the full load path.",
            self.registry,
        )
        self.coldstart_events = Counter(
            "kubeai_coldstart_snapshot_events_total",
            "Snapshot lifecycle events at boot (label `event`: restored, "
            "published, absent, mismatch, error). `mismatch` means the "
            "stored fingerprint disagreed and the boot fell back to full "
            "load — a stale layout is never served.",
            self.registry,
        )

        # sync_engine runs on the serve loop and on /metrics scrapes:
        # one at a time, so a step record or a counter delta lands once.
        self._sync_lock = threading.Lock()
        # Step-profiler records already observed into step_phase (the
        # profiler keeps a bounded ring; new records are read from it).
        self._phase_step = 0

    def record_coldstart(self, cold_start: dict) -> None:
        """Fold a ColdStartTracker snapshot into the boot metrics."""
        for phase, secs in (cold_start.get("phases") or {}).items():
            self.coldstart_phase.set(secs, phase=phase)
        self.coldstart_total.set(float(cold_start.get("total_s", 0.0)))
        self.coldstart_restored.set(1 if cold_start.get("restored") else 0)
        for ev in cold_start.get("events") or ():
            self.coldstart_events.inc(event=ev)

    def observe_timing(
        self, kind: str, seconds: float, exemplar: str | None = None
    ) -> None:
        if kind == "kv_transfer":
            # A handoff's page gather or scatter: the JAX profiler's
            # standalone phase, outside the step timeline.
            self.step_phase.observe(seconds, phase=kind)
            return
        h = self._timing_hist.get(kind)
        if h is not None:
            h.observe(seconds, exemplar=exemplar)

    def sync_engine(self, engine) -> None:
        """Snapshot engine serving state (the engine owns these counters;
        it records plain host-side values and this method moves them into
        the registry). Called from the serve loop after each step AND at
        /metrics scrape time, so the histograms are current even when the
        loop has gone idle."""
        with self._sync_lock:
            snap = engine_state_snapshot(engine)
            self.slots_active.set(snap["slots_active"])
            self.requests_pending.set(snap["requests_pending"])
            stats = snap["spec_stats"]
            if stats:
                self.spec_proposed.set(stats["proposed"])
                self.spec_accepted.set(stats["accepted"])
            pstats = snap["prefix_stats"]
            if pstats:
                # Counter semantics over cumulative engine-side stats: fold in
                # the delta since the last sync (never set, never backward).
                self.prefix_hit_tokens.inc(
                    max(0.0, pstats["hit_tokens"] - self.prefix_hit_tokens.get())
                )
                self.prefix_prompt_tokens.inc(
                    max(
                        0.0,
                        pstats["prompt_tokens"]
                        - self.prefix_prompt_tokens.get(),
                    )
                )
            dstats = getattr(engine, "disagg_stats", None)
            if dstats:
                for direction, count_key, bytes_key in (
                    ("export", "exported", "exported_bytes"),
                    ("import", "imported", "imported_bytes"),
                ):
                    self.kv_handoffs.inc(
                        max(0.0, dstats[count_key]
                            - self.kv_handoffs.get(direction=direction)),
                        direction=direction,
                    )
                    self.kv_transfer_bytes.inc(
                        max(0.0, dstats[bytes_key]
                            - self.kv_transfer_bytes.get(direction=direction)),
                        direction=direction,
                    )
            kstats = getattr(engine, "kv_share_stats", None)
            if kstats:
                for direction, key in (
                    ("exported", "exported_pages"),
                    ("imported", "imported_pages"),
                    ("spilled", "spilled_pages"),
                    ("filled", "filled_pages"),
                ):
                    self.kv_share_pages.inc(
                        max(0.0, kstats[key]
                            - self.kv_share_pages.get(direction=direction)),
                        direction=direction,
                    )
            slots = getattr(getattr(engine, "cfg", None), "num_slots", None)
            if slots is not None:
                self.slot_capacity.set(slots)
            kv_info = snap.get("kv_cache") or {}
            if kv_info:
                self.kv_cache_bytes.set(kv_info.get("pool_bytes", 0))
                self.kv_quant_enabled.set(
                    1.0 if kv_info.get("quantized") else 0.0
                )
                self.kv_quant_capacity_factor.set(
                    kv_info.get("capacity_factor", 1.0)
                )
            drain = getattr(engine, "drain_timing", None)
            if drain is not None:
                for rec in drain():
                    self.observe_timing(
                        rec[0], rec[1],
                        exemplar=rec[2] if len(rec) > 2 else None,
                    )
            prof = getattr(engine, "profiler", None)
            if prof is not None:
                # The JAX profiler queues every phase for this sync; the
                # port's keeps only its ring, read past the last step seen.
                for rec in prof.recent():
                    if rec["step"] > self._phase_step:
                        for phase, seconds in rec["phases_s"].items():
                            self.step_phase.observe(seconds, phase=phase)
                        self._phase_step = rec["step"]
            step_stats = snap["last_step"]
            if step_stats:
                self.batch_size.set(step_stats.get("batch_size", 0))
                self.tokens_per_step.set(step_stats.get("tokens", 0))
                self.step_duration.set(step_stats.get("duration_s", 0.0))
            self.kv_utilization.set(snap["kv_utilization"])
            sched = snap.get("scheduler") or {}
            for cls, stats in (sched.get("classes") or {}).items():
                self.queue_depth.set(stats["depth"], **{"class": cls})
                self.queue_oldest_wait.set(
                    stats["oldest_wait_s"], **{"class": cls}
                )
                self.queue_admitted.set(
                    stats["admitted_total"], **{"class": cls}
                )
                self.queue_shed.set(stats["shed_total"], **{"class": cls})
                self.queue_mean_wait.set(
                    stats["mean_queue_wait_s"], **{"class": cls}
                )
            if sched:
                self.sched_service_rate.set(sched.get("service_rate", 0.0))


def engine_state_snapshot(engine) -> dict:
    """Serving-state snapshot shared by /metrics and /v1/state."""
    kvu = getattr(engine, "kv_utilization", None)
    sched = getattr(engine, "scheduler", None)
    kv_info = getattr(engine, "kv_cache_info", None)
    return {
        "slots_active": engine.num_active,
        "requests_pending": engine.num_pending,
        "kv_utilization": kvu() if kvu is not None else 0.0,
        # KV dtype / capacity block: what the autoscaler and capacity
        # planner size the replica's KV capacity by.
        "kv_cache": kv_info() if kv_info is not None else {},
        "last_step": dict(getattr(engine, "last_step_stats", {}) or {}),
        "spec_stats": dict(getattr(engine, "spec_stats", {}) or {}),
        "prefix_stats": dict(getattr(engine, "prefix_stats", {}) or {}),
        "kv_share": dict(getattr(engine, "kv_share_stats", {}) or {}),
        # Queue-pressure snapshot: per-class depth/oldest-wait/admitted/
        # shed plus drain rate and the current computed retry hint.
        "scheduler": sched.snapshot() if sched is not None else {},
    }


class EngineServer:
    def __init__(
        self,
        engine: Engine,
        tokenizer: Tokenizer,
        served_model_name: str,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 256,
        request_timeout: float = 600.0,
        default_priority: str = "standard",
        max_deadline_ms: int = 0,
        drain_timeout: float = 30.0,
        role: str = "unified",
        max_transfer_mb: int = 0,
        transfer_timeout: float = 30.0,
        watchdog_timeout: float = 0.0,
        watchdog_action=None,
        kv_sharing: bool = False,
        kv_fetch_timeout: float = 5.0,
        kv_spill_store=None,
        cold_start: dict | None = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.served_model_name = served_model_name
        self.metrics = EngineMetrics()
        # Always-on flight recorder: admissions, sheds, preemptions and
        # watchdog or loop anomalies land in bounded rings surfaced on
        # /v1/state.
        self.recorder = flightrecorder.FlightRecorder(ring_size=128)
        engine.on_preempt = self._note_preempt
        # Boot cold-start record (ColdStartTracker.snapshot()): surfaced
        # on /v1/state so the fleet aggregator carries each replica's
        # measured cold-start cost to the planner, and folded into the
        # kubeai_coldstart_* metrics.
        self.cold_start = dict(cold_start or {})
        if self.cold_start:
            self.metrics.record_coldstart(self.cold_start)
        # Disaggregated serving role: "prefill" turns every generate into
        # prefill -> handoff (pushed to the decode address the router
        # names); "decode" and "unified" accept handoffs on /v1/kv/import
        # and admit them via X-Disagg-Handoff. "unified" also serves
        # normally: the router's fallback pool.
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        self.role = role
        self.max_transfer_bytes = max(0, int(max_transfer_mb)) * 1024 * 1024
        self.transfer_timeout = transfer_timeout
        self._handoffs = HandoffStore()
        # Cluster KV-sharing tier: publish prefix holdings in /v1/state,
        # serve peers' partial-chain fetches on /v1/kv/export, and pull
        # missing prefix pages from the X-KV-Source peer (or the spill
        # store) before admission instead of recomputing prefill.
        self.kv_sharing = bool(kv_sharing)
        self.kv_fetch_timeout = kv_fetch_timeout
        self.kv_spill = kv_spill_store
        if self.kv_spill is not None:
            spill_wire = getattr(engine, "enable_kv_spill", None)
            if spill_wire is not None:
                spill_wire(self.kv_spill)
        self.metrics.role_info.set(1, role=role)
        # Scheduling defaults (CRD `scheduling:` block, rendered as engine
        # flags): applied when the request carries no X-Priority /
        # X-Deadline-Ms headers; max_deadline_ms caps client deadlines.
        self.default_priority = default_priority
        self.max_deadline_ms = max_deadline_ms
        self.max_queue = max_queue
        self.request_timeout = request_timeout
        self._subscribers: dict[int, queue.Queue] = {}
        self._sub_lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        # Graceful drain (SIGTERM / POST /v1/drain): refuse new work with
        # 503 + Retry-After, finish in-flight generations up to
        # drain_timeout, then terminate the stragglers cleanly.
        self.drain_timeout = drain_timeout
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._drain_started = 0.0
        self._drain_thread: threading.Thread | None = None
        # Step watchdog: a hung device step (work active, no step
        # progress past watchdog_timeout) flips /health and fires
        # watchdog_action (in production: exit nonzero so kubelet
        # restarts the pod). 0 disables.
        self.watchdog_timeout = watchdog_timeout
        self._watchdog_action = watchdog_action
        self._wedged = False
        self._watchdog_thread: threading.Thread | None = None
        self._loop_thread = threading.Thread(target=self._serve_loop, daemon=True)

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            _last_status = 200  # recorded for the request span

            def log_message(self, *a):
                pass

            def _json(self, status: int, payload: dict, headers: dict | None = None):
                self._last_status = status
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/health":
                    if outer.draining:
                        # The LB's health view must eject this replica
                        # while the drain runs.
                        return self._json(
                            503, {"status": "draining", "draining": True}
                        )
                    if outer.healthy():
                        return self._json(200, {"status": "ok"})
                    if outer._wedged:
                        return self._json(
                            503, {"status": "wedged", "wedged": True}
                        )
                    return self._json(503, {"status": "unhealthy"})
                if path == "/v1/drain":
                    # kubelet preStop httpGet can only send GET: the
                    # drain trigger accepts it alongside the POST form.
                    return self._json(202, outer.begin_drain())
                if path == "/metrics":
                    outer.metrics.sync_engine(outer.engine)
                    body = outer.metrics.registry.expose().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/v1/models":
                    data = [{
                        "id": outer.served_model_name,
                        "object": "model",
                        "owned_by": "kubeai-tpu",
                    }]
                    return self._json(200, {"object": "list", "data": data})
                if path == "/v1/state":
                    return self._json(200, outer.state())
                return self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/v1/kv/import":
                    # Binary (possibly chunked) upload: reads its own
                    # body; the JSON decode below must not touch it.
                    return outer._handle_kv_import(self)
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError as e:
                    return self._json(400, {"error": {"message": f"bad JSON: {e}"}})
                # Continue the trace the proxy started (W3C traceparent),
                # with the propagated X-Request-Id on the span: one id
                # follows the request front door -> proxy -> engine.
                attrs = {"http.route": path}
                req_id = self.headers.get("X-Request-Id")
                if req_id:
                    attrs["request.id"] = req_id
                span = tracing.tracer().start_span(
                    f"engine {path}",
                    parent=tracing.parse_traceparent(self.headers.get("traceparent")),
                    kind=tracing.KIND_SERVER,
                    attributes=attrs,
                )
                self.current_span = span
                self._last_status = 200
                try:
                    if path == "/v1/drain":
                        return self._json(202, outer.begin_drain())
                    if path == "/v1/profile":
                        return outer._handle_profile(self, body)
                    if path == "/v1/kv/export":
                        return outer._handle_kv_export(self, body)
                    if path == "/v1/chat/completions":
                        return outer._handle_generate(self, body, chat=True)
                    if path == "/v1/completions":
                        return outer._handle_generate(self, body, chat=False)
                    return self._json(404, {"error": {"message": "not found"}})
                except BrokenPipeError as e:
                    span.set_attribute("http.status_code", self._last_status)
                    span.end(error=str(e) or "client disconnected")
                    raise
                except Exception as e:
                    logger.exception("handler error")
                    return self._json(500, {"error": {"message": str(e)}})
                finally:
                    # Handlers answer errors with 4xx/5xx JSON, not
                    # exceptions: the span must say so.
                    if not span.end_ns:
                        span.set_attribute("http.status_code", self._last_status)
                        span.end(
                            error=f"HTTP {self._last_status}"
                            if self._last_status >= 400 else None
                        )

        self.httpd = _HTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # -- lifecycle ------------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._loop_thread.start()
        self._http_thread.start()
        if self.watchdog_timeout > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True
            )
            self._watchdog_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._loop_thread.is_alive():
            self._loop_thread.join(timeout=30)
        # shutdown() handshakes with serve_forever; on a never-started
        # server it would wait forever.
        if self._http_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()

    def state(self) -> dict:
        """The /v1/state payload: serving state, KV facts, the prefix
        holdings and the boot's cold-start record."""
        return {
            "model": self.served_model_name,
            "healthy": self.healthy(),
            "draining": self.draining,
            "role": self.role,
            "pending_handoffs": len(self._handoffs),
            "kv_sharing": self.kv_sharing,
            # Held page-hash chains (hex), computed only here (not per
            # step): the fleet aggregator joins them into its
            # who-holds-which-prefix map.
            "kv_holdings": self.kv_holdings(),
            # Boot cold-start record: per-phase timings; the aggregator
            # copies it to the planner as the model's cold-start cost.
            "cold_start": self.cold_start,
            # Last request per bucket: the "rid-<n>" tags that let an
            # operator jump from a latency bucket to a request.
            "exemplars": {
                "ttft": self.metrics.ttft.exemplars(),
                "itl": self.metrics.itl.exemplars(),
            },
            # The engine's discrete decisions (admits, sheds, preemptions,
            # watchdog) in decision order.
            "flight_recorder": self.recorder.state_payload(),
            **engine_state_snapshot(self.engine),
        }

    def kv_holdings(self) -> list[str]:
        """Held page-hash chains (hex) for /v1/state; empty when sharing is
        off (no point shipping the table to the aggregator then)."""
        if not self.kv_sharing:
            return []
        holdings = getattr(self.engine, "prefix_holdings", None)
        return holdings() if holdings is not None else []

    # -- engine loop ----------------------------------------------------------

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self.engine.has_work():
                    self._work.wait(timeout=0.01)
                    self._work.clear()
                    continue
                for ev in self.engine.step():
                    with self._sub_lock:
                        q = self._subscribers.get(ev.rid)
                    if q is not None:
                        q.put(ev)
                # Per-step telemetry: drain the engine's latency records
                # into histograms and refresh the occupancy and KV gauges
                # while they are live.
                self.metrics.sync_engine(self.engine)
                self._last_progress = time.monotonic()
            except Exception:
                # A dead serving loop flips /health so the liveness probe
                # restarts the Pod; waiting requests run into their
                # timeout.
                logger.exception("serving loop crashed")
                self.recorder.record(
                    flightrecorder.STEP_ANOMALY, "engine",
                    target=self.served_model_name, reason="loop_crash",
                )
                self._loop_dead = True
                return

    _loop_dead = False
    _last_progress = 0.0

    def healthy(self) -> bool:
        return (
            not self._loop_dead
            and not self._wedged
            and not self._stop.is_set()
        )

    def _note_preempt(self, rid: int, client: str) -> None:
        self.recorder.record(
            flightrecorder.SCHED_PREEMPT, "engine_sched",
            target=self.served_model_name, trace_id=f"rid-{rid}",
            client=client or "",
        )

    # -- step watchdog ----------------------------------------------------------

    @property
    def wedged(self) -> bool:
        return self._wedged

    def _watchdog_loop(self) -> None:
        """Detect a hung device step: work is active but the serve loop
        made no step progress for watchdog_timeout. A crashed loop
        already flips /health (_loop_dead); this catches the worse case
        where step() never returns (a hung kernel or device), which no
        exception handler can see. On detection /health flips and
        watchdog_action runs (production: exit nonzero, kubelet restarts
        the pod)."""
        poll = max(0.01, min(self.watchdog_timeout / 4.0, 1.0))
        busy_since: float | None = None
        while not self._stop.wait(timeout=poll):
            try:
                busy = self.engine.has_work()
            except Exception:
                busy = False
            now = time.monotonic()
            if not busy:
                busy_since = None
                continue
            if busy_since is None:
                # Work just (re)appeared: stall time counts from here,
                # not from a _last_progress stamped before an idle gap.
                busy_since = now
            anchor = max(self._last_progress, busy_since)
            # Overlapped stepping: a dispatched-but-unreaped chunk is
            # progress (the device is computing and the host reaps it on
            # the next step), but only within the same watchdog budget:
            # an in-flight chunk older than that means the reap itself
            # is wedged and must still trip the restart.
            info_fn = getattr(self.engine, "inflight_info", None)
            if info_fn is not None:
                try:
                    info = info_fn()
                except Exception:
                    info = None
                if info:
                    dispatched_at = float(info.get("dispatched_at", 0.0))
                    if now - dispatched_at <= self.watchdog_timeout:
                        anchor = max(anchor, dispatched_at)
            stalled_for = now - anchor
            if stalled_for <= self.watchdog_timeout:
                continue
            self._wedged = True
            self.metrics.watchdog_wedged.set(1)
            self.metrics.watchdog_stalls.inc()
            self.recorder.record(
                flightrecorder.WATCHDOG, "engine",
                target=self.served_model_name,
                stalled_for_s=round(stalled_for, 3),
                active=self.engine.num_active,
                pending=self.engine.num_pending,
            )
            self.recorder.trigger(
                flightrecorder.TRIGGER_WATCHDOG,
                detail=f"no step progress for {stalled_for:.1f}s with work active",
            )
            logger.error(
                "watchdog: no engine step progress for %.1fs with work "
                "active (%d active, %d pending) — flipping /health and "
                "requesting restart",
                stalled_for, self.engine.num_active, self.engine.num_pending,
            )
            if self._watchdog_action is not None:
                try:
                    self._watchdog_action()
                except Exception:
                    logger.exception("watchdog action failed")
            return

    # -- graceful drain ---------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> dict:
        """Start the drain sequence (idempotent): stop admitting, let
        in-flight generations finish, terminate stragglers when the
        budget runs out. Returns the status payload /v1/drain answers."""
        if not self._draining.is_set():
            self._drain_started = time.monotonic()
            self._draining.set()
            self.metrics.draining.set(1)
            # Close the admission race at the engine too: a request that
            # slipped past the handler's check still gets refused.
            begin = getattr(self.engine, "begin_drain", None)
            if begin is not None:
                begin()
            self._work.set()
            self._drain_thread = threading.Thread(
                target=self._drain_worker, daemon=True
            )
            self._drain_thread.start()
            logger.info(
                "drain started: %d active, %d pending, budget %.1fs",
                self.engine.num_active, self.engine.num_pending,
                self.drain_timeout,
            )
        return {
            "draining": True,
            "active": self.engine.num_active,
            "pending": self.engine.num_pending,
            "drain_timeout_s": self.drain_timeout,
            "elapsed_s": round(time.monotonic() - self._drain_started, 3),
        }

    def _drain_worker(self) -> None:
        deadline = self._drain_started + self.drain_timeout
        while time.monotonic() < deadline:
            with self._sub_lock:
                streams = len(self._subscribers)
            if (
                streams == 0
                and self.engine.num_active == 0
                and self.engine.num_pending == 0
            ):
                self._drained.set()
                logger.info(
                    "drain complete: all in-flight work finished in %.2fs",
                    time.monotonic() - self._drain_started,
                )
                return
            time.sleep(0.02)
        # Budget exhausted: terminate the remaining streams cleanly. A
        # kill sentinel per subscriber makes its collector emit a final
        # chunk and release the slot, instead of the process exit
        # snapping TCP connections mid-token.
        with self._sub_lock:
            leftovers = list(self._subscribers.items())
        for rid, sub in leftovers:
            self.engine.cancel(rid)
            sub.put(StepEvent(
                rid=rid, token=-1, finished=True, finish_reason="cancelled",
            ))
        if leftovers:
            self.metrics.drain_terminated.set(len(leftovers))
            logger.warning(
                "drain budget (%.1fs) expired: terminated %d in-flight "
                "request(s)", self.drain_timeout, len(leftovers),
            )
        # Give the collectors a moment to flush their final chunks.
        flush_deadline = time.monotonic() + 2.0
        while time.monotonic() < flush_deadline:
            with self._sub_lock:
                if not self._subscribers:
                    break
            time.sleep(0.02)
        self._drained.set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until the drain sequence finished (True) or `timeout`
        elapsed (False). The process entry point exits on True."""
        return self._drained.wait(
            timeout=self.drain_timeout + 5.0 if timeout is None else timeout
        )

    def _drain_refusal(self, http):
        """503 for work arriving during drain: a computed Retry-After (the
        remaining drain budget, jittered) and Connection: close so the
        client's keep-alive doesn't pin a dying server."""
        remaining = retryafter.jittered(
            self._drain_started + self.drain_timeout - time.monotonic(),
            min_s=1.0,
        )
        http.close_connection = True
        return http._json(
            503,
            {
                "error": {"message": "server is draining, retry elsewhere"},
                "draining": True,
            },
            headers={
                "Retry-After": retryafter.format_header(remaining),
                "Connection": "close",
            },
        )

    # -- step profiling (kubeai_tpu_torch/fleet/profiler) ----------------------

    def _handle_profile(self, http, body: dict):
        """POST /v1/profile: capture an N-step per-phase timeline.

        Body (all optional): `steps` (how many step records to return,
        default 16), `fresh` (true = wait for that many NEW steps up to
        `timeout_s` before answering; false = answer from the ring at
        once), `jax_trace` (also record the capture window with
        torch.profiler, CPU and, on the card, CUDA activities, and write
        a Chrome trace into a new `kubeai-profile-*` directory). The
        response names that directory under `jax_trace_dir`, the JAX
        server's key, so that a client reads one schema from either
        engine; it is null when the profiler could not start or stop."""
        prof = getattr(self.engine, "profiler", None)
        if prof is None:
            return http._json(
                400, {"error": {"message": "engine exposes no step profiler"}}
            )
        steps = body.get("steps", 16)
        if (
            isinstance(steps, bool)
            or not isinstance(steps, int)
            or not 1 <= steps <= 10_000
        ):
            return http._json(
                400, {"error": {"message": "steps must be an int in 1..10000"}}
            )
        timeout_s = body.get("timeout_s", 10.0)
        if (
            isinstance(timeout_s, bool)
            or not isinstance(timeout_s, (int, float))
            or not 0 < timeout_s <= 120
        ):
            return http._json(
                400, {"error": {"message": "timeout_s must be in (0, 120]"}}
            )
        fresh = bool(body.get("fresh", False))
        trace = self._start_trace() if body.get("jax_trace") else None
        captured = 0
        try:
            if fresh:
                captured = prof.wait_for_steps(steps, float(timeout_s))
        finally:
            trace_dir = self._stop_trace(trace) if trace is not None else None
        records = prof.recent(steps)
        return http._json(
            200,
            {
                "object": "engine.profile",
                "model": self.served_model_name,
                "steps_requested": steps,
                "steps_captured": captured if fresh else len(records),
                "steps_completed_total": prof.steps_completed,
                "phase_totals_s": phase_totals(records),
                "steps": records,
                "jax_trace_dir": trace_dir,
            },
        )

    def _start_trace(self):
        """(profiler, trace directory) with torch.profiler recording, or
        None when it cannot start: profiling must not 500."""
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if getattr(self.engine, "device", torch.device("cpu")).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            # The serve loop's thread launches the work, not this one:
            # record the CPU ops of every thread where torch can.
            from torch._C._profiler import _ExperimentalConfig

            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
        try:
            prof = profile(activities=activities, experimental_config=config)
            prof.__enter__()
        except Exception:  # noqa: BLE001 — profiling must not 500
            logger.exception("/v1/profile: torch.profiler did not start")
            return None
        return prof, tempfile.mkdtemp(prefix="kubeai-profile-")

    @staticmethod
    def _stop_trace(trace) -> str | None:
        """Stop the profiler and write its Chrome trace; the directory, or
        None when either step failed."""
        prof, trace_dir = trace
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        except Exception:  # noqa: BLE001
            logger.exception("/v1/profile: torch.profiler did not stop")
            return None
        return trace_dir

    # -- request handling -----------------------------------------------------

    def _validate_resume(self, raw_resume, n: int) -> str | None:
        """Shape-check a `kubeai_resume` continuation block; returns a
        client-readable error, or None when it is valid."""
        if not isinstance(raw_resume, dict):
            return "kubeai_resume must be an object"
        if n != 1:
            return "kubeai_resume requires n == 1"
        toks = raw_resume.get("token_ids")
        if not isinstance(toks, list) or not toks or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in toks
        ):
            return "kubeai_resume.token_ids must be a non-empty int list"
        emitted = raw_resume.get("emitted")
        if emitted is not None and (
            isinstance(emitted, bool) or not isinstance(emitted, int) or emitted < 0
        ):
            return "kubeai_resume.emitted must be an int >= 0"
        return None

    def _parse_scheduling(self, headers):
        """Resolve (priority, deadline_ms, client) from request headers and
        the server's scheduling defaults. Raises ValueError on malformed
        values (the caller answers 400)."""
        raw_prio = (headers.get("X-Priority") or "").strip().lower()
        if raw_prio and raw_prio not in PRIORITY_CLASSES:
            raise ValueError(
                f"X-Priority must be one of {'/'.join(PRIORITY_CLASSES)}, "
                f"got {raw_prio!r}"
            )
        priority = raw_prio or self.default_priority
        deadline_ms = None
        raw_ddl = (headers.get("X-Deadline-Ms") or "").strip()
        if raw_ddl:
            try:
                deadline_ms = float(raw_ddl)
            except ValueError:
                raise ValueError(
                    f"X-Deadline-Ms must be a number of milliseconds, "
                    f"got {raw_ddl!r}"
                )
            if deadline_ms <= 0:
                raise ValueError("X-Deadline-Ms must be > 0")
        if deadline_ms is None and self.max_deadline_ms > 0:
            # The CRD cap doubles as the default deadline: every request
            # gets feasibility-checked against the operator's bound.
            deadline_ms = float(self.max_deadline_ms)
        elif deadline_ms is not None and self.max_deadline_ms > 0:
            deadline_ms = min(deadline_ms, float(self.max_deadline_ms))
        client = (headers.get("X-Client-Id") or "").strip()
        return priority, deadline_ms, client

    def _scheduler(self):
        return getattr(self.engine, "scheduler", None)

    def _shed_response(self, http, message: str, retry_after: float | None = None):
        """429 with a computed Retry-After (queue depth over drain rate,
        from the scheduler; jittered once, so header and body carry the
        same value) and per-class queue depths in the body."""
        sched = self._scheduler()
        if retry_after is None:
            retry_after = sched.retry_after() if sched is not None else 1.0
        retry_after = retryafter.jittered(retry_after)
        depths = sched.class_depths() if sched is not None else {}
        return http._json(
            429,
            {
                "error": {"message": message},
                "queue": {
                    "depths": depths,
                    "retry_after_s": round(retry_after, 3),
                },
            },
            headers={"Retry-After": retryafter.format_header(retry_after)},
        )

    def _cancel_all(self, reqs) -> None:
        for rid_i, _, _ in reqs:
            self.engine.cancel(rid_i)
            with self._sub_lock:
                self._subscribers.pop(rid_i, None)

    def _handle_generate(self, http, body: dict, chat: bool):
        if self._draining.is_set():
            return self._drain_refusal(http)
        if self.role == "prefill":
            # A prefill-role engine never enters decode: every generate
            # becomes prefill -> KV handoff pushed to the decode address
            # the router named.
            return self._handle_prefill_generate(http, body, chat)
        hid = (http.headers.get("X-Disagg-Handoff") or "").strip()
        if hid:
            return self._handle_decode_from_handoff(http, body, chat, hid)
        model_field = str(body.get("model") or self.served_model_name)
        if model_field != self.served_model_name:
            return http._json(
                404, {"error": {"message": f"model {model_field!r} not found"}}
            )
        display = self.served_model_name
        raw_n = body.get("n")
        if raw_n is None:
            n = 1
        elif isinstance(raw_n, bool) or not isinstance(raw_n, int):
            n = 0  # falls through to the 400 below
        else:
            n = raw_n
        if not 1 <= n <= 8:
            return http._json(
                400, {"error": {"message": "n must be an integer in 1..8"}}
            )
        # Continuation (the proxy resuming a stream after a replica
        # death): the tokens another replica already emitted, and how many
        # characters of their text reached the client.
        resume_tokens: list[int] = []
        resume_emitted: int | None = None
        raw_resume = body.get("kubeai_resume")
        if raw_resume is not None:
            err = self._validate_resume(raw_resume, n)
            if err is not None:
                return http._json(400, {"error": {"message": err}})
            resume_tokens = [int(t) for t in raw_resume["token_ids"]]
            if "emitted" in raw_resume:
                resume_emitted = int(raw_resume["emitted"])
        try:
            priority, deadline_ms, sched_client = self._parse_scheduling(
                http.headers
            )
        except ValueError as e:
            return http._json(400, {"error": {"message": str(e)}})
        if self.engine.num_pending + n > self.max_queue:
            return self._shed_response(http, "engine queue full, retry later")

        prompt_ids = self._prompt_ids(body, chat)
        room = self.engine.cfg.max_seq_len - len(prompt_ids) - 1
        if room <= 0:
            return http._json(
                400,
                {"error": {"message": (
                    f"prompt too long: {len(prompt_ids)} tokens "
                    f">= context {self.engine.cfg.max_seq_len}"
                )}},
            )
        if resume_tokens and len(resume_tokens) >= room:
            return http._json(
                400,
                {"error": {"message": (
                    f"resume prefix of {len(resume_tokens)} tokens leaves "
                    f"no room under context {self.engine.cfg.max_seq_len}"
                )}},
            )
        try:
            sp = self._parse_sampling(body, room)
        except ValueError as e:
            return http._json(400, {"error": {"message": str(e)}})
        if resume_tokens and len(resume_tokens) >= sp.max_tokens:
            return http._json(
                400,
                {"error": {"message": (
                    f"resume prefix of {len(resume_tokens)} tokens >= "
                    f"max_tokens {sp.max_tokens}: nothing left to generate"
                )}},
            )
        if self.kv_sharing and not resume_tokens:
            # Peer or spill KV prefix fetch BEFORE admission: on success the
            # pages sit unowned in the idle pool and the ordinary prefix-hit
            # admission below adopts them; on any failure this returns
            # silently and prefill recomputes.
            self._maybe_fetch_prefix(http.headers, prompt_ids, deadline_ms)
        stream = bool(body.get("stream", False))
        # Each choice gets a derived seed so explicit-seed requests stay
        # deterministic and diverse.
        reqs: list[tuple[int, queue.Queue, SamplingParams]] = []
        try:
            for i in range(n):
                sub_i: queue.Queue = queue.Queue()
                sp_i = (
                    sp if i == 0 or sp.seed is None
                    else dataclasses.replace(sp, seed=sp.seed + i)
                )

                def register(rid: int, _sub=sub_i) -> None:
                    # Runs under the engine lock, before the request is
                    # visible to step(): no event can be emitted
                    # unsubscribed.
                    with self._sub_lock:
                        self._subscribers[rid] = _sub

                # Only when resuming, so that engine stand-ins without
                # continuation support keep working.
                resume_kw = (
                    {"resume_tokens": resume_tokens}
                    if resume_tokens and i == 0 else {}
                )
                rid_i = self.engine.add_request(
                    prompt_ids, sp_i, on_admit=register, priority=priority,
                    client=sched_client, deadline_ms=deadline_ms, **resume_kw,
                )
                reqs.append((rid_i, sub_i, sp_i))
        except DeadlineInfeasible as e:
            self._cancel_all(reqs)
            self.recorder.record(
                flightrecorder.SCHED_SHED, "engine_sched",
                target=self.served_model_name, priority=priority,
                deadline_ms=deadline_ms, reason=str(e),
            )
            return self._shed_response(http, str(e), retry_after=e.retry_after)
        except EngineDraining:
            # Drain began between the handler's check and admission.
            self._cancel_all(reqs)
            return self._drain_refusal(http)
        except ValueError as e:
            # Residual continuation validation (a resume prefix that
            # already ends at a stop token).
            self._cancel_all(reqs)
            return http._json(400, {"error": {"message": str(e)}})
        # Metrics only after successful admission, so a failed add_request
        # can't drift the gauge or inflate the counters.
        self.metrics.requests_total.inc(model=display)
        self.metrics.active_requests.inc()
        self.metrics.prompt_tokens.inc(len(prompt_ids) * n)
        self.recorder.record(
            flightrecorder.SCHED_ADMIT, "engine_sched", target=display,
            trace_id=f"rid-{reqs[0][0]}", priority=priority, choices=n,
        )
        self._work.set()
        t0 = time.monotonic()
        span = getattr(http, "current_span", None)
        resume = dict(resume_tokens=resume_tokens, resume_emitted=resume_emitted)
        try:
            if stream:
                self._stream_response(http, reqs, display, chat, t0=t0,
                                      span=span, **resume)
            else:
                self._unary_response(http, reqs, display, chat,
                                     len(prompt_ids), **resume)
        finally:
            # The duration the TTFT and e2e histograms see is readable
            # off the trace too.
            if span is not None and not span.end_ns:
                span.set_attribute("request.duration_s", time.monotonic() - t0)
            # Client gone or handler done: release the slots of any
            # request still decoding (no-op after normal completion).
            self._cancel_all(reqs)
            self.metrics.active_requests.dec()

    # -- disaggregated serving ------------------------------------------------

    def _prompt_ids(self, body: dict, chat: bool) -> list[int]:
        if chat:
            prompt_ids = self.tokenizer.apply_chat_template(body.get("messages") or [])
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            prompt_ids = self.tokenizer.encode(str(prompt))
        return prompt_ids or [0]

    def _handle_prefill_generate(self, http, body: dict, chat: bool):
        """Prefill role: tokenize, prefill, export the paged-KV handoff,
        push it to the decode engine the router named (X-Disagg-Transfer)
        and answer a small JSON receipt that the router turns into the
        decode hop."""
        target = (http.headers.get("X-Disagg-Transfer") or "").strip()
        if not target:
            return http._json(400, {"error": {"message": (
                "prefill-role engine requires X-Disagg-Transfer: "
                "<decode host:port> (the router supplies it)"
            )}})
        model_field = str(body.get("model") or self.served_model_name)
        if model_field != self.served_model_name:
            return http._json(
                404, {"error": {"message": f"model {model_field!r} not found"}}
            )
        display = self.served_model_name
        if body.get("n") not in (None, 1):
            # n > 1 decodes n streams from ONE prefill; the two-hop path
            # hands off a single sampler state.
            return http._json(400, {"error": {"message":
                                              "n > 1 is not supported on the disaggregated "
                                              "path; use a unified endpoint"}})
        prompt_ids = self._prompt_ids(body, chat)
        room = self.engine.cfg.max_seq_len - len(prompt_ids) - 1
        if room <= 0:
            return http._json(400, {"error": {"message": (
                f"prompt too long: {len(prompt_ids)} tokens >= "
                f"context {self.engine.cfg.max_seq_len}"
            )}})
        try:
            sp = self._parse_sampling(body, room)
            priority, _deadline, client = self._parse_scheduling(http.headers)
        except ValueError as e:
            return http._json(400, {"error": {"message": str(e)}})
        try:
            handoff = self.engine.export_handoff(
                prompt_ids, sp, client=client, priority=priority, model_name=display,
            )
        except EngineBusy as e:
            return self._shed_response(http, str(e))
        except EngineDraining:
            return self._drain_refusal(http)
        self.metrics.requests_total.inc(model=display)
        self.metrics.prompt_tokens.inc(len(prompt_ids))
        if self.max_transfer_bytes and handoff.nbytes() > self.max_transfer_bytes:
            return http._json(413, {"error": {"message": (
                f"handoff of {handoff.nbytes()} bytes exceeds the "
                f"{self.max_transfer_bytes}-byte transfer limit"
            )}})
        hid = (http.headers.get("X-Handoff-Id") or "").strip() or None
        try:
            result = HTTPTransport(target, timeout=self.transfer_timeout).send(
                handoff, handoff_id=hid)
        except TransferError as e:
            logger.warning("handoff push to %s failed: %s", target, e)
            return http._json(502, {"error": {"message": str(e)}})
        self.metrics.kv_transfer_seconds.observe(result.seconds, direction="export")
        return http._json(200, {
            "object": "kv.handoff",
            "handoff_id": result.handoff_id,
            "decode_addr": target,
            "model": display,
            "prompt_tokens": len(prompt_ids),
            "first_token": handoff.first_token,
            "transfer": {"bytes": result.bytes, "seconds": round(result.seconds, 6)},
        })

    def _handle_kv_import(self, http):
        """POST /v1/kv/import: receive a serialized handoff (chunked
        upload) into the bounded handoff store; the follow-up generate
        references it with X-Disagg-Handoff."""
        if self.role == "prefill":
            return http._json(400, {"error": {"message":
                                              "prefill-role engines do not accept handoffs"}})
        if self._draining.is_set():
            return self._drain_refusal(http)
        t0 = time.monotonic()
        try:
            te = (http.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                blob = read_chunked_body(http.rfile, max_bytes=self.max_transfer_bytes)
            else:
                n = int(http.headers.get("Content-Length", 0) or 0)
                if self.max_transfer_bytes and n > self.max_transfer_bytes:
                    raise TransferError(
                        f"upload of {n} bytes exceeds the "
                        f"{self.max_transfer_bytes}-byte transfer limit"
                    )
                blob = http.rfile.read(n) if n else b""
        except TransferError as e:
            http.close_connection = True  # unread body bytes may remain
            return http._json(413, {"error": {"message": str(e)}})
        try:
            handoff = deserialize(blob)
        except HandoffError as e:
            return http._json(400, {"error": {"message": str(e)}})
        hid = self._handoffs.put(
            handoff, (http.headers.get("X-Handoff-Id") or "").strip() or None
        )
        # Bytes are counted at engine import time (disagg_stats through
        # sync_engine), so in-process and HTTP transfers land in the same
        # counter; only the receive latency is observed here.
        self.metrics.kv_transfer_seconds.observe(time.monotonic() - t0, direction="import")
        return http._json(200, {"handoff_id": hid, "bytes": len(blob)})

    def _handle_decode_from_handoff(self, http, body: dict, chat: bool, hid: str):
        """Decode role: admit a previously imported handoff straight into a
        slot (no prefill runs) and stream from its first decode step. The
        prefill engine sampled the handoff's first token; it is emitted
        here as the stream's first event."""
        handoff = self._handoffs.pop(hid)
        if handoff is None:
            return http._json(404, {"error": {"message": (
                f"unknown handoff id {hid!r} (expired or already consumed)"
            )}})
        display = handoff.model or self.served_model_name
        sp = SamplingParams(
            temperature=handoff.temperature, top_k=handoff.top_k,
            top_p=handoff.top_p, max_tokens=handoff.max_tokens,
            seed=handoff.seed, stop=tuple(handoff.stop),
        )
        sub: queue.Queue = queue.Queue()

        def register(rid: int) -> None:
            with self._sub_lock:
                self._subscribers[rid] = sub

        try:
            rid, first_ev = self.engine.import_handoff(handoff, on_admit=register)
        except EngineBusy as e:
            return self._shed_response(http, str(e))
        except EngineDraining:
            return self._drain_refusal(http)
        except NotImplementedError as e:  # an adapter's handoff
            return http._json(404, {"error": {"message": str(e)}})
        except HandoffError as e:
            return http._json(400, {"error": {"message": str(e)}})
        sub.put(first_ev)
        self.metrics.requests_total.inc(model=display)
        self.metrics.active_requests.inc()
        self.metrics.prompt_tokens.inc(handoff.plen)
        self._work.set()
        t0 = time.monotonic()
        span = getattr(http, "current_span", None)
        reqs = [(rid, sub, sp)]
        try:
            if body.get("stream", False):
                self._stream_response(http, reqs, display, chat, t0=t0, span=span)
            else:
                self._unary_response(http, reqs, display, chat, handoff.plen)
        finally:
            if span is not None and not span.end_ns:
                span.set_attribute("request.duration_s", time.monotonic() - t0)
                span.set_attribute("disagg.handoff_id", hid)
            self._cancel_all(reqs)
            self.metrics.active_requests.dec()

    # -- cluster KV-sharing tier -----------------------------------------------

    def _handle_kv_export(self, http, body: dict):
        """POST /v1/kv/export: serve a peer's partial-chain prefix fetch.
        JSON {"prefix_hashes": [hex...], "max_bytes": N} in, a KVP1 page
        blob out (empty when nothing of the chain is held). The cap is the
        tighter of the caller's max_bytes and this server's transfer
        limit."""
        if not self.kv_sharing:
            return http._json(404, {"error": {"message": "KV sharing is not enabled"}})
        if self._draining.is_set():
            return self._drain_refusal(http)
        hashes = body.get("prefix_hashes")
        if not isinstance(hashes, list) or not all(isinstance(h, str) for h in hashes):
            return http._json(400, {"error": {"message": "prefix_hashes must be a hex list"}})
        max_bytes = body.get("max_bytes", 0)
        if isinstance(max_bytes, bool) or not isinstance(max_bytes, int):
            max_bytes = 0
        cap = max(0, max_bytes)
        if self.max_transfer_bytes:
            cap = min(cap, self.max_transfer_bytes) if cap else self.max_transfer_bytes
        export_fn = getattr(self.engine, "export_prefix_pages", None)
        export = export_fn(hashes, cap) if export_fn is not None else None
        if export is None:
            return http._json(400, {"error": {"message": (
                "prefix export unavailable (paged prefix cache off or malformed chain)"
            )}})
        blob = serialize_pages(export)
        http._last_status = 200
        http.send_response(200)
        http.send_header("Content-Type", "application/octet-stream")
        http.send_header("Content-Length", str(len(blob)))
        http.send_header("X-KV-Pages", str(export.n_pages))
        http.end_headers()
        http.wfile.write(blob)

    def _maybe_fetch_prefix(self, headers, prompt_ids: list[int], deadline_ms) -> None:
        """Best-effort prefix KV fetch before admission: compute the
        prompt's chain, and when a peer (X-KV-Source, which the router
        supplies only for closed-circuit holders) or the spill store holds
        pages past the local cached depth, pull and seed them so that
        admission's ordinary prefix-hit path skips that prefill. Every
        failure returns silently and the request recomputes: this can cost
        latency (bounded by the deadline budget and kv_fetch_timeout),
        never correctness."""
        import http.client as _hc

        compute = getattr(self.engine, "compute_prefix_chain", None)
        depth_fn = getattr(self.engine, "cached_prefix_depth", None)
        import_fn = getattr(self.engine, "import_prefix_pages", None)
        if compute is None or depth_fn is None or import_fn is None:
            return
        t0 = time.monotonic()
        # deadline_ms is None when deadline admission is off entirely.
        budget_s = deadline_ms / 1000.0 if deadline_ms and deadline_ms > 0 else None

        def budget_left() -> float | None:
            if budget_s is None:
                return None
            return budget_s - (time.monotonic() - t0)

        try:
            chain = compute(prompt_ids)
        except Exception:
            return
        # Admission's hit cap: pages past it are never adopted (the final
        # token must compute its own logits), so fetching them is waste.
        ps = self.engine.cfg.page_size
        chain = chain[: max(0, (len(prompt_ids) - 1) // ps)]
        if not chain:
            return
        depth = depth_fn(chain)
        if depth >= len(chain):
            return  # a full local hit: nothing to fetch
        missing = chain[depth:]
        source = (headers.get("X-KV-Source") or "").strip()
        if source:
            left = budget_left()
            if left is not None and left <= 0:
                return
            self.metrics.kv_fetch_attempts.inc(source="peer")
            timeout = self.kv_fetch_timeout
            if left is not None:
                timeout = min(timeout, left)
            conn = None
            try:
                payload = json.dumps({
                    "prefix_hashes": missing, "max_bytes": self.max_transfer_bytes,
                }).encode()
                conn = _hc.HTTPConnection(source, timeout=timeout)
                conn.request("POST", "/v1/kv/export", body=payload,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    raise OSError(f"peer answered {resp.status}")
                blob = resp.read()
                if self.max_transfer_bytes and len(blob) > self.max_transfer_bytes:
                    raise OSError(
                        f"peer blob of {len(blob)} bytes exceeds the "
                        f"{self.max_transfer_bytes}-byte transfer limit"
                    )
                left = budget_left()
                if left is not None and left <= 0:
                    raise OSError("deadline budget exhausted mid-fetch")
                n = import_fn(deserialize_pages(blob), source="peer")
                if n > 0:
                    self.metrics.kv_fetch_bytes.inc(len(blob))
                    return
            except Exception as e:  # noqa: BLE001
                # Broad by contract: a peer dying mid-transfer surfaces as
                # http.client.IncompleteRead and a corrupt blob as
                # HandoffError; all of it degrades to recompute.
                logger.warning("peer KV fetch from %s failed: %s", source, e)
                self.metrics.kv_fetch_failures.inc(source="peer")
            finally:
                if conn is not None:
                    conn.close()
        if self.kv_spill is None:
            return
        # Spill fill: single-page blobs keyed by chain hash, imported one
        # page at a time so that a partial fill still shortens prefill.
        filled = 0
        self.metrics.kv_fetch_attempts.inc(source="spill")
        for h in missing:
            left = budget_left()
            if left is not None and left <= 0:
                break
            try:
                blob = self.kv_spill.get(h)
            except Exception:  # noqa: BLE001
                blob = None
            if blob is None:
                break  # the chain must stay consecutive: stop at a miss
            try:
                if import_fn(deserialize_pages(blob), source="spill") == 0:
                    break
            except (HandoffError, ValueError):
                break
            filled += 1
            self.metrics.kv_fetch_bytes.inc(len(blob))
        if filled == 0:
            self.metrics.kv_fetch_failures.inc(source="spill")

    @staticmethod
    def _parse_sampling(body: dict, room: int) -> SamplingParams:
        """Validate OpenAI sampling fields; raises ValueError with a
        client-readable message on malformed input."""

        def _number(key, default, *, lo=None, hi=None, integer=False):
            raw = body.get(key)
            if raw is None:
                return default
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ValueError(f"{key} must be a number, got {raw!r}")
            if integer and not isinstance(raw, int):
                raise ValueError(f"{key} must be an integer, got {raw!r}")
            if lo is not None and raw < lo:
                raise ValueError(f"{key} must be >= {lo}, got {raw}")
            if hi is not None and raw > hi:
                raise ValueError(f"{key} must be <= {hi}, got {raw}")
            return raw

        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = body.get("max_completion_tokens")
        if max_tokens is None:
            max_tokens = 128
        elif isinstance(max_tokens, bool) or not isinstance(max_tokens, int):
            raise ValueError(
                f"max_tokens must be a positive integer, got {max_tokens!r}"
            )
        elif max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        temperature = float(_number("temperature", 1.0, lo=0.0))
        top_p = float(_number("top_p", 1.0, hi=1.0))
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        top_k = int(_number("top_k", 0, lo=0, integer=True))
        return SamplingParams(
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_tokens=min(max_tokens, room),
            seed=body.get("seed"),
            stop=tuple(
                [body["stop"]] if isinstance(body.get("stop"), str)
                else body.get("stop") or []
            ),
        )

    def _collect(self, rid, sub, sp, on_delta=None, deadline=None,
                 resume_tokens=(), resume_emitted=None):
        """Drain tokens; detokenize incrementally; apply stop strings.
        Returns (text, finish_reason, tokens). on_delta gets (delta_text,
        new_tokens) for each piece of text that is safe to send.

        Continuation: `resume_tokens` seeds the token buffer, so stop
        strings and detokenization see the whole completion, while
        on_delta fires only past `resume_emitted` characters (what the
        dead stream already delivered; by default the whole resumed
        text)."""
        tokens: list[int] = list(resume_tokens)
        sent_tokens = len(tokens)
        if tokens:
            base_text = self.tokenizer.decode(tokens)
            emitted_len = (
                len(base_text) if resume_emitted is None
                else max(0, min(int(resume_emitted), len(base_text)))
            )
        else:
            emitted_len = 0
        finish = "length"
        if deadline is None:
            deadline = time.monotonic() + self.request_timeout
        while True:
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Empty
                ev = sub.get(timeout=remaining)
            except queue.Empty:
                # Stalled engine or abandoned stream: stop decoding now.
                self.engine.cancel(rid)
                finish = "timeout"
                break
            if ev.token < 0:
                # Drain-kill sentinel: the drain budget expired; end this
                # stream cleanly with whatever was generated so far.
                self.engine.cancel(rid)
                finish = "timeout"
                break
            tokens.append(ev.token)
            self.metrics.generated_tokens.inc()
            text = self.tokenizer.decode(tokens)
            stop_hit = None
            for s in sp.stop:
                idx = text.find(s, max(0, emitted_len - len(s)))
                if idx != -1:
                    stop_hit = idx
                    break
            if stop_hit is not None:
                if on_delta and stop_hit > emitted_len:
                    on_delta(text[emitted_len:stop_hit], tokens[sent_tokens:])
                    sent_tokens = len(tokens)
                self.engine.cancel(rid)
                return text[:stop_hit], "stop", tokens
            if on_delta and len(text) > emitted_len:
                # Hold back a partial UTF-8 replacement char at the tail.
                safe = text[:-1] if text.endswith("�") else text
                if len(safe) > emitted_len:
                    on_delta(safe[emitted_len:], tokens[sent_tokens:])
                    sent_tokens = len(tokens)
                    emitted_len = len(safe)
            if ev.finished:
                finish = ev.finish_reason or "stop"
                break
        text = self.tokenizer.decode(tokens)
        if on_delta and len(text) > emitted_len:
            on_delta(text[emitted_len:], tokens[sent_tokens:])
        return text, finish, tokens

    def _unary_response(self, http, reqs, display, chat, n_prompt,
                        resume_tokens=(), resume_emitted=None):
        choices = []
        total_completion = 0
        any_timeout = False
        deadline = time.monotonic() + self.request_timeout
        for i, (rid, sub, sp_i) in enumerate(reqs):
            text, finish, tokens = self._collect(
                rid, sub, sp_i, deadline=deadline,
                resume_tokens=resume_tokens if i == 0 else (),
                resume_emitted=resume_emitted if i == 0 else None,
            )
            completion_tokens = len(tokens)
            if finish == "timeout":
                any_timeout = True
                finish = "length"  # partial result; valid OpenAI value
            total_completion += completion_tokens
            if chat:
                choices.append({
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish,
                })
            else:
                choices.append({"index": i, "text": text, "finish_reason": finish})
        if any_timeout and total_completion == 0:
            # No choice produced a token within the budget: 503 so the
            # proxy retries another replica, with a hint from the
            # scheduler's state.
            sched = self._scheduler()
            ra = retryafter.jittered(
                sched.retry_after() if sched is not None else 1.0
            )
            return http._json(
                503,
                {"error": {"message": "engine produced no tokens within "
                           f"{self.request_timeout}s"}},
                headers={"Retry-After": retryafter.format_header(ra)},
            )
        payload = {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": display,
            "choices": choices,
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": total_completion,
                "total_tokens": n_prompt + total_completion,
            },
        }
        http._json(200, payload)

    def _stream_response(self, http, reqs, display, chat, t0=None, span=None,
                         resume_tokens=(), resume_emitted=None):
        """SSE stream; with n > 1 the choices stream one after another in
        index order. Every content chunk carries `token_ids`, the raw
        tokens behind its delta, which the routing proxy accumulates to
        resume the stream elsewhere if this replica dies; the final chunk
        of a choice carries only its finish_reason."""
        http.send_response(200)
        http.send_header("Content-Type", "text/event-stream")
        http.send_header("Cache-Control", "no-cache")
        http.send_header("Transfer-Encoding", "chunked")
        http.end_headers()
        rid_s = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def send_chunk(obj: dict):
            data = f"data: {json.dumps(obj)}\n\n".encode()
            http.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            http.wfile.flush()

        def send_choice(choice: dict, token_ids=()):
            send_chunk({
                "id": rid_s,
                "object": "chat.completion.chunk" if chat else "text_completion",
                "created": created,
                "model": display,
                "choices": [choice],
                **({"token_ids": [int(t) for t in token_ids]} if token_ids else {}),
            })

        deadline = time.monotonic() + self.request_timeout
        ttft_seen = [False]
        for i, (rid, sub, sp_i) in enumerate(reqs):

            def on_delta(delta_text: str, new_tokens=(), _i=i):
                if not ttft_seen[0]:
                    ttft_seen[0] = True
                    if span is not None and t0 is not None:
                        span.set_attribute("request.ttft_s", time.monotonic() - t0)
                if chat:
                    send_choice(
                        {"index": _i, "delta": {"content": delta_text},
                         "finish_reason": None},
                        token_ids=new_tokens,
                    )
                else:
                    send_choice(
                        {"index": _i, "text": delta_text, "finish_reason": None},
                        token_ids=new_tokens,
                    )

            _text, finish, _tokens = self._collect(
                rid, sub, sp_i, on_delta=on_delta, deadline=deadline,
                resume_tokens=resume_tokens if i == 0 else (),
                resume_emitted=resume_emitted if i == 0 else None,
            )
            if finish == "timeout":
                finish = "length"
            send_choice(
                {"index": i, "delta": {}, "finish_reason": finish}
                if chat
                else {"index": i, "text": "", "finish_reason": finish}
            )
        done = b"data: [DONE]\n\n"
        http.wfile.write(f"{len(done):x}\r\n".encode() + done + b"\r\n")
        http.wfile.write(b"0\r\n\r\n")
        http.wfile.flush()


# Flags of the JAX entry point whose features are not ported, with the
# ROADMAP item that brings each: (flag, is it set?, what it needs).
_UNPORTED_FLAGS = (
    ("--tpu-topology", lambda a: bool(a.tpu_topology),
     "meshes and parallelism (ROADMAP A item 11)"),
    ("--dcn-coordinator/--process-id/--num-processes",
     lambda a: bool(a.dcn_coordinator) or a.process_id != 0 or a.num_processes > 1,
     "multihost lockstep serving (ROADMAP A item 11)"),
    ("--quantization int8", lambda a: a.quantization == "int8",
     "int8 weights (ROADMAP A item 9)"),
    ("--draft-url", lambda a: bool(a.draft_url),
     "draft-model speculation (ROADMAP A item 10)"),
    ("--kv-spill-url", lambda a: bool(a.kv_spill_url),
     "KV spill to an object store (ROADMAP A item 9)"),
    ("--snapshot-url/--snapshot-dir/--snapshot-no-publish",
     lambda a: bool(a.snapshot_url or a.snapshot_dir or a.snapshot_no_publish),
     "snapshot restore-first boots (ROADMAP A item 9)"),
    ("--max-adapters", lambda a: a.max_adapters > 0,
     "LoRA adapters (ROADMAP A item 8)"),
)


def parse_args(argv=None) -> argparse.Namespace:
    """The entry point's flags, with the JAX entry point's names and
    defaults. Exits naming the ROADMAP item of a flag whose feature is
    not ported."""
    ap = argparse.ArgumentParser(prog="kubeai-tpu-torch-engine")
    ap.add_argument("--model-url", required=True)
    ap.add_argument("--served-model-name", default="model")
    ap.add_argument("--model-dir", default="", help="pre-downloaded cache dir")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device the engine runs on; cpu runs the kernels' "
        "plain PyTorch versions (tests)",
    )
    ap.add_argument("--tpu-topology", default="", help="not ported")
    ap.add_argument("--dcn-coordinator", default=os.environ.get("TPU_COORDINATOR", ""),
                    help="not ported")
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ.get("TPU_PROCESS_ID", "0")),
                    help="not ported")
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("TPU_PROCESS_COUNT", "1")),
                    help="not ported")
    ap.add_argument("--num-slots", type=int, default=32)
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument(
        "--max-adapters", type=int, default=0,
        help="LoRA adapter slots; the JAX engine's default is 4, the "
        "port's 0 until LoRA is ported (ROADMAP A item 8)",
    )
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--quantization", default="", choices=["", "int8"],
                    help="int8 is not ported")
    ap.add_argument("--kv-dtype", default="", choices=["", "bfloat16", "int8"],
                    help="paged KV-cache storage dtype: int8 stores pages as "
                    "int8 with per-token scales (about half the bytes)")
    ap.add_argument(
        "--pipeline", action="store_true",
        help="legacy alias of --step-overlap on",
    )
    ap.add_argument(
        "--step-overlap", choices=["auto", "on", "off"], default="auto",
        help="overlapped step pipeline: dispatch decode chunk N+1 before "
        "reaping chunk N (token-identical to the synchronous loop); auto "
        "and on overlap, off steps synchronously",
    )
    ap.add_argument(
        "--speculate", type=int, default=0,
        help="speculative-decoding window (0 = off); prompt-lookup "
        "proposals",
    )
    ap.add_argument(
        "--spec-adaptive", choices=["on", "off"], default="on",
        help="measure speculative vs chunk decode and run the faster",
    )
    ap.add_argument("--draft-url", default="", help="not ported")
    ap.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="chunked prefill size (0 = whole-prompt bucketed prefill)",
    )
    ap.add_argument(
        "--default-priority", default="standard",
        choices=list(PRIORITY_CLASSES),
        help="priority class for requests without an X-Priority header "
        "(CRD scheduling.defaultPriority)",
    )
    ap.add_argument(
        "--max-deadline-ms", type=int, default=0,
        help="cap on client X-Deadline-Ms values, and the default "
        "deadline when none is sent; 0 disables deadline admission "
        "(CRD scheduling.maxDeadlineMs)",
    )
    ap.add_argument(
        "--queue-shares", default="",
        help="per-class dispatch shares guaranteeing lower bands a "
        "fraction of admissions under sustained higher-priority load, "
        "e.g. 'standard=0.3,batch=0.05' (CRD scheduling.queueShares)",
    )
    ap.add_argument(
        "--max-queue", type=int, default=256,
        help="pending-queue depth past which requests are shed with 429 "
        "and a computed Retry-After",
    )
    ap.add_argument(
        "--drain-timeout", type=float, default=30.0,
        help="graceful-drain budget in seconds: after SIGTERM or POST "
        "/v1/drain, in-flight generations get this long to finish "
        "before being terminated (CRD spec.drainTimeoutSeconds)",
    )
    ap.add_argument(
        "--watchdog-timeout", type=float, default=120.0,
        help="step-watchdog budget in seconds: with work active and no "
        "engine step progress for this long, /health flips and the "
        "process exits 3 so Kubernetes restarts the pod; 0 disables",
    )
    ap.add_argument(
        "--role", default="unified",
        choices=["unified", "prefill", "decode"],
        help="disaggregated serving role: prefill engines run the prefill "
        "and push a KV handoff to the decode pool instead of entering "
        "decode; decode engines admit handoffs directly into slots (POST "
        "/v1/kv/import + X-Disagg-Handoff) (CRD spec.disaggregation)",
    )
    ap.add_argument(
        "--max-transfer-mb", type=int, default=0,
        help="cap on one serialized KV handoff (0 = unlimited); uploads "
        "and exports past it answer 413 (CRD disaggregation.maxTransferMB)",
    )
    ap.add_argument(
        "--transfer-timeout", type=float, default=30.0,
        help="prefill-role push budget toward the decode pool's "
        "/v1/kv/import (CRD disaggregation.transferTimeoutSeconds)",
    )
    ap.add_argument(
        "--prefix-cache", action="store_true",
        help="automatic prefix caching: shared prompt prefixes skip "
        "prefill. Implies a prefill chunk of min(512, max-seq-len/4) "
        "when unset",
    )
    ap.add_argument(
        "--kv-sharing", action="store_true",
        help="cluster-shared prefix/KV tier: publish held page-hash chains "
        "via /v1/state, serve peer page exports on /v1/kv/export, and pull "
        "common-prefix pages from the X-KV-Source peer before prefill; "
        "implies --prefix-cache (CRD spec.kvSharing)",
    )
    ap.add_argument(
        "--kv-fetch-timeout", type=float, default=5.0,
        help="budget for one peer KV-page fetch "
        "(CRD kvSharing.fetchTimeoutSeconds)",
    )
    ap.add_argument(
        "--kv-spill-url", default="",
        help="where evicted idle KV pages spill and are re-filled from; "
        "empty = in memory (an object-store URL is not ported)",
    )
    ap.add_argument("--snapshot-url", default="", help="not ported")
    ap.add_argument("--snapshot-dir", default="", help="not ported")
    ap.add_argument("--snapshot-no-publish", action="store_true",
                    help="not ported")
    args = ap.parse_args(argv)
    for flag, is_set, needs in _UNPORTED_FLAGS:
        if is_set(args):
            raise SystemExit(f"{flag}: {needs} is not ported to this engine")
    if args.kv_sharing:
        args.prefix_cache = True  # holdings live in the paged prefix cache
    if args.prefix_cache and args.prefill_chunk <= 0:
        args.prefill_chunk = max(32, min(512, args.max_seq_len // 4))
    if args.pipeline and args.step_overlap == "auto":
        args.step_overlap = "on"  # the legacy knob, as EngineConfig(pipeline=True)
    return args


def engine_config(args: argparse.Namespace) -> EngineConfig:
    """The EngineConfig that `args` ask for."""
    return EngineConfig(
        num_slots=args.num_slots,
        max_seq_len=args.max_seq_len,
        decode_chunk=args.decode_chunk,
        step_overlap=args.step_overlap,
        kv_dtype=args.kv_dtype,
        speculate=args.speculate,
        spec_adaptive=args.spec_adaptive == "on",
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache,
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("kubeai-tpu-torch-engine")
    device = resolve_device(args.device)
    tracker = ColdStartTracker()
    try:
        model_dir = resolve_model_dir(args.model_url, args.model_dir)
        hf_cfg = load_hf_config(model_dir)
        arch = (hf_cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        if arch in UNPORTED_ARCHITECTURES:
            raise WeightLoadError(
                f"{arch}: the {UNPORTED_ARCHITECTURES[arch]} family is not "
                "ported to this engine (ROADMAP A item 10)"
            )
        family = get_model_family(arch)
        model_cfg = family.config_from_hf(hf_cfg)
        log.info("loading %s (%s) from %s onto %s",
                 args.served_model_name, arch, model_dir, device)
        with tracker.phase("load"):
            params = load_params(family.name, model_dir, model_cfg, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    except (WeightLoadError, KeyError) as e:  # KeyError: an unknown family or field
        raise SystemExit(f"cannot load {args.model_url}: {e}") from e

    shares: dict[str, float] = {}
    if args.queue_shares:
        for pair in args.queue_shares.split(","):
            pair = pair.strip()
            if not pair:
                continue
            cls, _, share = pair.partition("=")
            shares[cls.strip()] = float(share)
    scheduler = RequestScheduler(
        SchedulingPolicy(
            default_priority=args.default_priority,
            queue_shares=shares,
            max_deadline_ms=args.max_deadline_ms,
        )
    )
    tokenizer = load_tokenizer(model_dir)
    engine_cfg = engine_config(args)
    # Warm-up before Ready. The engine captures its CUDA graphs when it
    # is built and the kernels' library is built at its first launch, so
    # `compile` covers both; `warmup` times a second, warmed generate.
    warm = SamplingParams(temperature=0.0, max_tokens=2)
    with tracker.phase("compile"):
        engine = Engine(
            family, model_cfg, params, cfg=engine_cfg,
            eos_token_ids=tuple(getattr(tokenizer, "eos_token_ids", ())),
            scheduler=scheduler, device=device,
        )
        engine.generate([[1, 2, 3]], warm)
    with tracker.phase("warmup"):
        engine.generate([[1, 2, 3]], warm)
    tracker.finish()
    # The warm-up's latency records are dropped: /metrics counts served
    # requests.
    engine.drain_timing()
    log.info("warm-up complete (cold start %.2fs: %s)", tracker.total_s,
             json.dumps({k: round(v, 3) for k, v in tracker.phases.items()}))

    def _watchdog_exit():
        # The watchdog already flipped /health; exiting nonzero hands the
        # pod to kubelet's restart policy: a hung device step cannot be
        # recovered in-process.
        log.error("engine watchdog: hung device step — exiting 3 for restart")
        os._exit(3)

    server = EngineServer(
        engine,
        tokenizer,
        args.served_model_name,
        host=args.host,
        port=args.port,
        max_queue=args.max_queue,
        default_priority=args.default_priority,
        max_deadline_ms=args.max_deadline_ms,
        drain_timeout=args.drain_timeout,
        role=args.role,
        max_transfer_mb=args.max_transfer_mb,
        transfer_timeout=args.transfer_timeout,
        watchdog_timeout=args.watchdog_timeout,
        watchdog_action=_watchdog_exit,
        kv_sharing=args.kv_sharing,
        kv_fetch_timeout=args.kv_fetch_timeout,
        kv_spill_store=(
            KVSpillStore(args.kv_spill_url) if args.kv_sharing else None
        ),
        cold_start=tracker.snapshot(),
    )
    tracing.configure(service_name=f"kubeai-tpu-engine.{args.served_model_name}")
    server.start()
    log.info("engine serving on %s:%d", args.host, server.port)

    # SIGTERM (pod deletion, rollout) starts the graceful drain: stop
    # admitting, flip /health so the LB ejects us, finish in-flight work
    # within --drain-timeout, then exit 0.
    exit_evt = threading.Event()

    def _drain_and_exit():
        server.begin_drain()
        server.wait_drained()
        exit_evt.set()

    def _on_sigterm(signum, frame):
        log.info("SIGTERM: draining (budget %.1fs)", args.drain_timeout)
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use)
    try:
        while not exit_evt.wait(timeout=0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
