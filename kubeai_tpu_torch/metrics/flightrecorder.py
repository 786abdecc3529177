"""Always-on flight recorder: bounded decision-event rings and triggered
incident bundles.

A copy of kubeai_tpu/metrics/flightrecorder.py: the recorder is host-side
Python with no JAX in it, and the port keeps its own copy so that it
imports nothing of the JAX package. The event kinds, record kinds and
bundle format are the JAX recorder's, so a bundle from either engine
replays through the same game-day tooling.

The engine server drops a structured event into a ring for each
discrete decision it makes: an admission, a deadline shed, a
preemption, a watchdog wedge, a crashed serving loop. Recording is a
deque append, never I/O. `trigger()` snapshots every ring, the
recent-span ring and the metric-capture deltas into a sorted-key JSONL
incident bundle (a GameDayLog header and typed records).

Determinism: the recorder touches the clock only through the injected
`clock` callable, assigns a process-monotonic `seq` to every event for
stable same-instant ordering, and filters known wall-clock-derived
metric series out of bundle deltas: a fake-clock run that dumps a
bundle twice gets the same bytes twice.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

from kubeai_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Registry,
    parse_prometheus_text,
)

logger = logging.getLogger(__name__)

# Decision-event kinds this recorder accepts: the JAX recorder's.
DOOR_SHED = "door_shed"
DOOR_QUOTA = "door_quota"
BREAKER = "breaker_transition"
LB_NO_ENDPOINTS = "lb_no_healthy_endpoints"
GOVERNOR_DENY = "governor_denial"
SCHED_ADMIT = "scheduler_admit"
SCHED_SHED = "scheduler_shed"
SCHED_PREEMPT = "scheduler_preempt"
PLANNER_PREEMPT = "planner_preempt_mark"
WATCHDOG = "engine_watchdog"
STEP_ANOMALY = "engine_step_anomaly"
SLO_ALERT = "slo_alert"
ROLLOUT_DECISION = "rollout_decision"

EVENT_KINDS = (
    DOOR_SHED,
    DOOR_QUOTA,
    BREAKER,
    LB_NO_ENDPOINTS,
    GOVERNOR_DENY,
    SCHED_ADMIT,
    SCHED_SHED,
    SCHED_PREEMPT,
    PLANNER_PREEMPT,
    WATCHDOG,
    STEP_ANOMALY,
    SLO_ALERT,
    ROLLOUT_DECISION,
)

# Record kinds incident bundles emit.
RECORD_KINDS = ("flight", "span", "metric_delta", "exemplar")

# Trigger rule names (the `trigger` label on kubeai_flight_incidents_total
# and the `reason` field in bundle headers).
TRIGGER_FAST_BURN = "fast_burn_page"
TRIGGER_WATCHDOG = "watchdog_wedge"
TRIGGER_ALL_CIRCUITS_OPEN = "all_circuits_open"
TRIGGER_COVERAGE_COLLAPSE = "coverage_collapse"
TRIGGER_ROLLBACK = "rollout_rollback"

# Metric series derived from the host wall clock even under a FakeClock
# (they time real work with time.monotonic). Excluded from bundle
# deltas: their values differ run-to-run and would break the
# byte-identical replay contract.
NONDETERMINISTIC_METRICS = frozenset({
    "kubeai_fleet_collection_duration_seconds",
    "kubeai_autoscaler_scrape_duration_seconds",
})


def _deterministic_series(series: str) -> bool:
    name = series.split("{", 1)[0]
    for nd in NONDETERMINISTIC_METRICS:
        if name.startswith(nd):
            return False
    return True


class FlightRecorderMetrics:
    """The recorder's own instrument bundle (own registry: the recorder
    is wired into subsystems that carry different Metrics bundles, and
    its health must be observable regardless of which one scrapes)."""

    def __init__(self):
        self.registry = Registry()
        self.events = Counter(
            "kubeai_flight_events_total",
            "Decision events recorded per flight-recorder ring.",
            self.registry,
        )
        self.dropped = Counter(
            "kubeai_flight_dropped_events_total",
            "Events evicted from a full flight-recorder ring (the ring "
            "keeps the newest; eviction is normal steady-state behavior, "
            "a spike means the window shrank during an incident).",
            self.registry,
        )
        self.incidents = Counter(
            "kubeai_flight_incidents_total",
            "Incident bundles dumped per trigger rule.",
            self.registry,
        )
        self.suppressed = Counter(
            "kubeai_flight_suppressed_triggers_total",
            "Trigger firings suppressed by the per-rule debounce "
            "interval (the first bundle of a storm is the evidence; "
            "the next hundred would be noise).",
            self.registry,
        )
        self.last_incident_ts = Gauge(
            "kubeai_flight_last_incident_timestamp_seconds",
            "Timestamp of the most recent incident bundle dump.",
            self.registry,
        )


class FlightRecorder:
    """Bounded per-subsystem decision rings + incident bundling.

    `clock` is injectable (FakeClock in sims); `tick_fn` optionally
    maps the clock to a sim tick for bundle records (defaults to 0 —
    live processes have no tick). `sink_dir` is where bundles land;
    without one, `trigger()` still builds and retains the bundle lines
    in memory (`self.incidents`)."""

    def __init__(
        self,
        clock=time.time,
        ring_size: int = 256,
        span_ring_size: int = 128,
        metric_captures: int = 8,
        min_trigger_interval_s: float = 300.0,
        sink_dir: str | None = None,
        metrics: FlightRecorderMetrics | None = None,
        tick_fn=None,
    ):
        self._clock = clock
        self.ring_size = int(ring_size)
        self.min_trigger_interval_s = float(min_trigger_interval_s)
        self.sink_dir = sink_dir
        self.metrics = metrics if metrics is not None else FlightRecorderMetrics()
        self.tick_fn = tick_fn
        self._lock = threading.Lock()
        self._rings: dict[str, deque] = {}
        self._seq = 0
        self._spans: deque = deque(maxlen=int(span_ring_size))
        self._captures: deque = deque(maxlen=max(2, int(metric_captures)))
        self._exemplars: dict[str, dict] = {}
        self._last_trigger: dict[str, float] = {}
        # What a bundle needs to be replayable: the owning sim stamps
        # {"sim": ..., "seed": ..., "ticks": ...} here before running.
        self.replay_context: dict = {}
        # [(reason, path_or_None, lines)] of every bundle this recorder
        # produced — the in-process view /v1/slo exposes.
        self.incidents: list[dict] = []

    # -- recording (the always-on hot path) ---------------------------------

    def record(
        self,
        kind: str,
        subsystem: str,
        target: str = "",
        trace_id: str = "",
        **detail,
    ) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown flight event kind {kind!r}")
        ev = {
            "t": self._clock(),
            "kind": kind,
            "subsystem": subsystem,
            "target": target,
        }
        if trace_id:
            ev["trace_id"] = trace_id
        if detail:
            ev["detail"] = detail
        with self._lock:
            ring = self._rings.get(subsystem)
            if ring is None:
                ring = self._rings[subsystem] = deque(maxlen=self.ring_size)
            ev["seq"] = self._seq
            self._seq += 1
            if len(ring) == ring.maxlen:
                self.metrics.dropped.inc(ring=subsystem)
            ring.append(ev)
        self.metrics.events.inc(ring=subsystem)

    def events(self, subsystem: str | None = None) -> list[dict]:
        """Current ring contents (all rings merged when subsystem is
        None), in global decision order."""
        with self._lock:
            if subsystem is not None:
                return [dict(e) for e in self._rings.get(subsystem, ())]
            merged = [e for ring in self._rings.values() for e in ring]
        merged.sort(key=lambda e: (e["t"], e["seq"]))
        return [dict(e) for e in merged]

    def note_span(self, span: dict) -> None:
        """Keep a recent-span ring for bundles (the tracer exports and
        forgets; the recorder remembers the last few)."""
        with self._lock:
            self._spans.append(dict(span))

    def note_exemplars(self, source: str, exemplars: dict) -> None:
        """Latest per-bucket trace-id exemplars for one histogram
        source (e.g. 'door_ttft/<model>') — stamped into bundles so a
        burn-rate breach links straight to example traces."""
        if exemplars:
            with self._lock:
                self._exemplars[source] = dict(exemplars)

    def capture_metrics(self, registry) -> None:
        """Snapshot a registry's series values (called each SLO tick).
        Bundles report the per-series delta between the oldest and
        newest retained capture — the movement across the incident's
        lead-up, not absolute counters."""
        text = registry.expose() if hasattr(registry, "expose") else registry
        parsed = parse_prometheus_text(text)
        flat = {}
        for (name, labels), value in parsed.items():
            series = name + (
                "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
                if labels else ""
            )
            if _deterministic_series(series):
                flat[series] = value
        with self._lock:
            self._captures.append((self._clock(), flat))

    # -- triggers / bundling -------------------------------------------------

    def trigger(
        self, reason: str, detail: str = "", extra_header: dict | None = None
    ) -> str | None:
        """Fire a trigger rule: debounce, then atomically snapshot every
        ring + spans + metric deltas into an incident bundle. Returns
        the bundle path (or None when debounced / no sink_dir — the
        bundle lines are still retained in self.incidents)."""
        now = self._clock()
        with self._lock:
            last = self._last_trigger.get(reason)
            if last is not None and now - last < self.min_trigger_interval_s:
                self.metrics.suppressed.inc(trigger=reason)
                return None
            self._last_trigger[reason] = now
        lines = self.bundle_lines(reason, detail, extra_header)
        path = None
        if self.sink_dir:
            import os

            os.makedirs(self.sink_dir, exist_ok=True)
            fname = f"incident-{reason}-{int(now)}.jsonl"
            path = os.path.join(self.sink_dir, fname)
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            logger.warning(
                "flight recorder dumped incident bundle %s (%s)",
                path, detail or reason,
            )
        self.incidents.append(
            {"t": now, "reason": reason, "detail": detail, "path": path,
             "lines": lines}
        )
        self.metrics.incidents.inc(trigger=reason)
        self.metrics.last_incident_ts.set(now)
        return path

    def bundle_lines(
        self, reason: str, detail: str = "",
        extra_header: dict | None = None,
    ) -> list[str]:
        """The incident bundle as sorted-key JSONL lines: a GameDayLog
        header (kind=gameday, bundle=incident, plus the replay context)
        followed by flight / span / metric_delta / exemplar records."""
        now = self._clock()
        tick = int(self.tick_fn()) if self.tick_fn is not None else 0
        with self._lock:
            events = [e for ring in self._rings.values() for e in ring]
            events = [dict(e) for e in events]
            spans = [dict(s) for s in self._spans]
            captures = list(self._captures)
            exemplars = {k: dict(v) for k, v in self._exemplars.items()}
        events.sort(key=lambda e: (e["t"], e["seq"]))
        header = {
            "kind": "gameday",
            "bundle": "incident",
            "reason": reason,
            "detail": detail,
            "t": now,
            "seed": 0,
            "ticks": 0,
            "events": [],
        }
        header.update(self.replay_context)
        if extra_header:
            header.update(extra_header)
        lines = [json.dumps(header, sort_keys=True)]
        for ev in events:
            rec = {"record": "flight", "tick": tick}
            rec.update(ev)
            lines.append(json.dumps(rec, sort_keys=True))
        for span in spans:
            rec = {"record": "span", "tick": tick}
            rec.update(span)
            lines.append(json.dumps(rec, sort_keys=True))
        if len(captures) >= 2:
            t0, base = captures[0]
            t1, cur = captures[-1]
            for series in sorted(set(base) | set(cur)):
                v0 = base.get(series, 0.0)
                v1 = cur.get(series, 0.0)
                if v1 != v0:
                    lines.append(json.dumps(
                        {
                            "record": "metric_delta", "tick": tick,
                            "series": series, "from": v0, "to": v1,
                            "delta": v1 - v0, "window_s": t1 - t0,
                        },
                        sort_keys=True,
                    ))
        for source in sorted(exemplars):
            lines.append(json.dumps(
                {
                    "record": "exemplar", "tick": tick, "source": source,
                    "exemplars": exemplars[source],
                },
                sort_keys=True,
            ))
        return lines

    # -- admin view ----------------------------------------------------------

    def state_payload(self) -> dict:
        with self._lock:
            rings = {name: len(ring) for name, ring in self._rings.items()}
            exemplars = {k: dict(v) for k, v in self._exemplars.items()}
        return {
            "rings": rings,
            "spans": len(self._spans),
            "metric_captures": len(self._captures),
            "exemplars": exemplars,
            "incidents": [
                {k: v for k, v in inc.items() if k != "lines"}
                for inc in self.incidents
            ],
        }
