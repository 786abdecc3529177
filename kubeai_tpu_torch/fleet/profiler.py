"""Engine step profiler: a per-phase monotonic timeline of Engine.step.

A copy of kubeai_tpu/fleet/profiler.py: the profiler is host-side Python
with no JAX in it, and the port keeps its own copy so that it imports
nothing of the JAX package. The phase vocabulary is the JAX engine's;
in the port the phases read:

  schedule   — host-side bookkeeping before the decode dispatch (page
               allocation, speculation arm pick, proposals)
  prefill    — the admission pass (scheduler pops + prefill compute)
  decode     — the dispatch of the decode chunk or verify window (a
               CUDA-graph replay on the card, so the host returns before
               the device finishes; the eager program on the CPU)
  dispatch   — host→device input staging for the call (the block-table
               upload through pinned buffers)
  overlap_idle — time the host spends blocked on the device at reap
               (waiting on the dispatch's event). In the synchronous loop
               this is ~the whole device call; under the overlapped step
               it shrinks toward zero.
  readback   — reading the reaped call's tokens from its host buffer
               (the device→host copy itself was enqueued at dispatch and
               ends before the event)
  sample     — host-side token emission (stop checks, slot release)
  kv_transfer — paged-KV handoff export/import: the page gather or
               scatter, which the engine records among its latency
               records, outside the step timeline

The engine records plain floats under its own lock — it never touches a
metrics registry from the hot path. `recent()` returns the bounded ring
of step records, `phase_totals` sums them, and `wait_for_steps` blocks
`/v1/profile`'s fresh capture until new steps close. The JAX profiler's
standalone observations and its drainable histogram queue are not
copied: the server's metrics sync reads the step records past the last
one it saw from the ring, and a queue would grow with every step of an
engine that no server drains.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# Canonical phase vocabulary (metric label values; docs list them).
PHASES = (
    "schedule", "prefill", "decode", "dispatch", "overlap_idle",
    "readback", "sample", "kv_transfer",
)


class StepProfiler:
    """Bounded ring of per-step phase timelines. Thread-safe; all methods
    are cheap enough for the engine lock's critical section."""

    def __init__(self, maxlen: int = 256, wall=time.time):
        self._cond = threading.Condition()
        self._ring: deque[dict] = deque(maxlen=maxlen)
        self._wall = wall
        self.steps_completed = 0

    def observe_step(
        self,
        phases: dict[str, float],
        tokens: int = 0,
        batch: int = 0,
        duration_s: float = 0.0,
    ) -> None:
        """Close one step's record into the ring. Wakes /v1/profile
        waiters."""
        with self._cond:
            self.steps_completed += 1
            self._ring.append(
                {
                    "step": self.steps_completed,
                    "ts": self._wall(),
                    "tokens": int(tokens),
                    "batch": int(batch),
                    "duration_s": round(float(duration_s), 9),
                    "phases_s": {
                        k: round(float(v), 9) for k, v in phases.items()
                    },
                }
            )
            self._cond.notify_all()

    def recent(self, n: int | None = None) -> list[dict]:
        with self._cond:
            records = list(self._ring)
        return records if n is None else records[-n:]

    def wait_for_steps(self, n: int, timeout_s: float) -> int:
        """Block until `n` NEW steps complete (or timeout); returns how
        many actually did. Backs /v1/profile's fresh-capture mode."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            start = self.steps_completed
            while self.steps_completed - start < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.25))
            return self.steps_completed - start


def phase_totals(records: list[dict]) -> dict[str, float]:
    """Sum each phase across step records — the profile response's
    roll-up (which phase dominates the window)."""
    totals: dict[str, float] = {}
    for rec in records:
        for k, v in (rec.get("phases_s") or {}).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return {k: round(v, 9) for k, v in totals.items()}
