"""Boot phase timings for one engine start. Counterpart of
kubeai_tpu/engine/coldstart.py, of which `ColdStartTracker` is ported:
every boot is phase-timed into it (`load` for the checkpoint, `compile`
for the engine's construction, where the CUDA graphs are captured, and
its first generate, where the kernels are built; `warmup` for the
second generate), exported as `kubeai_coldstart_*` metrics and on
`/v1/state`, so the fleet's planner can price a replica's measured
cold-start cost.

`ColdStartManager` (snapshot restore-first boots) is not ported yet
(ROADMAP A item 9): every boot of the port takes the full load path.
"""

from __future__ import annotations

import contextlib
import time


class ColdStartTracker:
    """Per-phase wall timings for one engine boot (injectable clock so
    the fake-clock sim drives it deterministically)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._total: float | None = None
        self.phases: dict[str, float] = {}
        self.events: list[str] = []
        self.restored = False
        self.fingerprint = ""

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                self._clock() - t0
            )

    def event(self, name: str) -> None:
        self.events.append(name)

    def finish(self) -> float:
        self._total = self._clock() - self._t0
        return self._total

    @property
    def total_s(self) -> float:
        return self._total if self._total is not None else (
            self._clock() - self._t0
        )

    def snapshot(self) -> dict:
        """The `/v1/state` cold_start block (and the metric source)."""
        return {
            "restored": self.restored,
            "fingerprint": self.fingerprint,
            "phases": dict(self.phases),
            "total_s": round(self.total_s, 6),
            "events": list(self.events),
        }
