"""Priority-band + weighted-fair-queueing request scheduler with
deadline-aware admission control.

A copy of kubeai_tpu/scheduling/scheduler.py: the scheduler is host-side
Python with no JAX in it, and the port keeps its own copy so that it
imports nothing of the JAX package.

Queue discipline, outermost to innermost:

  1. Priority bands (``realtime`` > ``standard`` > ``batch``): strict
     precedence — a lower band is served only when every higher band is
     empty, UNLESS the lower band's configured queue share is due (see
     below). This is the contract latency-sensitive traffic needs: batch
     work can never delay a realtime request by more than the share it
     was explicitly granted.
  2. Share credits (anti-starvation): ``SchedulingPolicy.queue_shares``
     grants a band a fraction of dispatches. Every time a non-empty band
     is passed over, it accrues its share as credit; at credit >= 1 it is
     due and takes the next dispatch even though a higher band has work.
     The default share of 0 keeps pure strict precedence.
  3. Weighted fair queueing within a band, keyed by client: classic
     finish-tag virtual-time accounting (SFQ). Entry i of client c gets
     ``finish = max(band_vtime, prev_finish(c)) + cost / weight`` and the
     band pops the smallest finish tag. Two backlogged clients with 2:1
     weights converge to a 2:1 dispatch ratio; a newly arriving client
     starts at the band's virtual time, so it can neither starve nor be
     starved by an old backlog.

Admission control: the scheduler keeps a decayed estimate of the service
rate (cost units completed per second, fed by ``observe_service``). A
request whose deadline cannot be met given the queued work ahead of it is
refused at enqueue with :class:`DeadlineInfeasible`, carrying a COMPUTED
retry hint (queue depth ÷ drain rate, clamped) — never a fixed constant —
so clients and load balancers can make informed retry decisions.

The scheduler is clock-injected (``clock=``) so unit tests drive it with
a fake clock and assert the fairness/feasibility math deterministically.
All public methods are thread-safe (internal lock; no callbacks run
under it).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

CLASS_REALTIME = "realtime"
CLASS_STANDARD = "standard"
CLASS_BATCH = "batch"
# Strict precedence order, highest first.
PRIORITY_CLASSES = (CLASS_REALTIME, CLASS_STANDARD, CLASS_BATCH)
CLASS_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


class DeadlineInfeasible(Exception):
    """Raised at submit() when the request's deadline cannot be met given
    queued work and the measured service rate. ``retry_after`` is the
    computed backoff hint (seconds) the HTTP layer surfaces as
    ``Retry-After``."""

    def __init__(
        self, message: str, retry_after: float, estimated_wait: float,
        deadline_s: float,
    ):
        super().__init__(message)
        self.retry_after = retry_after
        self.estimated_wait = estimated_wait
        self.deadline_s = deadline_s


@dataclasses.dataclass(frozen=True)
class SchedulingPolicy:
    """Per-model scheduling policy (CRD ``scheduling:`` block)."""

    default_priority: str = CLASS_STANDARD
    # class -> guaranteed fraction of dispatches while backlogged (0..1).
    # 0 (the default) = pure strict precedence below higher bands.
    queue_shares: dict[str, float] = dataclasses.field(default_factory=dict)
    # Cap on client-requested deadlines (ms). 0 = uncapped.
    max_deadline_ms: int = 0
    # Retry-After clamp: the hint must be useful (not 0 on an empty
    # queue) and bounded (a 10-minute backlog should not tell clients to
    # disappear for 10 minutes — the LB retries elsewhere first).
    min_retry_after_s: float = 0.25
    max_retry_after_s: float = 30.0
    # Service-rate estimator decay per observation (decayed num/den
    # counters are robust to zero-completion steps, unlike a raw EWMA of
    # cost/dt samples).
    rate_decay: float = 0.95

    def validate(self) -> None:
        if self.default_priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"default_priority must be one of {PRIORITY_CLASSES}, "
                f"got {self.default_priority!r}"
            )
        for cls, share in self.queue_shares.items():
            if cls not in PRIORITY_CLASSES:
                raise ValueError(f"queue_shares: unknown class {cls!r}")
            if not 0.0 <= float(share) < 1.0:
                raise ValueError(
                    f"queue_shares[{cls!r}] must be in [0, 1), got {share}"
                )
        if self.max_deadline_ms < 0:
            raise ValueError("max_deadline_ms must be >= 0")
        if not 0.0 < self.rate_decay < 1.0:
            raise ValueError("rate_decay must be in (0, 1)")


class _Entry:
    __slots__ = (
        "item", "priority", "client", "weight", "cost", "deadline",
        "t_enqueue", "vstart", "vfinish", "seq", "removed", "counted",
    )

    def __init__(self, item, priority, client, weight, cost, deadline,
                 t_enqueue, seq):
        self.item = item
        self.priority = priority
        self.client = client
        self.weight = weight
        self.cost = cost
        self.deadline = deadline  # absolute clock value or None
        self.t_enqueue = t_enqueue
        self.vstart = 0.0
        self.vfinish = 0.0
        self.seq = seq
        self.removed = False
        # True once this entry's queue-wait was recorded (a preempted
        # request re-queued at the front must not count twice).
        self.counted = False


class _Band:
    """One priority band: a finish-tag heap over live entries plus the
    per-client virtual-time bookkeeping."""

    __slots__ = (
        "name", "vtime", "heap", "client_finish", "client_count",
        "depth", "cost_total", "credit",
    )

    def __init__(self, name: str):
        self.name = name
        self.vtime = 0.0
        self.heap: list[tuple[float, int, _Entry]] = []
        self.client_finish: dict[str, float] = {}
        self.client_count: dict[str, int] = {}
        self.depth = 0
        self.cost_total = 0.0
        self.credit = 0.0

    def push(self, e: _Entry) -> None:
        start = max(self.vtime, self.client_finish.get(e.client, 0.0))
        e.vstart = start
        e.vfinish = start + e.cost / max(e.weight, 1e-9)
        self.client_finish[e.client] = e.vfinish
        self.client_count[e.client] = self.client_count.get(e.client, 0) + 1
        heapq.heappush(self.heap, (e.vfinish, e.seq, e))
        self.depth += 1
        self.cost_total += e.cost

    def peek(self) -> _Entry | None:
        while self.heap:
            _, _, e = self.heap[0]
            if e.removed:
                heapq.heappop(self.heap)
                continue
            return e
        return None

    def pop(self) -> _Entry | None:
        e = self.peek()
        if e is None:
            return None
        heapq.heappop(self.heap)
        self._drop(e)
        # Advance virtual time to the dispatched entry's start tag: new
        # arrivals join at the frontier instead of replaying history.
        self.vtime = max(self.vtime, e.vstart)
        return e

    def discard(self, e: _Entry) -> None:
        """Lazy removal: the heap tuple stays until it surfaces."""
        e.removed = True
        self._drop(e)

    def _drop(self, e: _Entry) -> None:
        self.depth -= 1
        self.cost_total -= e.cost
        n = self.client_count.get(e.client, 0) - 1
        if n <= 0:
            self.client_count.pop(e.client, None)
            # The client drained; once virtual time passes its last
            # finish tag, the memo is inert — drop it so client churn
            # cannot grow the dict without bound.
            if self.client_finish.get(e.client, 0.0) <= self.vtime:
                self.client_finish.pop(e.client, None)
        else:
            self.client_count[e.client] = n


class RequestScheduler:
    """Admission-controlled priority/WFQ queue (see module docstring).

    Items are opaque objects tracked by identity; the engine queues its
    ``_Request`` records directly.
    """

    def __init__(
        self,
        policy: SchedulingPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or SchedulingPolicy()
        self.policy.validate()
        self._clock = clock
        self._lock = threading.Lock()
        self._bands = {c: _Band(c) for c in PRIORITY_CLASSES}
        # Preempted requests re-enter here and are served before any
        # band: they already hold partial progress (recompute state) and
        # re-subjecting them to fairness would double-charge their class.
        self._front: deque[_Entry] = deque()
        self._entries: dict[int, _Entry] = {}  # id(item) -> entry
        self._seq = 0
        # Decayed service-rate estimate: cost units per second.
        self._rate_num = 0.0
        self._rate_den = 0.0
        # Per-class lifetime stats.
        self._admitted = {c: 0 for c in PRIORITY_CLASSES}
        self._wait_sum = {c: 0.0 for c in PRIORITY_CLASSES}
        self._shed = {c: 0 for c in PRIORITY_CLASSES}

    # -- admission -------------------------------------------------------------

    def submit(
        self,
        item: Any,
        *,
        priority: str | None = None,
        client: str = "",
        weight: float = 1.0,
        cost: float = 1.0,
        deadline_ms: float | None = None,
    ) -> str:
        """Enqueue ``item``. Returns the resolved priority class.

        Raises ``ValueError`` on an unknown class / bad deadline and
        :class:`DeadlineInfeasible` when the deadline cannot be met given
        queued work and the measured service rate (the item is NOT
        queued). A ``deadline_ms`` beyond the policy's ``max_deadline_ms``
        cap is clamped, not rejected — the cap is an operator bound on
        how long a request may ask to wait, so clamping preserves the
        operator's intent."""
        prio = priority or self.policy.default_priority
        if prio not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {prio!r} "
                f"(expected one of {PRIORITY_CLASSES})"
            )
        if weight <= 0:
            raise ValueError("weight must be > 0")
        if cost <= 0:
            raise ValueError("cost must be > 0")
        deadline = None
        now = self._clock()
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if deadline_ms <= 0:
                raise ValueError("deadline_ms must be > 0")
            if self.policy.max_deadline_ms > 0:
                deadline_ms = min(deadline_ms, self.policy.max_deadline_ms)
            deadline = now + deadline_ms / 1000.0
        with self._lock:
            if deadline is not None:
                est = self._estimate_wait_locked(prio)
                if est is not None and now + est > deadline:
                    self._shed[prio] += 1
                    raise DeadlineInfeasible(
                        f"deadline {deadline_ms:.0f}ms infeasible: "
                        f"estimated queue wait {est:.2f}s at the current "
                        "drain rate",
                        retry_after=self._retry_after_locked(),
                        estimated_wait=est,
                        deadline_s=deadline_ms / 1000.0,
                    )
            self._seq += 1
            e = _Entry(item, prio, client, float(weight), float(cost),
                       deadline, now, self._seq)
            self._entries[id(item)] = e
            self._bands[prio].push(e)
        return prio

    # -- dispatch --------------------------------------------------------------

    def peek(self) -> Any | None:
        """The item pop() would return next, without removing it."""
        with self._lock:
            e = self._peek_entry_locked()
            return e.item if e is not None else None

    def pop(self) -> Any | None:
        with self._lock:
            while self._front:
                e = self._front.popleft()
                if not e.removed:
                    self._entries.pop(id(e.item), None)
                    return e.item
            band = self._choose_band_locked(consume=True)
            if band is None:
                return None
            e = band.pop()
            self._entries.pop(id(e.item), None)
            if not e.counted:
                e.counted = True
                self._admitted[e.priority] += 1
                self._wait_sum[e.priority] += max(
                    0.0, self._clock() - e.t_enqueue
                )
            return e.item

    def _peek_entry_locked(self) -> _Entry | None:
        while self._front and self._front[0].removed:
            self._front.popleft()
        if self._front:
            return self._front[0]
        band = self._choose_band_locked(consume=False)
        return band.peek() if band is not None else None

    def _choose_band_locked(self, consume: bool) -> _Band | None:
        """Pick the band to serve next. ``consume=True`` also updates the
        share credits (peek must be side-effect free so that a deferred
        admission — peek without pop — cannot drain a band's credit)."""
        nonempty = [
            self._bands[c] for c in PRIORITY_CLASSES
            if self._bands[c].depth > 0
        ]
        if not nonempty:
            return None
        chosen = nonempty[0]
        # A passed-over band whose share is due takes precedence; among
        # several due bands, the highest-priority one wins.
        for band in nonempty[1:]:
            if band.credit >= 1.0:
                chosen = band
                break
        if consume:
            if chosen is not nonempty[0]:
                chosen.credit -= 1.0
            for band in nonempty:
                if band is chosen:
                    continue
                share = float(self.policy.queue_shares.get(band.name, 0.0))
                if share > 0.0:
                    # Cap: an idle spell must not bank unbounded credit
                    # and then burst past the share.
                    band.credit = min(band.credit + share, 2.0)
        return chosen

    def requeue_front(self, item: Any) -> None:
        """Re-queue a preempted item at the absolute front (it resumes by
        recompute and must re-admit before anything else). Its original
        enqueue time and class stats are preserved — preemption is
        recompute, not a second queue wait."""
        with self._lock:
            e = self._entries.get(id(item))
            if e is None:
                self._seq += 1
                e = _Entry(item, self.policy.default_priority, "", 1.0, 1.0,
                           None, self._clock(), self._seq)
                e.counted = True
            else:
                # Already queued (shouldn't happen) — pull it out of its
                # band first.
                self._bands[e.priority].discard(e)
                e.removed = False
            self._entries[id(item)] = e
            self._front.appendleft(e)

    def remove(self, item: Any) -> bool:
        """Drop a queued item (cancellation). False if not queued."""
        with self._lock:
            e = self._entries.pop(id(item), None)
            if e is None:
                return False
            if e in self._front:
                e.removed = True  # popped lazily
            else:
                self._bands[e.priority].discard(e)
            return True

    def __contains__(self, item: Any) -> bool:
        with self._lock:
            return id(item) in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        return len(self) > 0

    def items(self) -> Iterator[Any]:
        """Snapshot of queued items (any order)."""
        with self._lock:
            return iter([e.item for e in self._entries.values()])

    # -- service-rate estimation & feasibility ---------------------------------

    def observe_service(self, cost: float, seconds: float) -> None:
        """Fold one service observation (``cost`` units completed over
        ``seconds`` of wall time) into the decayed drain-rate estimate.
        Zero-completion observations are valid — they pull the rate down
        during stalls."""
        if seconds <= 0 or cost < 0:
            return
        with self._lock:
            d = self.policy.rate_decay
            self._rate_num = d * self._rate_num + cost
            self._rate_den = d * self._rate_den + seconds

    def service_rate(self) -> float | None:
        """Estimated drain rate (cost units/second); None before any
        observation."""
        with self._lock:
            return self._rate_locked()

    def _rate_locked(self) -> float | None:
        if self._rate_den <= 0.0 or self._rate_num <= 0.0:
            return None
        return self._rate_num / self._rate_den

    def estimate_wait(self, priority: str | None = None) -> float | None:
        """Expected queue wait (seconds) for a NEW request of the given
        class: work that will run before it ÷ drain rate. None while the
        rate is unmeasured."""
        prio = priority or self.policy.default_priority
        with self._lock:
            return self._estimate_wait_locked(prio)

    def _estimate_wait_locked(self, priority: str) -> float | None:
        rate = self._rate_locked()
        if rate is None:
            return None
        rank = CLASS_RANK[priority]
        ahead = sum(e.cost for e in self._front) + sum(
            self._bands[c].cost_total
            for c in PRIORITY_CLASSES
            if CLASS_RANK[c] <= rank
        )
        return ahead / rate

    def retry_after(self) -> float:
        """Computed backoff hint: total queued cost ÷ drain rate, clamped
        to the policy's [min, max]. Meaningful even when the rate is
        unmeasured (the min clamp)."""
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        rate = self._rate_locked()
        total = sum(e.cost for e in self._front) + sum(
            b.cost_total for b in self._bands.values()
        )
        if rate is None or rate <= 0:
            est = 0.0
        else:
            est = total / rate
        return min(
            max(est, self.policy.min_retry_after_s),
            self.policy.max_retry_after_s,
        )

    # -- introspection ---------------------------------------------------------

    def class_depths(self) -> dict[str, int]:
        with self._lock:
            depths = {c: self._bands[c].depth for c in PRIORITY_CLASSES}
            for e in self._front:
                if not e.removed:
                    depths[e.priority] += 1
            return depths

    def oldest_wait(self) -> float:
        """Age (seconds) of the oldest queued request, 0 when empty —
        the queue-pressure signal the autoscaler consumes."""
        with self._lock:
            now = self._clock()
            oldest = 0.0
            for e in self._entries.values():
                if not e.removed:
                    oldest = max(oldest, now - e.t_enqueue)
            return oldest

    def snapshot(self) -> dict:
        """Serving-state snapshot for /metrics and /v1/state: per-class
        depth / oldest-waiter age / admitted / shed / mean queue wait,
        plus the drain-rate estimate and the current retry hint."""
        with self._lock:
            now = self._clock()
            classes = {}
            oldest_by_class = {c: 0.0 for c in PRIORITY_CLASSES}
            for e in self._entries.values():
                if not e.removed:
                    age = max(0.0, now - e.t_enqueue)
                    if age > oldest_by_class[e.priority]:
                        oldest_by_class[e.priority] = age
            depths = {c: self._bands[c].depth for c in PRIORITY_CLASSES}
            for e in self._front:
                if not e.removed:
                    depths[e.priority] += 1
            for c in PRIORITY_CLASSES:
                admitted = self._admitted[c]
                classes[c] = {
                    "depth": depths[c],
                    "oldest_wait_s": oldest_by_class[c],
                    "admitted_total": admitted,
                    "shed_total": self._shed[c],
                    "mean_queue_wait_s": (
                        self._wait_sum[c] / admitted if admitted else 0.0
                    ),
                }
            rate = self._rate_locked()
            return {
                "classes": classes,
                "depth": sum(depths.values()),
                "oldest_wait_s": max(oldest_by_class.values(), default=0.0),
                "service_rate": rate if rate is not None else 0.0,
                "retry_after_s": self._retry_after_locked(),
            }
