"""Computed, jittered ``Retry-After`` values — one helper for every
shed path. Counterpart of kubeai_tpu/utils/retryafter.py, copied
without `parse_header` (the routing proxy's reader).

Three layers answer 429/503 with a retry hint: the engine scheduler's
admission shed, the engine's drain refusal, and the front door's tenant
admission layer (kubeai_tpu/fleet/tenancy). All of them must obey the
same contract:

  * the hint is COMPUTED from measured state (queue drain estimate,
    remaining drain budget, bucket refill time, window reset) — never a
    magic constant;
  * it is clamped into a useful band: not 0 (a zero tells clients to
    hammer), not unbounded (an hour-long window reset should not tell a
    client to vanish for an hour — by then capacity has moved);
  * it is jittered with the proxy's factor (``base * (0.5 + 0.5*r)``,
    kubeai_tpu/routing/proxy.py) so a shed burst does not resynchronize
    into a retry burst.

``_jitter`` is module-level and monkeypatchable, the same seam the
proxy exposes — tests pin it to make every hint deterministic.
"""

from __future__ import annotations

import math
import random

MIN_RETRY_AFTER_S = 0.25
MAX_RETRY_AFTER_S = 300.0

# Jitter source (monkeypatchable in tests, like routing.proxy._jitter).
_jitter = random.random


def clamp(seconds, min_s: float = MIN_RETRY_AFTER_S,
          max_s: float = MAX_RETRY_AFTER_S) -> float:
    """Sanitize a computed wait estimate into the useful band. Garbage
    in (None, NaN, inf, negative, zero, non-numeric) floors to
    ``min_s`` — a broken estimate must degrade to "retry soon", never
    to "retry never" or "retry now"."""
    try:
        s = float(seconds)
    except (TypeError, ValueError):
        s = min_s
    if not math.isfinite(s) or s <= 0.0:
        s = min_s
    return min(max(s, min_s), max_s)


def jittered(seconds, min_s: float = MIN_RETRY_AFTER_S,
             max_s: float = MAX_RETRY_AFTER_S) -> float:
    """Clamp, then apply the proxy's jitter factor. The result stays
    within [min_s, max_s]: jitter spreads retries, it must not push the
    hint below the floor the clamp just enforced."""
    base = clamp(seconds, min_s=min_s, max_s=max_s)
    return min(max(base * (0.5 + 0.5 * _jitter()), min_s), max_s)


def format_header(seconds) -> str:
    """Render a wait as a ``Retry-After`` header value (fractional
    seconds; RFC 7231 specifies delta-seconds and every client we front
    parses floats)."""
    try:
        s = float(seconds)
    except (TypeError, ValueError):
        s = MIN_RETRY_AFTER_S
    if not math.isfinite(s) or s < 0.0:
        s = MIN_RETRY_AFTER_S
    return f"{s:.3f}"

