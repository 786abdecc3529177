"""Minimal Prometheus-compatible metrics (text exposition format 0.0.4).
Counterpart of kubeai_tpu/metrics/registry.py: the instruments, the
registry, `TracingDroppedSpans`, `lint_registry`, `hist_buckets` and
`parse_prometheus_text`, copied so that the port's exposition text is
the JAX package's byte for byte. The operator's `Metrics` bundle and the
object-store counter are not ported."""

from __future__ import annotations

import re
import threading
from collections import defaultdict


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92)*2).replace(chr(34), chr(92)+chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Exposition value: integral floats render bare (`25`, not `25.0`);
    everything else uses repr's shortest round-trip form so large counters
    survive expose() → parse (the %g default truncates past 6 digits)."""
    if v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _fmt_le(bound: float) -> str:
    """Canonical `le` label value: `%g`-style (`0.005`, `1`, `+Inf`) so
    int and float bucket bounds render identically."""
    b = float(bound)
    if b == float("inf"):
        return "+Inf"
    return f"{b:g}"


class _Metric:
    def __init__(self, name: str, help_: str, registry: "Registry | None"):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = defaultdict(float)
        self._label_keys: dict[tuple, dict] = {}
        if registry is not None:
            registry.register(self)

    def _key(self, labels: dict[str, str]) -> tuple:
        k = tuple(sorted(labels.items()))
        self._label_keys[k] = labels
        return k

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def collect(self) -> list[str]:
        with self._lock:
            lines = [
                f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.TYPE}",
            ]
            if not self._values:
                lines.append(f"{self.name} 0")
            for k, v in sorted(self._values.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(self._label_keys[k])} "
                    f"{_fmt_value(v)}"
                )
            return lines


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] += amount


class TracingDroppedSpans(Counter):
    """Live view of the process tracer's dropped-span count (export
    queue full, or exporter thread dead). Synced at collect time, so the
    engine's registry exposes it without the tracer knowing about
    registries."""

    def collect(self) -> list[str]:
        from kubeai_tpu_torch.metrics import tracing

        t = tracing._default
        dropped = float(t.dropped) if t is not None else 0.0
        with self._lock:
            self._values[self._key({})] = dropped
        return super().collect()


class ObjstoreRetries(Counter):
    """Live view of the object-store layer's transient-failure retry
    count (5xx/429, connection resets, short reads). Synced from
    `objstore.RETRIES` at collect time, as TracingDroppedSpans is."""

    def collect(self) -> list[str]:
        from kubeai_tpu_torch import objstore

        with self._lock:
            self._values[self._key({})] = float(objstore.RETRIES["total"])
        return super().collect()


class Gauge(_Metric):
    TYPE = "gauge"

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value


class Histogram(_Metric):
    TYPE = "histogram"
    BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name, help_, registry, buckets=None):
        super().__init__(name, help_, registry)
        self.buckets = tuple(buckets or self.BUCKETS)
        self._bucket_counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._counts: dict[tuple, int] = defaultdict(int)
        # Last exemplar (trace/request id) per bucket per label set —
        # index len(buckets) is the +Inf overflow bucket. Deliberately
        # NOT emitted in the 0.0.4 text exposition (parsers here and in
        # the fleet would choke on OpenMetrics `# {...}` suffixes);
        # consumers read them via exemplars() / the admin state payloads.
        self._exemplars: dict[tuple, dict[int, str]] = {}

    def observe(self, value: float, exemplar: str | None = None,
                **labels) -> None:
        with self._lock:
            k = self._key(labels)
            if k not in self._bucket_counts:
                self._bucket_counts[k] = [0] * len(self.buckets)
            # Per-bucket (non-cumulative) counts: only the first bucket
            # that fits increments; collect() produces the cumulative
            # `le` series. Incrementing every bucket >= value here would
            # double-cumulate at collect time.
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._bucket_counts[k][i] += 1
                    idx = i
                    break
            self._sums[k] += value
            self._counts[k] += 1
            if exemplar:
                self._exemplars.setdefault(k, {})[idx] = str(exemplar)

    def exemplars(self, **labels) -> dict[str, str]:
        """Last exemplar per bucket for the label set, keyed by the
        bucket's canonical `le` string (`+Inf` for the overflow bucket)."""
        with self._lock:
            per_idx = self._exemplars.get(tuple(sorted(labels.items())), {})
            out: dict[str, str] = {}
            for idx, ex in sorted(per_idx.items()):
                bound = (
                    "+Inf" if idx >= len(self.buckets)
                    else _fmt_le(self.buckets[idx])
                )
                out[bound] = ex
            return out

    def get(self, **labels) -> float:
        """Observation COUNT for the label set (the scalar `_Metric.get`
        would silently read the unused `_values` dict and always say 0)."""
        with self._lock:
            return float(self._counts.get(tuple(sorted(labels.items())), 0))

    def collect(self) -> list[str]:
        with self._lock:
            lines = [
                f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} histogram",
            ]
            for k in sorted(self._counts):
                labels = self._label_keys[k]
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += self._bucket_counts[k][i]
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels({**labels, 'le': _fmt_le(b)})} {cum}"
                    )
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**labels, 'le': '+Inf'})} {self._counts[k]}"
                )
                lines.append(
                    f"{self.name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(self._sums[k])}"
                )
                lines.append(
                    f"{self.name}_count{_fmt_labels(labels)} {self._counts[k]}"
                )
            return lines


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, m: _Metric) -> None:
        with self._lock:
            self._metrics.append(m)

    @property
    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics)

    def expose(self) -> str:
        out: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            out.extend(m.collect())
        return "\n".join(out) + "\n"


_METRIC_NAME_RE = re.compile(r"^kubeai_[a-z0-9_]+$")


def lint_registry(registry: Registry) -> list[str]:
    """Metric-name hygiene for one registry: names match
    `^kubeai_[a-z0-9_]+$` and are unique, counters end in `_total`,
    histograms in `_seconds`. Returns human-readable violations (empty =
    clean); a unit test walks every instrument bundle through this so new
    instruments can't silently drift from the naming scheme."""
    errors: list[str] = []
    seen: set[str] = set()
    for m in registry.metrics:
        if not _METRIC_NAME_RE.match(m.name):
            errors.append(
                f"{m.name}: does not match ^kubeai_[a-z0-9_]+$"
            )
        if m.name in seen:
            errors.append(f"{m.name}: duplicate metric name in registry")
        seen.add(m.name)
        if isinstance(m, Histogram):
            if not m.name.endswith("_seconds"):
                errors.append(f"{m.name}: histogram must end in _seconds")
        elif isinstance(m, Counter):
            if not m.name.endswith("_total"):
                errors.append(f"{m.name}: counter must end in _total")
    return errors


def hist_buckets(
    parsed: dict, name: str
) -> tuple[list[tuple[float, float]], float, float]:
    """Extract one histogram's cumulative buckets from a parsed scrape:
    (sorted [(upper_bound, cumulative_count)], total_count, total_sum).
    Labels beyond `le` are ignored (one endpoint exposes one series per
    histogram); unparseable `le` values are skipped."""
    buckets: list[tuple[float, float]] = []
    total = 0.0
    total_sum = 0.0
    for (metric, labels), value in parsed.items():
        if metric == f"{name}_bucket":
            le = dict(labels).get("le", "")
            try:
                bound = float(le)
            except ValueError:
                continue
            buckets.append((bound, value))
        elif metric == f"{name}_count":
            total = value
        elif metric == f"{name}_sum":
            total_sum = value
    buckets.sort(key=lambda b: b[0])
    return buckets, total, total_sum


def parse_prometheus_text(text: str) -> dict[tuple[str, tuple], float]:
    """Parse exposition text into {(metric, ((label,val),...)): value} —
    the scrape decoder behind the autoscaler and the fleet aggregator
    (reference: modelautoscaler/metrics.go).

    Tolerates real-world exposition the aggregator will meet on the
    wire: `+Inf`/`NaN` sample values, exponent-format floats, trailing
    millisecond timestamps after the value, and `}`/whitespace inside
    quoted label values. Unparseable lines are skipped, never raised —
    one weird family must not blind the whole scrape."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        labels: list[tuple[str, str]] = []
        brace = line.find("{")
        if brace != -1 and (
            " " not in line[:brace] and "\t" not in line[:brace]
        ):
            name = line[:brace]
            closed = _find_label_close(line, brace + 1)
            if closed < 0:
                continue  # unterminated label block
            for pair in _split_label_pairs(line[brace + 1:closed]):
                if "=" not in pair:
                    continue
                k, v = pair.split("=", 1)
                labels.append((k.strip(), _unquote_label_value(v)))
            tail = line[closed + 1:]
        else:
            name, _, tail = line.partition(" ")
        parts = tail.split()
        if not name or not parts:
            continue
        try:
            # float() natively accepts +Inf/-Inf/NaN and exponent forms.
            value = float(parts[0])
        except ValueError:
            continue
        # parts[1], when present, is the optional sample timestamp — it
        # must not be mistaken for the value (the old rsplit was).
        out[(name, tuple(sorted(labels)))] = value
    return out


def _find_label_close(line: str, start: int) -> int:
    """Index of the `}` closing the label block opened before `start`,
    honoring quotes and backslash escapes (a quoted label value may
    legally contain `}`). -1 when unterminated."""
    in_q = esc = False
    for i in range(start, len(line)):
        ch = line[i]
        if esc:
            esc = False
        elif ch == "\\" and in_q:
            esc = True
        elif ch == '"':
            in_q = not in_q
        elif ch == "}" and not in_q:
            return i
    return -1


def _split_label_pairs(s: str) -> list[str]:
    """Split `k1="v1",k2="v2"` on commas outside quoted values. Tracks
    the backslash escape state: an escaped quote (`\\"`) inside a value —
    which `_fmt_labels`'s own escaping produces — must NOT toggle the
    in-quotes flag, or every value containing a quote fails to
    round-trip through `parse_prometheus_text`."""
    pairs, cur, in_q, esc = [], "", False, False
    for ch in s:
        if esc:
            cur += ch
            esc = False
        elif ch == "\\" and in_q:
            cur += ch
            esc = True
        elif ch == '"':
            in_q = not in_q
            cur += ch
        elif ch == "," and not in_q:
            pairs.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        pairs.append(cur)
    return pairs


def _unquote_label_value(v: str) -> str:
    """Strip one layer of quotes and undo exposition-format escaping
    (`\\\\` → `\\`, `\\"` → `"`, `\\n` → newline)."""
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        v = v[1:-1]
    out, i = [], 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)
