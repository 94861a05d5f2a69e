"""Process-wide metrics registry: counters, gauges, histograms.

Design targets: one registry shared by the executor, the PS
data plane, hapi callbacks and bench.py, so production telemetry and
BENCH_* numbers flow through the same code path; a Prometheus-style
text exposition for scrapers; fixed histogram bucket boundaries so two
processes' histograms merge by plain addition.

Hot-path cost: a counter inc is one dict lookup + one int add under a
lock-free fast path (the instance lock is only taken by histograms and
snapshot/exposition readers). Nothing here touches the filesystem —
the JSONL sink (telemetry.sink) is the only I/O layer, and it is off
unless PADDLE_METRICS_PATH is set.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# default latency buckets (ms): sub-ms host ops through multi-minute
# compiles. Fixed boundaries — see module docstring.
DEFAULT_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000, 60000, 300000,
)

# byte-size buckets for RPC payloads (1KiB .. 1GiB)
BYTE_BUCKETS = tuple(float(2 ** p) for p in range(10, 31, 2))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus text exposition escaping for label VALUES: backslash,
    double-quote and newline (exposition format 0.0.4 spec) — a path or
    free-text label must not tear the sample line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labelkey) -> str:
    if not labelkey:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labelkey)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count. `.value` is exact under the GIL
    (int += is a single bytecode-visible read-modify-write per thread;
    contended increments may interleave but never tear)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value (float)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def set_max(self, v: float) -> None:
        """High-water update: keep the larger of the current and new
        value (e.g. peak checkpoint save lag)."""
        v = float(v)
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-boundary histogram: per-bucket counts (non-cumulative
    internally; the exposition emits Prometheus cumulative `le`
    buckets), plus sum/count/min/max for cheap summaries.

    Exemplar: observe(v, trace_id=...) remembers the trace of
    the sample currently sitting in the TOP occupied bucket (the running
    max), so a scrape of a latency histogram hands the operator a
    trace_id to feed straight into tools/tracetop.py. Surfaced in the
    OpenMetrics `# {trace_id="..."} v ts` exemplar syntax on the
    matching _bucket line, and in summary()/snapshot(). Callers that
    never pass a trace_id (tracing off) leave the exposition and the
    summary byte-identical to the pre-exemplar format."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max",
                 "exemplar", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted ascending")
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None
        self.exemplar: Optional[dict] = None
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        v = float(v)
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # first bucket boundary >= v
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.sum += v
            self.count += 1
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if trace_id is not None and (
                    self.exemplar is None or v >= self.exemplar["value"]):
                self.exemplar = {"trace_id": str(trace_id),
                                 "value": v,
                                 "ts": round(time.time(), 3)}

    def summary(self) -> dict:
        """count/sum/min/max/avg. An EMPTY histogram reports zeros, not
        Nones — consumers (debugz pages, exporters, report arithmetic)
        must never have to None-guard a summary field."""
        with self._lock:
            out = {
                "count": self.count,
                "sum": round(self.sum, 6),
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
                "avg": round(self.sum / self.count, 6) if self.count else 0.0,
            }
            if self.exemplar is not None:
                out["exemplar"] = dict(self.exemplar)
            return out

    def quantile(self, q: float) -> float:
        """Bucket-boundary estimate of the q-quantile (upper boundary of
        the bucket containing it); max for the overflow bucket. An empty
        histogram reports 0.0 — well-defined instead of None-propagating
        into consumers."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= target:
                    return self.buckets[i] if i < len(self.buckets) else self.max
            return self.max


class MetricsRegistry:
    """name (+ labels) -> metric. get-or-create accessors; a name may
    only ever hold one metric type (a counter re-declared as a gauge is
    a bug, raised loudly)."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (type, help, {labelkey: metric})
        self._metrics: Dict[str, tuple] = {}

    def _get(self, name: str, kind: str, help_: str, factory, labels):
        key = _label_key(labels or {})
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = (kind, help_, {})
                self._metrics[name] = ent
            elif ent[0] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {ent[0]}, "
                    f"not {kind}")
            series = ent[2]
            m = series.get(key)
            if m is None:
                m = series[key] = factory()
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, Counter, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, Gauge, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(
            name, "histogram", help, lambda: Histogram(buckets), labels)

    def reset(self) -> None:
        """Drop every metric (tests / per-job reuse)."""
        with self._lock:
            self._metrics.clear()

    # -- read side -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready dump: {name: {type, series: [{labels, ...}]}}.
        Histograms dump their summary (count/sum/min/max/avg), not raw
        buckets — the exposition format carries the full buckets."""
        with self._lock:
            items = [(n, k, h, dict(s)) for n, (k, h, s)
                     in self._metrics.items()]
        out = {}
        for name, kind, _help, series in items:
            rows = []
            for labelkey, m in sorted(series.items()):
                row = {"labels": dict(labelkey)}
                if kind == "histogram":
                    row.update(m.summary())
                else:
                    row["value"] = m.value
                rows.append(row)
            out[name] = {"type": kind, "series": rows}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): HELP/TYPE headers,
        one sample line per series; histograms as cumulative _bucket
        series with an +Inf bucket plus _sum/_count."""
        with self._lock:
            items = [(n, k, h, dict(s)) for n, (k, h, s)
                     in self._metrics.items()]
        lines: List[str] = []
        for name, kind, help_, series in sorted(items):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labelkey, m in sorted(series.items()):
                if kind != "histogram":
                    lines.append(f"{name}{_fmt_labels(labelkey)} {m.value}")
                    continue
                with m._lock:
                    counts, total, s = list(m.counts), m.count, m.sum
                    ex = dict(m.exemplar) if m.exemplar else None
                acc = 0
                for b, c in zip(m.buckets, counts):
                    acc += c
                    lk = labelkey + (("le", f"{b:g}"),)
                    line = f"{name}_bucket{_fmt_labels(lk)} {acc}"
                    if ex is not None and ex["value"] <= b:
                        # OpenMetrics exemplar on the bucket holding the
                        # slowest traced sample; emitted once
                        line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                                 f'{ex["value"]:g} {ex["ts"]}')
                        ex = None
                    lines.append(line)
                lk = labelkey + (("le", "+Inf"),)
                line = f"{name}_bucket{_fmt_labels(lk)} {total}"
                if ex is not None:  # landed in the overflow bucket
                    line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{ex["value"]:g} {ex["ts"]}')
                lines.append(line)
                lines.append(f"{name}_sum{_fmt_labels(labelkey)} {s}")
                lines.append(f"{name}_count{_fmt_labels(labelkey)} {total}")
        return "\n".join(lines) + ("\n" if lines else "")


# THE process-wide registry (the executor, PS plane, hapi and bench all
# share it; tests that need isolation construct their own or reset())
_global = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _global
