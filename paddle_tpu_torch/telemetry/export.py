"""Metrics and span push exporters.

Ported from the JAX package's ``telemetry/export.py`` (stdlib plus the
registry; the payloads are the JAX package's, key for key).

Periodically POSTs the process registry to PADDLE_METRICS_PUSH_URL:

  * JSON mode (default): the registry's snapshot() — already OTLP-shaped
    ({name: {type, series: [{labels, value|summary}]}}) — wrapped with a
    resource block (rank/pid/job), for OTLP-ish JSON collectors.
  * Prometheus mode: the text exposition, for a Prometheus pushgateway.
    Selected when the URL contains "/metrics/job" (the pushgateway path
    convention) or PADDLE_METRICS_PUSH_FORMAT=prom; pushgateway merges
    by job/instance labels in the URL, so the caller encodes those.

Delivery contract: one POST per interval (PADDLE_METRICS_PUSH_SECS,
default 15s), bounded retry on failure — PADDLE_METRICS_PUSH_RETRIES
attempts (default 3) with exponential backoff + jitter — then the
sample is DROPPED and counted (metrics_push_failures_total); the next
interval pushes fresh state, so a dead collector costs bounded work and
zero unbounded queueing. Flag-off (env unset) = zero network, zero
threads, one env read per process.

Span batches: PADDLE_TRACES_PUSH_URL arms a SECOND exporter instance
pushing OTLP-trace-shaped JSON (resourceSpans/scopeSpans with
traceId/spanId/parentSpanId and unix-nano timestamps) drained from the
tracing ring since the last successful cursor — same bounded-retry
sender, same drop-and-count contract (PADDLE_TRACES_PUSH_SECS /
_RETRIES). Env unset = zero network; tracing off = the batch is always
empty and no POST is sent.

``start_fleet`` is the launcher-side aggregated push over the
coordinator's fleet rollup; the port's launcher does not arm it yet
(its fleet half is ROADMAP A8).

stdlib-only (urllib) by design: the pserver and launcher can push too.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional

from .registry import get_registry

ENV_URL = "PADDLE_METRICS_PUSH_URL"
ENV_SECS = "PADDLE_METRICS_PUSH_SECS"
ENV_RETRIES = "PADDLE_METRICS_PUSH_RETRIES"
ENV_FORMAT = "PADDLE_METRICS_PUSH_FORMAT"

ENV_TRACES_URL = "PADDLE_TRACES_PUSH_URL"
ENV_TRACES_SECS = "PADDLE_TRACES_PUSH_SECS"
ENV_TRACES_RETRIES = "PADDLE_TRACES_PUSH_RETRIES"

_exporter: Optional["PushExporter"] = None
_checked = False
_trace_exporter: Optional["PushExporter"] = None
_trace_checked = False
_lock = threading.Lock()


class PushExporter:
    """Daemon-thread periodic pusher. start() is idempotent; flush()
    pushes one sample synchronously (tests and atexit-style final
    pushes). body_fn overrides the payload function (the span exporter
    plugs its OTLP-trace batches in; returning None skips the POST —
    nothing new to ship this interval)."""

    def __init__(self, url: str, interval_s: float = 15.0,
                 retries: int = 3, fmt: Optional[str] = None,
                 timeout_s: float = 5.0, backoff_s: float = 0.2,
                 body_fn=None, counter_prefix: str = "metrics"):
        self.url = url
        self.interval_s = max(0.05, float(interval_s))
        self.retries = max(1, int(retries))
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        if fmt is None:
            fmt = "prom" if "/metrics/job" in url else "json"
        self.fmt = fmt
        self.body_fn = body_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._pushed = reg.counter(
            f"{counter_prefix}_push_total",
            f"successful {counter_prefix} pushes")
        self._failed = reg.counter(
            f"{counter_prefix}_push_failures_total",
            f"{counter_prefix} samples dropped after the bounded "
            f"retry budget")

    # -- payload ---------------------------------------------------------
    def _body(self):
        if self.body_fn is not None:
            return self.body_fn()
        if self.fmt == "prom":
            return (get_registry().to_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        payload = {
            "resource": {
                "job": os.environ.get("PADDLE_JOB_NAME", "paddle_tpu"),
                "rank": os.environ.get("PADDLE_TRAINER_ID"),
                "role": os.environ.get("PADDLE_TRAINING_ROLE"),
                "pid": os.getpid(),
            },
            "ts": round(time.time(), 6),
            "metrics": get_registry().snapshot(),
        }
        return json.dumps(payload).encode(), "application/json"

    # -- delivery --------------------------------------------------------
    def _post_once(self, body: bytes, ctype: str) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()

    def flush(self) -> bool:
        """Push one sample now; True on delivery, False when the retry
        budget is exhausted (the sample is dropped and counted). A
        body_fn returning None means nothing to ship — no POST, still
        True."""
        built = self._body()
        if built is None:
            return True
        body, ctype = built
        for attempt in range(self.retries):
            try:
                self._post_once(body, ctype)
                self._pushed.inc()
                return True
            except Exception:  # noqa: BLE001 — collector down/unreachable
                if attempt + 1 >= self.retries:
                    break
                # exp backoff + jitter: a fleet of ranks whose collector
                # hiccuped must not retry in lockstep
                delay = self.backoff_s * (2 ** attempt)
                self._stop.wait(delay * (0.5 + random.random()))
                if self._stop.is_set():
                    break
        self._failed.inc()
        return False

    # -- lifecycle -------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.flush()

    def start(self) -> "PushExporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="paddle-tpu-metrics-push")
            self._thread.start()
        return self

    def stop(self, final_flush: bool = False):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if final_flush:
            self.flush()


def start(url: str, **kwargs) -> PushExporter:
    """Explicit start (programmatic alternative to the env contract)."""
    global _exporter, _checked
    with _lock:
        if _exporter is not None:
            _exporter.stop()
        _exporter = PushExporter(url, **kwargs).start()
        _checked = True
        return _exporter


def maybe_start() -> Optional[PushExporter]:
    """Arm from PADDLE_METRICS_PUSH_URL; resolved once per process.
    Unset = None and never another env read."""
    global _exporter, _checked
    if _checked:
        return _exporter
    with _lock:
        if _checked:
            return _exporter
        _checked = True
        url = os.environ.get(ENV_URL)
        if not url:
            return None
        _exporter = PushExporter(
            url,
            interval_s=float(os.environ.get(ENV_SECS, "15") or 15),
            retries=int(os.environ.get(ENV_RETRIES, "3") or 3),
            fmt=(os.environ.get(ENV_FORMAT) or None),
        ).start()
        return _exporter


def active() -> Optional[PushExporter]:
    return _exporter


# ---------------------------------------------------------------------------
# span batches
# ---------------------------------------------------------------------------


def spans_to_otlp(spans, resource: Optional[dict] = None) -> dict:
    """Ring-format span dicts -> OTLP/JSON trace shape (resourceSpans /
    scopeSpans; ids hex, times unix-nano, attrs as key/value pairs) —
    what an OTLP-JSON collector ingests."""
    def attr(k, v):
        if isinstance(v, bool):
            return {"key": k, "value": {"boolValue": v}}
        if isinstance(v, int):
            return {"key": k, "value": {"intValue": str(v)}}
        if isinstance(v, float):
            return {"key": k, "value": {"doubleValue": v}}
        return {"key": k, "value": {"stringValue": str(v)}}

    res = {
        "job": os.environ.get("PADDLE_JOB_NAME", "paddle_tpu"),
        "rank": os.environ.get("PADDLE_TRAINER_ID"),
        "role": os.environ.get("PADDLE_TRAINING_ROLE"),
        "pid": os.getpid(),
    }
    res.update(resource or {})
    otlp_spans = []
    for s in spans:
        start_ns = int(s["ts"] * 1e9)
        span = {
            "traceId": s["trace"],
            "spanId": s["span"],
            "name": s["name"],
            "kind": s.get("kind", "internal"),
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + int(s["dur_ms"] * 1e6)),
            "attributes": [attr(k, v)
                           for k, v in (s.get("attrs") or {}).items()],
            "status": {"code": ("STATUS_CODE_OK"
                                if s.get("status", "ok") == "ok"
                                else "STATUS_CODE_ERROR"),
                       "message": s.get("status", "ok")},
        }
        if s.get("parent"):
            span["parentSpanId"] = s["parent"]
        otlp_spans.append(span)
    return {
        "resourceSpans": [{
            "resource": {"attributes": [attr(k, v) for k, v in res.items()
                                        if v is not None]},
            "scopeSpans": [{
                "scope": {"name": "paddle_tpu.telemetry.tracing"},
                "spans": otlp_spans,
            }],
        }],
    }


def _traces_body_fn():
    """Stateful payload function: drains spans recorded since the last
    build. The cursor advances at BUILD time — a batch the retry budget
    then drops is gone (bounded loss, matching the metrics contract)."""
    state = {"seq": 0}

    def body():
        from . import tracing

        spans, state["seq"] = tracing.export_batch(state["seq"])
        if not spans:
            return None  # nothing new: skip the POST entirely
        return (json.dumps(spans_to_otlp(spans)).encode(),
                "application/json")

    return body


def start_traces(url: str, **kwargs) -> PushExporter:
    """Explicit span-exporter start (tests / programmatic)."""
    global _trace_exporter, _trace_checked
    with _lock:
        if _trace_exporter is not None:
            _trace_exporter.stop()
        _trace_exporter = PushExporter(
            url, body_fn=_traces_body_fn(), counter_prefix="traces",
            **kwargs).start()
        _trace_checked = True
        return _trace_exporter


def maybe_start_traces() -> Optional[PushExporter]:
    """Arm span pushing from PADDLE_TRACES_PUSH_URL; resolved once per
    process. Unset = None, zero network, and never another env read."""
    global _trace_exporter, _trace_checked
    if _trace_checked:
        return _trace_exporter
    with _lock:
        if _trace_checked:
            return _trace_exporter
        _trace_checked = True
        url = os.environ.get(ENV_TRACES_URL)
        if not url:
            return None
        _trace_exporter = PushExporter(
            url,
            interval_s=float(os.environ.get(ENV_TRACES_SECS, "15") or 15),
            retries=int(os.environ.get(ENV_TRACES_RETRIES, "3") or 3),
            body_fn=_traces_body_fn(), counter_prefix="traces",
        ).start()
        return _trace_exporter


def active_traces() -> Optional[PushExporter]:
    return _trace_exporter


# ---------------------------------------------------------------------------
# fleet push
# ---------------------------------------------------------------------------


_fleet_exporter: Optional[PushExporter] = None


def _fleet_body_fn(status_fn, metrics_fn=None):
    """Payload function for the launcher-side fleet exporter: ONE
    aggregated snapshot — the coordinator's merged fleet rollup plus
    (optionally) the fleet Prometheus text — instead of N per-rank
    POSTs."""

    def body():
        fleet = status_fn()
        if not fleet or not fleet.get("ranks"):
            return None  # nothing renewed yet: skip the POST
        payload = {
            "resource": {
                "job": os.environ.get("PADDLE_JOB_NAME", "paddle_tpu"),
                "role": "launcher",
                "pid": os.getpid(),
            },
            "ts": round(time.time(), 6),
            "fleet": fleet,
        }
        if metrics_fn is not None:
            try:
                payload["exposition"] = metrics_fn()
            except Exception:  # noqa: BLE001 — rollup still ships
                pass
        return json.dumps(payload, default=str).encode(), "application/json"

    return body


def start_fleet(url: str, status_fn, metrics_fn=None,
                **kwargs) -> PushExporter:
    """Launcher-side aggregated push: when PADDLE_METRICS_PUSH_URL is
    set fleet-wide, launch.py calls this with the coordinator's
    fleet_status/fleet_metrics and STRIPS the env from the children —
    one coordinator POST per interval replaces N per-rank pushes
    (per-rank mode is unchanged when fleet aggregation is not armed;
    env unset = zero network, as today)."""
    global _fleet_exporter
    with _lock:
        if _fleet_exporter is not None:
            _fleet_exporter.stop()
        _fleet_exporter = PushExporter(
            url, body_fn=_fleet_body_fn(status_fn, metrics_fn),
            counter_prefix="fleet_metrics", **kwargs).start()
        return _fleet_exporter


def active_fleet() -> Optional[PushExporter]:
    return _fleet_exporter


def stop():
    """Tests: tear down and allow re-arming (all exporters)."""
    global _exporter, _checked, _trace_exporter, _trace_checked
    global _fleet_exporter
    with _lock:
        if _exporter is not None:
            _exporter.stop()
        _exporter = None
        _checked = False
        if _trace_exporter is not None:
            _trace_exporter.stop()
        _trace_exporter = None
        _trace_checked = False
        if _fleet_exporter is not None:
            _fleet_exporter.stop()
        _fleet_exporter = None
