"""Goodput/badput ledger: the part of the JAX package's
``telemetry/goodput.py`` that the generation engine calls.

Each process classifies wall-clock time into the BUCKETS below; the
window between consecutive classification points is authoritative
(measured phase times are scaled down if they overlap it, the
un-measured remainder is `idle`), so the bucket totals sum to wall time
exactly.  Rows are appended one JSON line at a time to
`<PADDLE_GOODPUT_DIR|PADDLE_TRACE_DIR>/goodput.<tag>.<inc>.jsonl`
(inc = PADDLE_ELASTIC_RESTART), in the reference's format.

The engine charges serving badput through `note_serving_badput`: time a
request burned before being shed or expiring, waiting off-device after a
preemption, or re-prefilling a resumed prefix.  The reference's training
hooks (step commits, abandoned steps, restores, stalls), its fleet
aggregation and its offline stitching (goodtop) are not here: they come
with the executor, the launcher and the coordinator.

Env contract:

  PADDLE_GOODPUT=1          arm the ledger (off = zero cost, no files)
  PADDLE_GOODPUT_DIR        ledger directory (default PADDLE_TRACE_DIR;
                            neither set = in-memory totals only)
  PADDLE_GOODPUT_EVERY      kind="goodput" sink-record cadence (ledger
                            rows, default 20)

Module is stdlib-only.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from . import sink as _sink
from .registry import get_registry

ENV_GATE = "PADDLE_GOODPUT"
ENV_DIR = "PADDLE_GOODPUT_DIR"
ENV_EVERY = "PADDLE_GOODPUT_EVERY"

BUCKETS = (
    "productive_step",
    "data_wait",
    "compile",
    "checkpoint_save",
    "restart_recovery",
    "bad_step_replay",
    "stall",
    "idle",
    # serving replicas: wall-clock a request burned before being shed at
    # admission / expiring mid-decode
    "serve_shed",
    "serve_deadline",
    # preemption ladder: time a preempted generation spent off the
    # device waiting to re-admit, and the extra prefill the resume cost
    "serve_preempt",
    "serve_resume",
)

# wall time of module import, recorded in the birth row as the
# reference records it
_IMPORT_TS = time.time()

_enabled: Optional[bool] = None
_ledger: Optional["GoodputLedger"] = None
_lock = threading.Lock()


def enabled() -> bool:
    """PADDLE_GOODPUT gate, resolved once per process."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get(ENV_GATE, "") not in ("", "0", "false")
    return _enabled


def _process_tag() -> str:
    # the STABLE membership identity survives elastic resizes where the
    # rank numbering does not — ledger files must keep accumulating
    # under one tag across incarnations
    t = os.environ.get("PADDLE_TRAINER_TAG")
    if t:
        return t
    from . import tracing

    return tracing.process_tag()


class GoodputLedger:
    """Per-process interval classifier + per-incarnation JSONL file.

    The classification point is `_commit_window`: given the measured
    phase milliseconds since the previous point, the wall window is
    decomposed so the bucket totals sum to wall EXACTLY — measured
    phases are scaled down when they overlap the window (async writers),
    and the remainder lands in `residual_bucket` (normally `idle`)."""

    def __init__(self, tag: Optional[str] = None,
                 incarnation: Optional[int] = None,
                 directory: Optional[str] = None,
                 now: Optional[float] = None):
        self.tag = tag or _process_tag()
        if incarnation is None:
            try:
                incarnation = int(
                    os.environ.get("PADDLE_ELASTIC_RESTART", 0) or 0)
            except ValueError:
                incarnation = 0
        self.incarnation = int(incarnation)
        if directory is None:
            directory = (os.environ.get(ENV_DIR)
                         or os.environ.get("PADDLE_TRACE_DIR"))
        self.path = (os.path.join(
            directory, f"goodput.{self.tag}.{self.incarnation}.jsonl")
            if directory else None)
        now = time.time() if now is None else now
        self.t0 = now
        self._last_ts = now
        self.totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.steps = 0
        self._events = 0
        try:
            self._every = int(os.environ.get(ENV_EVERY, 20) or 20)
        except ValueError:
            self._every = 20
        self._lock = threading.Lock()
        self._f = None
        self._write({"event": "birth", "tag": self.tag,
                     "incarnation": self.incarnation, "pid": os.getpid(),
                     "ts": round(now, 6),
                     "import_ts": round(_IMPORT_TS, 6)})

    # -- persistence -----------------------------------------------------
    def _write(self, row: dict) -> None:
        if self.path is None:
            return
        try:
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a", buffering=1)
            self._f.write(json.dumps(row) + "\n")
        except OSError:
            # a full disk must never fail a training step; totals and
            # gauges keep accumulating in memory
            self.path = None

    # -- classification --------------------------------------------------
    def _commit_window(self, measured: Dict[str, float],
                       now: Optional[float] = None, event: str = "step",
                       residual_bucket: str = "idle", **extra) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            # a caller may capture `now` BEFORE this lazily-constructed
            # ledger stamps its own birth (monitor.py takes now_wall,
            # emits the step record, then commits here) — clamp so no
            # row ever runs backwards and windows stay wall-exact
            now = max(now, self._last_ts)
            wall = max(0.0, (now - self._last_ts) * 1e3)
            t_start = self._last_ts
            self._last_ts = now
            buckets = {b: max(0.0, float(measured.get(b, 0.0)))
                       for b in BUCKETS}
            s = sum(buckets.values())
            if s > wall:
                if s > 0:
                    # measured phases overlap the wall window (async
                    # overlap / coarse timers): scale down so the
                    # ledger stays wall-exact
                    k = wall / s
                    buckets = {b: v * k for b, v in buckets.items()}
            else:
                buckets[residual_bucket] += wall - s
            for b, v in buckets.items():
                self.totals[b] += v
            if event == "step":
                self.steps += 1
            self._events += 1
            row = {
                "event": event,
                "t0": round(t_start, 6),
                "t1": round(now, 6),
                "buckets": {b: round(v, 3)
                            for b, v in buckets.items() if v > 0},
            }
            row.update(extra)
            emit_summary = (self._events % self._every == 0)
        self._write(row)
        self._update_gauges()
        if emit_summary:
            _sink.emit(dict(self.summary(), kind="goodput",
                            event="summary"))
        return row

    def _update_gauges(self) -> None:
        reg = get_registry()
        total = sum(self.totals.values())
        prod = self.totals["productive_step"]
        reg.gauge("goodput_ratio",
                  help="productive fraction of classified wall-clock "
                       "(job-lifetime goodput, this incarnation)").set(
            prod / total if total > 0 else 0.0)
        for b in BUCKETS:
            if b == "productive_step":
                continue
            reg.gauge("badput_seconds_total",
                      help="classified non-productive wall-clock by "
                           "cause (seconds)",
                      cause=b).set(round(self.totals[b] / 1e3, 3))

    # -- entry points ----------------------------------------------------
    def note_serving_badput(self, ms: float, cause: str,
                            now: Optional[float] = None) -> None:
        """Serving-side SLO badput: wall-clock a request spent in the
        replica before being shed at admission (`cause="shed"`),
        expiring mid-decode (`cause="deadline"`), waiting off-device
        after a KV-pressure preemption (`cause="preempt"`), or
        re-prefilling a resumed prefix (`cause="resume"`)."""
        bucket = {
            "deadline": "serve_deadline",
            "preempt": "serve_preempt",
            "resume": "serve_resume",
        }.get(cause, "serve_shed")
        self._commit_window({bucket: float(ms)}, now=now,
                            event="serve_badput", cause=cause)

    # -- read side -------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            total = sum(self.totals.values())
            prod = self.totals["productive_step"]
            return {
                "tag": self.tag,
                "incarnation": self.incarnation,
                "t0": round(self.t0, 6),
                "t1": round(self._last_ts, 6),
                "steps": self.steps,
                "goodput_ratio": round(prod / total, 6) if total else None,
                "buckets_ms": {b: round(v, 3)
                               for b, v in self.totals.items()},
            }

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------------------------------
# module-level hooks (each a no-op costing one cached bool read when
# PADDLE_GOODPUT is off)
# ---------------------------------------------------------------------------


def get_ledger() -> Optional[GoodputLedger]:
    global _ledger
    if not enabled():
        return None
    if _ledger is None:
        with _lock:
            if _ledger is None:
                _ledger = GoodputLedger()
    return _ledger


def note_serving_badput(ms: float, cause: str) -> None:
    led = get_ledger()
    if led is not None:
        led.note_serving_badput(ms, cause=cause)


def summary() -> Optional[dict]:
    led = get_ledger()
    return led.summary() if led is not None else None


def reset_for_tests() -> None:
    global _enabled, _ledger
    with _lock:
        if _ledger is not None:
            _ledger.close()
        _ledger = None
    _enabled = None
