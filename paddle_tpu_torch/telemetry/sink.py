"""Per-step JSONL sink (PADDLE_METRICS_PATH).

One JSON object per line, append-only, flushed per record so a killed
process loses at most the in-flight line. Schema contract (stable —
tools and tests parse it):

  every record    {"kind": str, "ts": float unix seconds, "rank": int}
  kind="step"     step-time breakdown from fluid/monitor.py:
                  {"step": int monotone per process, "data_wait_ms",
                   "compile_ms", "device_ms", "fetch_ms", "ckpt_save_ms",
                   "idle_ms": float gap between consecutive
                   Executor.run calls (the goodput ledger's idle
                   signal; iterator wait in that gap also lands in
                   data_wait_ms — classification is by residual),
                   "cache_hit": bool, "retraces": int cumulative,
                   "peak_hbm_bytes": int}; under PADDLE_TRACING the
                  record additionally carries "trace_id" — the step's
                  root span in the tracing ring (telemetry/tracing.py)
  kind="bench"    one bench.py result row (same keys as its stdout JSON)
  kind="train_epoch"  hapi MetricsLogger epoch summary
  kind="ps_step"  one APPLIED pserver update (distributed/ps_server.py;
                  the pserver arms this sink itself with a per-process
                  `ps` tag in the filename):
                  {"table": str, "mode": "sync"|"async"|"delta",
                   "step": int round/seq, "rows": int, "apply_ms": float}
  kind="numerics" training numerics (telemetry/numerics.py), split by
                  "event":
                  event="stats"      one sampled read of the in-graph
                    stat vars (FLAGS_tensor_stats, every
                    PADDLE_NUMERICS_EVERY steps): {"step": int sample
                    counter, "watch": {label: {"kind":
                    "grad"|"param"|"clip_gnorm", "nan": int,
                    "inf": int, "max_abs": float, "l2": float} —
                    clip_gnorm rows carry {"value", "clip_norm",
                    "clipped"?} instead}}
                  event="amp_scale"  one AMP dynamic-loss-scale
                    transition: {"step", "change": "growth"|"backoff",
                    "old", "new", "scale_var"}
                  event="doctor"     the NaN-provenance doctor ran:
                    {"reason", "op_index"?, "op_type"?, "output_var"?}
                    (full report: the numrec.<tag>.json dump)
                  event="divergence" a cross-replica SDC verdict
                    reached this rank: {"step", "odd_rank_out",
                    "method", "detected_step"}
  kind="goodput"  goodput/badput ledger summary (telemetry/goodput.py,
                  every PADDLE_GOODPUT_EVERY classification points when
                  PADDLE_GOODPUT=1): {"event": "summary", "tag",
                  "incarnation": int (PADDLE_ELASTIC_RESTART), "t0",
                  "t1", "steps": int, "goodput_ratio": float|null,
                  "buckets_ms": {bucket: cumulative ms for the eight
                  goodput.BUCKETS}}; the authoritative per-interval
                  rows live in goodput.<tag>.<incarnation>.jsonl under
                  PADDLE_GOODPUT_DIR (default PADDLE_TRACE_DIR)
  kind="serve_request"  one RETIRED generation request
                  (inference/engine.py, any outcome — the serving
                  flight ledger): {"trace": str|null (the request's
                  trace id when PADDLE_TRACING was on, else null),
                   "outcome": "served"|"shed"|"deadline_exceeded"|
                   "error", "prompt_len": int, "tokens": int delivered
                   (including a resumed prefix), "queue_ms": float
                   cumulative admission-queue wait (re-queues after
                   preemption accumulate), "ttft_ms": float|null
                   admission to first token, "total_ms": float
                   admission to retire, "preempts": int,
                   "resumed_from": int prefix length a resume carried
                   in, "weight_epoch": int, "detail"?: str error
                   text}; the same record feeds debugz /servez
                  ("recent_slowest") and, when tracing is on, the
                  flight-recorder dump's "requests" array that
                  tools/reqtop.py joins onto the span reconstruction
  kind="mem_report"  one static memory attribution (telemetry/memory.py,
                  emitted per compile-cache miss under FLAGS_mem_profile
                  and by explicit memtop/bench joins):
                  {"model": str|null, "static_peak_bytes": int,
                   "measured_peak_bytes": int|null, "model_bytes": int,
                   "coverage": float|null, "categories": {category: int}}

The sink is OFF (every emit a no-op costing one attribute read) unless
PADDLE_METRICS_PATH is set or enable(path) is called — the flag-off hot
path does no I/O and allocates nothing.

A `%r`/`{rank}` placeholder in the path expands to the trainer rank so
launched jobs don't interleave writers; otherwise a rank suffix is
appended automatically when PADDLE_TRAINER_ID > 0. When
PADDLE_TRAINER_ID is UNSET (processes not started by the launcher), the
placeholder — and the `.rank0` that two un-launched local processes
would otherwise collide on — falls back to the PID, so sharing one
PADDLE_METRICS_PATH template across ad-hoc processes yields one file
each. An explicit placeholder-free path stays exactly as given (the
single-process contract tools and CI read).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import IO, Optional

ENV_PATH = "PADDLE_METRICS_PATH"


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))
    except ValueError:
        return 0


def _expand(path: str, rank: int) -> str:
    # no launcher rank: two local processes sharing one path template
    # must not interleave into a single file — the PID is the suffix
    launched = "PADDLE_TRAINER_ID" in os.environ
    tag = str(rank) if launched else f"pid{os.getpid()}"
    if "{rank}" in path:
        return path.replace("{rank}", tag)
    if "%r" in path:
        return path.replace("%r", tag)
    if rank:
        root, ext = os.path.splitext(path)
        return f"{root}.rank{rank}{ext or '.jsonl'}"
    return path


class JsonlSink:
    def __init__(self, path: str):
        self.rank = _rank()
        self.path = _expand(path, self.rank)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[IO] = None
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault("ts", round(time.time(), 6))
        rec.setdefault("rank", self.rank)
        line = json.dumps(rec, default=_json_default)
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a", buffering=1)
            self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def _json_default(v):
    """numpy / jax scalars slip into records from fetch lists."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


_sink: Optional[JsonlSink] = None
_resolved = False
_lock = threading.Lock()


def active_sink() -> Optional[JsonlSink]:
    """The process sink, or None when telemetry output is off. Resolved
    once from PADDLE_METRICS_PATH; enable()/disable() override."""
    global _sink, _resolved
    if _resolved:
        return _sink
    with _lock:
        if not _resolved:
            path = os.environ.get(ENV_PATH)
            _sink = JsonlSink(path) if path else None
            _resolved = True
    return _sink


def enabled() -> bool:
    return active_sink() is not None


def enable(path: str) -> JsonlSink:
    global _sink, _resolved
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = JsonlSink(path)
        _resolved = True
    return _sink


def disable() -> None:
    global _sink, _resolved
    with _lock:
        if _sink is not None:
            _sink.close()
        _sink = None
        _resolved = True


def emit(record: dict) -> None:
    """Write one record if the sink is on; free no-op otherwise."""
    s = active_sink()
    if s is not None:
        s.emit(record)
