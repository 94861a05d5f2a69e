"""Distributed step tracing: causal span propagation.

The cross-process answer to "why did this sync round stall": every hop
we own — an Executor step, a client RPC (each retry, backoff sleep and
hedge attempt individually), the server-side verb handling it lands in,
the sync-barrier wait, a primary→backup `replicate` forward, a
coordinator lease renewal — becomes a SPAN carrying W3C-traceparent-
style identity (trace_id / span_id / parent_id), so one trace_id
connects trainer → primary → backup → coordinator and per-hop wall time
is evidence, not inference.

Design contract (mirrors the rest of the telemetry package):

  gate        PADDLE_TRACING=1 arms the layer. Off (the default) every
              entry point returns None after one cached bool read, the
              RPC payload gains NO key (wire bytes bit-identical — the
              CI drill asserts it) and nothing allocates.
  spans       in-process bounded ring buffer (PADDLE_TRACE_RING spans,
              default 4096) of finished-span dicts; timestamps are
              time.time() for cross-process ordering and
              perf_counter deltas for durations.
  context     thread-local span stack; `bound()` re-binds the caller's
              context inside worker-pool threads (RemoteTable fan-out,
              hedges) and the `_trace` payload key carries it across
              the wire ("00-<trace>-<span>-01", W3C traceparent).
  flight rec  dump_flight()/flight recorder: the span ring + recent
              step records written atomically to PADDLE_TRACE_DIR as
              flightrec.<tag>.json on SIGTERM, BadStepError,
              lease-expiry eviction, fault-injected kill/crash,
              unhandled crash, and process exit — the post-mortem
              input tools/tracetop.py merges into a causal trace.
  live        debugz /tracez serves tracez() — recent traces,
              slowest-first, per-hop durations.

Module is stdlib-only (the pserver, coordinator and launcher import it
without jax).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

ENV_GATE = "PADDLE_TRACING"
ENV_DIR = "PADDLE_TRACE_DIR"  # shared with the profiler's chrome dumps
ENV_RING = "PADDLE_TRACE_RING"

_enabled: Optional[bool] = None
_lock = threading.Lock()
_tls = threading.local()

# finished spans, oldest dropped first; each carries a process-monotone
# `seq` so the push exporter can drain "everything since my cursor"
_ring: deque = deque(maxlen=int(os.environ.get(ENV_RING, 4096) or 4096))
_seq = 0

# the last Executor step's (trace_id, span_id): joined onto heartbeat
# stamps (straggler episodes cite it) and checkpoint-save spans
_last_step_ctx: Optional[Tuple[str, str]] = None

_hooks_installed = False
_dumped_reasons: set = set()

# per-request serving flight records: one dict per retired
# generation, bounded; rides along in flight_dump payloads so
# tools/reqtop.py can reconstruct where a slow request's wall time went
_REQ_RECORDS: deque = deque(maxlen=256)


def enabled() -> bool:
    """PADDLE_TRACING gate, resolved once per process (one bool read on
    the hot path afterwards)."""
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get(ENV_GATE, "") not in ("", "0", "false")
    return _enabled


def process_tag() -> str:
    """This process's stable identity in dumps: the pserver tag ("ps0"),
    the launcher trainer rank ("trainer1"), else the pid."""
    t = os.environ.get("PADDLE_PS_RANK_TAG")
    if t:
        return t
    r = os.environ.get("PADDLE_TRAINER_ID")
    if r is not None:
        return f"trainer{r}"
    return f"pid{os.getpid()}"


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One in-flight span. Finished spans are stored as plain dicts in
    the ring; the object itself never outlives its scope."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "attrs", "status", "t0", "start", "tid")

    def __init__(self, name: str, kind: str, trace_id: str,
                 parent_id: Optional[str], attrs: Optional[dict]):
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.attrs = dict(attrs) if attrs else {}
        self.status = "ok"
        self.t0 = time.perf_counter()
        self.start = time.time()
        self.tid = threading.get_ident() % 100_000

    def to_dict(self, dur_ms: float) -> dict:
        d = {
            "trace": self.trace_id, "span": self.span_id,
            "parent": self.parent_id, "name": self.name,
            "kind": self.kind, "ts": round(self.start, 6),
            "dur_ms": round(dur_ms, 3), "status": self.status,
            "proc": process_tag(), "tid": self.tid,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _Ctx:
    """A remote/captured context re-bound in this thread (no new span):
    just enough identity for children to parent under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """Innermost active span/context in this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def current_ctx() -> Optional[Tuple[str, str]]:
    c = current()
    return (c.trace_id, c.span_id) if c is not None else None


def begin(name: str, kind: str = "internal", parent: Any = "auto",
          attrs: Optional[dict] = None) -> Optional[Span]:
    """Open a span WITHOUT pushing it on the thread-local stack (manual
    parenting — the RPC attempt loop). parent: "auto" (innermost active),
    None (new root trace), a Span/_Ctx, or a (trace_id, span_id) tuple.
    Returns None when tracing is off."""
    if not enabled():
        return None
    if parent == "auto":
        parent = current()
    if parent is None:
        return Span(name, kind, _new_id(16), None, attrs)
    if isinstance(parent, tuple):
        return Span(name, kind, parent[0], parent[1], attrs)
    return Span(name, kind, parent.trace_id, parent.span_id, attrs)


def finish(span: Optional[Span], status: Optional[str] = None) -> None:
    """Close a begin() span and record it in the ring. None-safe."""
    global _seq
    if span is None:
        return
    if status is not None:
        span.status = status
    d = span.to_dict((time.perf_counter() - span.t0) * 1e3)
    with _lock:
        _seq += 1
        d["seq"] = _seq
        _ring.append(d)


class _SpanScope:
    """Context manager: begin() + thread-local push, finish on exit
    (error status when the body raised). Yields the Span or None."""

    __slots__ = ("_span",)

    def __init__(self, span: Optional[Span]):
        self._span = span

    def __enter__(self):
        if self._span is not None:
            _stack().append(self._span)
        return self._span

    def __exit__(self, etype, evalue, tb):
        if self._span is not None:
            st = _stack()
            if st and st[-1] is self._span:
                st.pop()
            finish(self._span,
                   status=(f"error:{etype.__name__}" if etype else None))
        return False


def span(name: str, kind: str = "internal", parent: Any = "auto",
         attrs: Optional[dict] = None) -> _SpanScope:
    """`with tracing.span("apply", attrs=...)` — children started in the
    body (this thread) parent under it. No-op scope when tracing is off."""
    return _SpanScope(begin(name, kind, parent, attrs))


class _AttachScope:
    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            _stack().append(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._ctx is not None:
            st = _stack()
            if st and st[-1] is self._ctx:
                st.pop()
        return False


def attach(ctx: Optional[Tuple[str, str]]) -> _AttachScope:
    """Re-bind a captured (trace_id, span_id) context in this thread —
    worker-pool threads are not the caller's thread."""
    return _AttachScope(_Ctx(*ctx) if ctx is not None else None)


def bound(fn: Callable) -> Callable:
    """Capture the CALLER's current context now; return a wrapper that
    re-binds it where the pool runs fn. Identity when tracing is off or
    no context is active (zero overhead on the R=1 hot path)."""
    if not enabled():
        return fn
    ctx = current_ctx()
    if ctx is None:
        return fn

    def wrapper(*a, **kw):
        with attach(ctx):
            return fn(*a, **kw)

    return wrapper


def child_span(name: str, ctx: Optional[Tuple[str, str]],
               attrs: Optional[dict] = None,
               kind: str = "internal") -> _SpanScope:
    """Open a span parented under a CAPTURED (trace_id, span_id) context
    from any thread — the async checkpoint writer records its
    `checkpoint_write` span under the step's `checkpoint_save` span this
    way, even though the write runs later on the writer thread. A None
    context roots a fresh trace; tracing off = no-op scope."""
    if not enabled():
        return _SpanScope(None)
    return _SpanScope(begin(name, kind=kind, parent=ctx, attrs=attrs))


def annotate(**attrs) -> None:
    """Set attributes on the innermost active SPAN (contexts re-bound
    from another thread are skipped — they are not ours to mutate)."""
    c = current()
    if isinstance(c, Span):
        c.attrs.update(attrs)


# ---------------------------------------------------------------------------
# wire format (W3C traceparent)
# ---------------------------------------------------------------------------


def header_for(span: Optional[Span]) -> Optional[str]:
    if span is None:
        return None
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_header(header) -> Optional[Tuple[str, str]]:
    if not isinstance(header, str):
        return None
    parts = header.split("-")
    if len(parts) != 4 or not parts[1] or not parts[2]:
        return None
    return parts[1], parts[2]


def server_span(name: str, header, attrs: Optional[dict] = None,
                kind: str = "server") -> _SpanScope:
    """Reopen a propagated context server-side around verb handling.
    With no header (client untraced) the server still roots a local
    trace; tracing off = no-op scope either way."""
    if not enabled():
        return _SpanScope(None)
    ctx = parse_header(header)
    return _SpanScope(begin(name, kind=kind, parent=ctx, attrs=attrs))


# ---------------------------------------------------------------------------
# executor step join
# ---------------------------------------------------------------------------


class _StepScope(_SpanScope):
    def __enter__(self):
        sp = super().__enter__()
        if sp is not None:
            global _last_step_ctx
            _last_step_ctx = (sp.trace_id, sp.span_id)
        return sp


def step_span(attrs: Optional[dict] = None) -> _StepScope:
    """Root span for one Executor.run step; publishes its context as the
    process's "latest step" (heartbeat stamps, checkpoint-save joins,
    straggler episode citations)."""
    return _StepScope(begin("step", kind="step", parent=None, attrs=attrs))


def last_step_trace_id() -> Optional[str]:
    return _last_step_ctx[0] if _last_step_ctx is not None else None


def last_step_ctx() -> Optional[Tuple[str, str]]:
    return _last_step_ctx


# ---------------------------------------------------------------------------
# read side: ring, tracez, export batches
# ---------------------------------------------------------------------------


def finished_spans() -> List[dict]:
    with _lock:
        return list(_ring)


def export_batch(after_seq: int) -> Tuple[List[dict], int]:
    """Spans with seq > after_seq (the push exporter's drain cursor) and
    the new cursor. Ring eviction bounds what a slow collector can ever
    replay — bounded memory, bounded loss."""
    with _lock:
        out = [s for s in _ring if s.get("seq", 0) > after_seq]
    return out, (out[-1]["seq"] if out else after_seq)


def tracez(limit: int = 50) -> dict:
    """Recent traces, slowest-first: per trace the root name, total
    duration, and every hop with its own duration — the debugz /tracez
    payload."""
    spans = finished_spans()
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    traces = []
    for tid, ss in by_trace.items():
        ss.sort(key=lambda s: s["ts"])
        ids = {s["span"] for s in ss}
        roots = [s for s in ss if not s.get("parent")
                 or s["parent"] not in ids]
        t_begin = min(s["ts"] for s in ss)
        t_end = max(s["ts"] + s["dur_ms"] / 1e3 for s in ss)
        traces.append({
            "trace": tid,
            "root": (roots[0]["name"] if roots else ss[0]["name"]),
            "dur_ms": round((t_end - t_begin) * 1e3, 3),
            "n_spans": len(ss),
            "spans": [{k: s.get(k) for k in
                       ("span", "parent", "name", "kind", "proc",
                        "dur_ms", "status", "attrs")} for s in ss],
        })
    traces.sort(key=lambda t: -t["dur_ms"])
    return {"process": process_tag(), "enabled": enabled(),
            "traces": traces[:limit]}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def note_request(rec: dict) -> None:
    """Record one per-request serving flight record (retired generation:
    trace id, outcome, tokens, queue/ttft/total ms, preempts...). Kept in
    a bounded deque and included in flight_dump payloads under
    "requests". No-op when tracing is off."""
    if not enabled():
        return
    with _lock:
        _REQ_RECORDS.append(dict(rec))


def request_records() -> List[dict]:
    with _lock:
        return list(_REQ_RECORDS)


def _recent_steps() -> List[dict]:
    # the port has no Program executor (fluid.monitor) yet: no step records
    return []


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def flight_dump(reason: str, directory: Optional[str] = None,
                tag: Optional[str] = None) -> Optional[str]:
    """Dump the span ring + recent step records atomically to
    `<PADDLE_TRACE_DIR>/flightrec.<tag>.json`. One dump per reason per
    process; a later trigger REWRITES the same file with a fresher span
    ring and `reasons` accumulates every trigger so far (a BadStepError
    followed by the atexit dump reads ["bad_step", "exit"]). No-op
    (None) when tracing is off or no directory is configured."""
    if not enabled():
        return None
    directory = directory or os.environ.get(ENV_DIR)
    if not directory:
        return None
    with _lock:
        if reason in _dumped_reasons:
            return None
        _dumped_reasons.add(reason)
        reasons = sorted(_dumped_reasons)
    tag = tag or process_tag()
    payload = {
        "format": 1,
        "process": tag,
        "pid": os.getpid(),
        "reason": reason,
        "reasons": reasons,
        "ts": round(time.time(), 6),
        "spans": finished_spans(),
        "steps": _recent_steps(),
        "requests": request_records(),
    }
    path = os.path.join(directory, f"flightrec.{tag}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        _atomic_write(path, json.dumps(payload).encode())
    except OSError:
        return None  # a full disk must not mask the original failure
    return path


def to_chrome_events(spans: List[dict]) -> List[dict]:
    """Finished spans as chrome-trace complete events (host pid 0, one
    tid lane per originating thread) — the per-process file
    telemetry.timeline merges next to the jax profiler dumps."""
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0,
        "args": {"name": f"spans ({process_tag()})"},
    }]
    for s in spans:
        ev = {
            "name": s["name"], "cat": s.get("kind", "span"), "ph": "X",
            "pid": 0, "tid": s.get("tid", 0),
            "ts": s["ts"] * 1e6, "dur": max(s["dur_ms"], 1e-3) * 1e3,
            "args": {"trace": s["trace"], "span": s["span"],
                     "status": s.get("status", "ok"),
                     **(s.get("attrs") or {})},
        }
        if s.get("parent"):
            ev["args"]["parent"] = s["parent"]
        events.append(ev)
    return events


def dump_chrome(directory: Optional[str] = None,
                tag: Optional[str] = None) -> Optional[str]:
    """Write this process's spans as `trace.<tag>.json` chrome trace in
    PADDLE_TRACE_DIR, so the launcher's timeline merge shows pserver and
    coordinator lanes next to the trainer ranks'."""
    if not enabled():
        return None
    directory = directory or os.environ.get(ENV_DIR)
    if not directory:
        return None
    tag = tag or process_tag()
    path = os.path.join(directory, f"trace.{tag}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        _atomic_write(path, json.dumps(
            {"traceEvents": to_chrome_events(finished_spans()),
             "displayTimeUnit": "ms"}).encode())
    except OSError:
        return None
    return path


def shutdown_dump(tag: Optional[str] = None) -> None:
    """Clean-exit dump: flight record + chrome spans (idempotent per
    reason). Called from server teardown paths and the atexit hook."""
    flight_dump("exit", tag=tag)
    dump_chrome(tag=tag)


def maybe_install_hooks() -> None:
    """Arm the flight-recorder triggers once per process: SIGTERM
    (chained — the checkpoint preemption handler and launcher grace
    protocol keep working), unhandled-exception hook, and atexit. Safe
    to call from any thread (signal install silently skipped off the
    main thread) and a no-op when tracing is off."""
    global _hooks_installed
    if not enabled() or _hooks_installed:
        return
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True

    import atexit
    import signal
    import sys

    atexit.register(shutdown_dump)

    prev_hook = sys.excepthook

    def _excepthook(etype, evalue, tb):
        flight_dump(f"crash:{etype.__name__}")
        dump_chrome()
        prev_hook(etype, evalue, tb)

    sys.excepthook = _excepthook

    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(sig, frame):
            flight_dump("sigterm")
            dump_chrome()
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(sig, frame)
            else:
                # restore the default disposition and re-deliver so the
                # process still dies with the conventional 143
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread: atexit/excepthook remain
        pass


def _reset_for_tests() -> None:
    """Drop the ring, cursors and the cached gate (unit tests re-arm
    with monkeypatched env)."""
    global _enabled, _seq, _last_step_ctx, _hooks_installed
    with _lock:
        _ring.clear()
        _dumped_reasons.clear()
        _REQ_RECORDS.clear()
        _seq = 0
    _enabled = None
    _last_step_ctx = None
    _tls.stack = []
