"""Inference serving over the PS RPC transport, ported from the JAX
package's ``inference/server.py``.

An InferenceServer implements the ps_server `_Handler` contract (an
object with `handle(method, kwargs)` + `shutdown_event` behind
`_TCPServer`), so the transport comes with it — client retries with
backoff, per-RPC deadlines, hedged reads, per-verb latency histograms
with trace exemplars, deterministic fault injection (drop/refuse/delay/
slow/stall/kill), and per-request causal trace_id spans.

Verbs: `infer`, `generate`, `generate_poll`, `model_info`, `health`,
`stats`, `drain` (+ ping/shutdown).  Replies hold numpy arrays and
plain Python values, never torch tensors, so the JAX package's client
and the Go and R clients read them.

Device: the model runs on the CUDA card unless the caller passes
``device="cpu"`` (``main``'s ``--device cpu``); the decoder engine
`_maybe_build_engine` attaches runs on the same device.  A CUDA error
inside a batch becomes that batch's error replies; the replica keeps
serving.

Robustness core — the micro-batching scheduler (`MicroBatcher`):

  admission    — a BOUNDED queue. A request is REFUSED with an explicit
                 `Overloaded` reply when (a) the queue is full, (b) the
                 server is draining, or (c) the projected queue wait
                 (depth x EWMA batch latency) already exceeds the
                 request's remaining deadline — never silent queuing to
                 death.
  batching     — queued requests coalesce into one device batch
                 (concatenated rows, padded to max_batch so every batch
                 has one shape: one executor plan per model), outputs
                 are sliced back per request.
  deadlines    — the client's budget rides the request; a request whose
                 deadline expired while queued gets an explicit
                 `DeadlineExceeded` reply (counted) instead of burning
                 device time.
  drain        — SIGTERM stops admission ("Overloaded: draining"),
                 finishes every in-flight request, then exits 0.
  epoch fence  — fresh weights are STAGED (`stage_weights`) and
                 installed by the scheduler BETWEEN micro-batches: every
                 request is served entirely by one weight epoch, echoed
                 in its reply.

SLO accounting: serve_requests_total{outcome=served|shed|deadline_
exceeded|error}, serve_request_ms / serve_batch_ms histograms (p50/p99
via the registry), serve_queue_depth gauge, serve_weight_epoch gauge —
all on the `stats` verb.

Under the launcher (``launch --serve``), ``serve()`` stamps heartbeats
(PADDLE_HEARTBEAT_DIR with a trainer tag), renews a coordinator lease
of kind "inference" (PADDLE_COORDINATOR_ENDPOINT), pushes metrics and
spans (PADDLE_METRICS_PUSH_URL, PADDLE_TRACES_PUSH_URL) and follows the
live weight table (`weight_sync.maybe_start_subscriber`).  Not ported
yet, and refused rather than ignored: debugz (PADDLE_DEBUGZ_PORT),
ROADMAP A8.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np

from ..telemetry import get_registry
from ..telemetry import tracing as _tracing
from .freeze import FrozenModel, load_frozen
from .predictor import Predictor
from . import weight_sync as _wsync

_REG = get_registry()

# serving latency buckets (ms): sub-ms cache hits through a first batch
# that builds the kernels
SERVE_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000,
                 10000, 30000)

DEFAULT_MAX_BATCH = int(os.environ.get("PADDLE_SERVE_MAX_BATCH", 8))
DEFAULT_QUEUE_DEPTH = int(os.environ.get("PADDLE_SERVE_QUEUE_DEPTH", 64))

# the process-wide active server (debugz /statusz serving row)
_ACTIVE: Optional["InferenceServer"] = None


def _note_serving_badput(ms: float, cause: str) -> None:
    """Charge shed/expired request wall-time to the goodput ledger's
    serving buckets (no-op when PADDLE_GOODPUT is off)."""
    try:
        from ..telemetry import goodput as _goodput

        _goodput.note_serving_badput(ms, cause=cause)
    except Exception:  # noqa: BLE001 — telemetry is best-effort
        pass


class Overloaded(RuntimeError):
    """Admission refused — queue full, draining, or the projected wait
    exceeds the request deadline. The CLIENT's cue to back off or go to
    another replica; the error string crosses the wire verbatim."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its batch ran."""


class ResumedOnNewWeights(RuntimeError):
    """A generation resume landed on a replica serving a different
    weight epoch than the one the already-delivered tokens came from.
    Splicing two models' tokens would be silent corruption; the client
    gets this typed refusal (string crosses the wire verbatim) and
    decides — retry from scratch, or surface the partial output."""


# crash-tolerant generation: PADDLE_SERVE_RESUME=0 disables the
# resume/preempt/dedup machinery entirely — the engine sheds instead of
# preempting and finished streams/replies are dropped on delivery.
ENV_RESUME = "PADDLE_SERVE_RESUME"
# bound on the exactly-once dedup table and the retained finished
# streams (oldest entries evicted first)
DEDUP_MAX = int(os.environ.get("PADDLE_SERVE_DEDUP_MAX", 512))


def resume_enabled() -> bool:
    return os.environ.get(ENV_RESUME, "1") not in ("0", "false", "off")


class _Pending:
    """One admitted request riding the batch queue."""

    __slots__ = ("feed", "rows", "deadline_t", "event", "outputs",
                 "error", "weight_epoch", "t_admit")

    def __init__(self, feed, rows, deadline_t):
        self.feed = feed
        self.rows = int(rows)
        self.deadline_t = deadline_t  # monotonic seconds or None
        self.event = threading.Event()
        self.outputs: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.weight_epoch = 0
        self.t_admit = time.monotonic()


class MicroBatcher:
    """Bounded admission queue + scheduler thread running the model."""

    def __init__(self, predictor: Predictor, max_batch: int = 8,
                 queue_depth: int = 64, batch_wait_ms: float = 2.0):
        self.predictor = predictor
        self.max_batch = max(1, int(max_batch))
        self.queue_limit = max(1, int(queue_depth))
        self.batch_wait_s = float(batch_wait_ms) / 1e3
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._inflight = 0
        # EWMA of device batch latency: the admission estimator. Unset
        # until the first batch (which builds the kernels) lands.
        self._batch_ewma_s: Optional[float] = None
        self._pending_weights = None  # (weights dict, version) staged
        self._wlock = threading.Lock()
        self.weight_epoch = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # -- admission -------------------------------------------------------
    def _projected_wait_s(self, depth_rows: int) -> float:
        """Queue wait estimate: batches ahead of us x EWMA batch time.
        Unknown EWMA (nothing measured yet) estimates 0 — the first
        requests must be admitted for the estimator to learn."""
        if self._batch_ewma_s is None:
            return 0.0
        batches_ahead = -(-depth_rows // self.max_batch) + 1
        return batches_ahead * self._batch_ewma_s

    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None) -> _Pending:
        # validate the feed BEFORE admission: a malformed request must
        # bounce as ITS error, never enter a batch other requests share
        want = list(self.predictor.feed_names)
        missing = [n for n in want if n not in feed]
        extra = [n for n in feed if n not in want]
        if missing or extra:
            raise ValueError(
                f"infer feed mismatch: missing {missing}, unknown "
                f"{extra} (model feeds: {want})")
        rows = int(np.shape(next(iter(feed.values())))[0]) if feed else 0
        if rows <= 0 or rows > self.max_batch:
            raise ValueError(
                f"infer batch must have 1..{self.max_batch} rows "
                f"(got {rows}; raise --max_batch or split the request)")
        deadline_t = (time.monotonic() + float(deadline_ms) / 1e3
                      if deadline_ms else None)
        with self._cond:
            if self._draining or self._stopped:
                _REG.counter("serve_requests_total",
                             outcome="shed").inc()
                raise Overloaded("Overloaded: server is draining")
            depth_rows = sum(p.rows for p in self._q)
            if len(self._q) >= self.queue_limit:
                _REG.counter("serve_requests_total",
                             outcome="shed").inc()
                raise Overloaded(
                    f"Overloaded: admission queue full "
                    f"({len(self._q)}/{self.queue_limit})")
            if deadline_t is not None:
                wait = self._projected_wait_s(depth_rows + rows)
                if time.monotonic() + wait >= deadline_t:
                    _REG.counter("serve_requests_total",
                                 outcome="shed").inc()
                    _note_serving_badput(wait * 1e3, "shed")
                    raise Overloaded(
                        f"Overloaded: projected queue wait "
                        f"{wait * 1e3:.0f}ms exceeds the request "
                        f"deadline ({float(deadline_ms):.0f}ms)")
            p = _Pending(feed, rows, deadline_t)
            self._q.append(p)
            _REG.gauge("serve_queue_depth").set(len(self._q))
            self._cond.notify_all()
        return p

    # -- weight fence ----------------------------------------------------
    def stage_weights(self, weights: Dict[str, np.ndarray],
                      version: int) -> None:
        """Called from the subscriber thread; the SCHEDULER installs it
        between micro-batches (the epoch fence). Last staged wins."""
        with self._wlock:
            self._pending_weights = (weights, int(version))
        with self._cond:
            self._cond.notify_all()

    def _maybe_adopt_weights(self) -> None:
        with self._wlock:
            staged, self._pending_weights = self._pending_weights, None
        if staged is None:
            return
        weights, version = staged
        try:
            self.predictor.adopt_weights(weights)
        except Exception as e:  # noqa: BLE001 — a bad delivery (manifest
            # drift, shape mismatch) must never kill the scheduler:
            # serving continues on the CURRENT epoch's weights
            _REG.counter("serve_weight_adopt_errors_total").inc()
            import sys

            print(f"[inference_server] weight adoption rejected "
                  f"(version {version}): {e}; serving stays on epoch "
                  f"{self.weight_epoch}", file=sys.stderr, flush=True)
            return
        self.weight_epoch += 1
        _REG.gauge("serve_weight_epoch").set(self.weight_epoch)
        _REG.counter("serve_weight_fences_total").inc()

    # -- the scheduler ---------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Block until work exists, then coalesce up to max_batch rows.
        A short batch_wait lets near-simultaneous requests share a
        device run without adding real latency."""
        with self._cond:
            while not self._q and not self._stopped:
                self._cond.wait(0.1)
                if self._pending_weights is not None and not self._q:
                    return []  # install promptly even when idle
            if self._stopped and not self._q:
                return []
            if (sum(p.rows for p in self._q) < self.max_batch
                    and not self._draining):
                self._cond.wait(self.batch_wait_s)
            batch, rows = [], 0
            while self._q and rows + self._q[0].rows <= self.max_batch:
                p = self._q.popleft()
                batch.append(p)
                rows += p.rows
            self._inflight = len(batch)
            _REG.gauge("serve_queue_depth").set(len(self._q))
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            # fence: adoption happens here, BETWEEN micro-batches — no
            # request observes two epochs
            self._maybe_adopt_weights()
            if not batch:
                with self._cond:
                    if self._stopped and not self._q:
                        return
                continue
            try:
                self._run_batch(batch)
            except BaseException as e:  # noqa: BLE001 — the scheduler
                # must NEVER die: whatever failed, the batch gets error
                # replies and the next batch is served
                for p in batch:
                    if not p.event.is_set():
                        p.error = e
                        _REG.counter("serve_requests_total",
                                     outcome="error").inc()
                        p.event.set()
            finally:
                with self._cond:
                    self._inflight = 0
                    self._cond.notify_all()

    def _run_batch(self, batch: List[_Pending]) -> None:
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            if p.deadline_t is not None and now >= p.deadline_t:
                # expired while queued: explicit reply, no device time
                p.error = DeadlineExceeded(
                    "DeadlineExceeded: request expired in the queue")
                _REG.counter("serve_requests_total",
                             outcome="deadline_exceeded").inc()
                _note_serving_badput((now - p.t_admit) * 1e3, "deadline")
                p.event.set()
            else:
                live.append(p)
        if not live:
            return
        rows = sum(p.rows for p in live)
        feed_names = self.predictor.feed_names
        feed = {}
        for n in feed_names:
            parts = [np.asarray(p.feed[n]) for p in live]
            cat = np.concatenate(parts, axis=0)
            if rows < self.max_batch:
                # pad to ONE batch shape: the executor keeps a single
                # plan per model, and padding rows are dead compute
                pad = np.zeros((self.max_batch - rows,) + cat.shape[1:],
                               cat.dtype)
                cat = np.concatenate([cat, pad], axis=0)
            feed[n] = cat
        t0 = time.perf_counter()
        try:
            outs = self.predictor.run(feed)
        except BaseException as e:  # noqa: BLE001 — reply, keep serving
            for p in live:
                p.error = e
                _REG.counter("serve_requests_total",
                             outcome="error").inc()
                p.event.set()
            return
        dt = time.perf_counter() - t0
        # EWMA the admission estimator ranks queue wait with
        ewma = self._batch_ewma_s
        self._batch_ewma_s = dt if ewma is None else 0.8 * ewma + 0.2 * dt
        _REG.histogram("serve_batch_ms", help="device micro-batch "
                       "latency", buckets=SERVE_BUCKETS).observe(dt * 1e3)
        _REG.counter("serve_batches_total").inc()
        _REG.counter("serve_batch_rows_total").inc(rows)
        off = 0
        for p in live:
            sliced = []
            for o in outs:
                o = np.asarray(o)
                if o.ndim >= 1 and o.shape[0] == self.max_batch:
                    sliced.append(o[off:off + p.rows])
                else:  # batch-independent output (scalar/global stat)
                    sliced.append(o)
            p.outputs = sliced
            p.weight_epoch = self.weight_epoch
            _REG.counter("serve_requests_total", outcome="served").inc()
            _REG.histogram(
                "serve_request_ms",
                help="admission-to-reply serving latency",
                buckets=SERVE_BUCKETS).observe(
                (time.monotonic() - p.t_admit) * 1e3)
            off += p.rows
            p.event.set()

    # -- drain / teardown ------------------------------------------------
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._q)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, finish in-flight + queued work. True when
        the queue reached empty inside the timeout."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._q or self._inflight) and \
                    time.monotonic() < deadline:
                self._cond.wait(0.1)
            drained = not self._q and not self._inflight
        return drained

    def stop(self) -> None:
        self.drain(timeout=5.0)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        def counter(name, **labels):
            return _REG.counter(name, **labels).value

        req_h = _REG.histogram("serve_request_ms", buckets=SERVE_BUCKETS)
        with self._cond:
            depth, inflight = len(self._q), self._inflight
        return {
            "queue_depth": depth,
            "queue_limit": self.queue_limit,
            "inflight": inflight,
            "max_batch": self.max_batch,
            "draining": self._draining,
            "weight_epoch": self.weight_epoch,
            "batch_ewma_ms": (None if self._batch_ewma_s is None
                              else round(self._batch_ewma_s * 1e3, 3)),
            "served_total": counter("serve_requests_total",
                                    outcome="served"),
            "shed_total": counter("serve_requests_total", outcome="shed"),
            "deadline_exceeded_total": counter(
                "serve_requests_total", outcome="deadline_exceeded"),
            "error_total": counter("serve_requests_total",
                                   outcome="error"),
            "batches_total": counter("serve_batches_total"),
            "request_ms": req_h.summary(),
            # the SLO numbers servetop renders (bucket-interpolated)
            "p50_ms": round(req_h.quantile(0.50), 3),
            "p99_ms": round(req_h.quantile(0.99), 3),
            "batch_ms": _REG.histogram(
                "serve_batch_ms", buckets=SERVE_BUCKETS).summary(),
        }


class InferenceServer:
    """ps_server._Handler contract: serve a FrozenModel."""

    def __init__(self, frozen: FrozenModel,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 batch_wait_ms: float = 2.0,
                 weight_subscribe: bool = True,
                 engine=None, device=None):
        global _ACTIVE

        self.frozen = frozen
        # device=None: the CUDA card (raises where there is none)
        self.predictor = Predictor(frozen, device=device)
        self.batcher = MicroBatcher(self.predictor, max_batch=max_batch,
                                    queue_depth=queue_depth,
                                    batch_wait_ms=batch_wait_ms)
        # optional autoregressive path (engine.GenerationEngine): the
        # `generate`/`generate_poll` verbs; the padded `infer` path
        # above is untouched whether or not an engine is attached
        self.engine = engine
        self._streams: Dict[str, object] = {}
        self._streams_lock = threading.Lock()
        self._stream_seq = 0
        # exactly-once generate: request_id -> {req, stream_id,
        # reply}. A marked-retry generate with a known id reattaches to
        # the in-flight GenRequest or replays the finished reply — the
        # model never runs twice for one id. Bounded LRU (DEDUP_MAX);
        # the same bound retains finished streams so a retried
        # generate_poll after an ambiguous failure replays the final
        # snapshot instead of "unknown stream".
        self._dedup: "OrderedDict[str, dict]" = OrderedDict()
        self._done_streams: "OrderedDict[str, object]" = OrderedDict()
        self._resume_on = resume_enabled()
        self.shutdown_event = threading.Event()  # _Handler contract
        self.started_at = time.time()
        self.subscriber = None
        if weight_subscribe:
            self.subscriber = _wsync.maybe_start_subscriber(
                frozen, self.batcher.stage_weights)
        _ACTIVE = self

    # -- verbs -----------------------------------------------------------
    def infer(self, feed: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None) -> dict:
        pending = self.batcher.submit(feed, deadline_ms=deadline_ms)
        # the handler thread parks here while the scheduler batches;
        # wait is bounded by the deadline (+ grace for the reply)
        timeout = None
        if pending.deadline_t is not None:
            timeout = max(0.0, pending.deadline_t - time.monotonic()) + 30.0
        if not pending.event.wait(timeout):
            _REG.counter("serve_requests_total",
                         outcome="deadline_exceeded").inc()
            raise DeadlineExceeded(
                "DeadlineExceeded: batch did not complete in time")
        if pending.error is not None:
            raise pending.error
        return {
            "outputs": pending.outputs,
            "fetch_names": self.frozen.fetch_names,
            "weight_epoch": pending.weight_epoch,
            "queue_ms": round((time.monotonic() - pending.t_admit) * 1e3,
                              3),
        }

    def generate(self, prompt, max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 stream: bool = False,
                 request_id: Optional[str] = None,
                 retry: bool = False,
                 resume_tokens: Optional[list] = None,
                 elapsed_ms: Optional[float] = None,
                 expect_epoch: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 seed: Optional[int] = None,
                 top_p: Optional[float] = None) -> dict:
        """Autoregressive generation (requires an attached engine).

        Blocking form returns the full token list; ``stream=True``
        returns a ``stream_id`` the client polls with `generate_poll`
        for incremental tokens (the PS RPC transport is one-shot
        request/reply, so streaming is poll-based).

        Exactly-once: ``request_id`` + the transport's ``retry``
        marker form the same dedup contract the PS data plane uses for
        (trainer_id, step) — a marked retry whose id is already known
        reattaches to the in-flight request or replays the finished
        reply; the model never runs twice.  ``resume_tokens`` +
        ``elapsed_ms`` + ``expect_epoch`` are the failover-resume state:
        tokens already delivered become the new prefill prefix, the SLO
        clock is backdated by elapsed_ms, and an epoch mismatch is
        refused with the typed ResumedOnNewWeights string."""
        if self.engine is None:
            raise ValueError("generation is not enabled on this replica "
                             "(no decoder engine attached)")
        rid = str(request_id) if request_id else None
        if rid and retry and self._resume_on:
            with self._streams_lock:
                ent = self._dedup.get(rid)
            if ent is not None:
                _REG.counter(
                    "serve_gen_dedup_hits_total",
                    help="marked-retry generates that reattached or "
                         "replayed instead of running twice").inc()
                # the retry's own server span records that it replayed
                # instead of decoding — the trace shows ONE engine
                # residency plus a cheap reattach hop
                _tracing.annotate(dedup_hit=True)
                if ent.get("stream_id") is not None:
                    return {"stream_id": ent["stream_id"]}
                if ent.get("reply") is not None:
                    return ent["reply"]
                reply = self.engine.result(ent["req"])
                ent["reply"] = reply
                return reply
        req = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                 deadline_ms=deadline_ms, eos_id=eos_id,
                                 resume_tokens=resume_tokens,
                                 elapsed_ms=elapsed_ms,
                                 expect_epoch=expect_epoch,
                                 temperature=temperature, top_k=top_k,
                                 seed=seed, top_p=top_p)
        ent = None
        if rid and self._resume_on:
            ent = {"req": req, "stream_id": None, "reply": None}
            with self._streams_lock:
                self._dedup[rid] = ent
                while len(self._dedup) > DEDUP_MAX:
                    self._dedup.popitem(last=False)
        if stream:
            with self._streams_lock:
                self._stream_seq += 1
                sid = f"g{self._stream_seq}"
                self._streams[sid] = req
                if ent is not None:
                    ent["stream_id"] = sid
            return {"stream_id": sid}
        reply = self.engine.result(req)
        if ent is not None:
            ent["reply"] = reply
        return reply

    def generate_poll(self, stream_id: str, cursor: int = 0) -> dict:
        with self._streams_lock:
            req = (self._streams.get(stream_id)
                   or self._done_streams.get(stream_id))
        if req is None:
            raise ValueError(f"unknown stream {stream_id!r}")
        snap = req.snapshot(int(cursor))
        if snap["done"]:
            with self._streams_lock:
                live = self._streams.pop(stream_id, None)
                if live is not None and self._resume_on:
                    # retain (bounded) so a retried poll after an
                    # ambiguous failure replays the final snapshot
                    self._done_streams[stream_id] = live
                    while len(self._done_streams) > DEDUP_MAX:
                        self._done_streams.popitem(last=False)
        return snap

    def health(self) -> dict:
        return {
            "ok": not self.batcher._draining,
            "draining": self.batcher._draining,
            "weight_epoch": self.batcher.weight_epoch,
            "queue_depth": self.batcher.queue_depth(),
            "uptime_s": round(time.time() - self.started_at, 3),
        }

    def stats(self) -> dict:
        from ..distributed.ps_server import server_telemetry
        from ..ops.kernels import launch_counts

        out = {
            "serving": self.batcher.stats(),
            "model": self.frozen.model_info(),
            "server": server_telemetry(),
            "weight_sync": {
                "enabled": self.subscriber is not None,
                "version": (self.subscriber.version
                            if self.subscriber else None),
            },
            # the kernel wrappers' counts in this process: a caller in
            # another one reads which kernels its requests launched
            "kernel_launches": launch_counts(),
        }
        if self.engine is not None:
            out["generation"] = self.engine.stats()
            out["generation"]["dedup_hits_total"] = _REG.counter(
                "serve_gen_dedup_hits_total").value
        return out

    def handle(self, method: str, kwargs: dict):
        from ..distributed import faults

        inj = faults.injector()
        if inj is not None:
            # the PSServer.handle contract: deterministic server-side
            # fault rules (slow/kill/partition) apply to serving verbs
            # too — the slow-tail hedge drill and kill drills ride this
            inj.on_server_call(method)
        if kwargs.get("retry"):
            # transport marked this as a retry whose first attempt may
            # have landed (the PS _MARK_RETRY contract) — counted so
            # drills can prove the dedup table saw the replay
            _REG.counter("serve_retry_received_total",
                         help="RPCs carrying the ambiguous-retry marker",
                         verb=method).inc()
        if method == "ping":
            return "pong"
        if method == "infer":
            return self.infer(kwargs["feed"], kwargs.get("deadline_ms"))
        if method == "generate":
            return self.generate(
                kwargs["prompt"],
                max_new_tokens=int(kwargs.get("max_new_tokens", 16)),
                deadline_ms=kwargs.get("deadline_ms"),
                eos_id=kwargs.get("eos_id"),
                stream=bool(kwargs.get("stream", False)),
                request_id=kwargs.get("request_id"),
                retry=bool(kwargs.get("retry", False)),
                resume_tokens=kwargs.get("resume_tokens"),
                elapsed_ms=kwargs.get("elapsed_ms"),
                expect_epoch=kwargs.get("expect_epoch"),
                temperature=kwargs.get("temperature"),
                top_k=kwargs.get("top_k"),
                seed=kwargs.get("seed"),
                top_p=kwargs.get("top_p"))
        if method == "generate_poll":
            return self.generate_poll(kwargs["stream_id"],
                                      int(kwargs.get("cursor", 0)))
        if method == "model_info":
            return self.frozen.model_info()
        if method == "health":
            return self.health()
        if method == "stats":
            return self.stats()
        if method == "drain":
            t = float(kwargs.get("timeout", 30.0))
            drained = self.batcher.drain(timeout=t)
            if self.engine is not None:
                drained = self.engine.drain(timeout=t) and drained
            return {"drained": drained}
        if method == "shutdown":
            self.begin_drain()
            self.shutdown_event.set()
            return 0
        raise ValueError(f"unknown serving verb {method!r}")

    # -- lifecycle -------------------------------------------------------
    def begin_drain(self) -> None:
        with self.batcher._cond:
            self.batcher._draining = True
            self.batcher._cond.notify_all()
        if self.engine is not None:
            with self.engine._cond:
                self.engine._draining = True
                self.engine._cond.notify_all()

    def close(self) -> None:
        global _ACTIVE

        if self.subscriber is not None:
            self.subscriber.stop()
        self.batcher.stop()
        if self.engine is not None:
            self.engine.stop()
        if _ACTIVE is self:
            _ACTIVE = None


def current_status() -> Optional[dict]:
    """The active server's serving stats, or None — the debugz /statusz
    serving row (cheap: one module global)."""
    srv = _ACTIVE
    if srv is None:
        return None
    try:
        return srv.batcher.stats()
    except Exception:  # noqa: BLE001 — status pages never crash
        return None


def current_servez() -> Optional[dict]:
    """The active server's per-request generation view — the debugz
    /servez payload (active slots, queued requests, recent completions
    slowest-first). None when no server or no engine is attached."""
    srv = _ACTIVE
    if srv is None or srv.engine is None:
        return None
    try:
        out = srv.engine.servez()
        out["dedup_hits_total"] = _REG.counter(
            "serve_gen_dedup_hits_total").value
        return out
    except Exception:  # noqa: BLE001 — status pages never crash
        return None


# ---------------------------------------------------------------------------
# process entry (one serving replica)
# ---------------------------------------------------------------------------


def _maybe_build_engine(device=None):
    """PADDLE_SERVE_GEN=1 attaches a generation engine to the replica
    (the tiny decoder, on ``device``; real deployments construct their
    own engine and pass it to InferenceServer).  Sized by the
    PADDLE_SERVE_KV_* envs.  PADDLE_SERVE_GEN_CONFIG, a JSON object of
    ``DecoderConfig`` fields, widens the decoder: the tiny default's
    head_dim of 16 is not one the card's paged-attention kernel takes
    (64, 128, 256)."""
    if os.environ.get("PADDLE_SERVE_GEN", "") in ("", "0", "false"):
        return None
    from . import decode_model as _dm
    from .engine import GenerationEngine

    cfg = _dm.DecoderConfig(**json.loads(
        os.environ.get("PADDLE_SERVE_GEN_CONFIG") or "{}"))
    seed = int(os.environ.get("PADDLE_SERVE_GEN_SEED", "0"))
    return GenerationEngine(_dm.TinyDecoderLM(cfg, seed=seed, device=device))


# environment that arms a module the port does not have yet: serve()
# refuses to start rather than run without it
_NOT_PORTED_ENV = (
    ("PADDLE_DEBUGZ_PORT", "the debugz pages (telemetry/debugz.py, "
     "ROADMAP A8)"),
)


def _refuse_unported_env() -> None:
    for env, what in _NOT_PORTED_ENV:
        if os.environ.get(env):
            raise NotImplementedError(
                f"{env} is set, but {what} is not ported yet; unset it to "
                f"serve without it")


def serve(frozen: FrozenModel, port: int = 0, host: str = "0.0.0.0",
          ready_cb=None, max_batch: int = DEFAULT_MAX_BATCH,
          queue_depth: int = DEFAULT_QUEUE_DEPTH,
          drain_grace: float = 30.0, engine=None, device=None):
    """Run one serving replica (blocks) on ``device`` (None: the CUDA
    card). Mirrors ps_server.serve: the same _TCPServer/_Handler
    transport, the heartbeat stamps (PADDLE_HEARTBEAT_DIR with a trainer
    or PS tag) and a coordinator lease of kind "inference" carrying the
    batcher's stats (PADDLE_COORDINATOR_ENDPOINT), the push exporters
    (PADDLE_METRICS_PUSH_URL, PADDLE_TRACES_PUSH_URL); with live weights
    the port is bound after the first round of the weight table is
    installed; SIGTERM -> graceful drain -> every thread stopped ->
    return (exit 0 from ``main``)."""
    from ..distributed.ps_server import _Handler, _TCPServer

    _refuse_unported_env()
    _tracing.maybe_install_hooks()
    # span/metrics export off the replica (ps_server.serve pattern):
    # serving spans land in the same ring as training spans and leave
    # through the OTLP push exporter.  Env unset = zero network, zero
    # threads.
    try:
        from ..telemetry import export as _export

        _export.maybe_start()
        _export.maybe_start_traces()
    except Exception:  # noqa: BLE001 — telemetry must not stop serving
        _export = None
    if engine is None:
        engine = _maybe_build_engine(device)
    inf = InferenceServer(frozen, max_batch=max_batch,
                          queue_depth=queue_depth, engine=engine,
                          device=device)
    if inf.subscriber is not None:
        # live weights: the port is bound only once the subscriber's
        # first round of the table is in and installed, so a replica
        # (a respawn above all) never answers with the export's weights
        # where the table holds newer ones.  The JAX package binds first
        # and serves them until its first poll lands (ROADMAP section C).
        inf.subscriber.first_round.wait()
        inf.batcher._maybe_adopt_weights()
    try:
        srv = _TCPServer((host, port), _Handler)
    except BaseException:
        inf.close()
        raise
    srv.ps = inf  # type: ignore[attr-defined] — _Handler contract

    # graceful drain: SIGTERM stops admission (new infers bounce with
    # "Overloaded: draining"), in-flight + queued requests finish, then
    # the event loop stops — zero accepted requests dropped
    def _sigterm(signum, frame):
        def _drain_and_exit():
            print("[inference_server] SIGTERM: draining "
                  f"(queue={inf.batcher.queue_depth()})",
                  file=sys.stderr, flush=True)
            inf.begin_drain()
            inf.batcher.drain(timeout=drain_grace)
            if inf.engine is not None:
                inf.engine.drain(timeout=drain_grace)
            inf.shutdown_event.set()
            srv.shutdown()

        threading.Thread(target=_drain_and_exit, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (in-process tests drive drain directly)

    hb = None
    hb_dir = os.environ.get("PADDLE_HEARTBEAT_DIR")
    hb_tag = os.environ.get("PADDLE_TRAINER_TAG") or os.environ.get(
        "PADDLE_PS_RANK_TAG")
    if hb_dir and hb_tag:
        from ..distributed.heartbeat import HeartBeatWorker

        # a replica in a launcher's trainer slot stamps under its rank,
        # the name the launcher's HeartBeatMonitor reads (the JAX
        # package stamps under the tag, which the monitor never reads:
        # its serving jobs abort once the startup grace runs out)
        rank = os.environ.get("PADDLE_TRAINER_ID")
        who = int(rank) if os.environ.get("PADDLE_TRAINER_TAG") and \
            rank is not None else hb_tag
        hb = HeartBeatWorker(hb_dir, who).start()
    bound_host, bound_port = srv.server_address[0], srv.server_address[1]
    if bound_host in ("0.0.0.0", ""):
        bound_host = "127.0.0.1"
    lease_worker = None
    try:
        from ..distributed import coordinator as _coord

        lease_worker = _coord.maybe_start_lease_worker(
            kind="inference", tag=hb_tag,
            self_endpoint=f"{bound_host}:{bound_port}",
            payload_fn=lambda: {"serving": inf.batcher.stats()})
    except Exception as e:  # noqa: BLE001 — leases are advisory here
        print(f"[inference_server] lease worker failed to start: {e}",
              file=sys.stderr, flush=True)
    if ready_cb is not None:
        ready_cb(srv.server_address)
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        if hb is not None:
            # the last stamp says the replica is exiting: its teardown
            # is not read as a hang by the launcher's monitor
            hb.stop(exiting=True)
        if lease_worker is not None:
            lease_worker.stop()
        srv.close_all_connections()
        srv.server_close()
        inf.close()
        try:
            # final synchronous flush: spans from the last requests
            # leave the replica before the process does
            if _export is not None and _export.active_traces():
                _export.active_traces().flush()
        except Exception:  # noqa: BLE001 — best-effort on the way out
            pass
        _tracing.shutdown_dump()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.inference.server")
    p.add_argument("--model_dir", required=True,
                   help="fluid.io.save_inference_model output dir")
    p.add_argument("--port", type=int, default=None,
                   help="default: the port of PADDLE_CURRENT_ENDPOINT, "
                        "else an ephemeral port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--max_batch", type=int, default=DEFAULT_MAX_BATCH)
    p.add_argument("--queue_depth", type=int, default=DEFAULT_QUEUE_DEPTH)
    p.add_argument("--drain_grace", type=float, default=float(
        os.environ.get("PADDLE_SERVE_DRAIN_GRACE", 30.0)))
    p.add_argument("--device", default=None,
                   help="torch device the model runs on (default: the "
                        "CUDA card; 'cpu' asks for the CPU)")
    args = p.parse_args(argv)

    port = args.port
    if port is None:
        ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        port = int(ep.rsplit(":", 1)[1]) if ":" in ep else 0

    frozen = load_frozen(args.model_dir, device=args.device)

    def ready(addr):
        # the launcher/tests read this line to learn the bound port
        print(f"[inference_server] listening on {addr[0]}:{addr[1]}",
              flush=True)

    serve(frozen, port=port, host=args.host, ready_cb=ready,
          max_batch=args.max_batch, queue_depth=args.queue_depth,
          drain_grace=args.drain_grace, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
