"""Inference client: replica-set failover + hedged requests over the
hardened PS transport, ported from the JAX package's
``inference/client.py``.  The wire is the JAX package's, so this client
talks to either package's replica, and the JAX client to this one's.

`InferenceClient` talks to N serving replicas through `_Conn` (retries
with backoff, per-RPC deadlines, fault injection, trace spans — the
exact client the training data plane hardened). On top it adds:

  failover  — a replica whose deadline-capped retry budget is exhausted
              is marked down and the BEST live replica is promoted (the
              RemoteTable `_failover` shape: probe every candidate's
              `health`, rank by (not draining, weight_epoch, chain
              order)); `infer` is idempotent, so the request replays on
              the new replica — zero accepted requests lost. A rejoin
              probe re-enables the dead endpoint once it answers again.
  hedging   — after the infer latency histogram's quantile
              (PADDLE_SERVE_HEDGE_QUANTILE, default p95) a hedge is
              raced against another replica; first response wins — the
              slow-tail drill's contract.
  deadlines — `infer(deadline_ms=...)` rides the wire so the server's
              admission control sheds what it cannot finish in time;
              the client maps the explicit refusals onto typed errors
              (OverloadedError / DeadlineExceededError) instead of
              retrying a reply the server already made deliberately.
  resume    — `generate`/`generate_stream` survive a mid-request
              replica death: every generation carries a client-
              stamped request id, so a retry against the SAME replica
              reattaches to the in-flight stream (server-side dedup,
              exactly-once) and a retry against a PROMOTED replica
              re-issues as a resume — original prompt plus the tokens
              already delivered become the new prefill prefix, and the
              elapsed wall time rides along so failover never resets
              SLO accounting. Greedy decode is deterministic, so within
              one weight epoch the resumed tail is bit-identical to the
              uninterrupted run; a cross-epoch resume is REFUSED by the
              server and surfaces as ResumedOnNewWeightsError with the
              partial tokens attached.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..telemetry import get_registry
from ..telemetry import tracing as _tracing

_REG = get_registry()

HEDGE_QUANTILE = float(os.environ.get("PADDLE_SERVE_HEDGE_QUANTILE",
                                      0.95) or 0)
HEDGE_MIN_SAMPLES = int(os.environ.get("PADDLE_SERVE_HEDGE_MIN_SAMPLES",
                                       16))
CLIENT_DEADLINE = float(os.environ.get("PADDLE_SERVE_CLIENT_DEADLINE_SECS",
                                       10.0))
REJOIN_SECS = float(os.environ.get("PADDLE_SERVE_REJOIN_SECS", 60.0))


class OverloadedError(RuntimeError):
    """The server REFUSED admission (queue full / draining / projected
    wait past the deadline). Deliberate load shedding — back off or try
    a less loaded replica; blind retry against the same one is exactly
    the retry storm admission control exists to prevent."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before the server could serve it."""


class ResumedOnNewWeightsError(RuntimeError):
    """A generation resume landed on a replica serving a different
    weight epoch than the one that produced the already-delivered
    tokens. Splicing the tail on silently would hand the caller a
    sequence no single model ever produced, so the server refuses and
    the client surfaces the refusal typed. `.tokens` carries the
    partial output delivered before the cut — the caller decides
    whether to keep it or regenerate from scratch on the new weights."""

    def __init__(self, msg: str, tokens: Optional[List[int]] = None):
        super().__init__(msg)
        self.tokens: List[int] = list(tokens or [])


class InferResult:
    __slots__ = ("outputs", "fetch_names", "weight_epoch", "replica",
                 "queue_ms")

    def __init__(self, reply: dict, replica: str):
        self.outputs = [np.asarray(o) for o in reply["outputs"]]
        self.fetch_names = list(reply.get("fetch_names") or [])
        self.weight_epoch = int(reply.get("weight_epoch", 0))
        self.queue_ms = float(reply.get("queue_ms", 0.0))
        self.replica = replica

    def __getitem__(self, i):
        return self.outputs[i]


def _map_app_error(e: RuntimeError) -> BaseException:
    msg = str(e)
    if "ResumedOnNewWeights" in msg:
        return ResumedOnNewWeightsError(msg)
    if "Overloaded" in msg:
        return OverloadedError(msg)
    if "DeadlineExceeded" in msg:
        return DeadlineExceededError(msg)
    return e


class InferenceClient:
    """Failover + hedging client over a serving replica set."""

    def __init__(self, endpoints: Sequence[str],
                 deadline_secs: Optional[float] = None,
                 hedge_quantile: Optional[float] = None,
                 hedge_min_samples: Optional[int] = None):
        from ..distributed.ps_server import _Conn

        if not endpoints:
            raise ValueError("InferenceClient needs at least one endpoint")
        self.endpoints = [str(e) for e in endpoints]
        self._deadline = (CLIENT_DEADLINE if deadline_secs is None
                          else float(deadline_secs))
        # io_timeout past the deadline: a request parked in the server's
        # batch queue is progress, not a dead peer
        self._conns = [_Conn(e, deadline=self._deadline,
                             io_timeout=self._deadline + 30.0)
                       for e in self.endpoints]
        self._primary = 0
        self._down: Dict[int, float] = {}  # idx -> downed-at monotonic
        self._lock = threading.RLock()
        self._closed = threading.Event()  # stops rejoin probe threads
        self._hedge_q = (HEDGE_QUANTILE if hedge_quantile is None
                         else float(hedge_quantile))
        self._hedge_min = (HEDGE_MIN_SAMPLES if hedge_min_samples is None
                           else int(hedge_min_samples))
        self._hedge_pool = None
        if len(self.endpoints) > 1 and self._hedge_q > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._hedge_pool = ThreadPoolExecutor(
                max_workers=max(4, 2 * len(self.endpoints)))

    # -- routing ---------------------------------------------------------
    def _probe(self, j: int) -> Optional[dict]:
        from ..distributed.ps_server import _Conn

        probe = _Conn(self.endpoints[j], deadline=2.0, io_timeout=10.0)
        try:
            return probe.call("health")
        except Exception:  # noqa: BLE001 — a dead candidate scores None
            return None
        finally:
            probe.close()

    def _failover(self, dead_j: int) -> None:
        """Promote the best live replica: serving (not draining) beats
        draining, then highest weight_epoch (freshest model), then
        list order. Mirrors RemoteTable._failover's promote-best-live."""
        with self._lock:
            if self._primary != dead_j:
                return  # another thread already moved on
            self._down[dead_j] = time.monotonic()
            best = None
            for j in range(len(self.endpoints)):
                if j == dead_j:
                    continue
                h = self._probe(j)
                if h is None:
                    continue
                rank = (0 if h.get("draining") else 1,
                        int(h.get("weight_epoch", 0)), -j)
                if best is None or rank > best[0]:
                    best = (rank, j)
            if best is None:
                raise ConnectionError(
                    f"all {len(self.endpoints)} serving replicas are "
                    f"unreachable (last dead: "
                    f"{self.endpoints[dead_j]})")
            self._primary = best[1]
            _REG.counter("serve_client_failovers_total").inc()
            import sys

            print(f"[serve_client] replica {self.endpoints[dead_j]} "
                  f"unreachable; failing over to "
                  f"{self.endpoints[best[1]]}", file=sys.stderr,
                  flush=True)
        self._schedule_rejoin(dead_j)

    def _schedule_rejoin(self, dead_j: int) -> None:
        def loop():
            deadline = time.monotonic() + REJOIN_SECS
            while time.monotonic() < deadline \
                    and not self._closed.is_set():
                if self._closed.wait(0.5):
                    return  # client closed: stop probing immediately
                if self._probe(dead_j) is not None:
                    with self._lock:
                        self._down.pop(dead_j, None)
                    _REG.counter("serve_client_rejoins_total").inc()
                    return

        threading.Thread(target=loop, daemon=True,
                         name=f"serve-rejoin-{dead_j}").start()

    def _call(self, method: str, hops: int = 0, **kwargs):
        with self._lock:
            j = self._primary
        try:
            return self._conns[j].call(method, **kwargs)
        except (OverloadedError, DeadlineExceededError):
            raise
        except ConnectionError:
            if hops >= len(self.endpoints):
                raise
            self._failover(j)
            return self._call(method, hops=hops + 1, **kwargs)
        except RuntimeError as e:
            raise _map_app_error(e) from None

    # -- API -------------------------------------------------------------
    def infer(self, feed: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None) -> InferResult:
        if deadline_ms is not None:
            kwargs = {"feed": feed, "deadline_ms": float(deadline_ms)}
        else:
            kwargs = {"feed": feed}
        t0 = time.perf_counter()
        try:
            if self._hedge_pool is not None:
                reply, replica = self._hedged_infer(kwargs)
            else:
                reply = self._call("infer", **kwargs)
                with self._lock:  # read AFTER: a failover moved routing
                    replica = self.endpoints[self._primary]
            return InferResult(reply, replica)
        finally:
            _REG.histogram(
                "serve_client_infer_ms",
                help="caller-observed infer latency (failover + "
                     "hedging included)").observe(
                (time.perf_counter() - t0) * 1e3)

    def _hedged_infer(self, kwargs: dict):
        """Race the primary against a second replica once the observed
        latency quantile elapses (RemoteTable._hedged_call shape). The
        infer verb is idempotent — a duplicate execution costs device
        time, never correctness. Overloaded/DeadlineExceeded are
        DELIBERATE replies: the race only ends early on success or when
        both legs errored."""
        from concurrent import futures as _fut

        hist = _REG.histogram("ps_client_rpc_ms", verb="infer")
        with self._lock:
            j = self._primary
        if hist.count < self._hedge_min or len(self.endpoints) < 2:
            reply = self._call("infer", **kwargs)
            return reply, self.endpoints[j]
        delay_s = max(hist.quantile(self._hedge_q) / 1e3, 1e-3)
        fut = self._hedge_pool.submit(_tracing.bound(
            lambda: self._call("infer", **dict(kwargs))))
        try:
            return fut.result(timeout=delay_s), self.endpoints[j]
        except _fut.TimeoutError:
            pass
        except RuntimeError:
            raise
        _REG.counter("serve_client_hedges_issued_total").inc()
        with self._lock:
            hedge_j = next(
                (k for k in range(len(self.endpoints))
                 if k != self._primary and k not in self._down),
                (self._primary + 1) % len(self.endpoints))

        def _hedge_exec():
            with _tracing.span("hedge:infer",
                               attrs={"peer": self.endpoints[hedge_j]}):
                return self._conns[hedge_j].call("infer", **dict(kwargs))

        hedge = self._hedge_pool.submit(_tracing.bound(_hedge_exec))
        pending = {fut: self.endpoints[j], hedge: self.endpoints[hedge_j]}
        last_err = None
        while pending:
            done, _ = _fut.wait(set(pending),
                                return_when=_fut.FIRST_COMPLETED)
            for f in done:
                src = pending.pop(f)
                err = f.exception()
                if err is None:
                    if f is hedge:
                        _REG.counter(
                            "serve_client_hedges_won_total").inc()
                    return f.result(), src
                last_err = err
        if isinstance(last_err, RuntimeError):
            raise _map_app_error(last_err)
        raise last_err

    class GenerateResult:
        __slots__ = ("tokens", "weight_epoch", "ttft_ms", "replica",
                     "resumed_from")

        def __init__(self, reply: dict, replica: str):
            self.tokens = list(reply["tokens"])
            self.weight_epoch = int(reply.get("weight_epoch", 0))
            self.ttft_ms = reply.get("ttft_ms")
            self.replica = replica
            # >0: the run was spliced — this many leading tokens came
            # from a previous attempt (failover / preemption resume)
            self.resumed_from = int(reply.get("resumed_from", 0) or 0)

    @staticmethod
    def _gen_kwargs(prompt, max_new_tokens, deadline_ms, eos_id,
                    temperature, top_k, top_p, seed) -> dict:
        kwargs = {"prompt": [int(t) for t in prompt],
                  "max_new_tokens": int(max_new_tokens),
                  "request_id": uuid.uuid4().hex}
        if deadline_ms is not None:
            kwargs["deadline_ms"] = float(deadline_ms)
        if eos_id is not None:
            kwargs["eos_id"] = int(eos_id)
        if temperature is not None:
            kwargs["temperature"] = float(temperature)
            if top_k is not None:
                kwargs["top_k"] = int(top_k)
            if top_p is not None:
                kwargs["top_p"] = float(top_p)
            # Sampling without a caller seed: draw one HERE so a
            # failover resume replays the exact token sequence — the
            # seed must be fixed before the first attempt, not per
            # replica.
            kwargs["seed"] = (int.from_bytes(os.urandom(4), "little")
                              if seed is None else int(seed))
        elif seed is not None:
            kwargs["seed"] = int(seed)
        return kwargs

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 seed: Optional[int] = None,
                 top_p: Optional[float] = None) -> "GenerateResult":
        """Blocking autoregressive generation on the primary replica.
        Generation is NOT hedged: a duplicate run would burn KV pages
        and decode slots on two replicas for one reply. Instead every
        call is stamped with a request id: a transport-level retry
        against the same replica reattaches to the in-flight request
        (server dedup — the model never runs twice), and a dead replica
        is failed over with the retry marker and elapsed time carried
        so the promoted replica charges the full request age against
        the deadline."""
        kwargs = self._gen_kwargs(prompt, max_new_tokens, deadline_ms,
                                  eos_id, temperature, top_k, top_p,
                                  seed)
        t0 = time.perf_counter()
        abs_deadline = (None if deadline_ms is None
                        else t0 + float(deadline_ms) / 1e3)
        hops = 0
        # root span for the WHOLE generation: the context rides every
        # attempt's RPC payload, so after a failover both replicas'
        # server+engine spans share this one trace_id
        root = _tracing.begin(
            "generate", kind="client",
            attrs={"prompt_len": len(kwargs["prompt"]),
                   "max_new_tokens": int(max_new_tokens),
                   "request_id": kwargs["request_id"]})
        ctx = (None if root is None
               else (root.trace_id, root.span_id))
        status = "error"
        try:
            while True:
                with self._lock:
                    j = self._primary
                try:
                    with _tracing.attach(ctx):
                        reply = self._conns[j].call("generate", **kwargs)
                except ConnectionError:
                    if hops >= len(self.endpoints):
                        raise
                    hops += 1
                    self._failover(j)
                    # re-issue as a marked retry: the promoted replica
                    # sees the original arrival age, not a fresh clock
                    kwargs["retry"] = True
                    kwargs["elapsed_ms"] = (time.perf_counter() - t0) * 1e3
                    if abs_deadline is not None:
                        kwargs["deadline_ms"] = max(
                            (abs_deadline - time.perf_counter()) * 1e3, 1.0)
                    continue
                except RuntimeError as e:
                    raise _map_app_error(e) from None
                with self._lock:
                    replica = self.endpoints[self._primary]
                status = None
                if root is not None:
                    root.attrs.update(replica=replica, failovers=hops)
                return self.GenerateResult(reply, replica)
        finally:
            _tracing.finish(root, status=status)
            _REG.histogram(
                "serve_client_generate_ms",
                help="caller-observed generation latency").observe(
                (time.perf_counter() - t0) * 1e3)

    def generate_stream(self, prompt: Sequence[int],
                        max_new_tokens: int = 16,
                        deadline_ms: Optional[float] = None,
                        eos_id: Optional[int] = None,
                        poll_s: float = 0.01,
                        temperature: Optional[float] = None,
                        top_k: Optional[int] = None,
                        seed: Optional[int] = None,
                        top_p: Optional[float] = None,
                        timings: Optional[dict] = None):
        """Incremental generation: yields lists of new tokens as the
        replica's decode loop produces them.  The PS transport is
        one-shot request/reply, so streaming is poll-based: `generate`
        with stream=True returns a stream id, `generate_poll` drains it.
        KV state is replica-local, so a mid-stream replica death cannot
        be retried blindly — instead the stream RESUMES: the dead
        replica is failed over and the generation re-issued with the
        tokens already delivered as the new prefill prefix, the elapsed
        time carried for SLO accounting, and the weight epoch that
        produced the delivered tokens pinned via `expect_epoch`. Within
        one epoch the resumed tail is bit-identical (greedy decode is
        deterministic; sampling is counter-mode keyed on (seed, index));
        across an epoch boundary the server refuses and the caller gets
        ResumedOnNewWeightsError with the partial tokens attached.

        ``timings``: an optional dict the client fills IN PLACE with
        caller-observed SLO numbers — ``ttft_ms`` (call start to first
        token arrival), ``tpot_avg_ms`` (mean inter-token gap),
        ``token_ts_ms`` (per-token arrival offsets from call start; the
        tokens of one poll chunk share an arrival), ``tokens``. The
        server-observed ttft is measured at admission, so the delta is
        exactly network + poll-cadence skew — measurable, not guessed."""
        base = self._gen_kwargs(prompt, max_new_tokens, deadline_ms,
                                eos_id, temperature, top_k, top_p, seed)
        base["stream"] = True
        t0 = time.perf_counter()
        abs_deadline = (None if deadline_ms is None
                        else t0 + float(deadline_ms) / 1e3)
        delivered: List[int] = []
        last_epoch: Optional[int] = None
        hops = 0
        if timings is not None:
            timings.clear()
            timings.update(ttft_ms=None, tpot_avg_ms=None,
                           token_ts_ms=[], tokens=0)

        def _note_arrival(n_new: int) -> None:
            if timings is None or n_new <= 0:
                return
            at_ms = (time.perf_counter() - t0) * 1e3
            if timings["ttft_ms"] is None:
                timings["ttft_ms"] = round(at_ms, 3)
            timings["token_ts_ms"].extend([round(at_ms, 3)] * n_new)
            timings["tokens"] += n_new
            if timings["tokens"] > 1:
                timings["tpot_avg_ms"] = round(
                    (at_ms - timings["token_ts_ms"][0])
                    / (timings["tokens"] - 1), 3)

        root = _tracing.begin(
            "generate_stream", kind="client",
            attrs={"prompt_len": len(base["prompt"]),
                   "max_new_tokens": int(max_new_tokens),
                   "request_id": base["request_id"]})
        ctx = (None if root is None
               else (root.trace_id, root.span_id))
        status = "error"
        try:
            while True:  # one iteration per (re)attach
                with self._lock:
                    j = self._primary
                kwargs = dict(base)
                if hops:
                    kwargs["retry"] = True
                    kwargs["elapsed_ms"] = (time.perf_counter() - t0) * 1e3
                    if abs_deadline is not None:
                        kwargs["deadline_ms"] = max(
                            (abs_deadline - time.perf_counter()) * 1e3, 1.0)
                    if delivered:
                        kwargs["resume_tokens"] = list(delivered)
                        if last_epoch is not None:
                            kwargs["expect_epoch"] = int(last_epoch)
                try:
                    with _tracing.attach(ctx):
                        sid = self._conns[j].call("generate",
                                                  **kwargs)["stream_id"]
                    # dedup reattach and resume both pre-seed the stream
                    # with everything already delivered: skip past it
                    cursor = len(delivered)
                    while True:
                        with _tracing.attach(ctx):
                            snap = self._conns[j].call("generate_poll",
                                                       stream_id=sid,
                                                       cursor=cursor)
                        if snap["tokens"]:
                            chunk = list(snap["tokens"])
                            _note_arrival(len(chunk))
                            delivered.extend(chunk)
                            yield chunk
                        cursor = int(snap["cursor"])
                        last_epoch = int(snap.get("weight_epoch") or 0)
                        if snap["done"]:
                            if snap.get("error"):
                                err = _map_app_error(
                                    RuntimeError(snap["error"]))
                                if isinstance(err,
                                              ResumedOnNewWeightsError):
                                    err.tokens = list(delivered)
                                raise err
                            status = None
                            if root is not None:
                                root.attrs.update(
                                    failovers=hops,
                                    tokens=len(delivered))
                            return
                        time.sleep(poll_s)
                except ConnectionError:
                    if hops >= len(self.endpoints):
                        raise
                    hops += 1
                    self._failover(j)
                    if delivered:
                        _REG.counter(
                            "serve_client_stream_resumes_total").inc()
                    continue
                except (OverloadedError, DeadlineExceededError,
                        ResumedOnNewWeightsError):
                    raise
                except RuntimeError as e:
                    err = _map_app_error(e)
                    if isinstance(err, ResumedOnNewWeightsError):
                        err.tokens = list(delivered)
                    raise err from None
        finally:
            _tracing.finish(root, status=status)

    def model_info(self) -> dict:
        return self._call("model_info")

    def health(self, replica: Optional[int] = None) -> dict:
        if replica is not None:
            return self._conns[replica].call("health")
        return self._call("health")

    def stats(self, all_replicas: bool = False):
        if not all_replicas:
            return self._call("stats")
        out = []
        for j, c in enumerate(self._conns):
            try:
                out.append({"endpoint": self.endpoints[j],
                            **c.call("stats")})
            except Exception as e:  # noqa: BLE001 — dead replica row
                out.append({"endpoint": self.endpoints[j],
                            "error": f"{type(e).__name__}: {e}"})
        return out

    def client_stats(self) -> dict:
        """This process's serve_client_* + ps_client_* registry slice."""
        snap = _REG.snapshot()
        return {k: v for k, v in snap.items()
                if k.startswith(("serve_client_", "ps_client_"))}

    def close(self) -> None:
        self._closed.set()  # rejoin probes must not outlive the client
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)
        for c in self._conns:
            c.close()
