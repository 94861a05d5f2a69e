"""The PS RPC transport, ported from the JAX package's
``distributed/ps_server.py``: framing, the threaded TCP server with its
per-verb handler, and the pooled retrying client connection.  The
serving replica (``inference/server.py``) runs behind it, and its
client (``inference/client.py``) calls through it.

Wire format: 8-byte big-endian length + pickle (trusted cluster
transport).  A request is ``(method, kwargs)``; a reply is ``(True,
result)`` or ``(False, "Type: message")``.  The bytes are the JAX
package's, so either package's client talks to either package's server;
results hold numpy arrays and plain Python values, never torch tensors.

Handler contract: ``_TCPServer.ps`` is an object with ``handle(method,
kwargs)`` and a ``shutdown_event``; ``_Handler`` pops the ``_trace``
header (telemetry/tracing.py), counts ``ps_server_*`` series, and ships
exceptions back as error replies.  ``_Conn.call`` retries transport
faults with jittered exponential backoff (bounded by attempts or by a
deadline), marks replays of dedup'd verbs with ``retry=True``, and
consults the fault injector (``faults.py``: drop/refuse/delay/stall).

Not ported yet (the PS half of ROADMAP A6): the parameter
server itself — ``PSServer`` (tables, sync barriers, snapshots,
replication), ``RemoteTable``, and this module's ``serve``/``main``.
"""
from __future__ import annotations

import os
import pickle
import random
import socket
import socketserver
import struct
import threading
import time
from typing import List, Optional

from . import faults
from ..telemetry import get_registry
from ..telemetry import tracing as _tracing

_LEN = struct.Struct(">Q")

# process metrics registry: client- and server-side series use disjoint
# name prefixes (ps_client_* / ps_server_*) so in-process test servers
# sharing the registry stay distinguishable
_REG = get_registry()

# a sync barrier that outlives this window means a peer died mid-round;
# the client's default socket timeout is sized past it
SYNC_TIMEOUT = float(os.environ.get("PADDLE_PS_SYNC_TIMEOUT", 120.0))

# client retry envelope: total in-band wait ~= sum of capped backoffs,
# sized to ride out a supervised server restart with room to spare
RPC_MAX_RETRIES = int(os.environ.get("PADDLE_PS_RPC_RETRIES", 10))
RPC_BACKOFF_BASE = float(os.environ.get("PADDLE_PS_RPC_BACKOFF", 0.05))
RPC_BACKOFF_CAP = float(os.environ.get("PADDLE_PS_RPC_BACKOFF_CAP", 2.0))

# overall per-RPC deadline (seconds): when > 0 the retry LOOP is bounded
# by wall time, not attempt count — the knob that makes failover trigger
# in bounded time instead of riding the backoff ladder
RPC_DEADLINE = float(os.environ.get("PADDLE_PS_CALL_DEADLINE_SECS", 0) or 0)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, obj) -> int:
    """Returns wire bytes written (framing + payload) for telemetry."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return _LEN.size + len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the PS connection")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


def _recv_msg_sized(sock: socket.socket):
    """(message, wire bytes read) — the telemetry-aware receive."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n)), _LEN.size + n


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


def server_telemetry() -> dict:
    """This process's ps_server_* registry slice, JSON-ready — the
    payload of the `stats` verb. Histograms dump as summaries
    (count/sum/min/max/avg, plus the slowest-sample trace exemplar when
    tracing stamped one); the Prometheus exposition carries full
    buckets for scrapers."""
    snap = _REG.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("ps_server_")}


def client_telemetry() -> dict:
    """The ps_client_* slice of THIS process's registry — per-verb
    latency histograms (exemplars included), retry/failover/hedge
    counters. RemoteTable.stats() attaches it so one stats() call shows
    both ends of the data plane."""
    snap = _REG.snapshot()
    return {k: v for k, v in snap.items() if k.startswith("ps_client_")}


def _server_span_attrs(method: str, kwargs: dict) -> dict:
    """Small, always-picklable span attributes for a server-side verb:
    enough identity for tracetop to group sync rounds and name culprits
    without ever copying a payload array."""
    attrs = {"verb": method}
    for k, out in (("name", "table"), ("key", "table"), ("tag", "tag"),
                   ("partition", "partition"), ("trainer_id", "trainer"),
                   ("epoch", "epoch")):
        v = kwargs.get(k)
        if v is not None:
            attrs[out] = v
    # one `round` key for whatever the verb calls its sequence number
    for k in ("step", "seq"):
        if kwargs.get(k) is not None:
            attrs["round"] = kwargs[k]
            break
    if kwargs.get("retry"):
        attrs["retry"] = True
    return attrs


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.server.track(self.request)  # type: ignore[attr-defined]
        srv = self.server.ps  # type: ignore[attr-defined]
        while True:
            try:
                (method, kwargs), n_in = _recv_msg_sized(self.request)
            except (ConnectionError, EOFError):
                return
            # trace context: popped BEFORE dispatch so verbs
            # never see it; a traced client against an untraced server
            # costs this one dict op and nothing else
            trace_hdr = kwargs.pop("_trace", None) \
                if isinstance(kwargs, dict) else None
            # counted at ARRIVAL, not after the reply: an RPC whose
            # client vanished mid-round-trip was still handled and must
            # show in the books deterministically
            _REG.counter("ps_server_rpc_total", verb=method).inc()
            _REG.counter("ps_server_bytes_in_total", verb=method).inc(n_in)
            t0 = time.perf_counter()
            with _tracing.server_span(
                    f"server:{method}", trace_hdr,
                    attrs=(_server_span_attrs(method, kwargs)
                           if _tracing.enabled() else None)) as ssp:
                try:
                    result = srv.handle(method, kwargs)
                    reply = (True, result)
                except BaseException as e:  # noqa: BLE001 — ship to client
                    _REG.counter("ps_server_errors_total",
                                 verb=method).inc()
                    reply = (False, f"{type(e).__name__}: {e}")
                    if ssp is not None:
                        ssp.status = f"error:{type(e).__name__}"
            _REG.histogram("ps_server_rpc_ms",
                           help="server-side verb handling latency "
                                "(sync pushes include the barrier wait)",
                           verb=method).observe(
                (time.perf_counter() - t0) * 1e3,
                trace_id=(ssp.trace_id if ssp is not None else None))
            try:
                n_out = _send_msg(self.request, reply)
            except OSError:
                return  # peer gone; the retry path owns recovery
            _REG.counter("ps_server_bytes_out_total", verb=method).inc(n_out)
            if srv.shutdown_event.is_set():
                threading.Thread(
                    target=self.server.shutdown, daemon=True).start()
                return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._live_conns: set = set()
        self._conn_lock = threading.Lock()

    def track(self, request) -> None:
        with self._conn_lock:
            self._live_conns.add(request)

    def close_all_connections(self) -> None:
        """Hard-close every open client connection (parked handler
        threads wake with EOF). Used to simulate an abrupt pserver
        death for in-process failover tests, and by serve()'s teardown
        so a shut-down server can never keep answering on sockets that
        outlived the listener."""
        with self._conn_lock:
            conns, self._live_conns = list(self._live_conns), set()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _Conn:
    """Pooled client connections to ONE endpoint. Pooling (not one shared
    socket) matters: a sync-mode push BLOCKS in the server barrier, and a
    second table's push or a gather from another runtime thread must not
    queue behind it — the cross-table ordering deadlock the reference
    avoids with per-request gRPC calls (grpc_client.h AsyncSendVar).

    call() retries transport faults (ConnectionError / EOF / timeout /
    refused connect) with exponential backoff + jitter and a fresh
    socket per attempt, so a pserver restart is invisible to the caller.
    Replay-sensitive verbs (push_gradients, push_delta) are marked
    `retry=True` from the second attempt on; the server's dedup keys
    make the replay apply-once. Application errors the server REPLIED
    with are never retried — the RPC itself succeeded."""

    # verbs whose replay the server dedups: (trainer_id, step|seq) on
    # the PS plane, request_id on the serving plane's generate
    _MARK_RETRY = ("push_gradients", "push_delta", "generate")

    def __init__(self, endpoint: str, deadline: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 io_timeout: Optional[float] = None):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self.addr = (host, int(port))
        # deadline > 0: the retry LOOP is bounded by wall time (failover
        # in bounded time); 0/None: attempt-count bound, exactly the
        # pre-deadline behavior (PADDLE_PS_CALL_DEADLINE_SECS).
        # max_attempts additionally caps attempts UNDER a deadline —
        # replication forwards use it so a dead backup (instant refused
        # connects) is dropped immediately instead of riding out the
        # whole deadline meant for hung peers.
        # io_timeout is the SOCKET timeout: it defaults to the sync-
        # barrier envelope because a sync push legitimately BLOCKS in
        # the server barrier — a short recv timeout there would read a
        # slow peer trainer as a dead pserver and promote over live
        # data. Only quick admin verbs (probes, forwards, resync) pass
        # a short one.
        self.deadline = float(RPC_DEADLINE if deadline is None else deadline)
        self.max_attempts = max_attempts
        self.io_timeout = float(SYNC_TIMEOUT + 30 if io_timeout is None
                                else io_timeout)
        self._free: List[socket.socket] = []
        self._lock = threading.Lock()

    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._free:
                return self._free.pop()
        s = socket.create_connection(self.addr, timeout=self.io_timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def call(self, method: str, **kwargs):
        # causal tracing: one client span for the whole RPC,
        # a child span per attempt (its id rides the payload as the
        # `_trace` traceparent so the server's handling parents under
        # THAT attempt) and per backoff sleep. Tracing off: rpc_span is
        # None, every guard below is one is-None check, and kwargs gains
        # no key — the wire bytes are bit-identical.
        rpc_span = _tracing.begin(
            f"rpc:{method}", kind="client",
            attrs={"peer": self.endpoint, "verb": method})
        try:
            return self._call_traced(rpc_span, method, kwargs)
        except BaseException as e:
            if rpc_span is not None:
                rpc_span.status = f"error:{type(e).__name__}"
            raise
        finally:
            _tracing.finish(rpc_span)

    def _call_traced(self, rpc_span, method: str, kwargs: dict):
        inj = faults.injector()
        last_err: Optional[BaseException] = None
        t_rpc = time.perf_counter()
        deadline_t = t_rpc + self.deadline if self.deadline > 0 else None
        sent_bytes = rcvd_bytes = 0
        attempt = 0
        while True:
            if attempt:
                if method in self._MARK_RETRY:
                    kwargs["retry"] = True
                back = min(RPC_BACKOFF_CAP,
                           RPC_BACKOFF_BASE * (2 ** (attempt - 1)))
                back *= 0.5 + random.random()  # jittered
                if deadline_t is not None:
                    # never sleep past the deadline; give up at it
                    remaining = deadline_t - time.perf_counter()
                    if remaining <= 0:
                        break
                    back = min(back, remaining)
                bo_span = _tracing.begin("backoff", parent=rpc_span,
                                         attrs={"after_attempt": attempt})
                time.sleep(back)
                _tracing.finish(bo_span)
            s = None
            att_span = _tracing.begin(f"attempt:{method}", kind="client",
                                      parent=rpc_span,
                                      attrs={"n": attempt + 1})
            if att_span is not None:
                kwargs["_trace"] = _tracing.header_for(att_span)
            try:
                s = self._checkout()
                if inj is not None:
                    inj.before_send(method)  # refuse/delay/stall rules
                sent_bytes += _send_msg(s, (method, kwargs))
                if inj is not None and inj.drop_after_send(method):
                    raise faults.FaultError(
                        f"fault injection: dropped connection after "
                        f"sending {method!r}")
                (ok, result), n_in = _recv_msg_sized(s)
                rcvd_bytes += n_in
            except (OSError, EOFError) as e:
                # includes ConnectionError, socket.timeout, refused
                # connects while a supervised pserver restarts
                _tracing.finish(att_span,
                                status=f"transport:{type(e).__name__}")
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                last_err = e
                attempt += 1
                if self.max_attempts is not None \
                        and attempt >= self.max_attempts:
                    break
                if deadline_t is not None:
                    if time.perf_counter() >= deadline_t:
                        break
                    continue  # time remains: the deadline is the bound
                if attempt > RPC_MAX_RETRIES:
                    break
                continue
            except BaseException:
                _tracing.finish(att_span, status="error")
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                raise
            _tracing.finish(att_span,
                            status=None if ok else "app_error")
            with self._lock:
                self._free.append(s)
            # per-verb client telemetry: wall latency INCLUDING backoff
            # (what the training step actually waited), retries, bytes;
            # the trace_id rides as the histogram's slowest-sample
            # exemplar, so a latency scrape names a trace to pull
            _REG.histogram("ps_client_rpc_ms",
                           help="client RPC wall latency incl. retries",
                           verb=method).observe(
                (time.perf_counter() - t_rpc) * 1e3,
                trace_id=(rpc_span.trace_id if rpc_span is not None
                          else None))
            _REG.counter("ps_client_rpc_total", verb=method).inc()
            if attempt:
                _REG.counter("ps_client_retries_total",
                             help="retried RPC attempts",
                             verb=method).inc(attempt)
            _REG.counter("ps_client_bytes_sent_total",
                         verb=method).inc(sent_bytes)
            _REG.counter("ps_client_bytes_received_total",
                         verb=method).inc(rcvd_bytes)
            if not ok:
                _REG.counter("ps_client_app_errors_total",
                             verb=method).inc()
                raise RuntimeError(f"pserver {self.addr}: {result}")
            return result
        _REG.counter("ps_client_rpc_failed_total", verb=method).inc()
        if deadline_t is not None:
            raise ConnectionError(
                f"pserver {self.addr}: RPC {method!r} exceeded its "
                f"{self.deadline}s deadline after {attempt} attempts: "
                f"{last_err}") from last_err
        raise ConnectionError(
            f"pserver {self.addr}: RPC {method!r} still failing after "
            f"{attempt} attempts: {last_err}") from last_err

    def close(self):
        with self._lock:
            for s in self._free:
                try:
                    s.close()
                except OSError:
                    pass
            self._free.clear()
