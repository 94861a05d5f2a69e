"""Networked parameter-server data plane, ported from the JAX package's
``distributed/ps_server.py``: tables in a server PROCESS, the RPC
transport they ride on, and the trainer-side ``RemoteTable`` client.
The serving replica (``inference/server.py``) and the job coordinator
(``coordinator.py``) run behind the same transport.

The module is numpy only and never touches torch or the card: a
pserver holds its tables in host memory by design (a table larger than
the card), and a pserver process must never initialize CUDA.  Wire
bytes and snapshot files are the JAX package's, so either package's
client talks to either package's server, and a snapshot one writes
restores in the other.

Parity surface: the reference's cross-process PS runtime —
operators/distributed_ops/listen_and_serv_op.cc (server event loop),
operators/distributed/grpc/grpc_client.h:176 (async client),
operators/distributed/communicator.h:180-396 (send queues, Geo), and the
PADDLE_PSERVERS_IP_PORT_LIST / PADDLE_TRAINING_ROLE / PADDLE_PORT env
contract (fleet/base/role_maker.py:497).

The device step only ever sees [batch, dim] row slices through the
lookup op (ops/ps_ops.py), so the wire protocol is four verbs over TCP
— create / gather / push / admin — not a full RPC graph executor. One
server process (or several, round-robin row-sharded like the reference
ps_dispatcher) owns ShardedHostTable instances; N launcher-spawned
trainer processes talk to it through RemoteTable, which is duck-type
identical to the in-process table, so ops/ps_ops.py and GeoSGDClient
run unchanged on top.

Sync semantics (reference DistributeTranspiler sync_mode): in
`sync` mode the server BARRIERS each push round — it accumulates one
push per trainer, merges them (concat + dedup scatter-add, scaled
1/num_trainers: dp-mean convention, same as the framework's allreduce
mean), applies the optimizer ONCE, then releases every waiter. Two
trainers each pushing d(mean loss over their half-batch) therefore
produce exactly the single-process full-batch update. `async` skips the
barrier (Downpour: apply on arrival); `geo` trainers push deltas
(additive, no barrier) through GeoSGDClient wrapping a RemoteTable.

Fault tolerance:

  client   — every RPC runs in a retry loop: per-attempt socket, exp
             backoff with jitter, transparent reconnect on
             ConnectionError/EOF/timeout. Idempotent verbs retry freely;
             push_gradients / push_delta carry a (trainer_id, step|seq)
             dedup key and a `retry` marker so a replayed push that
             already LANDED (reply lost) is applied exactly once.
  server   — `generation` rides the create_table handshake
             (PADDLE_ELASTIC_RESTART): a restarted trainer group bumps
             it and the server RESETS the table's push barrier, so the
             half-filled round a crashed group left behind can never
             merge with — or deadlock — the new group's pushes.
  state    — periodic atomic snapshots, full or incremental
             (PADDLE_PS_SNAPSHOT_SECS / PADDLE_PS_SNAPSHOT_DIR /
             PADDLE_PS_SNAPSHOT_MODE); a supervised restart (launch.py)
             preloads them, and a client that finds its table missing
             after a server restart re-issues the idempotent
             create_table (which restores the snapshot) and replays the
             verb.
  replicas — PADDLE_PS_REPLICATION=R gives each row partition a primary
             and R-1 backups on distinct pservers: the primary forwards
             every applied write in seq order under an epoch fence; a
             client that loses the primary promotes a backup (or the
             coordinator does, on an expired lease), re-enrolls the
             respawned replica through anti-entropy (seq tail or full
             state), and hedges slow reads to a backup.
  faults   — distributed/faults.py injects drop/refuse/delay/kill/
             partition/bitflip on a deterministic schedule
             (FLAGS_ps_fault_injection + PADDLE_PS_FAULT_SPEC); flag-off
             is bit-identical.

Framing: 8-byte big-endian length + pickle (trusted cluster transport).
A request is ``(method, kwargs)``; a reply is ``(True, result)`` or
``(False, "Type: message")``; results hold numpy arrays and plain
Python values, never torch tensors.

Not ported (ROADMAP A8): the span and metrics push exporters
(telemetry/export.py); a pserver armed with PADDLE_TRACES_PUSH_URL or
PADDLE_METRICS_PUSH_URL refuses to start.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import random
import socket
import socketserver
import struct
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from . import faults
from .ps import ShardedHostTable
from ..telemetry import BYTE_BUCKETS, get_registry
from ..telemetry import sink as _metrics_sink
from ..telemetry import tracing as _tracing

_LEN = struct.Struct(">Q")

# process metrics registry (telemetry/): client- and server-
# side series use disjoint name prefixes (ps_client_* / ps_server_*) so
# in-process test servers sharing the registry stay distinguishable
_REG = get_registry()

def _arm_metrics_sink() -> None:
    """Pserver-side JSONL records on the SAME env var trainers use
    (PADDLE_METRICS_PATH, ROADMAP telemetry follow-on): the path gets a
    per-process `ps` tag (launch.py's PADDLE_PS_RANK_TAG, pid fallback)
    so a co-located trainer's rank-0 file is never interleaved. Unset =
    sink stays off and every emit below is a no-op."""
    path = os.environ.get(_metrics_sink.ENV_PATH)
    if not path:
        return
    tag = os.environ.get("PADDLE_PS_RANK_TAG") or f"ps{os.getpid()}"
    root, ext = os.path.splitext(path)
    _metrics_sink.enable(f"{root}.{tag}{ext or '.jsonl'}")


def _emit_ps_step(table: str, mode: str, step: int, rows: int,
                  apply_ms: float) -> None:
    """One kind="ps_step" JSONL record per APPLIED update — the pserver's
    analog of the trainer's kind="step" record (a sync round merges once;
    async/delta pushes apply on arrival)."""
    _metrics_sink.emit({
        "kind": "ps_step", "table": table, "mode": mode,
        "step": int(step), "rows": int(rows),
        "apply_ms": round(apply_ms, 3),
    })


# a barrier that outlives this window means a peer trainer died mid-round:
# fail fast so the launcher's watcher can abort/restart the group
SYNC_TIMEOUT = float(os.environ.get("PADDLE_PS_SYNC_TIMEOUT", 120.0))

# client retry envelope: total in-band wait ~= sum of capped backoffs,
# sized to ride out a supervised pserver restart (launch.py respawn:
# poll interval + python startup, a few seconds) with room to spare
RPC_MAX_RETRIES = int(os.environ.get("PADDLE_PS_RPC_RETRIES", 10))
RPC_BACKOFF_BASE = float(os.environ.get("PADDLE_PS_RPC_BACKOFF", 0.05))
RPC_BACKOFF_CAP = float(os.environ.get("PADDLE_PS_RPC_BACKOFF_CAP", 2.0))

# overall per-RPC deadline (seconds): when > 0 the retry LOOP is bounded
# by wall time, not attempt count — the knob that makes replicated
# failover trigger in bounded time instead of riding the backoff ladder.
# 0 (default) keeps the attempt-count bound exactly as before; a
# replicated RemoteTable defaults its connections to
# REPLICATED_DEADLINE_DEFAULT when the env is unset
RPC_DEADLINE = float(os.environ.get("PADDLE_PS_CALL_DEADLINE_SECS", 0) or 0)
REPLICATED_DEADLINE_DEFAULT = 10.0

# replication knobs (all inert at R=1):
#   hedge quantile    — read-only verbs hedge to a backup after the
#                       verb's observed latency quantile (0 disables)
#   hedge min samples — don't trust the histogram before this many obs
#   forward deadline  — how long a primary waits on a backup ack before
#                       dropping it from the forward set (it resyncs on
#                       rejoin)
#   replog keep       — per-partition ring of recent applied writes for
#                       seq-tail catch-up (anti-entropy without a full
#                       state transfer)
#   rejoin secs       — how long a client keeps trying to re-enroll a
#                       dead replica after failing over away from it
HEDGE_QUANTILE = float(os.environ.get("PADDLE_PS_HEDGE_QUANTILE", 0.95) or 0)
HEDGE_MIN_SAMPLES = int(os.environ.get("PADDLE_PS_HEDGE_MIN_SAMPLES", 16))
FORWARD_DEADLINE = float(
    os.environ.get("PADDLE_PS_FORWARD_DEADLINE_SECS", 5.0))
REPLOG_KEEP = int(os.environ.get("PADDLE_PS_REPLOG_KEEP", 256))
REJOIN_SECS = float(os.environ.get("PADDLE_PS_REJOIN_SECS", 120.0))

# incremental snapshots: compact the delta chain into a fresh base every
# N deltas (and implicitly on load — a restored chain forces a new base)
SNAPSHOT_COMPACT_EVERY = int(
    os.environ.get("PADDLE_PS_SNAPSHOT_COMPACT_EVERY", 8))


class TableMissingError(RuntimeError):
    """Server says the table does not exist — after a pserver restart the
    client re-creates it (idempotent; the server's preload_dir restores
    the latest snapshot) and replays the verb (RemoteTable._call)."""


class NotPrimaryError(RuntimeError):
    """A write verb reached a backup (or unpromoted) replica — the
    client re-resolves the partition's primary and replays."""


class StalePrimaryError(RuntimeError):
    """This replica was deposed (a newer epoch exists) or is awaiting
    resync; it must not serve until anti-entropy catches it up. Raised
    both at a deposed primary (its forward was epoch-rejected) and to
    clients that reach a stale replica."""


def _table_key(name: str, partition=None) -> str:
    """Server-side table identity. Unreplicated tables keep the bare
    name (R=1 wire + snapshot filenames byte-identical); replicated
    partitions get a `@p<idx>` suffix because one server hosts its own
    primary partition AND backup copies of its neighbours' under the
    same logical table name."""
    return name if partition is None else f"{name}@p{int(partition)}"


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


def _atomic_write(path: str, blob: bytes) -> None:
    """tmp + os.replace (the fluid/io.py contract): a crash mid-write
    can never leave a torn file at `path`."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def read_snapshot_manifest(dirname: str) -> Optional[dict]:
    """Parsed `<dirname>/manifest.json` of a PS snapshot dir, or None
    when absent/unreadable (pre-manifest snapshot dirs stay loadable —
    the per-table .pkl files are the state; the manifest is metadata)."""
    try:
        with open(os.path.join(dirname, "manifest.json")) as f:
            m = json.load(f)
        return m if isinstance(m, dict) else None
    except (OSError, ValueError):
        return None


def _validated_state(state, table, name):
    """Preload checkpoints fail LOUDLY instead of silently corrupting
    the table: a RemoteTable.state_dict() ({"servers": [...]}) unwraps
    only in the 1-server case, and the shard geometry must match the
    table this server actually hosts (a full-table checkpoint loaded
    into a multi-server PARTITION would misalign every row)."""
    if isinstance(state, dict) and "servers" in state:
        if len(state["servers"]) != 1:
            raise ValueError(
                f"preload {name!r}: checkpoint was saved from "
                f"{len(state['servers'])} pservers; restore it into the "
                f"same server count (per-server .pkl files)")
        state = state["servers"][0]
    shards = state.get("shards") if isinstance(state, dict) else None
    if shards is None:
        raise ValueError(
            f"preload {name!r}: not a table state_dict (expected a "
            f"'shards' key; got {type(state).__name__})")
    rows = sum(int(s.shape[0]) for s in shards)
    dims = {int(s.shape[1]) for s in shards}
    if rows != table.rows or dims != {table.dim}:
        raise ValueError(
            f"preload {name!r}: checkpoint geometry [{rows}, {dims}] "
            f"does not match this server's table "
            f"[{table.rows}, {table.dim}] — on multi-server deployments "
            f"each server needs ITS OWN partition checkpoint")
    if len(shards) != table.num_shards:
        raise ValueError(
            f"preload {name!r}: checkpoint has {len(shards)} shards, "
            f"table expects {table.num_shards}")
    return state


class _SyncState:
    """Per-table push barrier (sync mode): round r applies once all
    `num_trainers` contributions for r have arrived.

    Completion is tracked per-CONTRIBUTION (a token each waiter removes
    after waking) AND by an applied-round high-water mark used ONLY for
    replay dedup: `last_applied` is consulted when a push arrives with
    the `retry` marker (its first send may have landed before the
    connection died), never for first sends. Within one trainer-group
    GENERATION the mark is exact — sync rounds complete in lockstep, so
    a retried round number is either still pending (join the barrier) or
    <= last_applied (already merged: return without re-applying).

    A restarted trainer group restarts its step counter at 0, which
    would poison the high-water mark and leave half-filled rounds from
    the dead group in `rounds` — so the create_table handshake carries a
    `generation` (launch.py PADDLE_ELASTIC_RESTART) and the server swaps
    in a FRESH _SyncState when it bumps, marking the old one `reset` and
    waking its stale waiters to fail fast instead of timing out.

    `async_seen` / `delta_seen` are the barrier-less analogs: per-trainer
    high-water marks that dedup RETRIED async pushes / geo deltas.
    Downpour semantics make the high-water approximation safe: within one
    client, pushes are issued in step order, and async mode tolerates
    bounded reordering/loss by design."""

    def __init__(self, num_trainers: int):
        self.cond = threading.Condition()
        self.num = int(num_trainers)
        self.rounds: Dict[int, Dict[int, tuple]] = {}
        self.done: set = set()
        self.last_applied = -1
        self.async_seen: Dict[int, int] = {}
        self.delta_seen: Dict[int, int] = {}
        self.reset = False  # generation bumped: stale waiters fail fast


def _payload_nbytes(obj) -> int:
    """Recursive resident-byte estimate for RPC payload shapes (numpy
    arrays dominate; containers add their members). Used by the replog
    ring and table memory accounting — an estimate, not an audit."""
    if obj is None:
        return 0
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(obj, (list, tuple, set)):
        return sum(_payload_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_payload_nbytes(k) + _payload_nbytes(v)
                   for k, v in obj.items())
    if isinstance(obj, (bytes, bytearray, str)):
        return len(obj)
    return 8  # ints/floats/bools: pointer-ish


class _ReplicaState:
    """Per-hosted-partition replication state (only exists for tables
    created with a `partition` in their spec, i.e. R>1).

    Roles: None (created, not yet promoted — serves reads, rejects
    writes), "primary" (applies client writes, forwards each applied
    write to `backups` with a monotone per-partition `seq` under `lock`
    so every replica applies the identical prefix), "backup" (applies
    only `replicate` forwards in seq order; serves hedged reads).

    `epoch` is the promotion generation: a failover promotes a backup at
    epoch+1, and any forward carrying an older epoch is rejected — the
    deposed-primary fence. `log` is a bounded ring of recent applied
    writes for seq-tail catch-up (anti-entropy): a respawned replica
    that preloaded a snapshot at seq S only replays (S, seq] when the
    ring still covers it, else takes a full state transfer."""

    def __init__(self):
        self.role: Optional[str] = None
        self.epoch = 0
        self.seq = 0  # last applied replicated write
        self.backups: List[str] = []  # endpoints (primary only)
        self.conns: Dict[str, "_Conn"] = {}
        self.dropped: Dict[str, str] = {}  # endpoint -> reason
        self.log: deque = deque(maxlen=max(1, REPLOG_KEEP))
        self.lock = threading.RLock()
        self.stale = False  # deposed / awaiting resync

    def status(self) -> dict:
        with self.lock:
            return {
                "role": self.role, "epoch": self.epoch, "seq": self.seq,
                "stale": self.stale,
                "backups": list(self.backups),
                "dropped": dict(self.dropped),
            }

    def log_bytes(self) -> int:
        """Estimated resident bytes of the replication log ring — part
        of the table's memory accounting: each entry holds
        the applied write's ids + payload arrays until the ring evicts
        it, which on a hot table is REPLOG_KEEP rounds of traffic."""
        with self.lock:
            return sum(_payload_nbytes(e) for e in self.log)


class PSServer:
    """Event loop owning the host tables (listen_and_serv analog).

    preload_dir (fleet.init_server(model_dir)): when a table is first
    created, `<preload_dir>/<name>.pkl` — a `table.state_dict()` pickle
    saved by a previous run — is loaded into it, the reference's
    init_server checkpoint-restore contract. Snapshots
    (snapshot_dir/snapshot_secs) write the SAME format, so a supervised
    restart preloads the latest snapshot through this path."""

    def __init__(self, preload_dir: Optional[str] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_secs: float = 0.0,
                 snapshot_mode: Optional[str] = None):
        self.tables: Dict[str, ShardedHostTable] = {}
        self.specs: Dict[str, dict] = {}
        self.sync: Dict[str, _SyncState] = {}
        self.gens: Dict[str, int] = {}
        self.replicas: Dict[str, _ReplicaState] = {}
        self.lock = threading.Lock()
        self.shutdown_event = threading.Event()
        self.preload_dir = preload_dir
        self.snapshot_dir = snapshot_dir or None
        self.snapshot_secs = float(snapshot_secs or 0.0)
        self.snapshot_mode = (snapshot_mode or os.environ.get(
            "PADDLE_PS_SNAPSHOT_MODE", "full") or "full").lower()
        if self.snapshot_mode not in ("full", "incremental"):
            raise ValueError(
                f"PADDLE_PS_SNAPSHOT_MODE must be 'full' or "
                f"'incremental', got {self.snapshot_mode!r}")
        # incremental mode: per-table-key chain bookkeeping
        # {key: {"serial": int, "base": fname, "base_sha256": hex,
        #        "deltas": [{"file","sha256","rows"}]}}
        self._snap_chain: Dict[str, dict] = {}
        self._snap_thread: Optional[threading.Thread] = None
        # cross-job adoption: a stable snapshot dir carries a manifest
        # (snapshot epoch + trainer-group generation); a new job's
        # server picks up the epoch counter where the old job left it,
        # and serve() reports what was adopted
        self._snapshot_epoch = 0
        self.adopted_manifest: Optional[dict] = None
        if preload_dir:
            m = read_snapshot_manifest(preload_dir)
            if m is not None:
                self.adopted_manifest = m
                self._snapshot_epoch = int(m.get("snapshot_epoch", 0))

    # -- verbs -----------------------------------------------------------

    def create_table(self, spec: dict):
        """Idempotent across trainers: the first create wins; later
        creates with an IDENTICAL spec are no-ops, mismatches error.
        `generation` (not part of the identity spec) is the trainer
        group's restart attempt: a bump resets the sync barrier.
        Replicated partitions (spec carries `partition` + `replicas`)
        key the table as name@p<idx> and get a _ReplicaState; role
        assignment happens through the separate `promote` verb."""
        spec = dict(spec)
        gen = int(spec.pop("generation", 0))
        name = spec["name"]
        key = _table_key(name, spec.get("partition"))

        def identity(s: dict) -> dict:
            # sync_trainers (and the replica endpoint list) are
            # MEMBERSHIP state, not table identity: an elastic resize
            # re-creates the table at a new world size under a bumped
            # generation, and the rows must carry over
            return {k: v for k, v in s.items()
                    if k not in ("sync_trainers", "replicas")}

        with self.lock:
            if key in self.tables:
                if gen > self.gens.get(key, 0):
                    if identity(spec) != identity(self.specs[key]):
                        raise ValueError(
                            f"table {key!r} already exists with a "
                            f"different spec: {self.specs[key]} vs {spec}")
                    # elastic restart: the new group must never share
                    # barrier state (half-filled rounds, applied marks,
                    # step high-water) with the dead one; its
                    # sync_trainers is the NEW world size, so the merge
                    # denominator (dp-mean) tracks the resize
                    old = self.sync[key]
                    self.sync[key] = _SyncState(
                        int(spec.get("sync_trainers", old.num)))
                    self.specs[key] = dict(spec)
                    self.gens[key] = gen
                    with old.cond:
                        old.reset = True
                        old.cond.notify_all()
                elif spec != self.specs[key]:
                    raise ValueError(
                        f"table {key!r} already exists with a different "
                        f"spec: {self.specs[key]} vs {spec} (a changed "
                        f"sync_trainers needs a bumped generation — the "
                        f"elastic-resize handshake)")
                return {"rows": self.tables[key].rows,
                        "dim": self.tables[key].dim}
            kw = {k: v for k, v in spec.items()
                  if k not in ("name", "shape", "sync_trainers",
                               "partition", "replicas")}
            t = ShardedHostTable(name, spec["shape"], **kw)
            replica_meta = None
            if self.preload_dir:
                replica_meta = self._preload_table(t, key)
            self.tables[key] = t
            self.specs[key] = dict(spec)
            self.sync[key] = _SyncState(int(spec.get("sync_trainers", 0)))
            self.gens[key] = gen
            if "partition" in spec:
                rs = _ReplicaState()
                if replica_meta:
                    rs.seq = int(replica_meta.get("seq", 0))
                    rs.epoch = int(replica_meta.get("epoch", 0))
                self.replicas[key] = rs
            return {"rows": t.rows, "dim": t.dim}

    def _preload_table(self, t: ShardedHostTable, key: str):
        """Restore `key` from preload_dir — an incremental base+delta
        chain when the dir's manifest describes one, else the legacy
        full `<key>.pkl`. Returns the replica_meta dict ({seq, epoch})
        recorded in the newest restored file, or None."""
        m = read_snapshot_manifest(self.preload_dir)
        if m and m.get("mode") == "incremental" and \
                key in m.get("chains", {}):
            return self._restore_chain(t, key, m["chains"][key])
        path = os.path.join(self.preload_dir, f"{key}.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            state = _validated_state(pickle.load(f), t, key)
        meta = state.pop("replica_meta", None)
        t.load_state_dict(state)
        return meta

    def _restore_chain(self, t: ShardedHostTable, key: str, chain: dict):
        """base + ordered deltas, each sha256-verified; the chain stops
        LOUDLY at the first corrupt file (everything before it is intact
        thanks to atomic per-file writes) instead of silently skipping.
        The in-memory chain bookkeeping is NOT seeded, so the next
        snapshot writes a fresh base — compaction-on-load."""
        def read_verified(fname, want_sha):
            path = os.path.join(self.preload_dir, fname)
            with open(path, "rb") as f:
                blob = f.read()
            if want_sha and hashlib.sha256(blob).hexdigest() != want_sha:
                raise ValueError(f"checksum mismatch in {fname}")
            return pickle.loads(blob)

        state = _validated_state(
            read_verified(chain["base"], chain.get("base_sha256")), t, key)
        meta = state.pop("replica_meta", None)
        t.load_state_dict(state)
        for ent in chain.get("deltas", []):
            try:
                delta = read_verified(ent["file"], ent.get("sha256"))
            except (OSError, ValueError) as e:
                print(f"[ps_server] delta chain for {key!r} broken at "
                      f"{ent.get('file')}: {e}; restored up to the last "
                      f"intact delta", file=sys.stderr, flush=True)
                break
            t.apply_dirty_delta(delta)
            meta = delta.get("replica_meta", meta)
        return meta

    def _table(self, name: str, partition=None) -> ShardedHostTable:
        key = _table_key(name, partition)
        t = self.tables.get(key)
        if t is None:
            raise KeyError(f"no table {key!r} on this pserver")
        return t

    # -- replication core -------------------------------------------------

    def _check_writable(self, key: str) -> Optional[_ReplicaState]:
        """Client writes only land on the partition's current primary;
        a backup or a deposed/stale replica bounces them with a typed
        error the client resolves by re-routing."""
        rs = self.replicas.get(key)
        if rs is None:
            return None
        with rs.lock:
            if rs.stale:
                raise StalePrimaryError(
                    f"replica {key!r} was deposed (epoch {rs.epoch}) and "
                    f"awaits resync")
            if rs.role != "primary":
                raise NotPrimaryError(
                    f"replica {key!r} is {rs.role or 'unpromoted'} at "
                    f"epoch {rs.epoch}; writes go to the primary")
        return rs

    def _check_readable(self, key: str) -> None:
        """Reads are served by primaries AND backups (hedged pulls) —
        but never by a deposed replica whose copy may have diverged,
        and never by an UNPROMOTED one: a respawned server re-created
        from its (possibly stale) snapshot has role None until it
        resyncs, and serving a gather from that copy would leak stale
        rows into an otherwise bit-exact training trace."""
        rs = self.replicas.get(key)
        if rs is None:
            return
        if rs.stale:
            raise StalePrimaryError(
                f"replica {key!r} was deposed and awaits resync")
        if rs.role is None:
            raise NotPrimaryError(
                f"replica {key!r} is unpromoted (respawned, not yet "
                f"resynced); reads go to the primary or a backup")

    def _apply_replicated(self, key: str, apply_fn, op: str, ids, payload,
                          dedup: dict):
        """Apply a write and, when `key` is a replicated primary,
        forward the APPLIED form to every enrolled backup under the
        partition lock — the lock serializes (apply, seq++, forward) so
        all replicas see the identical apply prefix. Unreplicated
        tables take the bare-apply fast path (R=1 untouched)."""
        rs = self.replicas.get(key)
        if rs is None:
            apply_fn()
            return
        with rs.lock:
            apply_fn()
            if rs.role != "primary":
                return
            # seq advances and the write ring records EVERY primary
            # apply — even with zero live backups — so a replica that
            # rejoins later can catch up from the exact point it missed
            rs.seq += 1
            entry = (rs.seq, op, ids, payload, dedup)
            rs.log.append(entry)
            if rs.backups:
                self._forward(key, rs, entry)

    def _forward(self, key: str, rs: _ReplicaState, entry) -> None:
        """Synchronous fan-out of one applied write to the live backups
        (caller holds rs.lock). A backup that cannot ack within the
        forward deadline is DROPPED from the set (it will resync when it
        rejoins) so a dead replica costs bounded latency, not the job; a
        stale-epoch rejection means WE were deposed — fail the client
        write loudly so it re-routes to the real primary."""
        seq, op, ids, payload, dedup = entry
        for ep in list(rs.backups):
            if ep in rs.dropped:
                continue
            conn = rs.conns.get(ep)
            if conn is None:
                conn = rs.conns[ep] = _Conn(
                    ep, deadline=FORWARD_DEADLINE, max_attempts=3,
                    io_timeout=FORWARD_DEADLINE + 5.0)
            try:
                conn.call("replicate", key=key, epoch=rs.epoch, seq=seq,
                          op=op, ids=ids, payload=payload, dedup=dedup)
                _REG.counter("ps_server_replicate_forwarded_total",
                             help="applied writes forwarded to backups",
                             verb=op).inc()
            except ConnectionError as e:
                rs.dropped[ep] = f"unreachable: {e}"
                _REG.counter("ps_server_replica_dropped_total",
                             reason="unreachable").inc()
                print(f"[ps_server] dropping backup {ep} for {key!r}: "
                      f"unreachable ({type(e).__name__})",
                      file=sys.stderr, flush=True)
            except RuntimeError as e:
                msg = str(e)
                if "StaleEpoch" in msg:
                    # a newer primary exists: we are deposed
                    rs.stale = True
                    _REG.counter("ps_server_deposed_total").inc()
                    raise StalePrimaryError(
                        f"primary for {key!r} at epoch {rs.epoch} was "
                        f"deposed: {msg}")
                rs.dropped[ep] = f"lagging: {msg}"
                _REG.counter("ps_server_replica_dropped_total",
                             reason="lagging").inc()
                print(f"[ps_server] dropping backup {ep} for {key!r}: "
                      f"{msg}", file=sys.stderr, flush=True)

    def replicate(self, key, epoch, seq, op, ids, payload, dedup=None):
        """Backup-side apply of one forwarded write. Epoch fences a
        deposed primary (StaleEpoch → it stops serving); seq must be
        exactly last+1 — a duplicate (primary died between forward and
        client-reply; the round re-merged elsewhere) is acked without
        re-applying, a gap means we missed forwards and must resync."""
        table = self._table_by_key(key)
        rs = self.replicas.get(key)
        if rs is None:
            raise KeyError(f"no replica state for {key!r}")
        inj = faults.injector()
        if inj is not None and inj.blocks_replication():
            raise faults.FaultError(
                f"fault injection: partitioned — replicate {key!r} "
                f"seq {seq} rejected")
        with rs.lock:
            if epoch < rs.epoch:
                _REG.counter("ps_server_stale_epoch_rejected_total").inc()
                raise RuntimeError(
                    f"StaleEpoch: replicate for {key!r} carries epoch "
                    f"{epoch} < current {rs.epoch} (deposed primary)")
            if rs.stale:
                # a deposed replica's content and seq are untrustworthy;
                # acking against the inflated seq would silently skip
                # real entries — refuse until resync repairs it (the
                # forwarding primary drops us; rejoin drives resync)
                raise RuntimeError(
                    f"ReplicaGap: {key!r} was deposed and awaits "
                    f"resync; forward {seq} refused")
            if epoch > rs.epoch:
                rs.epoch = int(epoch)
                if rs.role != "backup":
                    rs.role = "backup"
                    rs.backups, rs.dropped = [], {}
            elif rs.role is None:
                rs.role = "backup"
            if seq <= rs.seq:
                _REG.counter("ps_server_replicate_dedup_total",
                             verb=op).inc()
                return {"seq": rs.seq}
            if seq != rs.seq + 1:
                raise RuntimeError(
                    f"ReplicaGap: {key!r} has seq {rs.seq}, got forward "
                    f"{seq}; resync required")
            self._apply_forward(key, table, op, ids, payload)
            rs.seq = int(seq)
            rs.log.append((rs.seq, op, ids, payload, dedup))
            self._absorb_dedup(key, dedup)
            _REG.counter("ps_server_replicate_applied_total",
                         verb=op).inc()
            return {"seq": rs.seq}

    def _apply_forward(self, key, table, op, ids, payload):
        if op == "push_gradients":
            table.push_gradients(ids, payload)
        elif op == "push_delta":
            table.push_delta(ids, payload)
        elif op == "load_state":
            table.load_state_dict(payload)
        else:
            raise ValueError(f"unknown replicated op {op!r}")

    def _absorb_dedup(self, key: str, dedup) -> None:
        """Mirror the primary's replay-dedup high-water marks onto this
        backup, so a promotion preserves exactly-once semantics for
        client retries that straddle the failover."""
        if not dedup:
            return
        st = self.sync.get(key)
        if st is None:
            return
        with st.cond:
            if "sync_step" in dedup:
                st.last_applied = max(st.last_applied,
                                      int(dedup["sync_step"]))
            if "async" in dedup:
                tid, step = dedup["async"]
                st.async_seen[tid] = max(st.async_seen.get(tid, -1),
                                         int(step))
            if "delta" in dedup:
                tid, seq = dedup["delta"]
                st.delta_seen[tid] = max(st.delta_seen.get(tid, -1),
                                         int(seq))

    def _dedup_snapshot(self, key: str) -> dict:
        st = self.sync.get(key)
        if st is None:
            return {}
        with st.cond:
            return {"last_applied": st.last_applied,
                    "async_seen": dict(st.async_seen),
                    "delta_seen": dict(st.delta_seen)}

    def _install_dedup(self, key: str, dd: dict) -> None:
        st = self.sync.get(key)
        if st is None or not dd:
            return
        with st.cond:
            st.last_applied = max(st.last_applied,
                                  int(dd.get("last_applied", -1)))
            for tid, v in (dd.get("async_seen") or {}).items():
                st.async_seen[tid] = max(st.async_seen.get(tid, -1), v)
            for tid, v in (dd.get("delta_seen") or {}).items():
                st.delta_seen[tid] = max(st.delta_seen.get(tid, -1), v)

    def _table_by_key(self, key: str) -> ShardedHostTable:
        t = self.tables.get(key)
        if t is None:
            raise KeyError(f"no table {key!r} on this pserver")
        return t

    def promote(self, key, epoch, backups):
        """Make this replica the partition's primary at `epoch`.
        Idempotent per epoch; older epochs are rejected (a client racing
        a finished failover just refreshes its routing)."""
        rs = self.replicas.get(key)
        if rs is None:
            raise KeyError(f"no replica state for {key!r}")
        with rs.lock:
            if epoch < rs.epoch or (
                    epoch == rs.epoch and rs.role == "backup"
                    and epoch > 0):
                raise RuntimeError(
                    f"StalePromote: {key!r} is {rs.role} at epoch "
                    f"{rs.epoch}; promote({epoch}) is stale")
            if epoch == rs.epoch and rs.role == "primary":
                return {"epoch": rs.epoch, "seq": rs.seq}  # idempotent
            rs.role = "primary"
            rs.epoch = int(epoch)
            rs.backups = [str(e) for e in (backups or [])]
            rs.dropped = {}
            rs.stale = False
            _REG.counter("ps_server_promotions_total").inc()
            print(f"[ps_server] promoted to PRIMARY for {key!r} "
                  f"(epoch {rs.epoch}, seq {rs.seq}, backups "
                  f"{rs.backups})", file=sys.stderr, flush=True)
            return {"epoch": rs.epoch, "seq": rs.seq}

    def fetch_replica_state(self, key, backup=None, have_seq=0):
        """Primary-side anti-entropy source: under the partition lock
        (no forward can interleave), hand back either the seq TAIL the
        requester is missing (ring still covers it) or a full state
        transfer, and enroll the requester in the forward set from this
        exact point — nothing applied after the snapshot can be missed."""
        table = self._table_by_key(key)
        rs = self.replicas.get(key)
        if rs is None:
            raise KeyError(f"no replica state for {key!r}")
        with rs.lock:
            if rs.role != "primary":
                raise NotPrimaryError(
                    f"fetch_replica_state: {key!r} is {rs.role}, not "
                    f"primary")
            have_seq = int(have_seq)
            # have_seq < 0 is an explicit full-transfer demand: a
            # deposed replica's local seq counts writes the cluster
            # never accepted, so "covered" computed from it would hand
            # back an empty tail and leave its divergence in place
            covered = have_seq >= 0 and (
                (have_seq >= rs.seq)
                or (rs.log and rs.log[0][0] <= have_seq + 1))
            if covered:
                out = {"tail": [e for e in rs.log if e[0] > have_seq]}
                _REG.counter("ps_server_resyncs_total", mode="tail").inc()
            else:
                out = {"state": table.state_dict()}
                _REG.counter("ps_server_resyncs_total", mode="full").inc()
            out.update(seq=rs.seq, epoch=rs.epoch,
                       dedup=self._dedup_snapshot(key))
            if backup:
                backup = str(backup)
                rs.dropped.pop(backup, None)
                if backup not in rs.backups:
                    rs.backups.append(backup)
            return out

    def resync(self, key, primary, self_endpoint=None):
        """Backup-side anti-entropy driver (runs on the REJOINING
        replica): pull the missing state from the current primary —
        which atomically enrolls us in its forward set — and install
        it. Called by the client's rejoin thread after a supervised
        respawn, or for a deposed replica."""
        table = self._table_by_key(key)
        rs = self.replicas.get(key)
        if rs is None:
            raise KeyError(f"no replica state for {key!r}")
        with rs.lock:
            # short io_timeout: bounds the (rare) resync-vs-forward lock
            # cycle between two replicas to seconds, not the barrier
            # envelope — the loser retries and converges
            conn = _Conn(primary, deadline=max(FORWARD_DEADLINE, 5.0),
                         io_timeout=max(FORWARD_DEADLINE, 5.0) + 5.0)
            try:
                # a deposed replica applied writes the cluster never
                # accepted: its seq is inflated and its same-numbered
                # log entries may DIFFER from the new primary's, so the
                # seq must not seed anti-entropy — demand a full state
                # transfer (have_seq=-1) instead of a tail
                have = -1 if rs.stale else rs.seq
                out = conn.call("fetch_replica_state", key=key,
                                backup=self_endpoint, have_seq=have)
            finally:
                conn.close()
            if "state" in out:
                table.load_state_dict(out["state"])
                # entries from the deposed incarnation must not survive
                # into a future promotion's tail service
                rs.log.clear()
                mode = "full"
            else:
                for seq, op, ids, payload, dedup in out["tail"]:
                    self._apply_forward(key, table, op, ids, payload)
                    self._absorb_dedup(key, dedup)
                    # keep the ring contiguous through rs.seq, so a
                    # later promotion serves gap-free tails
                    rs.log.append((seq, op, ids, payload, dedup))
                mode = "tail"
            rs.seq = int(out["seq"])
            rs.epoch = int(out["epoch"])
            rs.role = "backup"
            rs.stale = False
            self._install_dedup(key, out.get("dedup") or {})
        print(f"[ps_server] resynced {key!r} from {primary} "
              f"({mode}, seq {rs.seq}, epoch {rs.epoch}); rejoined as "
              f"backup", file=sys.stderr, flush=True)
        return {"seq": rs.seq, "epoch": rs.epoch, "mode": mode}

    def adopt_role(self, key, epoch, role):
        """Explicit role assignment for a fresh backup (the client sets
        it right after promoting the partition's first primary, so
        status pages and promotion ranking see a real backup instead of
        an unpromoted husk). Only ever an upgrade: an existing role or
        a newer epoch is left alone."""
        rs = self.replicas.get(key)
        if rs is None:
            raise KeyError(f"no replica state for {key!r}")
        with rs.lock:
            if rs.role is None and epoch >= rs.epoch:
                rs.role = str(role)
                rs.epoch = int(epoch)
            return {"role": rs.role, "epoch": rs.epoch}

    def replica_status(self, key):
        rs = self.replicas.get(key)
        if rs is None:
            # table may exist unreplicated, or not at all
            self._table_by_key(key)
            return {"role": None, "epoch": 0, "seq": 0, "stale": False}
        return rs.status()

    def replica_summary(self) -> Dict[str, dict]:
        """Compact {partition_key: {role, epoch, seq, stale}} across
        every hosted replicated partition — the payload this server's
        coordinator lease renewals carry, so the control plane can
        elect a caught-up backup when a primary's lease expires."""
        out = {}
        for key, rs in list(self.replicas.items()):
            with rs.lock:
                out[key] = {"role": rs.role, "epoch": rs.epoch,
                            "seq": rs.seq, "stale": rs.stale}
        return out

    # -- data verbs -------------------------------------------------------

    def gather(self, name, ids, partition=None):
        key = _table_key(name, partition)
        self._check_readable(key)
        return self._table(name, partition).gather(ids)

    def push_gradients(self, name, ids, grads, trainer_id=0, step=0,
                       retry=False, partition=None):
        key = _table_key(name, partition)
        self._check_writable(key)
        table = self._table(name, partition)
        st = self.sync[key]
        if st.num <= 1:
            # async / single trainer: apply on arrival (Downpour). A
            # RETRIED push whose first send already landed is skipped.
            with st.cond:
                if retry and st.async_seen.get(trainer_id, -1) >= step:
                    _REG.counter("ps_server_replay_dedup_total",
                                 help="retried pushes whose first send "
                                      "already landed (applied once)",
                                 verb="push_gradients").inc()
                    return 0
                st.async_seen[trainer_id] = max(
                    st.async_seen.get(trainer_id, -1), step)
            t0 = time.perf_counter()
            self._apply_replicated(
                key, lambda: table.push_gradients(ids, grads),
                "push_gradients", ids, grads,
                {"async": (trainer_id, step)})
            _emit_ps_step(name, "async", step, len(np.asarray(ids)),
                          (time.perf_counter() - t0) * 1e3)
            return 0
        token = object()
        merged = None  # (ids, grads, peer tokens) when THIS call merges
        with st.cond:
            if retry and step <= st.last_applied:
                # replay of a round that merged before the reply was
                # lost: the update already landed exactly once
                _REG.counter("ps_server_replay_dedup_total",
                             verb="push_gradients").inc()
                return 0
            buf = st.rounds.setdefault(step, {})
            # overwrite-not-raise: a pre-existing same-trainer entry is a
            # dropped connection's orphan (its server thread still waits
            # on a token that will never complete and times out) — the
            # retry's token supersedes it
            buf[trainer_id] = (np.asarray(ids), np.asarray(grads), token)
            if len(buf) == st.num:
                # trainer-id order, not arrival order: the merged batch
                # is then exactly the single-process batch layout, so
                # duplicate-id float accumulation is order-identical
                ids_m = np.concatenate([buf[t][0] for t in sorted(buf)])
                g_m = np.concatenate([buf[t][1] for t in sorted(buf)])
                # claim the round (dedup high-water + buffer removal)
                # BEFORE applying below, so a racing replay can never
                # trigger a second merge; peers are released only AFTER
                # the apply lands
                peers = [v[2] for v in buf.values() if v[2] is not token]
                st.last_applied = max(st.last_applied, step)
                del st.rounds[step]
                merged = (ids_m, g_m / st.num, peers)
                # this arrival RELEASED the barrier: the causal evidence
                # tracetop's critical path cites for the round
                _tracing.annotate(released_round=step)
            else:
                with _tracing.span("barrier_wait",
                                   attrs={"table": name, "round": step,
                                          "trainer": trainer_id}):
                    woke = st.cond.wait_for(
                        lambda: token in st.done or st.reset,
                        timeout=SYNC_TIMEOUT)
                if woke:
                    if token in st.done:
                        st.done.discard(token)  # each waiter prunes its own
                    else:
                        # generation bump while we waited: group is dead
                        raise RuntimeError(
                            f"sync-PS round abandoned: the trainer group "
                            f"restarted while table {name!r} round {step} "
                            f"was waiting for peers")
                else:
                    # drop our contribution so the round can't half-fire
                    # if this trainer is restarted and retries
                    if step in st.rounds:
                        st.rounds[step].pop(trainer_id, None)
                    raise RuntimeError(
                        f"sync-PS barrier timed out after {SYNC_TIMEOUT}s: "
                        f"only {len(st.rounds.get(step, {}))}/{st.num} "
                        f"trainers pushed table {name!r} round {step} — a "
                        f"peer trainer likely died")
        if merged is not None:
            ids_m, g_scaled, peers = merged
            t0 = time.perf_counter()
            # applied OUTSIDE st.cond: _apply_replicated takes rs.lock,
            # and the replication paths (replicate, resync,
            # fetch_replica_state) take rs.lock THEN st.cond — holding
            # st.cond across the apply inverts that order and can
            # deadlock a primary that is merging a round while a peer
            # forwards to it during a role-transition race. On apply
            # failure (e.g. this primary was deposed mid-forward) the
            # peers are NOT released: they time out, surface the error,
            # and the clients re-drive the round at the new primary.
            with _tracing.span("apply", attrs={"table": name,
                                               "round": step,
                                               "rows": int(len(ids_m))}):
                self._apply_replicated(
                    key, lambda: table.push_gradients(ids_m, g_scaled),
                    "push_gradients", ids_m, g_scaled, {"sync_step": step})
            apply_ms = (time.perf_counter() - t0) * 1e3
            with st.cond:
                st.done.update(peers)
                st.cond.notify_all()
            # emitted outside the barrier lock: sink I/O must never
            # extend the round's critical section
            _emit_ps_step(name, "sync", step, len(ids_m), apply_ms)
        return 0

    def push_delta(self, name, ids, deltas, trainer_id=0, seq=-1,
                   retry=False, partition=None):
        key = _table_key(name, partition)
        self._check_writable(key)
        table = self._table(name, partition)
        if seq >= 0:
            st = self.sync[key]
            with st.cond:
                if retry and st.delta_seen.get(trainer_id, -1) >= seq:
                    _REG.counter("ps_server_replay_dedup_total",
                                 verb="push_delta").inc()
                    return 0  # replayed delta already accumulated
                st.delta_seen[trainer_id] = max(
                    st.delta_seen.get(trainer_id, -1), seq)
        t0 = time.perf_counter()
        self._apply_replicated(
            key, lambda: table.push_delta(ids, deltas),
            "push_delta", ids, deltas, {"delta": (trainer_id, seq)})
        _emit_ps_step(name, "delta", seq, len(np.asarray(ids)),
                      (time.perf_counter() - t0) * 1e3)
        return 0

    def handle(self, method: str, kwargs: dict):
        inj = faults.injector()
        if inj is not None:
            inj.on_server_call(method)  # may os._exit (kill rule)
        if kwargs.get("retry"):
            # the client marked this a replay attempt (its first send may
            # have landed); dedup hits are counted separately above
            _REG.counter("ps_server_retry_received_total",
                         help="RPCs arriving with the retry marker",
                         verb=method).inc()
        if method == "ping":
            return "pong"
        if method == "create_table":
            return self.create_table(kwargs["spec"])
        part = kwargs.get("partition")
        if method == "gather":
            return self.gather(kwargs["name"], kwargs["ids"], part)
        if method == "push_gradients":
            return self.push_gradients(
                kwargs["name"], kwargs["ids"], kwargs["grads"],
                kwargs.get("trainer_id", 0), kwargs.get("step", 0),
                kwargs.get("retry", False), part)
        if method == "push_delta":
            return self.push_delta(
                kwargs["name"], kwargs["ids"], kwargs["deltas"],
                kwargs.get("trainer_id", 0), kwargs.get("seq", -1),
                kwargs.get("retry", False), part)
        if method == "replicate":
            return self.replicate(
                kwargs["key"], kwargs["epoch"], kwargs["seq"],
                kwargs["op"], kwargs["ids"], kwargs["payload"],
                kwargs.get("dedup"))
        if method == "promote":
            return self.promote(
                _table_key(kwargs["name"], part),
                kwargs["epoch"], kwargs.get("backups"))
        if method == "fetch_replica_state":
            return self.fetch_replica_state(
                kwargs["key"], kwargs.get("backup"),
                kwargs.get("have_seq", 0))
        if method == "resync":
            return self.resync(
                _table_key(kwargs["name"], part), kwargs["primary"],
                kwargs.get("self_endpoint"))
        if method == "adopt_role":
            return self.adopt_role(_table_key(kwargs["name"], part),
                                   kwargs["epoch"], kwargs["role"])
        if method == "replica_status":
            return self.replica_status(_table_key(kwargs["name"], part))
        if method == "to_dense":
            self._check_readable(_table_key(kwargs["name"], part))
            return self._table(kwargs["name"], part).to_dense()
        if method == "nbytes":
            return self._table(kwargs["name"], part).nbytes()
        if method == "stats":
            # idempotent observability verb: per-table traffic counters
            # (when a name is given) + this server process's telemetry
            # registry slice — per-verb latency histogram summaries,
            # retry/replay-dedup counters, bytes in/out; replicated
            # partitions add their role/epoch/seq/backup-lag state.
            # `memory` is this process's per-hosted-table
            # resident-byte accounting — rows x row width + optimizer
            # accumulators + the replication log ring
            out = {"server": server_telemetry(),
                   "memory": self.memory_stats()}
            name = kwargs.get("name")
            if name:
                key = _table_key(name, part)
                t = self._table(name, part)
                out["push_calls"] = t.push_calls
                out["pushed_bytes"] = t.pushed_bytes
                rs = self.replicas.get(key)
                if rs is not None:
                    out["replica"] = rs.status()
            return out
        if method == "state_dict":
            self._check_readable(_table_key(kwargs["name"], part))
            return self._table(kwargs["name"], part).state_dict()
        if method == "load_state_dict":
            key = _table_key(kwargs["name"], part)
            rs = self._check_writable(key)
            table = self._table(kwargs["name"], part)
            if rs is not None:
                self._apply_replicated(
                    key, lambda: table.load_state_dict(kwargs["state"]),
                    "load_state", None, kwargs["state"], {})
            else:
                table.load_state_dict(kwargs["state"])
            return 0
        if method == "snapshot":
            return self.snapshot()
        if method == "drop_table":
            with self.lock:
                name = kwargs["name"]
                for key in [k for k in self.tables
                            if k == name or k.startswith(name + "@p")]:
                    self.tables.pop(key, None)
                    self.specs.pop(key, None)
                    self.sync.pop(key, None)
                    self.gens.pop(key, None)
                    self.replicas.pop(key, None)
            return 0
        if method == "shutdown":
            self.shutdown_event.set()
            return 0
        raise ValueError(f"unknown PS method {method!r}")

    def memory_stats(self) -> dict:
        """Per-hosted-table-key resident bytes:
        value shards + optimizer accumulators + dirty-set overhead, and
        for replicated partitions the replication log ring — the
        pserver-process capacity-planning row the `stats` verb carries
        and fleet.ps_stats() surfaces."""
        with self.lock:
            items = list(self.tables.items())
            reps = dict(self.replicas)
        out = {}
        total = 0
        for key, t in items:
            row = t.memory_stats()
            rs = reps.get(key)
            if rs is not None:
                row["replog_bytes"] = rs.log_bytes()
                row["replog_entries"] = len(rs.log)
                row["resident_bytes"] += row["replog_bytes"]
            total += row["resident_bytes"]
            out[key] = row
        out["total_resident_bytes"] = total
        return out

    # -- snapshots --------------------------------------------------------

    def snapshot(self) -> int:
        """Atomically checkpoint every hosted table (tmp + os.replace: a
        crash mid-write can never leave a torn file, so the newest
        snapshot on disk is always loadable). Same format as
        preload_dir, so a supervised restart restores it through the
        existing create_table path. A manifest.json (snapshot epoch,
        trainer-group generation, table geometries) is committed LAST,
        so a stable cross-job snapshot dir is self-describing.

        Two modes (PADDLE_PS_SNAPSHOT_MODE): "full" (default) writes
        `<key>.pkl` per table exactly as before — O(table bytes) per
        tick; "incremental" writes a periodic full BASE plus sha256-
        checksummed dirty-row DELTA files chained by the manifest —
        O(touched rows) per tick, which is what makes sub-second
        cadences viable on multi-GB tables. The chain compacts into a
        fresh base every PADDLE_PS_SNAPSHOT_COMPACT_EVERY deltas and on
        load. Returns the number of files written."""
        if not self.snapshot_dir:
            return 0
        os.makedirs(self.snapshot_dir, exist_ok=True)
        if self.snapshot_mode == "incremental":
            return self._snapshot_incremental()
        with self.lock:
            items = list(self.tables.items())
            gens = dict(self.gens)
        n = 0
        for key, t in items:
            rs = self.replicas.get(key)
            if rs is None:
                state = t.state_dict()
            else:
                # one critical section: replicated writes apply under
                # rs.lock (_apply_replicated / replicate), so capturing
                # state AND seq inside it yields a consistent cut — a
                # seq ahead of the state would make a restore+resync
                # skip replaying writes the snapshot doesn't contain
                with rs.lock:
                    state = t.state_dict()
                    state["replica_meta"] = {"seq": rs.seq,
                                             "epoch": rs.epoch}
            _atomic_write(os.path.join(self.snapshot_dir, f"{key}.pkl"),
                          pickle.dumps(state,
                                       protocol=pickle.HIGHEST_PROTOCOL))
            n += 1
        if n:
            self._snapshot_epoch += 1
            manifest = {
                "format": 1,
                "snapshot_epoch": self._snapshot_epoch,
                "generation": max(gens.values(), default=0),
                "unix_time": time.time(),
                "tables": {
                    key: {"rows": t.rows, "dim": t.dim}
                    for key, t in items
                },
            }
            _atomic_write(os.path.join(self.snapshot_dir, "manifest.json"),
                          json.dumps(manifest, indent=1).encode())
        return n

    def _snapshot_incremental(self) -> int:
        """Base + dirty-row delta chain. Per table: a fresh BASE when
        none exists or the chain hit the compaction bound, else one
        DELTA holding only the rows touched since the last tick (none
        touched = nothing written). The manifest commit (atomic, last)
        is the consistency point; files it no longer references are
        removed AFTER it lands."""
        with self.lock:
            items = list(self.tables.items())
            gens = dict(self.gens)
        wrote = 0
        doomed: List[str] = []  # superseded chain files, removed last
        for key, t in items:
            rs = self.replicas.get(key)

            def cut(capture, _rs=rs):
                """Capture table state and replica seq in ONE rs.lock
                critical section (writes apply under rs.lock): seq ahead
                of the state loses resync-tail updates, state ahead of
                seq re-applies non-idempotent push_gradients."""
                if _rs is None:
                    return capture(), None
                with _rs.lock:
                    return capture(), {"seq": _rs.seq,
                                       "epoch": _rs.epoch}

            ent = self._snap_chain.get(key)
            if ent is None or len(ent["deltas"]) >= max(
                    1, SNAPSHOT_COMPACT_EVERY):
                # compaction / first base: everything dirty is folded in
                state, meta = cut(
                    lambda: (t.drain_dirty(), t.state_dict())[1])
                if meta:
                    state["replica_meta"] = meta
                blob = pickle.dumps(state,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                serial = (ent["serial"] + 1) if ent else 0
                fname = f"{key}.base.{serial:04d}.pkl"
                _atomic_write(os.path.join(self.snapshot_dir, fname), blob)
                if ent:
                    doomed.append(ent["base"])
                    doomed.extend(d["file"] for d in ent["deltas"])
                self._snap_chain[key] = {
                    "serial": serial, "base": fname,
                    "base_sha256": hashlib.sha256(blob).hexdigest(),
                    "deltas": [],
                }
                _REG.counter("ps_server_snapshot_bytes_total",
                             kind="base").inc(len(blob))
                wrote += 1
            else:
                delta, meta = cut(t.drain_dirty)
                if delta["rows"] == 0:
                    continue  # bytes per tick scale with touched rows
                if meta:
                    delta["replica_meta"] = meta
                blob = pickle.dumps(delta,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                fname = (f"{key}.delta.{ent['serial']:04d}."
                         f"{len(ent['deltas']):05d}.pkl")
                _atomic_write(os.path.join(self.snapshot_dir, fname), blob)
                ent["deltas"].append({
                    "file": fname,
                    "sha256": hashlib.sha256(blob).hexdigest(),
                    "rows": delta["rows"],
                })
                _REG.counter("ps_server_snapshot_bytes_total",
                             kind="delta").inc(len(blob))
                _REG.counter("ps_server_snapshot_rows_total").inc(
                    delta["rows"])
                wrote += 1
        if wrote:
            self._snapshot_epoch += 1
            manifest = {
                "format": 2,
                "mode": "incremental",
                "snapshot_epoch": self._snapshot_epoch,
                "generation": max(gens.values(), default=0),
                "unix_time": time.time(),
                "tables": {key: {"rows": t.rows, "dim": t.dim}
                           for key, t in items},
                "chains": {key: dict(ent) for key, ent
                           in self._snap_chain.items()},
            }
            _atomic_write(os.path.join(self.snapshot_dir, "manifest.json"),
                          json.dumps(manifest, indent=1).encode())
            for fname in doomed:
                try:
                    os.remove(os.path.join(self.snapshot_dir, fname))
                except OSError:
                    pass
        return wrote

    def start_snapshotter(self) -> None:
        if not (self.snapshot_dir and self.snapshot_secs > 0):
            return
        if self._snap_thread is not None:
            return

        def loop():
            while not self.shutdown_event.wait(self.snapshot_secs):
                try:
                    self.snapshot()
                except Exception as e:  # keep serving; snapshots degrade
                    print(f"[ps_server] snapshot failed: {e}",
                          file=sys.stderr, flush=True)

        self._snap_thread = threading.Thread(target=loop, daemon=True)
        self._snap_thread.start()


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
        srv: PSServer = self.server.ps  # type: ignore[attr-defined]
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


# environment that arms an exporter the port does not have yet: the
# pserver refuses to start rather than run without it
_NOT_PORTED_ENV = (
    ("PADDLE_METRICS_PUSH_URL", "the metrics push exporter "
     "(telemetry/export.py, ROADMAP A8)"),
    ("PADDLE_TRACES_PUSH_URL", "the span push exporter "
     "(telemetry/export.py, ROADMAP A8)"),
)


def _refuse_unported_env() -> None:
    for env, what in _NOT_PORTED_ENV:
        if os.environ.get(env):
            raise NotImplementedError(
                f"{env} is set, but {what} is not ported yet; unset it to "
                f"run the pserver without it")


def serve(port: int = 0, host: str = "0.0.0.0", ready_cb=None,
          preload_dir: Optional[str] = None,
          snapshot_dir: Optional[str] = None,
          snapshot_secs: Optional[float] = None,
          snapshot_mode: Optional[str] = None):
    """Run the pserver event loop (blocks). port=0 picks a free port;
    ready_cb (tests) receives the bound (host, port). Snapshot knobs
    default from PADDLE_PS_SNAPSHOT_DIR / PADDLE_PS_SNAPSHOT_SECS /
    PADDLE_PS_SNAPSHOT_MODE; a clean shutdown writes one final snapshot
    so a graceful restart is lossless (a crash loses at most one
    interval — one delta's worth of rows in incremental mode)."""
    if snapshot_dir is None:
        snapshot_dir = os.environ.get("PADDLE_PS_SNAPSHOT_DIR") or None
    if snapshot_secs is None:
        snapshot_secs = float(
            os.environ.get("PADDLE_PS_SNAPSHOT_SECS", 0) or 0)
    _refuse_unported_env()
    _arm_metrics_sink()
    # step tracing: arm the flight-recorder triggers (SIGTERM, crash,
    # exit); a no-op unless PADDLE_TRACING armed them
    _tracing.maybe_install_hooks()
    srv = _TCPServer((host, port), _Handler)
    srv.ps = PSServer(preload_dir=preload_dir,  # type: ignore[attr-defined]
                      snapshot_dir=snapshot_dir,
                      snapshot_secs=snapshot_secs,
                      snapshot_mode=snapshot_mode)
    srv.ps.start_snapshotter()
    # stamp liveness for the launcher's supervisor when heartbeats are on
    # (same channel trainers use; catches a HUNG pserver, not just death)
    hb = None
    hb_dir = os.environ.get("PADDLE_HEARTBEAT_DIR")
    hb_tag = os.environ.get("PADDLE_PS_RANK_TAG")
    if hb_dir and hb_tag:
        from .heartbeat import HeartBeatWorker

        hb = HeartBeatWorker(hb_dir, hb_tag).start()
    # job control plane (coordinator.py): renew a membership lease
    # carrying the per-partition replica summary, so an expired primary
    # lease lets the coordinator promote a backup with no client in the
    # loop. No-op (two env reads) when the launcher didn't arm leases.
    lease_worker = None
    bound_host, bound_port = srv.server_address[0], srv.server_address[1]
    if bound_host in ("0.0.0.0", ""):
        bound_host = "127.0.0.1"
    try:
        from . import coordinator as _coord

        lease_worker = _coord.maybe_start_lease_worker(
            kind="pserver", tag=hb_tag,
            self_endpoint=f"{bound_host}:{bound_port}",
            payload_fn=lambda: {"partitions": srv.ps.replica_summary()})
    except Exception as e:  # noqa: BLE001 — leases are advisory here
        print(f"[ps_server] lease worker failed to start: {e}",
              file=sys.stderr, flush=True)
    if ready_cb is not None:
        ready_cb(srv.server_address)
    if srv.ps.adopted_manifest is not None:
        # printed AFTER the ready banner: the launcher reads the first
        # stdout line to learn the bound port
        m = srv.ps.adopted_manifest
        print(f"[ps_server] adopting snapshot dir {preload_dir!r} "
              f"(epoch {m.get('snapshot_epoch')}, generation "
              f"{m.get('generation')}, tables "
              f"{sorted(m.get('tables', {}))})", flush=True)
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        if hb is not None:
            hb.stop()
        if lease_worker is not None:
            lease_worker.stop()
        srv.close_all_connections()
        srv.server_close()
        try:
            srv.ps.snapshot()
        except Exception as e:
            print(f"[ps_server] final snapshot failed: {e}",
                  file=sys.stderr, flush=True)
        # clean-exit span dump: flightrec.<tag>.json for tracetop plus
        # trace.<tag>.json so the launcher's timeline merge gets a
        # pserver lane (SIGTERM/crash paths dump via the hooks above)
        _tracing.shutdown_dump()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.ps_server")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("PADDLE_PORT", 0)))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--preload_dir", default=os.environ.get(
        "PADDLE_PS_PRELOAD_DIR", ""))
    p.add_argument("--snapshot_dir", default=os.environ.get(
        "PADDLE_PS_SNAPSHOT_DIR", ""))
    p.add_argument("--snapshot_secs", type=float, default=float(
        os.environ.get("PADDLE_PS_SNAPSHOT_SECS", 0) or 0))
    p.add_argument("--snapshot_mode", default=os.environ.get(
        "PADDLE_PS_SNAPSHOT_MODE", ""), choices=["", "full", "incremental"])
    args = p.parse_args(argv)

    def ready(addr):
        # the launcher reads this line to learn the bound port
        print(f"[ps_server] listening on {addr[0]}:{addr[1]}", flush=True)

    serve(args.port, args.host, ready_cb=ready,
          preload_dir=args.preload_dir or None,
          snapshot_dir=args.snapshot_dir or None,
          snapshot_secs=args.snapshot_secs,
          snapshot_mode=args.snapshot_mode or None)
    return 0


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
                if isinstance(result, str) and result.startswith(
                        "KeyError") and "no table" in result:
                    raise TableMissingError(f"pserver {self.addr}: {result}")
                if isinstance(result, str) and result.startswith(
                        "NotPrimaryError"):
                    raise NotPrimaryError(
                        f"pserver {self.addr}: {result}")
                if isinstance(result, str) and result.startswith(
                        "StalePrimaryError"):
                    raise StalePrimaryError(
                        f"pserver {self.addr}: {result}")
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


class RemoteTable:
    """Client shim: the ShardedHostTable duck type over N pservers.

    Rows are round-robin sharded across servers (global row r lives on
    server r % n at local row r // n — the reference ps_dispatcher
    RoundRobin placement), so with one server the hosted table is
    byte-identical (same seed, same shape) to the in-process one.

    generation (default PADDLE_ELASTIC_RESTART): the trainer group's
    restart attempt, carried in the create_table handshake so a server
    that outlived the previous group resets its sync barrier. Every verb
    goes through _call, which re-creates the table (idempotent; the
    server preloads its latest snapshot) if a restarted pserver lost it.

    replication R (PADDLE_PS_REPLICATION, default 1): partition p's rows
    get a PRIMARY on pserver p plus R-1 prefix-consistent BACKUPS on
    pservers (p+1)%n .. (p+R-1)%n (the chain). The client then adds:

      fast failover — when the primary's deadline-capped retry budget is
        exhausted, the next live replica in the chain is PROMOTED
        (epoch+1) and training continues; a daemon thread re-enrolls the
        dead endpoint once the supervisor respawns it (create_table →
        resync: snapshot + seq-tail anti-entropy) so the partition heals
        back to R replicas without a pause.
      hedged pulls — read verbs (gather, stats) race a backup-directed
        hedge issued after the verb's observed latency quantile
        (PADDLE_PS_HEDGE_QUANTILE, default p95); first response wins,
        the loser is discarded (hedges issued/won counters in the
        registry).

    R=1 sends byte-identical wire messages to the pre-replication
    protocol: no partition field, no promote/replicate verbs.
    """

    def __init__(self, name, shape, endpoints: List[str],
                 dtype: str = "float32", num_shards: int = 4,
                 optimizer: str = "sgd", learning_rate: float = 0.1,
                 initializer_std: Optional[float] = None, seed: int = 0,
                 sync_trainers: int = 0, trainer_id: int = 0,
                 generation: Optional[int] = None,
                 replication: Optional[int] = None):
        self.name = name
        self.rows, self.dim = int(shape[0]), int(shape[1])
        self.dtype = np.dtype(dtype)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.endpoints = list(endpoints)
        self.trainer_id = int(trainer_id)
        self.generation = int(
            os.environ.get("PADDLE_ELASTIC_RESTART", 0)
            if generation is None else generation)
        self._n = len(self.endpoints)
        if replication is None:
            replication = int(
                os.environ.get("PADDLE_PS_REPLICATION", 1) or 1)
        self.replication = max(1, int(replication))
        if self.replication > 1 and self.replication > self._n:
            raise ValueError(
                f"replication={self.replication} needs at least that "
                f"many distinct pservers, got {self._n} "
                f"(PADDLE_PS_REPLICATION vs PADDLE_PSERVERS_IP_PORT_LIST)")
        # replicated clients default to a bounded per-RPC deadline so
        # failover triggers in bounded time; R=1 keeps the attempt bound
        conn_deadline = None
        if self.replication > 1 and RPC_DEADLINE <= 0:
            conn_deadline = REPLICATED_DEADLINE_DEFAULT
        self._conns = [_Conn(e, deadline=conn_deadline)
                       for e in self.endpoints]
        self._step = 0
        self._delta_seq = 0
        self._step_lock = threading.Lock()
        # one record per client-driven promotion (_failover)
        self.failover_log: List[dict] = []
        # multi-server fan-out pool: per-server RPCs overlap instead of
        # serializing N round-trips (the reference's async gRPC client
        # model, grpc_client.h AsyncSendVar); connections are pooled per
        # endpoint so concurrent calls never share a socket
        self._pool = None
        if self._n > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self._n)
        self._specs: List[dict] = []
        for s in range(self._n):
            n_rows = (self.rows - s + self._n - 1) // self._n
            spec = {
                "name": name, "shape": (n_rows, self.dim),
                "dtype": str(self.dtype), "num_shards": num_shards,
                "optimizer": optimizer, "learning_rate": learning_rate,
                "initializer_std": initializer_std,
                # distinct per-server streams when sharded; the single-
                # server layout reproduces the local table bit-for-bit
                "seed": seed if self._n == 1 else seed + s,
                "sync_trainers": sync_trainers,
                "generation": self.generation,
            }
            if self.replication > 1:
                # the spec is PARTITION identity — identical on every
                # replica of partition s (seed included), so primary and
                # backups initialize bit-identically
                spec["partition"] = s
                spec["replicas"] = [
                    self.endpoints[(s + i) % self._n]
                    for i in range(self.replication)]
            self._specs.append(spec)
        if self.replication <= 1:
            for s, conn in enumerate(self._conns):
                conn.call("create_table", spec=self._specs[s])
        else:
            self._init_replicated()

    # -- replication bookkeeping -----------------------------------------
    def _init_replicated(self):
        from concurrent.futures import ThreadPoolExecutor

        R = self.replication
        # chain[p] = server indices hosting partition p, primary first
        self._chain = [[(p + i) % self._n for i in range(R)]
                       for p in range(self._n)]
        self._primary_idx = [0] * self._n  # index INTO the chain
        self._pepoch = [0] * self._n
        # RLock: _refresh_primary holds it while _refresh_primary_locked
        # schedules rejoins, which re-enter it to dedupe
        self._route_lock = threading.RLock()
        self._rejoining: set = set()
        self._hedge_q = HEDGE_QUANTILE
        self._hedge_min = HEDGE_MIN_SAMPLES
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self._n))
        for p in range(self._n):
            for j in self._chain[p]:
                self._conns[j].call("create_table", spec=self._specs[p])
            try:
                self._conns[self._chain[p][0]].call(
                    "promote", name=self.name, partition=p, epoch=0,
                    backups=[self.endpoints[j]
                             for j in self._chain[p][1:]])
                for j in self._chain[p][1:]:
                    self._conns[j].call("adopt_role", name=self.name,
                                        partition=p, epoch=0,
                                        role="backup")
            except RuntimeError as e:
                if "StalePromote" not in str(e):
                    raise
                # a failover already moved this partition on; adopt it
                self._refresh_primary(p)

    # -- addressing ------------------------------------------------------
    def _locate(self, ids: np.ndarray):
        if ids.size and (ids.min() < 0 or ids.max() >= self.rows):
            bad = ids[(ids < 0) | (ids >= self.rows)][0]
            raise IndexError(
                f"table {self.name!r}: id {int(bad)} out of range "
                f"[0, {self.rows})")
        return ids % self._n, ids // self._n

    def _call(self, s: int, method: str, **kwargs):
        """One partition's RPC with restart recovery: a pserver that
        came back empty (supervised respawn) gets the idempotent create
        — which preloads its latest snapshot — and the verb is replayed.
        Replicated tables additionally route to the partition's current
        primary, fail over on exhausted retry budgets, and hedge read
        verbs to a backup."""
        if self.replication <= 1:
            try:
                return self._conns[s].call(method, **kwargs)
            except TableMissingError:
                self._conns[s].call("create_table", spec=self._specs[s])
                return self._conns[s].call(method, **kwargs)
        kwargs.setdefault("partition", s)
        if method in ("gather", "stats") and self._hedge_q > 0:
            return self._hedged_call(s, method, kwargs)
        return self._replica_call(s, method, kwargs)

    def _conn_call(self, j: int, p: int, method: str, kwargs: dict):
        """Raw call to server j for partition p, with the idempotent
        recreate-on-missing recovery (replicated flavor)."""
        try:
            return self._conns[j].call(method, **kwargs)
        except TableMissingError:
            self._conns[j].call("create_table", spec=self._specs[p])
            return self._conns[j].call(method, **kwargs)

    def _replica_call(self, p: int, method: str, kwargs: dict,
                      hops: int = 0):
        """Primary-routed call with fast failover: an unreachable
        primary (deadline-capped retries exhausted) promotes the next
        live replica and the verb replays there — marked `retry` for
        writes, so a round that already merged-and-forwarded before the
        primary died applies exactly once."""
        j = self._chain[p][self._primary_idx[p]]
        try:
            return self._conn_call(j, p, method, kwargs)
        except ConnectionError:
            if hops >= self.replication:
                raise
            self._failover(p, dead_j=j)
        except (NotPrimaryError, StalePrimaryError):
            # our routing is behind the cluster: adopt the real primary
            if hops >= self.replication + 2:
                raise
            self._refresh_primary(p)
        if method in ("push_gradients", "push_delta"):
            kwargs["retry"] = True  # first try may have landed
        return self._replica_call(p, method, kwargs, hops + 1)

    def _probe(self, j: int, p: int):
        """replica_status of server j for partition p, or None if it is
        unreachable/unusable right now."""
        try:
            st = self._conn_call(j, p, "replica_status",
                                 {"name": self.name, "partition": p})
            return None if st.get("stale") else st
        except Exception:  # noqa: BLE001 — candidate scan must not die
            return None

    @staticmethod
    def _promote_rank(st: dict, idx: int):
        """Candidate ordering for promotion: replicas that HOLD DATA
        (role backup/primary — they applied the forward prefix) always
        outrank a role-None husk (a just-respawned empty server that
        has not resynced), regardless of its epoch; then epoch, then
        last-applied seq, then chain order. Promoting an empty replica
        while a caught-up one exists would be silent data loss."""
        has_data = 1 if st.get("role") in ("backup", "primary") else 0
        return (has_data, int(st.get("epoch", 0)), int(st.get("seq", 0)),
                -idx)

    def _failover(self, p: int, dead_j: int) -> None:
        """Promote the best live replica of partition p (highest
        (epoch, seq), chain order breaking ties) and keep training;
        a rejoin thread re-enrolls the dead endpoint once its
        supervised respawn answers again."""
        with self._route_lock:
            chain = self._chain[p]
            if chain[self._primary_idx[p]] != dead_j:
                return  # another thread already failed this partition over
            best = None
            for idx, j in enumerate(chain):
                if j == dead_j:
                    continue
                st = self._probe(j, p)
                if st is None:
                    continue
                rank = self._promote_rank(st, idx)
                if best is None or rank > best[0]:
                    best = (rank, idx, st)
            if best is None:
                raise ConnectionError(
                    f"table {self.name!r} partition {p}: primary "
                    f"{self.endpoints[dead_j]} is unreachable and no "
                    f"live replica remains")
            rank, idx, st = best
            if (st.get("role") == "primary"
                    and int(st.get("epoch", 0)) > self._pepoch[p]):
                # a control plane (coordinator lease elector) or a peer
                # trainer already promoted this replica at a newer
                # epoch — adopt the claim instead of deposing it with a
                # redundant epoch bump; adoption is not a client-driven
                # failover, so it gets its own counter
                _REG.counter("ps_client_primary_adoptions_total").inc()
                self._pepoch[p] = int(st.get("epoch", 0))
                self._primary_idx[p] = idx
                print(f"[ps_client] pserver {self.endpoints[dead_j]} "
                      f"unreachable for table {self.name!r} partition "
                      f"{p}; adopting already-promoted primary "
                      f"{self.endpoints[chain[idx]]} (epoch "
                      f"{self._pepoch[p]})", file=sys.stderr, flush=True)
                for p2 in range(self._n):
                    if dead_j in self._chain[p2]:
                        self._schedule_rejoin(p2, dead_j)
                return
            _REG.counter("ps_client_failovers_total").inc()
            new_epoch = max(self._pepoch[p], rank[1]) + 1
            backups = [self.endpoints[j] for j in chain
                       if j not in (dead_j, chain[idx])]
            target = chain[idx]
            print(f"[ps_client] pserver {self.endpoints[dead_j]} "
                  f"unreachable for table {self.name!r} partition {p}; "
                  f"promoting {self.endpoints[target]} (epoch "
                  f"{new_epoch})", file=sys.stderr, flush=True)
            try:
                self._conn_call(target, p, "promote",
                                {"name": self.name, "partition": p,
                                 "epoch": new_epoch, "backups": backups})
                self._pepoch[p] = new_epoch
                self._primary_idx[p] = idx
                # the promoted replica's first answered call, on the
                # host clock: what a failover cost is measured to
                self.failover_log.append({
                    "partition": p, "dead": self.endpoints[dead_j],
                    "promoted": self.endpoints[target],
                    "epoch": new_epoch, "answered_at": time.time()})
            except (NotPrimaryError, StalePrimaryError, RuntimeError):
                # lost the promote race to a peer trainer: adopt theirs
                self._refresh_primary_locked(p)
        # the dead server also held BACKUP copies of its neighbours'
        # partitions (their primaries dropped it on forward failure) —
        # re-enroll it everywhere it belongs once it respawns
        for p2 in range(self._n):
            if dead_j in self._chain[p2]:
                self._schedule_rejoin(p2, dead_j)

    def _refresh_primary(self, p: int) -> None:
        with self._route_lock:
            self._refresh_primary_locked(p)

    def _refresh_primary_locked(self, p: int) -> None:
        """Re-resolve partition p's primary from the replicas' own
        claims: highest-epoch primary claimant wins; with none — e.g.
        the old primary was respawned EMPTY before we noticed it died —
        promote the best-(epoch, seq) live replica (deterministic across
        trainers). Replicas that probe dead or behind (a just-respawned
        empty one) are left out of the forward set and scheduled for the
        rejoin/resync path instead — never silently abandoned at R=1."""
        chain = self._chain[p]
        probes = {}
        claimant = best = None
        for idx, j in enumerate(chain):
            st = self._probe(j, p)
            probes[j] = st
            if st is None:
                continue
            rank = self._promote_rank(st, idx)
            if st.get("role") == "primary" and (
                    claimant is None or rank > claimant[0]):
                claimant = (rank, idx)
            if best is None or rank > best[0]:
                best = (rank, idx)
        if claimant is not None:
            self._pepoch[p] = claimant[0][1]
            self._primary_idx[p] = claimant[1]
            return
        if best is None:
            raise ConnectionError(
                f"table {self.name!r} partition {p}: no live replica")
        new_epoch = max(self._pepoch[p], best[0][1]) + 1
        target = chain[best[1]]
        healthy = [j for j in chain
                   if j != target and probes.get(j) is not None
                   and probes[j].get("role") == "backup"]
        # a no-claimant promote IS a failover: the old primary vanished
        # (or came back empty) without us ever seeing a transport error
        _REG.counter("ps_client_failovers_total").inc()
        print(f"[ps_client] no primary claims table {self.name!r} "
              f"partition {p}; promoting {self.endpoints[target]} "
              f"(epoch {new_epoch})", file=sys.stderr, flush=True)
        self._conn_call(target, p, "promote",
                        {"name": self.name, "partition": p,
                         "epoch": new_epoch,
                         "backups": [self.endpoints[j] for j in healthy]})
        self._pepoch[p] = new_epoch
        self._primary_idx[p] = best[1]
        for j in chain:
            if j != target and j not in healthy:
                self._schedule_rejoin(p, j)

    def _schedule_rejoin(self, p: int, dead_j: int) -> None:
        """Daemon thread: once the dead endpoint answers again
        (supervised respawn), re-create the partition table there
        (preloads its snapshot) and drive `resync` — anti-entropy from
        the current primary (seq-tail when covered, else full state) —
        so the partition heals back to R replicas."""
        key = (p, dead_j)
        with self._route_lock:
            if key in self._rejoining:
                return
            self._rejoining.add(key)

        def loop():
            ep = self.endpoints[dead_j]
            deadline = time.monotonic() + REJOIN_SECS
            try:
                while time.monotonic() < deadline:
                    time.sleep(0.5)
                    c = _Conn(ep, deadline=3.0, io_timeout=15.0)
                    try:
                        c.call("ping")
                        c.call("create_table", spec=self._specs[p])
                        prim = self.endpoints[
                            self._chain[p][self._primary_idx[p]]]
                        if prim == ep:
                            return  # it came back as primary already
                        st = c.call("replica_status", name=self.name,
                                    partition=p)
                        if (st.get("role") == "backup"
                                and not st.get("stale")):
                            return  # a peer trainer already resynced it
                        out = c.call("resync", name=self.name,
                                     partition=p, primary=prim,
                                     self_endpoint=ep)
                        _REG.counter("ps_client_rejoins_total").inc()
                        print(f"[ps_client] pserver {ep} rejoined table "
                              f"{self.name!r} partition {p} as backup "
                              f"({out.get('mode')}, seq "
                              f"{out.get('seq')})", file=sys.stderr,
                              flush=True)
                        return
                    except Exception:  # noqa: BLE001 — retry until alive
                        continue
                    finally:
                        c.close()
                print(f"[ps_client] giving up re-enrolling {ep} for "
                      f"table {self.name!r} partition {p} after "
                      f"{REJOIN_SECS}s", file=sys.stderr, flush=True)
            finally:
                with self._route_lock:
                    self._rejoining.discard(key)

        threading.Thread(target=loop, daemon=True,
                         name=f"ps-rejoin-{self.name}-p{p}").start()

    def _hedged_call(self, p: int, method: str, kwargs: dict):
        """Tail-tolerant read: race the primary against a backup hedge
        issued after the verb's observed latency quantile. First
        response wins; the loser finishes in the background and is
        discarded. Falls back to the plain primary path until the
        latency histogram has enough samples to size the delay.

        ps_client_effective_read_ms records what the CALLER waited —
        ps_client_rpc_ms keeps recording each connection's raw RPC
        latency (the losing primary still logs its full tail there), so
        the two histograms together show exactly what hedging bought."""
        t_eff = time.perf_counter()
        try:
            return self._hedged_call_inner(p, method, kwargs)
        finally:
            _REG.histogram(
                "ps_client_effective_read_ms",
                help="read latency as the caller saw it (hedging "
                     "included; compare with ps_client_rpc_ms)",
                verb=method).observe((time.perf_counter() - t_eff) * 1e3)

    def _hedged_call_inner(self, p: int, method: str, kwargs: dict):
        from concurrent import futures as _fut

        hist = _REG.histogram("ps_client_rpc_ms", verb=method)
        chain = self._chain[p]
        if hist.count < self._hedge_min or len(chain) < 2:
            return self._replica_call(p, method, kwargs)
        delay_s = max(hist.quantile(self._hedge_q) / 1e3, 1e-3)
        # _tracing.bound: the pool thread re-binds THIS thread's span
        # context, so the primary attempt, the hedge, and the winner all
        # share one trace (identity function when tracing is off)
        fut = self._hedge_pool.submit(_tracing.bound(
            lambda: self._replica_call(p, method, dict(kwargs))))
        try:
            return fut.result(timeout=delay_s)
        except _fut.TimeoutError:
            pass
        _REG.counter("ps_client_hedges_issued_total",
                     help="backup-directed hedges for slow reads",
                     verb=method).inc()
        backup_j = chain[(self._primary_idx[p] + 1) % len(chain)]

        def _hedge_exec():
            with _tracing.span(f"hedge:{method}",
                               attrs={"partition": p,
                                      "peer": self.endpoints[backup_j]}):
                return self._conn_call(backup_j, p, method, dict(kwargs))

        hedge = self._hedge_pool.submit(_tracing.bound(_hedge_exec))
        pending = {fut: "primary", hedge: "hedge"}
        last_err = None
        while pending:
            done, _ = _fut.wait(set(pending),
                                return_when=_fut.FIRST_COMPLETED)
            for f in done:
                src = pending.pop(f)
                err = f.exception()
                if err is None:
                    if src == "hedge":
                        _REG.counter("ps_client_hedges_won_total",
                                     verb=method).inc()
                    return f.result()
                last_err = err
        raise last_err

    def _fanout(self, thunks):
        """Run one thunk per server, overlapped when a pool exists.
        Thunks carry the caller's trace context into the pool threads
        (tracing.bound is identity when the layer is off)."""
        if self._pool is None:
            return [t() for t in thunks]
        return [f.result() for f in
                [self._pool.submit(_tracing.bound(t)) for t in thunks]]

    # -- serving ---------------------------------------------------------
    def gather(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        srv, local = self._locate(ids)
        out = np.empty((ids.shape[0], self.dim), self.dtype)
        masks = [srv == s for s in range(self._n)]
        rows = self._fanout([
            (lambda s=s, m=m: self._call(
                s, "gather", name=self.name, ids=local[m]))
            if m.any() else (lambda: None)
            for s, m in enumerate(masks)
        ])
        for m, r in zip(masks, rows):
            if r is not None:
                out[m] = r
        return out

    def push_gradients(self, ids, grads) -> None:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        grads = np.asarray(grads, np.float32).reshape(ids.shape[0], self.dim)
        # data-corruption drill site: a bitflip:push_grad rule corrupts
        # one value of THIS rank's outgoing gradient — flag-off the
        # array passes through untouched (one flag read)
        from .faults import bitflip_point

        grads = bitflip_point("push_grad", grads)
        with self._step_lock:
            step = self._step
            self._step += 1
        srv, local = self._locate(ids)
        # every server participates in every sync round (even with zero
        # rows) so its barrier bookkeeping sees all trainers each step;
        # overlapped: in sync mode each call blocks on the barrier
        self._fanout([
            lambda s=s: self._call(
                s, "push_gradients", name=self.name, ids=local[srv == s],
                grads=grads[srv == s], trainer_id=self.trainer_id,
                step=step)
            for s in range(self._n)
        ])

    def push_delta(self, ids, deltas) -> None:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        deltas = np.asarray(deltas, np.float32).reshape(
            ids.shape[0], self.dim)
        with self._step_lock:
            seq = self._delta_seq
            self._delta_seq += 1
        srv, local = self._locate(ids)
        masks = [srv == s for s in range(self._n)]
        self._fanout([
            (lambda s=s, m=m: self._call(
                s, "push_delta", name=self.name, ids=local[m],
                deltas=deltas[m], trainer_id=self.trainer_id, seq=seq))
            if m.any() else (lambda: None)
            for s, m in enumerate(masks)
        ])

    # -- introspection / checkpoint --------------------------------------
    def nbytes(self) -> int:
        return sum(self._call(s, "nbytes", name=self.name)
                   for s in range(self._n))

    def stats(self) -> dict:
        """Aggregated table traffic counters + each pserver's telemetry
        slice under "servers" (the idempotent `stats` verb). Replicated
        tables add a "replication" section: factor plus each partition's
        replica roles/epochs/seqs — the operator's view of failovers,
        lag, and dropped backups. "client" is THIS process's ps_client_*
        slice (verb latency histograms with trace-exemplars, retry and
        hedge counters) so one call shows both ends of the data plane."""
        agg = {"push_calls": 0, "pushed_bytes": 0, "servers": [],
               "client": client_telemetry()}
        parts: dict = {}
        for s in range(self._n):
            st = self._call(s, "stats", name=self.name)
            agg["push_calls"] += st["push_calls"]
            agg["pushed_bytes"] += st["pushed_bytes"]
            agg["servers"].append(st.get("server", {}))
            # per-partition resident bytes: this table's key
            # slice of the answering server's memory accounting (a
            # pserver may host other tables — only ours counts), one
            # row per partition KEY (replica copies are partition-
            # identical by construction, so dedup by key is exact for
            # the value shards and an estimate for the replog ring)
            for key, row in (st.get("memory") or {}).items():
                if key == self.name or str(key).startswith(
                        self.name + "@p"):
                    parts[key] = row
        resident = sum(int(r.get("resident_bytes", 0))
                       for r in parts.values())
        agg["memory"] = {
            "partitions": parts,
            "resident_bytes": resident,
            # cluster-wide estimate: every partition keeps R copies
            "replicated_resident_bytes": resident
            * max(1, self.replication),
        }
        if self.replication > 1:
            agg["replication"] = {"factor": self.replication,
                                  "partitions": self.replica_status()}
        return agg

    def memory_stats(self) -> dict:
        """Aggregated resident-byte accounting for this table across
        its pservers (the `stats` verb's memory section filtered to
        this table's partitions) — fleet.ps_stats()' memory row."""
        return self.stats()["memory"]

    def replica_status(self) -> List[dict]:
        """Per-partition replica states (role, epoch, last-applied seq,
        dropped backups) straight from each chain member; unreplicated
        tables report []. Replica lag is visible as seq deltas between
        a partition's primary and its backups."""
        if self.replication <= 1:
            return []
        out = []
        for p in range(self._n):
            primary_j = self._chain[p][self._primary_idx[p]]
            row = {"partition": p,
                   "primary": self.endpoints[primary_j],
                   "epoch": self._pepoch[p], "replicas": []}
            seqs = []
            for j in self._chain[p]:
                try:
                    st = self._conns[j].call(
                        "replica_status", name=self.name, partition=p)
                except Exception as e:  # noqa: BLE001 — dead replica
                    st = {"error": type(e).__name__}
                if "seq" in st:
                    seqs.append(int(st["seq"]))
                row["replicas"].append(
                    {"endpoint": self.endpoints[j], **st})
            if seqs:
                row["max_lag"] = max(seqs) - min(seqs)
            out.append(row)
        return out

    def server_stats(self) -> List[dict]:
        """Per-pserver telemetry snapshots (no table counters) — verb
        latencies, retry/replay-dedup counters, bytes in/out."""
        return [self._conns[s].call("stats").get("server", {})
                for s in range(self._n)]

    def to_dense(self) -> np.ndarray:
        out = np.empty((self.rows, self.dim), self.dtype)
        for s in range(self._n):
            out[s::self._n] = self._call(s, "to_dense", name=self.name)
        return out

    def state_dict(self):
        return {"servers": [self._call(s, "state_dict", name=self.name)
                            for s in range(self._n)]}

    def load_state_dict(self, state):
        if "servers" in state:
            for s, st in enumerate(state["servers"]):
                self._call(s, "load_state_dict", name=self.name, state=st)
        else:  # a local-table checkpoint restored into a hosted run
            if self._n != 1:
                raise ValueError(
                    "single-table checkpoint needs exactly 1 pserver")
            self._call(0, "load_state_dict", name=self.name, state=state)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if getattr(self, "_hedge_pool", None) is not None:
            self._hedge_pool.shutdown(wait=False)
        for c in self._conns:
            c.close()


# ---------------------------------------------------------------------------
# env contract
# ---------------------------------------------------------------------------


def pserver_endpoints() -> List[str]:
    """PADDLE_PSERVERS_IP_PORT_LIST (reference role_maker.py:497)."""
    raw = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    return [e.strip() for e in raw.split(",") if e.strip()]


def training_role() -> str:
    return os.environ.get("PADDLE_TRAINING_ROLE", "TRAINER").upper()


if __name__ == "__main__":
    sys.exit(main())
