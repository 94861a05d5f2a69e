"""Lease-based job control plane, ported from the JAX package's
``distributed/coordinator.py``.  It is framework-neutral: the same
verbs, replies, epochs, evictions, snapshots and WAL records as the JAX
package's, over the port's copy of the ps_server transport, so either
package's client talks to either package's coordinator.

Where the port differs: the cross-replica SDC verbs (``numerics_report``
/ ``numerics_status``, telemetry/numerics.py) and the fleet rollups
(``fleet_status`` / ``fleet_metrics``, telemetry/goodput.py's fleet
half) wait for ROADMAP A8 and raise NotImplementedError; renewals carry
no fleet payload.  The pserver side of the leases (``sweep``'s primary
election and its ``promote`` RPC, pserver replica summaries) is copied,
but the port has no parameter server to promote until the PS half of
ROADMAP A6.

The launcher hosts a tiny membership service — the `Coordinator` — and
every process in the job (trainers AND pservers) holds a renewable
lease on its membership. Heartbeat stamps become lease renewals: the
same JSON step payload trainers already stamp to the heartbeat file
rides each `renew` RPC, and pservers renew with their per-partition
replica summary (role / epoch / seq). Liveness decisions then live in
ONE place instead of being split between file mtimes and client retry
loops:

  trainers  — a lease that expires past the member's per-rank retry
              budget EVICTS the member: the coordinator bumps the
              membership epoch and the launcher restarts the surviving
              ranks at the reduced world size from the last checkpoint
              (elastic resize) instead of burning the whole restart
              budget on a permanently-lost host.
  pservers  — the coordinator is the lease-based primary elector the
              client-driven failover path (ps_server.RemoteTable) could
              not be: when a partition primary's lease expires, the
              coordinator promotes the best caught-up backup DIRECTLY
              (promote RPC, epoch fenced) — no client traffic needed.
              Clients discover the new primary through the
              StaleEpoch/NotPrimary bounce they already handle.

Transport: the `_TCPServer` / `_Handler` / `_Conn` stack from
ps_server.py, unchanged — the Coordinator just implements
`handle(method, kwargs)` + `shutdown_event` like PSServer does, so RPC
retries, deterministic fault injection (faults.py: `lease_expire`,
`netsplit` rules) and per-verb telemetry come for free.

Split-brain guard: every renewal carries the member's view of the
membership epoch (PADDLE_MEMBERSHIP_EPOCH, exported by the launcher at
spawn). A renewal from a FUTURE epoch means a newer coordinator exists
and THIS one is stale — the renewal is recorded but does not refresh
the lease, and the coordinator stops trusting its own membership view
for that member (heartbeat.HeartBeatMonitor applies the same rule to
file stamps).

Control-plane crash tolerance: the coordinator itself was
the last single point of failure — every data-plane component survives
crashes, but killing the launcher-hosted coordinator lost the lease
table, restart budgets, election grants and the in-flight checkpoint
barrier. Three layers close that hole, all OFF by default (the
in-launcher coordinator is byte-identical on the wire when
PADDLE_COORD_SNAPSHOT_SECS is unset and no standby is armed):

  durable state   — `state_dir` arms snapshot+WAL persistence: the full
                    authoritative state (leases with remaining windows,
                    membership epoch, budgets, election grants reflected
                    in member payloads, CkptBarrier shard reports,
                    incident ring) is pickled to `coord-<seq>.snap` via
                    the atomic tmp+os.replace path on a bounded cadence,
                    with an append-only verb WAL (`coord-<seq>.wal`)
                    between snapshots. A respawned coordinator (the
                    launcher supervises it like a pserver) reloads the
                    newest intact snapshot (torn newest falls back to
                    the previous one), replays the WAL tail, bumps its
                    INCARNATION, and treats the first
                    PADDLE_LEASE_EXPIRE_PERIODS lease periods as a
                    reconciliation window in which no lease may be
                    declared expired — a coordinator crash never falsely
                    evicts a healthy rank.
  grace mode      — CoordinatorClient buffers renewals while the
                    coordinator is unreachable (training continues) and
                    re-registers idempotently on reconnect.
  warm standby    — a second coordinator follows the primary via the
                    `repl_pull` snapshot+WAL stream and self-promotes
                    when the primary's incarnation lease lapses; clients
                    hold an ordered endpoint list. Split-brain is fenced
                    by the incarnation number riding every reply: a
                    deposed primary's replies are rejected client-side
                    and the deposed primary LATCHES stale when it sees a
                    renewal claiming a higher incarnation (the PS
                    StaleEpoch pattern, one layer up).

Env contract:
  PADDLE_COORDINATOR_ENDPOINT  host:port of the launcher's coordinator
                               (may be an ordered comma-separated list:
                               primary first, warm standby second)
  PADDLE_LEASE_SECS            lease duration (launch.py --lease_secs)
  PADDLE_MEMBERSHIP_EPOCH      the member's membership-epoch view
  PADDLE_TRAINER_TAG           stable identity ("trainer2") across
                               resizes — budgets key on it, not on the
                               re-numbered rank
  PADDLE_COORD_SNAPSHOT_SECS   durable-mode snapshot cadence; setting it
                               moves the coordinator out of the launcher
                               into a supervised child process
  PADDLE_COORD_CALL_DEADLINE_SECS
                               client-side control-plane verb deadline
                               (default 3.0 — renewals never block a
                               training step to exhaustion)
"""
from __future__ import annotations

import hashlib
import os
import pickle
import re
import struct
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry import get_registry

_REG = get_registry()

ENV_ENDPOINT = "PADDLE_COORDINATOR_ENDPOINT"
ENV_LEASE_SECS = "PADDLE_LEASE_SECS"
ENV_EPOCH = "PADDLE_MEMBERSHIP_EPOCH"
ENV_TAG = "PADDLE_TRAINER_TAG"

# a lease is EXPIRED once this many lease periods pass without a
# renewal (the "within 2 lease periods" promotion bound)
EXPIRE_PERIODS = float(os.environ.get("PADDLE_LEASE_EXPIRE_PERIODS", 2.0))

ENV_SNAPSHOT_SECS = "PADDLE_COORD_SNAPSHOT_SECS"
ENV_CALL_DEADLINE = "PADDLE_COORD_CALL_DEADLINE_SECS"
# size-based WAL compaction: once the current WAL segment exceeds this
# many bytes a snapshot is taken and the WAL rotates, regardless of the
# time-based snapshot cadence (0 = disabled, time/record triggers only)
ENV_WAL_MAX_BYTES = "PADDLE_COORD_WAL_MAX_BYTES"


def snapshot_secs_from_env(default: float = 1.0) -> float:
    try:
        return float(os.environ.get(ENV_SNAPSHOT_SECS) or default)
    except ValueError:
        return default


def wal_max_bytes_from_env(default: int = 0) -> int:
    try:
        return int(os.environ.get(ENV_WAL_MAX_BYTES) or default)
    except ValueError:
        return default


def call_deadline_from_env(default: float = 3.0) -> float:
    """Client-side control-plane verb deadline. 3.0s is the historical
    CoordinatorClient default — the env knob only SHORTENS how long a
    renewal may block a training step during a coordinator outage."""
    try:
        return float(os.environ.get(ENV_CALL_DEADLINE) or default)
    except ValueError:
        return default


def lease_secs_from_env() -> float:
    try:
        return float(os.environ.get(ENV_LEASE_SECS, 0) or 0)
    except ValueError:
        return 0.0


def membership_epoch_from_env() -> int:
    try:
        return int(os.environ.get(ENV_EPOCH, 0) or 0)
    except ValueError:
        return 0


def member_tag() -> str:
    """This process's stable membership identity: the launcher-exported
    tag survives resizes (ranks are re-numbered, tags are not)."""
    tag = os.environ.get(ENV_TAG)
    if tag:
        return tag
    ps = os.environ.get("PADDLE_PS_RANK_TAG")
    if ps:
        return ps
    return f"trainer{os.environ.get('PADDLE_TRAINER_ID', 0)}"


class _Member:
    __slots__ = ("tag", "kind", "endpoint", "expires", "payload",
                 "failures", "alive", "evicted", "expired_reported",
                 "stale_reported", "last_renew")

    def __init__(self, tag: str, kind: str, endpoint: Optional[str],
                 expires: float):
        self.tag = tag
        self.kind = kind
        self.endpoint = endpoint
        self.expires = expires
        self.payload: Optional[dict] = None
        self.failures = 0
        self.alive = True
        self.evicted = False
        self.expired_reported = False  # one lease_expired event per lapse
        self.stale_reported = False  # one stale_coordinator event
        self.last_renew = 0.0

    def status(self, now: float) -> dict:
        return {
            "kind": self.kind, "endpoint": self.endpoint,
            "alive": self.alive, "evicted": self.evicted,
            "failures": self.failures,
            "lease_remaining_s": round(self.expires - now, 3),
            "payload": self.payload,
        }

    def to_state(self, now: float) -> dict:
        """Snapshot row. `expires` is stored as a REMAINING window, not
        a wall-clock instant — the restoring process re-anchors it to
        its own `now` (and then floors it at the reconciliation window),
        so a long outage cannot make every lease look long-expired."""
        return {
            "tag": self.tag, "kind": self.kind, "endpoint": self.endpoint,
            "remaining": self.expires - now,
            "payload": (dict(self.payload)
                        if self.payload is not None else None),
            "failures": self.failures, "alive": self.alive,
            "evicted": self.evicted,
            "expired_reported": self.expired_reported,
            "stale_reported": self.stale_reported,
            "last_renew": self.last_renew,
        }

    @classmethod
    def from_state(cls, st: dict, now: float) -> "_Member":
        m = cls(st["tag"], st.get("kind", "trainer"), st.get("endpoint"),
                now + float(st.get("remaining", 0.0)))
        m.payload = (dict(st["payload"])
                     if st.get("payload") is not None else None)
        m.failures = int(st.get("failures", 0))
        m.alive = bool(st.get("alive", True))
        m.evicted = bool(st.get("evicted", False))
        m.expired_reported = bool(st.get("expired_reported", False))
        m.stale_reported = bool(st.get("stale_reported", False))
        m.last_renew = float(st.get("last_renew", 0.0))
        return m


class CkptBarrier:
    """Commit barrier for sharded checkpoints (fluid/checkpoint.py):
    every rank reports its landed shard manifest (`ckpt_shard_commit`)
    and rank 0 polls `ckpt_status` until all world_size shards are in,
    THEN writes the global manifest — the single commit point that
    makes a partially-saved step invisible to every restore. Implements
    the `_Handler` contract, so it serves standalone over the ps_server
    TCP transport (the launcher hosts one for every multi-rank job) or
    rides a `Coordinator`'s port when the lease plane is armed.

    State is bounded: only the newest _KEEP steps are remembered — a
    report for a long-gone step can only come from a rank so far behind
    that its job already failed."""

    _KEEP = 32

    def __init__(self):
        self.cond = threading.Condition()
        # step -> {"world": int, "shards": {rank: info}}
        self.steps: Dict[int, dict] = {}
        self.shutdown_event = threading.Event()  # _Handler contract

    def shard_commit(self, step: int, rank: int, world_size: int,
                     info: Optional[dict] = None) -> dict:
        with self.cond:
            ent = self.steps.setdefault(
                int(step), {"world": int(world_size), "shards": {}})
            ent["world"] = int(world_size)
            ent["shards"][int(rank)] = dict(info or {})
            while len(self.steps) > self._KEEP:
                self.steps.pop(min(self.steps))
            self.cond.notify_all()
            _REG.counter("ckpt_barrier_reports_total").inc()
            return {"complete": len(ent["shards"]) >= ent["world"]}

    def status(self, step: int) -> dict:
        with self.cond:
            ent = self.steps.get(int(step)) or {"world": 0, "shards": {}}
            return {"world": ent["world"],
                    "shards": {r: dict(i)
                               for r, i in ent["shards"].items()},
                    "complete": (ent["world"] > 0
                                 and len(ent["shards"]) >= ent["world"])}

    def wait_full(self, step: int, world_size: int,
                  timeout: float) -> dict:
        """Block until all `world_size` shards reported (in-process
        callers; remote rank 0 polls `status` instead so no handler
        thread sits in a long wait)."""
        deadline = time.monotonic() + float(timeout)
        with self.cond:
            while True:
                ent = self.steps.get(int(step))
                if ent is not None and \
                        len(ent["shards"]) >= int(world_size):
                    return {"complete": True,
                            "shards": {r: dict(i)
                                       for r, i in ent["shards"].items()}}
                left = deadline - time.monotonic()
                if left <= 0:
                    return {"complete": False,
                            "shards": {r: dict(i) for r, i in
                                       (ent or {"shards": {}})
                                       ["shards"].items()}}
                self.cond.wait(min(left, 0.2))

    def handle(self, method: str, kwargs: dict):
        if method == "ping":
            return "pong"
        if method == "ckpt_shard_commit":
            return self.shard_commit(kwargs["step"], kwargs["rank"],
                                     kwargs["world_size"],
                                     kwargs.get("info"))
        if method == "ckpt_status":
            return self.status(kwargs["step"])
        if method == "shutdown":
            self.shutdown_event.set()
            return 0
        raise ValueError(f"unknown ckpt-barrier method {method!r}")


def serve_ckpt_barrier(barrier: CkptBarrier, host: str = "127.0.0.1",
                       port: int = 0):
    """Host `barrier` over the ps_server TCP transport (daemon thread).
    Returns (server, "host:port"); the launcher exports the endpoint as
    PADDLE_CKPT_BARRIER_ENDPOINT so sharded checkpoint writers can
    reach the commit barrier."""
    from .ps_server import _Handler, _TCPServer

    srv = _TCPServer((host, port), _Handler)
    srv.ps = barrier  # type: ignore[attr-defined] — _Handler contract
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True,
                     name="paddle-tpu-ckpt-barrier").start()
    return srv, f"{host}:{srv.server_address[1]}"


# ---------------------------------------------------------------------------
# durable state: framed+checksummed snapshots, verb WAL
# ---------------------------------------------------------------------------

_SNAP_MAGIC = b"PCOORD1\n"


def _atomic_write(path: str, blob: bytes) -> None:
    """tmp + fsync + os.replace — the same commit discipline every other
    durable artifact in the tree uses (snapshots, manifests)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_snapshot(path: str) -> Optional[dict]:
    """One snapshot file, or None when missing/torn/corrupt (the loader
    falls back to the previous intact snapshot + a longer WAL replay)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if not blob.startswith(_SNAP_MAGIC):
        return None
    digest, payload = (blob[len(_SNAP_MAGIC):len(_SNAP_MAGIC) + 32],
                       blob[len(_SNAP_MAGIC) + 32:])
    if hashlib.sha256(payload).digest() != digest:
        return None
    try:
        state = pickle.loads(payload)
    except Exception:  # noqa: BLE001 — corrupt == torn for the loader
        return None
    return state if isinstance(state, dict) else None


def _read_wal(path: str) -> List[Tuple[str, dict]]:
    """Length-prefixed (verb, kwargs) records; a torn tail (the crash
    landed mid-append) truncates the replay at the last intact record
    instead of failing recovery."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return []
    out: List[Tuple[str, dict]] = []
    off = 0
    while off + 4 <= len(data):
        (n,) = struct.unpack_from(">I", data, off)
        if off + 4 + n > len(data):
            break
        try:
            rec = pickle.loads(data[off + 4:off + 4 + n])
        except Exception:  # noqa: BLE001 — torn tail
            break
        if isinstance(rec, tuple) and len(rec) == 2:
            out.append(rec)
        off += 4 + n
    return out


class Coordinator:
    """Membership + lease table. Hosted in the LAUNCHER process: the
    launcher calls the methods directly (it is the consumer of events);
    remote members reach the same object through serve() + the
    ps_server RPC transport. All state is guarded by one lock — verbs
    are tiny and never block on I/O except `sweep`'s promote RPCs,
    which run outside the lock. Also carries the sharded-checkpoint
    commit barrier (`ckpt_*` verbs delegate to an owned CkptBarrier),
    so a lease-armed job's barrier shares the coordinator's port."""

    def __init__(self, lease_secs: float = 5.0, retries_per_rank: int = 0,
                 expire_periods: float = EXPIRE_PERIODS,
                 startup_grace: Optional[float] = None,
                 state_dir: Optional[str] = None,
                 snapshot_secs: Optional[float] = None,
                 wal_max_bytes: Optional[int] = None,
                 role: str = "primary"):
        self.lease_secs = float(lease_secs)
        self.retries_per_rank = int(retries_per_rank)
        self.expire_periods = float(expire_periods)
        # first expiry deadline after register: imports, the startup
        # program and the first step legitimately exceed a lease period (same reasoning as
        # HeartBeatMonitor.startup_grace)
        self.startup_grace = (
            float(startup_grace) if startup_grace is not None
            else max(self.lease_secs * 10.0,
                     self.lease_secs * self.expire_periods))
        self.epoch = 0
        self.members: Dict[str, _Member] = {}
        self.events: deque = deque(maxlen=512)
        # fleet view: unlike `events` (drained by the
        # launcher log), incidents are RETAINED — the /fleetz "worst
        # badput incidents" table reads them on every scrape
        self.incidents: deque = deque(maxlen=64)
        self.lock = threading.RLock()
        self.shutdown_event = threading.Event()  # _Handler contract
        self.ckpt_barrier = CkptBarrier()
        # cross-replica SDC detection (telemetry/numerics.py,
        # ROADMAP A8) is not ported: the eviction set stays empty and
        # rides the durable state as the JAX package's does
        self._sdc_evicted: set = set()
        # -- durable state + HA --------------------------------
        # incarnation 0 == the legacy in-launcher coordinator: no reply
        # stamping, no WAL mirror, byte-identical wire behavior. A
        # durable (process-hosted) primary is incarnation >= 1.
        self.role = role  # "primary" | "standby"
        self.incarnation = 0
        self.stale_latched = False  # deposed primary (incarnation fence)
        self.state_dir = state_dir or None
        self.snapshot_secs = (float(snapshot_secs)
                              if snapshot_secs is not None
                              else snapshot_secs_from_env())
        self.wal_max_bytes = (int(wal_max_bytes)
                              if wal_max_bytes is not None
                              else wal_max_bytes_from_env())
        self._reconcile_until = 0.0  # no expiries before this instant
        self._snap_seq = 0
        self._last_snap = 0.0
        self._wal_f = None  # open WAL file (durable primary only)
        self._wal_mem: List[Tuple[str, dict]] = []  # repl_pull stream
        self._wal_bytes = 0  # serialized bytes in the current segment
        self._replaying = False  # WAL/replication apply in progress
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
        if self.state_dir and self.role == "primary":
            self._load_durable()
            with self.lock:
                # persist the incarnation bump NOW (and rotate the WAL)
                # so a crash right after recovery still fences below us
                self._snapshot_locked(time.time())
        elif self.role == "standby":
            # a standby mirrors the primary's state (and seq) through
            # repl_apply; its state_dir is only used AFTER promotion
            self.incarnation = 0

    # incident kinds worth keeping for the fleet view: anything that
    # costs the job badput (deaths, evictions, expiries, stragglers,
    # SDC verdicts, promotions, control-plane outages)
    INCIDENT_EVENTS = frozenset((
        "member_failed", "member_evicted", "lease_expired", "straggler",
        "stall", "divergence", "ps_promoted", "ps_promotion_failed",
        "restart", "coord_outage", "coord_recovered", "coord_promoted",
    ))

    # verbs replayed from the WAL (everything that mutates durable
    # state; reads and the fleet rollups are deliberately absent)
    _WAL_VERBS = frozenset((
        "register", "renew", "report_failure", "note_incident",
        "ckpt_shard_commit", "sweep",
    ))

    # -- internals -------------------------------------------------------
    def _event(self, **ev) -> None:
        ev.setdefault("ts", time.time())
        self.events.append(ev)
        if ev.get("event") in self.INCIDENT_EVENTS:
            self.incidents.append(dict(ev))

    def _deadline(self, now: float) -> float:
        return now + self.lease_secs * self.expire_periods

    def _get(self, tag: str, kind: str = "trainer",
             endpoint: Optional[str] = None,
             now: Optional[float] = None) -> _Member:
        now = time.time() if now is None else now
        m = self.members.get(tag)
        if m is None:
            m = self.members[tag] = _Member(
                tag, kind, endpoint, now + self.startup_grace)
        return m

    # -- durable state: snapshot + WAL -------------------------
    def state_dict(self, now: Optional[float] = None) -> dict:
        """The full authoritative state, picklable: lease table (with
        REMAINING windows), budgets, membership epoch, member payloads
        (election grants live there), event + incident rings, CkptBarrier
        in-progress shard reports, SDC eviction set."""
        now = time.time() if now is None else now
        with self.lock:
            with self.ckpt_barrier.cond:
                ckpt_steps = {
                    int(s): {"world": int(e["world"]),
                             "shards": {int(r): dict(i)
                                        for r, i in e["shards"].items()}}
                    for s, e in self.ckpt_barrier.steps.items()}
            return {
                "format": 1,
                "seq": self._snap_seq,
                "incarnation": self.incarnation,
                "epoch": self.epoch,
                "lease_secs": self.lease_secs,
                "saved_at": now,
                "members": [m.to_state(now)
                            for _, m in sorted(self.members.items())],
                "events": [dict(e) for e in self.events],
                "incidents": [dict(e) for e in self.incidents],
                "ckpt_steps": ckpt_steps,
                "sdc_evicted": sorted(self._sdc_evicted),
            }

    def load_state_dict(self, state: dict,
                        now: Optional[float] = None) -> None:
        """Replace in-memory state with `state` (restore + replication
        apply). Does NOT touch incarnation/role — recovery and promotion
        own those transitions."""
        now = time.time() if now is None else now
        with self.lock:
            self.epoch = int(state.get("epoch", 0))
            self.members = {}
            for st in state.get("members", []):
                m = _Member.from_state(st, now)
                self.members[m.tag] = m
            self.events = deque((dict(e) for e in state.get("events", [])),
                                maxlen=512)
            self.incidents = deque(
                (dict(e) for e in state.get("incidents", [])), maxlen=64)
            with self.ckpt_barrier.cond:
                self.ckpt_barrier.steps = {
                    int(s): {"world": int(e["world"]),
                             "shards": {int(r): dict(i)
                                        for r, i in e["shards"].items()}}
                    for s, e in (state.get("ckpt_steps") or {}).items()}
                self.ckpt_barrier.cond.notify_all()
            self._sdc_evicted = set(state.get("sdc_evicted", []))

    def _snap_path(self, seq: int) -> str:
        return os.path.join(self.state_dir, f"coord-{seq:08d}.snap")

    def _wal_path(self, seq: int) -> str:
        return os.path.join(self.state_dir, f"coord-{seq:08d}.wal")

    def _snapshot_locked(self, now: float) -> None:
        """One snapshot + WAL rotation (caller holds the lock). The
        in-memory WAL mirror resets with the sequence number so
        repl_pull followers detect the rotation and pull a full
        snapshot."""
        self._snap_seq += 1
        self._last_snap = now
        if self.state_dir:
            payload = pickle.dumps(self.state_dict(now))
            _atomic_write(self._snap_path(self._snap_seq),
                          _SNAP_MAGIC + hashlib.sha256(payload).digest()
                          + payload)
            if self._wal_f is not None:
                try:
                    self._wal_f.close()
                except OSError:
                    pass
            self._wal_f = open(self._wal_path(self._snap_seq), "ab")
            # keep this snapshot and the previous one (the torn-newest
            # fallback); older generations are garbage
            for name in os.listdir(self.state_dir):
                mm = re.match(r"coord-(\d+)\.(snap|wal)$", name)
                if mm and int(mm.group(1)) <= self._snap_seq - 2:
                    try:
                        os.unlink(os.path.join(self.state_dir, name))
                    except OSError:
                        pass
        self._wal_mem = []
        self._wal_bytes = 0
        _REG.counter("coordinator_snapshots_total").inc()

    def snapshot(self, force: bool = False,
                 now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self.lock:
            if not force and now - self._last_snap < self.snapshot_secs:
                return
            self._snapshot_locked(now)

    def _mutated(self, verb: str, kw: dict) -> None:
        """One mutating verb landed: append it to the WAL (durable disk
        + the in-memory replication mirror) and maybe take a coalesced
        snapshot. No-op for the legacy in-launcher coordinator
        (incarnation 0) and during replay."""
        if self._replaying or self.incarnation <= 0:
            return
        with self.lock:
            rec = (verb, kw)
            self._wal_mem.append(rec)
            blob = pickle.dumps(rec)
            self._wal_bytes += 4 + len(blob)  # length prefix + payload
            if self._wal_f is not None:
                try:
                    self._wal_f.write(struct.pack(">I", len(blob)) + blob)
                    self._wal_f.flush()
                except OSError:
                    pass
            now = time.time()
            if (now - self._last_snap >= self.snapshot_secs
                    or len(self._wal_mem) > 4096
                    or (self.wal_max_bytes > 0
                        and self._wal_bytes >= self.wal_max_bytes)):
                self._snapshot_locked(now)

    def _apply(self, verb: str, kw: dict) -> None:
        """Replay one WAL record (recovery / replication). A bad record
        must not block recovery — everything it described is also in the
        next snapshot."""
        if verb not in self._WAL_VERBS:
            return
        try:
            if verb == "register":
                self.register(**kw)
            elif verb == "renew":
                self.renew(**kw)
            elif verb == "report_failure":
                self.report_failure(**kw)
            elif verb == "note_incident":
                self.note_incident(kw.get("incident") or {})
            elif verb == "ckpt_shard_commit":
                self.ckpt_barrier.shard_commit(**kw)
            elif verb == "sweep":
                self.sweep(**kw)
        except Exception:  # noqa: BLE001
            pass

    def _load_durable(self) -> None:
        """Recover from state_dir: newest intact snapshot (a torn newest
        falls back to the previous one), then the WAL tail(s) — wal-N
        holds mutations AFTER snap-N, so a fallback to snap-(N-1)
        replays wal-(N-1) and wal-N in order. Ends with the incarnation
        bump and the reconciliation window armed."""
        now = time.time()
        seqs = sorted(
            int(mm.group(1)) for name in os.listdir(self.state_dir)
            for mm in [re.match(r"coord-(\d+)\.snap$", name)] if mm)
        loaded, loaded_seq = None, 0
        for seq in reversed(seqs):
            state = _read_snapshot(self._snap_path(seq))
            if state is not None:
                loaded, loaded_seq = state, seq
                break
        prior_inc = 0
        if loaded is not None:
            prior_inc = int(loaded.get("incarnation", 0))
            self.load_state_dict(loaded, now=now)
            self._replaying = True
            try:
                for seq in [s for s in seqs if s >= loaded_seq]:
                    for verb, kw in _read_wal(self._wal_path(seq)):
                        self._apply(verb, kw)
            finally:
                self._replaying = False
        self._snap_seq = max(seqs) if seqs else 0
        self.incarnation = prior_inc + 1
        if loaded is not None:
            # reconciliation window: replayed register/renew recomputed
            # expiries from RECORDED times, and the outage itself ate
            # wall-clock — no lease may be declared expired until every
            # healthy member had EXPIRE_PERIODS renewal chances against
            # the recovered coordinator
            self._reconcile_until = (
                now + self.lease_secs * self.expire_periods)
            with self.lock:
                for m in self.members.values():
                    if not m.evicted:
                        m.expires = max(m.expires, self._reconcile_until)
                        m.expired_reported = False
                self._event(event="coord_recovered",
                            incarnation=self.incarnation,
                            snapshot_seq=loaded_seq,
                            members=len(self.members), epoch=self.epoch)
            _REG.counter("coordinator_recoveries_total").inc()

    # -- warm standby: replication + promotion -----------------
    def repl_pull(self, have_seq: int = -1, have_off: int = 0) -> dict:
        """Primary side of the follower stream: a follower at (seq, off)
        gets the WAL records it is missing, or a full snapshot + WAL
        when its seq is stale (rotation happened, or first contact)."""
        with self.lock:
            out = {"seq": self._snap_seq, "incarnation": self.incarnation,
                   "role": self.role, "off": len(self._wal_mem)}
            if int(have_seq) != self._snap_seq:
                out["snapshot"] = self.state_dict()
                out["wal"] = list(self._wal_mem)
            else:
                out["wal"] = self._wal_mem[max(0, int(have_off)):]
            return out

    def repl_apply(self, pulled: dict,
                   now: Optional[float] = None) -> None:
        """Standby side: mirror one repl_pull reply (full snapshot when
        present, then the WAL tail), tracking the primary's seq and
        incarnation so promotion fences ABOVE everything seen."""
        now = time.time() if now is None else now
        with self.lock:
            self._replaying = True
            try:
                if pulled.get("snapshot") is not None:
                    self.load_state_dict(pulled["snapshot"], now=now)
                for verb, kw in pulled.get("wal") or []:
                    self._apply(verb, kw)
            finally:
                self._replaying = False
            self.incarnation = int(
                pulled.get("incarnation", self.incarnation))
            self._snap_seq = int(pulled.get("seq", self._snap_seq))

    def promote(self, now: Optional[float] = None) -> None:
        """Standby → primary. The fence bumps by TWO: a crash-respawned
        old primary bumps by one, so the promoted standby always wins
        the incarnation comparison (ties only on chained double
        failovers, which the ordered endpoint list still resolves by
        position). Arms the reconciliation window exactly like a
        respawn — the takeover must not falsely expire anyone either."""
        now = time.time() if now is None else now
        with self.lock:
            if self.role == "primary":
                return
            self.role = "primary"
            self.incarnation = int(self.incarnation) + 2
            self._reconcile_until = (
                now + self.lease_secs * self.expire_periods)
            for m in self.members.values():
                if not m.evicted:
                    m.expires = max(m.expires, self._reconcile_until)
                    m.expired_reported = False
            self._event(event="coord_promoted",
                        incarnation=self.incarnation, epoch=self.epoch)
            _REG.counter("coordinator_promotions_total").inc()
            if self.state_dir:
                os.makedirs(self.state_dir, exist_ok=True)
                self._snapshot_locked(now)

    def coord_status(self, now: Optional[float] = None) -> dict:
        """Control-plane self-description (debugz /statusz row)."""
        now = time.time() if now is None else now
        with self.lock:
            return {
                "incarnation": self.incarnation,
                "role": self.role,
                "stale": self.stale_latched,
                "durable": bool(self.state_dir),
                "epoch": self.epoch,
                "members": len(self.members),
                "snapshot_seq": self._snap_seq,
                "last_snapshot_age_s": (round(now - self._last_snap, 3)
                                        if self._last_snap else None),
                "wal_records": len(self._wal_mem),
                "wal_bytes": self._wal_bytes,
                "reconcile_remaining_s": round(
                    max(0.0, self._reconcile_until - now), 3),
            }

    def _check_client_incarnation(self, coord_inc, tag: str) -> None:
        """A member claiming a HIGHER coordinator incarnation has talked
        to a newer coordinator — THIS one was deposed (it crashed and a
        standby promoted over it, or it is a stale standby). Latch stale
        (the PS StaleEpoch pattern one layer up): authority verbs stop
        granting, sweeps stop expiring, and clients reject the latched
        replies."""
        if not coord_inc or self._replaying:
            return
        ci = int(coord_inc)
        if self.incarnation and ci > self.incarnation \
                and not self.stale_latched:
            self.stale_latched = True
            self._event(event="stale_coordinator_incarnation", tag=tag,
                        claimed=ci, incarnation=self.incarnation)
            _REG.counter("coordinator_stale_incarnation_total").inc()

    # -- verbs (also called directly by the launcher) --------------------
    def register(self, tag: str, kind: str = "trainer",
                 endpoint: Optional[str] = None, payload: Optional[dict] = None,
                 epoch: Optional[int] = None, now: Optional[float] = None,
                 coord_inc=None):
        """(Re)grant a lease. Registration is identity-stable: a
        respawned process re-registers under its old tag and keeps its
        failure count (budgets outlive incarnations). An EVICTED tag is
        told so — the member must not keep working. Registration is also
        the grace-mode reconnect verb: re-registering an existing tag is
        idempotent (budgets and payloads survive)."""
        now = time.time() if now is None else now
        with self.lock:
            self._check_client_incarnation(coord_inc, tag)
            if self.stale_latched:
                return {"epoch": self.epoch, "lease_secs": self.lease_secs,
                        "evicted": False, "stale_coordinator": True}
            m = self._get(tag, kind, endpoint, now)
            m.kind = kind
            if endpoint:
                m.endpoint = endpoint
            if payload is not None:
                m.payload = dict(payload)
            self._mutated("register", {
                "tag": tag, "kind": kind, "endpoint": endpoint,
                "payload": payload, "now": now})
            if m.evicted:
                return {"epoch": self.epoch, "lease_secs": self.lease_secs,
                        "evicted": True}
            m.alive = True
            m.expired_reported = False
            # fresh registrations get the startup grace, renewals the
            # plain lease window — registration IS process (re)birth
            m.expires = now + max(self.startup_grace,
                                  self.lease_secs * self.expire_periods)
            _REG.counter("coordinator_registrations_total",
                         kind=kind).inc()
            return {"epoch": self.epoch, "lease_secs": self.lease_secs,
                    "evicted": False}

    def renew(self, tag: str, payload: Optional[dict] = None,
              epoch: Optional[int] = None, now: Optional[float] = None,
              coord_inc=None):
        """One lease renewal — the heartbeat stamp as an RPC. The
        payload is stored verbatim (step/avg_step_s for trainers,
        partition replica summaries for pservers). A renewal claiming a
        FUTURE membership epoch does NOT refresh the lease: a newer
        coordinator owns that member and this one is stale
        (split-brain guard). Same rule one layer up: a renewal claiming
        a future coordinator INCARNATION latches this coordinator
        stale."""
        now = time.time() if now is None else now
        ep = membership_epoch_from_env() if epoch is None else int(epoch)
        with self.lock:
            self._check_client_incarnation(coord_inc, tag)
            if self.stale_latched:
                return {"epoch": self.epoch, "evicted": False,
                        "stale_coordinator": True}
            m = self._get(tag, now=now)
            if payload is not None:
                m.payload = dict(payload)
            self._mutated("renew", {"tag": tag, "payload": payload,
                                    "epoch": ep, "now": now})
            if m.evicted:
                _REG.counter("coordinator_evicted_renewals_total").inc()
                return {"epoch": self.epoch, "evicted": True}
            if ep > self.epoch:
                _REG.counter("coordinator_stale_renewals_total").inc()
                if not m.stale_reported:
                    m.stale_reported = True
                    self._event(event="stale_coordinator", tag=tag,
                                member_epoch=ep, epoch=self.epoch)
                return {"epoch": self.epoch, "evicted": False,
                        "stale_coordinator": True}
            m.alive = True
            m.expired_reported = False
            m.last_renew = now
            m.expires = self._deadline(now)
            _REG.counter("coordinator_renewals_total", kind=m.kind).inc()
            return {"epoch": self.epoch, "evicted": False}

    def membership(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        with self.lock:
            trainers = [t for t, m in self.members.items()
                        if m.kind == "trainer" and not m.evicted]
            return {
                "epoch": self.epoch,
                "lease_secs": self.lease_secs,
                "retries_per_rank": self.retries_per_rank,
                "world_size": len(trainers),
                "members": {t: m.status(now)
                            for t, m in sorted(self.members.items())},
            }

    def report_failure(self, tag: str, reason: str = "") -> dict:
        """The launcher observed a failure (nonzero exit, stale
        heartbeat, expired lease, straggler ejection) for `tag`. The
        coordinator owns the budget: within the per-rank budget the
        member may be restarted; past it the member is EVICTED and the
        membership epoch bumps — the elastic-resize signal."""
        with self.lock:
            m = self._get(tag)
            m.alive = False
            m.failures += 1
            self._mutated("report_failure", {"tag": tag, "reason": reason})
            evicted = m.failures > self.retries_per_rank
            if evicted and not m.evicted:
                m.evicted = True
                self.epoch += 1
                _REG.counter("coordinator_evictions_total").inc()
                self._event(event="member_evicted", tag=tag, reason=reason,
                            failures=m.failures, epoch=self.epoch)
            elif not evicted:
                self._event(event="member_failed", tag=tag, reason=reason,
                            failures=m.failures,
                            retries_left=self.retries_per_rank - m.failures)
            return {"evicted": m.evicted, "epoch": self.epoch,
                    "failures": m.failures,
                    "retries_left": max(
                        0, self.retries_per_rank - m.failures)}

    def expired_tags(self, now: Optional[float] = None,
                     kind: Optional[str] = None) -> List[str]:
        now = time.time() if now is None else now
        with self.lock:
            return [t for t, m in self.members.items()
                    if m.alive and not m.evicted and now > m.expires
                    and (kind is None or m.kind == kind)]

    def drain_events(self) -> List[dict]:
        with self.lock:
            out, self.events = list(self.events), deque(maxlen=512)
            return out

    # -- fleet metrics aggregation -----------------------------
    def note_incident(self, ev: dict) -> dict:
        """The launcher (or a tool) records one badput incident —
        straggler stall episodes and restart windows land here so the
        fleet view cites the same evidence goodtop stitches."""
        ev = dict(ev)
        ev.setdefault("event", "stall")
        with self.lock:
            self._event(**ev)
            self._mutated("note_incident", {"incident": dict(ev)})
        return {"ok": True}

    def fleet_status(self) -> dict:
        """The fleet rollup of the JAX package (debugz /fleetz) merges
        goodput summaries from the renewal payloads: not ported."""
        raise NotImplementedError(
            "Coordinator.fleet_status: the fleet rollup needs "
            "telemetry/goodput.py's fleet half (ROADMAP A8)")

    def fleet_metrics(self) -> str:
        raise NotImplementedError(
            "Coordinator.fleet_metrics: the fleet exposition needs "
            "telemetry/goodput.py's fleet half (ROADMAP A8)")

    # -- cross-replica SDC detection -------------------------------------
    def numerics_report(self, tag: str, step: int, fingerprint: dict,
                        world_size: int = 0) -> dict:
        raise NotImplementedError(
            "Coordinator.numerics_report: cross-replica SDC detection "
            "needs telemetry/numerics.py (ROADMAP A8)")

    def numerics_status(self) -> dict:
        raise NotImplementedError(
            "Coordinator.numerics_status: cross-replica SDC detection "
            "needs telemetry/numerics.py (ROADMAP A8)")

    # -- lease sweep + pserver primary election --------------------------
    def sweep(self, now: Optional[float] = None) -> List[dict]:
        """One supervision tick: find expired leases, emit one
        `lease_expired` event per lapse, and for every expired PSERVER
        that held partition primaries, elect + promote a caught-up
        backup (the ROADMAP "promote without a client in the loop"
        path). Returns the events raised by THIS tick. The launcher
        calls this on its watch cadence; tests drive it with an
        explicit `now`.

        Crash tolerance: inside the post-recovery
        RECONCILIATION WINDOW no lease may be declared expired — every
        replayed/restored expiry is an artifact of the outage until the
        member had its full expiry window against the RECOVERED
        coordinator. A stale-latched (deposed) coordinator and an
        unpromoted standby exercise no expiry authority at all."""
        now = time.time() if now is None else now
        if not self._replaying:
            if self.stale_latched or self.role == "standby":
                return []
            if now < self._reconcile_until:
                return []
        raised: List[dict] = []
        elect: List[_Member] = []
        with self.lock:
            for tag, m in self.members.items():
                if m.evicted or not m.alive or now <= m.expires:
                    continue
                if m.expired_reported:
                    continue
                m.expired_reported = True
                ev = {"event": "lease_expired", "tag": tag, "kind": m.kind,
                      "overdue_s": round(now - m.expires, 3)}
                self._event(**ev)
                raised.append(ev)
                _REG.counter("coordinator_lease_expiries_total",
                             kind=m.kind).inc()
                if m.kind == "pserver":
                    m.alive = False  # stops being an election candidate
                    elect.append(m)
        for dead in elect:
            raised.extend(self._elect_primaries(dead))
        if raised:
            # no-op sweeps (the launcher's 0.2s cadence) mutate nothing
            # and must not bloat the WAL; a sweep that RAISED is state
            self._mutated("sweep", {"now": now})
        return raised

    def _partition_view(self, key: str):
        """(candidates, epochs, backups) for one partition key from the
        latest renewal payloads — candidates are caught-up live backups,
        epochs every epoch seen, backups the live replica endpoints."""
        cands, epochs, backups = [], [0], []
        with self.lock:
            for m in self.members.values():
                if m.kind != "pserver":
                    continue
                st = ((m.payload or {}).get("partitions") or {}).get(key)
                if st is None:
                    continue
                epochs.append(int(st.get("epoch", 0)))
                if not m.alive or m.evicted or not m.endpoint:
                    continue
                backups.append(m.endpoint)
                if st.get("role") == "backup" and not st.get("stale"):
                    cands.append((int(st.get("epoch", 0)),
                                  int(st.get("seq", 0)), m))
        return cands, epochs, backups

    def _elect_primaries(self, dead: _Member) -> List[dict]:
        """Promote a backup for every partition the dead pserver led.
        Runs OUTSIDE the coordinator lock (promote is a real RPC)."""
        parts = (dead.payload or {}).get("partitions") or {}
        raised: List[dict] = []
        for key, st in sorted(parts.items()):
            if st.get("role") != "primary":
                continue
            cands, epochs, backups = self._partition_view(key)
            if not cands:
                ev = {"event": "ps_promotion_skipped", "key": key,
                      "from": dead.tag, "reason": "no caught-up backup"}
                with self.lock:
                    self._event(**ev)
                raised.append(ev)
                continue
            cands.sort()
            _, seq, target = cands[-1]
            new_epoch = max(epochs) + 1
            name, _, part = key.rpartition("@p")
            try:
                if not self._replaying:
                    # WAL replay / replication apply rebuilds the GRANT
                    # REFLECTION only — the promote RPC already happened
                    # in the previous incarnation
                    from .ps_server import _Conn

                    conn = _Conn(target.endpoint, deadline=5.0,
                                 io_timeout=10.0)
                    try:
                        conn.call("promote", name=name,
                                  partition=int(part), epoch=new_epoch,
                                  backups=[b for b in backups
                                           if b != target.endpoint])
                    finally:
                        conn.close()
            except Exception as e:  # noqa: BLE001 — election must not
                # take the launcher down; the next sweep retries nothing
                # (the client-driven failover path still exists)
                ev = {"event": "ps_promotion_failed", "key": key,
                      "from": dead.tag, "to": target.tag,
                      "error": f"{type(e).__name__}: {e}"}
                with self.lock:
                    self._event(**ev)
                raised.append(ev)
                continue
            _REG.counter("coordinator_ps_promotions_total").inc()
            ev = {"event": "ps_promoted", "key": key, "from": dead.tag,
                  "to": target.tag, "epoch": new_epoch, "seq": seq}
            with self.lock:
                self._event(**ev)
                # reflect the grant locally so a repeated sweep (the
                # dead server stays dead) does not re-promote; the next
                # real renewal from the target carries the truth anyway
                tparts = (target.payload or {}).setdefault("partitions", {})
                tparts.setdefault(key, {})["role"] = "primary"
                tparts[key]["epoch"] = new_epoch
                dparts = (dead.payload or {}).get("partitions") or {}
                if key in dparts:
                    dparts[key]["role"] = None
            raised.append(ev)
        return raised

    # verbs that exercise (or mutate) membership/commit AUTHORITY: an
    # unpromoted standby and a stale-latched deposed primary refuse
    # them with a reply that makes the client rotate down its endpoint
    # list (read-only verbs still answer — debugz works on a standby)
    _AUTHORITY_VERBS = frozenset((
        "register", "renew", "report_failure", "note_incident",
        "numerics_report", "sweep",
    ))

    # -- RPC dispatch (ps_server._Handler contract) ----------------------
    def handle(self, method: str, kwargs: dict):
        from . import faults

        inj = faults.injector()
        if inj is not None:
            inj.on_server_call(method)
            # deterministic chaos site: `crash:coord_verb:<nth>` kills
            # the process-hosted coordinator at its Nth handled verb
            # (the kill-and-respawn drill)
            inj.at_phase("coord_verb")
        result = self._dispatch(method, kwargs)
        if self.incarnation > 0 and isinstance(result, dict):
            # the fence rides every reply; absent entirely on the
            # legacy in-launcher coordinator (incarnation 0), keeping
            # the default wire format byte-identical
            result.setdefault("coord_incarnation", self.incarnation)
            if self.stale_latched:
                result.setdefault("stale_coordinator", True)
        return result

    def _dispatch(self, method: str, kwargs: dict):
        if method == "ping":
            return "pong"
        if self.role == "standby" and (method in self._AUTHORITY_VERBS
                                       or method.startswith("ckpt_")):
            # followers hold state but no authority until promoted
            return {"standby": True, "epoch": self.epoch}
        if method.startswith("ckpt_"):
            # sharded-checkpoint commit barrier rides the same port
            if self.stale_latched:
                # a deposed primary must not swallow commit reports —
                # "standby" makes _RPCBarrier rotate to the new primary
                return {"standby": True, "epoch": self.epoch}
            out = self.ckpt_barrier.handle(method, kwargs)
            if method == "ckpt_shard_commit":
                self._mutated("ckpt_shard_commit", {
                    "step": kwargs["step"], "rank": kwargs["rank"],
                    "world_size": kwargs["world_size"],
                    "info": kwargs.get("info")})
            return out
        if method == "register":
            return self.register(
                kwargs["tag"], kwargs.get("kind", "trainer"),
                kwargs.get("endpoint"), kwargs.get("payload"),
                kwargs.get("epoch"), coord_inc=kwargs.get("coord_inc"))
        if method == "renew":
            return self.renew(kwargs["tag"], kwargs.get("payload"),
                              kwargs.get("epoch"),
                              coord_inc=kwargs.get("coord_inc"))
        if method == "membership":
            return self.membership()
        if method == "report_failure":
            return self.report_failure(kwargs["tag"],
                                       kwargs.get("reason", ""))
        if method == "fleet_status":
            return self.fleet_status()
        if method == "fleet_metrics":
            return self.fleet_metrics()
        if method == "note_incident":
            return self.note_incident(kwargs.get("incident") or {})
        if method == "numerics_report":
            return self.numerics_report(
                kwargs["tag"], kwargs["step"], kwargs["fingerprint"],
                kwargs.get("world_size", 0))
        if method == "numerics_status":
            return self.numerics_status()
        if method == "sweep":
            return self.sweep(kwargs.get("now"))
        if method == "events":
            return self.drain_events()
        if method == "coord_status":
            return self.coord_status()
        if method == "repl_pull":
            return self.repl_pull(kwargs.get("have_seq", -1),
                                  kwargs.get("have_off", 0))
        if method == "shutdown":
            self.shutdown_event.set()
            return 0
        raise ValueError(f"unknown coordinator method {method!r}")


def serve_coordinator(coord: Coordinator, host: str = "127.0.0.1",
                      port: int = 0):
    """Host `coord` over the ps_server TCP transport (daemon thread).
    Returns (server, "host:port"). The launcher exports the endpoint as
    PADDLE_COORDINATOR_ENDPOINT so members can renew."""
    from .ps_server import _Handler, _TCPServer

    srv = _TCPServer((host, port), _Handler)
    srv.ps = coord  # type: ignore[attr-defined] — _Handler contract
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True,
                     name="paddle-tpu-coordinator").start()
    return srv, f"{host}:{srv.server_address[1]}"


def stop_coordinator(srv) -> None:
    try:
        srv.shutdown()
        srv.close_all_connections()
        srv.server_close()
    except Exception:  # noqa: BLE001 — teardown best-effort
        pass


# ---------------------------------------------------------------------------
# member side
# ---------------------------------------------------------------------------


class CoordinatorClient:
    """Thin member-side client: register once, renew on a cadence. All
    RPCs ride ps_server._Conn (retries, deadline, telemetry), and every
    renewal consults faults.injector() so a `lease_expire:<tag>:<nth>`
    rule can swallow renewals deterministically (the lease-expiry
    drill) without touching the process's real liveness.

    Outage tolerance: `endpoint` may be an ordered
    comma-separated list (primary first, warm standby second). Every
    verb fails over down the list — always on a FRESH socket, because a
    coordinator respawned on the same port shares nothing with the dead
    connection — and a transport failure on `renew` puts the client in
    GRACE MODE: the error still propagates (callers like LeaseWorker /
    HeartBeatWorker swallow it and training continues), the payload is
    buffered, and the first successful contact re-registers
    idempotently before renewing so a recovered or promoted coordinator
    re-learns this member. Split-brain fence: the client tracks the
    highest coordinator incarnation it has seen and REJECTS replies
    from a lower one (a deposed primary)."""

    def __init__(self, endpoint: str, tag: Optional[str] = None,
                 kind: str = "trainer", self_endpoint: Optional[str] = None,
                 deadline: Optional[float] = None):
        self.endpoint = endpoint
        self.endpoints = [e.strip() for e in str(endpoint).split(",")
                          if e.strip()]
        self.tag = tag or member_tag()
        self.kind = kind
        self.self_endpoint = self_endpoint
        self.deadline = (call_deadline_from_env() if deadline is None
                         else float(deadline))
        self.grace = False
        self.last_incarnation = 0
        self.last_epoch = 0
        self._idx = 0
        self._buffered_payload: Optional[dict] = None
        self._conn = self._connect()

    def _connect(self):
        from .ps_server import _Conn

        ep = self.endpoints[self._idx % len(self.endpoints)]
        return _Conn(ep, deadline=self.deadline,
                     io_timeout=self.deadline + 10.0)

    def _rotate(self) -> None:
        """Drop the (possibly dead) socket and move to the next endpoint
        in the ordered list — a respawned or promoted coordinator is
        reached on a fresh connection, never by retrying a dead one to
        exhaustion."""
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001
            pass
        self._idx = (self._idx + 1) % len(self.endpoints)
        self._conn = self._connect()

    def _id_kwargs(self) -> dict:
        # the incarnation view rides identity verbs ONLY once the client
        # has actually seen one (durable mode) — a legacy coordinator
        # never sends it, so the legacy wire format stays byte-identical
        if self.last_incarnation:
            return {"coord_inc": self.last_incarnation}
        return {}

    def call(self, verb: str, **kw):
        """One verb with endpoint failover + incarnation fencing. Raises
        ConnectionError once every endpoint failed (each attempt is
        bounded by the PADDLE_COORD_CALL_DEADLINE_SECS deadline, so a
        coordinator outage can never block a caller to exhaustion)."""
        last: Optional[Exception] = None
        for _ in range(len(self.endpoints)):
            try:
                out = self._conn.call(verb, **kw)
            except ConnectionError as e:
                last = e
                self._rotate()
                continue
            if isinstance(out, dict):
                inc = int(out.get("coord_incarnation") or 0)
                if inc and inc < self.last_incarnation:
                    # deposed primary (a newer incarnation exists):
                    # reject the reply — the split-brain fence
                    _REG.counter(
                        "coordinator_client_stale_replies_total").inc()
                    last = ConnectionError(
                        f"stale coordinator incarnation {inc} < "
                        f"{self.last_incarnation}")
                    self._rotate()
                    continue
                if out.get("standby"):
                    # an unpromoted follower holds no authority yet
                    last = ConnectionError(
                        "coordinator endpoint is an unpromoted standby")
                    self._rotate()
                    continue
                if inc > self.last_incarnation:
                    if self.last_incarnation:
                        # the coordinator restarted or a standby took
                        # over: re-introduce ourselves on the next renew
                        self.grace = True
                        _REG.counter(
                            "coordinator_client_incarnation_bumps_total"
                        ).inc()
                    self.last_incarnation = inc
                try:
                    self.last_epoch = max(self.last_epoch,
                                          int(out.get("epoch") or 0))
                except (TypeError, ValueError):
                    pass
            return out
        raise last if last is not None else ConnectionError(
            "coordinator unreachable")

    def register(self, payload: Optional[dict] = None) -> dict:
        if payload is not None:
            self._buffered_payload = dict(payload)
        out = self.call(
            "register", tag=self.tag, kind=self.kind,
            endpoint=self.self_endpoint, payload=payload,
            epoch=membership_epoch_from_env(), **self._id_kwargs())
        self.grace = False
        return out

    def renew(self, payload: Optional[dict] = None) -> dict:
        from . import faults

        inj = faults.injector()
        if inj is not None and inj.on_lease_renew():
            # swallowed client-side: the coordinator never sees it, the
            # lease runs out — exactly what a silently-dead host does
            _REG.counter("coordinator_client_renewals_suppressed_total").inc()
            return {"suppressed": True}
        if payload is not None:
            self._buffered_payload = dict(payload)
        try:
            if self.grace:
                # grace-mode reconnect: re-register idempotently (with
                # the last buffered payload) so a recovered/promoted
                # coordinator re-learns this member BEFORE the renewal
                self.call(
                    "register", tag=self.tag, kind=self.kind,
                    endpoint=self.self_endpoint,
                    payload=payload if payload is not None
                    else self._buffered_payload,
                    epoch=membership_epoch_from_env(),
                    **self._id_kwargs())
                self.grace = False
                _REG.counter(
                    "coordinator_client_reconnects_total").inc()
            out = self.call(
                "renew", tag=self.tag, payload=payload,
                epoch=membership_epoch_from_env(), **self._id_kwargs())
        except ConnectionError:
            # GRACE MODE: training/serving continue; the renewal is
            # buffered and replayed as a re-register on reconnect. The
            # error still propagates — LeaseWorker/HeartBeatWorker
            # swallow it, and the netsplit drill asserts it raises.
            if not self.grace:
                self.grace = True
                _REG.counter(
                    "coordinator_client_grace_entries_total").inc()
            _REG.counter(
                "coordinator_client_grace_renewals_total").inc()
            raise
        if isinstance(out, dict) and out.get("evicted"):
            # lease-expiry eviction: this member is out of the job —
            # dump the flight record NOW, while the spans that led here
            # are still in the ring (no-op unless tracing is armed)
            from ..telemetry import tracing

            tracing.flight_dump("lease_evicted")
        return out

    def membership(self) -> dict:
        return self.call("membership")

    def numerics_report(self, step: int, fingerprint: dict,
                        world_size: int = 0) -> dict:
        """Publish one SDC fingerprint (the coordinator refuses it
        until telemetry/numerics.py lands, ROADMAP A8)."""
        return self.call(
            "numerics_report", tag=self.tag, step=step,
            fingerprint=fingerprint, world_size=world_size)

    def numerics_status(self) -> dict:
        return self.call("numerics_status")

    def fleet_status(self) -> dict:
        return self.call("fleet_status")

    def fleet_metrics(self) -> str:
        return self.call("fleet_metrics")

    def note_incident(self, incident: dict) -> dict:
        return self.call("note_incident", incident=incident)

    def close(self) -> None:
        self._conn.close()


class LeaseWorker:
    """Daemon renewal thread for processes without a heartbeat worker
    cadence of their own (pservers; lease-only trainers). Registration
    + renewals never raise — a flapping coordinator must not take a
    healthy member down."""

    def __init__(self, client: CoordinatorClient, interval: float,
                 payload_fn: Optional[Callable[[], dict]] = None):
        self.client = client
        self.interval = max(0.05, float(interval))
        self.payload_fn = payload_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _payload(self) -> Optional[dict]:
        out = None
        if self.payload_fn is not None:
            try:
                out = self.payload_fn()
            except Exception:  # noqa: BLE001
                out = None
        return out

    def start(self) -> "LeaseWorker":
        if self._thread is not None:
            return self
        try:
            self.client.register(payload=self._payload())
        except Exception:  # noqa: BLE001 — renewals retry registration
            pass

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.client.renew(payload=self._payload())
                except Exception:  # noqa: BLE001 — keep renewing
                    continue

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"paddle-tpu-lease-{self.client.tag}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.client.close()


def maybe_start_lease_worker(kind: str, tag: Optional[str] = None,
                             self_endpoint: Optional[str] = None,
                             payload_fn: Optional[Callable[[], dict]] = None,
                             ) -> Optional[LeaseWorker]:
    """Start lease renewals when the launcher armed the control plane
    (PADDLE_COORDINATOR_ENDPOINT + PADDLE_LEASE_SECS); no-op (two env
    reads) otherwise. Renewal cadence is lease_secs/3 so a healthy
    member always lands well inside the expiry window."""
    endpoint = os.environ.get(ENV_ENDPOINT)
    lease = lease_secs_from_env()
    if not endpoint or lease <= 0:
        return None
    client = CoordinatorClient(endpoint, tag=tag, kind=kind,
                               self_endpoint=self_endpoint)
    return LeaseWorker(client, interval=lease / 3.0,
                       payload_fn=payload_fn).start()


def query_membership(timeout: float = 2.0) -> Optional[dict]:
    """The coordinator's membership table, or None when no control
    plane is armed / reachable (status pages must never crash)."""
    return _query("membership", timeout)


def query_fleet(timeout: float = 2.0) -> Optional[dict]:
    """The coordinator's fleet rollup (debugz /fleetz), or None when no
    control plane is armed / reachable."""
    return _query("fleet_status", timeout)


def query_fleet_metrics(timeout: float = 2.0) -> Optional[str]:
    """The fleet-wide Prometheus exposition (debugz /fleetz/metrics),
    or None when no control plane is armed / reachable."""
    return _query("fleet_metrics", timeout)


def query_coord_status(timeout: float = 2.0) -> Optional[dict]:
    """The coordinator's control-plane self-description — incarnation,
    role, snapshot age (debugz /statusz row) — or None when no control
    plane is armed / reachable."""
    return _query("coord_status", timeout)


def _query(verb: str, timeout: float):
    endpoint = os.environ.get(ENV_ENDPOINT)
    if not endpoint:
        return None
    try:
        client = CoordinatorClient(endpoint, deadline=timeout)
        try:
            return client.call(verb)
        finally:
            client.close()
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# warm standby follower + launcher-side proxy 
# ---------------------------------------------------------------------------


class CoordinatorFollower:
    """Standby-side replication: poll the primary's `repl_pull` stream
    on the renewal cadence, mirror snapshot+WAL into the local
    Coordinator, and SELF-PROMOTE once the primary's own incarnation
    lease lapses — the same expiry rule members live under
    (expire_periods lease periods with no successful contact)."""

    def __init__(self, coord: Coordinator, primary_endpoint: str,
                 interval: Optional[float] = None):
        self.coord = coord
        self.endpoint = primary_endpoint
        self.interval = (max(0.05, coord.lease_secs / 3.0)
                         if interval is None else max(0.05, interval))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._have = (-1, 0)

    def start(self) -> "CoordinatorFollower":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="paddle-tpu-coord-follower")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        from .ps_server import _Conn

        deadline = call_deadline_from_env()
        lapse = self.coord.lease_secs * self.coord.expire_periods
        last_ok = time.time()
        conn = None
        while not self._stop.wait(self.interval):
            if self.coord.role == "primary":
                return  # promoted (possibly by a test) — stop following
            try:
                if conn is None:
                    conn = _Conn(self.endpoint, deadline=deadline,
                                 io_timeout=deadline + 10.0)
                out = conn.call("repl_pull", have_seq=self._have[0],
                                have_off=self._have[1])
                self.coord.repl_apply(out)
                self._have = (int(out["seq"]), int(out["off"]))
                last_ok = time.time()
                _REG.counter("coordinator_repl_pulls_total").inc()
            except Exception:  # noqa: BLE001 — the primary is flapping
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:  # noqa: BLE001
                        pass
                    conn = None  # fresh socket on the next attempt
                if time.time() - last_ok > lapse:
                    # the primary's incarnation lease lapsed: take over
                    print("[coordinator] primary unreachable for "
                          f"{round(time.time() - last_ok, 1)}s — "
                          "standby promoting itself", file=sys.stderr,
                          flush=True)
                    self.coord.promote()
                    return


class CoordinatorProxy:
    """Launcher-side handle on a PROCESS-hosted coordinator (durable
    mode): the same surface the launcher uses on the in-process object
    (register / report_failure / sweep / note_incident / fleet_* /
    epoch), backed by CoordinatorClient with endpoint failover. Every
    verb degrades gracefully on an outage — training must continue
    while the supervisor respawns the coordinator — and the proxy
    timestamps outage windows so recovery lands one `coord_outage`
    incident in both the fleet ledger and the coordinator's incident
    ring (the goodtop/goodput badput-visibility trail)."""

    def __init__(self, endpoint: str, lease_secs: float,
                 retries_per_rank: int, ledger=None):
        self.lease_secs = float(lease_secs)
        self.retries_per_rank = int(retries_per_rank)
        self.ledger = ledger
        # a short deadline: the watch loop must keep reaping trainers
        # while the control plane is down
        self.client = CoordinatorClient(
            endpoint, tag="launcher", kind="launcher",
            deadline=min(call_deadline_from_env(),
                         max(0.3, self.lease_secs / 2.0)))
        self.unreachable_since: Optional[float] = None
        self._pending_failures: List[Tuple[str, str]] = []
        self._last_sweep = 0.0
        # sweep over RPC rides the renewal cadence, not the launcher's
        # 0.2s watch tick — expiry granularity stays well inside the
        # expire_periods window
        self._sweep_interval = min(2.0, max(0.1, self.lease_secs / 3.0))

    @property
    def epoch(self) -> int:
        return self.client.last_epoch

    def _down(self) -> None:
        if self.unreachable_since is None:
            self.unreachable_since = time.time()
            _REG.counter("coordinator_outages_total").inc()

    def _recovered(self) -> None:
        """First successful verb after an outage: record ONE
        coord_outage incident (ledger + incident ring)."""
        if self.unreachable_since is None:
            return
        now = time.time()
        ev = {"event": "coord_outage",
              "detect_ts": round(self.unreachable_since, 6),
              "respawn_ts": round(now, 6),
              "gap_s": round(now - self.unreachable_since, 3),
              "incarnation": self.client.last_incarnation}
        self.unreachable_since = None
        print(f"[launch] coordinator reachable again after "
              f"{ev['gap_s']}s outage (incarnation "
              f"{ev['incarnation']})", file=sys.stderr, flush=True)
        if self.ledger is not None:
            try:
                self.ledger.event(**ev)
            except Exception:  # noqa: BLE001 — accounting only
                pass
        try:
            self.client.note_incident(dict(ev))
        except ConnectionError:
            self._down()

    def _flush_pending(self) -> None:
        # failure reports observed during an outage: charge the budgets
        # now, in order (raises out to the caller's handler if the
        # coordinator dropped again — the queue survives)
        while self._pending_failures:
            tag, reason = self._pending_failures[0]
            self.client.call("report_failure", tag=tag, reason=reason)
            self._pending_failures.pop(0)

    def register(self, tag: str, kind: str = "trainer",
                 endpoint: Optional[str] = None,
                 payload: Optional[dict] = None) -> dict:
        try:
            out = self.client.call(
                "register", tag=tag, kind=kind, endpoint=endpoint,
                payload=payload, **self.client._id_kwargs())
            self._recovered()
            return out
        except ConnectionError:
            self._down()
            return {"epoch": self.epoch, "evicted": False,
                    "lease_secs": self.lease_secs, "deferred": True}

    def report_failure(self, tag: str, reason: str = "") -> dict:
        try:
            self._flush_pending()
            out = self.client.call("report_failure", tag=tag,
                                   reason=reason)
            self._recovered()
            return out
        except ConnectionError:
            self._down()
            self._pending_failures.append((tag, reason))
            # optimistic verdict: never evict blind — the report is
            # queued and the budget charged on reconnect
            return {"evicted": False, "epoch": self.epoch,
                    "failures": -1,
                    "retries_left": self.retries_per_rank,
                    "deferred": True}

    def sweep(self) -> List[dict]:
        now = time.time()
        if now - self._last_sweep < self._sweep_interval:
            return []
        self._last_sweep = now
        try:
            self._flush_pending()
            out = self.client.call("sweep")
            self._recovered()
        except ConnectionError:
            self._down()
            return []
        if not isinstance(out, list):
            return []
        for ev in out:
            if isinstance(ev, dict) and ev.get("epoch"):
                try:
                    self.client.last_epoch = max(
                        self.client.last_epoch, int(ev["epoch"]))
                except (TypeError, ValueError):
                    pass
        return out

    def note_incident(self, ev: dict) -> dict:
        try:
            out = self.client.note_incident(dict(ev))
            self._recovered()
            return out
        except ConnectionError:
            self._down()
            return {"ok": False, "deferred": True}

    def drain_events(self) -> List[dict]:
        try:
            out = self.client.call("events")
            self._recovered()
            return out if isinstance(out, list) else []
        except ConnectionError:
            self._down()
            return []

    def fleet_status(self) -> dict:
        return self.client.fleet_status()

    def fleet_metrics(self) -> str:
        return self.client.fleet_metrics()

    def coord_status(self) -> Optional[dict]:
        try:
            return self.client.call("coord_status")
        except ConnectionError:
            return None

    def close(self) -> None:
        self.client.close()


# ---------------------------------------------------------------------------
# process entrypoint: the durable / standby coordinator the launcher
# spawns and supervises (python -m paddle_tpu_torch.distributed.coordinator)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.coordinator",
        description="process-hosted durable job coordinator")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--state_dir", default="")
    p.add_argument("--lease_secs", type=float, default=5.0)
    p.add_argument("--retries_per_rank", type=int, default=0)
    p.add_argument("--expire_periods", type=float, default=EXPIRE_PERIODS)
    p.add_argument("--snapshot_secs", type=float, default=None)
    p.add_argument("--startup_grace", type=float, default=None)
    p.add_argument("--standby_of", default="",
                   help="primary endpoint to follow (warm standby mode)")
    args = p.parse_args(argv)
    # fault tag-scoping identity (the coordinator kill drills target
    # PADDLE_PS_FAULT_TAGS=coord); the launcher sets this at spawn, the
    # default covers hand-run coordinators
    os.environ.setdefault(
        "PADDLE_PS_RANK_TAG",
        "coord-standby" if args.standby_of else "coord")
    from .ps_server import _Handler, _TCPServer

    role = "standby" if args.standby_of else "primary"
    coord = Coordinator(lease_secs=args.lease_secs,
                        retries_per_rank=args.retries_per_rank,
                        expire_periods=args.expire_periods,
                        startup_grace=args.startup_grace,
                        state_dir=args.state_dir or None,
                        snapshot_secs=args.snapshot_secs,
                        role=role)
    srv = _TCPServer((args.host, args.port), _Handler)
    srv.ps = coord  # type: ignore[attr-defined] — _Handler contract
    # the launcher reads this first stdout line to learn the bound port
    # (the _spawn_pserver banner protocol)
    print(f"[coordinator] listening on "
          f"{args.host}:{srv.server_address[1]}", flush=True)
    follower = None
    if args.standby_of:
        follower = CoordinatorFollower(coord, args.standby_of).start()

    def _graceful(signum, frame):  # noqa: ARG001
        coord.shutdown_event.set()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:  # non-main thread (tests)
        pass
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True,
                     name="paddle-tpu-coordinator-rpc").start()
    try:
        while not coord.shutdown_event.wait(0.2):
            pass
    finally:
        if follower is not None:
            follower.stop()
        srv.shutdown()
        srv.close_all_connections()
        srv.server_close()
        if coord.state_dir and coord.role == "primary":
            try:
                # clean exit = lossless restart (same discipline as the
                # pserver's final snapshot)
                coord.snapshot(force=True)
            except Exception as e:  # noqa: BLE001
                print(f"[coordinator] final snapshot failed: {e}",
                      file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
