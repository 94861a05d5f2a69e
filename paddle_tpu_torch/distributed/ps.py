"""Parameter-server embedding: host-resident sharded tables, ported
from the JAX package's ``distributed/ps.py``.  The module is numpy only,
and a table's state after the same gathers and pushes is the JAX
package's bit for bit (same seed, same shard layout, same float32
updates), so a ``state_dict`` one package pickles loads in the other.

Parity surface: reference operators/distributed/large_scale_kv.h,
distributed_lookup_table op (operators/distributed_ops/), the pserver
optimizer blocks run by listen_and_serv (distribute_transpiler.py:545),
and the Downpour-style async update flow (distributed/communicator.h).

The table is an embedding larger than the card: it lives in HOST
memory, row-sharded across `num_shards` shard stores, and never on the
device.  Single-process runs keep the shards in-process; under the
launcher's PS mode (PADDLE_PSERVERS_IP_PORT_LIST) the same table lives
in a dedicated pserver PROCESS and create_table hands back a
ps_server.RemoteTable client with the identical gather/push surface, so
N trainer processes share one table over TCP (ps_server.py).  The
device step meets it in one op (ops/ps_ops.py,
``distributed_lookup_table``):

  gather  — forward: the ids are copied to the host, the looked-up rows
            gathered there and copied to the ids' device ([batch, dim],
            never the full table)
  update  — backward: the rows' gradient is copied to the host and
            pushed; the SERVER applies the optimizer (sgd or adagrad per
            row, like the reference's pserver optimizer blocks),
            deduplicating repeated ids within a batch

Each step's gather waits for the previous step's push to return, so an
in-process table or a sync-mode server behaves like sync PS; async
servers apply pushes on arrival (Downpour).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

_tables: Dict[str, "ShardedHostTable"] = {}
_lock = threading.Lock()


class ShardedHostTable:
    """Row-sharded host KV: shard s owns rows with row % num_shards == s
    (the reference's round-robin block placement, ps_dispatcher.py)."""

    def __init__(
        self,
        name: str,
        shape,
        dtype: str = "float32",
        num_shards: int = 4,
        optimizer: str = "sgd",
        learning_rate: float = 0.1,
        initializer_std: Optional[float] = None,
        seed: int = 0,
    ):
        self.name = name
        self.rows, self.dim = int(shape[0]), int(shape[1])
        self.dtype = np.dtype(dtype)
        self.num_shards = int(num_shards)
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"unsupported server optimizer {optimizer!r}")
        # server-traffic accounting (tests + ops dashboards): every push
        # RPC-equivalent bumps these, so sync-mode vs geo-mode traffic is
        # directly comparable
        self.push_calls = 0
        self.pushed_bytes = 0
        rng = np.random.RandomState(seed)
        std = initializer_std if initializer_std is not None else 1.0 / np.sqrt(self.dim)
        self._shards: List[np.ndarray] = []
        self._accum: List[Optional[np.ndarray]] = []
        self._locks = [threading.Lock() for _ in range(self.num_shards)]
        # dirty-row tracking (incremental snapshots): per-shard LOCAL row
        # indices touched by push_* since the last drain_dirty(). Always
        # on — a set-update per push is noise next to the scatter itself,
        # and the snapshotter decides whether to use it
        self._dirty: List[set] = [set() for _ in range(self.num_shards)]
        for s in range(self.num_shards):
            n = (self.rows - s + self.num_shards - 1) // self.num_shards
            self._shards.append(rng.normal(0.0, std, (n, self.dim)).astype(self.dtype))
            self._accum.append(
                np.zeros((n, self.dim), np.float32) if optimizer == "adagrad" else None
            )

    # -- addressing ------------------------------------------------------
    def _locate(self, ids: np.ndarray):
        if ids.size and (ids.min() < 0 or ids.max() >= self.rows):
            bad = ids[(ids < 0) | (ids >= self.rows)][0]
            raise IndexError(
                f"table {self.name!r}: id {int(bad)} out of range "
                f"[0, {self.rows}) — pad ids must be remapped before lookup"
            )
        return ids % self.num_shards, ids // self.num_shards

    # -- serving ---------------------------------------------------------
    def gather(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        shard, local = self._locate(ids)
        out = np.empty((ids.shape[0], self.dim), self.dtype)
        for s in range(self.num_shards):
            m = shard == s
            if m.any():
                with self._locks[s]:
                    out[m] = self._shards[s][local[m]]
        return out

    def push_delta(self, ids, deltas) -> None:
        """Geo-SGD server half (reference GeoCommunicator,
        operators/distributed/communicator.h:396): trainers push
        accumulated parameter DELTAS every K steps; the server just adds
        them (no server-side optimizer — the trainer already applied
        its own). Repeated ids accumulate."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        deltas = np.asarray(deltas, np.float32).reshape(ids.shape[0], self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(acc, inv, deltas)
        shard, local = self._locate(uniq)
        self.push_calls += 1
        self.pushed_bytes += int(deltas.nbytes + ids.nbytes)
        for s in range(self.num_shards):
            m = shard == s
            if not m.any():
                continue
            with self._locks[s]:
                self._shards[s][local[m]] = (
                    self._shards[s][local[m]].astype(np.float32) + acc[m]
                ).astype(self.dtype)
                self._dirty[s].update(local[m].tolist())

    def push_gradients(self, ids, grads) -> None:
        """Apply the server-side optimizer for the touched rows. Repeated
        ids in one batch are accumulated first (SelectedRows merge-add
        semantics) so the update matches a dense scatter-add gradient."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        grads = np.asarray(grads, np.float32).reshape(ids.shape[0], self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(acc, inv, grads)
        shard, local = self._locate(uniq)
        # count only validated pushes (push_delta counts after _locate too)
        self.push_calls += 1
        self.pushed_bytes += int(grads.nbytes + ids.nbytes)
        lr = self.learning_rate
        for s in range(self.num_shards):
            m = shard == s
            if not m.any():
                continue
            rows = local[m]
            g = acc[m]
            with self._locks[s]:
                if self.optimizer == "adagrad":
                    self._accum[s][rows] += g * g
                    g = g / (np.sqrt(self._accum[s][rows]) + 1e-6)
                self._shards[s][rows] = (
                    self._shards[s][rows].astype(np.float32) - lr * g
                ).astype(self.dtype)
                self._dirty[s].update(rows.tolist())

    # -- introspection / checkpoint --------------------------------------
    def nbytes(self) -> int:
        return sum(sh.nbytes for sh in self._shards)

    def memory_stats(self) -> dict:
        """Resident-memory accounting: the capacity-planning row behind
        `stats` and `fleet.ps_stats()`. rows x row-width for the
        value shards, plus the adagrad accumulator when present; the
        dirty-row set is the incremental-snapshot overhead."""
        shard_bytes = int(sum(sh.nbytes for sh in self._shards))
        accum_bytes = int(sum(a.nbytes for a in self._accum
                              if a is not None))
        # CPython set-of-int overhead is roughly 32B/entry + the ints;
        # an estimate is all capacity planning needs
        dirty = sum(len(d) for d in self._dirty)
        return {
            "rows": self.rows,
            "dim": self.dim,
            "dtype": str(self.dtype),
            "num_shards": self.num_shards,
            "shard_bytes": shard_bytes,
            "accum_bytes": accum_bytes,
            "dirty_rows": dirty,
            "dirty_overhead_bytes": dirty * 64,
            "resident_bytes": shard_bytes + accum_bytes + dirty * 64,
        }

    def to_dense(self) -> np.ndarray:
        """Materialize the full table (tests/checkpoints only — defeats
        the purpose in a real run)."""
        out = np.empty((self.rows, self.dim), self.dtype)
        for s in range(self.num_shards):
            out[s::self.num_shards] = self._shards[s]
        return out

    def state_dict(self):
        # deep copies: a checkpoint must be a snapshot, not an alias of
        # the live shards (np.asarray with a matching dtype is a no-op).
        # Copies happen UNDER the shard locks: the pserver's periodic
        # snapshotter (ps_server.PSServer.snapshot) runs concurrently
        # with pushes, and an unlocked copy could capture a half-updated
        # row (torn between the optimizer's read and write)
        shards, accum = [], []
        for s in range(self.num_shards):
            with self._locks[s]:
                shards.append(self._shards[s].copy())
                accum.append(
                    None if self._accum[s] is None else self._accum[s].copy())
        return {
            "shards": shards,
            "accum": accum,
            "optimizer": self.optimizer,
            "learning_rate": self.learning_rate,
        }

    def load_state_dict(self, state):
        self._shards = [np.array(s, self.dtype) for s in state["shards"]]
        self._accum = [
            None if a is None else np.array(a, np.float32) for a in state["accum"]
        ]
        self.optimizer = state.get("optimizer", self.optimizer)
        self.learning_rate = float(state.get("learning_rate", self.learning_rate))
        # the loaded state IS the new baseline: nothing is dirty vs it
        self._dirty = [set() for _ in range(self.num_shards)]

    # -- incremental snapshots (dirty-row deltas) -------------------------
    def dirty_rows(self) -> int:
        """Rows touched since the last drain (across shards, local idx)."""
        return sum(len(d) for d in self._dirty)

    def drain_dirty(self) -> dict:
        """Capture-and-clear the dirty rows as a VALUE delta: per shard,
        the touched local row indices with their current values (+ the
        adagrad accumulator rows when present). Copies happen under the
        shard locks, like state_dict, so no torn row is ever captured.
        Value deltas are idempotent — replaying one on top of a newer
        base is last-write-wins, which makes the base/delta race in the
        snapshotter safe by construction."""
        out = {"shards": {}, "rows": 0}
        for s in range(self.num_shards):
            with self._locks[s]:
                if not self._dirty[s]:
                    continue
                rows = np.fromiter(sorted(self._dirty[s]), np.int64,
                                   len(self._dirty[s]))
                out["shards"][s] = {
                    "rows": rows,
                    "values": self._shards[s][rows].copy(),
                    "accum": (None if self._accum[s] is None
                              else self._accum[s][rows].copy()),
                }
                out["rows"] += int(rows.shape[0])
                self._dirty[s].clear()
        return out

    def apply_dirty_delta(self, delta: dict) -> int:
        """Scatter a drain_dirty() delta back into the shards (restore
        path: base snapshot + delta chain). Does NOT re-dirty the rows —
        a restored state is the new clean baseline."""
        n = 0
        for s, ent in delta.get("shards", {}).items():
            s = int(s)
            rows = np.asarray(ent["rows"], np.int64)
            with self._locks[s]:
                self._shards[s][rows] = np.asarray(
                    ent["values"], self.dtype)
                if ent.get("accum") is not None and self._accum[s] is not None:
                    self._accum[s][rows] = np.asarray(
                        ent["accum"], np.float32)
            n += int(rows.shape[0])
        return n


class GeoSGDClient:
    """Geo-SGD trainer half (reference geo_sgd_transpiler.py + the
    GeoCommunicator send thread): the trainer optimizes a LOCAL copy of
    the touched rows every step and pushes accumulated parameter deltas
    (cur - at_last_sync, scaled 1/num_trainers) to the server every
    `sync_steps` steps — K× less server traffic than per-step gradient
    push, at the cost of staleness bounded by K.

    API-compatible with ShardedHostTable for the lookup op (gather /
    push_gradients), so `mode="geo"` is transparent to programs. Rows
    are cached lazily: only touched rows live trainer-side."""

    def __init__(self, server: ShardedHostTable, sync_steps: int = 100,
                 num_trainers: int = 1):
        self.server = server
        self.name = server.name
        self.dim = server.dim
        self.rows = server.rows
        self.dtype = server.dtype
        self.sync_steps = int(sync_steps)
        self.num_trainers = int(num_trainers)
        self._local: Dict[int, np.ndarray] = {}
        self._old: Dict[int, np.ndarray] = {}
        self._touched: set = set()
        self._step = 0
        self._lock = threading.Lock()

    def _ensure_rows(self, uniq):
        missing = [r for r in uniq if r not in self._local]
        if missing:
            pulled = self.server.gather(np.asarray(missing, np.int64))
            for r, row in zip(missing, pulled):
                self._local[r] = row.astype(np.float32).copy()
                self._old[r] = row.astype(np.float32).copy()

    def gather(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        with self._lock:
            self._ensure_rows(np.unique(ids).tolist())
            return np.stack([self._local[int(r)] for r in ids]).astype(
                self.dtype)

    def push_gradients(self, ids, grads) -> None:
        """LOCAL optimizer step on the touched rows; every sync_steps
        pushes, the accumulated deltas go to the server."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        grads = np.asarray(grads, np.float32).reshape(ids.shape[0], self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros((uniq.shape[0], self.dim), np.float32)
        np.add.at(acc, inv, grads)
        lr = self.server.learning_rate
        with self._lock:
            self._ensure_rows(uniq.tolist())
            for r, g in zip(uniq.tolist(), acc):
                self._local[r] = self._local[r] - lr * g
                self._touched.add(r)
            self._step += 1
            if self._step % self.sync_steps == 0:
                self._sync_locked()

    def _sync_locked(self):
        if not self._touched:
            return
        rows = np.asarray(sorted(self._touched), np.int64)
        delta = np.stack([
            (self._local[int(r)] - self._old[int(r)]) / self.num_trainers
            for r in rows
        ])
        self.server.push_delta(rows, delta)
        fresh = self.server.gather(rows)
        for r, row in zip(rows.tolist(), fresh):
            self._local[r] = row.astype(np.float32).copy()
            self._old[r] = self._local[r].copy()
        self._touched.clear()

    def flush(self) -> None:
        """Push any pending deltas now (checkpoint / shutdown barrier)."""
        with self._lock:
            self._sync_locked()

    # -- delegation so geo tables checkpoint like plain ones --------------
    def nbytes(self) -> int:
        return self.server.nbytes()

    def to_dense(self) -> np.ndarray:
        self.flush()
        return self.server.to_dense()

    def state_dict(self):
        self.flush()
        return self.server.state_dict()

    def load_state_dict(self, state):
        with self._lock:
            self._local.clear()
            self._old.clear()
            self._touched.clear()
        self.server.load_state_dict(state)


def create_table(name, shape, mode: str = "sync", geo_sync_steps: int = 100,
                 num_trainers: Optional[int] = None, endpoints=None,
                 replication: Optional[int] = None, **kw):
    """mode: "sync" — per-step gradient push with a server-side barrier
    across trainers (reference DistributeTranspiler sync_mode); "async"
    — per-step push applied on arrival (Downpour); "geo" — local
    optimizer + K-step delta push (Geo-SGD, geo_sgd_transpiler.py).

    When `endpoints` is given, or the launcher exports
    PADDLE_PSERVERS_IP_PORT_LIST (launch.py --server_num), the table is
    HOSTED: this process gets a RemoteTable client and the rows live in
    the pserver process(es), shared by every trainer (ps_server.py).
    Without either, the table is in-process (single trainer / tests).
    In-process "sync" and "async" behave identically (there is no peer
    to barrier with).

    replication (default PADDLE_PS_REPLICATION, else 1): hosted tables
    only — each row partition gets a primary pserver plus R-1 backup
    replicas on distinct pservers (ps_server.RemoteTable docs: fast
    failover, hedged pulls). 1 = today's unreplicated behavior;
    in-process tables ignore it (there is no second process to hold a
    replica)."""
    import os as _os

    from . import ps_server as _net

    if num_trainers is None:
        num_trainers = int(_os.environ.get("PADDLE_TRAINERS_NUM", 1))
    if replication is None:
        replication = int(_os.environ.get("PADDLE_PS_REPLICATION", 1) or 1)
    with _lock:
        if name in _tables:
            raise ValueError(f"table {name!r} already exists")
        if endpoints is None and _net.training_role() == "TRAINER":
            endpoints = _net.pserver_endpoints()
        if endpoints:
            if mode not in ("sync", "async", "geo"):
                raise ValueError(f"unknown PS mode {mode!r}")
            t = _net.RemoteTable(
                name, shape, endpoints,
                sync_trainers=num_trainers if mode == "sync" else 0,
                trainer_id=int(_os.environ.get("PADDLE_TRAINER_ID", 0)),
                replication=replication,
                **kw)
        else:
            t = ShardedHostTable(name, shape, **kw)
        if mode == "geo":
            if t.optimizer != "sgd":
                raise ValueError(
                    "geo mode applies SGD trainer-side (reference "
                    "geo_sgd_transpiler.py restriction); use optimizer='sgd'")
            t = GeoSGDClient(t, sync_steps=geo_sync_steps,
                             num_trainers=num_trainers)
        _tables[name] = t
        return t


def get_table(name) -> ShardedHostTable:
    t = _tables.get(name)
    if t is None:
        raise KeyError(
            f"host embedding table {name!r} not registered; call "
            f"distributed.ps.create_table first"
        )
    return t


def drop_table(name) -> None:
    with _lock:
        _tables.pop(name, None)
