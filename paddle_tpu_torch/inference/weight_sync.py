"""Live weight sync: serving replicas subscribe to a PS-hosted weight
table and adopt fresh parameters under an epoch fence.

Ported from the JAX package's ``inference/weight_sync.py``.  A trainer
(or a publisher sidecar) packs the model's parameters into rows of an
ordinary PS table — the same replicated, snapshotted, failover-capable
tables of ``distributed/ps_server.py``, whose bytes on the wire are the
JAX package's — and each serving replica subscribes:

  publisher   — ``pack()`` flattens every parameter into a deterministic
                [total_rows, dim] float32 layout (PackPlan: sorted
                names, row offsets derived only from shapes, so trainer
                and replicas agree without a manifest exchange) and
                pushes it with ``load_state_dict`` — a REPLACE, so
                adoption is value-exact, and a replicated op the
                primary forwards and logs like any other write.
  subscriber  — a replica polls the table: on a REPLICATED partition it
                calls ``fetch_replica_state(have_seq=...)`` exactly like
                a rejoining backup (full state first, then applied-op
                tails); on a plain table it falls back to
                ``state_dict`` + a sha256 digest compare.  Every observed
                change is handed to ``on_adopt(weights, version)`` — the
                serving scheduler (``server.MicroBatcher.stage_weights``)
                installs it between micro-batches and bumps the weight
                epoch.

Gate: PADDLE_SERVE_WEIGHT_SYNC=0 disables the subscriber entirely —
serving is then byte-identical to a static frozen model.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import sys
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.ps import ShardedHostTable
from ..fluid.dtypes import dtype_name
from ..telemetry import get_registry

_REG = get_registry()

ENV_SYNC = "PADDLE_SERVE_WEIGHT_SYNC"
ENV_TABLE = "PADDLE_SERVE_WEIGHT_TABLE"
ENV_ENDPOINTS = "PADDLE_SERVE_WEIGHT_ENDPOINTS"
ENV_POLL = "PADDLE_SERVE_WEIGHT_POLL_SECS"

DEFAULT_DIM = 64
DEFAULT_NUM_SHARDS = 4


# ---------------------------------------------------------------------------
# deterministic packing
# ---------------------------------------------------------------------------


@dataclass
class PackPlan:
    """Row layout of a parameter set inside a [total_rows, dim] table.
    Derived ONLY from sorted (name, shape, dtype) — the trainer and
    every replica compute the identical plan from the same frozen
    model, no manifest wire exchange needed."""

    dim: int
    entries: List[Tuple[str, tuple, str, int, int]]  # name, shape, dtype, row_offset, n_rows
    total_rows: int

    def names(self) -> List[str]:
        return [e[0] for e in self.entries]


def pack_plan(shapes: Dict[str, tuple], dtypes: Optional[Dict[str, str]]
              = None, dim: int = DEFAULT_DIM) -> PackPlan:
    entries = []
    offset = 0
    for name in sorted(shapes):
        shape = tuple(int(d) for d in shapes[name])
        size = int(np.prod(shape)) if shape else 1
        n_rows = max(1, -(-size // dim))
        dtype = str((dtypes or {}).get(name, "float32"))
        entries.append((name, shape, dtype, offset, n_rows))
        offset += n_rows
    return PackPlan(dim=int(dim), entries=entries, total_rows=offset)


def _dtype_of(v) -> str:
    if isinstance(v, torch.Tensor):
        return dtype_name(v.dtype)
    return str(np.asarray(v).dtype)


def plan_for_frozen(frozen, dim: int = DEFAULT_DIM) -> PackPlan:
    """PackPlan over a FrozenModel's captured weights."""
    shapes, dtypes = {}, {}
    for n in frozen.param_names:
        v = frozen.scope.find_var(n)
        shapes[n] = tuple(v.shape)
        dtypes[n] = _dtype_of(v)
    return pack_plan(shapes, dtypes, dim=dim)


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def pack(plan: PackPlan, values: Dict[str, np.ndarray]) -> np.ndarray:
    out = np.zeros((plan.total_rows, plan.dim), np.float32)
    for name, shape, _dtype, offset, n_rows in plan.entries:
        v = values.get(name)
        if v is None:
            raise KeyError(f"pack: missing value for {name!r}")
        flat = _f32(v).reshape(-1)
        out[offset:offset + n_rows].reshape(-1)[:flat.size] = flat
    return out


def unpack(plan: PackPlan, rows: np.ndarray) -> Dict[str, np.ndarray]:
    """The parameter set of ``rows``: numpy arrays of each entry's dtype
    (a bf16 entry stays float32 — numpy has no bf16 — and the predictor
    casts it on adoption)."""
    out = {}
    for name, shape, dtype, offset, n_rows in plan.entries:
        size = int(np.prod(shape)) if shape else 1
        flat = np.asarray(rows[offset:offset + n_rows],
                          np.float32).reshape(-1)[:size]
        arr = flat.reshape(shape)
        out[name] = arr if dtype == "bfloat16" else arr.astype(np.dtype(dtype))
    return out


# ---------------------------------------------------------------------------
# publisher (trainer side)
# ---------------------------------------------------------------------------


def table_shape(plan: PackPlan) -> tuple:
    return (plan.total_rows, plan.dim)


def table_kwargs(plan: PackPlan) -> dict:
    """The weight table's creation kwargs (pair with table_shape).
    SGD/lr are inert — the publisher only ever replaces state — but the
    spec is table identity on the server, so every party must build the
    same one: ``RemoteTable(name, table_shape(p), eps, **table_kwargs(p))``."""
    return {"dtype": "float32", "num_shards": DEFAULT_NUM_SHARDS,
            "optimizer": "sgd", "learning_rate": 0.0, "seed": 0}


def _server_states(packed: np.ndarray, n_servers: int,
                   num_shards: int = DEFAULT_NUM_SHARDS) -> List[dict]:
    """Split packed rows into per-server ShardedHostTable state_dicts
    matching RemoteTable's row placement (global row r -> server r % n,
    local r // n; within a server, shard s holds local % num_shards ==
    s at local // num_shards)."""
    states = []
    for s in range(n_servers):
        rows_s = packed[s::n_servers]
        shards = [np.ascontiguousarray(rows_s[k::num_shards])
                  for k in range(num_shards)]
        states.append({"shards": shards, "accum": [None] * num_shards,
                       "optimizer": "sgd", "learning_rate": 0.0})
    return states


class WeightPublisher:
    """Push a scope's parameters into the weight table.  ``table`` is any
    ShardedHostTable duck type (in-process table or RemoteTable)."""

    def __init__(self, table, plan: PackPlan):
        self.table = table
        self.plan = plan
        self.pushes = 0

    def publish(self, scope_or_values) -> int:
        values = scope_or_values
        if hasattr(scope_or_values, "find_var"):
            values = {n: scope_or_values.find_var(n)
                      for n in self.plan.names()}
        packed = pack(self.plan, values)
        n = getattr(self.table, "_n", None)
        if n is None:  # in-process ShardedHostTable
            k = self.table.num_shards
            self.table.load_state_dict(_server_states(packed, 1, k)[0])
        else:
            k = self.table._specs[0]["num_shards"]
            self.table.load_state_dict(
                {"servers": _server_states(packed, n, k)})
        self.pushes += 1
        _REG.counter("serve_weight_pushes_total").inc()
        return self.pushes


# ---------------------------------------------------------------------------
# subscriber (replica side)
# ---------------------------------------------------------------------------


class WeightSubscriber:
    """Poll the weight table and deliver fresh parameter sets.

    Replicated partitions are followed like a rejoining backup follows
    its primary: ``fetch_replica_state(have_seq)`` hands back either the
    applied-op tail since have_seq (cheap steady state) or a full state
    transfer (first contact / ring overrun), applied to a local mirror
    table with the server's own arithmetic — the mirror is bit-identical
    to the primary's copy by construction.  Plain tables fall back to
    polled ``state_dict`` + sha256 digest compare.

    on_adopt(weights, version) runs on the poll thread; the consumer
    (server.py) stages the delivery and installs it under its own epoch
    fence.
    """

    def __init__(self, endpoints: Sequence[str], name: str, plan: PackPlan,
                 on_adopt: Callable[[Dict[str, np.ndarray], int], None],
                 poll_secs: float = 2.0, create: bool = False):
        from ..distributed.ps_server import _Conn

        self.endpoints = list(endpoints)
        self.name = name
        self.plan = plan
        self.on_adopt = on_adopt
        self.poll_secs = float(poll_secs)
        self._n = len(self.endpoints)
        self._conns = [_Conn(ep, deadline=5.0, io_timeout=15.0)
                       for ep in self.endpoints]
        self._create = bool(create)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.version = 0
        self._seq: Dict[int, int] = {}       # partition -> last seq
        self._mirrors: Dict[int, ShardedHostTable] = {}
        self._digest: Optional[str] = None   # plain-table mode
        self._replicated: Optional[bool] = None
        # set once the poll thread's first round has ended, adopted or
        # not (serve() binds its port only then)
        self.first_round = threading.Event()

    # -- partition plumbing ----------------------------------------------
    def _part_rows(self, p: int) -> int:
        return (self.plan.total_rows - p + self._n - 1) // self._n

    def _mirror(self, p: int) -> ShardedHostTable:
        m = self._mirrors.get(p)
        if m is None:
            kw = table_kwargs(self.plan)
            kw.pop("dtype", None)
            m = ShardedHostTable(self.name,
                                 (self._part_rows(p), self.plan.dim),
                                 **kw)
            self._mirrors[p] = m
        return m

    def _probe_replicated(self) -> Optional[bool]:
        """True: follow replicated partitions; False: plain polling;
        None: the table does not exist YET — decide on a later poll
        (latching a mode before the publisher created the table would
        pin the subscriber to the wrong key shape forever)."""
        # the replicated key first; missing replica state on an
        # existing table reports role None, a missing table raises
        try:
            st = self._conns[0].call("replica_status", name=self.name,
                                     partition=0)
            return st.get("role") is not None
        except Exception:  # noqa: BLE001 — fall back to the plain key
            try:
                st = self._conns[0].call("replica_status", name=self.name)
                return st.get("role") is not None
            except Exception:  # noqa: BLE001
                return None

    def _fetch_partition(self, p: int) -> bool:
        """Pull partition p up to date; True when new writes landed."""
        from ..distributed.ps_server import NotPrimaryError, \
            StalePrimaryError, _table_key

        key = _table_key(self.name, p)
        mirror = self._mirror(p)
        have = self._seq.get(p, -1)
        last_err: Optional[BaseException] = None
        # primary discovery: partition p's chain starts at server p
        for off in range(self._n):
            j = (p + off) % self._n
            try:
                out = self._conns[j].call("fetch_replica_state", key=key,
                                          have_seq=have)
            except (NotPrimaryError, StalePrimaryError, ConnectionError,
                    KeyError) as e:
                last_err = e
                continue
            if "state" in out:
                state = dict(out["state"])
                state.pop("replica_meta", None)
                mirror.load_state_dict(state)
            else:
                for _seq, op, ids, payload, _dedup in out["tail"]:
                    if op == "push_gradients":
                        mirror.push_gradients(ids, payload)
                    elif op == "push_delta":
                        mirror.push_delta(ids, payload)
                    elif op == "load_state":
                        mirror.load_state_dict(dict(payload))
                    else:
                        raise ValueError(
                            f"weight sync: unknown replicated op {op!r}")
            new_seq = int(out["seq"])
            changed = new_seq != have
            self._seq[p] = new_seq
            return changed
        raise ConnectionError(
            f"weight table {self.name!r} partition {p}: no replica "
            f"answered fetch_replica_state: {last_err}")

    def _poll_plain(self) -> bool:
        """Unreplicated fallback: full state_dict per server + digest."""
        states = [self._conns[s].call("state_dict", name=self.name)
                  for s in range(self._n)]
        blob = pickle.dumps(states, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hashlib.sha256(blob).hexdigest()
        if digest == self._digest:
            return False
        self._digest = digest
        for s, st in enumerate(states):
            st = dict(st)
            st.pop("replica_meta", None)
            self._mirror(s).load_state_dict(st)
        return True

    # -- the poll --------------------------------------------------------
    def poll_once(self) -> bool:
        """One subscription round; True when fresh weights were adopted
        (on_adopt ran).  Deterministic — tests drive it directly."""
        if self._replicated is None:
            self._replicated = self._probe_replicated()
            if self._replicated is None:
                return False  # table not created yet; retry next poll
        if self._replicated:
            changed = False
            for p in range(self._n):
                changed |= self._fetch_partition(p)
        else:
            changed = self._poll_plain()
        if not changed:
            return False
        packed = np.empty((self.plan.total_rows, self.plan.dim),
                          np.float32)
        for p in range(self._n):
            packed[p::self._n] = self._mirrors[p].to_dense()
        self.version += 1
        _REG.counter("serve_weight_adoptions_total").inc()
        self.on_adopt(unpack(self.plan, packed), self.version)
        return True

    # -- thread lifecycle ------------------------------------------------
    def start(self) -> "WeightSubscriber":
        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — serving survives
                    _REG.counter("serve_weight_poll_errors_total").inc()
                    print(f"[weight_sync] poll failed: {e}",
                          file=sys.stderr, flush=True)
                finally:
                    self.first_round.set()
                self._stop.wait(self.poll_secs)
            self.first_round.set()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-weight-sync")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for c in self._conns:
            c.close()


def sync_enabled() -> bool:
    return os.environ.get(ENV_SYNC, "1") not in ("0", "false", "off")


def maybe_start_subscriber(frozen, on_adopt) -> Optional[WeightSubscriber]:
    """Env-driven arming: needs PADDLE_SERVE_WEIGHT_TABLE plus endpoints
    (PADDLE_SERVE_WEIGHT_ENDPOINTS, falling back to the PS list), and
    PADDLE_SERVE_WEIGHT_SYNC must not be 0.  Returns the started
    subscriber or None."""
    if not sync_enabled():
        return None
    name = os.environ.get(ENV_TABLE)
    if not name:
        return None
    raw = os.environ.get(ENV_ENDPOINTS) or os.environ.get(
        "PADDLE_PSERVERS_IP_PORT_LIST", "")
    endpoints = [e.strip() for e in raw.split(",") if e.strip()]
    if not endpoints:
        return None
    poll = float(os.environ.get(ENV_POLL, 2.0) or 2.0)
    plan = plan_for_frozen(frozen)
    return WeightSubscriber(endpoints, name, plan, on_adopt,
                            poll_secs=poll).start()
