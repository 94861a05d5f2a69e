"""Live weight sync: the deterministic packing of a parameter set into
the rows of a PS weight table, and the arming gate of the subscriber.

Ported from the JAX package's ``inference/weight_sync.py``.  A trainer
(or a publisher sidecar) packs the model's parameters into rows of an
ordinary PS table; each serving replica subscribes and hands every
fresh set to ``on_adopt(weights, version)`` — the serving scheduler
(``server.MicroBatcher.stage_weights``) installs it between micro-batches
and bumps the weight epoch.

  PackPlan / pack / unpack — the [total_rows, dim] float32 layout
                (sorted names, row offsets derived only from shapes, so
                trainer and replicas agree without a manifest exchange).

Not ported yet: ``WeightPublisher`` and ``WeightSubscriber`` need the
parameter server's tables and ``RemoteTable`` (the PS half of ROADMAP A6).  So where
PADDLE_SERVE_WEIGHT_TABLE and endpoints are both set,
``maybe_start_subscriber`` raises instead of serving static weights the
caller asked to keep fresh.

Gate: PADDLE_SERVE_WEIGHT_SYNC=0 disables the subscriber entirely.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fluid.dtypes import dtype_name

ENV_SYNC = "PADDLE_SERVE_WEIGHT_SYNC"
ENV_TABLE = "PADDLE_SERVE_WEIGHT_TABLE"
ENV_ENDPOINTS = "PADDLE_SERVE_WEIGHT_ENDPOINTS"

DEFAULT_DIM = 64


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


def table_shape(plan: PackPlan) -> tuple:
    return (plan.total_rows, plan.dim)


# ---------------------------------------------------------------------------
# subscriber arming (replica side)
# ---------------------------------------------------------------------------


def sync_enabled() -> bool:
    return os.environ.get(ENV_SYNC, "1") not in ("0", "false", "off")


def maybe_start_subscriber(frozen, on_adopt):
    """Env-driven arming: PADDLE_SERVE_WEIGHT_TABLE plus endpoints
    (PADDLE_SERVE_WEIGHT_ENDPOINTS, falling back to the PS list), unless
    PADDLE_SERVE_WEIGHT_SYNC is 0.  Returns None when not armed; raises
    when armed, since the subscriber waits for the parameter server's
    port (the PS half of ROADMAP A6)."""
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
    raise NotImplementedError(
        f"live weight sync from table {name!r} at {endpoints} needs the "
        f"WeightSubscriber, which waits for the parameter server's port "
        f"(the PS half of ROADMAP A6); unset {ENV_TABLE} or set {ENV_SYNC}=0 to serve "
        f"the loaded weights")
