"""Rank / world discovery and the process-group bootstrap.

Ported from the JAX package's ``parallel/env.py``: ``get_rank``,
``get_world_size`` and ``get_endpoints`` read the same launcher
variables (PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS, the reference's
launch.py:193 protocol, then the JAX and torch spellings).

Where the JAX package starts the JAX coordination service once per host
(one controller drives every chip), the port runs one process per rank:
``init_parallel_env`` initialises ``torch.distributed`` in this process.
The backend is NCCL when the rank's device is CUDA and gloo on the CPU,
unless the caller names one; nothing falls back from one to the other.
Each rank's device is explicit: ``cuda:{local_rank % device_count}``
unless the caller asks for the CPU.

The rendezvous is ``init_method`` when given (``file://`` or ``tcp://``),
else PADDLE_DIST_RENDEZVOUS (the port's launcher exports a FileStore
of its own for every attempt, so a relaunched group never meets the
store of the attempt before it, its dead ranks or a port still in
TIME_WAIT), else ``tcp://`` the first endpoint of
PADDLE_TRAINER_ENDPOINTS, else for a lone rank a FileStore in a new
temporary directory, else torch's ``env://`` (MASTER_ADDR /
MASTER_PORT).

As the JAX version does, ``init_parallel_env`` first starts this rank's
liveness reporting for the launcher (``distributed.heartbeat.
start_heartbeat``: heartbeat stamps under PADDLE_HEARTBEAT_DIR, and
coordinator lease renewals where PADDLE_COORDINATOR_ENDPOINT and
PADDLE_LEASE_SECS arm them), then the metrics push exporter
(PADDLE_METRICS_PUSH_URL, ``telemetry/export.py``).  Its other hooks
(trace collection, debugz) are not ported: where their variables are
set, ``init_parallel_env`` raises instead of running without them.
"""
from __future__ import annotations

import datetime
import os

_state = {"initialized": False, "device": None, "liveness": None}

ENV_RENDEZVOUS = "PADDLE_DIST_RENDEZVOUS"

# the launcher hooks the JAX package arms in init_parallel_env, and the
# queue item that brings each (ROADMAP A8)
_UNPORTED_HOOKS = {
    "PADDLE_TRACE_DIR": "per-rank trace collection (ROADMAP A8)",
    "PADDLE_DEBUGZ_PORT": "the debugz server (ROADMAP A8)",
}


def get_rank() -> int:
    for k in ("PADDLE_TRAINER_ID", "JAX_PROCESS_ID", "RANK"):
        if k in os.environ:
            return int(os.environ[k])
    return 0


def get_endpoints() -> list:
    """Launcher-provided trainer endpoints (the one parser of
    PADDLE_TRAINER_ENDPOINTS)."""
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return [e.strip() for e in eps.split(",") if e.strip()] if eps else []


def get_world_size() -> int:
    if "PADDLE_TRAINERS_NUM" in os.environ:
        return int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = get_endpoints()
    if eps:
        return len(eps)
    for k in ("JAX_NUM_PROCESSES", "WORLD_SIZE"):
        if k in os.environ:
            return int(os.environ[k])
    return 1


def get_local_rank() -> int:
    for k in ("PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        if k in os.environ:
            return int(os.environ[k])
    return get_rank()


def choose_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU: no other pairing."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device=None):
    """This rank's device: ``device`` when given, else
    ``cuda:{local_rank % device_count}`` (raising without CUDA)."""
    import torch

    if device is not None:
        return torch.device(device)
    from .. import resolve_device

    resolve_device(None)  # raises without CUDA: no silent CPU
    return torch.device("cuda", get_local_rank() % torch.cuda.device_count())


def init_parallel_env(backend=None, device=None, init_method=None,
                      timeout_s: float = 300.0):
    """Initialise ``torch.distributed`` for this rank (idempotent).
    Returns this rank's device.  ``backend`` None picks NCCL for a CUDA
    device and gloo for the CPU; a named backend is used as it is."""
    import torch
    import torch.distributed as dist

    armed = [v for k, v in _UNPORTED_HOOKS.items() if os.environ.get(k)]
    if armed:
        raise NotImplementedError(
            "init_parallel_env: the environment arms " + ", ".join(armed)
            + ", not ported yet")
    if _state["initialized"] or dist.is_initialized():
        _state["initialized"] = True
        return _state["device"] or rank_device(device)
    if _state["liveness"] is None:
        # heartbeat stamps / lease renewals for the launcher (None when
        # it armed neither)
        from ..distributed.heartbeat import start_heartbeat

        _state["liveness"] = start_heartbeat()
    # the metrics push exporter (a no-op unless PADDLE_METRICS_PUSH_URL
    # is set; resolved once a process)
    from ..telemetry import export

    export.maybe_start()
    dev = rank_device(device)
    backend = backend or choose_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        eps = get_endpoints()
        if os.environ.get(ENV_RENDEZVOUS):
            init_method = os.environ[ENV_RENDEZVOUS]
        elif eps:
            init_method = f"tcp://{eps[0]}"
        elif get_world_size() == 1 and "MASTER_ADDR" not in os.environ:
            # one rank with no rendezvous: a FileStore of its own
            import tempfile

            store = os.path.join(tempfile.mkdtemp(prefix="pg-"), "store")
            init_method = f"file://{store}"
        else:
            init_method = "env://"
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=get_rank(),
        world_size=get_world_size(),
        timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(initialized=True, device=dev)
    return dev
