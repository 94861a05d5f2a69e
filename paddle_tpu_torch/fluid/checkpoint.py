"""Preemption-safe checkpointing: atomic, manifest-verified, resumable,
asynchronous and sharded.

Ported from the JAX package's ``fluid/checkpoint.py``: step-numbered checkpoint directories committed atomically, verified by
checksum on load, with automatic fallback to the newest *valid*
checkpoint when the latest was torn by a crash.  The two packages write
and read the same files: a checkpoint either one writes restores in the
other.

Commit protocol (CheckpointManager.save):

  1. all content files (scope persistables, RNG state, extra state) are
     written into `<root>/.tmp-ckpt-<step>-<pid>` (each fsynced, then the
     directory — power-loss durability; PADDLE_CKPT_FSYNC=0 opts out)
  2. the tmp dir is renamed to `<root>/ckpt-<step>` — visible but NOT
     yet a checkpoint: a directory without a manifest is torn by
     definition and every reader skips it
  3. `manifest.json` (step + sha256/size of every content file) is
     written via tmp + `os.replace` INTO the step dir — THE commit
     point. A kill anywhere before 3 leaves the previous checkpoint as
     the newest valid one; a kill during 3 leaves either no manifest or
     the complete manifest, never a torn one.

Async saves (`PADDLE_CKPT_ASYNC=1` or `save(async_=True)`): the step
loop pays only for the SNAPSHOT — a device→host copy of the scope
persistables, the step seed and the extra state, captured at the step
boundary — and serialization + sha256 + the two-phase commit run on a
background writer thread.  The port's step loop needs the GIL for every
op it launches, so two things keep the writer off it: a CUDA tensor is
copied into a page-locked host buffer (``_PinnedPool``, reused across
saves), all of them queued on the stream and awaited once; and each
content file is pickled straight into the file through a hashing writer
(``_HashingWriter``), so an array's bytes go from its host buffer to the
sha256 and the disk without a copy made under the GIL (hashlib and the
file writes release it). The queue has depth 1 with coalescing: a new
save supersedes a still-queued one (the writer always commits the
NEWEST snapshot it was handed), so the step loop never blocks behind a
slow disk. Writer exceptions latch and re-raise at the next save() /
drain(); SIGTERM-driven final saves go through the synchronous path
(which waits out any in-flight write first) and an atexit hook drains
the queue, so the final checkpoint is never lost.

Sharded jobs (`PADDLE_CKPT_SHARDED=1` with world_size > 1): every rank
writes its own `rank<k>/` shard dir (contents + per-shard manifest,
committed exactly like a single-writer checkpoint) under the SAME step
dir, then reports the shard-manifest sha256 to a commit barrier — the
launcher-hosted `CkptBarrier` over the ps_server RPC transport
(PADDLE_CKPT_BARRIER_ENDPOINT, an ordered list when a standby
coordinator is armed), or a shared-filesystem poll when no barrier is
armed. Rank 0 waits for every rank's report and only then commits
`global_manifest.json` (step, world_size, membership_epoch, per-shard
manifest sha256s) — THE global commit point. `restore()` only considers
steps with a complete global manifest, so a crash between two ranks'
shard commits leaves a checkpoint that is INVISIBLE by construction
(and GC'd as torn once a newer step commits). Rank 0 owns retention.

`distributed/faults.py` rules drill every phase deterministically:
`crash:<phase>:<nth>` kills at `ckpt_tmp_written`, `ckpt_before_commit`,
`ckpt_manifest_tmp_written` (mid manifest rename), `ckpt_writer`
(inside the async writer thread), `ckpt_shard_committed` (post-shard,
pre-barrier-report) and `ckpt_before_global_commit`; `io_err:<phase>`,
`short_write:<phase>` and `diskfull:<phase>` inject disk faults at the
`ckpt_content`, `ckpt_manifest` and `ckpt_global_manifest` write
phases. `tools/ckpt_doctor.py` is the offline
fsck of either package's checkpoints.

What a checkpoint holds, and where the port differs from the JAX
package:

  state.pkl  {"arrays": {name: array}}: every persistable of the
             program (parameters, optimizer moments, LR, AMP state),
             copied to the host.  A bf16 tensor is pickled as the
             ml_dtypes bfloat16 array the JAX package writes (its raw
             2-byte words, ``BF16Array`` on the port's side), without
             importing ml_dtypes; the port reads either package's
             state.pkl without it.
  rng.pkl    the scope's step seed (``Scope._rng_seed``, below 2^63) as
             ``{"typed": False, "data": uint32[2]}``, the high word then
             the low word: the JAX package restores it as a raw PRNG key.
             A JAX key reads back as the seed of its first two words
             (``key_data`` of a typed key, 2 or 4 words), high then low,
             masked to 63 bits.  Port -> port restores the seed exactly;
             across packages both load, and the dropout streams differ by
             design.
  extra.pkl  the caller's `extra_state` (epoch / step / loss history:
             what `Model.fit(resume=...)` needs for an exact loss-trace
             continuation).

Under a program whose mesh shards variables (each rank holds its
block: tp, pp and ep parameters, ZeRO's moments on "dp", the
multi-slice modes' [n_dcn, ...] state on "dcn"), ``save`` gathers each
such variable, so the checkpoint holds the global values as one process
of the JAX package would write them, and ``restore`` keeps this rank's
block of each (``parallel.local_shard``, the executor's helper): every
rank must call both.  In the sharded layout every rank's shard holds
those global values, as a rank of the JAX package writes its scope; a
restore at another world size (an elastic resize) takes this rank's
block of them under the program's new mesh, so ZeRO's moments are split
again for the new dp.

Not ported (raising NotImplementedError where armed): parameter-server
tables in a checkpoint (the PS half of ROADMAP A6).
"""
from __future__ import annotations

import atexit
import copy
import hashlib
import importlib
import io as _pyio
import json
import os
import pickle
import re
import shutil
import signal
import sys
import threading
import time
import types
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import parallel as _parallel

try:  # numpy 2
    from numpy._core.multiarray import _reconstruct as _np_reconstruct
except ImportError:  # numpy 1
    from numpy.core.multiarray import _reconstruct as _np_reconstruct

from . import io as io_lib
from .dtypes import bfloat16
from .executor import _to_tensor, global_scope
from .io import (_atomic_write_bytes, _np_dtype, _persistable_names,
                 _ps_table_names)
from ..telemetry import get_registry

_REG = get_registry()

MANIFEST = "manifest.json"
GLOBAL_MANIFEST = "global_manifest.json"
MANIFEST_FORMAT = 1
_DIR_RE = re.compile(r"^ckpt-(\d+)$")
_TMP_RE = re.compile(r"^\.tmp-ckpt-(\d+)-(?:r\d+-)?(\d+)$")

ENV_ASYNC = "PADDLE_CKPT_ASYNC"
ENV_SHARDED = "PADDLE_CKPT_SHARDED"
ENV_BARRIER = "PADDLE_CKPT_BARRIER_ENDPOINT"
ENV_BARRIER_TIMEOUT = "PADDLE_CKPT_BARRIER_TIMEOUT"
ENV_DRAIN_TIMEOUT = "PADDLE_CKPT_DRAIN_TIMEOUT"

# sysexits EX_TEMPFAIL: the conventional "retry me" code — a preempted
# trainer exits with it after its final checkpoint, and a supervisor
# respawns a trainer that auto-resumes
PREEMPTED_EXIT_CODE = 75

_SEED_MASK = (1 << 63) - 1


class Preempted(RuntimeError):
    """Raised by a training loop after it honored a preemption request
    (SIGTERM) with a final checkpoint. Catch it and
    `sys.exit(PREEMPTED_EXIT_CODE)` so the supervisor respawns you."""


class WorldSizeMismatchError(RuntimeError):
    """The checkpoint was written by a job at a different world size
    and elastic re-shard is disabled: resuming it blind would silently
    misalign every rank's data shard. restore(allow_reshard=True), or
    PADDLE_ELASTIC_RESHARD=1, resumes it."""


class CheckpointError(RuntimeError):
    """A checkpoint save could not commit (disk fault). The on-disk state
    is still consistent: restore() falls back to the newest
    fully-committed step."""


class CheckpointWriterError(CheckpointError):
    """A background (async) checkpoint write failed. The error latched
    in the writer and re-raises here — at the save/drain AFTER the
    failure — so the step loop learns about it at the next step
    boundary instead of from a silent gap in the checkpoint chain."""


class RestoreMismatchError(CheckpointError):
    """The checkpoint's arrays disagree with the program's var metadata
    (shape or dtype) — restoring them would fail deep inside the next
    step, far from the var that caused it. The message names every
    mismatched var and the layer that created it (scopecheck findings),
    and NOTHING was applied to the scope. restore() does not fall back
    past this: the program changed, not the checkpoint, so every older
    step is equally mismatched."""

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings = list(findings)


class CommitBarrierError(CheckpointError):
    """Rank 0 gave up waiting for every rank's shard-commit report:
    the step's checkpoint stays torn (no global manifest) and restore()
    keeps serving the previous fully-committed step."""


def _env_true(name: str, default: str = "") -> bool:
    return os.environ.get(name, default).lower() in ("1", "true", "yes",
                                                     "on")


def _reshard_allowed_from_env() -> bool:
    return _env_true("PADDLE_ELASTIC_RESHARD")


def _world_size_from_env() -> Optional[int]:
    raw = os.environ.get("PADDLE_TRAINERS_NUM")
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _membership_epoch() -> int:
    try:
        return int(os.environ.get("PADDLE_MEMBERSHIP_EPOCH", "0") or 0)
    except ValueError:
        return 0


def _float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default) or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# preemption signal plumbing
# ---------------------------------------------------------------------------

_preempt_event = threading.Event()
_handler_installed = False
_handler_lock = threading.Lock()


def preemption_requested() -> bool:
    return _preempt_event.is_set()


def request_preemption() -> None:
    """Arm the preemption flag directly (tests: deterministic 'SIGTERM at
    step K' without signal-delivery timing)."""
    _preempt_event.set()


def clear_preemption() -> None:
    _preempt_event.clear()


def install_preemption_handler(signum: int = signal.SIGTERM) -> bool:
    """SIGTERM -> set the preemption flag; training loops drain it at the
    next step boundary (save a final checkpoint, raise Preempted). Chains
    any previously installed handler. Idempotent; returns False when not
    on the main thread (signal.signal would raise there) — the flag can
    still be armed via request_preemption()."""
    global _handler_installed
    with _handler_lock:
        if _handler_installed:
            return True
        try:
            prev = signal.getsignal(signum)

            def _handler(sig, frame):
                _preempt_event.set()
                if callable(prev) and prev not in (signal.SIG_IGN,
                                                   signal.SIG_DFL):
                    prev(sig, frame)

            signal.signal(signum, _handler)
        except ValueError:  # not the main thread
            return False
        _handler_installed = True
        return True


# ---------------------------------------------------------------------------
# RNG state: the scope's step seed <-> the JAX package's raw key
# ---------------------------------------------------------------------------


def _rng_state(seed: Optional[int]) -> Optional[dict]:
    """The step seed as a raw two-word key: high word, then low word."""
    if seed is None:
        return None
    seed = int(seed) & _SEED_MASK
    return {"typed": False,
            "data": np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)}


def _param_specs(program) -> dict:
    """name -> spec of each var a program under a mesh shards (a rank
    holds its block; ``parallel.local_shard``): tp, pp and ep
    parameters, ZeRO's moments, the multi-slice per-slice state."""
    if program is None or getattr(program, "_mesh", None) is None:
        return {}
    return {v.name: _parallel.get_var_sharding(v)
            for v in program.list_vars()
            if _parallel.param_axes(_parallel.get_var_sharding(v))}


def _restore_rng(state: Optional[dict]) -> Optional[int]:
    """The step seed of an rng.pkl of either package: the first two
    words of the key data (a typed key's ``key_data``: 2 words for
    threefry, 4 for rbg), high then low, masked to 63 bits."""
    if state is None:
        return None
    words = np.asarray(state["data"]).astype(np.uint32).reshape(-1)
    if words.size < 2:
        raise ValueError(f"rng state holds {words.size} word(s); a key "
                         f"has at least 2")
    return ((int(words[0]) << 32) | int(words[1])) & _SEED_MASK


# ---------------------------------------------------------------------------
# host arrays: bf16 without ml_dtypes, pickled as the JAX package's
# ---------------------------------------------------------------------------


class BF16Array:
    """A host bf16 array: its raw 2-byte words (``bits``, uint16) and the
    IR's :data:`~paddle_tpu_torch.fluid.dtypes.bfloat16` as ``dtype``.
    Pickled by this module as the ml_dtypes bfloat16 ndarray the JAX
    package pickles, so its loader reads it back as one."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint16)

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    @property
    def dtype(self):
        return bfloat16

    def to_torch(self) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(self.bits).view(np.int16)).view(
                torch.bfloat16)

    def __eq__(self, other):  # bit-for-bit equality
        return (isinstance(other, BF16Array)
                and np.array_equal(self.bits, other.bits))

    __hash__ = None


class _Ref:
    """A pickling stand-in that reduces to ``reduce`` (see _Pickler)."""

    __slots__ = ("reduce",)

    def __init__(self, reduce):
        self.reduce = reduce


# ml_dtypes.bfloat16 as the unpickler of the reading process imports it,
# and the numpy dtype built from it with ml_dtypes' own pickle state
_ML_MODULE = _Ref((importlib.import_module, ("ml_dtypes",)))
_ML_BF16_TYPE = _Ref((getattr, (_ML_MODULE, "bfloat16")))
_ML_BF16_DTYPE = _Ref((np.dtype, (_ML_BF16_TYPE, False, True),
                       (3, "<", None, None, None, 2, 2, 64)))


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, _Ref):
            return obj.reduce
        if isinstance(obj, BF16Array):
            bits = np.ascontiguousarray(obj.bits)
            return (_np_reconstruct,
                    (np.ndarray, (0,), b"b"),
                    (1, bits.shape, _ML_BF16_DTYPE, False, bits.tobytes()))
        return NotImplemented


class _HashingWriter:
    """The file object a content file is pickled into: every chunk goes
    to the sha256 and then to the file, and is counted.  A large array
    arrives as its own buffer (pickle protocol 5 writes big payloads
    straight to ``write``), and both hashlib and the file write release
    the GIL for it.  ``hash_ms`` and ``write_ms`` split the time."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0
        self.hash_ms = 0.0
        self.write_ms = 0.0

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        t0 = time.perf_counter()
        self.sha.update(view)
        t1 = time.perf_counter()
        self.f.write(view)
        self.hash_ms += (t1 - t0) * 1e3
        self.write_ms += (time.perf_counter() - t1) * 1e3
        self.nbytes += view.nbytes
        return view.nbytes


def _dump_to(writer, obj) -> None:
    _Pickler(writer, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


class _MLBFloat16:
    """Stands in for ``ml_dtypes.bfloat16`` while unpickling."""


def _import_module(name):
    if name != "ml_dtypes":
        raise pickle.UnpicklingError(
            f"a checkpoint may import ml_dtypes only, not {name!r}")
    return types.SimpleNamespace(bfloat16=_MLBFloat16)


class _PendingArray:
    """An ndarray under reconstruction: numpy's pickle creates it empty
    and hands it its state, which may carry the bf16 dtype."""

    __slots__ = ("value",)

    def __setstate__(self, state):
        _version, shape, dtype, fortran, raw = state
        if dtype is bfloat16:
            bits = np.frombuffer(raw, np.uint16).copy().reshape(
                shape, order="F" if fortran else "C")
            self.value = BF16Array(bits)
        else:
            arr = np.ndarray((0,), np.uint8)
            arr.__setstate__(state)
            self.value = arr


def _pending_reconstruct(subtype, shape, dtype):
    return _PendingArray()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if module == "numpy" and name == "dtype":
            return lambda obj, align=False, copy=False: (
                bfloat16 if obj is _MLBFloat16
                else _np_dtype(obj, align, copy))
        if root == "ml_dtypes" and name == "bfloat16":
            return _MLBFloat16
        if module == "importlib" and name == "import_module":
            return _import_module
        if root == "numpy" and name == "_reconstruct":
            return _pending_reconstruct
        return super().find_class(module, name)


def _resolve(obj):
    if isinstance(obj, _PendingArray):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve(v) for v in obj)
    return obj


def _loads(blob: bytes):
    """Unpickle a checkpoint file of either package (bf16 arrays as
    BF16Array, no ml_dtypes needed)."""
    return _resolve(_Unpickler(_pyio.BytesIO(blob)).load())


def _host_array(value, deep: bool):
    """A scope value copied to (or viewed on) the host: a numpy array, or
    a BF16Array.  ``deep`` makes sure it shares no memory with the
    scope (a CUDA tensor's host copy never does)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        on_host = t.device.type == "cpu"
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).cpu().numpy()
            bits = bits.view(np.uint16)
            return BF16Array(bits.copy() if deep and on_host else bits)
        a = t.cpu().numpy()
        return a.copy() if deep and on_host else a
    if isinstance(value, BF16Array):
        return BF16Array(value.bits.copy()) if deep else value
    a = np.asarray(value)
    return np.array(a, copy=True) if deep else a


def _to_device(value, device) -> torch.Tensor:
    if isinstance(value, BF16Array):
        return value.to_torch().to(device)
    return _to_tensor(value, device)


# ---------------------------------------------------------------------------
# fault-injection shims (one flag read each when the layer is off)
# ---------------------------------------------------------------------------


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _crash_point(phase: str) -> None:
    """Deterministic kill site for torn-checkpoint drills (flag-gated
    no-op in production: one flag read when off)."""
    from ..distributed import faults

    faults.crash_point(phase)


def _io_point(phase: str) -> bool:
    """Deterministic disk-fault site: may raise OSError (io_err /
    diskfull rules); True = simulate a short write (truncate)."""
    from ..distributed import faults

    return faults.io_point(phase)


def _write_content(path: str, obj, phase: str = "ckpt_content",
                   ) -> "_HashingWriter":
    """One checkpoint content file, ``obj`` pickled into it: fault-
    injectable, fsynced before the directory it lives in is renamed into
    place (the manifest commit must never point at bytes still sitting
    in a volatile cache).  The returned writer holds the sha256 and size
    of the INTENDED bytes — a short or bit-flipped write on disk then
    fails verification instead of being checksummed into legitimacy."""
    short = _io_point(phase)
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        _dump_to(w, obj)
        if short:
            f.truncate(w.nbytes // 2)
        f.flush()
        t0 = time.perf_counter()
        if io_lib._fsync_enabled():
            os.fsync(f.fileno())
        w.write_ms += (time.perf_counter() - t0) * 1e3
    _REG.counter("ckpt_bytes_written_total",
                 help="checkpoint bytes written (content + manifests)"
                 ).inc(w.nbytes // 2 if short else w.nbytes)
    return w


# ---------------------------------------------------------------------------
# snapshot job + bounded async writer
# ---------------------------------------------------------------------------


class _PinnedPool:
    """Page-locked host buffers for the snapshots of CUDA tensors, kept
    across saves (pinning 1.3 GB costs more than the copy): a snapshot
    takes its buffers, and gives them back once its write is done or it
    was superseded, so a buffer is never refilled while a writer reads
    it."""

    def __init__(self):
        self._free: Dict[tuple, list] = {}
        self._lock = threading.Lock()

    def take(self, shape, dtype) -> torch.Tensor:
        with self._lock:
            bufs = self._free.get((tuple(shape), dtype))
            if bufs:
                return bufs.pop()
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)

    def give(self, bufs) -> None:
        with self._lock:
            for b in bufs:
                self._free.setdefault((tuple(b.shape), b.dtype),
                                      []).append(b)


class _Snapshot:
    """Everything a checkpoint commit needs, captured at the step
    boundary: host copies of the arrays, the RNG state and the caller's
    extra state. Hand it to the writer and the live scope is free to
    move on."""

    __slots__ = ("step", "arrays", "rng", "extra", "snap_global_step",
                 "save_ctx", "async_", "timings", "pinned")

    def __init__(self, step: int, arrays: dict, rng, extra: dict):
        self.step = int(step)
        self.arrays = arrays
        self.rng = rng
        self.extra = extra
        self.snap_global_step = 0
        self.save_ctx: Optional[Tuple[str, str]] = None
        self.async_ = False
        self.timings: Dict[str, float] = {}
        self.pinned: list = []   # page-locked buffers the arrays view


class _AsyncWriter:
    """Depth-1 coalescing write queue + one daemon writer thread.

    submit() replaces any still-queued snapshot (the newest snapshot
    wins — checkpoints are idempotent restart points, not a log), so
    the step loop can save at any frequency without ever queueing
    behind the disk. A writer exception LATCHES: the next
    save()/drain() on the owning manager re-raises it as
    CheckpointWriterError."""

    def __init__(self, mgr: "CheckpointManager"):
        self.mgr = mgr
        self.cond = threading.Condition()
        self.pending: Optional[_Snapshot] = None
        self.active: Optional[_Snapshot] = None
        self.error: Optional[BaseException] = None
        self.closed = False
        self._thread: Optional[threading.Thread] = None

    def _depth_locked(self) -> None:
        d = ((1 if self.pending is not None else 0)
             + (1 if self.active is not None else 0))
        _REG.gauge("ckpt_queue_depth",
                   help="async checkpoint snapshots queued + in flight"
                   ).set(d)

    def submit(self, job: _Snapshot) -> None:
        with self.cond:
            if self.pending is not None:
                _REG.counter(
                    "ckpt_async_superseded_total",
                    help="queued async snapshots replaced by a newer "
                         "save before the writer picked them up").inc()
                self.mgr._release(self.pending)
            self.pending = job
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="paddle-tpu-torch-ckpt-writer")
                self._thread.start()
            self._depth_locked()
            self.cond.notify_all()

    def _loop(self) -> None:
        while True:
            with self.cond:
                while self.pending is None and not self.closed:
                    self.cond.wait()
                if self.pending is None:
                    return
                job, self.pending = self.pending, None
                self.active = job
                self._depth_locked()
            try:
                _crash_point("ckpt_writer")
                self.mgr._write_snapshot(job)
            except BaseException as e:  # noqa: BLE001 — latch + surface
                with self.cond:
                    if self.error is None:
                        self.error = e
                _REG.counter("ckpt_writer_errors_total",
                             help="async checkpoint writes that failed"
                             ).inc()
                try:
                    from ..telemetry import tracing

                    tracing.flight_dump("ckpt_writer_error")
                except Exception:  # noqa: BLE001
                    pass
            finally:
                self.mgr._release(job)
                with self.cond:
                    self.active = None
                    self._depth_locked()
                    self.cond.notify_all()

    def cancel_pending(self) -> None:
        """Drop a still-queued snapshot (a synchronous save is about to
        write something at least as new)."""
        with self.cond:
            if self.pending is not None:
                _REG.counter("ckpt_async_superseded_total").inc()
                self.mgr._release(self.pending)
                self.pending = None
                self._depth_locked()

    def wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self.cond:
            while self.pending is not None or self.active is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(min(left, 0.5))
        return True

    def take_error(self) -> Optional[BaseException]:
        with self.cond:
            err, self.error = self.error, None
        return err


# ---------------------------------------------------------------------------
# manager


# ---------------------------------------------------------------------------
# commit-barrier handles (sharded global commit)
# ---------------------------------------------------------------------------


class _LocalBarrier:
    """Direct in-process handle on a coordinator.CkptBarrier (tests,
    and the launcher process itself)."""

    def __init__(self, barrier):
        self.barrier = barrier

    def shard_commit(self, step, rank, world, info) -> None:
        self.barrier.shard_commit(step=int(step), rank=int(rank),
                                  world_size=int(world), info=info)

    def wait_full(self, step, world, timeout) -> Optional[dict]:
        out = self.barrier.wait_full(step=int(step),
                                     world_size=int(world),
                                     timeout=float(timeout))
        if not out.get("complete"):
            return None
        return {int(r): dict(i) for r, i in out["shards"].items()}


class _RPCBarrier:
    """Commit barrier over the ps_server RPC transport (the launcher
    hosts coordinator.CkptBarrier and exports
    PADDLE_CKPT_BARRIER_ENDPOINT). Rank 0 POLLS ckpt_status instead of
    holding a handler thread in a long blocking wait.

    The endpoint may be a comma-separated ordered list (durable
    coordinator + warm standby): verbs rotate to the next endpoint on
    transport failure AND on a ``{"standby": True}`` refusal — an
    unpromoted standby or a stale-latched deposed primary must never
    swallow a commit report."""

    def __init__(self, endpoint: str):
        self.endpoints = [e.strip() for e in str(endpoint).split(",")
                          if e.strip()]
        self.endpoint = self.endpoints[0]
        self._idx = 0
        self._conn = None

    def _c(self):
        if self._conn is None:
            from ..distributed.ps_server import _Conn

            self._conn = _Conn(self.endpoints[self._idx], deadline=10.0,
                               io_timeout=30.0)
        return self._conn

    def _rotate(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — best-effort close
                pass
        self._conn = None
        self._idx = (self._idx + 1) % len(self.endpoints)
        self.endpoint = self.endpoints[self._idx]

    def _call(self, verb: str, **kw) -> dict:
        last: Optional[BaseException] = None
        for _ in range(max(2, len(self.endpoints) * 2)):
            try:
                out = self._c().call(verb, **kw)
            except ConnectionError as e:
                last = e
                self._rotate()
                time.sleep(0.05)
                continue
            if isinstance(out, dict) and out.get("standby"):
                last = ConnectionError(
                    f"barrier endpoint {self.endpoint} is not the "
                    f"authoritative coordinator")
                self._rotate()
                time.sleep(0.05)
                continue
            return out
        raise last if last is not None else ConnectionError(
            "ckpt barrier unreachable")

    def shard_commit(self, step, rank, world, info) -> None:
        self._call("ckpt_shard_commit", step=int(step), rank=int(rank),
                   world_size=int(world), info=info)

    def wait_full(self, step, world, timeout) -> Optional[dict]:
        deadline = time.monotonic() + float(timeout)
        while True:
            try:
                out = self._call("ckpt_status", step=int(step))
            except ConnectionError:
                if time.monotonic() > deadline:
                    return None
                time.sleep(0.2)
                continue
            shards = {int(r): dict(i)
                      for r, i in (out.get("shards") or {}).items()}
            if len(shards) >= int(world):
                return shards
            if time.monotonic() > deadline:
                return None
            time.sleep(0.1)


class _FSBarrier:
    """Shared-filesystem fallback when no barrier endpoint is armed: a
    landed, parseable shard manifest IS the rank's commit report; rank 0
    polls for every rank's and derives the manifest sha256s itself."""

    def __init__(self, mgr: "CheckpointManager"):
        self.mgr = mgr

    def shard_commit(self, step, rank, world, info) -> None:
        pass  # the shard manifest on the shared FS is the report

    def wait_full(self, step, world, timeout) -> Optional[dict]:
        deadline = time.monotonic() + float(timeout)
        stepdir = self.mgr._dir(step)
        while True:
            shards: Optional[dict] = {}
            for r in range(int(world)):
                p = os.path.join(stepdir, f"rank{r}", MANIFEST)
                try:
                    with open(p, "rb") as f:
                        blob = f.read()
                    m = json.loads(blob.decode())
                    if m.get("format") != MANIFEST_FORMAT:
                        raise ValueError("format")
                except (OSError, ValueError):
                    shards = None
                    break
                shards[r] = {
                    "manifest_sha256": hashlib.sha256(blob).hexdigest()}
            if shards is not None:
                return shards
            if time.monotonic() > deadline:
                return None
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Step-numbered atomic checkpoints with retention and verified,
    fall-back-to-newest-valid restore; optional async background writes
    and sharded multi-rank layouts with a single global commit point.

    program/scope given at construction are the defaults for save() and
    restore(); both can be overridden per call. With program=None the
    whole scope is checkpointed.

    async_save (default: PADDLE_CKPT_ASYNC) hands serialization + the
    two-phase commit to a background writer.  ``device`` is where a
    restore places the arrays (None: the CUDA card, resolved when a
    restore needs it).  sharded (default: PADDLE_CKPT_SHARDED, only with
    world_size > 1) writes `rank<k>/` shard dirs (``rank``: default
    PADDLE_TRAINER_ID) and gates restore on rank 0's
    global_manifest.json; ``barrier`` injects an in-process
    coordinator.CkptBarrier (tests); launched ranks reach the
    launcher's over PADDLE_CKPT_BARRIER_ENDPOINT, falling back to
    shared-FS polling.

    ``last_save`` holds the newest save's times in ms: ``snapshot``
    (device to host), ``serialize`` (pickle + sha256: the streaming time
    less the file writes), ``write`` (the file writes, fsyncs, renames,
    manifest) and ``save`` (the step loop's share), and its ``bytes``;
    an async save's writer fills in the middle two when it has run."""

    def __init__(self, root: str, keep_last_n: int = 3, program=None,
                 scope=None, world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 sharded: Optional[bool] = None,
                 async_save: Optional[bool] = None,
                 barrier=None, device=None):
        self.root = os.path.abspath(root)
        self.keep_last_n = max(1, int(keep_last_n))
        self.program = program
        self.scope = scope
        self.device = device
        # elastic contract: manifests record the dp world size that
        # wrote them (default: the launcher env); restore refuses a
        # mismatch unless the caller opted into re-sharding
        self.world_size = (int(world_size) if world_size is not None
                           else _world_size_from_env())
        self.rank = (int(rank) if rank is not None
                     else int(os.environ.get("PADDLE_TRAINER_ID", "0")
                              or 0))
        if sharded is None:
            sharded = _env_true(ENV_SHARDED) and (self.world_size or 1) > 1
        self.sharded = bool(sharded)
        self.barrier = barrier
        self._bar_handle = None
        if async_save is None:
            async_save = _env_true(ENV_ASYNC)
        self.async_save = bool(async_save)
        self._async: Optional[_AsyncWriter] = None
        self._pool = _PinnedPool()
        self.last_save: Dict[str, float] = {}
        os.makedirs(self.root, exist_ok=True)

    # -- layout ----------------------------------------------------------
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt-{int(step):08d}")

    def _data_dir(self, step: int) -> str:
        """Where THIS writer's content lives: the step dir itself, or
        this rank's shard dir under it."""
        d = self._dir(step)
        return os.path.join(d, f"rank{self.rank}") if self.sharded else d

    def _scan(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            m = _DIR_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def manifest(self, step: int) -> Optional[dict]:
        """Parsed manifest of a COMMITTED checkpoint — this rank's shard
        manifest in sharded mode — else None (missing or unparseable
        manifest == torn == not a checkpoint)."""
        try:
            with open(os.path.join(self._data_dir(step), MANIFEST)) as f:
                m = json.load(f)
            return m if m.get("format") == MANIFEST_FORMAT else None
        except (OSError, ValueError):
            return None

    def global_manifest(self, step: int) -> Optional[dict]:
        """Parsed global manifest of a sharded checkpoint (None = torn,
        absent, or a non-sharded layout)."""
        try:
            with open(os.path.join(self._dir(step), GLOBAL_MANIFEST)) as f:
                m = json.load(f)
            return m if m.get("format") == MANIFEST_FORMAT else None
        except (OSError, ValueError):
            return None

    def steps(self) -> List[int]:
        """COMMITTED steps, ascending. The commit marker is the manifest
        — the GLOBAL manifest for sharded layouts, so a step some ranks
        finished and others did not is not a checkpoint at all."""
        if self.sharded:
            return [s for s, _ in self._scan()
                    if self.global_manifest(s) is not None]
        return [s for s, _ in self._scan() if self.manifest(s) is not None]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    @staticmethod
    def _verify_files(d: str, files: Dict[str, dict]) -> bool:
        for rel, meta in files.items():
            p = os.path.join(d, rel)
            try:
                if os.path.getsize(p) != meta["bytes"]:
                    return False
                if _sha256(p) != meta["sha256"]:
                    return False
            except OSError:
                return False
        return True

    def verify(self, step: int) -> bool:
        """Full integrity check: manifest present and every listed file
        exists with matching size and sha256. Sharded: the global
        manifest must list world_size shards whose manifest files hash
        to the recorded sha256s, and THIS rank's shard contents are
        checksummed in full (tools/ckpt_doctor.py cross-checks every
        shard's contents offline)."""
        if self.sharded:
            gm = self.global_manifest(step)
            if gm is None:
                return False
            shards = gm.get("shards") or {}
            if len(shards) != int(gm.get("world_size") or 0):
                return False
            d = self._dir(step)
            for rname, info in shards.items():
                p = os.path.join(d, rname, MANIFEST)
                try:
                    with open(p, "rb") as f:
                        blob = f.read()
                except OSError:
                    return False
                if hashlib.sha256(blob).hexdigest() != \
                        info.get("manifest_sha256"):
                    return False
        m = self.manifest(step)
        if m is None:
            return False
        return self._verify_files(self._data_dir(step), m["files"])

    # -- async plumbing --------------------------------------------------
    def _writer(self) -> _AsyncWriter:
        if self._async is None:
            self._async = _AsyncWriter(self)
            # drain on interpreter exit: the last async save must land
            # even when the caller never reaches a drain point
            atexit.register(self._atexit_drain)
        return self._async

    def _drain_timeout(self) -> float:
        return _float_env(ENV_DRAIN_TIMEOUT, 120.0)

    def _barrier_timeout(self) -> float:
        return _float_env(ENV_BARRIER_TIMEOUT, 120.0)

    def _barrier_handle(self):
        if self._bar_handle is None:
            if self.barrier is not None:
                self._bar_handle = _LocalBarrier(self.barrier)
            elif os.environ.get(ENV_BARRIER):
                self._bar_handle = _RPCBarrier(os.environ[ENV_BARRIER])
            else:
                self._bar_handle = _FSBarrier(self)
        return self._bar_handle

    def raise_if_async_failed(self) -> None:
        """Surface a latched background-writer failure (no-op when the
        writer never ran or never failed). Training loops call this at
        the step boundary; save() and drain() call it themselves."""
        w = self._async
        if w is None:
            return
        err = w.take_error()
        if err is not None:
            raise CheckpointWriterError(
                f"async checkpoint write failed: "
                f"{type(err).__name__}: {err}") from err

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued/in-flight async save is durably
        committed; re-raises a latched writer error. The preemption and
        atexit paths run through here so the final checkpoint is never
        lost."""
        w = self._async
        if w is not None:
            if not w.wait_idle(timeout if timeout is not None
                               else self._drain_timeout()):
                raise CheckpointError(
                    "timed out draining the async checkpoint writer")
        self.raise_if_async_failed()

    def _atexit_drain(self) -> None:
        w = self._async
        if w is None:
            return
        w.wait_idle(self._drain_timeout())
        err = w.take_error()
        if err is not None:  # exiting: report, don't raise
            print(f"[checkpoint] async writer failed at exit: "
                  f"{type(err).__name__}: {err}", file=sys.stderr)

    # -- save ------------------------------------------------------------
    def save(self, step: int, extra_state: Optional[dict] = None,
             program=None, scope=None,
             async_: Optional[bool] = None) -> str:
        """Checkpoint `step`. async_ None defaults to the manager's
        async_save (PADDLE_CKPT_ASYNC); async saves return after the
        SNAPSHOT with the path the writer will commit to. async_=False
        forces a synchronous commit — the preemption/final-save path —
        after superseding any queued snapshot and waiting out an
        in-flight write (two writers never interleave). A latched
        background failure from an earlier async save re-raises HERE,
        before anything new is captured."""
        from . import monitor
        from ..telemetry import tracing

        self.raise_if_async_failed()
        if async_ is None:
            async_ = self.async_save
        t0 = time.perf_counter()
        # the save span joins the LAST step's trace (saves run between
        # steps, after the step span closed); no-op with tracing off
        with tracing.span("checkpoint_save",
                          parent=tracing.last_step_ctx(),
                          attrs={"step": int(step)}) as sp:
            job = self._snapshot(step, extra_state, program, scope,
                                 deep=bool(async_))
            job.async_ = bool(async_)
            self.last_save = job.timings
            if sp is not None:
                job.save_ctx = (sp.trace_id, sp.span_id)
            if async_:
                self._writer().submit(job)
                out = self._data_dir(step)
            else:
                w = self._async
                if w is not None:
                    w.cancel_pending()
                    w.wait_idle(self._drain_timeout())
                try:
                    out = self._write_snapshot(job)
                finally:
                    self._release(job)
        # the step loop's share of checkpoint time (the snapshot only,
        # for an async save)
        ms = (time.perf_counter() - t0) * 1e3
        job.timings["save"] = ms
        monitor.observe_checkpoint_save(ms)
        return out

    def _snapshot(self, step: int, extra_state: Optional[dict],
                  program, scope, deep: bool) -> _Snapshot:
        """Capture a consistent host snapshot at the step boundary:
        device→host copies of the persistables, the step seed and the
        extra state. `deep` (async) decouples every buffer from the live
        scope — the next step may overwrite a host tensor while the
        writer serializes."""
        from . import monitor

        program = program if program is not None else self.program
        scope = scope if scope is not None else (self.scope or global_scope())
        t0 = time.perf_counter()
        if program is not None:
            tables = _ps_table_names(program)
            if tables:
                raise NotImplementedError(
                    f"CheckpointManager.save: the program reads "
                    f"parameter-server tables {tables}; checkpointing them "
                    f"waits for the port of the parameter server (the PS "
                    f"half of ROADMAP A6), and the checkpoint will not leave them out")
            names = [n for n in _persistable_names(program)
                     if scope.find_var(n) is not None]
        else:
            names = [n for n, v in scope.vars.items() if v is not None]
        specs = _param_specs(program)
        arrays, pinned = {}, []
        for n in names:
            v = scope.find_var(n)
            if n in specs:
                # a rank's block of a sharded var: the checkpoint holds
                # the global value (every rank gathers it)
                v = _parallel.gather_shard(v, specs[n], program._mesh)
            if isinstance(v, torch.Tensor) and v.is_cuda:
                # queued on the stream after the step's kernels; awaited
                # once below
                buf = self._pool.take(v.shape, v.dtype)
                buf.copy_(v.detach(), non_blocking=True)
                pinned.append(buf)
                arrays[n] = buf
            else:
                arrays[n] = _host_array(v, deep)
        if pinned:
            torch.cuda.synchronize()
            arrays = {n: _host_array(a, deep=False)
                      if isinstance(a, torch.Tensor) else a
                      for n, a in arrays.items()}
        rng = _rng_state(scope._rng_seed)
        extra = (copy.deepcopy(dict(extra_state or {})) if deep
                 else dict(extra_state or {}))
        job = _Snapshot(step, arrays, rng, extra)
        job.pinned = pinned
        job.snap_global_step = monitor.global_step()
        job.timings["snapshot"] = (time.perf_counter() - t0) * 1e3
        return job

    def _release(self, job: _Snapshot) -> None:
        """Give a snapshot's page-locked buffers back (its write is done,
        failed, or was superseded); its arrays go with them."""
        if job.pinned:
            bufs, job.pinned, job.arrays = job.pinned, [], None
            self._pool.give(bufs)

    def _write_snapshot(self, job: _Snapshot) -> str:
        """Serialize + checksum + two-phase commit (runs inline for sync
        saves, on the writer thread for async ones)."""
        from . import monitor
        from ..telemetry import tracing

        t0 = time.perf_counter()
        contents = {"state.pkl": {"arrays": job.arrays}, "rng.pkl": job.rng,
                    "extra.pkl": job.extra}
        # the write span parents under the save span that captured the
        # snapshot, even though an async write runs later on another
        # thread
        with tracing.child_span("checkpoint_write", job.save_ctx,
                                attrs={"step": job.step,
                                       "mode": ("async" if job.async_
                                                else "sync")}):
            if self.sharded:
                out = self._write_shard(job, contents)
            else:
                out = self._write_single(job, contents)
        _REG.histogram("checkpoint_write_ms",
                       help="serialize+commit durations (writer side)"
                       ).observe((time.perf_counter() - t0) * 1e3)
        lag = max(0, monitor.global_step() - job.snap_global_step)
        _REG.gauge("ckpt_save_lag_steps",
                   help="steps the loop advanced while the last "
                        "checkpoint was being written").set(lag)
        _REG.gauge("ckpt_save_lag_steps_peak",
                   help="high-water of ckpt_save_lag_steps").set_max(lag)
        return out

    def _commit_manifest(self, path: str, manifest: dict, io_phase: str,
                         crash_phase: str = "ckpt_manifest_tmp_written",
                         ) -> str:
        """THE commit point: tmp + os.replace makes the manifest appear
        atomically; before this the directory reads as torn. Returns the
        sha256 of the INTENDED manifest bytes."""
        blob = json.dumps(manifest, indent=1).encode()
        short = _io_point(io_phase)
        data = blob[: len(blob) // 2] if short else blob
        _atomic_write_bytes(path, data, crash_phase=crash_phase)
        _REG.counter("ckpt_bytes_written_total",
                     help="checkpoint bytes written (content + manifests)"
                     ).inc(len(data))
        return hashlib.sha256(blob).hexdigest()

    def _write_dir(self, tmp: str, final: str, contents: dict,
                   job: _Snapshot, t0: float) -> dict:
        """Phases 1-2 of the commit: every content file into ``tmp``
        (fsynced, then the directory), then ``tmp`` renamed to ``final``.
        Returns the manifest's file table; the serialize time lands in
        the job's timings."""
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        files, write_ms = {}, 0.0
        try:
            for rel in sorted(contents):
                w = _write_content(os.path.join(tmp, rel), contents[rel])
                files[rel] = {"sha256": w.sha.hexdigest(),
                              "bytes": w.nbytes}
                write_ms += w.write_ms
            job.timings["serialize"] = \
                (time.perf_counter() - t0) * 1e3 - write_ms
            io_lib._fsync_dir(tmp)
            _crash_point("ckpt_tmp_written")
            if os.path.exists(final):  # stale same-step dir (torn or old)
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        io_lib._fsync_dir(os.path.dirname(final))
        _crash_point("ckpt_before_commit")
        job.timings["bytes"] = sum(m["bytes"] for m in files.values())
        return files

    @staticmethod
    def _ps_section() -> dict:
        return {"tables": [],
                "generation": int(
                    os.environ.get("PADDLE_ELASTIC_RESTART", "0") or 0)}

    def _write_single(self, job: _Snapshot, contents: dict) -> str:
        step = job.step
        t0 = time.perf_counter()
        final = self._dir(step)
        files = self._write_dir(
            os.path.join(self.root, f".tmp-ckpt-{step:08d}-{os.getpid()}"),
            final, contents, job, t0)
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "files": files,
            "ps": self._ps_section(),
        }
        if self.world_size is not None:
            manifest["world_size"] = int(self.world_size)
            manifest["membership_epoch"] = _membership_epoch()
        self._commit_manifest(os.path.join(final, MANIFEST), manifest,
                              "ckpt_manifest")
        job.timings["write"] = ((time.perf_counter() - t0) * 1e3
                                - job.timings["serialize"])
        self._retain()
        return final

    def _write_shard(self, job: _Snapshot, contents: dict) -> str:
        """Sharded commit: shard contents + shard manifest exactly like
        a single-writer checkpoint, then the commit barrier, then (rank
        0 only) the global manifest — the ONLY marker restore trusts."""
        step = job.step
        t0 = time.perf_counter()
        stepdir = self._dir(step)
        os.makedirs(stepdir, exist_ok=True)
        final = os.path.join(stepdir, f"rank{self.rank}")
        files = self._write_dir(
            os.path.join(self.root, f".tmp-ckpt-{step:08d}-r{self.rank}-"
                                    f"{os.getpid()}"),
            final, contents, job, t0)
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": step,
            "rank": int(self.rank),
            "files": files,
            "ps": self._ps_section(),
        }
        man_sha = self._commit_manifest(os.path.join(final, MANIFEST),
                                        manifest, "ckpt_manifest")
        # the shard is committed but INVISIBLE: without the global
        # manifest no restore anywhere considers this step
        _crash_point("ckpt_shard_committed")

        world = int(self.world_size or 1)
        barrier = self._barrier_handle()
        barrier.shard_commit(step, int(self.rank), world,
                             {"manifest_sha256": man_sha})
        if int(self.rank) == 0:
            shards = barrier.wait_full(step, world, self._barrier_timeout())
            if shards is None:
                raise CommitBarrierError(
                    f"commit barrier for step {step} incomplete after "
                    f"{self._barrier_timeout():.0f}s — the step stays torn "
                    f"(no global manifest); restore() keeps serving the "
                    f"previous fully-committed step")
            _crash_point("ckpt_before_global_commit")
            gm = {
                "format": MANIFEST_FORMAT,
                "step": step,
                "world_size": world,
                "membership_epoch": _membership_epoch(),
                "shards": {f"rank{r}": dict(info)
                           for r, info in sorted(shards.items())},
            }
            self._commit_manifest(
                os.path.join(stepdir, GLOBAL_MANIFEST), gm,
                "ckpt_global_manifest",
                crash_phase="ckpt_global_manifest_tmp_written")
            self._retain()
        job.timings["write"] = ((time.perf_counter() - t0) * 1e3
                                - job.timings["serialize"])
        return final

    def _retain(self) -> None:
        """Keep the newest keep_last_n COMMITTED checkpoints. Retention
        counts ONLY committed steps — torn dirs never consume a slot and
        the newest valid checkpoint is never deleted no matter how many
        newer torn dirs exist. Torn dirs BELOW the newest committed step
        can never complete (a newer commit exists) and are GC'd; a torn
        dir at/above it may be a save in flight and is left for the next
        save at that step (or tools/ckpt_doctor.py --gc) to clear. In
        sharded mode rank 0 owns retention."""
        if self.sharded and int(self.rank) != 0:
            return
        valid = self.steps()
        if not valid:
            return
        kept = valid[-self.keep_last_n:]
        cutoff = kept[0]
        newest = valid[-1]
        for s, path in self._scan():
            if s in kept:
                continue
            if s < cutoff:
                shutil.rmtree(path, ignore_errors=True)
            elif s < newest and s not in valid:
                _REG.counter("ckpt_torn_gcd_total",
                             help="torn (never-committed) checkpoint "
                                  "dirs garbage-collected").inc()
                shutil.rmtree(path, ignore_errors=True)
        for name in os.listdir(self.root):
            m = _TMP_RE.match(name)
            if not m:
                continue
            t_step, t_pid = int(m.group(1)), int(m.group(2))
            # another pid's tmp dir at a step NEWER than the newest
            # commit may be a live writer's save in flight (sharded
            # ranks share the root); it only becomes provable trash once
            # that step commits
            if t_step < cutoff or (t_pid != os.getpid()
                                   and t_step <= newest):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def restore(self, step: Optional[int] = None, program=None,
                scope=None, allow_reshard: Optional[bool] = None,
                ) -> Optional[dict]:
        """Restore the given step, or the newest checkpoint that passes
        full verification — a torn or corrupted newer directory is
        skipped with a warning, never trusted. A sharded step without a
        complete global manifest is invisible by construction. Returns
        {"step", "extra", "manifest", "world_size"} (and
        "global_manifest" when sharded) or None when no valid checkpoint
        exists. On success the scope holds the checkpointed persistables
        (on the manager's device) and the step seed.

        Elastic gate: a manifest written at a DIFFERENT world size is
        refused (WorldSizeMismatchError — never a silent fallback, the
        older checkpoints have the same world size) unless
        `allow_reshard` (default: PADDLE_ELASTIC_RESHARD env) is true;
        then the caller owns re-splitting its data positions across the
        new dp group and the returned "world_size" says what to re-split
        FROM, while each sharded variable takes this rank's block under
        the program's mesh. Manifests that carry no world size skip the
        check."""
        from .. import resolve_device

        program = program if program is not None else self.program
        scope = scope if scope is not None else (self.scope or global_scope())
        device = resolve_device(self.device)
        if allow_reshard is None:
            allow_reshard = _reshard_allowed_from_env()
        candidates = [step] if step is not None else \
            list(reversed(self.steps()))
        for s in candidates:
            t0 = time.perf_counter()
            if not self.verify(s):
                warnings.warn(
                    f"checkpoint ckpt-{s:08d} at {self.root!r} failed "
                    f"verification (torn write or corruption); falling "
                    f"back to the previous checkpoint",
                    RuntimeWarning, stacklevel=2)
                continue
            src = self.global_manifest(s) if self.sharded \
                else self.manifest(s)
            ckpt_ws = (src or {}).get("world_size")
            if (ckpt_ws is not None and self.world_size is not None
                    and int(ckpt_ws) != int(self.world_size)
                    and not allow_reshard):
                raise WorldSizeMismatchError(
                    f"checkpoint ckpt-{s:08d} was written by a world of "
                    f"{ckpt_ws} trainers but this job runs "
                    f"{self.world_size}; elastic re-shard is disabled — "
                    f"re-split the data positions and pass "
                    f"allow_reshard=True (or PADDLE_ELASTIC_RESHARD=1)")
            try:
                out = self._load(s, program, scope, device)
            except (RestoreMismatchError, NotImplementedError):
                # the program (or the port) disagrees with the
                # checkpoint: every older checkpoint is equally
                # mismatched — falling back would repeat the error
                raise
            except Exception as e:  # corrupt despite checksums: skip it
                warnings.warn(
                    f"checkpoint ckpt-{s:08d} failed to load ({e}); "
                    f"falling back", RuntimeWarning, stacklevel=2)
                continue
            out["world_size"] = ckpt_ws
            out["restore_ms"] = (time.perf_counter() - t0) * 1e3
            return out
        return None

    def _load(self, step: int, program, scope, device) -> dict:
        d = self._data_dir(step)
        manifest = self.manifest(step)
        tables = (manifest or {}).get("ps", {}).get("tables", ())
        if tables:
            raise NotImplementedError(
                f"checkpoint ckpt-{step:08d} holds parameter-server tables "
                f"{list(tables)}; restoring them waits for the port of the "
                f"parameter server (the PS half of ROADMAP A6)")
        loaded = {}
        for name in ("state", "rng", "extra"):
            with open(os.path.join(d, f"{name}.pkl"), "rb") as f:
                loaded[name] = _loads(f.read())
        state, rng, extra = loaded["state"], loaded["rng"], loaded["extra"]

        # scope-aware lint BEFORE anything touches the scope: a restored
        # array whose shape/dtype disagrees with the program var would
        # otherwise fail inside the next step. Only the intersection is
        # checked — partial restores (a program that grew a layer since
        # the save) are legitimate and the startup program owns the rest.
        if program is not None:
            from .analysis import ERROR as _AN_ERROR
            from .analysis import verify_scope as _verify_scope

            # LocalSGD's per-slice variables are saved [n_dcn, *shape]
            # (the JAX package's layout) for a program var of [*shape]
            divergent = getattr(program, "_dcn_divergent_names", ())
            checked = {n: (a[0] if n in divergent else a)
                       for n, a in state["arrays"].items()}
            mismatched = [
                f for f in _verify_scope(program, checked,
                                         check_orphans=False)
                if f.severity == _AN_ERROR and f.check in
                ("scope-shape-mismatch", "scope-dtype-mismatch")]
            if mismatched:
                raise RestoreMismatchError(
                    f"checkpoint ckpt-{step:08d} disagrees with the "
                    f"program on {len(mismatched)} var(s); nothing was "
                    f"restored:\n" + "\n".join(
                        "  " + f.format() for f in mismatched),
                    findings=mismatched)

        specs = _param_specs(program)
        tensors = {n: _to_device(a, device)
                   for n, a in state["arrays"].items()}
        for n, t in tensors.items():
            if n in specs:      # this rank's block of the global value
                t = _parallel.local_shard(t, specs[n],
                                          program._mesh).contiguous()
            scope.set_var(n, t)
        scope._rng_seed = _restore_rng(rng)
        out = {"step": int(step), "extra": extra, "manifest": manifest}
        if self.sharded:
            out["global_manifest"] = self.global_manifest(step)
        return out
