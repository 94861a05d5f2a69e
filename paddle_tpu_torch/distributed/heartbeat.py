"""Trainer liveness via file heartbeats, ported from the JAX package's
``distributed/heartbeat.py``: the same stamp files, so a stamp one
package's worker writes reads the same in the other's monitor.

Parity surface: the reference's PS-side HeartBeatMonitor
(paddle/fluid/operators/distributed/heart_beat_monitor.h:54) marks a trainer TIMEOUT when no UPDATE arrives within a window, and its
launcher aborts the job on any child failure (distributed/utils.py:407) —
detection only on hard exit, nothing for hangs.

Design: liveness is its own tiny channel — each trainer stamps a
per-rank heartbeat file (shared filesystem for multi-host) from a daemon
thread, and the launcher treats a stale stamp as a hang, which a
collective otherwise turns into a silent whole-job stall (one lost rank
blocks every all-reduce of its group until the process-group timeout).
Detection feeds the launcher's elastic restart (launch.py
--elastic_retries): kill the group, respawn, resume from checkpoint.

Not ported yet: the straggler detector that ``StragglerMonitor`` feeds
(``telemetry/straggler.py``, ROADMAP A8) and the fleet payload the
renewals carry when PADDLE_FLEET_METRICS arms it (``telemetry/
goodput.py``'s fleet half, ROADMAP A8): ``StragglerMonitor`` raises,
and renewals carry the stamp alone.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Callable, List, Optional, Tuple, Union

from ..telemetry import tracing as _tracing

ENV_DIR = "PADDLE_HEARTBEAT_DIR"

# a "rank" is an int trainer rank or a string tag (pservers stamp as
# "ps<idx>" — ps_server.serve / launch.py supervision share this channel)
Rank = Union[int, str]

# step-rate payload for the stamps: fluid/monitor.py registers its
# (global step, avg step seconds) sampler here on the first executed
# step, so launched trainers carry progress in their heartbeats without
# code changes — the launcher's straggler detection reads it back
_step_provider: Optional[Callable[[], Tuple[int, Optional[float]]]] = None

# extra stamp fields: a provider returning e.g. {"data_frac": 0.7} —
# the input-skew signal straggler attribution reads back. None values
# are dropped, so an unarmed telemetry layer leaves the stamp bytes
# unchanged
_aux_provider: Optional[Callable[[], dict]] = None


def set_step_provider(fn: Callable[[], Tuple[int, Optional[float]]]) -> None:
    global _step_provider
    _step_provider = fn


def set_aux_provider(fn: Callable[[], dict]) -> None:
    global _aux_provider
    _aux_provider = fn


def _stamp_path(directory: str, rank: Rank) -> str:
    return os.path.join(directory, f"heartbeat.{rank}")


def read_stamp(directory: str, rank: Rank) -> Optional[dict]:
    """Parsed stamp content: {"t": unix seconds[, "step": int,
    "avg_step_s": float]}. Pre-telemetry stamps (a bare repr(float))
    parse as {"t": value}. None when absent/torn."""
    try:
        with open(_stamp_path(directory, rank)) as f:
            raw = f.read()
    except OSError:
        return None
    try:
        d = json.loads(raw)
        return d if isinstance(d, dict) else {"t": float(d)}
    except ValueError:
        try:
            return {"t": float(raw)}
        except ValueError:
            return None


class HeartBeatWorker:
    """Daemon thread stamping this process's heartbeat file (trainers
    stamp their integer rank; pservers stamp a string tag). Stamps
    carry the member's membership-epoch view (PADDLE_MEMBERSHIP_EPOCH)
    when the launcher exported one, and `renew_cb` — when the job
    control plane is armed — turns every stamp into a coordinator
    lease renewal carrying the same payload (coordinator.py).

    Coordinator outages never stall the beat: the renewal
    callback is CoordinatorClient.renew, which raises ConnectionError
    on a transport failure AFTER entering grace mode — buffering the
    payload and re-registering idempotently on reconnect — and the
    `except` below swallows the raise, so file heartbeats keep stamping
    and training keeps stepping while the control plane is down."""

    def __init__(self, directory: str, rank: Rank, interval: float = 1.0,
                 renew_cb=None):
        self.path = _stamp_path(directory, rank)
        self.interval = interval
        self.renew_cb = renew_cb
        try:
            self.epoch = int(os.environ.get("PADDLE_MEMBERSHIP_EPOCH", 0)
                             or 0)
        except ValueError:
            self.epoch = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _beat(self, exiting: bool = False):
        stamp = {"t": time.time()}
        if exiting:
            stamp["exiting"] = True
        if self.epoch:
            stamp["epoch"] = self.epoch
        if _step_provider is not None:
            try:
                step, avg = _step_provider()
                stamp["step"] = int(step)
                if avg is not None:
                    stamp["avg_step_s"] = round(avg, 6)
            except Exception:  # noqa: BLE001 — liveness must never die
                pass
        # the latest step's trace_id (PADDLE_TRACING): straggler episode
        # events cite it, so tracetop can be pointed straight at the
        # culprit's step trace; absent when tracing is off
        tid = _tracing.last_step_trace_id()
        if tid is not None:
            stamp["trace_id"] = tid
        if _aux_provider is not None:
            try:
                for k, v in (_aux_provider() or {}).items():
                    if v is not None:
                        stamp[k] = v
            except Exception:  # noqa: BLE001 — liveness must never die
                pass
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(stamp))
        os.replace(tmp, self.path)  # atomic: monitor never reads a torn file
        if self.renew_cb is not None and not exiting:
            try:
                self.renew_cb(stamp)
            except Exception:  # noqa: BLE001 — a flapping coordinator
                pass  # must never kill the liveness thread

    def start(self):
        if self._thread is not None:
            return self
        self._beat()
        # a clean exit stops the stamping thread before the interpreter's
        # teardown, which takes ~0.7 s with torch loaded and several
        # seconds on a loaded host: the last stamp says so, and the
        # monitor gives such a rank its startup grace instead of the hang
        # timeout.  atexit runs handlers last-in first-out, so this one
        # runs before those of the modules imported before it.
        atexit.register(self._on_exit)

        def loop():
            while not self._stop.wait(self.interval):
                self._beat()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _halt(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def stop(self, exiting: bool = False):
        """Stop stamping; ``exiting`` leaves a last stamp that says so
        (a clean exit on the way, as the atexit hook writes)."""
        self._halt()
        atexit.unregister(self._on_exit)
        if exiting:
            try:
                self._beat(exiting=True)
            except OSError:
                pass

    def _on_exit(self):
        if self._stop.is_set():
            return  # stopped on purpose: a silent rank reads as hung
        self._halt()
        try:
            self._beat(exiting=True)
        except OSError:
            pass


def start_heartbeat(interval: float = 1.0):
    """Trainer-side entry: start stamping if the launcher enabled
    heartbeats (PADDLE_HEARTBEAT_DIR set); no-op otherwise. Called by
    parallel.env.init_parallel_env so launched trainers get liveness
    reporting without code changes.

    When the job control plane is armed (PADDLE_COORDINATOR_ENDPOINT +
    PADDLE_LEASE_SECS), every stamp doubles as a coordinator lease
    renewal; with a coordinator but no heartbeat dir, a pure
    lease-renewal worker runs instead — either way the trainer's lease
    stays live without code changes."""
    directory = os.environ.get(ENV_DIR)
    from . import coordinator as coord_mod

    endpoint = os.environ.get(coord_mod.ENV_ENDPOINT)
    lease = coord_mod.lease_secs_from_env()
    renew_cb = None
    if endpoint and lease > 0:
        if not directory:
            # lease-only liveness: no shared filesystem needed
            return coord_mod.maybe_start_lease_worker(kind="trainer")
        client = coord_mod.CoordinatorClient(endpoint, kind="trainer")
        try:
            client.register()
        except Exception:  # noqa: BLE001 — renewals keep trying
            pass
        renew_cb = client.renew
    if not directory:
        return None
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    return HeartBeatWorker(directory, rank, interval,
                           renew_cb=renew_cb).start()


class StragglerMonitor:
    """Launcher-side straggler detection over the heartbeat channel (the
    JAX package's ``StragglerMonitor``): trainers' stamps carry (step, t)
    once fluid/monitor.py registers its step provider, and the monitor
    feeds them into telemetry/straggler.py's detector.  That detector is
    not ported yet (ROADMAP A8), so constructing one raises; the
    launcher refuses --straggler_factor and --straggler_eject_factor
    for the same reason."""

    def __init__(self, directory: str, ranks: List[Rank],
                 factor: float = 3.0, min_steps: Optional[int] = None):
        raise NotImplementedError(
            "StragglerMonitor: its detector, telemetry/straggler.py, is "
            "not ported yet (ROADMAP A8)")


class HeartBeatMonitor:
    """Launcher-side: which ranks have not stamped within `timeout`?

    A rank whose last stamp says it is exiting (a clean exit's atexit
    stamp, HeartBeatWorker) is in its interpreter's teardown, not hung:
    it is flagged only once the startup grace has passed since that
    stamp.

    A rank is only considered once it stamps AFTER this monitor was
    created: startup (imports, the first step's kernel loads) can exceed
    the window, and a leftover stamp from a previous job in a reused
    shared directory must not kill the new group before it boots. But a
    rank that NEVER produces a fresh stamp is still flagged once the
    `startup_grace` window (default 30x the heartbeat timeout) runs out —
    otherwise the exact hang class the feature targets (deadlock during
    import or the first step) would go undetected forever.
    """

    def __init__(self, directory: str, ranks: List[Rank], timeout: float,
                 startup_grace: Optional[float] = None,
                 epoch: Optional[int] = None):
        self.directory = directory
        self.ranks = list(ranks)
        self.timeout = timeout
        self.startup_grace = (
            startup_grace if startup_grace is not None
            else float(os.environ.get("PADDLE_HEARTBEAT_STARTUP_GRACE",
                                      30 * timeout))
        )
        # split-brain guard: when this monitor knows its membership
        # epoch, a stamp claiming a FUTURE epoch is not proof of life —
        # the stamper answers to a NEWER coordinator, so this (stale)
        # supervisor must not keep making liveness calls on its basis
        self.epoch = epoch
        self._t0 = time.time()
        self._since: dict = {}  # rank -> its own start, after a respawn

    def rearm(self, rank: Rank) -> None:
        """``rank``'s process was replaced (a serving replica respawned in
        place): judge it as a new member, from now, with the startup
        grace for its first stamp."""
        self._since[rank] = time.time()

    def stale_ranks(self, now: Optional[float] = None,
                    ranks: Optional[List[Rank]] = None) -> List[Rank]:
        """`ranks` narrows the check (the launcher passes only ranks whose
        process is still running — a trainer that already exited cleanly
        stops stamping and must not read as hung)."""
        now = time.time() if now is None else now
        stale = []
        for r in self.ranks if ranks is None else ranks:
            t0 = self._since.get(r, self._t0)
            try:
                mtime = os.path.getmtime(_stamp_path(self.directory, r))
            except OSError:
                mtime = None  # no stamp file yet
            if mtime is None or mtime < t0:
                # never stamped under THIS monitor: flag only after the
                # (long) startup grace window
                if now - t0 > self.startup_grace:
                    stale.append(r)
                continue
            if self.epoch is not None:
                stamp = read_stamp(self.directory, r)
                if stamp and int(stamp.get("epoch", 0)) > self.epoch:
                    stale.append(r)  # future-epoch stamp: we are stale
                    continue
            if now - mtime > self.timeout:
                stamp = read_stamp(self.directory, r)
                if (stamp and stamp.get("exiting")
                        and now - mtime <= self.startup_grace):
                    continue  # tearing down after a clean exit
                stale.append(r)
        return stale
