"""Deterministic fault injection: the part of the JAX package's
``distributed/faults.py`` that the port's call sites reach — the RPC
transport (``distributed/ps_server.py``'s ``_Conn`` and the serving
replica's ``handle``), the job coordinator (``distributed/
coordinator.py``: its verb dispatch and the member-side lease
renewals), the named code phases of the generation engine, the atomic
writes of ``fluid/io.py`` and the commit protocol of
``fluid/checkpoint.py``, sharded layout included.

Gate: the layer is active only when BOTH the FLAGS_ps_fault_injection
flag is on AND PADDLE_PS_FAULT_SPEC is non-empty. Flag-off behavior is
bit-identical to a build without this module: each point consults
`injector()` and gets None.

Spec grammar (PADDLE_PS_FAULT_SPEC) — semicolon-separated rules:

    <action>:<method>:<nth>[:<arg>]

    action  one of
            drop    client side: close the connection AFTER sending the
                    request, before reading the reply — the server has
                    (usually) handled it, the client cannot know:
                    exercises the retry + dedup path (a marked-retry
                    `generate` reattaches instead of decoding twice)
            refuse  client side: raise FaultError BEFORE sending — the
                    request never reaches the server: the plain retry
                    path
            delay   client side: sleep <arg> seconds before sending
            stall   REPEATING: every <nth>-th arrival sleeps <arg>
                    MILLISECONDS — client side, before an outgoing RPC
                    whose verb matches; or at a named code phase
                    (stall_point call sites: "gen_decode_step", between
                    decode steps in the generation engine's loop, slows
                    one replica's generation without killing it). Phase
                    names and RPC verbs never collide
            kill    server side: os._exit(1) the serving process once it
                    has handled <nth> RPCs matching the verb
            slow    server side, REPEATING: every <nth>-th handled RPC
                    matching the verb sleeps <arg> MILLISECONDS before
                    being served — the slow-tail hedge drill
            partition  server side, LATCHING: once this server has
                    handled <nth> RPCs it latches `partitioned`, which
                    the parameter server's replication reads
                    (``blocks_replication``: its ``replicate`` verb
                    refuses forwards);
                    the <method> field names the server's tag
                    (PADDLE_PS_RANK_TAG) or "*"
            crash   phase side: os._exit(1) at the Nth arrival at a
                    named code phase (crash_point(phase) call sites:
                    "gen_decode_step" kills a replica mid-decode; an
                    atomic write's `crash_phase`; the checkpoint's
                    "ckpt_tmp_written" (content written, step dir not
                    yet renamed in), "ckpt_before_commit" (step dir in
                    place, manifest not yet written),
                    "ckpt_manifest_tmp_written" (manifest tmp written,
                    not yet renamed), "ckpt_writer" (inside the async
                    writer thread, before it touches the disk),
                    "ckpt_shard_committed" (a rank's shard manifest
                    landed, its commit-barrier report not yet sent) and
                    "ckpt_before_global_commit" (every shard confirmed,
                    the global manifest not yet written); and the
                    control-plane phase "coord_verb" (the entry of every
                    coordinator verb dispatch: kills a process-hosted
                    coordinator after it handled N verbs; scope it with
                    PADDLE_PS_FAULT_TAGS=coord))
            bitflip phase side, DATA-corrupting: at the Nth arrival at a
                    named data phase (bitflip_point(phase, array) call
                    sites: "push_grad" in the PS client's push path)
                    flip ONE BIT of one element of the array flowing
                    through — the deterministic stand-in for a silent
                    data corruption. The optional <arg> is the flat
                    element index to corrupt (default 0)
            io_err  phase side: raise OSError(EIO) at the Nth arrival at
                    a named WRITE phase (io_point(phase) call sites:
                    "ckpt_content", "ckpt_manifest",
                    "ckpt_global_manifest")
            short_write  phase side: the Nth write at the matching phase
                    lands TRUNCATED (half the intended bytes) while the
                    writer believes it succeeded
            diskfull  phase side, LATCHING: from the Nth arrival at the
                    matching phase on, EVERY io_point write phase in
                    this process raises OSError(ENOSPC)
            lease_expire  member side, LATCHING: once this process has
                    attempted <nth> coordinator lease renewals, ALL
                    further renewals are swallowed client-side (the
                    coordinator never sees them and the lease runs out
                    as a silently dead host's does). The <method> field
                    names the process tag to starve ("trainer1") or
                    "*"; the process itself keeps running
            netsplit  member side, WINDOWED: once this process has
                    issued <nth> outgoing RPCs, ALL outgoing RPCs are
                    dropped (FaultError before send) for <arg>
                    MILLISECONDS, then the split heals. Lease renewals
                    ride the same client path, so a long enough window
                    also expires the member's lease. The <method> field
                    names the process tag or "*"
    method  an RPC verb name (infer, generate, ...), a phase name, or "*"
    nth     1-based index of the matching call AT THE INJECTION SITE;
            each one-shot rule fires exactly once, on its Nth match

The JAX package's oom rule (the executor's OOM doctor, ROADMAP A8)
has no call site in the port yet, and a spec naming it is refused here;
the SDC drill's ``sdc_apply`` bitflip site waits for ROADMAP A8 too.

Counting is per-process and per-rule, so the schedule is a pure function
of the arrival sequence — reruns inject the same faults at the same
points.

Process scoping: PADDLE_PS_FAULT_TAGS (comma-separated) arms the layer
only in processes whose PADDLE_PS_RANK_TAG ("ps0") or trainer id
("trainer1") is listed. The tag rules (lease_expire, netsplit) match
the process's tags: its PADDLE_PS_RANK_TAG, its launcher-stable
PADDLE_TRAINER_TAG and "trainer<PADDLE_TRAINER_ID>".
"""
from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

ENV_SPEC = "PADDLE_PS_FAULT_SPEC"
ENV_TAGS = "PADDLE_PS_FAULT_TAGS"

_CLIENT_ACTIONS = ("drop", "refuse", "delay", "stall")
_SERVER_ACTIONS = ("kill", "slow", "partition")
_PHASE_ACTIONS = ("crash",)
# data-corruption rules: fire at named DATA phases (bitflip_point call
# sites) and perturb the array flowing through instead of failing
_DATA_ACTIONS = ("bitflip",)
# disk-fault rules: fire at named WRITE phases (io_point call sites in
# the checkpoint commit protocol)
_IO_ACTIONS = ("io_err", "short_write", "diskfull")
# member-side rules matched against this process's tags, not a verb
_TAG_ACTIONS = ("lease_expire", "netsplit")
_KNOWN = (_CLIENT_ACTIONS + _SERVER_ACTIONS + _PHASE_ACTIONS
          + _DATA_ACTIONS + _IO_ACTIONS
          + _TAG_ACTIONS)
# rules of the JAX package whose call sites the port does not have yet,
# and the queue item that brings each
_NOT_PORTED = {
    "oom": "its call site is the executor's OOM doctor (ROADMAP A8)",
}


def _process_tags() -> set:
    """The identities this process answers to for tag-matched rules:
    its pserver tag ("ps0"), its launcher-stable trainer tag
    ("trainer2", PADDLE_TRAINER_TAG), and the rank-derived fallback."""
    tags = {os.environ.get("PADDLE_PS_RANK_TAG") or "",
            os.environ.get("PADDLE_TRAINER_TAG") or "",
            "trainer" + os.environ.get("PADDLE_TRAINER_ID", "")}
    tags.discard("")
    tags.discard("trainer")
    return tags


class FaultError(ConnectionError):
    """Raised by client-side `refuse`/`drop` rules; a subclass of
    ConnectionError so it flows through the exact retry path a real
    transport fault would take."""


class _Rule:
    __slots__ = ("action", "method", "nth", "arg", "count", "fired")

    def __init__(self, action: str, method: str, nth: int, arg: float):
        self.action = action
        self.method = method
        self.nth = nth
        self.arg = arg
        self.count = 0
        self.fired = False

    def matches(self, method: str) -> bool:
        return self.method in ("*", method)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_Rule({self.action}:{self.method}:{self.nth}"
                f"{':' + str(self.arg) if self.arg else ''})")


def parse_spec(spec: str) -> List[_Rule]:
    rules = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad fault rule {raw!r}: want action:method:nth[:arg]")
        action, method, nth = parts[0], parts[1], parts[2]
        if action in _NOT_PORTED:
            raise NotImplementedError(
                f"fault rule {raw!r}: the {action!r} rule is not ported: "
                f"{_NOT_PORTED[action]}")
        if action not in _KNOWN:
            raise ValueError(
                f"bad fault rule {raw!r}: unknown action {action!r} "
                f"(want one of {_KNOWN})")
        try:
            n = int(nth)
        except ValueError:
            raise ValueError(f"bad fault rule {raw!r}: nth must be an int")
        if n < 1:
            raise ValueError(f"bad fault rule {raw!r}: nth is 1-based")
        arg = float(parts[3]) if len(parts) == 4 else 0.0
        if action == "netsplit" and arg <= 0:
            raise ValueError(
                f"bad fault rule {raw!r}: netsplit needs a window — "
                f"netsplit:<tag>:<nth>:<ms>")
        if action == "stall" and arg <= 0:
            raise ValueError(
                f"bad fault rule {raw!r}: stall needs a duration — "
                f"stall:<verb|phase>:<nth>:<ms>")
        rules.append(_Rule(action, method, n, arg))
    return rules


class FaultInjector:
    """One injection schedule, shared by every caller in a process.

    Client hooks (called by ps_server._Conn.call):
      before_send(method)  — fires refuse (raises FaultError), delay, the
                             repeating stall and the netsplit window
      drop_after_send(method) -> bool — True: close the socket now

    Server hook (called by the serving replica's handle):
      on_server_call(method) — fires kill (os._exit) at the nth match,
      the repeating slow, and latches partition

    Phase hooks (called through crash_point()/stall_point()/io_point()
    at named code phases):
      at_phase(phase)       — fires crash (os._exit) on the Nth arrival
      at_stall_phase(phase) — sleeps on every nth-th arrival
      at_io_phase(phase)    — the disk faults of a write phase

    Lease hook (called by coordinator.CoordinatorClient.renew):
      on_lease_renew() -> bool — True once a lease_expire rule latched
    """

    def __init__(self, spec: str):
        self.spec = spec
        self._rules = parse_spec(spec)
        self._lock = threading.Lock()
        self.partitioned = False  # latched by a fired `partition` rule
        self.disk_full = False  # latched by a fired `diskfull` rule
        self.lease_blocked = False  # latched by a fired `lease_expire`
        self.netsplit_until = 0.0  # wall time the split heals

    def _take(self, site_actions, method: str) -> List[_Rule]:
        """Advance matching rules' counters; return the rules firing NOW."""
        firing = []
        with self._lock:
            for r in self._rules:
                if r.action not in site_actions or r.fired:
                    continue
                if not r.matches(method):
                    continue
                r.count += 1
                if r.count == r.nth:
                    r.fired = True
                    firing.append(r)
        return firing

    def _take_every(self, site_actions, method: str) -> List[_Rule]:
        """REPEATING variant (`stall`): fires on every nth-th match —
        count % nth == 0 — and never spends the rule, so 1/nth of the
        matching arrivals see the fault (a deterministic latency tail)."""
        firing = []
        with self._lock:
            for r in self._rules:
                if r.action not in site_actions:
                    continue
                if not r.matches(method):
                    continue
                r.count += 1
                if r.count % r.nth == 0:
                    firing.append(r)
        return firing

    def _take_tagged(self, action: str) -> List[_Rule]:
        """Advance rules whose <method> field names one of THIS
        process's tags (or "*") — each rule counted at most once per
        arrival even when several tags match."""
        tags = _process_tags()
        firing = []
        with self._lock:
            for r in self._rules:
                if r.action != action or r.fired:
                    continue
                if not (r.method == "*" or r.method in tags):
                    continue
                r.count += 1
                if r.count == r.nth:
                    r.fired = True
                    firing.append(r)
        return firing

    # -- client side -----------------------------------------------------
    def before_send(self, method: str) -> None:
        # netsplit rules count every outgoing RPC from a tagged process;
        # firing opens a drop window during which ALL sends fail the way
        # a severed link fails them (the renewal path included)
        now = time.time()
        for r in self._take_tagged("netsplit"):
            with self._lock:
                self.netsplit_until = max(self.netsplit_until,
                                          now + r.arg / 1000.0)
            os.write(2, (f"[faults] netsplit: pid {os.getpid()} dropping "
                         f"all RPCs for {r.arg:.0f}ms (rule netsplit:"
                         f"{r.method}:{r.nth})\n").encode())
        if now < self.netsplit_until:
            raise FaultError(
                f"fault injection: netsplit — {method!r} RPC dropped "
                f"({self.netsplit_until - now:.3f}s until the window "
                f"heals)")
        for r in self._take_every(("stall",), method):
            time.sleep(r.arg / 1000.0)  # arg is MILLISECONDS, repeating
        for r in self._take(("refuse", "delay"), method):
            if r.action == "delay":
                time.sleep(r.arg)
            else:
                raise FaultError(
                    f"fault injection: refused {method!r} RPC "
                    f"(rule {r.action}:{r.method}:{r.nth})")

    def drop_after_send(self, method: str) -> bool:
        return bool(self._take(("drop",), method))

    # -- server side -----------------------------------------------------
    def on_server_call(self, method: str) -> None:
        for r in self._take(("kill",), method):
            # hard death, no cleanup: the supervision + failover story
            # must recover from exactly this
            os.write(2, (f"[faults] killing server pid {os.getpid()} "
                         f"at {time.time():.6f} "
                         f"(rule kill:{r.method}:{r.nth})\n").encode())
            self._flight("kill")
            os._exit(1)
        for r in self._take_every(("slow",), method):
            time.sleep(r.arg / 1000.0)  # arg is MILLISECONDS
        # partition rules match the server's TAG, not the RPC verb, and
        # count every handled RPC; once fired the injector latches
        tag = os.environ.get("PADDLE_PS_RANK_TAG", "")
        for r in self._take(("partition",), tag):
            os.write(2, (f"[faults] partitioning server {tag or '?'} pid "
                         f"{os.getpid()} (rule partition:{r.method}:"
                         f"{r.nth})\n").encode())
            with self._lock:
                self.partitioned = True

    # -- lease side ------------------------------------------------------
    def blocks_replication(self) -> bool:
        """True once a `partition` rule fired: this server must reject
        `replicate` forwards (reachable-but-stale backup)."""
        return self.partitioned

    # -- data-corruption side ----------------------------------------------
    def at_bitflip_phase(self, phase: str, array):
        """Consulted at named DATA phases (bitflip_point call sites):
        a `bitflip:<phase>:<nth>[:<elem>]` rule returns a COPY of the
        array with one bit of one element flipped (float32/float64: the
        high exponent bit, so the corruption is loud in any norm;
        integer dtypes: the low bit). No matching rule: the array is
        returned untouched, same object."""
        rules = self._take(("bitflip",), phase)
        if not rules:
            return array
        import numpy as np

        a = np.array(array, copy=True)
        flat = a.reshape(-1)
        for r in rules:
            if flat.size == 0:
                continue
            idx = int(r.arg) % flat.size
            if a.dtype == np.float32:
                u = flat.view(np.uint32)
                u[idx] ^= np.uint32(1 << 30)
            elif a.dtype == np.float64:
                u = flat.view(np.uint64)
                u[idx] ^= np.uint64(1 << 62)
            else:
                # any other dtype: flip the low bit of the element's
                # first byte through the raw view
                b = a.view(np.uint8).reshape(a.size, a.itemsize)
                b[idx, 0] ^= np.uint8(1)
            os.write(2, (f"[faults] bitflip at phase {phase!r}: "
                         f"element {idx} corrupted in pid "
                         f"{os.getpid()} (rule bitflip:{r.method}:"
                         f"{r.nth})\n").encode())
        return a

    def on_lease_renew(self) -> bool:
        """Counts one coordinator lease-renewal ATTEMPT from this
        process; True once a matching `lease_expire` rule has latched —
        the caller (CoordinatorClient.renew) then swallows the renewal
        so the lease expires while the process stays alive."""
        for r in self._take_tagged("lease_expire"):
            os.write(2, (f"[faults] lease_expire: pid {os.getpid()} "
                         f"swallowing all lease renewals from now on "
                         f"(rule lease_expire:{r.method}:{r.nth})\n"
                         ).encode())
            with self._lock:
                self.lease_blocked = True
        return self.lease_blocked

    @staticmethod
    def _flight(reason: str) -> None:
        """Best-effort flight-recorder dump before an os._exit — the
        atexit/excepthook triggers never run for a hard death, so the
        crash rule dumps the span ring itself. No-op unless
        PADDLE_TRACING + PADDLE_TRACE_DIR are armed."""
        try:
            from ..telemetry import tracing

            tracing.flight_dump(reason)
        except Exception:  # noqa: BLE001 — the death must still happen
            pass

    def at_phase(self, phase: str) -> None:
        for r in self._take(("crash",), phase):
            # hard death, no cleanup: the recovery story must start from
            # exactly this
            os.write(2, (f"[faults] crashing pid {os.getpid()} at phase "
                         f"{phase!r} (rule crash:{r.method}:{r.nth})\n"
                         ).encode())
            self._flight(f"crash:{phase}")
            os._exit(1)

    def at_stall_phase(self, phase: str) -> None:
        """REPEATING delay at a named code phase (stall_point call
        sites): every nth-th arrival sleeps <arg> milliseconds."""
        for r in self._take_every(("stall",), phase):
            time.sleep((r.arg or 0) / 1000.0)

    def at_io_phase(self, phase: str) -> bool:
        """Consulted at named checkpoint WRITE phases (io_point call
        sites). Raises OSError for `io_err` (one EIO at the Nth match)
        and `diskfull` (ENOSPC from the Nth match on — latched: a full
        disk fails every later write too); returns True when a
        `short_write` rule fired and the caller must truncate the bytes
        it is about to write."""
        import errno

        for r in self._take(("diskfull",), phase):
            os.write(2, (f"[faults] disk full from phase {phase!r} on "
                         f"(rule diskfull:{r.method}:{r.nth})\n").encode())
            with self._lock:
                self.disk_full = True
        if self.disk_full:
            raise OSError(errno.ENOSPC,
                          f"fault injection: no space left on device "
                          f"(phase {phase!r})")
        for r in self._take(("io_err",), phase):
            raise OSError(errno.EIO,
                          f"fault injection: I/O error at phase "
                          f"{phase!r} (rule io_err:{r.method}:{r.nth})")
        short = bool(self._take(("short_write",), phase))
        if short:
            os.write(2, (f"[faults] short write at phase {phase!r}\n"
                         ).encode())
        return short


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def injector() -> Optional[FaultInjector]:
    """The process-wide injector, or None when the layer is off (the
    common case: one flag read + one env read, no state)."""
    from ..fluid import flags

    if not flags.flag("FLAGS_ps_fault_injection"):
        return None
    spec = os.environ.get(ENV_SPEC, "")
    if not spec.strip():
        return None
    tags = os.environ.get(ENV_TAGS, "").strip()
    if tags:
        # scoped arming: only processes named in PADDLE_PS_FAULT_TAGS
        # ("ps0", "trainer1") see the schedule
        mine = {os.environ.get("PADDLE_PS_RANK_TAG") or "",
                "trainer" + os.environ.get("PADDLE_TRAINER_ID", "")}
        wanted = {t.strip() for t in tags.split(",") if t.strip()}
        if not (wanted & mine):
            return None
    global _injector
    with _injector_lock:
        if _injector is None or _injector.spec != spec:
            _injector = FaultInjector(spec)
        return _injector


def crash_point(phase: str) -> None:
    """Deterministic kill site: os._exit(1) if an armed crash rule
    matches this phase on this arrival. One flag read when the layer is
    off."""
    inj = injector()
    if inj is not None:
        inj.at_phase(phase)


def stall_point(phase: str) -> None:
    """Deterministic mid-phase delay site: a REPEATING
    `stall:<phase>:<nth>:<ms>` rule sleeps at every nth-th arrival at
    this phase — e.g. "gen_decode_step" in the serving decode loop
    slows one replica's generation without killing it. One flag read
    when the layer is off."""
    inj = injector()
    if inj is not None:
        inj.at_stall_phase(phase)


def io_point(phase: str) -> bool:
    """Deterministic disk-fault site at a named write phase: may raise
    OSError (`io_err`, `diskfull`); returns True when the caller must
    simulate a short write (truncate the bytes). One flag read when the
    layer is off."""
    inj = injector()
    if inj is None:
        return False
    return inj.at_io_phase(phase)


def bitflip_point(phase: str, array):
    """Deterministic data-corruption site at a named data phase: a
    matching `bitflip:<phase>:<nth>[:<elem>]` rule returns a copy of
    `array` with one bit of one element flipped; otherwise the array
    passes through untouched. One flag read when the layer is off —
    the data plane pays nothing in production."""
    inj = injector()
    if inj is None:
        return array
    return inj.at_bitflip_phase(phase, array)


def reset() -> None:
    """Drop the cached injector (tests: fresh counters per case)."""
    global _injector
    with _injector_lock:
        _injector = None
