"""Multi-process launcher: `python -m paddle_tpu_torch.distributed.launch
[--nproc_per_node N] [--ips a,b] train.py args...`

Ported from the JAX package's ``distributed/launch.py`` (trainer mode).
Parity surface: reference python/paddle/distributed/launch.py:193 +
utils.py (get_cluster:230, start_local_trainers:340,
watch_local_trainers:407 — abort the whole job when any child dies).

Env protocol per trainer (the JAX launcher's, consumed by
parallel/env.py): PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT, the stable identity
PADDLE_TRAINER_TAG, PADDLE_MEMBERSHIP_EPOCH and PADDLE_ELASTIC_RESTART
(the attempt number), PADDLE_HEARTBEAT_DIR when liveness is armed, and
PADDLE_CKPT_BARRIER_ENDPOINT (the sharded checkpoints' commit barrier)
for a multi-rank job.  The port adds PADDLE_DIST_RENDEZVOUS: a FileStore
of this launcher's own for each attempt, under a directory it removes
at exit, where the process group meets.  A relaunched group never
meets the store of the attempt before it (its dead ranks, or a TCP port
still in TIME_WAIT), and launchers that share a host never collide.

Supervision: any nonzero exit aborts the whole local group at once —
the survivors would otherwise block in a collective until their
process-group timeout — and the next attempt starts only once every
process of the old one is gone.  --heartbeat_timeout turns a stale
heartbeat stamp into the same abort (a hang), and --lease_secs arms the
coordinator (distributed/coordinator.py): renewals ride the stamps, an
expired trainer lease is a hang, and per-rank budgets
(--elastic_retries_per_rank) evict a rank that keeps failing, after
which the survivors restart re-ranked at the smaller world size with
PADDLE_ELASTIC_RESHARD=1 (--min_world_size bounds it).
PADDLE_COORD_SNAPSHOT_SECS or --coordinator_standby move the coordinator
into a supervised child process with durable state (and a warm
standby).

Preemption: SIGTERM to the LAUNCHER is forwarded to every trainer and
the job gets --sigterm_grace seconds to finish its final checkpoints
(fluid/checkpoint.py training loops honor the signal at the next step
boundary) before being terminated. A SIGTERM'd TRAINER that
checkpointed exits with PREEMPTED_EXIT_CODE (75); like any nonzero exit
it consumes one --elastic_retries attempt, and the respawned trainer
auto-resumes from the latest valid checkpoint (Model.fit(resume=...)).

Parameter servers (reference launch_ps.py): --server_num N spawns N
pserver processes (``python -m paddle_tpu_torch.distributed.ps_server``,
host memory only: each runs with CUDA_VISIBLE_DEVICES empty, so it can
never initialize the card) on free ports, or --servers names them, and
PADDLE_PSERVERS_IP_PORT_LIST carries the list to the trainers.  They
outlive elastic restarts, snapshot their tables (--ps_snapshot_secs,
--ps_snapshot_mode; PADDLE_PS_SNAPSHOT_DIR adopts a previous job's), are
respawned in place from the snapshots by ``PServerSupervisor`` within
the --elastic_retries budget, and with --ps_replication R keep R copies
of every row partition; under --lease_secs each pserver holds a lease
whose expiry makes the coordinator promote a caught-up backup.

Serving (--serve): the positional argument is a saved inference-model
directory and each trainer slot runs one replica, ``python -m
paddle_tpu_torch.inference.server --model_dir DIR ARGS...``, bound to
the port of its PADDLE_CURRENT_ENDPOINT (--serve_kv_cache and
--serve_kv_pages ride in as PADDLE_SERVE_KV_CACHE / _PAGES).  Replicas
are independent, so a dead one is respawned IN PLACE on its endpoint by
``ServeRespawner`` within the per-replica budget while the others keep
serving; past it the death takes the group-abort path above.  The
respawn never inherits the fault schedule (PADDLE_PS_FAULT_SPEC) or
its dead predecessor's heartbeat stamp.

Not ported yet, refused with NotImplementedError naming the queue item:
--fleetz_port, --debugz_port, --trace_dir, --straggler_factor and
--straggler_eject_factor, and the goodput ledger PADDLE_GOODPUT arms
(ROADMAP A8: telemetry/debugz, timeline, straggler and goodput's
launcher ledger with its fleet exporter).
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from ..parallel.env import ENV_RENDEZVOUS

# fluid/checkpoint.py's: a trainer SIGTERM'd after its final checkpoint
# exits with it (sysexits EX_TEMPFAIL, "retry me")
PREEMPTED_EXIT_CODE = 75

SERVE_MODULE = "paddle_tpu_torch.inference.server"


class Trainer:
    def __init__(self, rank: int, endpoint: str, tag: Optional[str] = None):
        self.rank = rank
        self.endpoint = endpoint
        # stable membership identity: ranks are RE-NUMBERED when an
        # elastic resize shrinks the world, tags are not — per-rank
        # restart budgets and the coordinator's lease table key on tags
        self.tag = tag if tag is not None else f"trainer{rank}"
        self.proc: Optional[subprocess.Popen] = None
        self.log = None
        # host time of the exit, set by a reaper thread: when one rank
        # dies its peers fail in their next collective a moment later,
        # and the first to exit is the culprit
        self.exit_ts: Optional[float] = None


class PServer:
    """One supervised pserver child: the respawn identity (idx, host,
    bound port) needed to restart it in place."""

    def __init__(self, idx: int, host: str, port: int,
                 proc: subprocess.Popen):
        self.idx = idx
        self.host = host
        self.port = port  # bound port — respawns MUST rebind it
        self.proc = proc

    @property
    def tag(self) -> str:
        # heartbeat identity (distributed/heartbeat.py: pservers stamp
        # as "ps<idx>", never colliding with integer trainer ranks)
        return f"ps{self.idx}"


def _reap(t: Trainer) -> None:
    t.proc.wait()
    t.exit_ts = time.time()


def get_cluster(ips: List[str], nproc_per_node: int, start_port: int):
    """[(rank, ip:port)] across all nodes (reference utils.get_cluster)."""
    out = []
    rank = 0
    for ip in ips:
        for i in range(nproc_per_node):
            out.append(Trainer(rank, f"{ip}:{start_port + i}"))
            rank += 1
    return out


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="spawn and watch per-node trainer processes",
    )
    p.add_argument("--ips", "--cluster_node_ips", default="127.0.0.1",
                   help="comma-separated node ips (this script runs on each)")
    p.add_argument("--node_ip", default=None,
                   help="this node's ip (default: first of --ips)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--log_dir", default=None)
    p.add_argument(
        "--elastic_retries", type=int, default=0,
        help="JOB-LEVEL cap on trainer-group restarts (trainers resume "
        "from their own checkpoints; PADDLE_ELASTIC_RESTART carries the "
        "attempt number), and restart budget for dead pservers "
        "(snapshot recovery). 0 = reference behavior: fail fast "
        "(utils.py:407) — unless --elastic_retries_per_rank arms the "
        "control plane on its own",
    )
    p.add_argument(
        "--elastic_retries_per_rank", type=int, default=None,
        help="PER-RANK restart budget (default: = --elastic_retries). "
        "A rank that fails MORE times than its budget is EVICTED from "
        "the membership instead of burning the job: the coordinator "
        "bumps the membership epoch and the surviving ranks restart "
        "from the last checkpoint at the REDUCED world size (elastic "
        "resize; needs PADDLE_ELASTIC_RESHARD-aware checkpoints). A "
        "permanently-lost host therefore costs its own budget, not the "
        "whole fleet's",
    )
    p.add_argument(
        "--min_world_size", type=int, default=1,
        help="abort instead of resizing below this many trainers",
    )
    p.add_argument(
        "--lease_secs", type=float, default=None,
        help="arm the lease-based job control plane "
        "(distributed/coordinator.py): the launcher hosts a membership "
        "coordinator, heartbeat stamps become lease renewals "
        "(PADDLE_COORDINATOR_ENDPOINT / PADDLE_LEASE_SECS exported to "
        "every child), a trainer lease expired for 2 periods is "
        "treated like a hang (kill + per-rank budget), and an expired "
        "PSERVER primary lease promotes a caught-up backup directly — "
        "no client in the loop. Default: PADDLE_LEASE_SECS if set, "
        "else off",
    )
    p.add_argument(
        "--coordinator_standby", action="store_true",
        help="control-plane HA: spawn a WARM-STANDBY "
        "coordinator beside the durable primary. The standby follows "
        "the primary's snapshot+WAL stream (repl_pull) and promotes "
        "itself when the primary's incarnation lease lapses; clients "
        "hold the ordered endpoint list (primary,standby) and fail "
        "over, with split-brain fenced by the incarnation number. "
        "Implies the process-hosted durable coordinator (as does "
        "setting PADDLE_COORD_SNAPSHOT_SECS); requires --lease_secs",
    )
    p.add_argument(
        "--straggler_eject_factor", type=float, default=0.0,
        help="EJECT (kill + per-rank budget, reason 'straggler "
        "ejection') a trainer whose step time exceeds this multiple of "
        "the median across ranks — the enforcement sibling of the "
        "diagnosis-only --straggler_factor. 0 = off",
    )
    p.add_argument(
        "--sigterm_grace", type=float, default=30.0,
        help="seconds the job gets to checkpoint after the launcher "
        "receives SIGTERM (forwarded to every trainer; training loops "
        "with a CheckpointManager write a final checkpoint and exit). "
        "After the grace window remaining trainers are terminated",
    )
    p.add_argument(
        "--heartbeat_timeout", type=float, default=0.0,
        help="treat a trainer as hung when its heartbeat file "
        "(distributed/heartbeat.py; stamped by init_parallel_env) goes "
        "stale for this many seconds — catches collective deadlocks that "
        "never exit. 0 = off",
    )
    p.add_argument(
        "--straggler_factor", type=float, default=0.0,
        help="log a structured `straggler` event when a trainer's step "
        "time exceeds this multiple of the median across ranks (step "
        "rates ride the heartbeat stamps; fluid/monitor.py publishes "
        "them automatically). Diagnosis only — the job keeps running. "
        "0 = off",
    )
    p.add_argument(
        "--trace_dir", default=None,
        help="collect per-process traces: trainers record host spans "
        "(PADDLE_TRACE_DIR contract, fluid/profiler.py) and dump "
        "trace.<rank>.json here at exit; causal step tracing "
        "(telemetry/tracing.py) is armed in every child — pservers and "
        "the coordinator dump span lanes + flightrec.<tag>.json flight "
        "records here too (tools/tracetop.py merges those into per-round "
        "critical paths). After the job the launcher merges everything "
        "into <trace_dir>/timeline.json (pid=rank — open in Perfetto / "
        "chrome://tracing)",
    )
    p.add_argument(
        "--fleetz_port", type=int, default=None,
        help="arm the FLEET goodput view (telemetry/goodput.py): "
        "every child classifies its wall-clock into a goodput/badput "
        "ledger (PADDLE_GOODPUT=1) and ships a bounded metrics "
        "snapshot + ledger summary on each lease renewal "
        "(PADDLE_FLEET_METRICS=1); the launcher serves debugz on THIS "
        "port with /fleetz (per-rank rollup, job goodput %%, worst "
        "incidents) and /fleetz/metrics (fleet-wide Prometheus "
        "exposition, per-rank labels — scrape ONE endpoint instead of "
        "N). Implies --lease_secs 5 when the lease plane is off. "
        "Default: PADDLE_FLEETZ_PORT if set, else off",
    )
    p.add_argument(
        "--debugz_port", type=int, default=None,
        help="arm every trainer's live introspection server "
        "(telemetry/debugz.py: /metrics /statusz /steps /proftop "
        "/healthz) with deterministic per-rank ports: rank r serves on "
        "debugz_port + r. Default: PADDLE_DEBUGZ_PORT if set (same "
        "offset rule), else off",
    )
    p.add_argument(
        "--server_num", type=int, default=0,
        help="spawn N local parameter-server processes "
        "(distributed/ps_server.py) on free ports and export "
        "PADDLE_PSERVERS_IP_PORT_LIST to the trainers (reference "
        "launch_ps.py). Servers outlive elastic restarts, so hosted "
        "tables survive a trainer-group respawn",
    )
    p.add_argument(
        "--servers", default="",
        help="explicit pserver endpoint list host:port,... — endpoints "
        "whose host matches this node are spawned here; the full list "
        "is exported to trainers (multi-node PS). Overrides --server_num",
    )
    p.add_argument(
        "--ps_snapshot_secs", type=float, default=None,
        help="pserver snapshot interval (atomic per-table state_dict "
        "pickles a supervised restart recovers from). Default: "
        "PADDLE_PS_SNAPSHOT_SECS if set, else 1.0 when --elastic_retries "
        "> 0 (supervision without snapshots would restart pservers "
        "EMPTY), else 0 (off)",
    )
    p.add_argument(
        "--ps_snapshot_mode", default=None,
        choices=[None, "full", "incremental"],
        help="pserver snapshot format: 'full' rewrites every table each "
        "tick (the default); 'incremental' writes a periodic base plus "
        "checksummed dirty-row delta files — O(touched rows) per tick, "
        "which makes sub-second --ps_snapshot_secs viable on multi-GB "
        "tables. Default: PADDLE_PS_SNAPSHOT_MODE if set, else full",
    )
    p.add_argument(
        "--ps_replication", type=int, default=None,
        help="replication factor R for hosted PS tables: each row "
        "partition gets a primary pserver plus R-1 prefix-consistent "
        "backups on distinct pservers (needs --server_num >= R). "
        "Trainers fail over to a backup when a primary dies — no "
        "respawn-wait — and hedge slow reads to backups; the supervisor "
        "respawn then rejoins via anti-entropy resync. Default: "
        "PADDLE_PS_REPLICATION if set, else 1 (today's unreplicated "
        "data plane)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="SERVING mode (inference/server.py): the "
        "positional argument is a saved inference-model dir, and each "
        "'trainer' slot runs one serving replica bound to its cluster "
        "endpoint (started_port + rank). The whole supervision stack "
        "applies unchanged — heartbeats, per-rank restart budgets, "
        "elastic respawn, --lease_secs lease renewals (kind="
        "'inference'), SIGTERM graceful drain — and extra args after "
        "the model dir pass through to the server (--max_batch, "
        "--queue_depth, ...)",
    )
    p.add_argument(
        "--serve_kv_cache", choices=["0", "1"], default=None,
        help="serving replicas: force the paged-KV generation path on "
        "(1) or off (0, the r19 padded recompute baseline) — exported "
        "as PADDLE_SERVE_KV_CACHE to every replica",
    )
    p.add_argument(
        "--serve_kv_pages", type=int, default=None,
        help="serving replicas: KV pool size in pages per replica "
        "(PADDLE_SERVE_KV_PAGES; default sizes from the HBM budget)",
    )
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """The flags and environment of the JAX launcher whose machinery the
    port has not yet: NotImplementedError naming the queue item."""
    armed = []
    a8 = (("fleetz_port", "the fleet view, telemetry/debugz.py"),
          ("debugz_port", "telemetry/debugz.py"),
          ("trace_dir", "per-rank traces, telemetry/timeline.py"))
    for flag, what in a8:
        if getattr(args, flag) is not None:
            armed.append(f"--{flag} ({what}, ROADMAP A8)")
    for flag in ("straggler_factor", "straggler_eject_factor"):
        if getattr(args, flag) > 0:
            armed.append(f"--{flag} (telemetry/straggler.py, ROADMAP A8)")
    for var, what in (("PADDLE_FLEETZ_PORT", "the fleet view"),
                      ("PADDLE_DEBUGZ_PORT", "telemetry/debugz.py"),
                      ("PADDLE_GOODPUT", "the goodput launcher ledger")):
        if os.environ.get(var, "") not in ("", "0", "false"):
            armed.append(f"{var} ({what}, ROADMAP A8)")
    if armed:
        raise NotImplementedError(
            "launch: not ported yet: " + "; ".join(armed))


def _spawn_pserver(idx: int, host: str, port: int,
                   log_dir: Optional[str] = None,
                   snapshot_root: Optional[str] = None,
                   snapshot_secs: float = 0.0,
                   preload_snapshots: bool = False,
                   heartbeat_dir: Optional[str] = None,
                   log_mode: str = "w",
                   clear_fault_spec: bool = False) -> subprocess.Popen:
    """Fork one pserver child and wait for its bound-port banner; the
    caller learns the bound port via proc.ps_bound_port. Snapshots live
    in a PER-SERVER subdir of snapshot_root — each server hosts its own
    row PARTITION of a table under the same name, and a shared dir would
    let server 1's respawn silently preload server 0's rows whenever the
    partition geometries coincide. Respawns pass the original port and
    preload_snapshots=True (recovery)."""
    env = dict(os.environ)
    env["PADDLE_TRAINING_ROLE"] = "PSERVER"
    env["PADDLE_PS_RANK_TAG"] = f"ps{idx}"
    # a pserver holds its tables in host memory by design: it never sees
    # the card, so it can never initialize CUDA there
    env["CUDA_VISIBLE_DEVICES"] = ""
    if clear_fault_spec:
        # a RESPAWNED pserver must not replay the deterministic fault
        # schedule from RPC-count zero — a `kill:*:N` drill means "kill
        # this server once", not "kill every incarnation", which would
        # burn the whole restart budget on one rule
        env.pop("PADDLE_PS_FAULT_SPEC", None)
    if heartbeat_dir:
        env["PADDLE_HEARTBEAT_DIR"] = heartbeat_dir
    snap = os.path.join(snapshot_root, f"ps{idx}") if snapshot_root else None
    cmd = [sys.executable, "-u", "-m",
           "paddle_tpu_torch.distributed.ps_server",
           "--port", str(port), "--host", host]
    if preload_snapshots and snap:
        cmd += ["--preload_dir", snap]
    if snap and snapshot_secs > 0:
        cmd += ["--snapshot_dir", snap,
                "--snapshot_secs", str(snapshot_secs)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()  # "[ps_server] listening on h:p"
    if "listening on" not in line:
        proc.kill()
        raise RuntimeError(f"pserver {idx} failed to start: {line!r}")
    proc.ps_bound_port = int(line.rsplit(":", 1)[1])
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log = open(os.path.join(log_dir, f"serverlog.{idx}"), log_mode)
        log.write(line)

        def drain(p=proc, f=log):
            for ln in p.stdout:
                f.write(ln)
            f.close()
    else:
        def drain(p=proc):
            for _ in p.stdout:
                pass

    threading.Thread(target=drain, daemon=True).start()
    return proc


def start_pservers(server_num: int, servers: str, node_ip: str,
                   log_dir: Optional[str] = None,
                   snapshot_dir: Optional[str] = None,
                   snapshot_secs: float = 0.0,
                   heartbeat_dir: Optional[str] = None,
                   adopt_snapshots: bool = False):
    """Spawn this node's pserver processes (reference launch_ps.py
    start_procs). Returns (List[PServer], full_endpoint_list).
    --server_num spawns on launcher-chosen free ports (the child binds
    port 0 and reports the bound port on stdout, so there is no
    pick-then-bind race); --servers spawns the endpoints whose host is
    this node. adopt_snapshots (stable PADDLE_PS_SNAPSHOT_DIR): preload
    each server's snapshot partition on FIRST spawn, not just respawn —
    a new job adopts a previous job's tables."""
    pservers: List[PServer] = []

    def spawn(port: int, host: str, idx: int) -> int:
        proc = _spawn_pserver(idx, host, port, log_dir=log_dir,
                              snapshot_root=snapshot_dir,
                              snapshot_secs=snapshot_secs,
                              preload_snapshots=adopt_snapshots,
                              heartbeat_dir=heartbeat_dir)
        pservers.append(PServer(idx, host, proc.ps_bound_port, proc))
        return proc.ps_bound_port

    try:
        if servers:
            eps = [e.strip() for e in servers.split(",") if e.strip()]
            for i, ep in enumerate(eps):
                host, port = ep.rsplit(":", 1)
                if host in (node_ip, "127.0.0.1", "localhost"):
                    spawn(int(port), host, i)
            endpoints = eps
        else:
            endpoints = []
            for i in range(server_num):
                bound = spawn(0, "127.0.0.1", i)
                endpoints.append(f"127.0.0.1:{bound}")
    except BaseException:
        # partial startup must not orphan the servers already running
        terminate_pservers(pservers)
        raise
    return pservers, endpoints


def terminate_pservers(pservers: List[PServer]):
    for p in pservers:
        if p.proc.poll() is None:
            p.proc.terminate()
    for p in pservers:
        try:
            p.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.proc.kill()


class PServerSupervisor:
    """Poll pserver children and respawn the dead ones in place (same
    host:port — trainers hold the endpoint list; their RPC retry loop
    rides out the gap). Recovery state comes from the snapshot dir: the
    respawn preloads the latest atomic snapshot, and trainers that find
    their table missing re-create it (RemoteTable._call), restoring the
    Downpour bounded-staleness contract instead of losing the job.

    A shared restart budget (--elastic_retries) bounds flapping; with
    heartbeats enabled, a pserver process that freezes (stamps stale) is
    killed and handled through the same respawn path."""

    def __init__(self, pservers: List[PServer], retries: int,
                 log_dir: Optional[str], snapshot_dir: Optional[str],
                 snapshot_secs: float, heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0):
        self.pservers = pservers
        self.retries_left = int(retries)
        self.log_dir = log_dir
        self.snapshot_dir = snapshot_dir
        self.snapshot_secs = snapshot_secs
        self.heartbeat_dir = heartbeat_dir
        self.aborted = False  # budget gone: no point restarting trainers
        self.monitor = None
        if heartbeat_dir and heartbeat_timeout > 0:
            from .heartbeat import HeartBeatMonitor

            self.monitor = HeartBeatMonitor(
                heartbeat_dir, [p.tag for p in pservers], heartbeat_timeout)

    def check(self) -> Optional[int]:
        """None = all healthy (possibly after respawns); an int = abort
        the job with that exit code (restart budget exhausted)."""
        if self.monitor is not None:
            running = [p for p in self.pservers if p.proc.poll() is None]
            stale = set(self.monitor.stale_ranks(
                ranks=[p.tag for p in running]))
            for p in running:
                if p.tag in stale:
                    print(f"[launch] pserver {p.idx} ({p.host}:{p.port}) "
                          f"stopped heartbeating (frozen?); killing it "
                          f"for respawn", file=sys.stderr)
                    p.proc.kill()
                    p.proc.wait()
        for p in self.pservers:
            rc = p.proc.poll()
            if rc is None:
                continue
            if self.retries_left <= 0:
                print(f"[launch] pserver {p.idx} ({p.host}:{p.port}) "
                      f"exited with {rc} and no restarts remain; "
                      f"aborting the job", file=sys.stderr)
                self.aborted = True
                return rc if rc != 0 else 1
            self.retries_left -= 1
            print(f"[launch] pserver {p.idx} ({p.host}:{p.port}) exited "
                  f"with {rc}; restarting it on the same port "
                  f"(snapshot recovery, {self.retries_left} restarts "
                  f"left)", file=sys.stderr)
            try:
                p.proc = _spawn_pserver(
                    p.idx, p.host, p.port, log_dir=self.log_dir,
                    snapshot_root=self.snapshot_dir,
                    snapshot_secs=self.snapshot_secs,
                    preload_snapshots=True,
                    heartbeat_dir=self.heartbeat_dir, log_mode="a",
                    clear_fault_spec=True)
            except RuntimeError as e:
                print(f"[launch] pserver {p.idx} respawn failed: {e}; "
                      f"aborting the job", file=sys.stderr)
                self.aborted = True
                return 1
        return None


def _spawn_coordinator(host: str, port: int, state_dir: Optional[str],
                       lease_secs: float, per_rank: int,
                       snapshot_secs: float,
                       log_dir: Optional[str] = None,
                       standby_of: Optional[str] = None,
                       log_mode: str = "w",
                       clear_fault_spec: bool = False) -> subprocess.Popen:
    """Fork one process-hosted coordinator (durable control
    plane) and wait for its bound-port banner — the _spawn_pserver
    idiom: first spawns bind port 0 and report the bound port; respawns
    pass the original port so clients reconnect in place. The caller
    learns the port via proc.coord_bound_port."""
    env = dict(os.environ)
    role = "standby" if standby_of else "primary"
    # fault tag-scoping identity: PADDLE_PS_FAULT_TAGS=coord arms kill/
    # crash rules in the PRIMARY only (the standby answers to
    # coord-standby)
    env["PADDLE_PS_RANK_TAG"] = ("coord-standby" if standby_of
                                 else "coord")
    # the coordinator must not hold a lease on itself
    env.pop("PADDLE_COORDINATOR_ENDPOINT", None)
    env.pop("PADDLE_CKPT_BARRIER_ENDPOINT", None)
    if clear_fault_spec:
        # same rule as pserver respawns: a `crash:coord_verb:N` drill
        # means "crash the coordinator once", not every incarnation
        env.pop("PADDLE_PS_FAULT_SPEC", None)
    cmd = [sys.executable, "-u", "-m",
           "paddle_tpu_torch.distributed.coordinator",
           "--host", host, "--port", str(port),
           "--lease_secs", str(lease_secs),
           "--retries_per_rank", str(per_rank),
           "--snapshot_secs", str(snapshot_secs)]
    if state_dir:
        cmd += ["--state_dir", state_dir]
    if standby_of:
        cmd += ["--standby_of", standby_of]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()  # "[coordinator] listening on h:p"
    if "listening on" not in line:
        proc.kill()
        raise RuntimeError(
            f"{role} coordinator failed to start: {line!r}")
    proc.coord_bound_port = int(line.rsplit(":", 1)[1])
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log = open(os.path.join(log_dir, f"coordlog.{role}"), log_mode)
        log.write(line)

        def drain(p=proc, f=log):
            for ln in p.stdout:
                f.write(ln)
            f.close()
    else:
        def drain(p=proc):
            for _ in p.stdout:
                pass

    threading.Thread(target=drain, daemon=True).start()
    return proc


class CoordinatorSupervisor:
    """Respawn a dead process-hosted coordinator in place — same port,
    same state dir, so the durable snapshot+WAL make the respawn resume
    exactly where the dead one stopped (bumped incarnation,
    reconciliation window armed). The budget is --elastic_retries; a
    coordinator dead past its budget does NOT abort the job: the data
    plane keeps training in grace mode, and a warm standby (when armed)
    promotes itself."""

    def __init__(self, children: dict, retries: int):
        # children: role -> spawn record (proc + the _spawn_coordinator
        # kwargs needed to respawn it in place)
        self.children = children
        self.retries_left = int(retries)

    def check(self) -> None:
        for role, ent in self.children.items():
            proc = ent.get("proc")
            if proc is None or proc.poll() is None:
                continue
            rc = proc.poll()
            if self.retries_left <= 0:
                if not ent.get("dead_reported"):
                    ent["dead_reported"] = True
                    print(f"[launch] {role} coordinator exited with "
                          f"{rc} and no restarts remain; clients stay "
                          f"in grace mode"
                          + (" (warm standby will promote itself)"
                             if len(self.children) > 1
                             and role == "primary" else ""),
                          file=sys.stderr)
                ent["proc"] = None
                continue
            self.retries_left -= 1
            print(f"[launch] {role} coordinator (port {ent['port']}) "
                  f"exited with {rc}; respawning on the same port from "
                  f"its durable state ({self.retries_left} restarts "
                  f"left)", file=sys.stderr)
            try:
                ent["proc"] = _spawn_coordinator(
                    ent["host"], ent["port"], ent["state_dir"],
                    ent["lease_secs"], ent["per_rank"],
                    ent["snapshot_secs"], log_dir=ent.get("log_dir"),
                    standby_of=ent.get("standby_of"), log_mode="a",
                    clear_fault_spec=True)
            except RuntimeError as e:
                print(f"[launch] {role} coordinator respawn failed: "
                      f"{e}; clients stay in grace mode",
                      file=sys.stderr)
                ent["proc"] = None


class SigtermGrace:
    """Launcher-side preemption protocol: on SIGTERM, forward the signal
    to every live trainer (their training loops checkpoint and exit) and
    give the group `grace_secs` to drain before the watcher terminates
    whatever is left. install() chains any previous handler; trainers
    are registered per elastic attempt."""

    def __init__(self, grace_secs: float):
        self.grace_secs = float(grace_secs)
        self.requested = threading.Event()
        self.deadline: Optional[float] = None
        self.trainers: List[Trainer] = []

    def install(self) -> bool:
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _handler(sig, frame):
                self.requested.set()
                self.deadline = time.time() + self.grace_secs
                print("[launch] SIGTERM: forwarding to trainers for a "
                      f"final checkpoint ({self.grace_secs}s grace)",
                      file=sys.stderr)
                for t in self.trainers:
                    if t.proc is not None and t.proc.poll() is None:
                        try:
                            t.proc.send_signal(signal.SIGTERM)
                        except OSError:
                            pass
                if callable(prev) and prev not in (signal.SIG_IGN,
                                                   signal.SIG_DFL):
                    prev(sig, frame)

            signal.signal(signal.SIGTERM, _handler)
            return True
        except ValueError:  # not the main thread (tests calling launch())
            return False

    def expired(self) -> bool:
        return self.deadline is not None and time.time() > self.deadline


def start_local_trainers(cluster: List[Trainer], node_ip: str, script: str,
                         script_args: List[str], log_dir: Optional[str],
                         restart_count: int = 0,
                         heartbeat_dir: Optional[str] = None,
                         membership_epoch: int = 0,
                         rendezvous: Optional[str] = None,
                         module: Optional[str] = None,
                         only_tags=None, clear_fault_spec: bool = False):
    """Fork this node's trainers with the env protocol (reference
    utils.start_local_trainers:340). PADDLE_TRAINER_TAG carries the
    stable membership identity and PADDLE_MEMBERSHIP_EPOCH the
    coordinator's membership epoch — both survive resizes where the rank
    numbering does not; ``rendezvous`` (PADDLE_DIST_RENDEZVOUS) is this
    attempt's own process-group store.  ``module`` runs ``-m module``
    instead of a script file (launch --serve); ``only_tags`` spawns only
    the named members, the env protocol still derived from the whole
    cluster (a replica's respawn in place), and ``clear_fault_spec``
    keeps PADDLE_PS_FAULT_SPEC from the spawned children."""
    endpoints = ",".join(t.endpoint for t in cluster)
    local = [t for t in cluster if t.endpoint.split(":")[0] == node_ip]
    if only_tags is not None:
        local = [t for t in local if t.tag in only_tags]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    for t in local:
        env = dict(os.environ)
        env.update(
            PADDLE_TRAINER_ID=str(t.rank),
            PADDLE_TRAINERS_NUM=str(len(cluster)),
            PADDLE_TRAINER_ENDPOINTS=endpoints,
            PADDLE_CURRENT_ENDPOINT=t.endpoint,
            PADDLE_ELASTIC_RESTART=str(restart_count),
            PADDLE_TRAINER_TAG=t.tag,
            PADDLE_MEMBERSHIP_EPOCH=str(membership_epoch),
        )
        if heartbeat_dir:
            env["PADDLE_HEARTBEAT_DIR"] = heartbeat_dir
        if rendezvous:
            env[ENV_RENDEZVOUS] = rendezvous
        if clear_fault_spec:
            # a `kill:*:N` drill means "kill this replica once", not
            # every incarnation of it
            env.pop("PADDLE_PS_FAULT_SPEC", None)
        if module is not None:
            cmd = [sys.executable, "-u", "-m", module] + list(script_args)
        else:
            cmd = [sys.executable, "-u", script] + list(script_args)
        if log_dir:
            mode = "a" if restart_count else "w"
            t.log = open(os.path.join(log_dir, f"workerlog.{t.rank}"), mode)
            t.proc = subprocess.Popen(cmd, env=env, stdout=t.log,
                                      stderr=subprocess.STDOUT)
        else:
            t.proc = subprocess.Popen(cmd, env=env)
        t.exit_ts = None
        threading.Thread(target=_reap, args=(t,), daemon=True).start()
    return local


def terminate_local_trainers(trainers: List[Trainer],
                             grace_s: float = 5.0):
    """SIGTERM every live trainer, SIGKILL what is left after
    ``grace_s``, and return only once every one of them is gone: the
    next attempt must never start beside a process of this one."""
    for t in trainers:
        if t.proc and t.proc.poll() is None:
            t.proc.terminate()
    deadline = time.time() + grace_s
    for t in trainers:
        if not t.proc:
            continue
        while t.proc.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if t.proc.poll() is None:
            t.proc.kill()
    for t in trainers:
        if t.proc:
            t.proc.wait()
        if t.log:
            t.log.close()


class ServeRespawner:
    """Per-replica supervision for launch --serve: serving replicas are
    INDEPENDENT — one dying must never blip the rest of the fleet, so
    (unlike sync training, where the barrier demands a group restart) a
    dead replica is respawned IN PLACE on its original endpoint, budget
    ``retries`` per replica.  Past budget the death falls through to the
    group-abort path so the job still ends loudly.

    Only a replica whose process has exited is respawned, so no second
    process ever binds a live replica's endpoint.  The respawn runs
    without the fault schedule, and the monitor is re-armed for it
    (``HeartBeatMonitor.rearm``): a stamp older than the respawn counts
    as none, so the new process gets the startup grace for its first
    stamp instead of being read as hung on the one that died."""

    def __init__(self, cluster: List[Trainer], node_ip: str, script: str,
                 script_args: List[str], log_dir: Optional[str],
                 retries: int, heartbeat_dir: Optional[str] = None,
                 membership_epoch: int = 0,
                 module: Optional[str] = None,
                 rendezvous: Optional[str] = None, monitor=None):
        self.cluster = cluster
        self.node_ip = node_ip
        self.script = script
        self.script_args = list(script_args)
        self.log_dir = log_dir
        self.retries = int(retries)
        self.heartbeat_dir = heartbeat_dir
        self.membership_epoch = membership_epoch
        self.module = module
        self.rendezvous = rendezvous
        self.monitor = monitor
        self._counts: dict = {}

    def respawn(self, t: Trainer) -> bool:
        if t.proc is None or t.proc.poll() is None:
            return False
        n = self._counts.get(t.tag, 0)
        if n >= self.retries:
            return False
        self._counts[t.tag] = n + 1
        print(f"[launch] serving replica {t.rank} ({t.tag}, "
              f"{t.endpoint}) died; respawning in place "
              f"({n + 1}/{self.retries}); the rest of the fleet keeps "
              f"serving", file=sys.stderr, flush=True)
        if t.log:
            t.log.close()
            t.log = None
        if self.monitor is not None:
            self.monitor.rearm(t.rank)
        start_local_trainers(
            self.cluster, self.node_ip, self.script, self.script_args,
            self.log_dir, restart_count=n + 1,
            heartbeat_dir=self.heartbeat_dir,
            membership_epoch=self.membership_epoch,
            rendezvous=self.rendezvous, module=self.module,
            only_tags={t.tag}, clear_fault_spec=True)
        return True


def watch_local_trainers(trainers: List[Trainer], poll_interval=0.2,
                         monitor=None, ps_supervisor=None,
                         grace: Optional[SigtermGrace] = None,
                         failure: Optional[dict] = None,
                         coordinator=None, coord_supervisor=None,
                         serve_respawner: Optional[ServeRespawner] = None,
                         ) -> int:
    """Block until all trainers exit. Any nonzero exit — or a stale
    heartbeat when `monitor` (heartbeat.HeartBeatMonitor) is given —
    aborts the whole local group (reference watch_local_trainers:407:
    fail fast; heartbeat parity: heart_beat_monitor.h:54). Under a
    SIGTERM `grace` the watcher waits for the (already signaled)
    trainers to finish their final checkpoints, terminating stragglers
    when the grace window expires, and reports 128+SIGTERM. Returns the
    job's exit code.

    `failure` (out-param dict) receives {"trainer", "tag", "rank",
    "reason", "detect_ts"} for the trainer whose death ended the watch
    (detect_ts: when the watcher saw it, before the group was torn
    down) — the attempts loop charges the right PER-RANK budget and
    names the culprit in the restart line. `coordinator`
    (coordinator.Coordinator) is swept on the poll cadence: an expired
    TRAINER lease is treated like a hang (kill + reason "lease
    expired"); the sweep also elects a new primary for the partitions
    of a pserver whose lease expired. `ps_supervisor`
    (PServerSupervisor) is polled on the same cadence: it respawns dead
    pservers in place, or returns an exit code to abort the job. A
    `coord_supervisor` respawns a dead process-hosted coordinator on
    the same cadence; a `serve_respawner` respawns a dead serving
    replica in place, within its budget, instead of aborting."""

    def _fail(t: Optional[Trainer], reason: str) -> None:
        if failure is not None and t is not None:
            failure.update(trainer=t, tag=t.tag, rank=t.rank,
                           reason=reason, detect_ts=time.time())

    try:
        while True:
            if grace is not None and grace.requested.is_set():
                # preemption drain: children got SIGTERM from the grace
                # handler; each checkpoints and exits on its own
                while (any(t.proc.poll() is None for t in trainers)
                       and not grace.expired()):
                    time.sleep(poll_interval)
                terminate_local_trainers(trainers)
                return 128 + signal.SIGTERM
            codes = [t.proc.poll() for t in trainers]
            dead = [t for t, rc in zip(trainers, codes)
                    if rc not in (None, 0)]
            if dead and serve_respawner is not None:
                # replaced in place: the fleet serves on
                dead = [t for t in dead if not serve_respawner.respawn(t)]
                codes = [t.proc.poll() for t in trainers]
            alive = None in codes
            if dead:
                # the first to exit: its peers fail after it, in the
                # collective it left
                t = min(dead, key=lambda d: (d.exit_ts is None,
                                             d.exit_ts or 0.0, d.rank))
                rc = t.proc.returncode
                _fail(t, f"nonzero exit (code {rc})")
                print(
                    f"[launch] trainer {t.rank} ({t.tag}, "
                    f"{t.endpoint}) exited with {rc}; aborting the "
                    f"job",
                    file=sys.stderr,
                )
                terminate_local_trainers(trainers)
                return rc
            if not alive:
                return 0
            if monitor is not None:
                running = [t.rank for t in trainers if t.proc.poll() is None]
                stale = monitor.stale_ranks(ranks=running)
                if stale:
                    culprit = next((t for t in trainers
                                    if t.rank in stale), None)
                    _fail(culprit, "heartbeat stale (hang)")
                    print(
                        f"[launch] trainer rank(s) {stale} stopped "
                        f"heartbeating for >{monitor.timeout}s (hang?); "
                        f"aborting the group",
                        file=sys.stderr,
                    )
                    terminate_local_trainers(trainers)
                    return 124  # timeout-style exit code
            if coordinator is not None:
                # lease plane: sweep expiries on the watch cadence, then
                # react to expired TRAINER leases exactly like stale
                # heartbeats
                events = coordinator.sweep()
                running_tags = {t.tag: t for t in trainers
                                if t.proc.poll() is None}
                for ev in events:
                    if (ev.get("event") == "lease_expired"
                            and ev.get("kind") == "trainer"
                            and ev.get("tag") in running_tags):
                        t = running_tags[ev["tag"]]
                        _fail(t, "lease expired (no renewals)")
                        print(f"[launch] trainer {t.rank} ({t.tag}) "
                              f"lease expired ({ev.get('overdue_s')}s "
                              f"overdue — renewals stopped); killing "
                              f"the group", file=sys.stderr)
                        terminate_local_trainers(trainers)
                        return 124
            if ps_supervisor is not None:
                rc = ps_supervisor.check()
                if rc is not None:
                    terminate_local_trainers(trainers)
                    return rc
            if coord_supervisor is not None:
                # durable control plane: respawn a dead coordinator in
                # place; never aborts the job
                coord_supervisor.check()
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        terminate_local_trainers(trainers)
        return 128 + signal.SIGINT


def launch(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    _refuse_unported(args)
    ips = [s.strip() for s in args.ips.split(",") if s.strip()]
    node_ip = args.node_ip or ips[0]
    cluster = get_cluster(ips, args.nproc_per_node, args.started_port)

    # lease plane (--lease_secs / PADDLE_LEASE_SECS): the launcher hosts
    # the membership coordinator and every child renews a lease on it
    lease_secs = args.lease_secs
    if lease_secs is None:
        try:
            lease_secs = float(os.environ.get("PADDLE_LEASE_SECS", 0) or 0)
        except ValueError:
            lease_secs = 0.0

    # this launcher's own directory: the per-attempt rendezvous stores,
    # and the heartbeat stamps when the operator named no directory
    job_dir = tempfile.mkdtemp(prefix="paddle_torch_job_")
    heartbeat_dir = None
    # lease renewals ride the heartbeat channel (stamps double as
    # renewals), so either flag provisions the directory
    if args.heartbeat_timeout > 0 or lease_secs > 0:
        heartbeat_dir = (os.environ.get("PADDLE_HEARTBEAT_DIR")
                         or os.path.join(job_dir, "heartbeat"))

    # pserver snapshot interval: explicit flag > env > supervision-implied
    # default
    snapshot_secs = args.ps_snapshot_secs
    if snapshot_secs is None:
        env_secs = os.environ.get("PADDLE_PS_SNAPSHOT_SECS")
        if env_secs:
            snapshot_secs = float(env_secs)
        else:
            snapshot_secs = 1.0 if args.elastic_retries > 0 else 0.0
    if args.ps_replication is not None and args.ps_replication > 1:
        if args.servers:
            n_ps = len([e for e in args.servers.split(",") if e.strip()])
        else:
            n_ps = args.server_num
        if n_ps < args.ps_replication:
            print(f"[launch] --ps_replication {args.ps_replication} "
                  f"needs at least that many pservers, got {n_ps} "
                  f"(--server_num / --servers)", file=sys.stderr)
            shutil.rmtree(job_dir, ignore_errors=True)
            return 2

    grace = SigtermGrace(args.sigterm_grace)
    grace.install()

    # the job control plane: the coordinator owns membership, epochs and
    # per-rank budgets whenever elastic supervision is on; it is SERVED
    # over TCP (lease renewals) only when --lease_secs arms leases.
    # DURABLE mode (PADDLE_COORD_SNAPSHOT_SECS set, or
    # --coordinator_standby): the coordinator moves OUT of the launcher
    # into a supervised child process with snapshot+WAL state, and the
    # launcher talks to it through CoordinatorProxy; neither armed =
    # the in-process coordinator, byte-identical on the wire
    from .coordinator import (Coordinator, CoordinatorProxy,
                              serve_ckpt_barrier, serve_coordinator,
                              stop_coordinator)

    per_rank = (args.elastic_retries_per_rank
                if args.elastic_retries_per_rank is not None
                else args.elastic_retries)
    durable_snap_secs = None
    raw_snap = os.environ.get("PADDLE_COORD_SNAPSHOT_SECS")
    if raw_snap:
        try:
            durable_snap_secs = float(raw_snap)
        except ValueError:
            durable_snap_secs = None
    durable_coord = lease_secs > 0 and (durable_snap_secs is not None
                                        or args.coordinator_standby)
    if args.coordinator_standby and lease_secs <= 0:
        print("[launch] --coordinator_standby needs the lease plane; "
              "arm it with --lease_secs", file=sys.stderr)
        shutil.rmtree(job_dir, ignore_errors=True)
        return 2
    coord_server = None
    coord_children = None
    coord_ep = None
    ckpt_barrier_server = None
    pservers: List[PServer] = []
    try:
        if durable_coord:
            snap_secs = (durable_snap_secs
                         if durable_snap_secs is not None else 1.0)
            coord_state_root = (os.path.join(args.log_dir, "coord_state")
                                if args.log_dir
                                else os.path.join(job_dir, "coord_state"))
            os.makedirs(coord_state_root, exist_ok=True)
            primary_state = os.path.join(coord_state_root, "primary")
            primary = _spawn_coordinator(
                "127.0.0.1", 0, primary_state, lease_secs, per_rank,
                snap_secs, log_dir=args.log_dir)
            primary_ep = f"127.0.0.1:{primary.coord_bound_port}"
            coord_children = {"primary": {
                "proc": primary, "host": "127.0.0.1",
                "port": primary.coord_bound_port,
                "state_dir": primary_state, "lease_secs": lease_secs,
                "per_rank": per_rank, "snapshot_secs": snap_secs,
                "log_dir": args.log_dir, "standby_of": None}}
            endpoints = [primary_ep]
            if args.coordinator_standby:
                standby_state = os.path.join(coord_state_root, "standby")
                standby = _spawn_coordinator(
                    "127.0.0.1", 0, standby_state, lease_secs, per_rank,
                    snap_secs, log_dir=args.log_dir, standby_of=primary_ep)
                coord_children["standby"] = {
                    "proc": standby, "host": "127.0.0.1",
                    "port": standby.coord_bound_port,
                    "state_dir": standby_state, "lease_secs": lease_secs,
                    "per_rank": per_rank, "snapshot_secs": snap_secs,
                    "log_dir": args.log_dir, "standby_of": primary_ep}
                endpoints.append(f"127.0.0.1:{standby.coord_bound_port}")
            coord_ep = ",".join(endpoints)
            # children inherit the ORDERED list through the spawn env
            os.environ["PADDLE_COORDINATOR_ENDPOINT"] = coord_ep
            os.environ["PADDLE_LEASE_SECS"] = str(lease_secs)
            coord = CoordinatorProxy(coord_ep, lease_secs, per_rank)
            print(f"[launch] durable job coordinator on {coord_ep} (lease "
                  f"{lease_secs}s, per-rank budget {per_rank}, snapshots "
                  f"every {snap_secs}s"
                  + (", warm standby" if args.coordinator_standby else "")
                  + ")", file=sys.stderr)
        else:
            coord = Coordinator(lease_secs=lease_secs or 5.0,
                                retries_per_rank=per_rank)
            if lease_secs > 0:
                coord_server, coord_ep = serve_coordinator(coord)
                # children inherit both through the spawn env copies
                os.environ["PADDLE_COORDINATOR_ENDPOINT"] = coord_ep
                os.environ["PADDLE_LEASE_SECS"] = str(lease_secs)
                print(f"[launch] job coordinator on {coord_ep} (lease "
                      f"{lease_secs}s, per-rank budget {per_rank})",
                      file=sys.stderr)

        # sharded-checkpoint commit barrier (fluid/checkpoint.py): every
        # multi-rank job gets one — it costs a daemon thread and only
        # matters once PADDLE_CKPT_SHARDED arms sharded saves in the
        # trainers. Lease-armed jobs reach it through the coordinator's
        # port (ckpt_* verbs delegate); otherwise the coordinator's
        # barrier object is served standalone
        if len(cluster) > 1:
            if coord_ep is not None:
                os.environ["PADDLE_CKPT_BARRIER_ENDPOINT"] = coord_ep
            else:
                ckpt_barrier_server, bar_ep = serve_ckpt_barrier(
                    coord.ckpt_barrier)
                os.environ["PADDLE_CKPT_BARRIER_ENDPOINT"] = bar_ep

        # parameter servers: started after the coordinator, so their
        # lease workers (ps_server.serve) find its endpoint in the env
        ps_supervisor = None
        if args.ps_snapshot_mode:
            # pservers inherit it through _spawn_pserver's env copy
            os.environ["PADDLE_PS_SNAPSHOT_MODE"] = args.ps_snapshot_mode
        if args.ps_replication is not None:
            # trainers inherit it through start_local_trainers' env
            # copy; RemoteTable reads it as the default replication
            os.environ["PADDLE_PS_REPLICATION"] = str(args.ps_replication)
        if args.server_num or args.servers:
            snapshot_dir = None
            adopt_snapshots = False
            if snapshot_secs > 0:
                snapshot_dir = os.environ.get("PADDLE_PS_SNAPSHOT_DIR")
                if snapshot_dir:
                    # stable cross-job dir: a previous job's snapshots
                    # (+ manifest) are adopted on first spawn
                    adopt_snapshots = True
                else:
                    snapshot_dir = os.path.join(
                        args.log_dir or job_dir, "ps_snapshots")
                os.makedirs(snapshot_dir, exist_ok=True)
            pservers, endpoints = start_pservers(
                args.server_num, args.servers, node_ip, args.log_dir,
                snapshot_dir=snapshot_dir, snapshot_secs=snapshot_secs,
                heartbeat_dir=heartbeat_dir,
                adopt_snapshots=adopt_snapshots)
            # trainers inherit the list through start_local_trainers' env
            os.environ["PADDLE_PSERVERS_IP_PORT_LIST"] = ",".join(endpoints)
            os.environ.setdefault("PADDLE_TRAINING_ROLE", "TRAINER")
            print(f"[launch] {len(pservers)} pserver(s) on "
                  f"{','.join(endpoints)}", file=sys.stderr)
            if args.elastic_retries > 0:
                ps_supervisor = PServerSupervisor(
                    pservers, args.elastic_retries, args.log_dir,
                    snapshot_dir, snapshot_secs,
                    heartbeat_dir=heartbeat_dir,
                    heartbeat_timeout=args.heartbeat_timeout)

        coord_supervisor = None
        if coord_children is not None:
            coord_supervisor = CoordinatorSupervisor(
                coord_children, args.elastic_retries)
        return _launch_attempts(args, ips, node_ip, cluster, heartbeat_dir,
                                job_dir, grace, coord=coord,
                                lease_armed=lease_secs > 0,
                                coord_supervisor=coord_supervisor,
                                ps_supervisor=ps_supervisor)
    finally:
        terminate_pservers(pservers)
        if coord_server is not None:
            stop_coordinator(coord_server)
        if ckpt_barrier_server is not None:
            stop_coordinator(ckpt_barrier_server)  # same teardown shape
        if coord_children is not None:
            # SIGTERM = graceful: the coordinator writes a final
            # snapshot, so a follow-up job adopting the state dir
            # restarts lossless
            for ent in coord_children.values():
                p = ent.get("proc")
                if p is not None and p.poll() is None:
                    p.terminate()
            for ent in coord_children.values():
                p = ent.get("proc")
                if p is not None:
                    try:
                        p.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
            coord.close()
        shutil.rmtree(job_dir, ignore_errors=True)


def _launch_attempts(args, ips, node_ip, cluster, heartbeat_dir, job_dir,
                     grace=None, coord=None, lease_armed=False,
                     coord_supervisor=None, ps_supervisor=None) -> int:
    """Supervision loop with per-rank budgets and elastic resize.

    Failure accounting lives in the coordinator: every group-ending
    trainer failure (nonzero exit, stale heartbeat, expired lease) is
    charged to THAT member's per-rank budget
    (coordinator.report_failure). Within budget, the group restarts at
    the same world size (the sync-PS barrier demands a group restart
    either way); past budget the member is EVICTED — the
    membership epoch bumps and the survivors restart at world-1 from the
    last checkpoint (PADDLE_ELASTIC_RESHARD=1 is exported so their
    CheckpointManagers accept the resized resume). --elastic_retries
    stays the JOB-LEVEL restart cap. Each restart prints when the
    failure was detected and when the new group was spawned (the JAX
    launcher's goodput `restart` event).  Under --serve each rank is one
    serving replica, respawned in place by a ServeRespawner."""
    # serving mode: each rank is one inference replica; the positional
    # arg is the model dir, extra args pass through to the server
    serve_module = None
    serve_args: List[str] = []
    if args.serve:
        serve_module = SERVE_MODULE
        serve_args = (["--model_dir", args.training_script]
                      + list(args.training_script_args))
        # KV-pool knobs ride the env protocol into every replica (the
        # same PADDLE_SERVE_* envs an operator would set by hand)
        if args.serve_kv_cache is not None:
            os.environ["PADDLE_SERVE_KV_CACHE"] = args.serve_kv_cache
        if args.serve_kv_pages is not None:
            os.environ["PADDLE_SERVE_KV_PAGES"] = str(args.serve_kv_pages)
        print(f"[launch] serving replicas: "
              f"{','.join(t.endpoint for t in cluster)}",
              file=sys.stderr)
    elastic_enabled = (args.elastic_retries > 0
                       or args.elastic_retries_per_rank is not None)
    # job-level cap: --elastic_retries when given; with only per-rank
    # budgets, a generous derived bound (every rank exhausting its own
    # budget plus its eviction restart)
    per_rank = (args.elastic_retries_per_rank
                if args.elastic_retries_per_rank is not None
                else args.elastic_retries)
    job_cap = (args.elastic_retries if args.elastic_retries > 0
               else (per_rank + 1) * len(cluster))
    trainers = list(cluster)  # survivors, re-ranked on resize
    attempt = 0
    epoch = coord.epoch if coord is not None else 0
    pending_restart = None
    while True:
        rendezvous = "file://" + os.path.join(job_dir, f"store.{attempt}")
        local = start_local_trainers(
            trainers, node_ip, args.training_script,
            serve_args if serve_module else args.training_script_args,
            args.log_dir, restart_count=attempt,
            heartbeat_dir=heartbeat_dir, membership_epoch=epoch,
            rendezvous=rendezvous, module=serve_module,
        )
        if pending_restart is not None:
            pending_restart["respawn_ts"] = round(time.time(), 6)
            print(f"[launch] restart {pending_restart['attempt']}: "
                  f"failure detected at "
                  f"{pending_restart['detect_ts']:.6f}, group respawned "
                  f"at {pending_restart['respawn_ts']:.6f} ("
                  f"{pending_restart['respawn_ts'] - pending_restart['detect_ts']:.3f}"
                  f" s)", file=sys.stderr)
            if coord is not None:
                coord.note_incident(
                    dict(pending_restart, event="restart"))
            pending_restart = None
        if not local:
            print(f"[launch] node_ip {node_ip} not in --ips {ips}",
                  file=sys.stderr)
            return 2
        if grace is not None:
            grace.trainers = local
        if coord is not None and lease_armed:
            for t in local:
                coord.register(t.tag, kind="trainer", endpoint=t.endpoint)
        monitor = None
        if heartbeat_dir and args.heartbeat_timeout > 0:
            from .heartbeat import HeartBeatMonitor

            # created AFTER spawn: a fresh monitor ignores stamps older
            # than itself, so leftovers from a previous attempt/job in a
            # reused shared dir never read as hangs; it knows the
            # membership epoch so a future-epoch stamp (a member owned
            # by a NEWER coordinator) is never read as proof of life
            monitor = HeartBeatMonitor(
                heartbeat_dir, [t.rank for t in local],
                args.heartbeat_timeout, epoch=epoch,
            )
        serve_respawner = None
        if serve_module is not None and elastic_enabled:
            serve_respawner = ServeRespawner(
                trainers, node_ip, args.training_script, serve_args,
                args.log_dir, retries=per_rank,
                heartbeat_dir=heartbeat_dir, membership_epoch=epoch,
                module=serve_module, rendezvous=rendezvous,
                monitor=monitor)
        failure: dict = {}
        rc = watch_local_trainers(
            local, monitor=monitor, ps_supervisor=ps_supervisor,
            grace=grace, failure=failure,
            coordinator=coord if lease_armed else None,
            coord_supervisor=coord_supervisor,
            serve_respawner=serve_respawner)
        detect_ts = failure.get("detect_ts", time.time())
        if (rc == 0
                or rc == 128 + signal.SIGINT
                or rc == 128 + signal.SIGTERM  # whole-job preemption
                or (ps_supervisor is not None and ps_supervisor.aborted)
                or not elastic_enabled):
            return rc
        # charge the failure to the culprit's per-rank budget; the
        # coordinator decides restart-in-place vs evict-and-resize
        tag = failure.get("tag", local[0].tag)
        rank = failure.get("rank", "?")
        reason = failure.get("reason", f"exit code {rc}")
        resized = False
        if coord is not None:
            verdict = coord.report_failure(tag, reason)
            if verdict["evicted"]:
                new_world = len(trainers) - 1
                if new_world < max(1, args.min_world_size):
                    print(f"[launch] {tag} (rank {rank}) exhausted its "
                          f"per-rank budget ({reason}) and the job "
                          f"cannot resize below "
                          f"--min_world_size={args.min_world_size}; "
                          f"aborting", file=sys.stderr)
                    return rc
                if len(ips) > 1:
                    print(f"[launch] {tag} (rank {rank}) exhausted its "
                          f"per-rank budget ({reason}); elastic resize "
                          f"is single-node only — aborting",
                          file=sys.stderr)
                    return rc
                survivors = [t for t in trainers if t.tag != tag]
                # re-rank 0..W-1 but keep each survivor's stable tag
                # (and endpoint — ports are identity on CPU fleets)
                trainers = [Trainer(i, t.endpoint, tag=t.tag)
                            for i, t in enumerate(survivors)]
                epoch = verdict["epoch"]
                resized = True
        if attempt >= job_cap:
            print(f"[launch] {tag} (rank {rank}) failed ({reason}) and "
                  f"the job-level restart cap ({job_cap}) is exhausted; "
                  f"aborting", file=sys.stderr)
            return rc
        attempt += 1
        pending_restart = {
            "tag": tag, "rank": rank, "reason": reason,
            "detect_ts": round(detect_ts, 6), "attempt": attempt,
            "world": len(trainers), "resized": resized,
        }
        if resized:
            # elastic resize: survivors re-shard their checkpoints
            # (CheckpointManager world-size gate)
            os.environ["PADDLE_ELASTIC_RESHARD"] = "1"
            print(
                f"[launch] elastic restart {attempt}/{job_cap}: {tag} "
                f"(rank {rank}) evicted after {reason}; membership "
                f"epoch {epoch}, resizing to world_size="
                f"{len(trainers)} (survivors resume from checkpoint, "
                f"re-sharded)",
                file=sys.stderr,
            )
        else:
            print(
                f"[launch] elastic restart {attempt}/{job_cap}: {tag} "
                f"(rank {rank}) died ({reason}); group restarts at "
                f"world_size={len(trainers)} (trainers resume from "
                f"checkpoint)",
                file=sys.stderr,
            )
        if heartbeat_dir:
            # drop stale stamps so the new group starts with a clean slate
            from .heartbeat import _stamp_path

            for t in local:
                try:
                    os.remove(_stamp_path(heartbeat_dir, t.rank))
                except OSError:
                    pass


if __name__ == "__main__":
    sys.exit(launch())
