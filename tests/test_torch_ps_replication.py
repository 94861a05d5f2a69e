"""The port's replicated PS tables (``paddle_tpu_torch/distributed/
ps_server.py``): fast failover, hedged reads and incremental snapshots,
against the JAX package's, on the CPU.

Mirrors ``tests/test_ps_replication.py`` case for case.  Unit layer
(in-thread servers, hard-killable):
  - R replicas of a partition stay BIT-identical: the primary forwards
    every applied write with a per-partition apply seq; a replicated
    table spread over one server of each package does the same
  - killing a primary promotes the next live replica and training
    continues with exact parity; a respawned replica catches up by
    anti-entropy and rejoins as backup
  - read verbs hedge to a backup after the observed latency quantile
  - incremental snapshots write O(touched rows) per tick, chain-restore
    to exactly the full-snapshot state (also in the other package's
    server), compact, and stop at a corrupt delta
Process layer (slow, launcher drills): R=2 kill-primary gives the
no-fault loss trace bit for bit; an injected tail is absorbed by hedges.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import ps_server as jps_server
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import ps, ps_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ps_worker.py")
_REG = telemetry.get_registry()


class _Srv:
    """An in-thread pserver of either package (``mod``), hard-killable
    and respawnable on the same port."""

    def __init__(self, port=0, preload=None, snapdir=None, mode=None,
                 mod=ps_server):
        self.mod = mod
        self.ready = threading.Event()
        self.kw = dict(preload_dir=preload, snapshot_dir=snapdir,
                       snapshot_mode=mode)
        self.srv = None
        self.thread = threading.Thread(target=self._run, args=(port,),
                                       daemon=True)
        self.thread.start()
        assert self.ready.wait(10)

    def _run(self, port):
        self.srv = self.mod._TCPServer(("127.0.0.1", port),
                                       self.mod._Handler)
        self.srv.ps = self.mod.PSServer(**self.kw)
        self.ep = f"127.0.0.1:{self.srv.server_address[1]}"
        self.port = self.srv.server_address[1]
        self.ready.set()
        self.srv.serve_forever(poll_interval=0.05)

    def kill(self):
        """Abrupt death: listener closed AND every live connection reset."""
        self.srv.shutdown()
        self.srv.close_all_connections()
        self.srv.server_close()
        self.thread.join(timeout=5)

    @property
    def ps(self):
        return self.srv.ps


@pytest.fixture
def fast_failover(monkeypatch):
    """Failover detection bounded to ~1 s; a short rejoin window."""
    monkeypatch.setattr(ps_server, "REPLICATED_DEADLINE_DEFAULT", 1.0)
    monkeypatch.setattr(ps_server, "REJOIN_SECS", 30.0)


def _mk_oracle(rows, dim, n_parts, **kw):
    """Per-partition local oracles with the replicated seed layout
    (partition p seeded seed+p, rows r%n at local r//n)."""
    seed = kw.pop("seed")
    parts = [ps.ShardedHostTable(
        f"oracle{p}", ((rows - p + n_parts - 1) // n_parts, dim),
        seed=seed + p, **kw) for p in range(n_parts)]

    class O:
        def gather(self, ids):
            ids = np.asarray(ids, np.int64)
            out = np.empty((len(ids), dim), np.float32)
            for p in range(n_parts):
                m = ids % n_parts == p
                if m.any():
                    out[m] = parts[p].gather(ids[m] // n_parts)
            return out

        def push_gradients(self, ids, g):
            ids = np.asarray(ids, np.int64)
            for p in range(n_parts):
                m = ids % n_parts == p
                if m.any():
                    parts[p].push_gradients(ids[m] // n_parts, g[m])

    return O()


def test_replication_requires_enough_pservers():
    a = _Srv()
    try:
        with pytest.raises(ValueError, match="replication=2"):
            ps_server.RemoteTable("rv", (10, 4), [a.ep], replication=2)
    finally:
        a.kill()


def test_r1_wire_format_and_files_unchanged(tmp_path):
    """R=1 stays byte-compatible: no partition/replicas keys, zero
    replication verbs, snapshot files named <name>.pkl holding a plain
    state_dict — which the JAX package's server preloads."""
    a = _Srv(snapdir=str(tmp_path))
    try:
        before = _REG.counter("ps_server_rpc_total", verb="promote").value
        kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=1)
        t = ps_server.RemoteTable("plain", (40, 4), [a.ep], **kw)
        spec = a.ps.specs["plain"]
        assert "partition" not in spec and "replicas" not in spec
        assert "plain" in a.ps.tables and a.ps.replicas == {}
        t.push_gradients(np.arange(4, dtype=np.int64),
                         np.ones((4, 4), np.float32))
        assert a.ps.snapshot() == 1
        with open(tmp_path / "plain.pkl", "rb") as f:
            state = pickle.load(f)
        assert "replica_meta" not in state and "shards" in state
        assert _REG.counter("ps_server_rpc_total",
                            verb="promote").value == before
        j = jps_server.PSServer(preload_dir=str(tmp_path))
        j.create_table(dict(spec))
        np.testing.assert_array_equal(j.tables["plain"].to_dense(),
                                      t.to_dense())
        t.close()
    finally:
        a.kill()


def test_replicated_parity_and_backup_prefix_consistency(fast_failover):
    """Every acked write is on EVERY replica — over three servers, the
    middle one the JAX package's."""
    a, b, c = _Srv(), _Srv(mod=jps_server), _Srv()
    try:
        kw = dict(num_shards=2, optimizer="adagrad", learning_rate=0.3,
                  seed=3)
        remote = ps_server.RemoteTable("r3", (90, 8), [a.ep, b.ep, c.ep],
                                       replication=2, **kw)
        oracle = _mk_oracle(90, 8, 3, **dict(kw))
        rng = np.random.RandomState(0)
        for _ in range(5):
            ids = rng.randint(0, 90, (24,)).astype(np.int64)
            np.testing.assert_array_equal(remote.gather(ids),
                                          oracle.gather(ids))
            g = rng.randn(24, 8).astype(np.float32)
            remote.push_gradients(ids, g)
            oracle.push_gradients(ids, g)
        np.testing.assert_array_equal(a.ps.tables["r3@p0"].to_dense(),
                                      b.ps.tables["r3@p0"].to_dense())
        np.testing.assert_array_equal(b.ps.tables["r3@p1"].to_dense(),
                                      c.ps.tables["r3@p1"].to_dense())
        st = remote.replica_status()
        assert [r["replicas"][0]["role"] for r in st] == ["primary"] * 3
        assert [r["replicas"][1]["role"] for r in st] == ["backup"] * 3
        assert all(r["max_lag"] == 0 for r in st), st
        agg = remote.stats()
        assert agg["replication"]["factor"] == 2
        assert len(agg["replication"]["partitions"]) == 3
        remote.close()
    finally:
        for s in (a, b, c):
            s.kill()


def test_failover_promotes_backup_and_training_continues(fast_failover):
    a, b = _Srv(), _Srv()
    try:
        kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=4)
        remote = ps_server.RemoteTable("r4", (100, 4), [a.ep, b.ep],
                                       replication=2, **kw)
        oracle = _mk_oracle(100, 4, 2, **dict(kw))
        rng = np.random.RandomState(1)
        for _ in range(4):
            ids = rng.randint(0, 100, (16,)).astype(np.int64)
            g = rng.randn(16, 4).astype(np.float32)
            remote.push_gradients(ids, g)
            oracle.push_gradients(ids, g)
        failovers0 = _REG.counter("ps_client_failovers_total").value
        a.kill()  # partition 0's primary, partition 1's backup
        t0 = time.time()
        for _ in range(4):
            ids = rng.randint(0, 100, (16,)).astype(np.int64)
            g = rng.randn(16, 4).astype(np.float32)
            remote.push_gradients(ids, g)
            oracle.push_gradients(ids, g)
            np.testing.assert_array_equal(remote.gather(ids),
                                          oracle.gather(ids))
        assert time.time() - t0 < 20
        assert _REG.counter("ps_client_failovers_total").value > failovers0
        everything = np.arange(100, dtype=np.int64)
        np.testing.assert_array_equal(remote.gather(everything),
                                      oracle.gather(everything))
        st = remote.replica_status()
        surv = [r for r in st[0]["replicas"] if "error" not in r]
        assert [r["role"] for r in surv] == ["primary"]
        assert st[0]["epoch"] >= 1
        remote.close()
    finally:
        for s in (a, b):
            try:
                s.kill()
            except Exception:
                pass


def test_respawn_catches_up_then_rejoins_as_backup(fast_failover):
    """A server respawned on the same port (the JAX package's this time)
    is re-created by the client's rejoin thread, pulls the seq tail from
    the port's primary and rejoins as a zero-lag backup."""
    a, b = _Srv(), _Srv()
    try:
        kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=4)
        remote = ps_server.RemoteTable("r5", (100, 4), [a.ep, b.ep],
                                       replication=2, **kw)
        oracle = _mk_oracle(100, 4, 2, **dict(kw))
        rng = np.random.RandomState(2)

        def push(n):
            for _ in range(n):
                ids = rng.randint(0, 100, (16,)).astype(np.int64)
                g = rng.randn(16, 4).astype(np.float32)
                remote.push_gradients(ids, g)
                oracle.push_gradients(ids, g)

        push(3)
        port_a = a.port
        a.kill()
        push(3)  # fails over; rejoin threads start probing port_a
        a2 = _Srv(port=port_a, mod=jps_server)
        deadline = time.time() + 30
        while time.time() < deadline:
            st = remote.replica_status()
            roles = {r["endpoint"]: r.get("role")
                     for r in st[0]["replicas"]}
            if (roles.get(f"127.0.0.1:{port_a}") == "backup"
                    and all(r.get("max_lag") == 0 for r in st)):
                break
            time.sleep(0.3)
        else:
            pytest.fail(f"respawned pserver never rejoined: {st}")
        push(2)  # forwards now include the rejoined backup
        everything = np.arange(100, dtype=np.int64)
        np.testing.assert_array_equal(remote.gather(everything),
                                      oracle.gather(everything))
        np.testing.assert_array_equal(a2.ps.tables["r5@p0"].to_dense(),
                                      b.ps.tables["r5@p0"].to_dense())
        assert all(r["max_lag"] == 0 for r in remote.replica_status())
        remote.close()
        a2.kill()
    finally:
        for s in (a, b):
            try:
                s.kill()
            except Exception:
                pass


def test_fetch_replica_state_tail_vs_full():
    srv = ps_server.PSServer()
    srv.create_table({"name": "t", "shape": (20, 4), "num_shards": 2,
                      "optimizer": "sgd", "learning_rate": 0.5, "seed": 1,
                      "partition": 0, "replicas": []})
    key = "t@p0"
    srv.promote(key, epoch=0, backups=[])
    for _ in range(5):
        srv.push_gradients("t", np.arange(4, dtype=np.int64),
                           np.ones((4, 4), np.float32), partition=0)
    assert srv.replicas[key].seq == 5
    out = srv.fetch_replica_state(key, have_seq=3)
    assert "tail" in out and [e[0] for e in out["tail"]] == [4, 5]
    assert out["seq"] == 5
    assert srv.fetch_replica_state(key, have_seq=5)["tail"] == []
    srv.replicas[key].log = type(srv.replicas[key].log)(
        list(srv.replicas[key].log)[-1:], maxlen=4)
    out = srv.fetch_replica_state(key, have_seq=1)
    assert "state" in out and "tail" not in out
    out = srv.fetch_replica_state(key, have_seq=-1)
    assert "state" in out and "tail" not in out


def test_launch_validates_replication_against_endpoint_count(tmp_path):
    script = tmp_path / "noop.py"
    script.write_text("pass\n")
    for extra in (["--server_num", "1"], ["--servers", "127.0.0.1:1"]):
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             *extra, "--ps_replication", "2", str(script)],
            capture_output=True, text=True, timeout=60, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 2, (r.stdout, r.stderr)
        assert "needs at least that many pservers" in r.stderr


def test_deposed_primary_divergence_forces_full_resync(fast_failover):
    a, b = _Srv(), _Srv()
    try:
        kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5,
                  seed=11)
        remote = ps_server.RemoteTable("dv", (20, 4), [a.ep, b.ep],
                                       replication=2, **kw)
        ids = np.arange(0, 20, 2, dtype=np.int64)  # partition-0 rows
        lids = ids // 2
        remote.push_gradients(ids, np.ones((10, 4), np.float32))
        key = "dv@p0"
        assert a.ps.replicas[key].role == "primary"
        assert b.ps.replicas[key].seq == a.ps.replicas[key].seq
        cb = ps_server._Conn(b.ep)
        cb.call("promote", name="dv", partition=0, epoch=1, backups=[])
        cb.call("push_gradients", name="dv", ids=lids,
                grads=np.full((10, 4), 2.0, np.float32), partition=0,
                trainer_id=1, step=101)
        ca = ps_server._Conn(a.ep, deadline=5.0)
        with pytest.raises(ps_server.StalePrimaryError):
            ca.call("push_gradients", name="dv", ids=lids,
                    grads=np.full((10, 4), -3.0, np.float32),
                    partition=0, trainer_id=2, step=101)
        rs_a = a.ps.replicas[key]
        assert rs_a.stale and rs_a.seq == b.ps.replicas[key].seq
        assert not np.array_equal(a.ps.tables[key].to_dense(),
                                  b.ps.tables[key].to_dense())
        out = ca.call("resync", name="dv", partition=0, primary=b.ep,
                      self_endpoint=a.ep)
        assert out["mode"] == "full"
        np.testing.assert_array_equal(a.ps.tables[key].to_dense(),
                                      b.ps.tables[key].to_dense())
        assert not rs_a.stale and rs_a.role == "backup"
        cb.call("push_gradients", name="dv", ids=lids,
                grads=np.ones((10, 4), np.float32), partition=0,
                trainer_id=1, step=102)
        np.testing.assert_array_equal(a.ps.tables[key].to_dense(),
                                      b.ps.tables[key].to_dense())
        cb.close()
        ca.close()
        remote.close()
    finally:
        for s in (a, b):
            try:
                s.kill()
            except Exception:
                pass


def test_hedged_pull_first_response_wins(fast_failover):
    a, b = _Srv(), _Srv()
    try:
        kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=4)
        remote = ps_server.RemoteTable("h2", (100, 4), [a.ep, b.ep],
                                       replication=2, **kw)
        rng = np.random.RandomState(0)
        want = {}
        for i in range(ps_server.HEDGE_MIN_SAMPLES + 4):
            ids = rng.randint(0, 100, (8,)).astype(np.int64)
            want[i] = (ids, remote.gather(ids))
        real = a.ps.gather

        def slow_gather(name, ids, partition=None):
            time.sleep(0.5)
            return real(name, ids, partition)

        a.ps.gather = slow_gather
        issued0 = _REG.counter("ps_client_hedges_issued_total",
                               verb="gather").value
        won0 = _REG.counter("ps_client_hedges_won_total",
                            verb="gather").value
        t0 = time.time()
        for i in range(4):
            ids, exp = want[i]
            np.testing.assert_array_equal(remote.gather(ids), exp)
        dt = time.time() - t0
        issued = _REG.counter("ps_client_hedges_issued_total",
                              verb="gather").value - issued0
        won = _REG.counter("ps_client_hedges_won_total",
                           verb="gather").value - won0
        assert issued > 0 and won > 0, (issued, won)
        assert dt < 4 * 0.5, dt
        remote.close()
    finally:
        for s in (a, b):
            s.kill()


def _mk_spec(name, rows=20_000, dim=32):
    return {"name": name, "shape": (rows, dim), "num_shards": 4,
            "optimizer": "sgd", "learning_rate": 0.1, "seed": 1}


def test_incremental_snapshot_bytes_scale_with_touched_rows(tmp_path):
    srv = ps_server.PSServer(snapshot_dir=str(tmp_path),
                             snapshot_mode="incremental")
    srv.create_table(_mk_spec("big"))
    t = srv.tables["big"]
    assert srv.snapshot() == 1  # base
    base = [f for f in os.listdir(tmp_path) if ".base." in f][0]
    base_size = os.path.getsize(tmp_path / base)
    t.push_gradients(np.arange(50, dtype=np.int64),
                     np.ones((50, 32), np.float32))
    assert srv.snapshot() == 1  # one delta
    deltas = [f for f in os.listdir(tmp_path) if ".delta." in f]
    delta_size = sum(os.path.getsize(tmp_path / f) for f in deltas)
    assert delta_size * 50 < base_size, (delta_size, base_size)
    assert srv.snapshot() == 0  # idle tick: no bytes at all
    m = json.load(open(tmp_path / "manifest.json"))
    assert m["mode"] == "incremental"
    assert m["chains"]["big"]["deltas"][0]["rows"] == 50


def test_incremental_restore_equals_full_restore(tmp_path):
    """restore(base + delta chain) == restore(full), values and adagrad
    accumulators, in the port's server and in the JAX package's."""
    inc_dir, full_dir = tmp_path / "inc", tmp_path / "full"
    srv = ps_server.PSServer(snapshot_dir=str(inc_dir),
                             snapshot_mode="incremental")
    spec = _mk_spec("tbl", rows=500, dim=8)
    spec["optimizer"] = "adagrad"
    srv.create_table(dict(spec))
    t = srv.tables["tbl"]
    rng = np.random.RandomState(0)
    srv.snapshot()  # base
    for _ in range(3):
        ids = rng.randint(0, 500, (40,)).astype(np.int64)
        t.push_gradients(ids, rng.randn(40, 8).astype(np.float32))
        srv.snapshot()
    srv_f = ps_server.PSServer(snapshot_dir=str(full_dir),
                               snapshot_mode="full")
    srv_f.tables["tbl"] = t
    srv_f.gens["tbl"] = 0
    srv_f.snapshot()

    def restore(mod, preload):
        s = mod.PSServer(preload_dir=str(preload))
        s.create_table(dict(spec))
        return s.tables["tbl"]

    for mod in (ps_server, jps_server):
        ti, tf = restore(mod, inc_dir), restore(mod, full_dir)
        np.testing.assert_array_equal(ti.to_dense(), tf.to_dense())
        np.testing.assert_array_equal(ti.to_dense(), t.to_dense())
        for s in range(t.num_shards):
            np.testing.assert_array_equal(ti._accum[s], tf._accum[s])


def test_incremental_chain_compacts_and_cleans_up(tmp_path, monkeypatch):
    monkeypatch.setattr(ps_server, "SNAPSHOT_COMPACT_EVERY", 3)
    srv = ps_server.PSServer(snapshot_dir=str(tmp_path),
                             snapshot_mode="incremental")
    srv.create_table(_mk_spec("c", rows=100, dim=4))
    t = srv.tables["c"]
    for _ in range(8):
        t.push_gradients(np.arange(5, dtype=np.int64),
                         np.ones((5, 4), np.float32))
        srv.snapshot()
    m = json.load(open(tmp_path / "manifest.json"))
    chain = m["chains"]["c"]
    assert len(chain["deltas"]) <= 3
    assert chain["base"].startswith("c.base.")
    referenced = {chain["base"]} | {d["file"] for d in chain["deltas"]}
    on_disk = {f for f in os.listdir(tmp_path) if f.endswith(".pkl")}
    assert on_disk == referenced, (on_disk, referenced)


def test_corrupt_delta_stops_chain_at_last_intact_file(tmp_path):
    srv = ps_server.PSServer(snapshot_dir=str(tmp_path),
                             snapshot_mode="incremental")
    srv.create_table(_mk_spec("k", rows=100, dim=4))
    t = srv.tables["k"]
    srv.snapshot()  # base
    t.push_gradients(np.arange(5, dtype=np.int64),
                     np.ones((5, 4), np.float32))
    srv.snapshot()  # delta 0 (intact)
    after_first = t.to_dense().copy()
    t.push_gradients(np.arange(5, 10, dtype=np.int64),
                     np.ones((5, 4), np.float32))
    srv.snapshot()  # delta 1 (to be corrupted)
    m = json.load(open(tmp_path / "manifest.json"))
    victim = m["chains"]["k"]["deltas"][1]["file"]
    with open(tmp_path / victim, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    s2 = ps_server.PSServer(preload_dir=str(tmp_path))
    s2.create_table(_mk_spec("k", rows=100, dim=4))
    np.testing.assert_array_equal(s2.tables["k"].to_dense(), after_first)


# ---------------------------------------------------------------------------
# process layer (launcher end to end) — slow: replication chaos drills
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env(tmpdir, extra=None):
    env = dict(os.environ)
    for k in ("PADDLE_PSERVERS_IP_PORT_LIST", "PADDLE_TRAINERS_NUM",
              "PADDLE_PS_FAULT_SPEC", "FLAGS_ps_fault_injection",
              "PADDLE_PS_FAULT_TAGS", "PADDLE_PS_REPLICATION"):
        env.pop(k, None)
    env["PADDLE_DIST_TRACE_DIR"] = str(tmpdir)
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _launch_replicated(tmp_path, sub, extra_env=None, extra_args=(),
                       timeout=480):
    dist_dir = tmp_path / sub
    dist_dir.mkdir(exist_ok=True)
    log_dir = tmp_path / f"logs_{sub}"
    r = subprocess.run(
        [sys.executable, "-u", "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--started_port", str(_free_port()),
         "--server_num", "2", "--ps_replication", "2",
         "--log_dir", str(log_dir), *extra_args, WORKER],
        env=_env(dist_dir, extra_env), capture_output=True, text=True,
        timeout=timeout, cwd=REPO)
    logs = ""
    if log_dir.exists():
        for pth in sorted(log_dir.iterdir()):
            if pth.is_file():
                logs += f"\n--- {pth.name} ---\n" + pth.read_text()[-3000:]
    return r, dist_dir, logs


@pytest.mark.slow
def test_chaos_kill_primary_replicated_loss_parity(tmp_path):
    r_ref, ref_dir, logs = _launch_replicated(tmp_path, "ref")
    assert r_ref.returncode == 0, (
        f"no-fault run failed:\n{r_ref.stdout}\n{r_ref.stderr}\n{logs}")
    ref0 = json.load(open(ref_dir / "trace.0.json"))
    ref1 = json.load(open(ref_dir / "trace.1.json"))
    r, dist_dir, logs = _launch_replicated(
        tmp_path, "kill",
        extra_env={"FLAGS_ps_fault_injection": "1",
                   "PADDLE_PS_FAULT_SPEC": "kill:*:30",
                   "PADDLE_PS_FAULT_TAGS": "ps0",
                   "PADDLE_PS_CALL_DEADLINE_SECS": "2"},
        extra_args=("--elastic_retries", "1"))
    assert r.returncode == 0, (
        f"kill run failed rc={r.returncode}:\n{r.stdout}\n{r.stderr}\n{logs}")
    assert "promoting" in logs, f"no client failover observed:\n{logs}"
    t0 = json.load(open(dist_dir / "trace.0.json"))
    t1 = json.load(open(dist_dir / "trace.1.json"))
    assert t0["failovers"] + t1["failovers"] > 0, (t0, t1)
    assert t0["losses"] == ref0["losses"]
    assert t1["losses"] == ref1["losses"]
    assert t0["table_sum"] == ref0["table_sum"]
    assert t0["table_touched"] == ref0["table_touched"]


@pytest.mark.slow
def test_chaos_hedging_restores_tail_latency(tmp_path):
    r, dist_dir, logs = _launch_replicated(
        tmp_path, "hedge",
        extra_env={"FLAGS_ps_fault_injection": "1",
                   "PADDLE_PS_FAULT_SPEC": "slow:gather:4:400",
                   "PADDLE_PS_FAULT_TAGS": "ps0",
                   "PS_TEST_STEPS": "40",
                   "PADDLE_PS_HEDGE_MIN_SAMPLES": "8",
                   "PADDLE_PS_HEDGE_QUANTILE": "0.5"})
    assert r.returncode == 0, (
        f"hedge run failed rc={r.returncode}:\n{r.stdout}\n{r.stderr}\n{logs}")
    t0 = json.load(open(dist_dir / "trace.0.json"))
    t1 = json.load(open(dist_dir / "trace.1.json"))
    assert t0["hedges_won"] + t1["hedges_won"] > 0, (t0, t1)
    assert min(t0["gather_p95_ms"], t1["gather_p95_ms"]) < 400, (t0, t1)
