"""Chaos tests of the port's fault-tolerant PS data plane
(``paddle_tpu_torch/distributed/ps_server.py`` retry / dedup / recovery
and ``distributed/faults.py``), against the JAX package's, on the CPU.

Mirrors ``tests/test_ps_faults.py`` case for case; every fault is
injected on a deterministic schedule and the assertions are exact:

  fault layer   — the spec grammar, nth-match firing, the flag gate, the
                  repeating ``slow`` rule, the latching ``partition``
                  rule, tag scoping and the ``bitflip`` rule at the PS
                  client's ``push_grad`` site parse and fire as in the
                  JAX package
  unit layer    — dropped, refused and delayed RPCs leave the hosted
                  table bit for bit the un-faulted local oracle (a
                  replayed push applies once); the ``stats`` verb counts
                  exactly the injected faults; a restarted server
                  recovers its tables from the latest snapshot — the
                  JAX package's snapshot restored by the port's server
                  and the port's by the JAX package's; a bumped
                  generation resets a stale sync round; the epoch fence
                  rejects a deposed primary's forwards
  process layer — (slow) a 2-trainer + 1-pserver launcher job trains to
                  the exact no-fault loss under injected connection
                  drops, and completes after a mid-run pserver kill
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

from paddle_tpu.distributed import faults as jfaults
from paddle_tpu.distributed import ps_server as jps_server
from paddle_tpu_torch.distributed import faults, ps, ps_server
from paddle_tpu_torch.fluid import flags as fl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ps_worker.py")


@pytest.fixture
def server():
    """One port pserver on a free port, in a daemon thread."""
    addr, ready = {}, threading.Event()

    def cb(a):
        addr["ep"] = f"127.0.0.1:{a[1]}"
        ready.set()

    t = threading.Thread(target=ps_server.serve, args=(0, "127.0.0.1", cb),
                         daemon=True)
    t.start()
    assert ready.wait(10)
    yield addr["ep"]
    try:
        ps_server._Conn(addr["ep"]).call("shutdown")
    except Exception:
        pass
    t.join(timeout=5)


@pytest.fixture
def inject(monkeypatch):
    """Arm the port's fault layer with a spec; disarmed (and counters
    dropped) on teardown so no injection leaks into other tests."""

    def _arm(spec: str):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        fl.set_flags({"FLAGS_ps_fault_injection": True})
        faults.reset()

    yield _arm
    fl.set_flags({"FLAGS_ps_fault_injection": False})
    faults.reset()


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# fault layer itself
# ---------------------------------------------------------------------------


def test_fault_spec_parsing():
    spec = ("drop:gather:3;delay:push_gradients:2:0.5; refuse:*:1;kill:*:40;"
            "bitflip:push_grad:2:5")
    rules = faults.parse_spec(spec)
    want = jfaults.parse_spec(spec)
    assert [(r.action, r.method, r.nth, r.arg) for r in rules] == \
        [(r.action, r.method, r.nth, r.arg) for r in want]
    assert rules[1].arg == 0.5
    for bad in ("nonsense", "drop:gather", "boom:gather:1",
                "drop:gather:zero", "drop:gather:0"):
        with pytest.raises(ValueError):
            faults.parse_spec(bad)


def test_rule_fires_exactly_once_on_nth_match():
    inj = faults.FaultInjector("refuse:gather:3")
    inj.before_send("gather")
    inj.before_send("push_gradients")  # different verb: not counted
    inj.before_send("gather")
    with pytest.raises(faults.FaultError):
        inj.before_send("gather")  # 3rd: fires
    inj.before_send("gather")  # spent, never fires again


def test_injector_is_flag_gated(monkeypatch):
    monkeypatch.setenv(faults.ENV_SPEC, "drop:gather:1")
    fl.set_flags({"FLAGS_ps_fault_injection": False})
    faults.reset()
    assert faults.injector() is None  # spec set but flag off
    fl.set_flags({"FLAGS_ps_fault_injection": True})
    try:
        assert faults.injector() is not None
        monkeypatch.setenv(faults.ENV_SPEC, "")
        assert faults.injector() is None  # flag on but no spec
    finally:
        fl.set_flags({"FLAGS_ps_fault_injection": False})
        faults.reset()


def test_bitflip_rule_fires_at_push_grad(server, inject):
    """``bitflip:push_grad:<nth>[:<elem>]`` corrupts one element of the
    nth outgoing gradient of the PS client — the same bits as the JAX
    package's rule — and nothing else; flag off, the array passes
    through as the same object."""
    g = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    assert faults.bitflip_point("push_grad", g) is g
    inj = faults.FaultInjector("bitflip:push_grad:2:5")
    jinj = jfaults.FaultInjector("bitflip:push_grad:2:5")
    assert inj.at_bitflip_phase("push_grad", g) is g
    jinj.at_bitflip_phase("push_grad", g)
    got = inj.at_bitflip_phase("push_grad", g)
    np.testing.assert_array_equal(got, jinj.at_bitflip_phase("push_grad", g))
    assert (got != g).sum() == 1 and got.reshape(-1)[5] != g.reshape(-1)[5]
    # through the client: the 2nd push lands corrupted on the server
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=1)
    local = ps.ShardedHostTable("bf", (40, 4), **kw)
    remote = ps_server.RemoteTable("bf", (40, 4), [server], **kw)
    inject("bitflip:push_grad:2:0")
    ids = np.arange(3, dtype=np.int64)
    for _ in range(2):
        remote.push_gradients(ids, g)
        local.push_gradients(ids, g)
    diff = remote.to_dense() != local.to_dense()
    assert diff.sum() == 1 and diff[0, 0]
    remote.close()


# ---------------------------------------------------------------------------
# client retry / dedup (unit layer, in-thread server)
# ---------------------------------------------------------------------------


def test_gather_and_push_survive_faults_with_exact_parity(server, inject):
    kw = dict(num_shards=4, optimizer="adagrad", learning_rate=0.3, seed=3)
    local = ps.ShardedHostTable("f1", (300, 8), **kw)
    remote = ps_server.RemoteTable("f1", (300, 8), [server], **kw)
    inject("drop:push_gradients:2;refuse:push_gradients:4;"
           "drop:gather:1;refuse:gather:3;delay:gather:2:0.05")
    rng = np.random.RandomState(0)
    for _ in range(6):
        ids = rng.randint(0, 300, (24,)).astype(np.int64)
        np.testing.assert_array_equal(remote.gather(ids), local.gather(ids))
        g = rng.randn(24, 8).astype(np.float32)
        remote.push_gradients(ids, g)
        local.push_gradients(ids, g)
    np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
    assert remote.stats()["push_calls"] == 6
    remote.close()


def test_sync_barrier_push_replay_dedups(server, inject):
    """Trainer 0's push connection drops after sending; the round merges
    with the ORIGINAL contribution and the replay returns without
    re-applying.  Trainer 1 is the JAX package's client."""
    kw = dict(num_shards=4, optimizer="sgd", learning_rate=0.2, seed=5)
    oracle = ps.ShardedHostTable("f2", (200, 8), **kw)
    t0 = ps_server.RemoteTable("f2", (200, 8), [server], sync_trainers=2,
                               trainer_id=0, **kw)
    t1 = jps_server.RemoteTable("f2", (200, 8), [server], sync_trainers=2,
                                trainer_id=1, **kw)
    inject("drop:push_gradients:1")
    rng = np.random.RandomState(1)
    for _ in range(3):
        ids = rng.randint(0, 200, (16,)).astype(np.int64)
        g = rng.randn(16, 8).astype(np.float32)
        errs = []

        def push(t, i, gg):
            try:
                t.push_gradients(i, gg)
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        th = [threading.Thread(target=push, args=(t0, ids[:8], g[:8])),
              threading.Thread(target=push, args=(t1, ids[8:], g[8:]))]
        [x.start() for x in th]
        [x.join(30) for x in th]
        assert not errs, errs
        oracle.push_gradients(ids, g / 2.0)
        np.testing.assert_array_equal(t0.to_dense(), oracle.to_dense())
    t0.close(), t1.close()


def test_geo_delta_replay_dedups(server, inject):
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=9)
    local = ps.ShardedHostTable("f3", (100, 4), **kw)
    remote = ps_server.RemoteTable("f3", (100, 4), [server], **kw)
    inject("drop:push_delta:1")
    ids = np.arange(20, dtype=np.int64)
    d = np.full((20, 4), 0.25, np.float32)
    remote.push_delta(ids, d)  # dropped reply -> replay -> apply ONCE
    local.push_delta(ids, d)
    remote.push_delta(ids, d)
    local.push_delta(ids, d)
    np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
    remote.close()


def test_stats_verb_reports_retry_counts_matching_drop_spec(server, inject):
    """The ``stats`` verb accounts for exactly the faults the spec
    produced: 2 dropped pushes = 2 client retries, 2 retry-marked
    arrivals and 2 replay-dedup hits (deltas: the in-thread server shares
    the process registry)."""
    from paddle_tpu_torch import telemetry

    reg = telemetry.get_registry()

    def val(name, verb="push_gradients"):
        return reg.counter(name, verb=verb).value

    names = ("ps_client_retries_total", "ps_server_retry_received_total",
             "ps_server_replay_dedup_total", "ps_client_rpc_total",
             "ps_server_rpc_total")
    before = {n: val(n) for n in names}
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.2, seed=5)
    remote = ps_server.RemoteTable("f_stats", (100, 4), [server], **kw)
    inject("drop:push_gradients:2;drop:push_gradients:4")
    rng = np.random.RandomState(1)
    for _ in range(5):
        ids = rng.randint(0, 100, (10,)).astype(np.int64)
        remote.push_gradients(ids, rng.randn(10, 4).astype(np.float32))
    st = remote.stats()
    assert st["push_calls"] == 5
    assert val("ps_client_retries_total") - before[
        "ps_client_retries_total"] == 2
    assert val("ps_client_rpc_total") - before["ps_client_rpc_total"] == 5
    (tele,) = st["servers"]

    def server_val(name, verb="push_gradients"):
        for row in tele.get(name, {}).get("series", []):
            if row["labels"].get("verb") == verb:
                return row["value"]
        return 0

    for name, n in (("ps_server_retry_received_total", 2),
                    ("ps_server_replay_dedup_total", 2),
                    ("ps_server_rpc_total", 7)):
        assert server_val(name) - before[name] == n, name
    lat = tele.get("ps_server_rpc_ms", {}).get("series", [])
    assert any(r["labels"].get("verb") == "push_gradients" and r["count"]
               for r in lat)
    remote.close()


def test_retry_exhaustion_raises_connection_error(monkeypatch):
    monkeypatch.setattr(ps_server, "RPC_MAX_RETRIES", 2)
    monkeypatch.setattr(ps_server, "RPC_BACKOFF_BASE", 0.01)
    conn = ps_server._Conn(f"127.0.0.1:{_free_port()}")  # nobody listens
    t0 = time.time()
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        conn.call("ping")
    assert time.time() - t0 < 10


# ---------------------------------------------------------------------------
# snapshot recovery + generation reset (unit layer)
# ---------------------------------------------------------------------------


def _serve_on(mod, port, preload, snap):
    ready = threading.Event()
    t = threading.Thread(
        target=mod.serve, args=(port, "127.0.0.1", lambda a: ready.set()),
        kwargs=dict(preload_dir=preload, snapshot_dir=snap,
                    snapshot_secs=0.0), daemon=True)
    t.start()
    assert ready.wait(10)
    return t


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_pserver_restart_recovers_table_from_snapshot(tmp_path, first,
                                                      second):
    """Server A (one package) snapshots and dies; server B (the other)
    comes up on the SAME port preloading A's snapshot dir; the port's
    client rides the retry loop through the outage, re-creates the table
    and reads back the pre-crash state."""
    mods = {"jax": jps_server, "torch": ps_server}
    snap = str(tmp_path / "snaps")
    port = _free_port()
    ep = f"127.0.0.1:{port}"
    ta = _serve_on(mods[first], port, None, snap)
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=4)
    oracle = ps.ShardedHostTable("f4", (80, 4), **kw)
    remote = ps_server.RemoteTable("f4", (80, 4), [ep], **kw)
    ids = np.arange(40, dtype=np.int64)
    g = np.ones((40, 4), np.float32)
    remote.push_gradients(ids, g)
    oracle.push_gradients(ids, g)
    assert ps_server._Conn(ep).call("snapshot") == 1
    with open(os.path.join(snap, "f4.pkl"), "rb") as f:
        pickle.load(f)  # loadable, and no torn tmp files left behind
    assert not [p for p in os.listdir(snap) if ".tmp" in p]
    assert ps_server.read_snapshot_manifest(snap) == \
        jps_server.read_snapshot_manifest(snap)
    ps_server._Conn(ep).call("shutdown")
    ta.join(timeout=10)
    tb = _serve_on(mods[second], port, snap, snap)
    np.testing.assert_array_equal(remote.to_dense(), oracle.to_dense())
    remote.push_gradients(ids, g)  # and it keeps training
    oracle.push_gradients(ids, g)
    np.testing.assert_array_equal(remote.to_dense(), oracle.to_dense())
    remote.close()
    ps_server._Conn(ep).call("shutdown")
    tb.join(timeout=10)


def test_generation_bump_resets_stale_sync_round(server, monkeypatch):
    monkeypatch.setattr(ps_server, "SYNC_TIMEOUT", 60.0)
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.5, seed=7)
    dead = ps_server.RemoteTable("f5", (60, 4), [server], sync_trainers=2,
                                 trainer_id=0, generation=0, **kw)
    errs = []

    def stale_push():
        try:
            dead.push_gradients(np.arange(4, dtype=np.int64),
                                np.ones((4, 4), np.float32))
        except RuntimeError as e:
            errs.append(e)

    th = threading.Thread(target=stale_push, daemon=True)
    th.start()
    time.sleep(0.3)  # let the push park in the barrier
    t0 = ps_server.RemoteTable("f5", (60, 4), [server], sync_trainers=2,
                               trainer_id=0, generation=1, **kw)
    t1 = ps_server.RemoteTable("f5", (60, 4), [server], sync_trainers=2,
                               trainer_id=1, generation=1, **kw)
    th.join(timeout=10)  # woken by the reset, NOT by the 60 s timeout
    assert not th.is_alive(), "stale waiter still parked after reset"
    assert errs and "abandoned" in str(errs[0])
    oracle = ps.ShardedHostTable("f5o", (60, 4), **kw)
    ids = np.arange(8, dtype=np.int64)
    g = np.ones((8, 4), np.float32)
    ths = [threading.Thread(target=t.push_gradients,
                            args=(ids[i::2], g[i::2]))
           for i, t in enumerate((t0, t1))]
    [t.start() for t in ths]
    [t.join(30) for t in ths]
    oracle.push_gradients(ids, g / 2.0)
    np.testing.assert_array_equal(t0.to_dense(), oracle.to_dense())
    dead.close(), t0.close(), t1.close()


# ---------------------------------------------------------------------------
# process layer (launcher end to end) — slow: full chaos drills
# ---------------------------------------------------------------------------


def _env(tmpdir, extra=None):
    env = dict(os.environ)
    for k in ("PADDLE_PSERVERS_IP_PORT_LIST", "PADDLE_TRAINERS_NUM",
              "PADDLE_PS_FAULT_SPEC", "FLAGS_ps_fault_injection"):
        env.pop(k, None)
    env["PADDLE_DIST_TRACE_DIR"] = str(tmpdir)
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _launch_ps_job(tmp_path, extra_env=None, extra_args=(), timeout=480):
    dist_dir = tmp_path / "dist"
    dist_dir.mkdir(exist_ok=True)
    log_dir = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-u", "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--started_port", str(_free_port()),
         "--server_num", "1", "--log_dir", str(log_dir), *extra_args,
         WORKER],
        env=_env(dist_dir, extra_env), capture_output=True, text=True,
        timeout=timeout, cwd=REPO)
    logs = ""
    if log_dir.exists():
        for pth in sorted(log_dir.iterdir()):
            if pth.is_file():
                logs += f"\n--- {pth.name} ---\n" + pth.read_text()[-3000:]
    return r, logs


@pytest.mark.slow
def test_chaos_connection_drops_match_no_fault_loss(tmp_path):
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    r = subprocess.run([sys.executable, "-u", WORKER], env=_env(ref_dir),
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, f"single run failed:\n{r.stdout}\n{r.stderr}"
    ref = json.load(open(ref_dir / "trace.0.json"))
    dist_dir = tmp_path / "dist"
    r, logs = _launch_ps_job(tmp_path, {
        "FLAGS_ps_fault_injection": "1",
        "PADDLE_PS_FAULT_SPEC": ("drop:push_gradients:3;"
                                 "refuse:push_gradients:7;"
                                 "drop:gather:2;refuse:gather:5;"
                                 "delay:push_gradients:9:0.2"),
    })
    assert r.returncode == 0, (
        f"chaos job failed rc={r.returncode}:\n{r.stdout}\n{r.stderr}\n{logs}")
    t0 = json.load(open(dist_dir / "trace.0.json"))
    t1 = json.load(open(dist_dir / "trace.1.json"))
    avg = (np.asarray(t0["losses"]) + np.asarray(t1["losses"])) / 2.0
    np.testing.assert_allclose(avg, ref["losses"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t0["table_sum"], ref["table_sum"], rtol=1e-5)


# ---------------------------------------------------------------------------
# RPC deadline + replication fault rules
# ---------------------------------------------------------------------------


def test_call_deadline_bounds_wall_time_not_attempts(monkeypatch):
    monkeypatch.setattr(ps_server, "RPC_MAX_RETRIES", 10_000_000)
    monkeypatch.setattr(ps_server, "RPC_BACKOFF_BASE", 0.01)
    conn = ps_server._Conn(f"127.0.0.1:{_free_port()}", deadline=0.5)
    t0 = time.time()
    with pytest.raises(ConnectionError, match="deadline"):
        conn.call("ping")
    assert time.time() - t0 < 3.0


def test_call_deadline_off_keeps_attempt_bound(monkeypatch):
    monkeypatch.setattr(ps_server, "RPC_MAX_RETRIES", 2)
    monkeypatch.setattr(ps_server, "RPC_BACKOFF_BASE", 0.01)
    conn = ps_server._Conn(f"127.0.0.1:{_free_port()}", deadline=0)
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        conn.call("ping")


def test_slow_rule_fires_every_nth():
    inj = faults.FaultInjector("slow:gather:2:30")
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        inj.on_server_call("gather")
        times.append(time.perf_counter() - t0)
    assert [t > 0.02 for t in times] == [False, True] * 3, times
    inj.on_server_call("push_gradients")  # other verbs unaffected


def test_partition_rule_latches_and_blocks_replication(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_RANK_TAG", "ps1")
    inj = faults.FaultInjector("partition:ps1:3")
    for _ in range(2):
        inj.on_server_call("gather")
        assert not inj.blocks_replication()
    inj.on_server_call("push_gradients")
    assert inj.blocks_replication()
    inj.on_server_call("gather")
    assert inj.blocks_replication()  # latched
    monkeypatch.setenv("PADDLE_PS_RANK_TAG", "ps0")
    inj2 = faults.FaultInjector("partition:ps1:1")
    inj2.on_server_call("gather")
    assert not inj2.blocks_replication()


def test_fault_tags_scope_the_injector(monkeypatch):
    monkeypatch.setenv(faults.ENV_SPEC, "drop:gather:1")
    monkeypatch.setenv(faults.ENV_TAGS, "ps0")
    fl.set_flags({"FLAGS_ps_fault_injection": True})
    try:
        monkeypatch.setenv("PADDLE_PS_RANK_TAG", "ps1")
        faults.reset()
        assert faults.injector() is None  # not my tag
        monkeypatch.setenv("PADDLE_PS_RANK_TAG", "ps0")
        faults.reset()
        assert faults.injector() is not None
        monkeypatch.delenv("PADDLE_PS_RANK_TAG")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv(faults.ENV_TAGS, "trainer1")
        faults.reset()
        assert faults.injector() is not None  # trainer tags work too
    finally:
        fl.set_flags({"FLAGS_ps_fault_injection": False})
        faults.reset()


def _replicated_server(name):
    srv = ps_server.PSServer()
    srv.create_table({"name": name, "shape": (20, 4), "num_shards": 2,
                      "optimizer": "sgd", "learning_rate": 0.5, "seed": 1,
                      "partition": 0, "replicas": []})
    return srv, f"{name}@p0"


def test_stale_epoch_write_from_deposed_primary_rejected():
    srv, key = _replicated_server("d")
    ids = np.arange(4, dtype=np.int64)
    g = np.ones((4, 4), np.float32)
    srv.promote(key, epoch=2, backups=[])
    before = srv.tables[key].to_dense().copy()
    with pytest.raises(RuntimeError, match="StaleEpoch"):
        srv.replicate(key, epoch=1, seq=1, op="push_gradients", ids=ids,
                      payload=g)
    np.testing.assert_array_equal(srv.tables[key].to_dense(), before)
    srv.replicas[key].role = "backup"
    srv.replicas[key].seq = 5
    out = srv.replicate(key, epoch=2, seq=3, op="push_gradients", ids=ids,
                        payload=g)
    assert out == {"seq": 5}
    np.testing.assert_array_equal(srv.tables[key].to_dense(), before)
    with pytest.raises(RuntimeError, match="ReplicaGap"):
        srv.replicate(key, epoch=2, seq=9, op="push_gradients", ids=ids,
                      payload=g)


def test_deposed_primary_refuses_clients_until_resync():
    srv, key = _replicated_server("d2")
    srv.promote(key, epoch=0, backups=[])
    srv.replicas[key].stale = True  # deposed (forward was epoch-rejected)
    with pytest.raises(ps_server.StalePrimaryError):
        srv.push_gradients("d2", np.arange(2, dtype=np.int64),
                           np.ones((2, 4), np.float32), partition=0)
    with pytest.raises(ps_server.StalePrimaryError):
        srv.gather("d2", np.arange(2, dtype=np.int64), partition=0)


@pytest.mark.slow
def test_chaos_pserver_kill_recovers_from_snapshot(tmp_path):
    dist_dir = tmp_path / "dist"
    r, logs = _launch_ps_job(
        tmp_path,
        {"FLAGS_ps_fault_injection": "1",
         "PADDLE_PS_FAULT_SPEC": "kill:*:40",
         "PADDLE_PS_SNAPSHOT_SECS": "0.3"},
        extra_args=("--elastic_retries", "1"), timeout=480)
    assert "restarting it on the same port" in r.stderr, (
        f"no pserver respawn seen:\n{r.stderr}\n{logs}")
    assert r.returncode == 0, (
        f"job failed rc={r.returncode}:\n{r.stdout}\n{r.stderr}\n{logs}")
    t0 = json.load(open(dist_dir / "trace.0.json"))
    t1 = json.load(open(dist_dir / "trace.1.json"))
    assert np.isfinite(t0["losses"]).all() and np.isfinite(t1["losses"]).all()
    np.testing.assert_allclose(t0["table_sum"], t1["table_sum"], rtol=0)
