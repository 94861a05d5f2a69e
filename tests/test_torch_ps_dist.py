"""The port's cross-process parameter server (``paddle_tpu_torch/
distributed/ps_server.py``, the launcher's pserver mode and fleet's PS
roles) against the JAX package's, on the CPU.

Mirrors ``tests/test_ps_dist.py`` case for case:

  unit layer    — RemoteTable over an in-thread server is bit for bit
                  the in-process table, and the wire runs both ways: the
                  port's client against the JAX package's server and the
                  JAX package's client against the port's; the sync
                  barrier merges N trainers' pushes into the
                  single-process full-batch update
  process layer — ``python -m paddle_tpu_torch.distributed.launch
                  --server_num 1`` with 2 trainers (``tests/
                  torch_ps_worker.py``): the sync loss trace and table
                  match one process of the port AND one of the JAX
                  package (its ``tests/dist_ps_worker.py`` run in this
                  process, whose frozen projection the port's workers
                  load); geo and async train; a dead trainer fails the
                  job fast; an elastic restart finishes against the
                  surviving pserver
  fleet         — init_server(model_dir) preloads a table pickled by the
                  JAX package; run_server blocks until shutdown

Every launcher job of the module starts at once in a module fixture,
each test waits for its own with a deadline.
"""
from __future__ import annotations

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed import ps_server as jps_server
from paddle_tpu_torch.distributed import ps, ps_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ps_worker.py")
DEADLINE_S = 240


# ---------------------------------------------------------------------------
# in-thread servers (unit layer)
# ---------------------------------------------------------------------------


def _start(mod):
    addr, ready = {}, threading.Event()

    def cb(a):
        addr["ep"] = f"127.0.0.1:{a[1]}"
        ready.set()

    t = threading.Thread(target=mod.serve, args=(0, "127.0.0.1", cb),
                         daemon=True)
    t.start()
    assert ready.wait(10)
    return addr["ep"], t


def _stop(mod, ep, t):
    try:
        mod._Conn(ep).call("shutdown")
    except Exception:
        pass
    t.join(timeout=5)


@pytest.fixture
def server():
    """One port pserver on a free port, in a daemon thread."""
    ep, t = _start(ps_server)
    yield ep
    _stop(ps_server, ep, t)


@pytest.fixture
def jax_server():
    """One JAX-package pserver on a free port, in a daemon thread."""
    ep, t = _start(jps_server)
    yield ep
    _stop(jps_server, ep, t)


def test_remote_matches_local_bit_for_bit(server, jax_server):
    """Single server, same seed: the hosted table IS the local table —
    the port's client on the JAX package's server and the JAX package's
    client on the port's."""
    for client, ep in ((ps_server, jax_server), (jps_server, server)):
        local = ps.ShardedHostTable("u1", (500, 8), num_shards=4,
                                    optimizer="adagrad", learning_rate=0.3,
                                    seed=3)
        remote = client.RemoteTable("u1", (500, 8), [ep], num_shards=4,
                                    optimizer="adagrad", learning_rate=0.3,
                                    seed=3)
        np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
        rng = np.random.RandomState(0)
        for _ in range(5):
            ids = rng.randint(0, 500, (32,)).astype(np.int64)
            np.testing.assert_array_equal(remote.gather(ids),
                                          local.gather(ids))
            g = rng.randn(32, 8).astype(np.float32)
            remote.push_gradients(ids, g)
            local.push_gradients(ids, g)
        np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
        assert remote.stats()["push_calls"] == 5
        assert remote.nbytes() == local.nbytes()
        # checkpoint roundtrip through the wire
        state = remote.state_dict()
        remote.push_gradients(np.arange(10, dtype=np.int64),
                              np.ones((10, 8), np.float32))
        remote.load_state_dict(state)
        np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
        with pytest.raises((IndexError, RuntimeError)):
            remote.gather(np.asarray([500], np.int64))
        remote.close()


def test_create_table_idempotent_and_spec_checked(server):
    kw = dict(num_shards=2, optimizer="sgd", learning_rate=0.1, seed=1)
    a = ps_server.RemoteTable("u2", (100, 4), [server], **kw)
    b = jps_server.RemoteTable("u2", (100, 4), [server], **kw)  # trainer 2
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())
    with pytest.raises(RuntimeError, match="different spec"):
        ps_server.RemoteTable("u2", (100, 4), [server], num_shards=2,
                              optimizer="sgd", learning_rate=0.9, seed=1)
    a.close(), b.close()


def _push_pair(t0, t1, ids, g, half):
    errs = []

    def push(t, i, gg):
        try:
            t.push_gradients(i, gg)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    th = [threading.Thread(target=push, args=(t0, ids[:half], g[:half])),
          threading.Thread(target=push, args=(t1, ids[half:], g[half:]))]
    [x.start() for x in th]
    [x.join(30) for x in th]
    assert not errs, errs


def test_sync_barrier_merges_like_single_process(server):
    """Two clients (one of each package) push half-batches; the applied
    update equals ONE full-batch push of the mean-scaled gradient."""
    kw = dict(num_shards=4, optimizer="adagrad", learning_rate=0.2, seed=5)
    oracle = ps.ShardedHostTable("u3", (300, 8), **kw)
    t0 = ps_server.RemoteTable("u3", (300, 8), [server], sync_trainers=2,
                               trainer_id=0, **kw)
    t1 = jps_server.RemoteTable("u3", (300, 8), [server], sync_trainers=2,
                                trainer_id=1, **kw)
    rng = np.random.RandomState(1)
    for _ in range(4):
        ids = rng.randint(0, 300, (24,)).astype(np.int64)  # dupes likely
        g = rng.randn(24, 8).astype(np.float32)
        _push_pair(t0, t1, ids, g, 12)
        oracle.push_gradients(ids, g / 2.0)  # dp-mean convention
        np.testing.assert_array_equal(t0.to_dense(), oracle.to_dense())
    t0.close(), t1.close()


def test_sync_barrier_fails_fast_when_peer_missing(server, monkeypatch):
    monkeypatch.setattr(ps_server, "SYNC_TIMEOUT", 1.5)
    t0 = ps_server.RemoteTable("u4", (50, 4), [server], sync_trainers=2,
                               trainer_id=0, seed=0)
    with pytest.raises(RuntimeError, match="barrier timed out"):
        t0.push_gradients(np.asarray([1, 2], np.int64),
                          np.ones((2, 4), np.float32))
    t0.close()


def test_multi_server_round_robin_sharding():
    srvs = [_start(ps_server), _start(jps_server)]  # one of each package
    eps = [ep for ep, _ in srvs]
    try:
        t = ps_server.RemoteTable("u5", (101, 8), eps, num_shards=2,
                                  learning_rate=0.5, seed=2)
        dense = t.to_dense()
        assert dense.shape == (101, 8)
        ids = np.asarray([0, 1, 2, 99, 100, 1], np.int64)
        np.testing.assert_array_equal(t.gather(ids), dense[ids])
        g = np.ones((6, 8), np.float32)
        t.push_gradients(ids, g)
        after = t.to_dense()
        np.testing.assert_allclose(after[0], dense[0] - 0.5, rtol=1e-6)
        np.testing.assert_allclose(after[1], dense[1] - 2 * 0.5, rtol=1e-6)
        untouched = np.setdiff1d(np.arange(101), ids)
        np.testing.assert_array_equal(after[untouched], dense[untouched])
        # the JAX package's client reads the same partitioned table
        jt = jps_server.RemoteTable("u5", (101, 8), eps, num_shards=2,
                                    learning_rate=0.5, seed=2)
        np.testing.assert_array_equal(jt.to_dense(), after)
        t.close(), jt.close()
    finally:
        _stop(ps_server, *srvs[0])
        _stop(jps_server, *srvs[1])


def test_geo_client_over_the_wire(server):
    """GeoSGDClient is transport-agnostic: wrapping a RemoteTable behaves
    exactly like wrapping the local table."""
    kw = dict(num_shards=4, optimizer="sgd", learning_rate=0.5, seed=9)
    local = ps.GeoSGDClient(ps.ShardedHostTable("u6", (200, 8), **kw),
                            sync_steps=3)
    remote = ps.GeoSGDClient(
        ps_server.RemoteTable("u6", (200, 8), [server], **kw), sync_steps=3)
    rng = np.random.RandomState(4)
    for _ in range(7):
        ids = rng.randint(0, 200, (16,)).astype(np.int64)
        g = rng.randn(16, 8).astype(np.float32)
        np.testing.assert_array_equal(remote.gather(ids), local.gather(ids))
        remote.push_gradients(ids, g)
        local.push_gradients(ids, g)
    np.testing.assert_array_equal(remote.to_dense(), local.to_dense())
    remote.server.close()


def test_each_package_trains_against_the_other_packages_pserver(
        server, jax_server):
    """A transpiled program of each package trains through a pserver of
    the other: the same loss trace and table as an in-process table."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid

    def run(fluid, mod, kw, pservers, name):
        mod.drop_table(name)
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            ids = L.data("ids", [16], dtype="int64",
                         append_batch_size=False)
            y = L.data("y", [16, 1], dtype="int64", append_batch_size=False)
            emb = L.embedding(ids, size=[3000, 16],
                              param_attr=fluid.ParamAttr(name=name))
            proj = L.fc(emb, 5, param_attr=fluid.ParamAttr(
                name="proj", trainable=False,
                initializer=fluid.initializer.ConstantInitializer(0.1)),
                bias_attr=False)
            loss = L.mean(L.softmax_with_cross_entropy(proj, y))
            cfg = fluid.DistributeTranspilerConfig()
            cfg.server_learning_rate = 0.5
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fluid.DistributeTranspiler(cfg).transpile(
                    trainer_id=0, program=main, startup_program=startup,
                    pservers=pservers, trainers=1)
            fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        exe = fluid.Executor(**kw)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        v = rng.randint(0, 3000, (16,)).astype(np.int64)
        feed = {"ids": v, "y": (v % 5)[:, None]}
        losses = [float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(()))
            for _ in range(6)]
        dense = mod.get_table(name).to_dense()
        mod.drop_table(name)
        return losses, dense

    import paddle_tpu_torch.fluid as _tf  # noqa: F401

    ref = run(tfluid, ps, {"device": "cpu"}, "", "xw_ref")
    via_jax = run(tfluid, ps, {"device": "cpu"}, jax_server, "xw_t")
    via_port = run(jfluid, jps, {}, server, "xw_j")
    np.testing.assert_allclose(via_jax[0], ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(via_jax[1], ref[1])
    np.testing.assert_allclose(via_port[0], ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(via_port[1], ref[1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# process layer (launcher end to end): every job starts at once
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env(trace_dir, extra=None):
    env = dict(os.environ)
    for k in ("PADDLE_PSERVERS_IP_PORT_LIST", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID", "PADDLE_PS_FAULT_SPEC",
              "FLAGS_ps_fault_injection", "PADDLE_PS_REPLICATION",
              "PADDLE_TRAINING_ROLE", "PADDLE_PORT"):
        env.pop(k, None)
    env["PADDLE_DIST_TRACE_DIR"] = str(trace_dir)
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


# name -> (launcher args or None for one process, extra env)
JOBS = {
    "ref": (None, {}),
    "sync": (("--server_num", "1"), {}),
    "geo": (("--server_num", "1"), {"PS_TEST_MODE": "geo"}),
    "async": (("--server_num", "1"), {"PS_TEST_MODE": "async"}),
    "dead": (("--server_num", "1"),
             {"PS_TEST_KILL_RANK": "1", "PADDLE_PS_SYNC_TIMEOUT": "4"}),
    "elastic": (("--server_num", "1", "--elastic_retries", "1"),
                {"PS_TEST_KILL_RANK": "1", "PS_TEST_CRASH_ONCE": "1",
                 "PADDLE_PS_SYNC_TIMEOUT": "30"}),
}


class _Job:
    def __init__(self, name, root, proj):
        args, extra = JOBS[name]
        self.dir = root / name
        self.dir.mkdir()
        self.logs = self.dir / "logs"
        env = _env(self.dir, dict(extra, PS_TEST_PROJ_W=str(proj)))
        if args is None:
            cmd = [sys.executable, "-u", WORKER]
        else:
            cmd = [sys.executable, "-u", "-m",
                   "paddle_tpu_torch.distributed.launch",
                   "--nproc_per_node", "2", "--started_port",
                   str(_free_port()), "--log_dir", str(self.logs), *args,
                   WORKER]
        self.t0 = time.time()
        self.proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=REPO, start_new_session=True)

    def wait(self):
        try:
            _, self.stderr = self.proc.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
            raise
        self.seconds = time.time() - self.t0
        return self.proc.returncode

    def worker_logs(self):
        out = ""
        if self.logs.exists():
            for p in sorted(self.logs.iterdir()):
                if p.is_file():
                    out += f"\n--- {p.name} ---\n" + p.read_text()[-3000:]
        return out

    def trace(self, rank):
        with open(self.dir / f"trace.{rank}.json") as f:
            return json.load(f)


def _jax_reference(out_dir):
    """The JAX package's own worker, one process, run here: its trace and
    its frozen projection (which the port's workers load)."""
    import importlib.util

    import paddle_tpu.fluid as jfluid

    spec = importlib.util.spec_from_file_location(
        "dist_ps_worker", os.path.join(REPO, "tests", "dist_ps_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("PADDLE_PSERVERS_IP_PORT_LIST", "PADDLE_TRAINERS_NUM",
                  "PADDLE_TRAINER_ID", "PS_TEST_MODE", "PADDLE_TRAINING_ROLE"):
            mp.delenv(k, raising=False)
        mp.setenv("PADDLE_DIST_TRACE_DIR", str(out_dir))
        jps.drop_table("ps_dist_table")
        scope = jfluid.Scope()
        with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
            mod.main()
            proj = np.asarray(scope.find_var("proj_w"))
        jps.drop_table("ps_dist_table")
    with open(out_dir / "trace.0.json") as f:
        return json.load(f), proj


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ps_jobs")
    jax_dir = root / "jax_ref"
    jax_dir.mkdir()
    jax_ref, proj = _jax_reference(jax_dir)
    np.save(root / "proj_w.npy", proj)
    started = {name: _Job(name, root, root / "proj_w.npy") for name in JOBS}
    started["jax_ref"] = jax_ref
    yield started
    for name, job in started.items():
        if name != "jax_ref" and job.proc.poll() is None:
            os.killpg(job.proc.pid, signal.SIGKILL)
            job.proc.communicate()


def _ok(job):
    rc = job.wait()
    assert rc == 0, f"rc={rc}:\n{job.stderr}\n{job.worker_logs()}"


def test_two_process_ps_training_matches_single(jobs):
    """A 2-trainer + 1-pserver job whose loss trace matches one process:
    sync mode merges both trainers' half-batch gradients into the
    single-process full-batch update, so avg(rank losses) == the
    single-process loss — the port's one process and the JAX package's."""
    ref_job, job = jobs["ref"], jobs["sync"]
    _ok(ref_job)
    _ok(job)
    assert "1 pserver(s) on" in job.stderr
    ref, jref = ref_job.trace(0), jobs["jax_ref"]
    np.testing.assert_allclose(ref["losses"], jref["losses"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ref["table_sum"], jref["table_sum"],
                               rtol=1e-5)
    t0, t1 = job.trace(0), job.trace(1)
    avg = (np.asarray(t0["losses"]) + np.asarray(t1["losses"])) / 2.0
    for want in (ref, jref):
        np.testing.assert_allclose(avg, want["losses"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(t0["table_sum"], want["table_sum"],
                                   rtol=1e-5)
        np.testing.assert_allclose(t0["table_touched"],
                                   want["table_touched"], rtol=1e-4,
                                   atol=1e-5)
    # both ranks observed the SAME hosted table
    assert t0["table_sum"] == t1["table_sum"]
    assert t0["table_touched"] == t1["table_touched"]
    assert avg[-1] < avg[0]


def test_two_process_geo_ps_trains(jobs):
    job = jobs["geo"]
    _ok(job)
    t0, t1 = job.trace(0), job.trace(1)
    assert t0["losses"][-1] < t0["losses"][0]
    assert t1["losses"][-1] < t1["losses"][0]


def test_dead_trainer_fails_the_job_fast(jobs):
    """Rank 1 hard-exits mid-run; rank 0's next sync push hits the
    barrier timeout and fails (no hang) and the launcher aborts."""
    job = jobs["dead"]
    rc = job.wait()
    assert rc != 0, "job must fail when a trainer dies"
    assert "aborting the job" in job.stderr, job.stderr
    assert job.seconds < 180, f"fail-fast took {job.seconds:.0f}s"


def test_two_process_async_ps_trains(jobs):
    """Async (Downpour) over the wire: no barrier, no exact parity, but
    training converges and both ranks share one table (bounded by one
    run of unsynced half-batch pushes)."""
    job = jobs["async"]
    _ok(job)
    t0, t1 = job.trace(0), job.trace(1)
    assert t0["losses"][-1] < t0["losses"][0]
    assert t1["losses"][-1] < t1["losses"][0]
    bound = 12 * 0.5 * 16 * 16
    assert abs(t0["table_sum"] - t1["table_sum"]) < bound


def test_elastic_restart_with_surviving_pserver(jobs):
    """The pserver outlives an elastic trainer-group restart: rank 1
    crashes once; the respawned group (bumped generation, fresh sync
    barrier) finishes against the SAME server."""
    job = jobs["elastic"]
    rc = job.wait()
    assert "elastic restart 1/1" in job.stderr, job.stderr
    assert rc == 0, f"rc={rc}:\n{job.stderr}\n{job.worker_logs()}"
    t0, t1 = job.trace(0), job.trace(1)
    assert len(t0["losses"]) == len(t1["losses"])
    assert t0["table_sum"] == t1["table_sum"]
    assert np.isfinite(t0["losses"]).all()


# ---------------------------------------------------------------------------
# fleet's PS roles
# ---------------------------------------------------------------------------


def _wait_up(ep):
    for _ in range(100):
        try:
            if ps_server._Conn(ep, deadline=1.0).call("ping") == "pong":
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"no pserver on {ep}")


def test_fleet_server_lifecycle_with_preload(tmp_path, monkeypatch):
    """fleet.init_server(model_dir)/run_server/init_worker/stop_worker:
    the server preloads a table the JAX package pickled, the port's
    trainer connects, trains and flushes through the fleet surface."""
    import paddle_tpu_torch.fleet as fleet

    seed_table = jps.ShardedHostTable("lc_tbl", (60, 4), num_shards=2,
                                      learning_rate=0.5, seed=11)
    seed_table.push_gradients(np.arange(60, dtype=np.int64),
                              np.ones((60, 4), np.float32))
    want = seed_table.to_dense().copy()
    with open(tmp_path / "lc_tbl.pkl", "wb") as f:
        pickle.dump(seed_table.state_dict(), f)
    port = _free_port()
    monkeypatch.setenv("PADDLE_PORT", str(port))
    ep = f"127.0.0.1:{port}"

    def run_srv():
        fleet.init_server(model_dir=str(tmp_path))
        fleet.run_server()

    threading.Thread(target=run_srv, daemon=True).start()
    _wait_up(ep)
    ps.drop_table("lc_tbl")
    try:
        fleet.init_worker(device="cpu")
        t = ps.create_table("lc_tbl", shape=(60, 4), num_shards=2,
                            learning_rate=0.5, seed=11, endpoints=[ep])
        np.testing.assert_array_equal(t.gather(np.arange(60)), want)
        with open(tmp_path / "lc_bad.pkl", "wb") as f:
            pickle.dump(seed_table.state_dict(), f)  # 60 rows
        with pytest.raises(RuntimeError, match="geometry"):
            ps.create_table("lc_bad", shape=(30, 4), num_shards=2,
                            endpoints=[ep])
        ps.drop_table("lc_bad")
        st = fleet.ps_stats("lc_tbl")["lc_tbl"]
        assert st["push_calls"] == 0 and len(st["servers"]) == 1
        assert fleet.membership() is None  # no control plane armed
        fleet.stop_worker()  # closes AND unregisters the client
        assert "lc_tbl" not in ps._tables
    finally:
        ps.drop_table("lc_tbl")
        try:
            ps_server._Conn(ep).call("shutdown")
        except Exception:
            pass


def test_fleet_run_server_blocks_and_shuts_down(monkeypatch):
    """fleet.run_server() hosts on PADDLE_PORT until shutdown; without
    PADDLE_PORT it refuses to bind an undiscoverable port."""
    import paddle_tpu_torch.fleet as fleet

    monkeypatch.delenv("PADDLE_PORT", raising=False)
    with pytest.raises(RuntimeError, match="PADDLE_PORT"):
        fleet.run_server()
    port = _free_port()
    monkeypatch.setenv("PADDLE_PORT", str(port))
    fleet.init_server()
    th = threading.Thread(target=fleet.run_server, daemon=True)
    th.start()
    ep = f"127.0.0.1:{port}"
    _wait_up(ep)
    ps_server._Conn(ep).call("shutdown")
    th.join(timeout=10)
    assert not th.is_alive(), "run_server must return after shutdown"
