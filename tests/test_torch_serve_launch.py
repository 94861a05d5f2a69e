"""Serving under the port's launcher (``python -m
paddle_tpu_torch.distributed.launch --serve``) against the JAX
package's, on the CPU.

Every launcher job of the module starts at once in a module fixture and
each test waits for its own, with a deadline (as
``test_torch_ps_dist.py`` does):

* ``drill`` — the kill-one-of-two drill of the JAX package's
  ``tests/test_serving.py:755`` at tier-1 size: two replicas of a tiny
  fc model (``--device cpu``) with live weights, heartbeats, leases and
  the generation engine on a ``--serve_kv_pages`` pool; the weights are
  published before the start, both replicas adopt them, a client
  streams, replica 0 is SIGKILLed and respawned in place, re-adopts and
  answers bit for bit like the survivor; SIGTERM to each replica drains
  the job, which exits 0.
* ``jax_drill`` — the same job under the JAX launcher (its replicas
  follow the same weight table): each replica's env protocol, the
  coordinator's member table and the respawn line against the port's.
* ``budget`` / ``jax_budget`` — replica 0 always dies (its port is
  held by a listening socket of the test's): the respawn lines, the
  group restart and the exit code once every budget is spent, port
  against JAX.
* ``stale`` / ``jax_stale`` — a replica SIGSTOPped after it is healthy
  stops heartbeating, and the launcher aborts the group with 124.  The
  port's replicas stamp under their rank, which the monitor reads; the
  JAX package's stamp under their tag, so its monitor reads every
  replica as never stamped and aborts once the startup grace (here
  PADDLE_HEARTBEAT_STARTUP_GRACE, 6 s) runs out, stopped or not.

Replica pids come from ``/proc/<launcher pid>/task/*/children`` and
their environment from ``/proc/<pid>/environ``.
"""
from __future__ import annotations

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.distributed import ps_server as tps
from paddle_tpu_torch.distributed.coordinator import CoordinatorClient
from paddle_tpu_torch.distributed.ps_server import _Conn
from paddle_tpu_torch.inference import weight_sync as ws
from paddle_tpu_torch.inference.client import InferenceClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = "serve_launch_w"
KV_PAGES = 40
JOB_DEADLINE = 150.0


def _free_base(n):
    """A base port with n free ports after it."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n >= 65000:
            continue
        ok = True
        for p in range(base, base + n):
            t = socket.socket()
            try:
                t.bind(("127.0.0.1", p))
            except OSError:
                ok = False
            finally:
                t.close()
        if ok:
            return base
    raise RuntimeError("no free port range")


def _children(pid):
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                out += [int(x) for x in f.read().split()]
        except OSError:
            pass
    return out


def _kill_tree(pid):
    """SIGKILL ``pid`` and every process under it, children first: a
    launcher killed alone would leave its replicas serving."""
    for kid in _children(pid):
        _kill_tree(kid)
    try:
        os.kill(pid, signal.SIGKILL)
    except OSError:
        pass


def _environ(pid):
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    return dict(kv.split("=", 1) for kv in raw.decode().split("\0")
                if "=" in kv)


def _replica_pid(launcher_pid, rank):
    for pid in _children(launcher_pid):
        if _environ(pid).get("PADDLE_TRAINER_ID") == str(rank):
            return pid
    return None


def _healthy(eps, timeout):
    deadline = time.time() + timeout
    pending = set(eps)
    while pending and time.time() < deadline:
        for ep in list(pending):
            conn = _Conn(ep, deadline=1.0, io_timeout=5.0)
            try:
                if conn.call("health").get("ok"):
                    pending.discard(ep)
            except Exception:  # noqa: BLE001
                pass
            finally:
                conn.close()
        time.sleep(0.2)
    return not pending


def _call(ep, verb, timeout=10.0, **kw):
    conn = _Conn(ep, deadline=timeout, io_timeout=30.0)
    try:
        return conn.call(verb, **kw)
    finally:
        conn.close()


def _epoch_at_least(eps, n, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if all(int(_call(ep, "health").get("weight_epoch", 0)) >= n
                   for ep in eps):
                return True
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.2)
    return False


class _Job:
    def __init__(self, name, pkg, base, argv, tmp, env=None):
        self.name, self.pkg, self.base = name, pkg, base
        self.eps = [f"127.0.0.1:{base + r}" for r in range(2)]
        self.dir = tmp / name
        self.dir.mkdir()
        self.err_path = self.dir / "launcher.err"
        full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        for k in [k for k in full if k.startswith("PADDLE_")]:
            del full[k]
        full.update(env or {})
        mod = ("paddle_tpu_torch" if pkg == "torch" else "paddle_tpu") \
            + ".distributed.launch"
        self.err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", mod, "--serve",
             "--nproc_per_node", "2", "--started_port", str(base),
             "--log_dir", str(self.dir / "logs")] + argv,
            env=full, cwd=REPO, stdout=self.err, stderr=subprocess.STDOUT)
        self.result = {}
        self.error = None
        self.thread = None

    def run(self, body):
        def go():
            try:
                body(self)
            except Exception as e:  # noqa: BLE001 — reported by the test
                self.error = e
            finally:
                if self.proc.poll() is None:
                    try:
                        self.proc.wait(timeout=JOB_DEADLINE)
                    except subprocess.TimeoutExpired:
                        _kill_tree(self.proc.pid)
                        self.proc.wait()
                self.err.close()

        self.thread = threading.Thread(target=go, daemon=True)
        self.thread.start()

    def finish(self):
        self.thread.join(JOB_DEADLINE + 30)
        if self.proc.poll() is None:
            _kill_tree(self.proc.pid)
            self.proc.wait()
        if self.error is not None:
            raise AssertionError(
                f"{self.name}: {self.error!r}\n--- launcher ---\n"
                + self.err_path.read_text()[-3000:]) from self.error
        return self.result

    def lines(self):
        return [ln for ln in self.err_path.read_text().splitlines()
                if ln.startswith("[launch]")]


def _protocol(job, pid):
    """A replica's PADDLE_* environment, its ports and paths masked."""
    out = {}
    for k, v in _environ(pid).items():
        if not k.startswith("PADDLE_") or k == "PADDLE_DIST_RENDEZVOUS":
            continue
        for r, ep in enumerate(job.eps):
            v = v.replace(ep, f"EP{r}")
        v = re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "ADDR", v)
        out[k] = "PATH" if v.startswith("/") else v
    return out


def _members(job, pkg_client):
    pid = _replica_pid(job.proc.pid, 0)
    ep = _environ(pid)["PADDLE_COORDINATOR_ENDPOINT"]
    cli = pkg_client(ep, deadline=5.0)
    try:
        table = cli.call("membership")["members"]
    finally:
        cli.close()
    eps = {ep: f"EP{r}" for r, ep in enumerate(job.eps)}
    return {t: (m["kind"], eps.get(m.get("endpoint"), m.get("endpoint")))
            for t, m in table.items()}


def _drill(job):
    """Adopt, stream, kill replica 0, respawn, re-adopt, drain."""
    r = job.result
    assert _healthy(job.eps, 90), "replicas never became healthy"
    assert _epoch_at_least(job.eps, 1, 30), "weight adoption never landed"
    r["protocol"] = {
        rank: _protocol(job, _replica_pid(job.proc.pid, rank))
        for rank in range(2)}
    time.sleep(0.5)  # the first lease renewals land (kind "inference")
    r["members"] = _members(job, job.client_cls)
    cli = InferenceClient(job.eps, deadline_secs=8.0, hedge_quantile=0)
    if job.pkg == "torch":
        r["stats"] = [_call(ep, "stats") for ep in job.eps]
        r["gen"] = [_call(ep, "generate", timeout=30.0,
                          prompt=[3, 9, 1, 4], max_new_tokens=4)["tokens"]
                    for ep in job.eps]
    stop = threading.Event()
    errors, outputs = [], []

    def stream():
        while not stop.is_set():
            try:
                out = cli.infer({"x": job.xa}, deadline_ms=8000)
                outputs.append(np.asarray(out.outputs[0]))
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
            time.sleep(0.02)

    th = threading.Thread(target=stream, daemon=True)
    th.start()
    time.sleep(1.0)
    victim = _replica_pid(job.proc.pid, 0)
    assert victim is not None, "no replica pid found"
    t_kill = time.time()
    os.kill(victim, signal.SIGKILL)
    assert _healthy([job.eps[0]], 90), "killed replica never respawned"
    time.sleep(0.5)
    stop.set()
    th.join(timeout=20)
    r["errors"], r["outputs"] = errors, outputs
    r["survivor"] = _call(job.eps[1], "health")
    r["t_kill"] = t_kill
    r["t_done"] = time.time()
    assert _epoch_at_least([job.eps[0]], 1, 30), "no re-adoption"
    r["respawned"] = _call(job.eps[0], "infer", feed={"x": job.xa},
                           deadline_ms=8000.0)
    r["survivor_out"] = _call(job.eps[1], "infer", feed={"x": job.xa},
                              deadline_ms=8000.0)
    r["respawn_pid"] = _replica_pid(job.proc.pid, 0)
    if job.pkg == "torch":
        r["stats_after"] = _call(job.eps[0], "stats")
        hb_dir = _environ(r["respawn_pid"])["PADDLE_HEARTBEAT_DIR"]
        r["stamps"] = [os.path.getmtime(os.path.join(hb_dir,
                                                     f"heartbeat.{rank}"))
                       for rank in range(2)]
    cli.close()
    # SIGTERM drains each replica; a drained job exits 0
    for rank in range(2):
        os.kill(_replica_pid(job.proc.pid, rank), signal.SIGTERM)
    r["rc"] = job.proc.wait(timeout=60)


def _budget(job):
    try:
        job.result["rc"] = job.proc.wait(timeout=JOB_DEADLINE)
    finally:
        job.blocker.close()


def _stale(job):
    if job.pkg == "jax":  # aborts at the grace, healthy replicas or not
        job.result["rc"] = job.proc.wait(timeout=JOB_DEADLINE)
        return
    assert _healthy(job.eps, 90), "replicas never became healthy"
    time.sleep(6.0)  # past the 5 s timeout: fresh stamps hold it off
    assert job.proc.poll() is None
    pid = _replica_pid(job.proc.pid, 1)
    os.kill(pid, signal.SIGSTOP)
    try:
        job.result["rc"] = job.proc.wait(timeout=60)
    finally:
        try:
            os.kill(pid, signal.SIGKILL)
            os.kill(pid, signal.SIGCONT)
        except OSError:
            pass


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    from paddle_tpu.distributed.coordinator import CoordinatorClient as JCC

    tmp = tmp_path_factory.mktemp("serve_launch")
    model = str(tmp / "model")
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", [8], dtype="float32")
        h = jfluid.layers.fc(x, 16, act="relu")
        pred = jfluid.layers.fc(h, 4)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.executor.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(model, ["x"], [pred], exe,
                                       main_program=main)

    # the weight table, on a pserver of the port's in this process,
    # published BEFORE the jobs start: a replica has adopted iff it
    # serves these
    ps = tps._TCPServer(("127.0.0.1", 0), tps._Handler)
    ps.ps = tps.PSServer()
    threading.Thread(target=ps.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    ps_ep = f"127.0.0.1:{ps.server_address[1]}"
    frozen = inference.load_frozen(model, device="cpu")
    plan = ws.plan_for_frozen(frozen)
    tbl = tps.RemoteTable(TABLE, ws.table_shape(plan), [ps_ep],
                          **ws.table_kwargs(plan))
    live = {n: frozen.scope.find_var(n).numpy() * 2.0 for n in plan.names()}
    ws.WeightPublisher(tbl, plan).publish(live)
    xa = np.random.RandomState(0).rand(1, 8).astype(np.float32)
    # the oracle: the port's predictor with the live weights, at the
    # replicas' padded batch of 4
    pad = {"x": np.concatenate([xa, np.zeros((3, 8), np.float32)])}
    pred_live = inference.ServingPredictor(frozen, device="cpu")
    static = np.asarray(pred_live.run(pad)[0])[:1]
    pred_live.adopt_weights(ws.unpack(plan, ws.pack(plan, live)))
    oracle = np.asarray(pred_live.run(pad)[0])[:1]

    wenv = {"PADDLE_SERVE_WEIGHT_TABLE": TABLE,
            "PADDLE_SERVE_WEIGHT_ENDPOINTS": ps_ep,
            "PADDLE_SERVE_WEIGHT_POLL_SECS": "0.2",
            "PADDLE_SERVE_GEN": "1"}
    drill_argv = ["--elastic_retries", "2", "--lease_secs", "5",
                  "--serve_kv_cache", "1", "--serve_kv_pages",
                  str(KV_PAGES)]
    n_ports = 8
    base = _free_base(2 * n_ports)
    specs = [
        ("drill", "torch", drill_argv + [
            "--heartbeat_timeout", "10", model, "--max_batch", "4",
            "--device", "cpu"], wenv, _drill),
        ("jax_drill", "jax", drill_argv + [model, "--max_batch", "4"],
         wenv, _drill),
        ("budget", "torch", ["--elastic_retries", "1",
                             "--elastic_retries_per_rank", "1",
                             "--min_world_size", "2", model,
                             "--max_batch", "2", "--device", "cpu"],
         {"PADDLE_SERVE_WEIGHT_SYNC": "0"}, _budget),
        ("jax_budget", "jax", ["--elastic_retries", "1",
                               "--elastic_retries_per_rank", "1",
                               "--min_world_size", "2", model,
                               "--max_batch", "2"],
         {"PADDLE_SERVE_WEIGHT_SYNC": "0"}, _budget),
        ("stale", "torch", ["--heartbeat_timeout", "5", model,
                            "--max_batch", "2", "--device", "cpu"],
         {"PADDLE_SERVE_WEIGHT_SYNC": "0"}, _stale),
        ("jax_stale", "jax", ["--heartbeat_timeout", "5", model,
                              "--max_batch", "2"],
         {"PADDLE_SERVE_WEIGHT_SYNC": "0",
          "PADDLE_HEARTBEAT_STARTUP_GRACE": "6"}, _stale),
    ]
    out = {}
    for i, (name, pkg, argv, env, body) in enumerate(specs):
        blocker = None
        if body is _budget:
            # replica 0's port held: it dies at its bind, every time
            blocker = socket.socket()
            blocker.bind(("127.0.0.1", base + 2 * i))
            blocker.listen(1)
        job = _Job(name, pkg, base + 2 * i, argv, tmp, env)
        job.blocker = blocker
        job.xa = xa
        job.client_cls = CoordinatorClient if pkg == "torch" else JCC
        job.run(body)
        out[name] = job
    yield {"jobs": out, "oracle": oracle, "static": static, "xa": xa,
           "live": live}
    for job in out.values():
        if job.proc.poll() is None:
            _kill_tree(job.proc.pid)
            job.proc.wait()
    tbl.close()
    ps.shutdown()
    ps.server_close()


def test_kill_one_of_two_replicas_respawns_in_place(jobs):
    job = jobs["jobs"]["drill"]
    r = job.finish()
    # zero accepted requests lost across the kill
    assert not r["errors"], r["errors"][:3]
    assert len(r["outputs"]) >= 10
    # one weight epoch throughout, the published weights (the oracle's
    # bits), not the on-disk ones
    for o in r["outputs"]:
        np.testing.assert_array_equal(o, jobs["oracle"])
    assert not np.array_equal(jobs["oracle"], jobs["static"])
    # per-replica respawn: the survivor never blipped
    assert r["survivor"]["uptime_s"] > r["t_done"] - r["t_kill"]
    # the respawned replica re-adopted and answers bit for bit like the
    # survivor
    assert r["respawned"]["weight_epoch"] >= 1
    np.testing.assert_array_equal(r["respawned"]["outputs"][0],
                                  r["survivor_out"]["outputs"][0])
    np.testing.assert_array_equal(r["respawned"]["outputs"][0],
                                  jobs["oracle"])
    lines = job.lines()
    assert sum("respawning in place (1/2)" in ln for ln in lines) == 1
    assert not any("aborting" in ln or "heartbeating" in ln
                   for ln in lines)
    # both replicas stamp under their rank; the respawn's is its own
    assert min(r["stamps"]) > r["t_kill"]
    # drained by SIGTERM: every replica exited 0, so the job did
    assert r["rc"] == 0
    for rank in range(2):
        log = (job.dir / "logs" / f"workerlog.{rank}").read_text()
        assert "SIGTERM: draining" in log and "Traceback" not in log


def test_kv_pages_and_generate_reach_the_replicas(jobs):
    r = jobs["jobs"]["drill"].finish()
    for st in r["stats"] + [r["stats_after"]]:
        assert st["generation"]["mode"] == "paged"
        assert st["generation"]["kv_pool"]["n_pages"] == KV_PAGES
        assert st["weight_sync"]["enabled"] is True
    # both replicas run the same decoder at the same seed
    assert r["gen"][0] == r["gen"][1] and len(r["gen"][0]) == 4


def test_env_protocol_members_and_respawn_line_match_the_jax_launcher(jobs):
    t = jobs["jobs"]["drill"].finish()
    jjob = jobs["jobs"]["jax_drill"]
    j = jjob.finish()
    assert not j["errors"], j["errors"][:3]
    for rank in range(2):
        tp, jp = t["protocol"][rank], j["protocol"][rank]
        tp.pop("PADDLE_SERVE_KV_CACHE"), jp.pop("PADDLE_SERVE_KV_CACHE")
        assert tp == jp, rank
        assert tp["PADDLE_CURRENT_ENDPOINT"] == f"EP{rank}"
        assert tp["PADDLE_SERVE_KV_PAGES"] == str(KV_PAGES)
    assert t["members"] == j["members"] == {
        "trainer0": ("inference", "EP0"), "trainer1": ("inference", "EP1")}

    def respawn_lines(job):
        return [re.sub(r"127\.0\.0\.1:\d+", "EP", ln)
                for ln in job.lines() if "respawning in place" in ln]

    assert respawn_lines(jobs["jobs"]["drill"]) == respawn_lines(jjob)
    assert j["rc"] == t["rc"] == 0


def _norm(lines):
    return [re.sub(r"127\.0\.0\.1:\d+", "EP", ln) for ln in lines
            if re.search(r"respawning in place|elastic restart|exhausted|"
                         r"exited with|aborting", ln)]


def test_exit_code_once_the_budget_is_spent_matches_the_jax_launcher(jobs):
    t = jobs["jobs"]["budget"]
    j = jobs["jobs"]["jax_budget"]
    rt, rj = t.finish()["rc"], j.finish()["rc"]
    assert rt == rj == 1
    assert _norm(t.lines()) == _norm(j.lines())
    lines = t.lines()
    assert sum("respawning in place (1/1)" in ln for ln in lines) == 2
    assert any("elastic restart 1/1" in ln for ln in lines)
    assert "exhausted its per-rank budget" in lines[-1]


def test_a_stale_replica_heartbeat_aborts_the_group(jobs):
    t = jobs["jobs"]["stale"]
    j = jobs["jobs"]["jax_stale"]
    assert t.finish()["rc"] == j.finish()["rc"] == 124

    def stale(job):
        return [ln for ln in job.lines() if "stopped heartbeating" in ln]

    # the SIGSTOPped replica alone; the JAX monitor never read a stamp
    assert stale(t) == ["[launch] trainer rank(s) [1] stopped heartbeating "
                        "for >5.0s (hang?); aborting the group"]
    assert stale(j) == [stale(t)[0].replace("[1]", "[0, 1]")]
