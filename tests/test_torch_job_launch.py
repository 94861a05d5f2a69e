"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_launch.py:30-171`` and ``tests/test_elastic.py:
469-631``: the env protocol (equal to the JAX launcher's for the same
argv: rank, world, endpoints, tag, membership epoch, attempt, the commit
barrier's endpoint; the port adds its per-attempt rendezvous store),
``workerlog.N``, abort-all on a child's failure, the elastic restart,
the exhausted budget, hang detection through heartbeats, per-rank
eviction with the resize and its re-ranked survivors, the min-world-size
abort; and SIGTERM's grace with the trainers' exit 75.  Each refused flag
raises NotImplementedError naming its ROADMAP item.  ``Model.fit``'s
elastic ``reshard`` resumes at the JAX package's position.

Every launcher job of the module starts at once in a module fixture (the
workers are plain Python, importing neither torch nor JAX unless the
case needs the port's heartbeat), and each test waits for its own, with
a deadline.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest

from paddle_tpu_torch.distributed import launch as tlaunch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90

ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_TRAINER_TAG", "PADDLE_MEMBERSHIP_EPOCH",
            "PADDLE_ELASTIC_RESTART")

_ENV_DUMP = """
import json, os, sys
out = sys.argv[1]
rank = os.environ["PADDLE_TRAINER_ID"]
keys = %r
rec = {k: os.environ[k] for k in keys}
rec["barrier"] = bool(os.environ.get("PADDLE_CKPT_BARRIER_ENDPOINT"))
rec["rendezvous"] = os.environ.get("PADDLE_DIST_RENDEZVOUS")
with open(os.path.join(out, "env.%%s.json" %% rank), "w") as f:
    json.dump(rec, f)
""" % (ENV_KEYS,)

SCRIPTS = {
    "env": _ENV_DUMP,
    "abort": """
        import os, sys, time
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        out = sys.argv[1]
        if rank == 1:
            sys.exit(7)
        for _ in range(600):
            time.sleep(0.1)
        open(os.path.join(out, f"survived{rank}"), "w").close()
        """,
    "noop": "import sys\n",
    "restart": """
        import os, sys
        out = sys.argv[1]
        rank = os.environ["PADDLE_TRAINER_ID"]
        attempt = int(os.environ["PADDLE_ELASTIC_RESTART"])
        with open(os.path.join(out, f"attempts.{rank}.{attempt}"), "w") as f:
            f.write(os.environ["PADDLE_DIST_RENDEZVOUS"])
        if rank == "0" and attempt == 0:
            sys.exit(3)
        """,
    "fail7": "import sys\nsys.exit(7)\n",
    "hang": """
        import os, sys, time
        from paddle_tpu_torch.distributed.heartbeat import start_heartbeat
        rank = os.environ["PADDLE_TRAINER_ID"]
        hb = start_heartbeat(interval=0.2)
        assert hb is not None
        if rank == "1":
            hb.stop()
        time.sleep(60)
        """,
    "clean_exit": """
        import os, sys, time
        from paddle_tpu_torch.distributed.heartbeat import start_heartbeat
        start_heartbeat(interval=0.2)
        time.sleep(1 if os.environ["PADDLE_TRAINER_ID"] == "0" else 6)
        """,
    "slow_exit": """
        import os, sys, time
        from paddle_tpu_torch.distributed.heartbeat import start_heartbeat
        start_heartbeat(interval=0.2)

        class _SlowTeardown:
            # runs while the interpreter clears __main__, after the
            # stamping thread has stopped: a teardown 1 s longer than
            # the heartbeat timeout, as a loaded host gives torch's
            def __del__(self, _sleep=time.sleep):
                _sleep(3.0)

        _keep = _SlowTeardown()
        time.sleep(1 if os.environ["PADDLE_TRAINER_ID"] == "0" else 8)
        """,
    "evict": """
        import os, sys
        out = sys.argv[1]
        tag = os.environ["PADDLE_TRAINER_TAG"]
        attempt = os.environ["PADDLE_ELASTIC_RESTART"]
        with open(os.path.join(out, f"run.{attempt}.{tag}"), "w") as f:
            f.write("|".join([
                os.environ["PADDLE_TRAINER_ID"],
                os.environ["PADDLE_TRAINERS_NUM"],
                os.environ["PADDLE_MEMBERSHIP_EPOCH"],
                os.environ.get("PADDLE_ELASTIC_RESHARD", ""),
            ]))
        if tag == "trainer1":
            # die once the others have written theirs (the launcher kills
            # them as soon as it sees this exit)
            import glob, time
            deadline = time.time() + 30
            while (len(glob.glob(os.path.join(out, f"run.{attempt}.*"))) < 3
                   and time.time() < deadline):
                time.sleep(0.05)
            sys.exit(5)
        """,
    "in_budget": """
        import os, sys
        tag = os.environ["PADDLE_TRAINER_TAG"]
        if tag == "trainer0" and os.environ["PADDLE_ELASTIC_RESTART"] == "0":
            sys.exit(3)
        """,
    "fail6": "import sys\nsys.exit(6)\n",
    "durable": """
        import os, sys, time
        from paddle_tpu_torch.distributed import coordinator
        from paddle_tpu_torch.distributed.heartbeat import start_heartbeat
        start_heartbeat(interval=0.2)
        time.sleep(1.5)
        m = coordinator.query_membership()
        with open(os.path.join(sys.argv[1], "members." +
                               os.environ["PADDLE_TRAINER_ID"]), "w") as f:
            f.write(",".join(sorted(m["members"])))
        """,
    "sigterm": """
        import os, signal, sys, time
        out = sys.argv[1]
        rank = os.environ["PADDLE_TRAINER_ID"]
        def on_term(sig, frame):
            open(os.path.join(out, f"final_ckpt.{rank}"), "w").close()
            sys.exit(75)
        signal.signal(signal.SIGTERM, on_term)
        open(os.path.join(out, f"ready.{rank}"), "w").close()
        for _ in range(600):
            time.sleep(0.1)
        """,
}

# name -> (script, nproc, extra args, extra env, launcher package)
JOBS = {
    "env": ("env", 3, (), {}, "paddle_tpu_torch"),
    "env_jax": ("env", 3, (), {}, "paddle_tpu"),
    "abort": ("abort", 3, (), {}, "paddle_tpu_torch"),
    "unknown_ip": ("noop", 1, ("--ips", "10.1.1.1,10.1.1.2",
                               "--node_ip", "10.9.9.9"), {},
                   "paddle_tpu_torch"),
    "restart": ("restart", 2, ("--elastic_retries", "2"), {},
                "paddle_tpu_torch"),
    "exhausted": ("fail7", 2, ("--elastic_retries", "1"), {},
                  "paddle_tpu_torch"),
    "hang": ("hang", 2, ("--heartbeat_timeout", "2.0"), {"hb": True},
             "paddle_tpu_torch"),
    "clean_exit": ("clean_exit", 2, ("--heartbeat_timeout", "2.0"),
                   {"hb": True, "leftover": True}, "paddle_tpu_torch"),
    "slow_exit": ("slow_exit", 2, ("--heartbeat_timeout", "2.0"),
                  {"hb": True}, "paddle_tpu_torch"),
    "evict": ("evict", 3, ("--elastic_retries_per_rank", "0",
                           "--elastic_retries", "3"), {},
              "paddle_tpu_torch"),
    "in_budget": ("in_budget", 2, ("--elastic_retries", "2"), {},
                  "paddle_tpu_torch"),
    "min_world": ("fail6", 2, ("--elastic_retries_per_rank", "0",
                               "--elastic_retries", "4",
                               "--min_world_size", "2"), {},
                  "paddle_tpu_torch"),
    "sigterm": ("sigterm", 2, ("--sigterm_grace", "20"), {},
                "paddle_tpu_torch"),
    "durable": ("durable", 2, ("--lease_secs", "5"),
                {"env": {"PADDLE_COORD_SNAPSHOT_SECS": "0.2"}},
                "paddle_tpu_torch"),
}


class _Job:
    def __init__(self, name, root):
        script, nproc, extra, opts, pkg = JOBS[name]
        self.dir = root / name
        self.dir.mkdir()
        path = self.dir / "worker.py"
        path.write_text(textwrap.dedent(SCRIPTS[script]))
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   **opts.get("env", {}))
        if opts.get("hb"):
            hb = self.dir / "hb"
            hb.mkdir()
            env["PADDLE_HEARTBEAT_DIR"] = str(hb)
            if opts.get("leftover"):
                # a stamp from a previous job, hours old
                stale = hb / "heartbeat.0"
                stale.write_text("0.0")
                os.utime(stale, (1, 1))
        cmd = [sys.executable, "-m", f"{pkg}.distributed.launch",
               "--nproc_per_node", str(nproc),
               "--log_dir", str(self.dir / "logs"), *extra, str(path),
               str(self.dir)]
        self.t0 = time.time()
        self.proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)

    def wait(self):
        try:
            _, self.stderr = self.proc.communicate(timeout=DEADLINE_S)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
            raise
        self.seconds = time.time() - self.t0
        return self.proc.returncode


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    started = {name: _Job(name, root) for name in JOBS}
    yield started
    for job in started.values():
        if job.proc.poll() is None:
            os.killpg(job.proc.pid, signal.SIGKILL)
            job.proc.communicate()


def _read(job, rank):
    import json

    with open(job.dir / f"env.{rank}.json") as f:
        return json.load(f)


def test_launch_env_protocol_equals_the_jax_launchers(jobs):
    port, ref = jobs["env"], jobs["env_jax"]
    assert port.wait() == 0, port.stderr
    assert ref.wait() == 0, ref.stderr
    for rank in range(3):
        got, want = _read(port, rank), _read(ref, rank)
        assert {k: got[k] for k in ENV_KEYS} == {k: want[k] for k in ENV_KEYS}
        assert got["barrier"] and want["barrier"]
        assert got["PADDLE_TRAINER_TAG"] == f"trainer{rank}"
        assert got["rendezvous"].startswith("file://")
    eps = _read(port, 0)["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(set(eps)) == 3
    assert sorted(os.listdir(port.dir / "logs")) == [
        "workerlog.0", "workerlog.1", "workerlog.2"]


def test_launch_aborts_all_on_failure(jobs):
    job = jobs["abort"]
    assert job.wait() == 7, job.stderr
    assert "aborting the job" in job.stderr
    assert not any(p.name.startswith("survived") for p in job.dir.iterdir())
    assert job.seconds < 40   # the others were killed, not waited out


def test_launch_unknown_node_ip(jobs):
    assert jobs["unknown_ip"].wait() == 2


def test_launch_elastic_restart_recovers_on_a_fresh_rendezvous(jobs):
    job = jobs["restart"]
    assert job.wait() == 0, job.stderr
    assert (job.dir / "attempts.0.0").exists()
    assert (job.dir / "attempts.0.1").exists()
    assert "elastic restart 1/2" in job.stderr
    # each attempt meets in a store of its own
    first = (job.dir / "attempts.0.0").read_text()
    second = (job.dir / "attempts.0.1").read_text()
    assert first != second
    assert (job.dir / "attempts.1.1").read_text() == second
    assert "failure detected at" in job.stderr


def test_launch_elastic_exhausted_fails(jobs):
    job = jobs["exhausted"]
    assert job.wait() == 7
    assert "elastic restart 1/1" in job.stderr


def test_launch_heartbeat_detects_hang(jobs):
    job = jobs["hang"]
    assert job.wait() == 124, job.stderr
    assert "stopped heartbeating" in job.stderr
    assert job.seconds < 45


def test_launch_heartbeat_ignores_clean_exit_and_stale_leftovers(jobs):
    job = jobs["clean_exit"]
    assert job.wait() == 0, job.stderr


def test_launch_heartbeat_ignores_a_slow_teardown_after_a_clean_exit(jobs):
    """Rank 0 exits 0 and its interpreter then takes 3 s to tear down
    with the stamps stopped; the monitor reads its ``exiting`` stamp
    and does not call it hung."""
    job = jobs["slow_exit"]
    assert job.wait() == 0, job.stderr
    assert "stopped heartbeating" not in job.stderr


def test_launch_per_rank_budget_evicts_and_resizes(jobs):
    job = jobs["evict"]
    assert job.wait() == 0, job.stderr
    for tag in ("trainer0", "trainer1", "trainer2"):
        rank, world, epoch, reshard = (
            (job.dir / f"run.0.{tag}").read_text().split("|"))
        assert world == "3" and epoch == "0"
    assert not (job.dir / "run.1.trainer1").exists()
    assert (job.dir / "run.1.trainer0").read_text().split("|") == [
        "0", "2", "1", "1"]
    assert (job.dir / "run.1.trainer2").read_text().split("|") == [
        "1", "2", "1", "1"]
    assert "elastic restart 1/3" in job.stderr
    assert "trainer1" in job.stderr
    assert "nonzero exit (code 5)" in job.stderr
    assert "resizing to world_size=2" in job.stderr


def test_launch_within_budget_restarts_same_size(jobs):
    job = jobs["in_budget"]
    assert job.wait() == 0, job.stderr
    assert "elastic restart 1/2" in job.stderr
    assert "trainer0" in job.stderr and "world_size=2" in job.stderr
    assert "resizing" not in job.stderr


def test_launch_min_world_size_aborts(jobs):
    job = jobs["min_world"]
    assert job.wait() == 6, job.stderr
    assert "min_world_size" in job.stderr


def test_launch_sigterm_grace_and_exit_75(jobs):
    """SIGTERM to the launcher reaches every trainer; each writes its
    final checkpoint and exits PREEMPTED_EXIT_CODE; the job reports
    128 + SIGTERM."""
    from paddle_tpu_torch.fluid import checkpoint as ckpt

    assert tlaunch.PREEMPTED_EXIT_CODE == ckpt.PREEMPTED_EXIT_CODE == 75
    job = jobs["sigterm"]
    deadline = time.time() + DEADLINE_S
    while not all((job.dir / f"ready.{r}").exists() for r in (0, 1)):
        assert time.time() < deadline and job.proc.poll() is None
        time.sleep(0.05)
    job.proc.send_signal(signal.SIGTERM)
    assert job.wait() == 128 + signal.SIGTERM, job.stderr
    assert "SIGTERM: forwarding to trainers" in job.stderr
    assert (job.dir / "final_ckpt.0").exists()
    assert (job.dir / "final_ckpt.1").exists()


def test_launch_hosts_a_durable_coordinator_process(jobs):
    """PADDLE_COORD_SNAPSHOT_SECS moves the coordinator into a supervised
    child (``python -m paddle_tpu_torch.distributed.coordinator``) with
    snapshot + WAL state; the ranks' renewals reach it and the launcher
    talks to it through CoordinatorProxy."""
    job = jobs["durable"]
    assert job.wait() == 0, job.stderr
    assert "durable job coordinator on" in job.stderr
    for r in (0, 1):
        members = (job.dir / f"members.{r}").read_text().split(",")
        assert {"trainer0", "trainer1"} <= set(members)
    assert "listening on" in (job.dir / "logs" / "coordlog.primary"
                              ).read_text()
    state = job.dir / "logs" / "coord_state" / "primary"
    assert any(f.endswith(".snap") for f in os.listdir(state))


@pytest.mark.parametrize("argv,item", [
    (["--serve"], "serving under the launcher"),
    (["--fleetz_port", "0"], "ROADMAP A8"),
    (["--debugz_port", "0"], "ROADMAP A8"),
    (["--trace_dir", "t"], "ROADMAP A8"),
    (["--straggler_factor", "3"], "ROADMAP A8"),
    (["--straggler_eject_factor", "3"], "ROADMAP A8"),
], ids=["serve", "fleetz_port", "debugz_port", "trace_dir",
        "straggler_factor", "straggler_eject_factor"])
def test_refused_flags_name_their_roadmap_item(argv, item):
    # the pserver flags are ported (tests/test_torch_ps_dist.py,
    # test_torch_ps_replication.py); --serve waits for the next A6 item
    with pytest.raises(NotImplementedError, match=item):
        tlaunch.launch(argv + ["worker.py"])


@pytest.mark.parametrize("var", ["PADDLE_GOODPUT"])
def test_refused_environment_names_its_roadmap_item(var, monkeypatch):
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A8"):
        tlaunch.launch(["worker.py"])


def test_get_cluster_matches_the_jax_launchers():
    from paddle_tpu.distributed import launch as jlaunch

    for ips, n, port in ((["127.0.0.1"], 4, 6170), (["a", "b"], 2, 7000)):
        got = [(t.rank, t.endpoint, t.tag)
               for t in tlaunch.get_cluster(ips, n, port)]
        want = [(t.rank, t.endpoint, t.tag)
                for t in jlaunch.get_cluster(ips, n, port)]
        assert got == want


# ---------------------------------------------------------------------------
# Model.fit(reshard=...) (tests/test_elastic.py:469-513)
# ---------------------------------------------------------------------------


def _fit_model(pkg):
    if pkg == "jax":
        import paddle_tpu.fluid as fluid
        from paddle_tpu.fluid import layers
        from paddle_tpu.hapi import Input, Model

        kw = {}
    else:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.fluid import layers
        from paddle_tpu_torch.hapi import Input, Model

        kw = {"device": "cpu"}

    def net(x):
        return layers.fc(x, 1)

    with fluid.unique_name.guard():
        m = Model(net, Input("x", [4, 3]), Input("y", [4, 1]), **kw)
        m.prepare(fluid.optimizer.SGDOptimizer(learning_rate=0.1),
                  lambda p, y: layers.mean(layers.square_error_cost(p, y)))
    return m


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fit_refuses_then_reshards_world_size_change(tmp_path, monkeypatch,
                                                     pkg):
    """A checkpoint from a dp 2 job resumed at dp 4 is refused unless
    reshard is on; with reshard the per-rank position is scaled (old_step
    * old_w // new_w), in the port as in the JAX package: the same
    warnings, the same number of steps run after the resume."""
    import importlib

    ckpt_mod = importlib.import_module(
        "paddle_tpu.fluid.checkpoint" if pkg == "jax"
        else "paddle_tpu_torch.fluid.checkpoint")
    rng = np.random.RandomState(0)
    X = rng.randn(32, 3).astype(np.float32)
    Y = rng.randn(32, 1).astype(np.float32)
    ckpt_dir = str(tmp_path / "fit_ckpt")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_ELASTIC_RESHARD", raising=False)
    m = _fit_model(pkg)
    m.fit((X, Y), batch_size=4, epochs=1, verbose=0, shuffle=False,
          checkpoint_dir=ckpt_dir, checkpoint_freq=4)
    mgr = m._checkpoint_manager(ckpt_dir)
    assert mgr.manifest(mgr.latest_step())["world_size"] == 2
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    with pytest.raises(ckpt_mod.WorldSizeMismatchError):
        _fit_model(pkg).fit((X, Y), batch_size=4, epochs=2, verbose=0,
                            shuffle=False, checkpoint_dir=ckpt_dir,
                            resume=True)
    m3 = _fit_model(pkg)
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hist = m3.fit((X, Y), batch_size=4, epochs=2, verbose=0,
                      shuffle=False, checkpoint_dir=ckpt_dir, resume=True,
                      reshard=True)
    seen = [str(w.message) for w in caught if "elastic resume" in
            str(w.message)]
    # the checkpoint of global step 8 (dp 2: 8 steps of 4 samples a
    # rank, 16 a step) resumes at dp 4 at its 4th step of 4 a rank
    assert seen == ["elastic resume: checkpoint world size 2 -> 4; "
                    "resuming epoch 0 at re-split step 4 (was 8)"]
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    # PADDLE_ELASTIC_RESHARD=1 is reshard=None's default
    monkeypatch.setenv("PADDLE_ELASTIC_RESHARD", "1")
    assert _fit_model(pkg).fit((X, Y), batch_size=4, epochs=2, verbose=0,
                               shuffle=False, checkpoint_dir=ckpt_dir,
                               resume=True)["loss"]
