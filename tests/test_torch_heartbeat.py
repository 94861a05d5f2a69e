"""Trainer heartbeats in the port (``paddle_tpu_torch/distributed/
heartbeat.py``) against the JAX package's, on the CPU.

Mirrors ``tests/test_heartbeat.py``: each monitor case stamps one
directory and asks both packages' ``HeartBeatMonitor`` (same ranks, same
clock origin, same probe times) which ranks are stale; the answers are
the JAX package's.  A stamp one package's ``HeartBeatWorker`` writes
reads the same through the other's ``read_stamp`` and monitor.  The
port's executor publishes its step count through the stamps (the
``fluid/monitor.py`` step provider), ``start_heartbeat`` turns the stamps
into lease renewals on a coordinator when the launcher arms one (the JAX
package's coordinator here), and ``StragglerMonitor``, whose detector is
not ported, raises naming ROADMAP A8.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.distributed import coordinator as jcoord
from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu_torch.distributed import heartbeat as thb

HB = {"jax": jhb, "torch": thb}


def _stamp(directory, rank, mtime=None, payload=None):
    p = thb._stamp_path(str(directory), rank)
    with open(p, "w") as f:
        if payload is None:
            f.write(repr(time.time()))
        else:
            f.write(json.dumps(dict({"t": time.time()}, **payload)))
    if mtime is not None:
        os.utime(p, (mtime, mtime))
    return p


class _Monitors:
    """Both packages' monitors over one directory with one clock
    origin; ``stale`` asks both and holds them equal."""

    def __init__(self, directory, ranks, **kw):
        self.mons = {k: m.HeartBeatMonitor(str(directory), ranks, **kw)
                     for k, m in HB.items()}
        self._t0 = self.mons["torch"]._t0
        self.mons["jax"]._t0 = self._t0

    def stale(self, **kw):
        got = {k: m.stale_ranks(**kw) for k, m in self.mons.items()}
        assert got["torch"] == got["jax"]
        return got["torch"]


def test_never_stamping_rank_flagged_only_after_startup_grace(tmp_path):
    mon = _Monitors(tmp_path, [0, 1], timeout=1.0, startup_grace=10.0)
    _stamp(tmp_path, 0, mtime=mon._t0 + 4.5)
    assert mon.stale(now=mon._t0 + 5.0) == []
    _stamp(tmp_path, 0, mtime=mon._t0 + 10.5)
    assert mon.stale(now=mon._t0 + 11.0) == [1]


def test_cleanly_exited_rank_is_not_flagged(tmp_path):
    mon = _Monitors(tmp_path, [0, 1], timeout=1.0, startup_grace=10.0)
    _stamp(tmp_path, 0)
    _stamp(tmp_path, 1)
    late = mon._t0 + 50.0
    assert set(mon.stale(now=late)) == {0, 1}
    assert mon.stale(now=late, ranks=[1]) == [1]
    assert mon.stale(now=late, ranks=[]) == []


def test_stale_stamps_from_previous_attempt_are_ignored(tmp_path):
    _stamp(tmp_path, 0, mtime=1.0)
    mon = _Monitors(tmp_path, [0], timeout=1.0, startup_grace=10.0)
    assert mon.stale(now=mon._t0 + 5.0) == []
    assert mon.stale(now=mon._t0 + 11.0) == [0]
    _stamp(tmp_path, 0, mtime=mon._t0 + 10.5)
    assert mon.stale(now=mon._t0 + 11.0) == []


def test_string_rank_tags(tmp_path):
    mon = _Monitors(tmp_path, ["ps0", "ps1"], timeout=1.0,
                    startup_grace=5.0)
    _stamp(tmp_path, "ps0", mtime=mon._t0 + 5.5)
    assert mon.stale(now=mon._t0 + 6.0) == ["ps1"]
    assert mon.stale(now=mon._t0 + 60.0, ranks=["ps0"]) == ["ps0"]


def test_future_epoch_stamp_reads_as_stale(tmp_path):
    mon = _Monitors(tmp_path, [0, 1], timeout=5.0, startup_grace=100.0,
                    epoch=1)
    _stamp(tmp_path, 0, mtime=mon._t0 + 1.0, payload={"epoch": 1})
    _stamp(tmp_path, 1, mtime=mon._t0 + 1.0, payload={"epoch": 3})
    assert mon.stale(now=mon._t0 + 1.5) == [1]
    _stamp(tmp_path, 1, mtime=mon._t0 + 2.0, payload={"epoch": 0})
    assert mon.stale(now=mon._t0 + 2.5) == []
    # without an epoch, fresh stamps are fresh whatever they claim
    mon = _Monitors(tmp_path, [0], timeout=5.0, startup_grace=100.0)
    _stamp(tmp_path, 0, mtime=mon._t0 + 1.0, payload={"epoch": 99})
    assert mon.stale(now=mon._t0 + 1.5) == []


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_a_stamp_reads_the_same_in_the_other_package(tmp_path, monkeypatch,
                                                     writer, reader):
    monkeypatch.setenv("PADDLE_MEMBERSHIP_EPOCH", "2")
    w = HB[writer].HeartBeatWorker(str(tmp_path), 0, interval=30.0)
    w._beat()
    got = {k: m.read_stamp(str(tmp_path), 0) for k, m in HB.items()}
    assert got[reader] == got[writer]
    assert got[reader]["epoch"] == 2 and "t" in got[reader]
    mon = HB[reader].HeartBeatMonitor(str(tmp_path), [0], timeout=5.0,
                                      startup_grace=100.0, epoch=2)
    mon._t0 = got[reader]["t"] - 1.0
    assert mon.stale_ranks(now=got[reader]["t"] + 1.0) == []
    # a legacy bare-float stamp parses alike too
    with open(thb._stamp_path(str(tmp_path), 1), "w") as f:
        f.write("1234.5")
    assert (thb.read_stamp(str(tmp_path), 1)
            == jhb.read_stamp(str(tmp_path), 1) == {"t": 1234.5})
    assert thb.read_stamp(str(tmp_path), 7) is None


def test_worker_stamps_atomically_and_stop_is_idempotent(tmp_path):
    w = thb.HeartBeatWorker(str(tmp_path), 3, interval=0.05)
    assert w.start() is w
    assert w.start() is w
    p = thb._stamp_path(str(tmp_path), 3)
    m0 = os.path.getmtime(p)
    deadline = time.time() + 5
    while os.path.getmtime(p) == m0 and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.getmtime(p) >= m0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    w.stop()
    w.stop()


def test_stamps_carry_the_executors_step_count(tmp_path, monkeypatch):
    """The first ``Executor.run`` registers the step provider: the
    stamps then carry the global step and the recent step seconds."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers, monitor

    monkeypatch.setattr(thb, "_step_provider", None)
    monkeypatch.setattr(monitor, "_hb_registered", False)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [2, 3], append_batch_size=False)
        y = layers.fc(x, 2)
    exe = fluid.Executor(device="cpu")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    n0 = monitor.global_step()
    for _ in range(3):
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[y], scope=scope)
    assert thb._step_provider is monitor.step_rate_sample
    w = thb.HeartBeatWorker(str(tmp_path), 0, interval=30.0)
    w._beat()
    stamp = thb.read_stamp(str(tmp_path), 0)
    assert stamp["step"] == n0 + 3 and stamp["avg_step_s"] > 0


def test_start_heartbeat_renews_a_lease(tmp_path, monkeypatch):
    """With the launcher's coordinator armed, every stamp is also a
    lease renewal carrying the stamp (here on the JAX package's
    coordinator: the same wire)."""
    c = jcoord.Coordinator(lease_secs=5.0)
    srv, ep = jcoord.serve_coordinator(c)
    monkeypatch.setenv(thb.ENV_DIR, str(tmp_path))
    monkeypatch.setenv("PADDLE_COORDINATOR_ENDPOINT", ep)
    monkeypatch.setenv("PADDLE_LEASE_SECS", "5")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINER_TAG", "trainer1")
    w = thb.start_heartbeat(interval=0.05)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not (
                c.members.get("trainer1") and c.members["trainer1"].payload):
            time.sleep(0.05)
        m = c.membership()["members"]["trainer1"]
        assert m["alive"] and m["payload"]["t"] > 0
        assert os.path.exists(thb._stamp_path(str(tmp_path), 1))
    finally:
        w.stop()
        jcoord.stop_coordinator(srv)
    # lease-only liveness: a coordinator and no heartbeat directory
    monkeypatch.delenv(thb.ENV_DIR)
    monkeypatch.setenv("PADDLE_COORDINATOR_ENDPOINT", "127.0.0.1:1")
    monkeypatch.setenv("PADDLE_COORD_CALL_DEADLINE_SECS", "0.2")
    lw = thb.start_heartbeat()
    assert type(lw).__name__ == "LeaseWorker"
    lw.stop()
    # nothing armed: no worker
    monkeypatch.delenv("PADDLE_COORDINATOR_ENDPOINT")
    assert thb.start_heartbeat() is None


def test_straggler_monitor_raises_naming_a8(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        thb.StragglerMonitor(str(tmp_path), [0, 1])


def test_exiting_stamp_gets_the_startup_grace_not_the_timeout(tmp_path):
    """A clean exit's last stamp says ``exiting``: the rank is in its
    interpreter's teardown (torch's takes ~0.7 s, seconds on a loaded
    host) and is flagged only once the startup grace has passed since
    that stamp.  The same stamp without the mark is a hang."""
    mon = thb.HeartBeatMonitor(str(tmp_path), [0, 1], timeout=1.0,
                               startup_grace=10.0)
    now = time.time()
    _stamp(tmp_path, 0, mtime=now - 3.0, payload={"exiting": True})
    _stamp(tmp_path, 1, mtime=now - 3.0)
    mon._t0 = now - 5.0
    assert mon.stale_ranks(now=now) == [1]
    assert mon.stale_ranks(now=now + 8.0) == [0, 1]


def test_rearm_gives_a_respawned_rank_the_startup_grace(tmp_path):
    """A replica respawned in place: its predecessor's stamp, left on
    disk and older than the re-arm, counts as none, so the new process
    gets the startup grace for its first stamp; once it stamps, the
    timeout applies again."""
    mon = thb.HeartBeatMonitor(str(tmp_path), [0, 1], timeout=1.0,
                               startup_grace=10.0)
    now = time.time()
    mon._t0 = now - 20.0
    _stamp(tmp_path, 0, mtime=now - 3.0)
    _stamp(tmp_path, 1, mtime=now - 3.0)
    assert mon.stale_ranks(now=now) == [0, 1]
    mon.rearm(0)
    assert mon._since[0] >= now
    assert mon.stale_ranks(now=now) == [1]
    assert mon.stale_ranks(now=mon._since[0] + 11.0) == [0, 1]
    _stamp(tmp_path, 0, mtime=mon._since[0] + 1.0)
    assert mon.stale_ranks(now=mon._since[0] + 1.5) == [1]
    assert mon.stale_ranks(now=mon._since[0] + 3.0) == [0, 1]


def test_clean_exit_writes_an_exiting_stamp_and_stop_does_not(tmp_path):
    """The worker's atexit hook writes the ``exiting`` stamp; a worker
    stopped on purpose (a rank that goes silent) writes none."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    body = ("import sys\n"
            "from paddle_tpu_torch.distributed.heartbeat import "
            "HeartBeatWorker\n"
            "w = HeartBeatWorker(sys.argv[1], int(sys.argv[2]), 0.05)"
            ".start()\n"
            "if sys.argv[2] == '1':\n"
            "    w.stop()\n")
    for rank in (0, 1):
        subprocess.run([sys.executable, "-c", body, str(tmp_path),
                        str(rank)], check=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert thb.read_stamp(str(tmp_path), 0).get("exiting") is True
    assert "exiting" not in thb.read_stamp(str(tmp_path), 1)
