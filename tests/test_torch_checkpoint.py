"""Preemption-safe training in the port (``fluid/checkpoint.py``), on the
CPU, against the JAX package's checkpoints.

  commit protocol — contents -> rename -> manifest, checksums, fallback
                    past torn and corrupt directories, keep_last_n
                    retention counting committed steps only, every crash
                    phase (``crash:<phase>`` rules, the process death
                    simulated in-process) and disk fault (``io_err``,
                    ``short_write``, ``diskfull``) leaving the previous
                    step restorable
  async writer    — snapshot-cost saves, depth-1 coalescing, the latched
                    writer error, sync saves superseding the queue, the
                    fsync opt-out, byte identity with sync saves
  resume          — ``Model.fit`` preempted at an exact step and resumed
                    bit for bit (sync, async, past a torn latest), and a
                    SIGTERM drill: a child fit SIGTERM'd after step 6
                    exits 75 with a committed checkpoint, and the resumed
                    trace and parameters equal the straight run's bit for
                    bit
  across packages — a JAX checkpoint restores into the port and the port
                    continues its loss trace (dropout off, f32) within
                    1e-5 relative, and the reverse; bf16 arrays bit for bit
                    both ways; the step seed <-> PRNG key rule; the
                    ``save_dygraph`` files byte for byte
  refusals        — parameter-server tables raise
                    NotImplementedError naming the ROADMAP slice
"""
from __future__ import annotations

import errno
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import checkpoint as jckpt
from paddle_tpu.hapi import Input as JInput
from paddle_tpu.hapi import Model as JModel
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.fluid import flags as fl
from paddle_tpu_torch.fluid.checkpoint import (CheckpointManager,
                                               CheckpointWriterError)
from paddle_tpu_torch.hapi import Callback, Input, Model, ModelCheckpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import ckpt_doctor  # noqa: E402

REL_TOL = 1e-5  # f32 loss traces across the packages (relative)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _net(fluid, p=0.3):
    def net(x):
        L = fluid.layers
        h = L.fc(x, 16, act="relu")
        h = L.dropout(h, dropout_prob=p)  # RNG restore must matter
        return L.fc(h, 1)
    return net


def _model(p=0.3):
    m = Model(_net(tfluid, p), Input("x", [8, 4]), Input("y", [8, 1]),
              device="cpu")
    m.prepare(tfluid.optimizer.AdamOptimizer(learning_rate=1e-2),
              lambda q, y: tfluid.layers.mean(
                  tfluid.layers.square_error_cost(q, y)))
    return m


def _jax_model(p=0.3):
    m = JModel(_net(jfluid, p), JInput("x", [8, 4]), JInput("y", [8, 1]))
    m.prepare(jfluid.optimizer.AdamOptimizer(learning_rate=1e-2),
              lambda q, y: jfluid.layers.mean(
                  jfluid.layers.square_error_cost(q, y)))
    return m


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 4).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


class PreemptAtStep(Callback):
    """Deterministic stand-in for SIGTERM delivery at an exact step."""

    def __init__(self, at, request=ckpt.request_preemption):
        self.at, self.n, self.request = int(at), 0, request

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train":
            self.n += 1
            if self.n == self.at:
                self.request()


def _scope_with(w):
    scope = tfluid.Scope()
    scope.set_var("w", torch.as_tensor(np.asarray(w, np.float32)))
    return scope


def _mgr(root, scope=None, **kw):
    return CheckpointManager(str(root), scope=scope, device="cpu", **kw)


def _w(scope):
    return scope.find_var("w").numpy()


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _params_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Rec:
    """Records every train step's loss (duck-typed: either package's
    callback list calls it)."""

    def __init__(self):
        self.out = []

    def __getattr__(self, name):
        if name.startswith("on_") or name == "set_model":
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_batch_end(self, mode, step, logs=None):
        self.out.append(logs["loss"])

    def on_epoch_end(self, epoch, logs=None):
        return False


def _steps(m, X, Y, **kw):
    """(every step's loss, the history) of a 3-epoch fit."""
    rec = _Rec()
    h = m.fit((X, Y), batch_size=8, epochs=3, verbose=0,
              callbacks=[rec] + kw.pop("callbacks", []), **kw)
    return rec.out, h


@pytest.fixture(autouse=True)
def _clear_preemption():
    ckpt.clear_preemption()
    jckpt.clear_preemption()
    yield
    ckpt.clear_preemption()
    jckpt.clear_preemption()


class _FaultCtl:
    def __init__(self, monkeypatch):
        self._mp = monkeypatch

    def __call__(self, spec):
        fl.set_flags({"FLAGS_ps_fault_injection": True})
        self._mp.setenv("PADDLE_PS_FAULT_SPEC", spec)
        faults.reset()

    def disarm(self):
        self._mp.setenv("PADDLE_PS_FAULT_SPEC", "")
        faults.reset()


@pytest.fixture
def fault_spec(monkeypatch):
    ctl = _FaultCtl(monkeypatch)
    yield ctl
    fl.set_flags({"FLAGS_ps_fault_injection": False})
    faults.reset()


class _Killed(BaseException):
    """The process death of a ``crash`` rule, raised instead."""


# ---------------------------------------------------------------------------
# commit protocol
# ---------------------------------------------------------------------------


def test_manifest_commit_retention_and_verify(tmp_path):
    scope = _scope_with(np.arange(6))
    mgr = _mgr(tmp_path, scope, keep_last_n=2)
    for s in range(1, 5):
        scope.set_var("w", torch.full((6,), float(s)))
        mgr.save(s, extra_state={"mark": s})
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003", "ckpt-00000004"]
    m = mgr.manifest(4)
    assert m["step"] == 4
    assert {"state.pkl", "rng.pkl", "extra.pkl"} <= set(m["files"])
    assert all(set(meta) == {"sha256", "bytes"}
               for meta in m["files"].values())
    assert mgr.verify(4)
    st = mgr.restore()
    assert st["step"] == 4 and st["extra"]["mark"] == 4
    np.testing.assert_array_equal(_w(scope), np.full(6, 4.0, np.float32))
    assert set(mgr.last_save) >= {"snapshot", "serialize", "write", "save",
                                  "bytes"}
    assert st["restore_ms"] > 0


def test_restore_falls_back_past_torn_and_corrupt(tmp_path):
    scope = _scope_with(np.zeros(3))
    mgr = _mgr(tmp_path, scope, keep_last_n=4)
    for s in (1, 2, 3):
        scope.set_var("w", torch.full((3,), float(s)))
        mgr.save(s)
    os.remove(tmp_path / "ckpt-00000003" / "manifest.json")
    p = tmp_path / "ckpt-00000002" / "state.pkl"
    blob = bytearray(p.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    p.write_bytes(bytes(blob))
    assert mgr.steps() == [1, 2]
    assert not mgr.verify(2)
    with pytest.warns(RuntimeWarning):
        st = mgr.restore()
    assert st["step"] == 1
    np.testing.assert_array_equal(_w(scope), np.full(3, 1.0, np.float32))


def test_retention_counts_only_committed_and_gcs_torn(tmp_path):
    scope = _scope_with(np.zeros(3))
    mgr = _mgr(tmp_path, scope, keep_last_n=2)
    mgr.save(1)
    mgr.save(2)
    os.makedirs(tmp_path / "ckpt-00000003")
    (tmp_path / "ckpt-00000003" / "state.pkl").write_bytes(b"partial")
    os.makedirs(tmp_path / "ckpt-00000005")
    mgr.save(4)
    assert mgr.steps() == [2, 4]
    assert not (tmp_path / "ckpt-00000003").exists()
    assert (tmp_path / "ckpt-00000005").exists()
    assert mgr.restore()["step"] == 4
    mgr2 = _mgr(tmp_path, scope, keep_last_n=1)
    mgr2.save(6)
    os.makedirs(tmp_path / "ckpt-00000007")
    os.makedirs(tmp_path / "ckpt-00000008")
    mgr2.save(9)
    assert mgr2.steps() == [9]
    assert not (tmp_path / "ckpt-00000007").exists()
    assert mgr2.restore()["step"] == 9


def test_restore_empty_dir_returns_none(tmp_path):
    mgr = _mgr(tmp_path, tfluid.Scope())
    assert mgr.restore() is None and mgr.latest_step() is None


@pytest.mark.parametrize("phase,async_,leaves_dir", [
    ("ckpt_tmp_written", False, False),
    ("ckpt_before_commit", False, True),
    ("ckpt_manifest_tmp_written", False, True),
    ("ckpt_writer", True, False),
    ("ckpt_tmp_written", True, False),
])
def test_crash_phase_restores_previous_step(tmp_path, fault_spec,
                                            monkeypatch, phase, async_,
                                            leaves_dir):
    """A kill at each commit phase leaves the previous step the newest
    restorable one; the torn debris is overwritable."""
    def die(code):
        raise _Killed(code)

    monkeypatch.setattr(faults.os, "_exit", die)
    scope = _scope_with(np.full(4, 1.0))
    mgr = _mgr(tmp_path, scope, keep_last_n=3)
    mgr.save(1)
    fault_spec(f"crash:{phase}:1")
    scope.set_var("w", torch.full((4,), 2.0))
    if async_:
        mgr.save(2, async_=True)
        with pytest.raises(CheckpointWriterError, match="_Killed"):
            mgr.drain()
    else:
        with pytest.raises(_Killed):
            mgr.save(2)
    fault_spec.disarm()
    assert (tmp_path / "ckpt-00000002").exists() == leaves_dir
    fresh = tfluid.Scope()
    mgr2 = _mgr(tmp_path, fresh)
    assert mgr2.steps() == [1]
    assert mgr2.restore()["step"] == 1
    np.testing.assert_array_equal(_w(fresh), np.full(4, 1.0, np.float32))
    mgr2.save(2)
    assert mgr2.verify(2) and mgr2.latest_step() == 2


def test_io_err_sync_save_fails_previous_survives(tmp_path, fault_spec):
    scope = _scope_with(np.full(4, 1.0))
    mgr = _mgr(tmp_path, scope)
    mgr.save(1)
    fault_spec("io_err:ckpt_content:1")
    scope.set_var("w", torch.full((4,), 2.0))
    with pytest.raises(OSError, match="I/O error"):
        mgr.save(2)
    assert mgr.steps() == [1]
    fresh = tfluid.Scope()
    assert _mgr(tmp_path, fresh).restore()["step"] == 1
    np.testing.assert_array_equal(_w(fresh), np.full(4, 1.0, np.float32))
    mgr.save(2)
    assert mgr.verify(2)


def test_io_err_async_latches(tmp_path, fault_spec):
    mgr = _mgr(tmp_path, _scope_with(np.ones(4)))
    mgr.save(1)
    fault_spec("io_err:ckpt_content:1")
    mgr.save(2, async_=True)
    with pytest.raises(CheckpointWriterError, match="I/O error"):
        mgr.drain()
    assert mgr.steps() == [1]


def test_short_write_content_detected_as_corrupt(tmp_path, fault_spec):
    scope = _scope_with(np.full(4, 1.0))
    mgr = _mgr(tmp_path, scope)
    mgr.save(1)
    fault_spec("short_write:ckpt_content:1")
    scope.set_var("w", torch.full((4,), 2.0))
    mgr.save(2)
    assert mgr.steps() == [1, 2] and not mgr.verify(2)
    fresh = tfluid.Scope()
    with pytest.warns(RuntimeWarning):
        assert _mgr(tmp_path, fresh).restore()["step"] == 1
    rep = ckpt_doctor.scan_root(str(tmp_path))
    assert {e["step"]: e["status"] for e in rep["steps"]} == {
        1: "ok", 2: "corrupt"}
    assert rep["newest_valid"] == 1


def test_short_write_manifest_is_torn(tmp_path, fault_spec):
    mgr = _mgr(tmp_path, _scope_with(np.ones(4)))
    mgr.save(1)
    fault_spec("short_write:ckpt_manifest:1")
    mgr.save(2)
    assert mgr.steps() == [1]
    rep = ckpt_doctor.scan_root(str(tmp_path))
    assert {e["step"]: e["status"] for e in rep["steps"]}[2] == "torn"


def test_diskfull_latches_until_reset(tmp_path, fault_spec):
    mgr = _mgr(tmp_path, _scope_with(np.ones(4)))
    mgr.save(1)
    fault_spec("diskfull:ckpt_content:1")
    with pytest.raises(OSError) as ei:
        mgr.save(2)
    assert ei.value.errno == errno.ENOSPC
    with pytest.raises(OSError):
        mgr.save(3)
    assert mgr.steps() == [1]
    fault_spec.disarm()
    mgr.save(4)
    assert mgr.verify(4)


def test_ckpt_doctor_reports_the_ports_checkpoints_clean(tmp_path):
    scope = _scope_with(np.arange(8))
    scope.set_var("b", torch.arange(4, dtype=torch.bfloat16))
    mgr = _mgr(tmp_path, scope, keep_last_n=2)
    for s in (4, 8, 12):
        mgr.save(s)
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "ckpt_doctor.py"),
                        str(tmp_path), "--json"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    import json

    rep = json.loads(r.stdout)
    assert [(e["step"], e["status"]) for e in rep["steps"]] == [
        (8, "ok"), (12, "ok")]
    assert rep["newest_valid"] == 12 and rep["orphans"] == []


# ---------------------------------------------------------------------------
# async writer
# ---------------------------------------------------------------------------


def _slow_writer(monkeypatch, delay=0.0, gate=None):
    orig = CheckpointManager._write_snapshot

    def slowed(self, job):
        if gate is not None:
            assert gate.wait(30), "writer gate never opened"
        if delay:
            time.sleep(delay)
        return orig(self, job)

    monkeypatch.setattr(CheckpointManager, "_write_snapshot", slowed)


def _wait_writer_busy(mgr, timeout=5.0):
    w = mgr._async
    deadline = time.monotonic() + timeout
    while True:
        with w.cond:
            if w.active is not None and w.pending is None:
                return
        assert time.monotonic() < deadline, "writer never picked up job"
        time.sleep(0.005)


def test_async_save_returns_at_snapshot_cost(tmp_path, monkeypatch):
    _slow_writer(monkeypatch, delay=0.6)
    mgr = _mgr(tmp_path, _scope_with(np.arange(64)))
    t0 = time.perf_counter()
    mgr.save(1, extra_state={"mark": 1}, async_=True)
    assert time.perf_counter() - t0 < 0.3
    assert mgr.latest_step() is None
    mgr.drain()
    assert mgr.latest_step() == 1 and mgr.verify(1)
    assert mgr.restore()["extra"]["mark"] == 1


def test_async_supersede_coalesces_queued_saves(tmp_path, monkeypatch):
    gate = threading.Event()
    _slow_writer(monkeypatch, gate=gate)
    scope = _scope_with(np.zeros(8))
    mgr = _mgr(tmp_path, scope, keep_last_n=10)
    scope.set_var("w", torch.full((8,), 1.0))
    mgr.save(1, async_=True)
    _wait_writer_busy(mgr)
    for s in range(2, 6):
        scope.set_var("w", torch.full((8,), float(s)))
        mgr.save(s, async_=True)
    gate.set()
    mgr.drain()
    assert mgr.steps() == [1, 5]
    assert mgr.restore()["step"] == 5
    np.testing.assert_array_equal(_w(scope), np.full(8, 5.0, np.float32))


def test_async_snapshot_decoupled_from_live_scope(tmp_path, monkeypatch):
    """The snapshot is what commits, even when the host tensor it was
    taken from is written in place after the save."""
    gate = threading.Event()
    _slow_writer(monkeypatch, gate=gate)
    scope = _scope_with(np.full(4, 1.0))
    mgr = _mgr(tmp_path, scope)
    mgr.save(1, async_=True)
    scope.find_var("w").fill_(9.0)
    gate.set()
    mgr.drain()
    fresh = tfluid.Scope()
    _mgr(tmp_path, fresh).restore()
    np.testing.assert_array_equal(_w(fresh), np.full(4, 1.0, np.float32))


class _OnCard(torch.Tensor):
    """A CPU tensor that the snapshot takes for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_pinned_buffers_are_reused_and_never_refilled_in_flight(
        tmp_path, monkeypatch):
    """The page-locked snapshot buffers (taken for CUDA tensors): the one
    a writer is reading is never refilled, a queued snapshot superseded
    by a newer one gives its buffer back, and later saves reuse the free
    ones."""
    allocs = []

    def take(self, shape, dtype):
        with self._lock:
            bufs = self._free.get((tuple(shape), dtype))
            if bufs:
                return bufs.pop()
        allocs.append(tuple(shape))
        return torch.empty(tuple(shape), dtype=dtype)  # no CUDA to pin

    monkeypatch.setattr(ckpt._PinnedPool, "take", take)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def card(v):
        return torch.Tensor._make_subclass(_OnCard, torch.full((4,), v))

    gate = threading.Event()
    _slow_writer(monkeypatch, gate=gate)
    scope = tfluid.Scope()
    scope.set_var("w", card(1.0))
    mgr = _mgr(tmp_path, scope, keep_last_n=10)
    try:
        mgr.save(1, async_=True)
        _wait_writer_busy(mgr)              # buffer A in flight
        scope.set_var("w", card(2.0))
        mgr.save(2, async_=True)            # buffer B, queued
        scope.set_var("w", card(3.0))
        mgr.save(3, async_=True)            # C; superseded 2 gives B back
    finally:
        gate.set()
    assert allocs == [(4,)] * 3
    mgr.drain()
    assert mgr.steps() == [1, 3]
    for step, want in ((1, 1.0), (3, 3.0)):
        fresh = tfluid.Scope()
        _mgr(tmp_path, fresh).restore(step=step)
        np.testing.assert_array_equal(_w(fresh), np.full(4, want, np.float32))
    mgr.save(4)                             # sync: a free buffer again
    mgr.save(5, async_=True)
    mgr.drain()
    assert allocs == [(4,)] * 3 and mgr.verify(4) and mgr.verify(5)


def test_async_and_sync_saves_byte_identical(tmp_path):
    w = np.arange(32, dtype=np.float32) * 0.5
    s_sync, s_async = _scope_with(w), _scope_with(w)
    for s in (s_sync, s_async):
        s.set_var("h", torch.arange(6, dtype=torch.bfloat16))
        s._rng_seed = 12345
    _mgr(tmp_path / "sync", s_sync).save(3, extra_state={"epoch": 1})
    m = _mgr(tmp_path / "async", s_async)
    m.save(3, extra_state={"epoch": 1}, async_=True)
    m.drain()
    assert _tree_bytes(tmp_path / "sync") == _tree_bytes(tmp_path / "async")


def test_writer_exception_latches_and_reraises(tmp_path, monkeypatch):
    def failing(self, job):
        raise OSError("disk detached")

    monkeypatch.setattr(CheckpointManager, "_write_snapshot", failing)
    mgr = _mgr(tmp_path, _scope_with(np.ones(4)))
    mgr.save(1, async_=True)
    assert mgr._async.wait_idle(10)
    with pytest.raises(CheckpointWriterError, match="disk detached"):
        mgr.save(2, async_=True)
    monkeypatch.undo()
    mgr.save(3, async_=True)
    mgr.drain()
    assert mgr.latest_step() == 3
    monkeypatch.setattr(CheckpointManager, "_write_snapshot", failing)
    mgr.save(4, async_=True)
    with pytest.raises(CheckpointWriterError):
        mgr.drain()


def test_sync_save_supersedes_queued_and_waits_inflight(tmp_path,
                                                        monkeypatch):
    gate = threading.Event()
    _slow_writer(monkeypatch, gate=gate)
    scope = _scope_with(np.full(4, 1.0))
    mgr = _mgr(tmp_path, scope, keep_last_n=10)
    mgr.save(1, async_=True)
    _wait_writer_busy(mgr)
    scope.set_var("w", torch.full((4,), 2.0))
    mgr.save(2, async_=True)
    scope.set_var("w", torch.full((4,), 3.0))
    threading.Timer(0.2, gate.set).start()
    mgr.save(3, async_=False)
    assert mgr.steps() == [1, 3] and mgr.verify(3)


def test_fsync_opt_out_env(tmp_path, monkeypatch):
    from paddle_tpu_torch.fluid import io as io_lib

    w = np.arange(8, dtype=np.float32)
    _mgr(tmp_path / "on", _scope_with(w)).save(1)
    monkeypatch.setenv("PADDLE_CKPT_FSYNC", "0")
    assert not io_lib._fsync_enabled()
    m = _mgr(tmp_path / "off", _scope_with(w))
    m.save(1)
    assert m.verify(1)
    assert _tree_bytes(tmp_path / "on") == _tree_bytes(tmp_path / "off")


def test_ckpt_telemetry_and_write_span(tmp_path, monkeypatch):
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.telemetry import tracing

    reg = telemetry.get_registry()
    before = reg.counter("ckpt_bytes_written_total").value
    monkeypatch.setenv("PADDLE_TRACING", "1")
    tracing._reset_for_tests()
    try:
        mgr = _mgr(tmp_path, _scope_with(np.ones(8)))
        mgr.save(1, async_=True)
        mgr.drain()
        spans = tracing.finished_spans()
    finally:
        monkeypatch.delenv("PADDLE_TRACING")
        tracing._reset_for_tests()
    assert reg.counter("ckpt_bytes_written_total").value > before
    assert reg.gauge("ckpt_queue_depth").value == 0
    assert reg.histogram("checkpoint_write_ms").summary()["count"] >= 1
    saves = [s for s in spans if s["name"] == "checkpoint_save"]
    writes = [s for s in spans if s["name"] == "checkpoint_write"]
    assert writes[-1]["parent"] == saves[-1]["span"]
    assert writes[-1]["attrs"]["mode"] == "async"


# ---------------------------------------------------------------------------
# resume through Model.fit
# ---------------------------------------------------------------------------


def test_fit_preempt_resume_trace_bit_identical(tmp_path):
    X, Y = _data(64)
    m_ref = _model()
    h_ref = m_ref.fit((X, Y), batch_size=8, epochs=4, verbose=0)
    with pytest.raises(ckpt.Preempted):
        _model().fit((X, Y), batch_size=8, epochs=4, verbose=0,
                     checkpoint_dir=str(tmp_path), checkpoint_freq=5,
                     callbacks=[PreemptAtStep(13)])
    ckpt.clear_preemption()
    m_res = _model()
    h_res = m_res.fit((X, Y), batch_size=8, epochs=4, verbose=0,
                      checkpoint_dir=str(tmp_path), resume=True)
    assert h_ref["loss"] == h_res["loss"]
    _params_equal(m_ref.parameters(), m_res.parameters())


def test_fit_resume_from_torn_latest_falls_back(tmp_path):
    X, Y = _data(64)
    m_ref = _model()
    h_ref = m_ref.fit((X, Y), batch_size=8, epochs=3, verbose=0)
    with pytest.raises(ckpt.Preempted):
        _model().fit((X, Y), batch_size=8, epochs=3, verbose=0,
                     checkpoint_dir=str(tmp_path), checkpoint_freq=4,
                     callbacks=[PreemptAtStep(10)])
    ckpt.clear_preemption()
    mgr = _mgr(tmp_path)
    latest = mgr.latest_step()
    os.remove(tmp_path / f"ckpt-{latest:08d}" / "manifest.json")
    prev = _mgr(tmp_path).latest_step()
    p = tmp_path / f"ckpt-{prev:08d}" / "state.pkl"
    blob = bytearray(p.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    p.write_bytes(bytes(blob))
    m_res = _model()
    with pytest.warns(RuntimeWarning):
        h_res = m_res.fit((X, Y), batch_size=8, epochs=3, verbose=0,
                          checkpoint_dir=str(tmp_path), resume=True)
    assert h_ref["loss"] == h_res["loss"]
    _params_equal(m_ref.parameters(), m_res.parameters())


def test_fit_async_preempt_resume_trace_bit_identical(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_CKPT_ASYNC", "1")
    X, Y = _data(64)
    m_ref = _model()
    h_ref = m_ref.fit((X, Y), batch_size=8, epochs=3, verbose=0)
    with pytest.raises(ckpt.Preempted):
        _model().fit((X, Y), batch_size=8, epochs=3, verbose=0,
                     checkpoint_dir=str(tmp_path), checkpoint_freq=3,
                     callbacks=[PreemptAtStep(13)])
    ckpt.clear_preemption()
    mgr = _mgr(tmp_path)
    assert mgr.latest_step() == 13 and mgr.verify(13)
    m_res = _model()
    h_res = m_res.fit((X, Y), batch_size=8, epochs=3, verbose=0,
                      checkpoint_dir=str(tmp_path), resume=True)
    assert h_ref["loss"] == h_res["loss"]
    _params_equal(m_ref.parameters(), m_res.parameters())


def test_model_checkpoint_callback_step_freq_and_retention(tmp_path):
    X, Y = _data(64)
    cb = ModelCheckpoint(save_freq=5, save_dir=str(tmp_path),
                         save_freq_unit="step", keep_last_n=2)
    _model().fit((X, Y), batch_size=8, epochs=2, verbose=0, callbacks=[cb])
    mgr = _mgr(tmp_path)
    assert mgr.steps() == [10, 15] and all(mgr.verify(s) for s in (10, 15))
    st = _model()._checkpoint_manager(str(tmp_path)).restore()
    assert st["step"] == 15 and st["extra"]["global_step"] == 15
    with pytest.raises(ValueError):
        ModelCheckpoint(save_freq_unit="minute")


_DRILL = """
import sys
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import checkpoint as ckpt
from paddle_tpu_torch.hapi import Callback, Input, Model

def net(x):
    L = fluid.layers
    h = L.dropout(L.fc(x, 16, act="relu"), dropout_prob=0.3)
    return L.fc(h, 1)

class Report(Callback):
    n = 0

    def on_batch_end(self, mode, step, logs=None):
        self.n += 1
        print("STEP", self.n, repr(logs["loss"]), flush=True)
        sys.stdin.readline()  # the parent paces every step

rng = np.random.RandomState(0)
X, Y = rng.randn(64, 4).astype(np.float32), rng.randn(64, 1).astype(np.float32)
m = Model(net, Input("x", [8, 4]), Input("y", [8, 1]), device="cpu")
m.prepare(fluid.optimizer.AdamOptimizer(learning_rate=1e-2),
          lambda q, y: fluid.layers.mean(fluid.layers.square_error_cost(q, y)))
try:
    m.fit((X, Y), batch_size=8, epochs=3, verbose=0, callbacks=[Report()],
          checkpoint_dir=sys.argv[1], checkpoint_freq=4, checkpoint_keep=2)
except ckpt.Preempted:
    sys.exit(ckpt.PREEMPTED_EXIT_CODE)
print("FINISHED", flush=True)
"""


def test_sigterm_drill_exits_75_and_resumes_bit_for_bit(tmp_path):
    """A real SIGTERM after the child reports step 6: the child leaves a
    final checkpoint at the next step boundary and exits 75; the resume
    continues to the end with the straight run's trace and parameters."""
    X, Y = _data(64)
    m_ref = _model()
    ref, h_ref = _steps(m_ref, X, Y)
    script = tmp_path / "drill.py"
    script.write_text(textwrap.dedent(_DRILL))
    root = tmp_path / "ckpts"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_") and k != "FLAGS_ps_fault_injection"}
    env["PYTHONPATH"] = REPO
    child = subprocess.Popen([sys.executable, "-u", str(script), str(root)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env)
    losses = []
    try:
        for line in child.stdout:
            if not line.startswith("STEP"):
                continue
            _, n, loss = line.split()
            losses.append(float(loss))
            if int(n) == 6:
                child.send_signal(signal.SIGTERM)
            child.stdin.write("\n")
            child.stdin.flush()
        rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
    assert rc == ckpt.PREEMPTED_EXIT_CODE, child.stderr.read()
    assert losses == ref[:6]
    mgr = _mgr(root)
    assert mgr.latest_step() == 6 and mgr.verify(6)
    assert mgr.steps() == [4, 6]
    m_res = _model()
    got, h_res = _steps(m_res, X, Y, checkpoint_dir=str(root), resume=True)
    assert got == ref[6:]
    assert h_res["loss"] == h_ref["loss"]
    _params_equal(m_ref.parameters(), m_res.parameters())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    X, Y = _data(64)
    ref, _ = _steps(_jax_model(p=0.0), X, Y)
    with pytest.raises(jckpt.Preempted):
        _steps(_jax_model(p=0.0), X, Y, checkpoint_dir=str(tmp_path),
               checkpoint_freq=5,
               callbacks=[PreemptAtStep(11, jckpt.request_preemption)])
    jckpt.clear_preemption()
    got, _ = _steps(_model(p=0.0), X, Y, checkpoint_dir=str(tmp_path),
                    resume=True)
    assert len(got) == 24 - 11
    np.testing.assert_allclose(got, ref[11:], rtol=REL_TOL, atol=0)


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    X, Y = _data(64)
    ref, _ = _steps(_model(p=0.0), X, Y)
    with pytest.raises(ckpt.Preempted):
        _steps(_model(p=0.0), X, Y, checkpoint_dir=str(tmp_path),
               checkpoint_freq=5, callbacks=[PreemptAtStep(11)])
    ckpt.clear_preemption()
    got, _ = _steps(_jax_model(p=0.0), X, Y, checkpoint_dir=str(tmp_path),
                    resume=True)
    assert len(got) == 24 - 11
    np.testing.assert_allclose(got, ref[11:], rtol=REL_TOL, atol=0)


def test_bf16_arrays_round_trip_bit_for_bit_both_ways(tmp_path):
    import jax.numpy as jnp
    import ml_dtypes

    bits = np.random.RandomState(0).randint(0, 1 << 16, (3, 5)).astype(
        np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0  # no NaN/Inf payloads
    scope = tfluid.Scope()
    scope.set_var("h", torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16))
    scope.set_var("f", torch.arange(4.0))
    _mgr(tmp_path / "port", scope).save(1)
    with open(tmp_path / "port" / "ckpt-00000001" / "state.pkl", "rb") as f:
        raw = pickle.load(f)["arrays"]  # the plain unpickler, ml_dtypes
    assert raw["h"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(raw["h"].view(np.uint16), bits)
    jscope = jfluid.Scope()
    assert jckpt.CheckpointManager(str(tmp_path / "port"),
                                   scope=jscope).restore()["step"] == 1
    h = np.asarray(jscope.find_var("h"))
    assert h.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(h.view(np.uint16), bits)
    # the JAX package's bf16 array into the port
    jscope.set_var("h2", jnp.asarray(bits.view(ml_dtypes.bfloat16)[::-1]))
    jckpt.CheckpointManager(str(tmp_path / "jax"), scope=jscope).save(2)
    back = tfluid.Scope()
    _mgr(tmp_path / "jax", back).restore()
    t = back.find_var("h2")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits[::-1])
    np.testing.assert_array_equal(back.find_var("f").numpy(), np.arange(4.0))


def test_step_seed_and_key_mapping(tmp_path):
    import jax

    seed = (0x5EED << 40) | 0x12345678
    scope = _scope_with(np.ones(2))
    scope._rng_seed = seed
    _mgr(tmp_path / "a", scope).save(1)
    back = tfluid.Scope()
    _mgr(tmp_path / "a", back).restore()
    assert back._rng_seed == seed
    with open(tmp_path / "a" / "ckpt-00000001" / "rng.pkl", "rb") as f:
        st = pickle.load(f)
    assert st["typed"] is False and st["data"].dtype == np.uint32
    assert list(st["data"]) == [seed >> 32, seed & 0xFFFFFFFF]
    jscope = jfluid.Scope()
    jckpt.CheckpointManager(str(tmp_path / "a"), scope=jscope).restore()
    np.testing.assert_array_equal(np.asarray(jscope._rng_key), st["data"])
    # JAX keys: a raw two-word key and a typed four-word one
    for key in (jax.random.PRNGKey(7),
                jax.random.key(9, impl="rbg")):
        words = np.asarray(jax.random.key_data(key)
                           if jax.dtypes.issubdtype(key.dtype,
                                                    jax.dtypes.prng_key)
                           else key).astype(np.uint32).reshape(-1)
        jscope._rng_key = key
        d = tmp_path / f"k{words.size}"
        jckpt.CheckpointManager(str(d), scope=jscope).save(3)
        got = tfluid.Scope()
        _mgr(d, got).restore()
        want = ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)
        assert got._rng_seed == want
    with pytest.raises(ValueError, match="at least 2"):
        ckpt._restore_rng({"typed": False, "data": np.zeros(1, np.uint32)})


def test_save_dygraph_files_match_byte_for_byte(tmp_path):
    from paddle_tpu.fluid.dygraph import checkpoint as jdc
    from paddle_tpu_torch.fluid import dygraph as tdy

    rng = np.random.RandomState(3)
    params = {"w": rng.rand(3, 4).astype(np.float32),
              "b": np.arange(4, dtype=np.int64)}
    opt = {"w": {"moment1": rng.rand(3, 4).astype(np.float32)}}
    for state in (params, opt):
        jdc.save_dygraph(state, str(tmp_path / "j" / "m"))
        tdy.save_dygraph(state, str(tmp_path / "t" / "m"))
    assert _tree_bytes(tmp_path / "j") == _tree_bytes(tmp_path / "t")
    p, o = tdy.load_dygraph(str(tmp_path / "j" / "m"))
    np.testing.assert_array_equal(p["w"], params["w"])
    np.testing.assert_array_equal(o["w"]["moment1"], opt["w"]["moment1"])
    with pytest.raises(ValueError):
        tdy.load_dygraph(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# refusals and device placement
# ---------------------------------------------------------------------------


def test_sharded_layout_and_ps_tables_raise(tmp_path, monkeypatch):
    # the sharded layout is ported: PADDLE_CKPT_SHARDED with a world size
    # above 1 arms it (tests/test_torch_sharded_checkpoint.py holds it
    # against the JAX package); parameter-server tables still raise
    monkeypatch.setenv("PADDLE_CKPT_SHARDED", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    assert CheckpointManager(str(tmp_path / "sharded")).sharded
    assert not CheckpointManager(str(tmp_path / "one"), world_size=1).sharded
    monkeypatch.delenv("PADDLE_CKPT_SHARDED")
    mgr = CheckpointManager(str(tmp_path), scope=_scope_with(np.ones(2)),
                            device="cpu")
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name="ids", shape=(4, 1), dtype="int64")
    blk.create_var(name="emb", shape=(4, 8), dtype="float32")
    blk.append_op(type="distributed_lookup_table", inputs={"Ids": ["ids"]},
                  outputs={"Outputs": ["emb"]},
                  attrs={"table_names": ["emb_table"]}, infer=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        mgr.save(1, program=prog)
    assert mgr.steps() == []
    # a world-size mismatch is refused, never resharded
    mgr.save(2)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    with pytest.raises(ckpt.WorldSizeMismatchError):
        _mgr(tmp_path, tfluid.Scope()).restore()


def test_restore_places_arrays_on_the_managers_device(tmp_path,
                                                      monkeypatch):
    _mgr(tmp_path, _scope_with(np.ones(3))).save(1)
    scope = tfluid.Scope()
    CheckpointManager(str(tmp_path), scope=scope, device="meta").restore()
    assert scope.find_var("w").device.type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(str(tmp_path), scope=tfluid.Scope()).restore()
