"""The sharded checkpoint layout in the port (``fluid/checkpoint.py``:
``rank<k>/`` shards, the commit barrier, rank 0's global manifest)
against the JAX package's, on the CPU.

Mirrors ``tests/test_checkpoint_async.py:554-672``: two ranks of one job
(rank 1 on a thread) save a step; only the global manifest commits it,
each rank restores its own shard, a step whose barrier never completes
stays invisible and is reported and collected as torn by
``tools/ckpt_doctor.py``, the shared-filesystem fallback and the RPC
barrier over the transport commit alike, async saves compose, the
world-size gate refuses a resize unless re-sharding is allowed, and rank
0 alone owns retention.  Across packages: a sharded checkpoint the JAX
package writes restores in the port to the same values, and the port's
in the JAX package; the barrier of either package's coordinator serves
the other's ranks; the crash phases of the sharded commit
(``ckpt_shard_committed``, ``ckpt_before_global_commit``) and the
``ckpt_global_manifest`` disk faults leave the previous step restorable.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed import coordinator as jcoord
from paddle_tpu.fluid import checkpoint as jckpt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.distributed import coordinator as tcoord
from paddle_tpu_torch.distributed import faults as tfaults
from paddle_tpu_torch.fluid import checkpoint as tckpt
from paddle_tpu_torch.fluid import flags as tflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import ckpt_doctor  # noqa: E402


def _scope(pkg, w):
    if pkg == "jax":
        import jax.numpy as jnp

        scope = jfluid.executor.Scope()
        scope.set_var("w", jnp.asarray(np.asarray(w, np.float32)))
        return scope
    scope = tfluid.Scope()
    scope.set_var("w", torch.as_tensor(np.asarray(w, np.float32)))
    return scope


def _w(scope):
    v = scope.find_var("w")
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mgr(pkg, root, rank, barrier=None, world=2, scope=None, **kw):
    if pkg == "jax":
        return jckpt.CheckpointManager(
            str(root), scope=scope, world_size=world, rank=rank,
            sharded=True, barrier=barrier, **kw)
    return tckpt.CheckpointManager(
        str(root), scope=scope, world_size=world, rank=rank, sharded=True,
        barrier=barrier, device="cpu", **kw)


def _shard_mgr(root, rank, barrier=None, world=2, pkg="torch", **kw):
    scope = _scope(pkg, np.full(4, 10.0 + rank, np.float32))
    return _mgr(pkg, root, rank, barrier, world, scope, **kw), scope


def _save_both(root, step, barrier=None, stagger=0.0, pkg="torch", **kw):
    """Two ranks of one sharded job saving `step` (rank 1 on a thread:
    rank 0 blocks in the commit barrier until rank 1's shard lands)."""
    m0, _ = _shard_mgr(root, 0, barrier, pkg=pkg, **kw)
    m1, _ = _shard_mgr(root, 1, barrier, pkg=pkg, **kw)
    errs = []

    def r1():
        if stagger:
            time.sleep(stagger)
        try:
            m1.save(step, extra_state={"rank": 1})
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=r1, daemon=True)
    t.start()
    m0.save(step, extra_state={"rank": 0})
    t.join(30)
    assert not errs, errs
    return m0, m1


def test_sharded_global_commit_and_per_rank_restore(tmp_path):
    barrier = tcoord.CkptBarrier()
    m0, m1 = _save_both(tmp_path, 4, barrier)
    for m in (m0, m1):
        assert m.steps() == [4] and m.verify(4)
    gm = m0.global_manifest(4)
    assert gm["world_size"] == 2 and set(gm["shards"]) == {"rank0", "rank1"}
    for rname, info in gm["shards"].items():
        blob = open(tmp_path / "ckpt-00000004" / rname /
                    "manifest.json", "rb").read()
        assert hashlib.sha256(blob).hexdigest() == info["manifest_sha256"]
    for rank in (0, 1):
        fresh = tfluid.Scope()
        st = _mgr("torch", tmp_path, rank, scope=fresh).restore()
        assert st["step"] == 4 and st["extra"]["rank"] == rank
        assert st["global_manifest"]["world_size"] == 2
        np.testing.assert_array_equal(_w(fresh),
                                      np.full(4, 10.0 + rank, np.float32))


def test_sharded_partial_commit_is_invisible_and_torn(tmp_path,
                                                      monkeypatch):
    barrier = tcoord.CkptBarrier()
    _save_both(tmp_path, 2, barrier)
    monkeypatch.setenv("PADDLE_CKPT_BARRIER_TIMEOUT", "0.5")
    m0, _ = _shard_mgr(tmp_path, 0, barrier)
    with pytest.raises(tckpt.CommitBarrierError):
        m0.save(3)
    assert m0.steps() == [2]
    assert (tmp_path / "ckpt-00000003" / "rank0" / "manifest.json").exists()
    assert not (tmp_path / "ckpt-00000003" / "global_manifest.json").exists()
    fresh = tfluid.Scope()
    assert _mgr("torch", tmp_path, 0, scope=fresh).restore()["step"] == 2
    rep = ckpt_doctor.scan_root(str(tmp_path))
    assert {e["step"]: e["status"] for e in rep["steps"]}[3] == "torn"
    removed = ckpt_doctor.gc_root(str(tmp_path), rep)
    assert str(tmp_path / "ckpt-00000003") in removed
    assert (tmp_path / "ckpt-00000002").exists()


def test_sharded_fs_barrier_fallback(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_CKPT_BARRIER_ENDPOINT", raising=False)
    m0, m1 = _save_both(tmp_path, 7, barrier=None, stagger=0.3)
    assert m0.verify(7) and m1.verify(7)
    assert set(m0.global_manifest(7)["shards"]) == {"rank0", "rank1"}


@pytest.mark.parametrize("server", [tcoord, jcoord],
                         ids=["torch_barrier", "jax_barrier"])
def test_sharded_rpc_barrier_over_transport(tmp_path, monkeypatch, server):
    """The launcher's path: the commit barrier served over the transport
    (either package's serves the port's ranks)."""
    barrier = server.CkptBarrier()
    srv, ep = server.serve_ckpt_barrier(barrier)
    try:
        monkeypatch.setenv("PADDLE_CKPT_BARRIER_ENDPOINT", ep)
        m0, m1 = _save_both(tmp_path, 5, barrier=None)
        assert m0.verify(5) and m1.verify(5)
        assert m0.global_manifest(5)["world_size"] == 2
    finally:
        server.stop_coordinator(srv)


def test_sharded_async_commit(tmp_path):
    barrier = tcoord.CkptBarrier()
    m0, _ = _shard_mgr(tmp_path, 0, barrier, async_save=True)
    m1, _ = _shard_mgr(tmp_path, 1, barrier, async_save=True)
    t0 = time.perf_counter()
    m0.save(6)
    assert time.perf_counter() - t0 < 1.0
    m1.save(6)
    m1.drain()
    m0.drain()
    assert m0.verify(6) and m1.verify(6)


def test_sharded_world_size_gate(tmp_path, monkeypatch):
    _save_both(tmp_path, 2, tcoord.CkptBarrier())
    monkeypatch.delenv("PADDLE_ELASTIC_RESHARD", raising=False)
    mgr = _mgr("torch", tmp_path, 0, world=3, scope=tfluid.Scope())
    with pytest.raises(tckpt.WorldSizeMismatchError):
        mgr.restore()
    st = mgr.restore(allow_reshard=True)
    assert st["step"] == 2 and st["world_size"] == 2
    monkeypatch.setenv("PADDLE_ELASTIC_RESHARD", "1")
    assert mgr.restore()["world_size"] == 2


def test_sharded_retention_rank0_owns_gc(tmp_path):
    barrier = tcoord.CkptBarrier()
    for s in (1, 2, 3, 4):
        _save_both(tmp_path, s, barrier, keep_last_n=2)
    m0 = _mgr("torch", tmp_path, 0)
    assert m0.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003",
                                            "ckpt-00000004"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_sharded_checkpoint_restores_across_packages(tmp_path, writer,
                                                     reader):
    """Either package's sharded checkpoint, its barrier either package's
    coordinator's, restores in the other to the same values, rank by
    rank."""
    barrier = (jcoord if writer == "torch" else tcoord).CkptBarrier()
    _save_both(tmp_path, 3, barrier, pkg=writer)
    for rank in (0, 1):
        fresh = _scope(reader, np.zeros(4, np.float32))
        mgr = _mgr(reader, tmp_path, rank, scope=fresh)
        assert mgr.steps() == [3] and mgr.verify(3)
        st = mgr.restore()
        assert st["step"] == 3 and st["extra"] == {"rank": rank}
        np.testing.assert_array_equal(_w(fresh),
                                      np.full(4, 10.0 + rank, np.float32))
    rep = ckpt_doctor.scan_root(str(tmp_path))
    assert {e["step"]: e["status"] for e in rep["steps"]} == {3: "ok"}


@pytest.fixture
def armed(monkeypatch):
    before = tflags.flag("FLAGS_ps_fault_injection")

    def arm(spec):
        monkeypatch.setenv("PADDLE_PS_FAULT_SPEC", spec)
        monkeypatch.delenv("PADDLE_PS_FAULT_TAGS", raising=False)
        tflags.set_flags({"FLAGS_ps_fault_injection": True})
        tfaults.reset()

    yield arm
    tflags.set_flags({"FLAGS_ps_fault_injection": before})
    tfaults.reset()


@pytest.mark.parametrize("phase", ["ckpt_shard_committed",
                                   "ckpt_before_global_commit"])
def test_sharded_crash_phases_leave_the_step_torn(tmp_path, monkeypatch,
                                                  armed, phase):
    """A crash between the shard commit and the global commit (os._exit
    patched to raise, in-process): the step has no global manifest, the
    previous step restores."""
    _save_both(tmp_path, 2, tcoord.CkptBarrier())

    class Crash(BaseException):
        pass

    def die(code):
        raise Crash(code)

    monkeypatch.setattr(tfaults.os, "_exit", die)
    armed(f"crash:{phase}:1")
    barrier = tcoord.CkptBarrier()
    m1, _ = _shard_mgr(tmp_path, 1, barrier)
    m0, _ = _shard_mgr(tmp_path, 0, barrier)
    if phase == "ckpt_shard_committed":
        with pytest.raises(Crash):
            m1.save(4)          # rank 1 dies before its barrier report
    else:
        tfaults.reset()
        monkeypatch.delenv("PADDLE_PS_FAULT_SPEC")
        m1.save(4)
        armed(f"crash:{phase}:1")
        with pytest.raises(Crash):
            m0.save(4)          # rank 0 dies before the global manifest
    assert (tmp_path / "ckpt-00000004" / "rank1" / "manifest.json").exists()
    assert not (tmp_path / "ckpt-00000004" / "global_manifest.json").exists()
    fresh = tfluid.Scope()
    assert _mgr("torch", tmp_path, 0, scope=fresh).restore()["step"] == 2


@pytest.mark.parametrize("rule", ["io_err", "short_write"])
def test_global_manifest_disk_faults(tmp_path, armed, rule):
    _save_both(tmp_path, 2, tcoord.CkptBarrier())
    armed(f"{rule}:ckpt_global_manifest:1")
    barrier = tcoord.CkptBarrier()
    m1, _ = _shard_mgr(tmp_path, 1, barrier)
    m0, _ = _shard_mgr(tmp_path, 0, barrier)
    m1.save(4)
    if rule == "io_err":
        with pytest.raises(OSError):
            m0.save(4)
    else:
        m0.save(4)     # the writer believes it; the manifest is torn
    assert _mgr("torch", tmp_path, 0).steps() == [2]
    fresh = tfluid.Scope()
    assert _mgr("torch", tmp_path, 1, scope=fresh).restore()["step"] == 2
