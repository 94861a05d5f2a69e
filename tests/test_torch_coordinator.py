"""The job coordinator and its fault rules in the port
(``paddle_tpu_torch/distributed/coordinator.py``, ``faults.py``)
against the JAX package's, on the CPU.

The coordinator is framework-neutral, so each case drives the same verb
sequence, with explicit clocks, through both packages' ``Coordinator``
(and ``CkptBarrier``) and compares what comes back: the replies, the
membership epochs, the evictions, the events (less their wall-clock
``ts``) and the ``state_dict``.  The sequences mirror the JAX package's
``tests/test_elastic.py`` (register / renew / expiry, per-rank budget
eviction, the future-epoch guard, the startup grace) and
``tests/test_coordinator_ha.py`` (the durable snapshot + WAL replay with
its incarnation bump, the torn-snapshot fallback, the reconciliation
window, the standby that refuses and then promotes, the client's grace
mode and its failover down the endpoint list).  Over the transport each
package's client talks to the other's coordinator.  The ``lease_expire``
and ``netsplit`` rules parse and fire alike in both packages; the verbs
the port refuses (SDC numerics, the fleet rollups) raise naming ROADMAP
A8.
"""
from __future__ import annotations

import os
import time

import pytest

from paddle_tpu.distributed import coordinator as jcoord
from paddle_tpu.distributed import faults as jfaults
from paddle_tpu.fluid import flags as jflags
from paddle_tpu_torch.distributed import coordinator as tcoord
from paddle_tpu_torch.distributed import faults as tfaults
from paddle_tpu_torch.fluid import flags as tflags

PKGS = {"jax": jcoord, "torch": tcoord}


def _clean(obj):
    """A reply or state with the wall-clock stamps taken out."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()
                if k not in ("ts", "saved_at")}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def _both(scenario, *args):
    """Run ``scenario(module, *args)`` on both packages; the port's
    transcript, held equal to the JAX package's."""
    got = {name: _clean(scenario(mod, *args)) for name, mod in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# the lease table (tests/test_elastic.py:55-140)
# ---------------------------------------------------------------------------


def _register_renew(C):
    c = C.Coordinator(lease_secs=1.0, retries_per_rank=1)
    t0, out = 1000.0, []
    for i in range(3):
        out.append(c.register(f"trainer{i}", kind="trainer", now=t0))
    c.register("ps0", kind="pserver", endpoint="127.0.0.1:1", now=t0)
    out.append(c.membership(now=t0))
    for k in range(10):
        for i in range(3):
            out.append(c.renew(f"trainer{i}", payload={"step": k}, epoch=0,
                               now=t0 + k))
        out.append(c.sweep(now=t0 + k + 0.5))
    out.append(c.membership(now=t0 + 10)["members"]["trainer1"])
    out.append(c.state_dict(now=t0 + 10))
    return out


def test_register_renew_membership():
    out = _both(_register_renew)
    assert out[0] == {"epoch": 0, "lease_secs": 1.0, "evicted": False}
    m = out[3]
    assert m["epoch"] == 0 and m["world_size"] == 3
    assert m["members"]["ps0"]["kind"] == "pserver"
    assert all(s == [] for s in out[7:-2:4])
    assert out[-2]["payload"] == {"step": 9}


def _expiry_and_budget(C):
    c = C.Coordinator(lease_secs=1.0, retries_per_rank=1, startup_grace=2.0)
    t0, out = 1000.0, []
    for i in range(2):
        c.register(f"trainer{i}", now=t0)
        c.renew(f"trainer{i}", epoch=0, now=t0)
    c.renew("trainer0", epoch=0, now=t0 + 1.5)
    out.append(c.sweep(now=t0 + 2.5))
    out.append(c.sweep(now=t0 + 3.0))
    out.append(c.report_failure("trainer1", "lease expired"))
    c.register("trainer1", now=t0 + 4.0)
    out.append(c.report_failure("trainer1", "nonzero exit (code 9)"))
    out.append(c.membership(now=t0 + 4.0)["world_size"])
    out.append(c.renew("trainer1", epoch=0, now=t0 + 5.0))
    out.append(c.register("trainer1", now=t0 + 5.0))
    out.append(c.drain_events())
    out.append(c.state_dict(now=t0 + 5.0))
    return out


def test_lease_expiry_and_per_rank_budget_eviction():
    out = _both(_expiry_and_budget)
    assert [e["event"] for e in out[0]] == ["lease_expired"]
    assert out[0][0]["tag"] == "trainer1"
    assert out[1] == []
    assert not out[2]["evicted"] and out[2]["retries_left"] == 0
    assert out[3]["evicted"] and out[3]["epoch"] == 1
    assert out[4] == 1
    assert out[5]["evicted"] and out[6]["evicted"]
    evs = [e["event"] for e in out[7]]
    assert "member_failed" in evs and "member_evicted" in evs


def _future_epoch(C):
    c = C.Coordinator(lease_secs=1.0, retries_per_rank=0, startup_grace=1.0)
    t0 = 1000.0
    c.register("trainer0", now=t0)
    c.renew("trainer0", epoch=0, now=t0)
    return [c.renew("trainer0", epoch=0, now=t0 + 1.0),
            c.renew("trainer0", epoch=5, now=t0 + 1.5),
            c.renew("trainer0", epoch=5, now=t0 + 2.5),
            c.sweep(now=t0 + 3.5), c.drain_events()]


def test_future_epoch_renewal_is_stale_coordinator_guard():
    out = _both(_future_epoch)
    assert out[0] == {"epoch": 0, "evicted": False}
    assert out[1]["stale_coordinator"] and out[2]["stale_coordinator"]
    assert [e["event"] for e in out[3]] == ["lease_expired"]
    assert any(e["event"] == "stale_coordinator" for e in out[4])


def _startup_grace(C):
    c = C.Coordinator(lease_secs=1.0, retries_per_rank=0,
                      startup_grace=10.0)
    c.register("trainer0", now=1000.0)
    return [c.sweep(now=1005.0), c.sweep(now=1010.5)]


def test_startup_grace_covers_slow_boot():
    out = _both(_startup_grace)
    assert out[0] == [] and [e["event"] for e in out[1]] == ["lease_expired"]


def _barrier(C):
    b = C.CkptBarrier()
    return [b.shard_commit(4, 0, 2, {"manifest_sha256": "aa"}),
            b.status(4), b.wait_full(4, 2, timeout=0.05),
            b.shard_commit(4, 1, 2, {"manifest_sha256": "bb"}),
            b.wait_full(4, 2, timeout=0.05), b.handle("ping", {}),
            b.handle("ckpt_status", {"step": 4})]


def test_ckpt_barrier_replies():
    out = _both(_barrier)
    assert out[0] == {"complete": False} and out[3] == {"complete": True}
    assert not out[2]["complete"] and out[4]["complete"]


# ---------------------------------------------------------------------------
# durable state and HA (tests/test_coordinator_ha.py:91-498)
# ---------------------------------------------------------------------------


def _populated(C, state_dir=None, lease=1.0, **kw):
    """A coordinator with every table non-trivially populated."""
    c = C.Coordinator(lease_secs=lease, retries_per_rank=2,
                      startup_grace=5.0, state_dir=state_dir,
                      snapshot_secs=kw.pop("snapshot_secs", 3600.0), **kw)
    t0 = 1000.0
    for i in range(3):
        c.register(f"trainer{i}", kind="trainer", now=t0)
        c.renew(f"trainer{i}", payload={"step": 7 + i}, epoch=0,
                now=t0 + 0.5)
    c.register("ps0", kind="pserver", endpoint="127.0.0.1:7001",
               payload={"partitions": {"tab@p0": {"role": "primary",
                                                  "epoch": 3, "seq": 41}}},
               now=t0)
    c.report_failure("trainer2", reason="exit 1")
    c.register("trainer2", now=t0 + 1.0)
    c.note_incident({"event": "stall", "rank": 1, "excess_ms": 1200.0})
    c.ckpt_barrier.shard_commit(step=12, rank=0, world_size=2,
                                info={"manifest_sha256": "abc"})
    c._sdc_evicted.add("trainer9")
    return c


def _roundtrip(C):
    c = _populated(C)
    st = c.state_dict(now=1002.0)
    c2 = C.Coordinator(lease_secs=1.0, retries_per_rank=2,
                       startup_grace=5.0)
    c2.load_state_dict(st, now=1002.0)
    return [st, c2.state_dict(now=1002.0)]


def test_state_dict_roundtrip_every_table():
    st, back = _both(_roundtrip)
    assert back == st
    # either package's state restores in the other
    for a, b in ((jcoord, tcoord), (tcoord, jcoord)):
        c2 = b.Coordinator(lease_secs=1.0, retries_per_rank=2,
                           startup_grace=5.0)
        c2.load_state_dict(_populated(a).state_dict(now=1002.0), now=1002.0)
        assert _clean(c2.state_dict(now=1002.0)) == st


def _wal_replay(C, d):
    c = _populated(C, state_dir=d)
    inc0 = c.incarnation
    c.snapshot(force=True)
    c.renew("trainer0", payload={"step": 99}, epoch=0, now=2000.0)
    c.report_failure("trainer1", reason="post-snap")
    c.ckpt_barrier.shard_commit(step=12, rank=1, world_size=2,
                                info={"manifest_sha256": "def"})
    c._mutated("ckpt_shard_commit", {"step": 12, "rank": 1,
                                     "world_size": 2,
                                     "info": {"manifest_sha256": "def"}})
    r = C.Coordinator(lease_secs=1.0, retries_per_rank=2,
                      startup_grace=5.0, state_dir=d, snapshot_secs=3600.0)
    st = r.state_dict(now=2000.0)
    for m in st["members"]:
        # the recovered windows are floored at the reconciliation window,
        # which runs from the recovery's own clock
        m.pop("remaining")
    return [inc0, r.incarnation, r.members["trainer0"].payload,
            r.members["trainer1"].failures,
            r.ckpt_barrier.status(12)["complete"],
            [e["event"] for e in r.incidents], st]


def test_durable_recovery_replays_wal_and_bumps_incarnation(tmp_path):
    out = _both(lambda C: _wal_replay(C, str(tmp_path / C.__name__)))
    assert out[:5] == [1, 2, {"step": 99}, 1, True]
    assert "coord_recovered" in out[5]


def _torn_snapshot(C, d):
    c = _populated(C, state_dir=d)
    c.snapshot(force=True)
    c.renew("trainer0", payload={"step": 50}, epoch=0, now=2000.0)
    c.snapshot(force=True)
    newest = max(int(f.split("-")[1].split(".")[0])
                 for f in os.listdir(d) if f.endswith(".snap"))
    p = os.path.join(d, f"coord-{newest:08d}.snap")
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:len(blob) // 2])
    r = C.Coordinator(lease_secs=1.0, retries_per_rank=2,
                      startup_grace=5.0, state_dir=d, snapshot_secs=3600.0)
    return [r.members["trainer0"].payload, r.incarnation]


def test_torn_newest_snapshot_falls_back_to_previous(tmp_path):
    out = _both(lambda C: _torn_snapshot(C, str(tmp_path / C.__name__)))
    assert out == [{"step": 50}, 2]


def test_snapshot_and_wal_cross_packages(tmp_path):
    """A state directory one package's durable coordinator wrote
    recovers in the other's: the same framed snapshot and WAL bytes."""
    for a, b in ((jcoord, tcoord), (tcoord, jcoord)):
        d = str(tmp_path / f"{a.__name__}-to-{b.__name__}")
        c = _populated(a, state_dir=d)
        c.snapshot(force=True)
        c.renew("trainer0", payload={"step": 77}, epoch=0, now=2000.0)
        r = b.Coordinator(lease_secs=1.0, retries_per_rank=2,
                          startup_grace=5.0, state_dir=d,
                          snapshot_secs=3600.0)
        assert r.incarnation == 2
        assert r.members["trainer0"].payload == {"step": 77}
        assert r.members["trainer2"].failures == 1


def _reconcile(C, d):
    lease = 0.2
    c = C.Coordinator(lease_secs=lease, retries_per_rank=0,
                      startup_grace=0.3, state_dir=d, snapshot_secs=3600.0)
    c.register("trainer0", now=time.time())
    c.renew("trainer0", epoch=0, now=time.time())
    c.snapshot(force=True)
    time.sleep(3 * lease)
    r = C.Coordinator(lease_secs=lease, retries_per_rank=0,
                      startup_grace=0.3, state_dir=d, snapshot_secs=3600.0)
    inside = [r.sweep(), r.coord_status()["reconcile_remaining_s"] > 0]
    deadline, raised = time.time() + 10 * lease, []
    while time.time() < deadline and not raised:
        raised = r.sweep()
        time.sleep(lease / 4)
    return inside + [[e["tag"] for e in raised]]


def test_recovery_reconciliation_window_never_false_evicts(tmp_path):
    out = _both(lambda C: _reconcile(C, str(tmp_path / C.__name__)))
    assert out == [[], True, ["trainer0"]]


def _deposed(C, d):
    c = C.Coordinator(lease_secs=1.0, state_dir=d, snapshot_secs=3600.0)
    return [c.incarnation,
            c.handle("renew", {"tag": "trainer0", "coord_inc": 3}),
            c.stale_latched,
            c.handle("register", {"tag": "trainer1", "coord_inc": 1}),
            c.sweep(now=time.time() + 1e6),
            c.handle("ckpt_shard_commit", {"step": 1, "rank": 0,
                                           "world_size": 2, "info": {}})]


def test_deposed_primary_latches_stale(tmp_path):
    out = _both(lambda C: _deposed(C, str(tmp_path / C.__name__)))
    assert out[0] == 1 and out[1]["stale_coordinator"] and out[2]
    assert out[3]["stale_coordinator"] and out[4] == []
    assert out[5].get("standby") is True
    # the legacy in-launcher coordinator stamps nothing
    out = _both(lambda C: [C.Coordinator(lease_secs=1.0).handle(
        "register", {"tag": "trainer0"})])
    assert out == [{"epoch": 0, "lease_secs": 1.0, "evicted": False}]


def _standby(C, d):
    primary = _populated(C, state_dir=os.path.join(d, "p"))
    primary.snapshot(force=True)
    primary.renew("trainer0", payload={"step": 123}, epoch=0, now=3000.0)
    standby = C.Coordinator(lease_secs=1.0, retries_per_rank=2,
                            startup_grace=5.0, role="standby",
                            state_dir=os.path.join(d, "s"),
                            snapshot_secs=3600.0)
    standby.repl_apply(primary.repl_pull(have_seq=-1, have_off=0))
    out = [standby.members["trainer0"].payload,
           standby.incarnation == primary.incarnation]
    off = len(primary._wal_mem)
    primary.renew("trainer1", payload={"step": 124}, epoch=0, now=3001.0)
    pulled = primary.repl_pull(have_seq=primary._snap_seq, have_off=off)
    out.append(["snapshot" in pulled, len(pulled["wal"])])
    standby.repl_apply(pulled)
    out.append(standby.members["trainer1"].payload)
    for verb, kw in (("renew", {"tag": "trainer0"}),
                     ("ckpt_shard_commit", {"step": 1, "rank": 0,
                                            "world_size": 2, "info": {}})):
        out.append(standby.handle(verb, kw))
    out.append(standby.sweep(now=time.time() + 1e6))
    old = primary.incarnation
    standby.promote()
    out += [standby.role, standby.incarnation - old, standby.sweep(),
            standby.handle("renew", {"tag": "trainer0"})]
    return out


def test_standby_mirrors_refuses_then_promotes(tmp_path):
    out = _both(lambda C: _standby(C, str(tmp_path / C.__name__)))
    assert out[:4] == [{"step": 123}, True, [False, 1], {"step": 124}]
    assert out[4]["standby"] and out[5]["standby"] and out[6] == []
    assert out[7:10] == ["primary", 2, []]
    assert "standby" not in out[10]


# ---------------------------------------------------------------------------
# over the transport, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("server,client", [(tcoord, jcoord),
                                           (jcoord, tcoord)],
                         ids=["torch_server", "jax_server"])
def test_coordinator_over_rpc_across_packages(server, client):
    c = server.Coordinator(lease_secs=1.0, retries_per_rank=0)
    srv, ep = server.serve_coordinator(c)
    try:
        cl = client.CoordinatorClient(ep, tag="trainer0", kind="trainer")
        assert cl.register({"step": 0}) == {
            "epoch": 0, "lease_secs": 1.0, "evicted": False}
        assert cl.renew({"step": 3}) == {"epoch": 0, "evicted": False}
        assert cl.membership()["members"]["trainer0"]["payload"] == {
            "step": 3}
        # the launcher's verdict evicts; the member learns it
        c.report_failure("trainer0", "nonzero exit (code 9)")
        assert cl.renew({"step": 4})["evicted"] is True
        # the sharded checkpoints' barrier rides the same port
        assert cl.call("ckpt_shard_commit", step=2, rank=0, world_size=1,
                       info={"manifest_sha256": "x"}) == {"complete": True}
        cl.close()
    finally:
        server.stop_coordinator(srv)


def test_rpc_barrier_rotates_off_standby_to_primary():
    from paddle_tpu_torch.fluid.checkpoint import _RPCBarrier

    standby = jcoord.Coordinator(lease_secs=1.0, role="standby")
    primary = jcoord.Coordinator(lease_secs=1.0)
    s1, ep1 = jcoord.serve_coordinator(standby)
    s2, ep2 = jcoord.serve_coordinator(primary)
    try:
        barrier = _RPCBarrier(f"{ep1},{ep2}")
        barrier.shard_commit(3, 0, 2, {"manifest_sha256": "aa"})
        barrier.shard_commit(3, 1, 2, {"manifest_sha256": "bb"})
        assert primary.ckpt_barrier.status(3)["complete"]
        assert not standby.ckpt_barrier.status(3)["shards"]
        shards = barrier.wait_full(3, 2, timeout=2.0)
        assert shards and shards[1]["manifest_sha256"] == "bb"
    finally:
        jcoord.stop_coordinator(s1)
        jcoord.stop_coordinator(s2)


def test_client_grace_mode_buffers_and_reregisters(tmp_path):
    d = str(tmp_path / "state")
    c1 = tcoord.Coordinator(lease_secs=1.0, retries_per_rank=1,
                            startup_grace=5.0, state_dir=d,
                            snapshot_secs=3600.0)
    srv1, ep = tcoord.serve_coordinator(c1)
    port = int(ep.rsplit(":", 1)[1])
    client = tcoord.CoordinatorClient(ep, tag="trainer0", kind="trainer",
                                      deadline=0.5)
    assert client.register({"step": 1})["evicted"] is False
    assert client.last_incarnation == 1
    tcoord.stop_coordinator(srv1)
    with pytest.raises(ConnectionError):
        client.renew({"step": 2})
    assert client.grace and client._buffered_payload == {"step": 2}
    # the respawn: the JAX package's coordinator recovers the port's
    # state directory on the same port
    c2 = jcoord.Coordinator(lease_secs=1.0, retries_per_rank=1,
                            startup_grace=5.0, state_dir=d,
                            snapshot_secs=3600.0)
    assert c2.incarnation == 2
    srv2, _ = jcoord.serve_coordinator(c2, port=port)
    try:
        assert client.renew({"step": 4})["evicted"] is False
        assert not client.grace and client.last_incarnation == 2
        assert c2.membership()["members"]["trainer0"]["payload"] == {
            "step": 4}
        client.close()
    finally:
        jcoord.stop_coordinator(srv2)


def test_client_fails_over_and_caps_its_deadline(monkeypatch):
    monkeypatch.setenv(tcoord.ENV_CALL_DEADLINE, "0.7")
    assert tcoord.CoordinatorClient("127.0.0.1:1", tag="t0").deadline == 0.7
    monkeypatch.delenv(tcoord.ENV_CALL_DEADLINE)
    c = tcoord.Coordinator(lease_secs=1.0, startup_grace=5.0)
    c.incarnation = 5
    srv, ep = tcoord.serve_coordinator(c)
    try:
        client = tcoord.CoordinatorClient(f"127.0.0.1:1,{ep}",
                                          tag="trainer0", deadline=0.5)
        assert client.register()["evicted"] is False
        assert client.last_incarnation == 5
        client.close()
    finally:
        tcoord.stop_coordinator(srv)


@pytest.mark.parametrize("verb", ["lease_stats", "renew_gaps"])
def test_a_verb_the_reference_lacks_is_refused_alike(verb):
    def scenario(mod):
        c = mod.Coordinator(lease_secs=2.0)
        c.register("trainer0", now=1000.0)
        with pytest.raises(ValueError) as e:
            c.handle(verb, {})
        return str(e.value)

    assert verb in _both(scenario)


@pytest.mark.parametrize("verb", ["numerics_status", "fleet_status",
                                  "fleet_metrics"])
def test_unported_verbs_raise_naming_a8(verb):
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tcoord.Coordinator(lease_secs=1.0).handle(verb, {})


# ---------------------------------------------------------------------------
# the lease_expire and netsplit rules (tests/test_elastic.py:292-342)
# ---------------------------------------------------------------------------


@pytest.fixture
def armed(monkeypatch):
    """Both packages' injection flag on for one test, the injectors reset
    before and after."""
    before = (jflags.flag("FLAGS_ps_fault_injection"),
              tflags.flag("FLAGS_ps_fault_injection"))

    def arm(spec, tag):
        monkeypatch.setenv("PADDLE_PS_FAULT_SPEC", spec)
        monkeypatch.setenv("PADDLE_TRAINER_TAG", tag)
        monkeypatch.delenv("PADDLE_PS_FAULT_TAGS", raising=False)
        jflags.set_flags({"FLAGS_ps_fault_injection": True})
        tflags.set_flags({"FLAGS_ps_fault_injection": True})
        jfaults.reset()
        tfaults.reset()
        return jfaults.injector(), tfaults.injector()

    yield arm
    jflags.set_flags({"FLAGS_ps_fault_injection": before[0]})
    tflags.set_flags({"FLAGS_ps_fault_injection": before[1]})
    jfaults.reset()
    tfaults.reset()


@pytest.mark.parametrize("spec", ["lease_expire:trainer1:3",
                                  "lease_expire:*:1",
                                  "netsplit:trainer1:2:250",
                                  "netsplit:*:1:50;crash:coord_verb:4",
                                  "io_err:ckpt_global_manifest:1",
                                  "crash:ckpt_before_global_commit:2"])
def test_tag_rules_parse_like_reference(spec):
    fields = ("action", "method", "nth", "arg")
    assert ([tuple(getattr(r, f) for f in fields)
             for r in tfaults.parse_spec(spec)]
            == [tuple(getattr(r, f) for f in fields)
                for r in jfaults.parse_spec(spec)])


def test_netsplit_needs_a_window_like_reference():
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match="window"):
            mod.parse_spec("netsplit:*:1")


@pytest.mark.parametrize("tag", ["trainer1", "trainer2"])
def test_lease_expire_fires_alike(armed, tag):
    seqs = [[inj.on_lease_renew() for _ in range(6)]
            for inj in armed("lease_expire:trainer1:3", tag)]
    assert seqs[1] == seqs[0]
    assert seqs[1] == ([False, False, True, True, True, True]
                       if tag == "trainer1" else [False] * 6)


def test_netsplit_fires_alike(armed, monkeypatch):
    clock = [1000.0]
    out = []
    for mod, inj in zip((jfaults, tfaults),
                        armed("netsplit:trainer1:2:250", "trainer1")):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        seq = []
        for t in (1000.0, 1000.1, 1000.2, 1000.3, 1000.4):
            clock[0] = t
            try:
                inj.before_send("renew")
                seq.append("sent")
            except mod.FaultError:
                seq.append("dropped")
        out.append(seq)
    # the second send opens a 250 ms window: dropped until 1000.35
    assert out[1] == out[0] == ["sent", "dropped", "dropped", "dropped",
                                "sent"]


def test_lease_expire_swallows_renewals_end_to_end(armed):
    armed("lease_expire:trainer0:2", "trainer0")
    c = tcoord.Coordinator(lease_secs=1.0)
    srv, ep = tcoord.serve_coordinator(c)
    try:
        cl = tcoord.CoordinatorClient(ep, tag="trainer0")
        cl.register()
        assert cl.renew({"step": 1}) == {"epoch": 0, "evicted": False}
        assert cl.renew({"step": 2}) == {"suppressed": True}
        assert c.membership()["members"]["trainer0"]["payload"] == {
            "step": 1}
        cl.close()
    finally:
        tcoord.stop_coordinator(srv)
