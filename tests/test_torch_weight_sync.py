"""Live weight sync in the port (``paddle_tpu_torch/inference/
weight_sync.py``) against the JAX package's, on the CPU: in-process PS
servers on 127.0.0.1, no subprocess.

The four fast cases of the JAX package's ``tests/test_serving.py``
(:436-600), with the same inputs: the subscriber in plain mode (a
``state_dict`` digest) and replicated mode (``fetch_replica_state``:
the full state, then the tail), a subscriber started before its table
exists, the epoch fence under a mid-stream push, and the flag off.
Then the two packages against each other: the JAX package's publisher
writing to a JAX ``PSServer`` that the port's subscriber follows, and
the port's publisher writing to the port's server that the JAX
subscriber follows, plain and replicated (R 2), each bit for bit; and
``_server_states`` / ``table_kwargs`` equal to the JAX functions' on the
same packed rows.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed import ps_server as jps
from paddle_tpu.inference import weight_sync as jws
from paddle_tpu_torch import inference
from paddle_tpu_torch.distributed import ps_server as tps
from paddle_tpu_torch.inference import weight_sync as ws
from paddle_tpu_torch.inference.client import InferenceClient
from paddle_tpu_torch.inference.server import InferenceServer
from paddle_tpu_torch.telemetry import get_registry

_REG = get_registry()


def _start_tcp(handler_obj, mod=tps):
    srv = mod._TCPServer(("127.0.0.1", 0), mod._Handler)
    srv.ps = handler_obj
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def _stop_tcp(srv):
    srv.shutdown()
    srv.close_all_connections()
    srv.server_close()


@pytest.fixture(scope="module")
def saved_dir(tmp_path_factory):
    """A tiny fc model saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("wsync") / "model")
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", [8], dtype="float32")
        h = jfluid.layers.fc(x, 16, act="relu")
        pred = jfluid.layers.fc(h, 4)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.executor.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe,
                                       main_program=main)
    return d


@pytest.fixture(scope="module")
def tiny_frozen(saved_dir):
    return inference.load_frozen(saved_dir, device="cpu")


# ---------------------------------------------------------------------------
# the JAX package's cases (tests/test_serving.py:436-600)
# ---------------------------------------------------------------------------


def test_weight_subscriber_plain_and_replicated():
    plan = ws.pack_plan({"w": (6, 3)}, dim=8)
    vals = {"w": np.arange(18, dtype=np.float32).reshape(6, 3)}
    vals2 = {"w": vals["w"] * -1.5}
    pushes0 = _REG.counter("serve_weight_pushes_total").value
    adopt0 = _REG.counter("serve_weight_adoptions_total").value

    # plain single pserver: state_dict digest polling
    srv, ep = _start_tcp(tps.PSServer())
    tbl = tps.RemoteTable("w_plain", ws.table_shape(plan), [ep],
                          **ws.table_kwargs(plan))
    pub = ws.WeightPublisher(tbl, plan)
    pub.publish(vals)
    got = {}
    sub = ws.WeightSubscriber([ep], "w_plain", plan,
                              lambda w, v: got.update(w))
    assert sub.poll_once() is True
    assert sub.poll_once() is False    # unchanged -> no adoption
    np.testing.assert_array_equal(got["w"], vals["w"])
    pub.publish(vals2)
    assert sub.poll_once() is True
    np.testing.assert_array_equal(got["w"], vals2["w"])
    sub.stop()
    tbl.close()
    _stop_tcp(srv)

    # replicated R=2: fetch_replica_state full-then-tail, like a
    # rejoining backup
    srv_a, ep_a = _start_tcp(tps.PSServer())
    srv_b, ep_b = _start_tcp(tps.PSServer())
    tbl2 = tps.RemoteTable("w_repl", ws.table_shape(plan), [ep_a, ep_b],
                           replication=2, **ws.table_kwargs(plan))
    pub2 = ws.WeightPublisher(tbl2, plan)
    pub2.publish(vals)
    got2 = {}
    sub2 = ws.WeightSubscriber([ep_a, ep_b], "w_repl", plan,
                               lambda w, v: got2.update(w))
    assert sub2.poll_once() is True
    assert sub2._replicated is True
    np.testing.assert_array_equal(got2["w"], vals["w"])
    assert sub2.poll_once() is False
    pub2.publish(vals2)
    assert sub2.poll_once() is True    # the incremental TAIL path
    np.testing.assert_array_equal(got2["w"], vals2["w"])
    sub2.stop()
    tbl2.close()
    _stop_tcp(srv_a)
    _stop_tcp(srv_b)
    assert _REG.counter("serve_weight_pushes_total").value - pushes0 == 4
    assert _REG.counter("serve_weight_adoptions_total").value - adopt0 == 4


def test_weight_subscriber_before_table_exists():
    """A subscriber started before the publisher created the table must
    not latch a mode: polls are no-ops until the table appears, then
    the right key shape is adopted."""
    plan = ws.pack_plan({"w": (4, 2)}, dim=4)
    vals = {"w": np.arange(8, dtype=np.float32).reshape(4, 2)}
    srv, ep = _start_tcp(tps.PSServer())
    got = {}
    sub = ws.WeightSubscriber([ep], "late_w", plan,
                              lambda w, v: got.update(w))
    try:
        assert sub.poll_once() is False   # table absent: no mode latch
        assert sub._replicated is None
        tbl = tps.RemoteTable("late_w", ws.table_shape(plan), [ep],
                              **ws.table_kwargs(plan))
        ws.WeightPublisher(tbl, plan).publish(vals)
        assert sub.poll_once() is True
        np.testing.assert_array_equal(got["w"], vals["w"])
        tbl.close()
    finally:
        sub.stop()
        _stop_tcp(srv)


def test_epoch_fence_mid_stream_weight_push(tiny_frozen, monkeypatch):
    """Outputs for a fixed input are bit-identical within a weight
    epoch, change only at a fence boundary, and the epoch is echoed in
    every reply; the subscriber is armed from the environment."""
    ps_srv, ps_ep = _start_tcp(tps.PSServer())
    plan = ws.plan_for_frozen(tiny_frozen)
    tbl = tps.RemoteTable("fence_w", ws.table_shape(plan), [ps_ep],
                          **ws.table_kwargs(plan))
    pub = ws.WeightPublisher(tbl, plan)
    pub.publish(tiny_frozen.scope)
    monkeypatch.setenv(ws.ENV_SYNC, "1")
    monkeypatch.setenv(ws.ENV_TABLE, "fence_w")
    monkeypatch.setenv(ws.ENV_ENDPOINTS, ps_ep)
    monkeypatch.setenv(ws.ENV_POLL, "0.1")
    inf = InferenceServer(tiny_frozen, max_batch=2, device="cpu")
    assert inf.subscriber is not None
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        xa = np.random.RandomState(5).rand(1, 8).astype(np.float32)
        # wait out the initial adoption (epoch 0 -> 1)
        deadline = time.time() + 10
        while time.time() < deadline:
            r0 = cli.infer({"x": xa}, deadline_ms=30000)
            if r0.weight_epoch == 1:
                break
            time.sleep(0.05)
        assert r0.weight_epoch == 1
        r0b = cli.infer({"x": xa}, deadline_ms=30000)
        assert r0b.weight_epoch == 1
        np.testing.assert_array_equal(r0.outputs[0], r0b.outputs[0])

        # mid-stream push: the fence moves exactly once, outputs change
        # only across it
        new_vals = {n: tiny_frozen.scope.find_var(n).numpy() * 2.0
                    for n in plan.names()}
        pub.publish(new_vals)
        deadline = time.time() + 10
        while time.time() < deadline:
            r1 = cli.infer({"x": xa}, deadline_ms=30000)
            if r1.weight_epoch != 1:
                break
            np.testing.assert_array_equal(  # pre-fence: bit-identical
                r1.outputs[0], r0.outputs[0])
            time.sleep(0.05)
        assert r1.weight_epoch == 2
        assert not np.array_equal(r1.outputs[0], r0.outputs[0])
        r1b = cli.infer({"x": xa}, deadline_ms=30000)
        assert r1b.weight_epoch == 2
        np.testing.assert_array_equal(r1.outputs[0], r1b.outputs[0])
        assert inf.stats()["weight_sync"] == {"enabled": True,
                                              "version": 2}
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
        tbl.close()
        _stop_tcp(ps_srv)


def test_weight_sync_flag_off_identity(tiny_frozen, monkeypatch):
    """PADDLE_SERVE_WEIGHT_SYNC=0: no subscriber, epoch stays 0, and a
    table push changes NOTHING — serving is byte-identical to a static
    frozen model."""
    ps_srv, ps_ep = _start_tcp(tps.PSServer())
    plan = ws.plan_for_frozen(tiny_frozen)
    tbl = tps.RemoteTable("off_w", ws.table_shape(plan), [ps_ep],
                          **ws.table_kwargs(plan))
    pub = ws.WeightPublisher(tbl, plan)
    monkeypatch.setenv(ws.ENV_SYNC, "0")
    monkeypatch.setenv(ws.ENV_TABLE, "off_w")
    monkeypatch.setenv(ws.ENV_ENDPOINTS, ps_ep)
    inf = InferenceServer(tiny_frozen, max_batch=2, device="cpu")
    assert inf.subscriber is None
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        xa = np.random.RandomState(6).rand(1, 8).astype(np.float32)
        # the static oracle through the SAME padded batch shape the
        # server runs (bit-identity is shape-for-shape)
        pad = np.concatenate([xa, np.zeros_like(xa)], axis=0)
        static = [np.asarray(o)[:1] for o in inference.ServingPredictor(
            tiny_frozen, device="cpu").run({"x": pad})]
        r0 = cli.infer({"x": xa}, deadline_ms=30000)
        pub.publish({n: tiny_frozen.scope.find_var(n).numpy() * 3.0
                     for n in plan.names()})
        time.sleep(0.3)
        r1 = cli.infer({"x": xa}, deadline_ms=30000)
        assert r0.weight_epoch == r1.weight_epoch == 0
        np.testing.assert_array_equal(r0.outputs[0], r1.outputs[0])
        np.testing.assert_array_equal(r0.outputs[0],
                                      np.asarray(static[0]))
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
        tbl.close()
        _stop_tcp(ps_srv)


@pytest.mark.parametrize("published", [True, False],
                         ids=["published", "table_absent"])
def test_serve_binds_after_the_first_weight_round(tiny_frozen, monkeypatch,
                                                   published):
    """serve() with live weights binds its port only once the
    subscriber's first round is in and installed: its first reply is at
    the table's weights (epoch 1), never the export's, however slow that
    round is.  A table that does not exist yet does not hold the bind:
    the replica serves the export's weights (epoch 0) until it appears.
    (The JAX package binds first: ROADMAP section C.)"""
    from paddle_tpu_torch.inference import server as srvmod

    ps_srv, ps_ep = _start_tcp(tps.PSServer())
    plan = ws.plan_for_frozen(tiny_frozen)
    live = {n: tiny_frozen.scope.find_var(n).numpy() * 2.0
            for n in plan.names()}
    tbl = tps.RemoteTable("bind_w", ws.table_shape(plan), [ps_ep],
                          **ws.table_kwargs(plan))
    if published:
        ws.WeightPublisher(tbl, plan).publish(live)
    monkeypatch.setenv(ws.ENV_SYNC, "1")
    monkeypatch.setenv(ws.ENV_TABLE, "bind_w" if published else "none_w")
    monkeypatch.setenv(ws.ENV_ENDPOINTS, ps_ep)
    monkeypatch.setenv(ws.ENV_POLL, "0.1")
    slow = ws.WeightSubscriber.poll_once

    def slow_poll(self):
        time.sleep(0.5)   # a first round slower than the bind
        return slow(self)

    monkeypatch.setattr(ws.WeightSubscriber, "poll_once", slow_poll)
    xa = np.random.RandomState(7).rand(1, 8).astype(np.float32)
    pad = {"x": np.concatenate([xa, np.zeros_like(xa)])}
    oracle = inference.ServingPredictor(tiny_frozen, device="cpu")
    if published:
        oracle.adopt_weights(ws.unpack(plan, ws.pack(plan, live)))
    want = np.asarray(oracle.run(pad)[0])[:1]
    seen = {}

    def ready(addr):
        seen["epoch_at_bind"] = srvmod._ACTIVE.batcher.weight_epoch

    def fake_serve_forever(self, poll_interval=0.1):
        seen["reply"] = self.ps.infer({"x": xa}, 30000.0)

    monkeypatch.setattr(tps._TCPServer, "serve_forever", fake_serve_forever)
    try:
        srvmod.serve(tiny_frozen, port=0, host="127.0.0.1", ready_cb=ready,
                     max_batch=2, device="cpu")
    finally:
        tbl.close()
        _stop_tcp(ps_srv)
    epoch = 1 if published else 0
    assert seen["epoch_at_bind"] == epoch
    assert seen["reply"]["weight_epoch"] == epoch
    np.testing.assert_array_equal(seen["reply"]["outputs"][0], want)


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------


_PKGS = {"jax": (jws, jps), "torch": (ws, tps)}


@pytest.mark.parametrize("replication", [1, 2], ids=["plain", "r2"])
@pytest.mark.parametrize("pub_pkg,sub_pkg", [("jax", "torch"),
                                             ("torch", "jax")],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_weight_tables_interoperate_bit_for_bit(pub_pkg, sub_pkg,
                                                replication):
    """One package publishes into its own servers, the other subscribes:
    every adopted value equal bit for bit, in the tail mode too."""
    pws, pps = _PKGS[pub_pkg]
    sws, _ = _PKGS[sub_pkg]
    shapes = {"w": (37, 5), "b": (11,), "s": ()}
    rng = np.random.RandomState(21)
    v1 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    v2 = {n: (v * np.float32(-0.7) + np.float32(1e-3)).astype(np.float32)
          for n, v in v1.items()}
    pplan, splan = pws.pack_plan(shapes, dim=8), sws.pack_plan(shapes, dim=8)
    assert pplan.entries == splan.entries
    srvs = [_start_tcp(pps.PSServer(), mod=pps) for _ in range(replication)]
    eps = [ep for _, ep in srvs]
    kw = dict(pws.table_kwargs(pplan))
    if replication > 1:
        kw["replication"] = replication
    tbl = pps.RemoteTable(f"x_{pub_pkg}", pws.table_shape(pplan), eps, **kw)
    got = []
    sub = sws.WeightSubscriber(eps, f"x_{pub_pkg}", splan,
                               lambda w, v: got.append((v, w)))
    try:
        pub = pws.WeightPublisher(tbl, pplan)
        pub.publish(v1)
        assert sub.poll_once() is True
        assert sub._replicated is (replication > 1)
        assert sub.poll_once() is False
        pub.publish(v2)
        assert sub.poll_once() is True
        assert [v for v, _ in got] == [1, 2]
        for (_, w), want in zip(got, (v1, v2)):
            assert sorted(w) == sorted(want)
            for n in want:
                assert w[n].dtype == np.float32 and w[n].shape == \
                    want[n].shape
                np.testing.assert_array_equal(w[n].view(np.int32),
                                              want[n].view(np.int32))
    finally:
        sub.stop()
        tbl.close()
        for srv, _ in srvs:
            _stop_tcp(srv)


@pytest.mark.parametrize("n,k", [(1, 1), (2, 4), (3, 8)])
def test_server_states_and_table_kwargs_match_jax(n, k):
    plan = ws.pack_plan({"a": (13, 7), "b": (5,)}, dim=4)
    assert ws.table_kwargs(plan) == jws.table_kwargs(
        jws.pack_plan({"a": (13, 7), "b": (5,)}, dim=4))
    assert ws.DEFAULT_NUM_SHARDS == jws.DEFAULT_NUM_SHARDS
    packed = np.random.RandomState(n * 10 + k).standard_normal(
        (plan.total_rows, plan.dim)).astype(np.float32)
    got = ws._server_states(packed, n, k)
    want = jws._server_states(packed, n, k)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["optimizer"], g["learning_rate"], g["accum"]) == \
            (w["optimizer"], w["learning_rate"], w["accum"])
        assert len(g["shards"]) == len(w["shards"]) == k
        for a, b in zip(g["shards"], w["shards"]):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
