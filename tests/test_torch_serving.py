"""The serving replica, ported in ``paddle_tpu_torch/inference/server.py``
with its client (``client.py``) and transport
(``distributed/ps_server.py``), on the CPU: in-process TCP servers on
127.0.0.1, no subprocess.

Mirrors the fast cases of the JAX package's ``tests/test_serving.py``
and the server cases of ``test_gen_resume.py``: the micro-batcher's
admission, shedding, deadlines, drain and weight fence with a fake
predictor; a round trip with ``stats``; typed errors over the wire;
failover from a dead replica; the epoch fence through
``stage_weights``; exactly-once ``generate`` with a request id and a
marked retry.  Then the two packages against each other: the JAX client
against the port's replica and the port's client against the JAX
replica, a model the JAX package saved served by the port within 1e-4
of the JAX predictor, a raw-framing request as ``clients/go/README.md``
gives it, and replies that hold numpy and plain values only.  Last, the
refusals of what is not ported (debugz, the `oom` fault rule).  Live
weight sync is held in ``test_torch_weight_sync.py``, the replica under
the launcher (heartbeat, lease) in ``test_torch_serve_launch.py`` and
the push exporters in ``test_torch_export.py``.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.distributed import ps_server as jps
from paddle_tpu.inference import client as jclient
from paddle_tpu.inference import server as jserver
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.distributed.ps_server import _Conn, _Handler, _TCPServer
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference import server as srv_mod
from paddle_tpu_torch.inference import weight_sync as ws
from paddle_tpu_torch.inference.client import (DeadlineExceededError,
                                               InferenceClient,
                                               OverloadedError)
from paddle_tpu_torch.inference.engine import GenerationEngine
from paddle_tpu_torch.inference.server import (DeadlineExceeded,
                                               InferenceServer, MicroBatcher,
                                               Overloaded)
from paddle_tpu_torch.telemetry import get_registry

_REG = get_registry()
TOL = 1e-4
PROMPT = [3, 9, 1, 4, 1, 5, 9]


def _counter(name, **labels):
    return _REG.counter(name, **labels).value


def _start_tcp(handler_obj, tcp=_TCPServer, handler=_Handler):
    srv = tcp(("127.0.0.1", 0), handler)
    srv.ps = handler_obj
    threading.Thread(target=srv.serve_forever,
                     kwargs={"poll_interval": 0.05}, daemon=True).start()
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def _stop_tcp(srv):
    srv.shutdown()
    srv.close_all_connections()
    srv.server_close()


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4)
    return main, startup, pred


@pytest.fixture(scope="module")
def saved_dir(tmp_path_factory):
    """A tiny fc model saved by the JAX package."""
    d = str(tmp_path_factory.mktemp("served") / "model")
    main, startup, pred = _mlp(jfluid)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.executor.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe,
                                       main_program=main)
    return d


@pytest.fixture(scope="module")
def tiny_frozen(saved_dir):
    return inference.load_frozen(saved_dir, device="cpu")


@pytest.fixture(autouse=True)
def _no_weight_sync(monkeypatch):
    monkeypatch.setenv(ws.ENV_SYNC, "0")


class FakePredictor:
    """Deterministic-latency predictor duck type for scheduler units."""

    def __init__(self, latency_s=0.0):
        self.feed_names = ["x"]
        self.fetch_names = ["out"]
        self.latency_s = latency_s
        self.adopted = []
        self.weight_epoch = 0

    def run(self, feed):
        if self.latency_s:
            time.sleep(self.latency_s)
        return [np.asarray(feed["x"]) * 2.0]

    def adopt_weights(self, weights, epoch=None):
        self.adopted.append(dict(weights))
        self.weight_epoch += 1
        return self.weight_epoch


def _x(rows, v=1.0):
    return {"x": np.full((rows, 4), v, np.float32)}


# ---------------------------------------------------------------------------
# micro-batching scheduler
# ---------------------------------------------------------------------------


def test_batcher_coalesces_and_slices():
    mb = MicroBatcher(FakePredictor(latency_s=0.05), max_batch=4,
                      queue_depth=16, batch_wait_ms=150)
    b0 = _counter("serve_batches_total")
    pendings = [mb.submit(_x(1, v=float(i))) for i in range(3)]
    for p in pendings:
        assert p.event.wait(5.0)
        assert p.error is None
    for i, p in enumerate(pendings):
        np.testing.assert_array_equal(p.outputs[0],
                                      np.full((1, 4), 2.0 * i))
    assert _counter("serve_batches_total") == b0 + 1
    mb.stop()


def test_batcher_queue_full_sheds():
    mb = MicroBatcher(FakePredictor(latency_s=0.3), max_batch=1,
                      queue_depth=2, batch_wait_ms=0)
    shed0 = _counter("serve_requests_total", outcome="shed")
    overloaded = 0
    pendings = []
    for _ in range(6):
        try:
            pendings.append(mb.submit(_x(1)))
        except Overloaded:
            overloaded += 1
    assert overloaded >= 2
    assert _counter("serve_requests_total",
                    outcome="shed") == shed0 + overloaded
    for p in pendings:
        assert p.event.wait(10.0)
    mb.stop()


def test_batcher_projected_wait_sheds_on_deadline():
    mb = MicroBatcher(FakePredictor(latency_s=0.0), max_batch=2,
                      queue_depth=64, batch_wait_ms=0)
    mb._batch_ewma_s = 0.2
    with pytest.raises(Overloaded, match="projected queue wait"):
        mb.submit(_x(1), deadline_ms=50)
    p = mb.submit(_x(1), deadline_ms=5000)
    assert p.event.wait(5.0) and p.error is None
    mb.stop()


def test_batcher_deadline_exceeded_in_queue():
    mb = MicroBatcher(FakePredictor(latency_s=0.4), max_batch=1,
                      queue_depth=8, batch_wait_ms=0)
    d0 = _counter("serve_requests_total", outcome="deadline_exceeded")
    a = mb.submit(_x(1))
    b = mb.submit(_x(1), deadline_ms=60)
    assert b.event.wait(5.0)
    assert isinstance(b.error, DeadlineExceeded)
    assert a.event.wait(5.0) and a.error is None
    assert _counter("serve_requests_total",
                    outcome="deadline_exceeded") == d0 + 1
    mb.stop()


def test_batcher_drain_finishes_inflight_then_refuses():
    mb = MicroBatcher(FakePredictor(latency_s=0.1), max_batch=1,
                      queue_depth=8, batch_wait_ms=0)
    pendings = [mb.submit(_x(1)) for _ in range(3)]
    assert mb.drain(timeout=10.0) is True
    for p in pendings:
        assert p.event.is_set() and p.error is None
    with pytest.raises(Overloaded, match="draining"):
        mb.submit(_x(1))
    mb.stop()


def test_batcher_weight_fence_between_batches():
    fp = FakePredictor(latency_s=0.0)
    mb = MicroBatcher(fp, max_batch=2, queue_depth=8, batch_wait_ms=0)
    p0 = mb.submit(_x(1))
    assert p0.event.wait(5.0)
    assert p0.weight_epoch == 0
    mb.stage_weights({"w": np.ones(3)}, version=1)
    deadline = time.monotonic() + 5
    while not fp.adopted and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fp.adopted
    p1 = mb.submit(_x(1))
    assert p1.event.wait(5.0)
    assert p1.weight_epoch == 1
    assert mb.weight_epoch == 1
    mb.stop()


def test_batcher_rejects_malformed_feeds_before_admission():
    mb = MicroBatcher(FakePredictor(), max_batch=2, batch_wait_ms=0)
    with pytest.raises(ValueError, match="feed mismatch"):
        mb.submit({"y": np.zeros((1, 4), np.float32)})
    with pytest.raises(ValueError, match="1..2 rows"):
        mb.submit(_x(3))
    assert mb.queue_depth() == 0
    mb.stop()


# ---------------------------------------------------------------------------
# the TCP serving plane
# ---------------------------------------------------------------------------


def test_server_roundtrip_and_stats(tiny_frozen):
    inf = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    assert inf.subscriber is None
    assert inf.predictor.device == torch.device("cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        xa = np.random.RandomState(1).rand(2, 8).astype(np.float32)
        res = cli.infer({"x": xa}, deadline_ms=30000)
        assert res.weight_epoch == 0
        assert res.fetch_names == tiny_frozen.fetch_names
        pad = np.concatenate([xa, np.zeros((2, 8), np.float32)])
        direct = inference.ServingPredictor(tiny_frozen,
                                            device="cpu").run({"x": pad})
        np.testing.assert_allclose(res.outputs[0], direct[0][:2],
                                   rtol=1e-6, atol=1e-6)

        def one(i):
            return cli.infer({"x": xa[i % 2:i % 2 + 1]},
                             deadline_ms=30000).outputs[0]

        with ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(one, range(6)))
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o, direct[0][i % 2:i % 2 + 1],
                                       rtol=1e-6, atol=1e-6)
        h = cli.health()
        assert h["ok"] and not h["draining"]
        st = cli.stats()
        s = st["serving"]
        assert s["served_total"] >= 7
        assert s["p99_ms"] >= s["p50_ms"] >= 0
        assert st["model"]["num_params"] == 4
        assert st["weight_sync"]["enabled"] is False
        assert _counter("ps_server_rpc_total", verb="infer") >= 7
        assert srv_mod.current_status()["served_total"] >= 7
        assert srv_mod.current_servez() is None   # no engine attached
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
    assert srv_mod.current_status() is None


def test_stats_reports_the_kernel_launch_counts(tiny_frozen, monkeypatch):
    """A replica's ``stats`` carries every kernel wrapper's launch count
    in its process (``ops.kernels.launch_counts``), so that a caller in
    another process reads which kernels its requests launched."""
    from paddle_tpu_torch.ops.kernels import (add_ln, flash_attention,
                                              launch_counts,
                                              paged_attention)

    monkeypatch.setattr(paged_attention.paged_attention, "launches", 3)
    monkeypatch.setattr(add_ln.fused_add_ln, "launches", 25)
    monkeypatch.setattr(flash_attention.flash_attention_bsh,
                        "launches_tc", 7)
    inf = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        got = cli.stats()["kernel_launches"]
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
    assert got == launch_counts()
    assert (got["paged_attention"], got["add_ln"],
            got["flash_attention_bsh_tc"]) == (3, 25, 7)
    assert len([k for k in got if not k.endswith("_tc")]) == 14


def test_client_failover_kill_one_of_two_inprocess(tiny_frozen):
    inf_a = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    inf_b = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    srv_a, ep_a = _start_tcp(inf_a)
    srv_b, ep_b = _start_tcp(inf_b)
    f0 = _counter("serve_client_failovers_total")
    try:
        cli = InferenceClient([ep_a, ep_b], deadline_secs=5.0,
                              hedge_quantile=0)
        xa = np.random.RandomState(2).rand(1, 8).astype(np.float32)
        want = cli.infer({"x": xa}, deadline_ms=30000).outputs[0]
        _stop_tcp(srv_a)
        inf_a.close()
        for _ in range(3):
            got = cli.infer({"x": xa}, deadline_ms=30000)
            np.testing.assert_array_equal(got.outputs[0], want)
            assert got.replica == ep_b
        assert _counter("serve_client_failovers_total") == f0 + 1
        cli.close()
    finally:
        _stop_tcp(srv_b)
        inf_b.close()


def test_client_typed_errors_over_wire(tiny_frozen):
    inf = InferenceServer(tiny_frozen, max_batch=2, queue_depth=2,
                          device="cpu")
    inf.batcher.predictor = FakePredictor(latency_s=0.3)
    inf.batcher._batch_ewma_s = 0.3
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep], deadline_secs=5.0)
        with pytest.raises(OverloadedError, match="projected queue wait"):
            cli.infer(_x(1), deadline_ms=20)
        assert cli.infer(_x(1), deadline_ms=5000).outputs
        with pytest.raises(RuntimeError, match="feed mismatch"):
            cli.infer({"z": np.zeros((1, 4), np.float32)})
        with pytest.raises(RuntimeError, match="unknown serving verb"):
            cli._call("no_such_verb")
        inf.begin_drain()
        with pytest.raises(OverloadedError, match="draining"):
            cli.infer(_x(1))
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
    assert issubclass(DeadlineExceededError, RuntimeError)


def test_epoch_fence_through_stage_weights(tiny_frozen):
    """Outputs for a fixed input are bit-identical within a weight
    epoch, change only at the fence, and every reply echoes its epoch."""
    inf = InferenceServer(tiny_frozen, max_batch=2, device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        xa = np.random.RandomState(5).rand(1, 8).astype(np.float32)
        r0 = cli.infer({"x": xa}, deadline_ms=30000)
        assert r0.weight_epoch == 0
        doubled = {n: tiny_frozen.scope.find_var(n).numpy() * 2.0
                   for n in tiny_frozen.param_names}
        inf.batcher.stage_weights(doubled, version=7)
        deadline = time.time() + 10
        while inf.batcher.weight_epoch == 0 and time.time() < deadline:
            time.sleep(0.01)
        r1 = cli.infer({"x": xa}, deadline_ms=30000)
        assert r1.weight_epoch == 1
        assert not np.array_equal(r1.outputs[0], r0.outputs[0])
        r1b = cli.infer({"x": xa}, deadline_ms=30000)
        assert r1b.weight_epoch == 1
        np.testing.assert_array_equal(r1.outputs[0], r1b.outputs[0])
        # the frozen model's own weights are untouched: adoption
        # replaces scope entries, never writes into a shared tensor
        again = inference.ServingPredictor(
            tiny_frozen, device="cpu").run({"x": np.concatenate(
                [xa, np.zeros_like(xa)])})
        np.testing.assert_allclose(again[0][:1], r0.outputs[0], atol=1e-6)
        # a bad delivery is rejected and serving stays on epoch 1
        errs0 = _counter("serve_weight_adopt_errors_total")
        inf.batcher.stage_weights({"no_such_param": np.ones(2)}, version=8)
        deadline = time.time() + 10
        while _counter("serve_weight_adopt_errors_total") == errs0 \
                and time.time() < deadline:
            time.sleep(0.01)
        assert _counter("serve_weight_adopt_errors_total") == errs0 + 1
        assert cli.infer({"x": xa}, deadline_ms=30000).weight_epoch == 1
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()


# ---------------------------------------------------------------------------
# generate: exactly-once with a request id
# ---------------------------------------------------------------------------


def _engine():
    model = dm.TinyDecoderLM(dm.DecoderConfig(), seed=0, device="cpu")
    return GenerationEngine(model, max_slots=2, page_size=4, n_pages=24)


@pytest.fixture
def inject(monkeypatch):
    before = flags.flag("FLAGS_ps_fault_injection")

    def arm(spec):
        monkeypatch.setenv(faults.ENV_SPEC, spec)
        flags.set_flags({"FLAGS_ps_fault_injection": True})
        faults.reset()

    yield arm
    flags.set_flags({"FLAGS_ps_fault_injection": before})
    faults.reset()


def test_server_dedup_replays_finished_reply(tiny_frozen):
    eng = _engine()
    inf = InferenceServer(tiny_frozen, weight_subscribe=False, engine=eng,
                          device="cpu")
    try:
        hits0 = _counter("serve_gen_dedup_hits_total")
        r1 = inf.generate(PROMPT, max_new_tokens=5, request_id="rid-1")
        out0 = eng.counters["tokens_out"]
        r2 = inf.generate(PROMPT, max_new_tokens=5, request_id="rid-1",
                          retry=True)
        assert r2["tokens"] == r1["tokens"]
        assert eng.counters["tokens_out"] == out0
        assert _counter("serve_gen_dedup_hits_total") == hits0 + 1
        # an unmarked repeat of the same id is a fresh request
        inf.generate(PROMPT, max_new_tokens=5, request_id="rid-1")
        assert eng.counters["tokens_out"] == out0 + 5
    finally:
        inf.close()


def test_server_dedup_reattaches_stream_and_retains_done_polls(tiny_frozen):
    inf = InferenceServer(tiny_frozen, weight_subscribe=False,
                          engine=_engine(), device="cpu")
    try:
        sid = inf.generate(PROMPT, max_new_tokens=4, stream=True,
                           request_id="rid-s")["stream_id"]
        assert inf.generate(PROMPT, max_new_tokens=4, stream=True,
                            request_id="rid-s",
                            retry=True)["stream_id"] == sid
        toks, cursor = [], 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            snap = inf.generate_poll(stream_id=sid, cursor=cursor)
            toks += snap["tokens"]
            cursor = snap["cursor"]
            if snap["done"]:
                break
            time.sleep(0.005)
        assert len(toks) == 4
        again = inf.generate_poll(stream_id=sid, cursor=0)
        assert again["done"] and again["tokens"] == toks
        assert srv_mod.current_servez() is not None
    finally:
        inf.close()


def test_tcp_marked_retry_runs_model_once(tiny_frozen, inject):
    """The transport drops the connection after the generate request is
    sent; the retry carries the marker, the server dedups on the request
    id, and the model runs once."""
    eng = _engine()
    inf = InferenceServer(tiny_frozen, weight_subscribe=False, engine=eng,
                          device="cpu")
    srv, ep = _start_tcp(inf)
    inject("drop:generate:1")
    try:
        hits0 = _counter("serve_gen_dedup_hits_total")
        retries0 = _counter("serve_retry_received_total", verb="generate")
        cli = InferenceClient([ep])
        res = cli.generate(PROMPT, max_new_tokens=5)
        assert len(res.tokens) == 5
        assert eng.counters["tokens_out"] == 5
        assert _counter("serve_gen_dedup_hits_total") == hits0 + 1
        assert _counter("serve_retry_received_total",
                        verb="generate") == retries0 + 1
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()


def test_generate_blocking_and_streaming_agree_with_the_engine(tiny_frozen):
    """Through the wire, a blocking and a streamed generation return the
    tokens a direct engine run gives."""
    direct = _engine()
    want = direct.result(direct.submit(PROMPT, max_new_tokens=6),
                         timeout=60)["tokens"]
    direct.stop()
    inf = InferenceServer(tiny_frozen, weight_subscribe=False,
                          engine=_engine(), device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        assert cli.generate(PROMPT, max_new_tokens=6).tokens == want
        timings = {}
        got = [t for chunk in cli.generate_stream(
            PROMPT, max_new_tokens=6, timings=timings) for t in chunk]
        assert got == want and timings["tokens"] == 6
        assert cli.stats()["generation"]["served_total"] == 2
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()


def test_generate_requires_an_engine(tiny_frozen):
    inf = InferenceServer(tiny_frozen, device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        with pytest.raises(RuntimeError, match="no decoder engine"):
            cli.generate(PROMPT, max_new_tokens=2)
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------


def _pad(xa, rows):
    return np.concatenate([xa, np.zeros((rows - len(xa),) + xa.shape[1:],
                                        xa.dtype)])


def test_jax_saved_model_served_by_the_port_matches_jax(saved_dir,
                                                        tiny_frozen):
    """The JAX package's export, loaded by the port's ``load_frozen`` and
    served over TCP by the port's replica, gives the JAX predictor's
    fetches."""
    xa = np.random.RandomState(3).rand(3, 8).astype(np.float32)
    jf = jinference.load_frozen(saved_dir)
    want = np.asarray(jinference.ServingPredictor(jf).run(
        {"x": _pad(xa, 4)})[0])[:3]
    inf = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = InferenceClient([ep])
        got = cli.infer({"x": xa}).outputs[0]
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_jax_client_against_the_port_replica(tiny_frozen):
    inf = InferenceServer(tiny_frozen, max_batch=4, device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        cli = jclient.InferenceClient([ep])
        xa = np.random.RandomState(4).rand(2, 8).astype(np.float32)
        res = cli.infer({"x": xa}, deadline_ms=30000)
        want = inference.ServingPredictor(tiny_frozen, device="cpu").run(
            {"x": _pad(xa, 4)})[0][:2]
        np.testing.assert_allclose(res.outputs[0], want, atol=1e-6)
        assert cli.health()["ok"]
        info = cli.model_info()
        assert info == tiny_frozen.model_info()
        assert cli.stats()["serving"]["served_total"] >= 1
        inf.batcher._batch_ewma_s = 5.0
        with pytest.raises(jclient.OverloadedError):
            cli.infer({"x": xa}, deadline_ms=10)
        cli.close()
    finally:
        _stop_tcp(srv)
        inf.close()


def test_port_client_against_the_jax_replica(saved_dir, tiny_frozen,
                                             monkeypatch):
    monkeypatch.setenv("PADDLE_SERVE_WEIGHT_SYNC", "0")
    jf = jinference.load_frozen(saved_dir)
    jinf = jserver.InferenceServer(jf, max_batch=4)
    srv, ep = _start_tcp(jinf, jps._TCPServer, jps._Handler)
    try:
        cli = InferenceClient([ep])
        xa = np.random.RandomState(6).rand(2, 8).astype(np.float32)
        got = cli.infer({"x": xa}, deadline_ms=30000).outputs[0]
        want = inference.ServingPredictor(tiny_frozen, device="cpu").run(
            {"x": _pad(xa, 4)})[0][:2]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert cli.health()["ok"]
        assert cli.model_info()["fetches"] == \
            tiny_frozen.model_info()["fetches"]
        assert cli.stats()["serving"]["served_total"] >= 1
        jinf.batcher._batch_ewma_s = 5.0
        with pytest.raises(OverloadedError):
            cli.infer({"x": xa}, deadline_ms=10)
        cli.close()
    finally:
        _stop_tcp(srv)
        jinf.close()


_LEN = struct.Struct(">Q")


def _raw_call(ep, verb, kwargs):
    """One request over one raw socket, the framing of
    clients/go/README.md: 8-byte big-endian length || pickle((verb,
    kwargs)); the reply is length || pickle((ok, result))."""
    host, port = ep.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30.0) as s:
        payload = pickle.dumps((verb, kwargs),
                               protocol=pickle.HIGHEST_PROTOCOL)
        s.sendall(_LEN.pack(len(payload)) + payload)
        hdr = b""
        while len(hdr) < _LEN.size:
            hdr += s.recv(_LEN.size - len(hdr))
        (n,) = _LEN.unpack(hdr)
        buf = b""
        while len(buf) < n:
            buf += s.recv(n - len(buf))
    return pickle.loads(buf)


def _plain(obj):
    """True when obj holds only numpy arrays/scalars and plain Python
    values (what the JAX, Go and R clients can read)."""
    if isinstance(obj, (str, bytes, bool, int, float, type(None),
                        np.ndarray, np.generic)):
        return True
    if isinstance(obj, (list, tuple)):
        return all(_plain(x) for x in obj)
    if isinstance(obj, dict):
        return all(_plain(k) and _plain(v) for k, v in obj.items())
    return False


def test_raw_framing_and_replies_hold_numpy_only(tiny_frozen):
    inf = InferenceServer(tiny_frozen, max_batch=4, engine=_engine(),
                          device="cpu")
    srv, ep = _start_tcp(inf)
    try:
        xa = np.random.RandomState(7).rand(1, 8).astype(np.float32)
        ok, res = _raw_call(ep, "infer", {"feed": {"x": xa},
                                          "deadline_ms": 5000.0})
        assert ok and set(res) == {"outputs", "fetch_names",
                                   "weight_epoch", "queue_ms"}
        assert all(type(o) is np.ndarray for o in res["outputs"])
        assert res["outputs"][0].shape == (1, 4)
        ok, err = _raw_call(ep, "infer", {"feed": {"x": xa},
                                          "deadline_ms": 0.001})
        assert ok is False and err.startswith(("Overloaded",
                                               "DeadlineExceeded"))
        replies = [res]
        for verb, kw in (("ping", {}), ("health", {}), ("model_info", {}),
                         ("generate", {"prompt": PROMPT,
                                       "max_new_tokens": 3}),
                         ("generate", {"prompt": PROMPT,
                                       "max_new_tokens": 3,
                                       "stream": True}),
                         ("stats", {})):
            ok, r = _raw_call(ep, verb, kw)
            assert ok, r
            replies.append(r)
        sid = replies[-2]["stream_id"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ok, snap = _raw_call(ep, "generate_poll", {"stream_id": sid})
            replies.append(snap)
            if snap["done"]:
                break
            time.sleep(0.01)
        assert snap["done"] and len(snap["tokens"]) == 3
        assert replies[1] == "pong"
        for r in replies:
            assert _plain(r), r
        ok, r = _raw_call(ep, "drain", {"timeout": 10.0})
        assert ok and r["drained"] is True
    finally:
        _stop_tcp(srv)
        inf.close()


def test_shutdown_verb_drains_and_stops_serve(tiny_frozen):
    """serve() off the main thread (no SIGTERM handler) stops through
    the shutdown verb: admission closes, the event loop returns."""
    ready = threading.Event()
    addr = {}

    def on_ready(a):
        addr["ep"] = f"127.0.0.1:{a[1]}"
        ready.set()

    th = threading.Thread(target=srv_mod.serve, args=(tiny_frozen,),
                          kwargs=dict(port=0, host="127.0.0.1",
                                      ready_cb=on_ready, max_batch=2,
                                      device="cpu"), daemon=True)
    th.start()
    assert ready.wait(30)
    conn = _Conn(addr["ep"], deadline=5.0)
    xa = np.zeros((1, 8), np.float32)
    assert conn.call("infer", feed={"x": xa})["outputs"][0].shape == (1, 4)
    assert conn.call("shutdown") == 0
    th.join(30)
    assert not th.is_alive()
    conn.close()


# ---------------------------------------------------------------------------
# refusals: what is not ported raises instead of being ignored
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {"PADDLE_DEBUGZ_PORT": "0"},
], ids=["debugz"])
def test_serve_refuses_unported_environment(tiny_frozen, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A8"):
        srv_mod.serve(tiny_frozen, port=0, host="127.0.0.1", device="cpu")
    assert srv_mod._ACTIVE is None


# lease_expire and netsplit are ported with the coordinator
# (tests/test_torch_coordinator.py) and bitflip with the parameter
# server (tests/test_torch_ps_faults.py); oom still has no call site in
# the port
@pytest.mark.parametrize("spec", ["oom:run:1"])
def test_fault_spec_naming_an_unported_rule_raises(spec, inject):
    with pytest.raises(NotImplementedError, match="is not ported"):
        faults.parse_spec(spec)
    inject(spec)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        faults.injector()


def test_weight_sync_packing_roundtrip_and_plan(tiny_frozen):
    shapes = {"w": (3, 5), "b": (7,), "scalar": ()}
    plan = ws.pack_plan(shapes, {"b": "float32"}, dim=4)
    vals = {n: np.asarray(np.random.RandomState(i).rand(*shapes[n]),
                          np.float32) for i, n in enumerate(shapes)}
    out = ws.unpack(plan, ws.pack(plan, vals))
    for n in shapes:
        np.testing.assert_array_equal(out[n], vals[n])
    with pytest.raises(KeyError, match="missing value"):
        ws.pack(plan, {"w": vals["w"]})
    # the frozen model's plan is the JAX package's for the same weights
    from paddle_tpu.inference import weight_sync as jws

    plan_t = ws.plan_for_frozen(tiny_frozen)
    shapes_t = {n: tuple(tiny_frozen.scope.find_var(n).shape)
                for n in tiny_frozen.param_names}
    want = jws.pack_plan(shapes_t, {n: "float32" for n in shapes_t})
    assert (plan_t.dim, plan_t.entries, plan_t.total_rows) == \
        (want.dim, want.entries, want.total_rows)
    assert ws.table_shape(plan_t) == jws.table_shape(plan_t)
