"""The push exporters in the port (``paddle_tpu_torch/telemetry/
export.py``) against the JAX package's, on the CPU.

The exporter cases of the JAX package's ``tests/test_proftop.py``
(:416-491) and ``tests/test_tracing.py`` (:500-527) against a local
HTTP collector on 127.0.0.1: flag off means no exporter, the OTLP-shaped
metrics snapshot, the bounded retry with backoff, the pushgateway's
Prometheus text, arming from the environment, the span batches' OTLP
shape and cursor.  Then the payloads against the JAX exporter's for the
same registry contents and the same spans, equal but for the timestamp
and the pid; and ``serve()``, ``ps_server.serve`` and
``init_parallel_env`` arming their exporters from the environment, as
``tests/test_serving_trace.py:563`` holds the JAX replica's.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.telemetry import export as jexport
from paddle_tpu.telemetry import registry as jregistry
from paddle_tpu.telemetry import tracing as jtracing
from paddle_tpu_torch import inference
from paddle_tpu_torch.distributed import ps_server as tps
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference import server as srvmod
from paddle_tpu_torch.inference.engine import GenerationEngine
from paddle_tpu_torch.telemetry import export, get_registry, tracing
from paddle_tpu_torch.telemetry import registry as tregistry

PROMPT = [3, 9, 1, 4, 1, 5, 9]


class _Collector:
    """Tiny local collector: records POSTs, optionally failing the
    first N with HTTP 500."""

    def __init__(self, fail_first=0):
        self.bodies = []
        self.headers = []
        self.attempts = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                outer.attempts += 1
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if outer.attempts <= fail_first:
                    self.send_response(500)
                    self.end_headers()
                    return
                outer.bodies.append(body)
                outer.headers.append(dict(self.headers))
                self.send_response(200)
                self.end_headers()

            def log_message(self, fmt, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def url(self, path="/ingest"):
        return f"http://127.0.0.1:{self.port}{path}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def traced(monkeypatch):
    """Arm PADDLE_TRACING for this test; ring + gate reset on teardown."""
    monkeypatch.setenv(tracing.ENV_GATE, "1")
    tracing._reset_for_tests()
    yield
    tracing._reset_for_tests()


@pytest.fixture
def untraced(monkeypatch):
    monkeypatch.delenv(tracing.ENV_GATE, raising=False)
    tracing._reset_for_tests()
    yield
    tracing._reset_for_tests()


@pytest.fixture(autouse=True)
def _fresh_exporters():
    export.stop()
    yield
    export.stop()


# ---------------------------------------------------------------------------
# the JAX package's cases (tests/test_proftop.py:416-491,
# tests/test_tracing.py:500-527)
# ---------------------------------------------------------------------------


def test_exporter_flag_off_means_no_exporter(monkeypatch):
    monkeypatch.delenv(export.ENV_URL, raising=False)
    assert export.maybe_start() is None
    assert export.active() is None


def test_exporter_pushes_otlp_shaped_snapshot():
    col = _Collector()
    try:
        get_registry().counter("export_test_total", "t").inc(7)
        exp = export.PushExporter(col.url(), interval_s=60, retries=2)
        assert exp.flush()
        payload = json.loads(col.bodies[-1])
        assert payload["resource"]["pid"] == os.getpid()
        series = payload["metrics"]["export_test_total"]["series"]
        assert series[0]["value"] >= 7
        assert get_registry().counter("metrics_push_total").value >= 1
    finally:
        col.close()


def test_exporter_retry_is_bounded_with_backoff():
    fails = get_registry().counter("metrics_push_failures_total").value
    col = _Collector(fail_first=100)  # always failing
    try:
        exp = export.PushExporter(col.url(), interval_s=60, retries=3,
                                  backoff_s=0.01)
        assert not exp.flush()
        assert col.attempts == 3  # bounded: exactly `retries` attempts
        assert (get_registry().counter("metrics_push_failures_total").value
                == fails + 1)
        # recovery: collector comes back, next interval delivers
        col2 = _Collector()
        exp.url = col2.url()
        assert exp.flush()
        col2.close()
    finally:
        col.close()


def test_exporter_retries_then_succeeds():
    col = _Collector(fail_first=2)
    try:
        exp = export.PushExporter(col.url(), interval_s=60, retries=3,
                                  backoff_s=0.01)
        assert exp.flush()
        assert col.attempts == 3 and len(col.bodies) == 1
    finally:
        col.close()


def test_exporter_pushgateway_format_is_prometheus_text():
    col = _Collector()
    try:
        get_registry().counter("export_pg_total", "t").inc()
        exp = export.PushExporter(col.url("/metrics/job/paddle"),
                                  interval_s=60)
        assert exp.fmt == "prom"
        assert exp.flush()
        assert b"# TYPE export_pg_total counter" in col.bodies[-1]
        assert "text/plain" in col.headers[-1].get("Content-Type", "")
    finally:
        col.close()


def test_exporter_env_arming(monkeypatch):
    col = _Collector()
    try:
        monkeypatch.setenv(export.ENV_URL, col.url())
        monkeypatch.setenv(export.ENV_SECS, "60")
        exp = export.maybe_start()
        assert exp is not None and exp.flush()
        assert export.maybe_start() is exp  # resolved once a process
    finally:
        col.close()


def test_trace_export_otlp_shape_and_cursor(traced):
    posts = []

    class _Exp(export.PushExporter):
        def _post_once(self, body, ctype):
            posts.append((json.loads(body.decode()), ctype))

    with tracing.span("exported"):
        pass
    exp = _Exp("http://127.0.0.1:1/v1/traces", interval_s=3600,
               body_fn=export._traces_body_fn(), counter_prefix="traces")
    assert exp.flush() is True
    (payload, ctype), = posts
    assert ctype == "application/json"
    spans = payload["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert any(s["name"] == "exported" for s in spans)
    sp = spans[-1]
    assert len(sp["traceId"]) == 32 and len(sp["spanId"]) == 16
    assert int(sp["endTimeUnixNano"]) >= int(sp["startTimeUnixNano"])
    # cursor advanced: nothing new -> no POST at all, still "delivered"
    assert exp.flush() is True
    assert len(posts) == 1
    exp.stop()


def test_trace_export_env_unset_zero_network(untraced, monkeypatch):
    monkeypatch.delenv(export.ENV_TRACES_URL, raising=False)
    assert export.maybe_start_traces() is None
    assert export.active_traces() is None


# ---------------------------------------------------------------------------
# the payloads against the JAX exporter's
# ---------------------------------------------------------------------------


def _fill(reg):
    reg.counter("served_total", "requests", outcome="ok").inc(3)
    reg.counter("served_total", "requests", outcome="shed").inc()
    reg.gauge("queue_depth", "queued").set(4)
    h = reg.histogram("batch_ms", "batch latency", verb="infer")
    for v in (0.5, 2.0, 7.5, 40.0, 300.0):
        h.observe(v)


def _same_but_clock(a, b):
    for p in (a, b):
        p.pop("ts", None)
        p["resource"].pop("pid", None)
    assert a == b


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_metrics_payload_equals_the_jax_exporters(fmt, monkeypatch):
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _fill(treg)
    _fill(jreg)
    monkeypatch.setattr(export, "get_registry", lambda: treg)
    monkeypatch.setattr(jexport, "get_registry", lambda: jreg)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    t = export.PushExporter("http://127.0.0.1:1/x", fmt=fmt)._body()
    j = jexport.PushExporter("http://127.0.0.1:1/x", fmt=fmt)._body()
    assert t[1] == j[1]
    if fmt == "prom":
        assert t[0] == j[0]
        return
    _same_but_clock(json.loads(t[0]), json.loads(j[0]))


_SPANS = [
    {"trace": "0af7651916cd43dd8448eb211c80319c", "span": "b7ad6b7169203331",
     "parent": None, "name": "gen_request", "kind": "server",
     "ts": 1700000000.25, "dur_ms": 12.5, "status": "ok",
     "attrs": {"positions": 7, "prefix_hit": True, "charged_ms": 1.25,
               "peer": "127.0.0.1:1"}},
    {"trace": "0af7651916cd43dd8448eb211c80319c", "span": "00f067aa0ba902b7",
     "parent": "b7ad6b7169203331", "name": "decode_step",
     "ts": 1700000000.26, "dur_ms": 0.75, "status": "error:Overloaded",
     "attrs": {}},
]


def test_span_payload_equals_the_jax_exporters(monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_NAME", "job7")
    t, j = export.spans_to_otlp(_SPANS), jexport.spans_to_otlp(_SPANS)
    for p in (t, j):
        attrs = p["resourceSpans"][0]["resource"]["attributes"]
        p["resourceSpans"][0]["resource"]["attributes"] = [
            a for a in attrs if a["key"] != "pid"]
    assert t == j
    # the batches the trace exporters build from the same ring
    monkeypatch.setattr(tracing, "export_batch", lambda seq: (_SPANS, 2))
    monkeypatch.setattr(jtracing, "export_batch", lambda seq: (_SPANS, 2))
    tb, jb = export._traces_body_fn()(), jexport._traces_body_fn()()
    assert tb[1] == jb[1]
    assert (json.loads(tb[0])["resourceSpans"][0]["scopeSpans"]
            == json.loads(jb[0])["resourceSpans"][0]["scopeSpans"])


def test_fleet_payload_equals_the_jax_exporters():
    fleet = {"ranks": {"trainer0": {"goodput": 0.9}}, "job_goodput": 0.9}
    t = json.loads(export._fleet_body_fn(lambda: fleet,
                                         lambda: "# x\n")()[0])
    j = json.loads(jexport._fleet_body_fn(lambda: fleet,
                                          lambda: "# x\n")()[0])
    _same_but_clock(t, j)
    assert export._fleet_body_fn(lambda: {})() is None


# ---------------------------------------------------------------------------
# the entry points arm their exporters from the environment
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_frozen(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("export") / "model")
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", [4], dtype="float32")
        pred = jfluid.layers.fc(x, 2)
    exe = jfluid.Executor()
    with jfluid.scope_guard(jfluid.executor.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe,
                                       main_program=main)
    return inference.load_frozen(d, device="cpu")


def _spans_of(posts):
    return {s["name"] for p in posts
            for s in p["resourceSpans"][0]["scopeSpans"][0]["spans"]}


def test_serve_arms_trace_and_metrics_push_from_env(traced, tiny_frozen,
                                                    monkeypatch):
    """serve() mirrors ps_server.serve: PADDLE_TRACES_PUSH_URL and
    PADDLE_METRICS_PUSH_URL arm the exporters at startup, and the
    teardown flushes the span exporter — the last requests' spans leave
    the replica before the process does.  serve_forever is stubbed to
    one in-process generation so the whole serve() lifecycle (arm ->
    serve -> flush) runs inline."""
    posts = []

    class _Exp(export.PushExporter):
        def _post_once(self, body, ctype):
            if ctype == "application/json":
                posts.append(json.loads(body.decode()))

    monkeypatch.setenv(export.ENV_TRACES_URL, "http://127.0.0.1:1/x")
    monkeypatch.setenv(export.ENV_URL, "http://127.0.0.1:1/m")
    monkeypatch.setenv(export.ENV_SECS, "3600")
    monkeypatch.setenv(export.ENV_TRACES_SECS, "3600")
    monkeypatch.setattr(export, "PushExporter", _Exp)
    eng = GenerationEngine(dm.TinyDecoderLM(dm.DecoderConfig(), seed=0,
                                            device="cpu"),
                           max_slots=2, page_size=4, n_pages=24)
    seen = {}

    def fake_serve_forever(self, poll_interval=0.1):
        seen["metrics"] = export.active()
        seen["traces"] = export.active_traces()
        r = eng.result(eng.submit(PROMPT, max_new_tokens=3), timeout=120)
        assert len(r["tokens"]) == 3

    monkeypatch.setattr(tps._TCPServer, "serve_forever", fake_serve_forever)
    srvmod.serve(tiny_frozen, port=0, host="127.0.0.1", engine=eng,
                 device="cpu")
    assert isinstance(seen["metrics"], _Exp)
    assert isinstance(seen["traces"], _Exp)
    # serve()'s teardown flushed the serving lifecycle off-replica
    assert {"gen_request", "prefill", "decode_step"} <= _spans_of(posts)


def test_ps_server_serve_arms_trace_push_from_env(traced, monkeypatch):
    seen = {}
    monkeypatch.setenv(export.ENV_TRACES_URL, "http://127.0.0.1:1/x")
    monkeypatch.setenv(export.ENV_TRACES_SECS, "3600")

    def fake_serve_forever(self, poll_interval=0.1):
        seen["traces"] = export.active_traces()
        seen["metrics"] = export.active()

    monkeypatch.setattr(tps._TCPServer, "serve_forever", fake_serve_forever)
    tps.serve(port=0, host="127.0.0.1")
    assert seen["traces"] is not None
    assert seen["traces"].url == "http://127.0.0.1:1/x"
    assert seen["metrics"] is None  # the pserver pushes spans only


def test_init_parallel_env_arms_the_metrics_push(monkeypatch, tmp_path):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import env as penv

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setitem(penv._state, "initialized", False)
    monkeypatch.setitem(penv._state, "device", None)
    monkeypatch.setenv(export.ENV_URL, "http://127.0.0.1:1/m")
    monkeypatch.setenv(export.ENV_SECS, "3600")
    monkeypatch.setenv(export.ENV_TRACES_URL, "http://127.0.0.1:1/x")
    dev = penv.init_parallel_env(backend="gloo", device="cpu",
                                 init_method=f"file://{tmp_path}/store")
    assert str(dev) == "cpu" and calls[0]["backend"] == "gloo"
    assert export.active() is not None
    assert export.active().url == "http://127.0.0.1:1/m"
    # as in the JAX package, init_parallel_env arms no span exporter
    assert export.active_traces() is None
    for var in ("PADDLE_TRACE_DIR", "PADDLE_DEBUGZ_PORT"):
        monkeypatch.setitem(penv._state, "initialized", False)
        monkeypatch.setenv(var, "1")
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            penv.init_parallel_env(backend="gloo", device="cpu")
        monkeypatch.delenv(var)
    assert len(calls) == 1
