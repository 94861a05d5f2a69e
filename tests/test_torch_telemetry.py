"""The port's goodput ledger and fault points against the JAX package's:
the same calls at the same clock readings give the same ledger rows and
summaries, and the same fault specs give the same schedules."""
from __future__ import annotations

import json

import pytest

from paddle_tpu.distributed import faults as ref_faults
from paddle_tpu.telemetry import goodput as ref_goodput
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.telemetry import goodput

CAUSES = ["shed", "deadline", "preempt", "resume"]


def _rows(path):
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    for r in rows:      # process identity, not ledger content
        r.pop("pid", None)
        r.pop("import_ts", None)
    return rows


@pytest.mark.parametrize("cause", CAUSES)
def test_serving_badput_rows_match_reference(cause, tmp_path):
    """A shed/expired/preempted/resumed request's charge lands in the
    same bucket, with the same wall-exact idle residual, in both."""
    out = {}
    for name, mod in (("ref", ref_goodput), ("port", goodput)):
        d = tmp_path / name
        led = mod.GoodputLedger(tag="r0", incarnation=0, directory=str(d),
                                now=100.0)
        led.note_serving_badput(250.0, cause=cause, now=100.5)
        led.note_serving_badput(900.0, cause=cause, now=101.0)  # > wall
        led.close()
        out[name] = (_rows(d / "goodput.r0.0.jsonl"), led.summary())
    assert out["port"] == out["ref"]
    rows, summary = out["port"]
    assert [r["event"] for r in rows] == ["birth", "serve_badput",
                                          "serve_badput"]
    assert sum(summary["buckets_ms"].values()) == pytest.approx(1000.0)


def test_ledger_is_off_without_the_gate(monkeypatch):
    monkeypatch.delenv(goodput.ENV_GATE, raising=False)
    goodput.reset_for_tests()
    try:
        goodput.note_serving_badput(5.0, cause="shed")
        assert goodput.get_ledger() is None and goodput.summary() is None
    finally:
        goodput.reset_for_tests()


@pytest.mark.parametrize("spec", [
    "crash:gen_decode_step:3",
    "stall:gen_decode_step:2:5",
    "crash:*:1;stall:*:4:1.5",
    "drop:generate:1;refuse:infer:2;delay:*:1:0.5",
    "kill:infer:40;slow:infer:3:25;partition:ps1:5;stall:infer:2:5",
])
def test_fault_specs_parse_like_reference(spec):
    fields = ("action", "method", "nth", "arg")
    assert ([tuple(getattr(r, f) for f in fields)
             for r in faults.parse_spec(spec)]
            == [tuple(getattr(r, f) for f in fields)
                for r in ref_faults.parse_spec(spec)])


@pytest.mark.parametrize("spec", [
    "netsplit:*:1",               # netsplit without a window
    "stall:gen_decode_step:1",    # stall without a duration
    "crash:gen_decode_step:0",    # nth is 1-based
    "crash:gen_decode_step",      # too few fields
])
def test_fault_specs_refused(spec):
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


@pytest.fixture
def fault_flag():
    """Sets FLAGS_ps_fault_injection for one test, then restores it."""
    before = flags.flag("FLAGS_ps_fault_injection")
    yield lambda on: flags.set_flags({"FLAGS_ps_fault_injection": on})
    flags.set_flags({"FLAGS_ps_fault_injection": before})
    faults.reset()


def test_stall_point_fires_every_nth_arrival(monkeypatch, fault_flag):
    fault_flag(True)
    monkeypatch.setenv(faults.ENV_SPEC, "stall:gen_decode_step:3:20")
    slept = []
    monkeypatch.setattr(faults.time, "sleep", slept.append)
    faults.reset()
    try:
        for _ in range(7):
            faults.stall_point("gen_decode_step")
            faults.stall_point("other_phase")
        faults.crash_point("gen_decode_step")   # no crash rule: returns
    finally:
        faults.reset()
    assert slept == [0.02, 0.02]


def test_fault_layer_off_without_flag(monkeypatch, fault_flag):
    fault_flag(False)
    monkeypatch.setenv(faults.ENV_SPEC, "crash:gen_decode_step:1")
    faults.reset()
    assert faults.injector() is None
    faults.crash_point("gen_decode_step")       # would exit if armed
