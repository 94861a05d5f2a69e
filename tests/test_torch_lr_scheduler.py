"""The port's in-graph learning-rate schedules
(``fluid/learning_rate_scheduler.py``) against the JAX package's, on the
CPU.

Each schedule is built in both packages under ``unique_name.guard()``
beside an SGD step whose learning rate it is, and run 30 steps; the
fetched rate of every step agrees within rtol 1e-6 (float32 ops in
another order), with an absolute floor of 1e-7 of the schedule's peak
rate (near the end of a polynomial decay 1 - step / decay_steps cancels:
one float32 ulp of the fraction, 6e-8, is 6e-8 of the peak rate, a large
share of the small rate left), and so does the trained weight: noam, exponential,
natural_exp and inverse_time decays with and without ``staircase``,
polynomial decay with and without ``cycle`` (power 1 and 2), the
piecewise boundaries, cosine decay, and ``linear_lr_warmup`` around a
schedule and around a float.  The step counter ``@LR_DECAY_COUNTER@``
is one persistable float32 shared by schedules in one program (one
increment a run).  A ``CheckpointManager`` save mid-warmup, restored
into a fresh scope, continues the trace of the straight run exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

STEPS = 30
RTOL = 1e-6

SCHEDULES = {
    "noam": lambda L: L.noam_decay(d_model=64, warmup_steps=10,
                                   learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 7, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 7, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 5, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 5, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 4, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 4, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 20, 0.001),
    "polynomial_power2": lambda L: L.polynomial_decay(0.1, 20, 0.0,
                                                      power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 8, 0.01,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 10, 17],
                                             [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 3, 10),
    "warmup_exponential": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 5, 0.8), warmup_steps=6, start_lr=0.0,
        end_lr=0.1),
    "warmup_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-3, decay_steps=20, end_learning_rate=0.0),
        warmup_steps=5, start_lr=1e-5, end_lr=1e-3),
    "warmup_float": lambda L: L.linear_lr_warmup(0.05, 8, 0.01, 0.05),
}


def _build(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        lr = SCHEDULES[name](L)
        x = L.data("x", [4], "float32")
        loss = L.reduce_mean(L.fc(x, 1, bias_attr=False))
        fluid.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


def _trace(exe, main, scope, loss, lr, steps, start=0):
    x = np.ones((2, 4), np.float32)
    return [float(np.asarray(exe.run(main, feed={"x": x * (1 + i % 3)},
                                     fetch_list=[lr], scope=scope)[0])
                  .reshape(-1)[0]) for i in range(start, start + steps)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_trace_matches_jax(name):
    jm, js, jl, jlr = _build(jfluid, name)
    tm, ts, tl, tlr = _build(tfluid, name)
    assert [op.type for op in tm.global_block().ops] == [
        op.type for op in jm.global_block().ops]
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    assert state["@LR_DECAY_COUNTER@"].dtype == np.float32
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    texe = tfluid.Executor(device="cpu")
    want = _trace(jexe, jm, jscope, jl, jlr, STEPS)
    got = _trace(texe, tm, tscope, tl, tlr, STEPS)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-7 * max(want))
    assert len(set(got)) > 1          # the rate moved
    w = tm.all_parameters()[0].name
    np.testing.assert_allclose(tscope.find_var(w).numpy(),
                               np.asarray(jscope.find_var(w)), rtol=RTOL,
                               atol=1e-7)
    assert float(tscope.find_var("@LR_DECAY_COUNTER@")[0]) == STEPS - (
        0 if name == "noam" else 1)


def test_two_schedules_share_one_counter_and_one_increment():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        L = tfluid.layers
        a = L.exponential_decay(0.1, 5, 0.5)
        b = L.linear_lr_warmup(L.cosine_decay(0.1, 2, 5), 3, 0.0, 0.1)
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("increment") == 1
    counter = main.global_block().var("@LR_DECAY_COUNTER@")
    assert counter.persistable and counter.dtype == "float32"
    scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
    exe.run(startup, scope=scope)
    for step in range(4):
        exe.run(main, fetch_list=[a, b], scope=scope)
        assert float(scope.find_var("@LR_DECAY_COUNTER@")[0]) == step


def test_checkpoint_mid_warmup_resumes_the_trace(tmp_path):
    """A CheckpointManager save after 4 of 10 warmup steps carries the
    step counter: a fresh scope restored from it continues with step 4's
    rate, exactly as the run that never stopped."""
    name = "warmup_polynomial"
    main, startup, loss, lr = _build(tfluid, name)
    exe = tfluid.Executor(device="cpu")
    straight = tfluid.Scope()
    exe.run(startup, scope=straight)
    init = {n: v.clone() for n, v in straight.vars.items()}
    want = _trace(exe, main, straight, loss, lr, 12)

    first = tfluid.Scope()
    for n, v in init.items():
        first.set_var(n, v.clone())
    head = _trace(exe, main, first, loss, lr, 4)
    tfluid.CheckpointManager(str(tmp_path), program=main, scope=first,
                             device="cpu").save(4)
    resumed = tfluid.Scope()
    info = tfluid.CheckpointManager(str(tmp_path), program=main,
                                    scope=resumed, device="cpu").restore()
    assert info["step"] == 4
    assert float(resumed.find_var("@LR_DECAY_COUNTER@")[0]) == 3.0
    tail = _trace(exe, main, resumed, loss, lr, 8, start=4)
    assert head + tail == want
    w = main.all_parameters()[0].name
    assert torch.equal(resumed.find_var(w), straight.find_var(w))
