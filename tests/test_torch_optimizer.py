"""The port's optimizers against the JAX package's: SGD, Momentum, Adam
and AdamW (with and without its decay filter) over a small fc net for 5
steps, plus L2 regularization and per-value / per-norm clipping.

Both packages build the same program under ``unique_name.guard()`` (same
ops, same accumulators), the JAX startup scope is copied across, and
after every step the loss, every parameter and every accumulator
(moments, velocities, beta powers, the learning rate) agree within 1e-6
(f32; the same math in another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

TOL = 1e-6

OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGDOptimizer(learning_rate=0.1),
    "momentum": lambda f: f.optimizer.MomentumOptimizer(0.1, momentum=0.9),
    "nesterov": lambda f: f.optimizer.MomentumOptimizer(
        0.05, momentum=0.9, use_nesterov=True),
    "adam": lambda f: f.optimizer.AdamOptimizer(learning_rate=0.01),
    "adamw": lambda f: f.optimizer.AdamWOptimizer(learning_rate=0.01,
                                                  weight_decay=0.05),
    "adamw_filtered": lambda f: f.optimizer.AdamWOptimizer(
        learning_rate=0.01, weight_decay=0.05,
        apply_decay_param_fun=lambda n: n.endswith(".w_0")),
    "sgd_l2": lambda f: f.optimizer.SGD(
        learning_rate=0.1, regularization=f.regularizer.L2Decay(0.01)),
    "adam_clip_value": lambda f: f.optimizer.Adam(
        learning_rate=0.01, grad_clip=f.clip.GradientClipByValue(0.05)),
    "momentum_clip_norm": lambda f: f.optimizer.Momentum(
        0.1, momentum=0.9, grad_clip=f.clip.GradientClipByNorm(0.5)),
}


def _build(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [8], "float32")
        y = L.data("y", [1], "int32")
        h = L.fc(x, 16, act="tanh")
        logits = L.fc(h, 4)
        loss = L.reduce_mean(L.softmax_with_cross_entropy(logits, y))
        OPTIMIZERS[name](fluid).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_for_5_steps(name):
    jm, js, jl = _build(jfluid, name)
    tm, ts, tl = _build(tfluid, name)
    assert [op.type for op in tm.global_block().ops] == [
        op.type for op in jm.global_block().ops]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = sorted(n for n, v in jscope.vars.items() if v is not None)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in state}, device="cpu")
    texe = tfluid.Executor(device="cpu")
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((5, 8)).astype(np.float32),
            "y": rng.integers(0, 4, (5, 1)).astype(np.int32)}
    for step in range(5):
        a = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0]
        b = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0]
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0,
                                   err_msg=f"loss, step {step}")
        for n in state:
            np.testing.assert_allclose(
                tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                atol=TOL, rtol=0, err_msg=f"{n}, step {step}")


def test_adam_state_is_written_back_and_detached():
    tm, ts, tl = _build(tfluid, "adam")
    scope = tfluid.Scope()
    exe = tfluid.Executor(device="cpu")
    exe.run(ts, scope=scope)
    before = {n: v.clone() for n, v in scope.vars.items()}
    feed = {"x": np.ones((2, 8), np.float32),
            "y": np.zeros((2, 1), np.int32)}
    exe.run(tm, feed=feed, fetch_list=[tl], scope=scope)
    moments = [n for n in scope.vars if "moment" in n]
    assert moments
    for n, v in scope.vars.items():
        assert not v.requires_grad and not v.is_inference(), n
    for n in moments:
        assert not np.array_equal(scope.find_var(n).numpy(),
                                  before[n].numpy()), n
    b1 = [n for n in scope.vars if "beta1_pow" in n][0]
    np.testing.assert_allclose(scope.find_var(b1).numpy(), [0.9 * 0.9],
                               rtol=1e-6)
