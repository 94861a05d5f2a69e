"""The port's eight other update ops and their optimizers against the
JAX package's, on the CPU: adamax, adagrad, decayed_adagrad, rmsprop
(centered too), lamb, lars_momentum, ftrl (lr_power -0.5 and another)
and dpsgd.

* Each update op's emitter against the JAX emitter on the same random
  f32 inputs: every output within rtol 1e-5, atol 1e-6 (the same math,
  reduced in another order for the norms).
* Each optimizer class (``LarsMomentumOptimizer``, ``AdagradOptimizer``,
  ``AdamaxOptimizer``, ``DecayedAdagradOptimizer``, ``RMSPropOptimizer``,
  ``LambOptimizer`` with ``exclude_from_weight_decay_fn``,
  ``FtrlOptimizer``, ``DpsgdOptimizer`` at sigma 0) built in both
  packages under ``unique_name.guard()`` (the same ops), the JAX startup
  scope copied across, 5 steps on a small fc net: the loss trace and
  every scope variable after the last step within 1e-5.
* dpsgd at sigma > 0 draws its noise from the step's generator: the
  same seed gives the same bits in the port (the JAX PRNG's bits differ
  by design), and over 2**16 draws the noise's mean and standard
  deviation fall within 6 standard errors of 0 and sigma * clip.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
TRAIN_TOL = 1e-5

_R = np.random.default_rng(11)


def _f(*shape, pos=False):
    a = _R.standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.1 if pos else a


_P, _G = _f(6, 5), _f(6, 5)
_LR = np.array([0.05], np.float32)
_B1P, _B2P = np.array([0.81], np.float32), np.array([0.998], np.float32)

OPS = {
    "adamax": ("adamax", {"Param": _P, "Grad": _G, "Moment": _f(6, 5),
                          "InfNorm": _f(6, 5, pos=True), "Beta1Pow": _B1P,
                          "LearningRate": _LR},
               {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8}),
    "adagrad": ("adagrad", {"Param": _P, "Grad": _G,
                            "Moment": _f(6, 5, pos=True),
                            "LearningRate": _LR}, {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad", {
        "Param": _P, "Grad": _G, "Moment": _f(6, 5, pos=True),
        "LearningRate": _LR}, {"decay": 0.9, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", {"Param": _P, "Grad": _G,
                            "MeanSquare": _f(6, 5, pos=True),
                            "Moment": _f(6, 5), "LearningRate": _LR},
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}),
    "rmsprop_centered": ("rmsprop", {
        "Param": _P, "Grad": _G, "MeanSquare": _f(6, 5, pos=True) + 2.0,
        "Moment": _f(6, 5), "MeanGrad": 0.1 * _f(6, 5),
        "LearningRate": _LR},
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
    "lamb": ("lamb", {"Param": _P, "Grad": _G, "Moment1": _f(6, 5),
                      "Moment2": _f(6, 5, pos=True), "Beta1Pow": _B1P,
                      "Beta2Pow": _B2P, "LearningRate": _LR},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "lamb_zero_param": ("lamb", {"Param": np.zeros((6, 5), np.float32),
                                 "Grad": _G, "Moment1": _f(6, 5),
                                 "Moment2": _f(6, 5, pos=True),
                                 "Beta1Pow": _B1P, "Beta2Pow": _B2P,
                                 "LearningRate": _LR},
                        {"weight_decay": 0.0}),
    "lars_momentum": ("lars_momentum", {"Param": _P, "Grad": _G,
                                        "Velocity": _f(6, 5),
                                        "LearningRate": _LR},
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "lars_momentum_zero_grad": ("lars_momentum", {
        "Param": _P, "Grad": np.zeros((6, 5), np.float32),
        "Velocity": _f(6, 5), "LearningRate": _LR}, {"epsilon": 1e-9}),
    "ftrl": ("ftrl", {"Param": _P, "Grad": _G,
                      "SquaredAccumulator": _f(6, 5, pos=True),
                      "LinearAccumulator": _f(6, 5), "LearningRate": _LR},
             {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
    "ftrl_power": ("ftrl", {"Param": _P, "Grad": _G,
                            "SquaredAccumulator": _f(6, 5, pos=True),
                            "LinearAccumulator": _f(6, 5),
                            "LearningRate": _LR},
                   {"l1": 0.0, "l2": 0.1, "lr_power": -0.25}),
    "dpsgd": ("dpsgd", {"Param": _P, "Grad": 10 * _G, "LearningRate": _LR},
              {"clip": 1.0, "batch_size": 4.0, "sigma": 0.0}),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_the_jax_emitter(name):
    op, ins, attrs = OPS[name]
    j = jreg.get(op).emit(jreg.EmitContext(),
                          {k: [jnp.asarray(v)] for k, v in ins.items()},
                          dict(attrs))
    t = treg.get(op).emit(treg.EmitContext(),
                          {k: [torch.as_tensor(v)] for k, v in ins.items()},
                          dict(attrs))
    assert sorted(t) == sorted(j)
    for slot in j:
        a, b = np.asarray(j[slot][0]), t[slot][0]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, slot
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL, atol=ATOL,
                                   err_msg=slot)


OPTIMIZERS = {
    "lars": lambda f: f.optimizer.LarsMomentumOptimizer(
        0.5, momentum=0.9, lars_coeff=0.01),
    "adagrad": lambda f: f.optimizer.AdagradOptimizer(
        0.1, initial_accumulator_value=0.1),
    "adamax": lambda f: f.optimizer.AdamaxOptimizer(0.01),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagradOptimizer(
        0.05, decay=0.9),
    "rmsprop": lambda f: f.optimizer.RMSPropOptimizer(0.01, momentum=0.5),
    "rmsprop_centered": lambda f: f.optimizer.RMSPropOptimizer(
        0.01, rho=0.9, momentum=0.9, centered=True),
    "lamb": lambda f: f.optimizer.LambOptimizer(
        0.01, lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b_0")),
    "ftrl": lambda f: f.optimizer.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
    "ftrl_power": lambda f: f.optimizer.FtrlOptimizer(0.1, lr_power=-0.25),
    "dpsgd": lambda f: f.optimizer.DpsgdOptimizer(0.1, clip=5.0,
                                                  batch_size=4.0,
                                                  sigma=0.0),
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
def test_optimizer_class_matches_jax_for_5_steps(name):
    jm, js, jl = _build(jfluid, name)
    tm, ts, tl = _build(tfluid, name)
    assert [(op.type, op.inputs, op.outputs) for op in
            tm.global_block().ops] == [(op.type, op.inputs, op.outputs)
                                       for op in jm.global_block().ops]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = sorted(n for n, v in jscope.vars.items() if v is not None)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in state}, device="cpu")
    texe = tfluid.Executor(device="cpu")
    start = {n: tscope.find_var(n).numpy().copy() for n in state}
    rng = np.random.default_rng(0)
    want, got = [], []
    for _ in range(5):
        feed = {"x": rng.standard_normal((5, 8)).astype(np.float32),
                "y": rng.integers(0, 4, (5, 1)).astype(np.int32)}
        want.append(float(jexe.run(jm, feed=feed, fetch_list=[jl],
                                   scope=jscope)[0].reshape(-1)[0]))
        got.append(float(texe.run(tm, feed=feed, fetch_list=[tl],
                                  scope=tscope)[0].reshape(-1)[0]))
    np.testing.assert_allclose(got, want, atol=TRAIN_TOL, rtol=0)
    for n in state:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   atol=TRAIN_TOL, rtol=0, err_msg=n)
    # the run moved every parameter
    for p in tm.all_parameters():
        assert not np.array_equal(tscope.find_var(p.name).numpy(),
                                  start[p.name]), p.name


def test_lamb_excludes_the_biases_from_weight_decay():
    tm, _, _ = _build(tfluid, "lamb")
    wd = {op.input("Param")[0]: op.attr("weight_decay")
          for op in tm.global_block().ops if op.type == "lamb"}
    assert wd == {n: (0.0 if n.endswith(".b_0") else 0.05) for n in wd}
    assert sorted(wd) == sorted(p.name for p in tm.all_parameters())


def _dpsgd_noise(seed, n=1 << 16, sigma=0.5, clip=2.0):
    """dpsgd on a zero gradient: the update is -lr * noise / batch."""
    lr, batch = 0.1, 4.0
    ins = {"Param": [torch.zeros(n)], "Grad": [torch.zeros(n)],
           "LearningRate": [torch.tensor([lr])]}
    out = treg.get("dpsgd").emit(treg.EmitContext(seed=seed), ins, {
        "clip": clip, "sigma": sigma, "batch_size": batch})["ParamOut"][0]
    return -out.double() * batch / lr


def test_dpsgd_noise_repeats_per_seed_and_has_the_right_moments():
    a, b, c = _dpsgd_noise(3), _dpsgd_noise(3), _dpsgd_noise(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    n, std = a.numel(), 0.5 * 2.0
    assert abs(float(a.mean())) < 6 * std / math.sqrt(n)
    # the sample std's standard error is std / sqrt(2 n)
    assert abs(float(a.std()) - std) < 6 * std / math.sqrt(2 * n)
    # an executor step draws it from the step seed: two scopes seeded
    # alike give the same parameters, the next step other noise
    outs = []
    for _ in range(2):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), tfluid.program_guard(main,
                                                              startup):
            x = tfluid.layers.data("x", [4], "float32")
            loss = tfluid.layers.reduce_mean(tfluid.layers.fc(x, 3))
            tfluid.optimizer.DpsgdOptimizer(0.1, sigma=1.0).minimize(loss)
        scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
        exe.run(startup, scope=scope)
        w = main.all_parameters()[0].name
        steps = []
        for _ in range(2):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[loss], scope=scope)
            steps.append(scope.find_var(w).clone())
        outs.append(steps)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
