"""The slice as a whole: ResNet training and serving, built by the port
against the JAX package, on the CPU.

* ResNet-50 as the JAX package's bench trains it (batch 128 at 224,
  FLAGS_conv_bn_fusion, Momentum 0.1/0.9, bf16 AMP), built by both
  packages without a run: the same ops, slots and attrs, 53
  ``fused_conv_bn`` ops, and the same split by the kernel gate: 49 take
  the kernels (13 k x k at stride 1, 36 1 x 1), 4 (the 7 x 7 stem and the
  three 3 x 3 stride-2 convs) the reference composition.
* Loss traces of 5 Momentum steps from the JAX package's initialised
  scope (``Scope.from_numpy``) on one batch of 4 at 32 x 32, for
  ``ResNetConfig.tiny()`` (basic blocks) and a tiny bottleneck
  configuration, fusion on and off, and the space-to-depth stem fused:
  f32 within 1e-4 (the same math in another summation order), bf16 AMP
  within 2e-2
  (bf16 rounds at other places in the two frameworks); the BN moving
  statistics within the same limits after the first step, and in f32
  every parameter, velocity and moving statistic after the last.  Under
  bf16 the moving statistics are not held after the later steps: at
  learning rate 0.1 bf16 rounding compounds through the updates in each
  package on its own (its bf16 run drifts from its own f32 run) as far
  as the two packages drift apart.
* The serving fold: the tiny bottleneck model frozen by both packages
  folds the same number of conv+BN pairs, and the Predictors' logits
  agree within 1e-5 in f32.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import freeze_program as jax_freeze
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu.ops.pallas import conv_bn as jcb
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid.dtypes import dtype_name
from paddle_tpu_torch.inference import ServingPredictor, freeze_program
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.ops.kernels import conv_bn as tcb

F32_TOL, BF16_TOL = 1e-4, 2e-2
STEPS = 5


def _cfg(res, name):
    if name == "tiny":
        return res.ResNetConfig.tiny()
    if name == "tiny_s2d_stem":
        # the folded 4 x 4 / s1 stem with pads (2, 1): a k x k stride-1
        # conv with asymmetric pads, on the kernel route
        return res.ResNetConfig(8, 10, [1, 1], base_filters=8,
                                stem_space_to_depth=True)
    return res.ResNetConfig(50, 10, [1, 1], base_filters=8)


def _build(fluid, flags, res, mp, cfg, batch, size, fuse, amp):
    flags.set_flags({"FLAGS_conv_bn_fusion": fuse})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard():
            m, st, _, loss = res.build_resnet_train_program(
                cfg, batch, size, main, startup)
            with fluid.program_guard(m, st):
                opt = fluid.optimizer.MomentumOptimizer(0.1, momentum=0.9)
                if amp:
                    opt = mp.decorate(opt, use_bf16=True)
                opt.minimize(loss)
    finally:
        flags.set_flags({"FLAGS_conv_bn_fusion": False})
    return m, st, loss


def _attr(v):
    try:
        return dtype_name(v)  # the IR's dtypes, whatever object holds them
    except (TypeError, ValueError, KeyError, AttributeError):
        return v


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: _attr(v) for k, v in op.attrs.items()
              if not k.startswith("__")})
            for op in program.global_block().ops]


def _gate_split(program, resolve, gate):
    """(kernel route, reference route) counts of the fused ops."""
    blk = program.global_block()
    routes = []
    for op in blk.ops:
        if op.type != "fused_conv_bn":
            continue
        xs = blk.var(op.input("Input")[0]).shape
        ws = blk.var(op.input("Filter")[0]).shape
        st = tuple(op.attr("strides"))
        pad = jnn_ops._conv_padding(op.attr("paddings"),
                                    op.attr("padding_algorithm", "EXPLICIT"),
                                    2)
        pads = resolve(pad, xs[1], xs[2], ws[2], ws[3], st)
        routes.append((gate(xs, ws, st, pads), tuple(ws[2:])))
    return routes


def test_resnet50_programs_match_after_fusion():
    jm, _, _ = _build(jfluid, jflags, jresnet, jmp,
                      jresnet.ResNetConfig.resnet50(), 128, 224, True, True)
    tm, _, _ = _build(tfluid, tflags, tresnet, tmp,
                      tresnet.ResNetConfig.resnet50(), 128, 224, True, True)
    assert _ops(tm) == _ops(jm)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("fused_conv_bn") == 53
    assert types.count("fused_conv_bn_grad") == 53
    assert "batch_norm" not in types and "conv2d" not in types
    t_routes = _gate_split(tm, tcb._resolve_pads, tcb.conv_bn_shapes_ok)
    j_routes = _gate_split(jm, jcb._resolve_pads, jcb.conv_bn_shapes_ok)
    assert t_routes == j_routes
    kernel = [k for ok, k in t_routes if ok]
    assert len(kernel) == 49 and len(t_routes) - len(kernel) == 4
    assert sum(k != (1, 1) for k in kernel) == 13  # row 10
    assert sum(k == (1, 1) for k in kernel) == 36  # row 11
    assert sorted(k for ok, k in t_routes if not ok) == [(3, 3)] * 3 + [(7, 7)]
    assert tresnet.resnet_step_flops(tresnet.ResNetConfig.resnet50(), 128,
                                     224) == jresnet.resnet_step_flops(
        jresnet.ResNetConfig.resnet50(), 128, 224)


def _bn_stats(program):
    names = []
    for op in program.global_block().ops:
        if op.type in ("batch_norm", "fused_conv_bn"):
            names += op.input("Mean") + op.input("Variance")
    return names


CASES = [(c, f, a) for c in ("tiny", "bottleneck") for f in (True, False)
         for a in (False, True)] + [("tiny_s2d_stem", True, False)]


@pytest.mark.parametrize("name,fuse,amp", CASES,
                         ids=[f"{c}-{'fused' if f else 'unfused'}-"
                              f"{'bf16' if a else 'f32'}"
                              for c, f, a in CASES])
def test_train_loss_trace_matches_jax(name, fuse, amp):
    jm, js, jl = _build(jfluid, jflags, jresnet, jmp, _cfg(jresnet, name), 4,
                        32, fuse, amp)
    tm, ts, tl = _build(tfluid, tflags, tresnet, tmp, _cfg(tresnet, name), 4,
                        32, fuse, amp)
    assert _ops(tm) == _ops(jm)
    n_fused = [op.type for op in tm.global_block().ops].count("fused_conv_bn")
    assert n_fused == (0 if not fuse else 9 if name == "bottleneck" else 6)
    if name == "tiny_s2d_stem":
        stem = next(op for op in tm.global_block().ops
                    if op.type == "fused_conv_bn")
        assert stem.attrs["paddings"] == [2, 1, 2, 1]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    texe = tfluid.Executor(device="cpu")
    rng = np.random.default_rng(1)
    feed = {"image": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (4, 1)).astype(np.int64)}
    stats = _bn_stats(tm)
    assert stats and set(stats) <= set(state)
    tol = BF16_TOL if amp else F32_TOL

    def check(names):
        for n in names:
            np.testing.assert_allclose(
                tscope.find_var(n).float().numpy(),
                np.asarray(jscope.find_var(n), np.float32),
                atol=tol, rtol=0, err_msg=n)

    want, got = [], []
    for step in range(STEPS):
        want.append(jexe.run(jm, feed=feed, fetch_list=[jl],
                             scope=jscope)[0][0])
        got.append(texe.run(tm, feed=feed, fetch_list=[tl],
                            scope=tscope)[0][0])
        if step == 0:
            check(stats)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]
    if not amp:
        check(state)


def test_freeze_folds_conv_bn_like_jax():
    def build(fluid, res, cfg):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data("image", [2, 3, 32, 32],
                                    append_batch_size=False)
            logits = res.resnet(cfg, img)
        return main, startup, logits

    jm, js, jlog = build(jfluid, jresnet, _cfg(jresnet, "bottleneck"))
    tm, _, tlog = build(tfluid, tresnet, _cfg(tresnet, "bottleneck"))
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    # moving statistics away from their initial 0 / 1, so the fold's
    # use of them shows in the logits
    rng = np.random.default_rng(3)
    weights = {}
    for n, v in jscope.vars.items():
        a = np.asarray(v)
        if n in _bn_stats(jm):
            a = (a + rng.uniform(0.1, 0.5, a.shape)).astype(a.dtype)
            jscope.set_var(n, a)
        weights[n] = a
    tscope = tfluid.Scope.from_numpy(weights, device="cpu")
    jf = jax_freeze(jm, scope=jscope, fetch_list=[jlog])
    tf = freeze_program(tm, scope=tscope, fetch_list=[tlog])
    assert tf.fused_conv_bn == jf.fused_conv_bn == 9
    assert _ops(tf.program) == _ops(jf.program)
    assert tf.model_info() == jf.model_info()
    assert all(op.attrs["is_test"] for op in tf.program.global_block().ops
               if op.type == "fused_conv_bn")
    feed = {"image": rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}
    want = JaxPredictor(jf).run(feed)
    got = ServingPredictor(tf, device="cpu").run(feed)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5, rtol=0)
    # the fold leaves the moving statistics as they were
    for n in _bn_stats(tm):
        np.testing.assert_array_equal(tf.scope.find_var(n).numpy(),
                                      weights[n])
