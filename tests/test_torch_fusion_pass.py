"""The conv+BN fusion pass (``fluid/fusion_pass.py``) of the port against
the JAX package's, on the same programs built by both packages: the same
number of fusions and the same ops, slots and attrs afterwards, for the
plain pattern, grouped and dilated convs (left alone), a BN output with a
second consumer (the ReLU stays), a conv with two consumers (left alone),
the ``is_test`` fold and FLAGS_conv_bn_fusion off (a no-op).  Then
fused against unfused training through ``minimize`` on the CPU: the same
losses (within 1e-5 relative, the JAX package's own parity limit) and the
same losses as the JAX package's fused program; under bf16 AMP finite
and falling."""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid.fusion_pass import apply_conv_bn_fusion as jfuse
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid.dtypes import dtype_name
from paddle_tpu_torch.fluid.fusion_pass import apply_conv_bn_fusion as tfuse


def _attr(v):
    try:
        return dtype_name(v)
    except (TypeError, ValueError, KeyError, AttributeError):
        return v


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: _attr(v) for k, v in op.attrs.items()
              if not k.startswith("__")})
            for op in program.global_block().ops]


def _chain(fluid, groups=1, dilation=1, act="relu"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data("img", [2, 3, 8, 8], append_batch_size=False)
        x = L.transpose(img, [0, 2, 3, 1])
        c = L.conv2d(x, 4, 3, padding=dilation, bias_attr=False,
                     data_format="NHWC")
        c = L.conv2d(c, 8, 3, padding=dilation, dilation=dilation,
                     groups=groups, bias_attr=False, data_format="NHWC")
        bn = L.batch_norm(c, act=act, data_layout="NHWC")
        L.reduce_mean(bn)
    return main


def _shared_bn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data("img", [2, 4, 8, 8], append_batch_size=False)
        x = L.transpose(img, [0, 2, 3, 1])
        c = L.conv2d(x, 8, 3, padding=1, bias_attr=False,
                     data_format="NHWC")
        bn = L.batch_norm(c, data_layout="NHWC")
        L.relu(bn)
        L.reduce_sum(bn)   # a second consumer of the BN's Y
    return main


def _shared_conv(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        img = L.data("img", [2, 4, 8, 8], append_batch_size=False)
        x = L.transpose(img, [0, 2, 3, 1])
        c = L.conv2d(x, 8, 3, padding=1, bias_attr=False,
                     data_format="NHWC")
        L.batch_norm(c, data_layout="NHWC")
        L.reduce_sum(c)    # a second consumer of the conv output
    return main


def _is_test(fluid):
    main = _chain(fluid)
    return main.clone(for_test=True)


PROGRAMS = {   # build function, fusions, attrs of the fused op
    "plain": (_chain, 1, {"with_relu": True}),
    "grouped": (lambda f: _chain(f, groups=2), 0, None),
    "dilated": (lambda f: _chain(f, dilation=2), 0, None),
    "no_act": (lambda f: _chain(f, act=None), 1, {"with_relu": False}),
    "shared_bn_output": (_shared_bn, 1, {"with_relu": False}),
    "shared_conv_output": (_shared_conv, 0, None),
    "is_test": (_is_test, 1, {"is_test": True, "with_relu": True}),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_pass_matches_jax(name):
    build, n_fused, last_attrs = PROGRAMS[name]
    jm, tm = build(jfluid), build(tfluid)
    assert _ops(tm) == _ops(jm)
    n = tfuse(tm)
    assert n == jfuse(jm) == n_fused
    assert _ops(tm) == _ops(jm)
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("batch_norm") == 1 - n_fused
    fused = [op for op in tm.global_block().ops if op.type == "fused_conv_bn"]
    for op in fused:
        for k, v in last_attrs.items():
            assert op.attrs[k] == v
        for v in op.output_names():
            assert tm.global_block()._find_var_recursive(v).op is op


def test_flag_off_is_a_no_op():
    assert tflags.get_flags(["FLAGS_conv_bn_fusion"])[
        "FLAGS_conv_bn_fusion"] is False
    progs = [_train_program(tfluid, tflags, None, fuse=False)[0]
             for _ in range(2)]
    types = [op.type for op in progs[0].global_block().ops]
    assert types == [op.type for op in progs[1].global_block().ops]
    assert "fused_conv_bn" not in types and "batch_norm" in types


def _train_program(fluid, flags, mp, fuse, amp=False):
    flags.set_flags({"FLAGS_conv_bn_fusion": fuse})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            img = L.data("img", [4, 3, 16, 16], append_batch_size=False)
            y = L.data("y", [4, 1], dtype="int64", append_batch_size=False)
            x = L.transpose(img, [0, 2, 3, 1])
            c = L.conv2d(x, 8, 3, padding=1, bias_attr=False,
                         data_format="NHWC")
            c = L.batch_norm(c, act="relu", data_layout="NHWC")
            c = L.conv2d(c, 8, 1, bias_attr=False, data_format="NHWC")
            c = L.batch_norm(c, data_layout="NHWC")
            logits = L.fc(c, 5)
            loss = L.mean(L.softmax_with_cross_entropy(logits, y))
            opt = fluid.optimizer.MomentumOptimizer(0.05, momentum=0.9)
            if amp:
                opt = mp.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    finally:
        flags.set_flags({"FLAGS_conv_bn_fusion": False})
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(1)
    return {"img": rng.randn(4, 3, 16, 16).astype("f4"),
            "y": rng.randint(0, 5, (4, 1)).astype("i8")}


def _losses(main, startup, loss, weights=None, steps=5):
    exe = tfluid.Executor(device="cpu")
    if weights is None:
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = tfluid.Scope.from_numpy(weights, device="cpu")
    return [float(exe.run(main, feed=_feed(), fetch_list=[loss],
                          scope=scope)[0][0]) for _ in range(steps)]


def test_fused_trains_like_unfused_and_like_jax():
    fm, fs, fl = _train_program(tfluid, tflags, None, fuse=True)
    um, us, ul = _train_program(tfluid, tflags, None, fuse=False)
    types = [op.type for op in fm.global_block().ops]
    assert types.count("fused_conv_bn") == 2
    assert types.count("fused_conv_bn_grad") == 2
    assert "batch_norm" not in types
    jm, js, jl = _train_program(jfluid, jflags, None, fuse=True)
    assert _ops(fm) == _ops(jm)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    weights = {n: np.asarray(v) for n, v in jscope.vars.items()
               if v is not None}
    lf = _losses(fm, fs, fl, weights)
    lu = _losses(um, us, ul, weights)
    lj = [float(jexe.run(jm, feed=_feed(), fetch_list=[jl],
                         scope=jscope)[0][0]) for _ in range(5)]
    np.testing.assert_allclose(lf, lu, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lf, lj, rtol=1e-5, atol=1e-6)
    assert lf[-1] < lf[0]


def test_fused_trains_under_amp():
    fm, fs, fl = _train_program(tfluid, tflags, tmp, fuse=True, amp=True)
    jm, _, _ = _train_program(jfluid, jflags, jmp, fuse=True, amp=True)
    assert _ops(fm) == _ops(jm)
    types = [op.type for op in fm.global_block().ops]
    assert "fused_conv_bn" in types and "batch_norm" not in types
    # the rewrite keeps the scale, shift and moving statistics f32
    blk = fm.global_block()
    for op in blk.ops:
        if op.type == "fused_conv_bn":
            assert dtype_name(blk.var(op.input("Input")[0]).dtype) == \
                "bfloat16"
            for slot in ("Scale", "Bias", "Mean", "Variance"):
                assert dtype_name(blk.var(op.input(slot)[0]).dtype) == \
                    "float32", slot
    losses = _losses(fm, fs, fl)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
