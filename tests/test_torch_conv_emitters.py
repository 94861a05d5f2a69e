"""The ResNet op emitters of the port (``conv2d``, ``pool2d``,
``batch_norm``, ``relu``, ``fused_conv_bn``) against the JAX package's, on
the same numpy inputs in f32 on the CPU: every output slot within 1e-5
(convolutions: the same sums in another order), in NCHW and NHWC, with
asymmetric pads, SAME/VALID, dilation, groups and ``ceil_mode``; BN in
training and ``is_test`` mode; the fused op in its kernel route, its
reference route, NCHW and its ``is_test`` weight fold.  Shape inference
on meta tensors against the JAX package's abstract evaluation, and the
unported branches raise."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid import dtypes as tdtypes
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.ops import registry as treg

TOL = 1e-5
_rng = np.random.RandomState(11)


def _f(*shape, lo=None):
    a = _rng.randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def _bn_ins(x, c):
    return {"X": x, "Scale": _f(c, lo=0.5), "Bias": _f(c),
            "Mean": _f(c) * 0.1, "Variance": _f(c, lo=0.5)}


def _fused_ins(x, w):
    o = w.shape[0]
    return {"Input": x, "Filter": w, "Scale": _f(o, lo=0.5), "Bias": _f(o),
            "Mean": _f(o) * 0.1, "Variance": _f(o, lo=0.5)}


NHWC = {"data_format": "NHWC"}
X_NCHW, X_NHWC = _f(2, 6, 9, 9), _f(2, 9, 9, 6)
W3, W1 = _f(8, 6, 3, 3) * 0.2, _f(8, 6, 1, 1) * 0.2

EMIT = {
    # conv2d
    "conv_nchw_pad1": ("conv2d", {"Input": X_NCHW, "Filter": W3},
                       {"strides": [1, 1], "paddings": [1, 1]}),
    "conv_nhwc_pad1": ("conv2d", {"Input": X_NHWC, "Filter": W3},
                       dict(NHWC, strides=[1, 1], paddings=[1, 1])),
    "conv_nhwc_asym": ("conv2d", {"Input": X_NHWC, "Filter": W3},
                       dict(NHWC, strides=[1, 1], paddings=[2, 1, 0, 1])),
    "conv_nchw_asym_s2": ("conv2d", {"Input": X_NCHW, "Filter": W3},
                          {"strides": [2, 2], "paddings": [2, 1, 1, 0]}),
    "conv_nhwc_same_s2": ("conv2d", {"Input": X_NHWC,
                                     "Filter": _f(8, 6, 4, 4) * 0.2},
                          dict(NHWC, strides=[2, 2],
                               padding_algorithm="SAME")),
    "conv_nchw_same_even": ("conv2d", {"Input": X_NCHW,
                                       "Filter": _f(8, 6, 4, 4) * 0.2},
                            {"strides": [1, 1], "padding_algorithm": "SAME"}),
    "conv_nhwc_valid_1x1_s2": ("conv2d", {"Input": X_NHWC, "Filter": W1},
                               dict(NHWC, strides=[2, 2],
                                    padding_algorithm="VALID")),
    "conv_nhwc_dilated": ("conv2d", {"Input": X_NHWC, "Filter": W3},
                          dict(NHWC, paddings=[2, 2], dilations=[2, 2])),
    "conv_nchw_same_dilated": ("conv2d", {"Input": X_NCHW, "Filter": W3},
                               {"dilations": [2, 2],
                                "padding_algorithm": "SAME"}),
    "conv_nhwc_groups": ("conv2d", {"Input": X_NHWC,
                                    "Filter": _f(8, 3, 3, 3) * 0.2},
                         dict(NHWC, paddings=[1, 1], groups=2)),
    "conv_nchw_groups": ("conv2d", {"Input": X_NCHW,
                                    "Filter": _f(6, 2, 3, 3) * 0.2},
                         {"paddings": [1, 1], "groups": 3}),
    # pool2d
    "max_nhwc_resnet": ("pool2d", {"X": X_NHWC},
                        dict(NHWC, pooling_type="max", ksize=[3, 3],
                             strides=[2, 2], paddings=[1, 1])),
    "max_nchw_asym": ("pool2d", {"X": X_NCHW},
                      {"pooling_type": "max", "ksize": [3, 3],
                       "strides": [2, 2], "paddings": [0, 1, 1, 0]}),
    "max_nhwc_ceil": ("pool2d", {"X": X_NHWC},
                      dict(NHWC, pooling_type="max", ksize=[2, 2],
                           strides=[2, 2], ceil_mode=True)),
    "max_nchw_ceil_pad": ("pool2d", {"X": X_NCHW},
                          {"pooling_type": "max", "ksize": [3, 3],
                           "strides": [2, 2], "paddings": [1, 1],
                           "ceil_mode": True}),
    "max_nhwc_same": ("pool2d", {"X": X_NHWC},
                      dict(NHWC, pooling_type="max", ksize=[2, 2],
                           strides=[2, 2], padding_algorithm="SAME")),
    "avg_nhwc_exclusive_pad": ("pool2d", {"X": X_NHWC},
                               dict(NHWC, pooling_type="avg", ksize=[3, 3],
                                    strides=[2, 2], paddings=[1, 1])),
    "avg_nchw_inclusive_pad": ("pool2d", {"X": X_NCHW},
                               {"pooling_type": "avg", "ksize": [3, 3],
                                "strides": [1, 1], "paddings": [1, 1],
                                "exclusive": False}),
    "avg_nchw_exclusive_ceil": ("pool2d", {"X": X_NCHW},
                                {"pooling_type": "avg", "ksize": [2, 2],
                                 "strides": [2, 2], "ceil_mode": True}),
    "avg_nhwc_asym_exclusive": ("pool2d", {"X": X_NHWC},
                                dict(NHWC, pooling_type="avg", ksize=[3, 3],
                                     strides=[2, 2], paddings=[0, 2, 1, 1])),
    "avg_nhwc_same": ("pool2d", {"X": X_NHWC},
                      dict(NHWC, pooling_type="avg", ksize=[3, 3],
                           strides=[2, 2], padding_algorithm="SAME")),
    "avg_nhwc_global": ("pool2d", {"X": X_NHWC},
                        dict(NHWC, pooling_type="avg", ksize=[1, 1],
                             global_pooling=True)),
    "max_nchw_global": ("pool2d", {"X": X_NCHW},
                        {"pooling_type": "max", "global_pooling": True}),
    "avg_nchw_adaptive": ("pool2d", {"X": _f(2, 3, 8, 6)},
                          {"pooling_type": "avg", "ksize": [4, 3],
                           "adaptive": True}),
    "max_nhwc_adaptive": ("pool2d", {"X": _f(2, 8, 6, 3)},
                          dict(NHWC, pooling_type="max", ksize=[2, 3],
                               adaptive=True)),
    # batch_norm
    "bn_nchw_train": ("batch_norm", _bn_ins(X_NCHW, 6), {"momentum": 0.8}),
    "bn_nhwc_train": ("batch_norm", _bn_ins(X_NHWC, 6),
                      {"data_layout": "NHWC", "epsilon": 1e-3}),
    "bn_nhwc_is_test": ("batch_norm", _bn_ins(X_NHWC, 6),
                        {"data_layout": "NHWC", "is_test": True}),
    "bn_nchw_global_stats": ("batch_norm", _bn_ins(X_NCHW, 6),
                             {"use_global_stats": True}),
    "bn_2d": ("batch_norm", _bn_ins(_f(16, 5), 5), {}),
    # relu
    "relu": ("relu", {"X": _f(3, 7)}, {}),
    # fused_conv_bn: the kernel route (3 x 3 s1, 1 x 1 s2), the reference
    # route (3 x 3 s2), NCHW, is_test weight folding
    "fused_3x3_relu": ("fused_conv_bn", _fused_ins(X_NHWC, W3),
                       dict(NHWC, paddings=[1, 1], with_relu=True)),
    "fused_1x1_s2": ("fused_conv_bn", _fused_ins(X_NHWC, W1),
                     dict(NHWC, strides=[2, 2], momentum=0.7)),
    "fused_3x3_s2_reference": ("fused_conv_bn", _fused_ins(X_NHWC, W3),
                               dict(NHWC, strides=[2, 2], paddings=[1, 1],
                                    with_relu=True)),
    "fused_nchw": ("fused_conv_bn", _fused_ins(X_NCHW, W3),
                   {"paddings": [1, 1], "with_relu": True}),
    "fused_nhwc_is_test": ("fused_conv_bn", _fused_ins(X_NHWC, W3),
                           dict(NHWC, paddings=[1, 1], with_relu=True,
                                is_test=True)),
    "fused_nchw_is_test": ("fused_conv_bn", _fused_ins(X_NCHW, W1),
                           {"is_test": True}),
}


def _as(ins, conv):
    return {k: [conv(a) for a in (v if isinstance(v, list) else [v])]
            for k, v in ins.items()}


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax(name):
    op, ins, attrs = EMIT[name]
    j = jreg.get(op).emit(jreg.EmitContext(), _as(ins, jnp.asarray),
                          dict(attrs))
    t = treg.get(op).emit(treg.EmitContext(), _as(ins, torch.as_tensor),
                          dict(attrs))
    assert sorted(t) == sorted(j)
    for slot in j:
        for a, b in zip(j[slot], t[slot]):
            a = np.asarray(a)
            assert tuple(b.shape) == a.shape, slot
            assert tdtypes.from_torch_dtype(b.dtype) == a.dtype, slot
            np.testing.assert_allclose(b.numpy(), a, atol=TOL, rtol=TOL,
                                       err_msg=slot)


@pytest.mark.parametrize("name", ["conv_nhwc_asym", "conv_nchw_asym_s2",
                                  "conv_nhwc_same_s2", "max_nchw_ceil_pad",
                                  "avg_nhwc_global", "bn_nhwc_train",
                                  "fused_3x3_relu", "fused_3x3_s2_reference",
                                  "fused_nhwc_is_test"])
def test_shape_inference_matches_jax(name):
    op, ins, attrs = EMIT[name]
    metas = {k: [(a.shape, a.dtype) for a in v]
             for k, v in _as(ins, np.asarray).items()}
    assert (treg.abstract_eval(op, metas, attrs, 3)
            == jreg.abstract_eval(op, metas, attrs, 3))


@pytest.mark.parametrize("name", ["conv_nhwc_asym", "max_nchw_ceil_pad",
                                  "avg_nhwc_asym_exclusive", "bn_nhwc_train",
                                  "relu"])
def test_generic_grad_matches_jax(name):
    """The synthesized <op>_grad (autograd through the emitter) against
    the JAX package's (jax.vjp through its emitter), cotangent on the
    first output."""
    op, ins, attrs = EMIT[name]
    out_slot = {"conv2d": "Output", "pool2d": "Out", "batch_norm": "Y",
                "relu": "Out"}[op]
    jins, tins = _as(ins, jnp.asarray), _as(ins, torch.as_tensor)
    shape = jreg.get(op).emit(jreg.EmitContext(), jins,
                              dict(attrs))[out_slot][0].shape
    g = _rng.randn(*shape).astype(np.float32)
    gattrs = dict(attrs, __fwd_in_slots__=list(ins))
    j = jreg.get(op + "_grad").emit(
        jreg.EmitContext(), dict(jins, **{out_slot + "@GRAD":
                                          [jnp.asarray(g)]}), gattrs)
    t = treg.get(op + "_grad").emit(
        treg.EmitContext(), dict(tins, **{out_slot + "@GRAD":
                                          [torch.as_tensor(g)]}), gattrs)
    for slot in ins:
        np.testing.assert_allclose(t[slot + "@GRAD"][0].numpy(),
                                   np.asarray(j[slot + "@GRAD"][0]),
                                   atol=1e-4, rtol=1e-4, err_msg=slot)


def test_unported_branches_raise():
    op, ins, attrs = EMIT["conv_nhwc_pad1"]
    tflags.set_flags({"FLAGS_conv_dw_im2col": True})
    try:
        with pytest.raises(NotImplementedError, match="conv_dw_im2col"):
            treg.get(op).emit(treg.EmitContext(), _as(ins, torch.as_tensor),
                              attrs)
        # the flag only concerns NHWC k x k convs: NCHW runs as before
        op, ins, attrs = EMIT["conv_nchw_pad1"]
        treg.get(op).emit(treg.EmitContext(), _as(ins, torch.as_tensor),
                          attrs)
    finally:
        tflags.set_flags({"FLAGS_conv_dw_im2col": False})
    with pytest.raises(NotImplementedError, match="non-divisible"):
        treg.get("pool2d").emit(treg.EmitContext(),
                                {"X": [torch.zeros(1, 3, 7, 7)]},
                                {"pooling_type": "avg", "ksize": [2, 2],
                                 "adaptive": True})
