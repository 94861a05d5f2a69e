"""The ResNet op emitters of the port (``conv2d``, ``pool2d``,
``batch_norm``, ``relu``, ``fused_conv_bn``) against the JAX package's, on
the same numpy inputs in f32 on the CPU: every output slot within 1e-5
(convolutions: the same sums in another order), in NCHW and NHWC, with
asymmetric pads, SAME/VALID, dilation, groups and ``ceil_mode``; BN in
training and ``is_test`` mode; the fused op in its kernel route, its
reference route, NCHW and its ``is_test`` weight fold.  Shape inference
on meta tensors against the JAX package's abstract evaluation.
FLAGS_conv_dw_im2col's weight gradient (NHWC, f32 and bf16) and adaptive
pool2d with bins that do not divide the input (avg and max, ties) against
the JAX emitters, forward and gradients."""
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


def _vjp_both(op, ins, attrs, out_slot, dtype, seed=5):
    """(JAX, port) results of ``op`` and the gradients of ``out_slot``
    with respect to every input, one random cotangent, inputs in
    ``dtype`` ("float32" or "bfloat16") on both sides."""
    import jax

    names = sorted(ins)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = [jnp.asarray(ins[n], jd) for n in names]

    def jfn(*args):
        return jreg.get(op).emit(jreg.EmitContext(),
                                 {n: [a] for n, a in zip(names, args)},
                                 dict(attrs))[out_slot][0]

    jout, vjp = jax.vjp(jfn, *jx)
    g = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(g, jd))
    # the same bf16 bits on both sides
    tx = [torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16) if dtype == "bfloat16"
        else torch.as_tensor(np.array(a)) for a in jx]
    tx = [a.requires_grad_() for a in tx]
    tout = treg.get(op).emit(treg.EmitContext(),
                             {n: [a] for n, a in zip(names, tx)},
                             dict(attrs))[out_slot][0]
    tout.backward(torch.as_tensor(g).to(td))
    f = lambda a: np.asarray(a).astype(np.float32)  # noqa: E731
    return ([f(jout)] + [f(a) for a in jg],
            [tout.detach().float().numpy()] + [a.grad.float().numpy()
                                                for a in tx])


# FLAGS_conv_dw_im2col: NHWC k x k convs, groups 1
IM2COL = {
    "pad1": ({"Input": X_NHWC, "Filter": W3},
             dict(NHWC, paddings=[1, 1])),
    "asym_s2": ({"Input": X_NHWC, "Filter": W3},
                dict(NHWC, strides=[2, 2], paddings=[2, 1, 0, 1])),
    "same_s2_4x4": ({"Input": X_NHWC, "Filter": _f(8, 6, 4, 4) * 0.2},
                    dict(NHWC, strides=[2, 2], padding_algorithm="SAME")),
    "dilated": ({"Input": X_NHWC, "Filter": W3},
                dict(NHWC, paddings=[2, 2], dilations=[2, 2])),
}
IM2COL_CASES = [(n, d) for n in sorted(IM2COL)
                for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,dtype", IM2COL_CASES,
                         ids=[f"{n}-{d}" for n, d in IM2COL_CASES])
def test_im2col_dw_matches_jax(name, dtype):
    """The weight gradient under FLAGS_conv_dw_im2col (patches against dy
    in one f32 product, cast to the weight's dtype), the forward and the
    input gradient, against the JAX package's custom VJP with the flag
    on: f32 within 1e-4 (sums of up to 6 x 9 x 98 products in another
    order), bf16 within one bf16 rounding step of the largest value."""
    from paddle_tpu.fluid import flags as jflags

    ins, attrs = IM2COL[name]
    jflags.set_flags({"FLAGS_conv_dw_im2col": True})
    tflags.set_flags({"FLAGS_conv_dw_im2col": True})
    try:
        want, got = _vjp_both("conv2d", ins, attrs, "Output", dtype)
    finally:
        jflags.set_flags({"FLAGS_conv_dw_im2col": False})
        tflags.set_flags({"FLAGS_conv_dw_im2col": False})
    for what, g, w in zip(("Output", "dFilter", "dInput"), got, want):
        assert g.shape == w.shape, what
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(g, w, atol=2.0 ** -7 * np.abs(
                w).max(), rtol=2.0 ** -7, err_msg=what)


def test_im2col_gate_leaves_other_convs_as_they_were():
    """The flag takes NHWC k x k convs with groups 1 only: NCHW, a 1 x 1
    and a grouped conv give the same outputs and gradients with it on as
    with it off."""
    cases = [EMIT["conv_nchw_pad1"], EMIT["conv_nhwc_valid_1x1_s2"],
             EMIT["conv_nhwc_groups"]]

    def run(flag):
        tflags.set_flags({"FLAGS_conv_dw_im2col": flag})
        try:
            return [_vjp_both(op, ins, attrs, "Output", "float32", seed=9)[1]
                    for op, ins, attrs in cases]
        finally:
            tflags.set_flags({"FLAGS_conv_dw_im2col": False})

    on, off = run(True), run(False)
    for a, b in zip(on, off):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# adaptive pool2d with bins that do not divide the input (NCHW)
ADAPTIVE = {f"{t}_{h}to3": ("pool2d", {"X": x}, {
    "pooling_type": t, "ksize": [3, 3], "adaptive": True})
    for t in ("avg", "max") for h, x in (
        (7, _f(2, 3, 7, 7)), (5, _f(2, 2, 5, 5)))}
# a zero input: every max bin a tie
ADAPTIVE["max_5to3_ties"] = ("pool2d", {"X": np.zeros((1, 1, 5, 5),
                                                      np.float32)},
                             {"pooling_type": "max", "ksize": [3, 3],
                              "adaptive": True})
ADAPTIVE["avg_7x5to3x2"] = ("pool2d", {"X": _f(1, 2, 7, 5)},
                            {"pooling_type": "avg", "ksize": [3, 2],
                             "adaptive": True})


@pytest.mark.parametrize("name", sorted(ADAPTIVE))
def test_adaptive_pool_non_divisible_matches_jax(name):
    """Forward and gradient (jax.vjp) of ``adaptive_pool_nd``'s bins
    [floor(i n / o), ceil((i + 1) n / o)) within 1e-6; max ties share the
    gradient as jnp.max does, one axis after the other."""
    op, ins, attrs = ADAPTIVE[name]
    want, got = _vjp_both(op, ins, attrs, "Out", "float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_adaptive_max_tie_shares_multiply():
    """5 -> 3 over zeros: bins of 2, 3 and 2 rows overlapping at rows 1 and
    3; each axis splits a bin's cotangent evenly among its ties, so the
    shares multiply: an element's gradient is the product of its row's
    and its column's summed shares (0.5 / 0.5 + 1/3 / 1/3 + 1/3 + 0.5 /
    ...), not one element taking it all as F.adaptive_max_pool2d gives."""
    x = torch.zeros(1, 1, 5, 5, requires_grad=True)
    treg.get("pool2d").emit(treg.EmitContext(), {"X": [x]}, {
        "pooling_type": "max", "ksize": [3, 3], "adaptive": True})[
        "Out"][0].sum().backward()
    share = np.array([0.5, 0.5 + 1 / 3, 1 / 3, 1 / 3 + 0.5, 0.5])
    np.testing.assert_allclose(x.grad[0, 0].numpy(),
                               np.outer(share, share), rtol=1e-6)


def test_adaptive_non_divisible_nhwc_raises_as_jax():
    ins = {"X": [np.zeros((1, 5, 5, 2), np.float32)]}
    attrs = dict(NHWC, pooling_type="avg", ksize=[3, 3], adaptive=True)
    with pytest.raises(NotImplementedError, match="NCHW only"):
        jreg.get("pool2d").emit(jreg.EmitContext(),
                                _as(ins, jnp.asarray), attrs)
    with pytest.raises(NotImplementedError, match="NCHW only"):
        treg.get("pool2d").emit(treg.EmitContext(),
                                _as(ins, torch.as_tensor), attrs)
