"""The port's ``ops/nn_ops.py`` op types of this slice against the JAX
package's emitters on the CPU, on the same numpy inputs from a seed.

Tolerances (absolute / relative), each the width of what two correct
float implementations may differ by, not of a known fault:

* f32 losses, norms and elementwise math: 1e-6 / 2e-6 (an ulp or two of
  log, exp, sqrt; sums of at most 64 terms);
* f32 convolutions: 1e-5 / 1e-5 (the same products summed in another
  order; TF32 is off);
* ``group_norm`` / ``instance_norm`` at mean 100 and std 3: 5e-6 / 2e-7
  (the mean of 64 values near 100, summed in another order, moves by up
  to 2 ulps of 100, 1.5e-5, within 2e-7 relative; the normalized output
  by that over the std, 5e-6); that the variance is two-pass, as
  jnp.var's, is held apart at mean 1e4, where the one-pass E[x^2] -
  E[x]^2 in f32 loses it;
* bf16 results: 0 / 2**-7, one bf16 rounding step of the result (XLA
  keeps a fused chain in f32 where torch rounds each op);
* one_hot, accuracy, the auc counts, index outputs: exact.

Gradients against ``jax.vjp`` of the JAX emitters at 2e-6 / 1e-6 (f32;
the convolutions at 1e-5 / 1e-5), among them the ignored label and an
out-of-range label of ``cross_entropy`` (no gradient), ``kldiv_loss``
where the target is 0 (-0.0 to X, NaN to Target), the adaptive max
pool's shared ties (in ``test_torch_conv_emitters.py``), and lax.max's
and lax.abs's derivatives at 0.  Two repairs of ops ported before:
lax.max's derivative is a product (an infinite cotangent gives NaN to
the operand that lost), and XLA's min and max order -0.0 below +0.0.
The layers over the ops build the same ops, attributes, shapes and
dtypes as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from torch_emit_cases import (INF, NAN, SPECIAL, Bf16, assert_emit_matches,
                              assert_vjp_matches, emit_jax, emit_torch, rand,
                              shape_inference_matches)

F32_TOL = (1e-6, 2e-6)
CONV_TOL = (1e-5, 1e-5)
NORM100_TOL = (5e-6, 2e-7)
BF16_TOL = (0.0, 2.0 ** -7)
EXACT = None


def _probs(seed, *shape):
    e = np.exp(rand(seed, *shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


X_NCHW = rand(1, 2, 4, 7, 7)
X_NHWC = rand(2, 2, 7, 7, 4)
P = _probs(3, 4, 6)
P_ZERO = np.concatenate([P, np.array([[0.0, 1.0, 0, 0, 0, 0]], np.float32)])
# ids: in range, the ignored -100, -1 (wraps to the last class), 9 (past
# the end: NaN in the loss, no gradient)
HARD = np.array([[2], [-100], [-1], [9], [0]], np.int64)
MEAN100 = 100.0 + 3.0 * rand(4, 2, 4, 4, 4)
LOGITS = np.concatenate([SPECIAL.ravel(), rand(5, 8).ravel()])[None]
BIN = (rand(6, 1, 16) > 0).astype(np.float32)
IDS = np.array([[0, 3, -1], [7, 2, 9]], np.int64)    # -1, 7, 9 outside [0, 7)
ZERO_T = np.array([[0.0, 0.3, 0.7, -0.1], [0.5, 0.0, 0.25, 0.25]],
                  np.float32)
SCORES = np.array([[0.2, 0.9], [0.5, NAN], [0.1, 1e10], [0.3, -INF],
                   [0.0, 0.55], [0.7, 0.3], [0.4, INF], [0.9, -1e10]],
                  np.float32)
AUC_LABEL = np.array([[1], [0], [1], [0], [1], [1], [0], [0]], np.int64)
STATS = np.arange(11, dtype=np.float32)


def _auc_ins(curve):
    return ("auc", {"Predict": SCORES, "Label": AUC_LABEL,
                    "StatPos": STATS, "StatNeg": STATS[::-1].copy()},
            {"num_thresholds": 10, "curve": curve})


EMIT = {
    # convolutions
    "depthwise_conv2d_nchw": ("depthwise_conv2d", {
        "Input": X_NCHW, "Filter": rand(7, 4, 1, 3, 3)},
        {"strides": [2, 1], "paddings": [1, 0, 2, 1]}, CONV_TOL),
    "depthwise_conv2d_nhwc_x2": ("depthwise_conv2d", {
        "Input": X_NHWC, "Filter": rand(8, 8, 1, 3, 3)},
        {"paddings": [1, 1], "data_format": "NHWC"}, CONV_TOL),
    "conv2d_transpose_s2": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(9, 4, 3, 3, 3)},
        {"strides": [2, 2], "paddings": [1, 1]}, CONV_TOL),
    "conv2d_transpose_output_padding": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(9, 4, 3, 3, 3)},
        {"strides": [2, 2], "paddings": [1, 1], "output_padding": [1, 1]},
        CONV_TOL),
    "conv2d_transpose_asym_dil": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(10, 4, 2, 3, 2)},
        {"strides": [2, 1], "paddings": [1, 0, 2, 1], "dilations": [2, 1]},
        CONV_TOL),
    "conv2d_transpose_groups": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(11, 4, 3, 3, 3)},
        {"strides": [2, 2], "paddings": [0, 0], "groups": 2}, CONV_TOL),
    "conv2d_transpose_same_s1": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(12, 4, 2, 4, 3)},
        {"padding_algorithm": "SAME", "dilations": [1, 2]}, CONV_TOL),
    "conv2d_transpose_valid_s1": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(13, 4, 2, 3, 3)},
        {"padding_algorithm": "VALID"}, CONV_TOL),
    "conv2d_transpose_neg_pad": ("conv2d_transpose", {
        "Input": X_NCHW, "Filter": rand(14, 4, 2, 3, 3)},
        {"strides": [2, 2], "paddings": [-1, 2]}, CONV_TOL),
    "conv2d_transpose_bf16": ("conv2d_transpose", {
        "Input": Bf16(X_NCHW), "Filter": Bf16(rand(15, 4, 3, 3, 3))},
        {"strides": [2, 2], "paddings": [1, 1], "output_padding": [1, 0]},
        BF16_TOL),
    "conv3d": ("conv3d", {"Input": rand(16, 2, 3, 5, 6, 5),
                          "Filter": rand(17, 4, 3, 3, 3, 2)},
               {"paddings": [1, 1, 0], "strides": [1, 2, 1]}, CONV_TOL),
    "conv3d_same_s2_groups": ("conv3d", {
        "Input": rand(18, 1, 4, 5, 6, 5), "Filter": rand(19, 4, 2, 2, 3, 3)},
        {"padding_algorithm": "SAME", "strides": [2, 2, 2], "groups": 2},
        CONV_TOL),
    "conv3d_asym_dil": ("conv3d", {"Input": rand(20, 1, 2, 6, 6, 6),
                                   "Filter": rand(21, 3, 2, 2, 2, 2)},
                        {"paddings": [1, 0, 0, 2, 1, 1],
                         "dilations": [2, 1, 2]}, CONV_TOL),
    # normalization
    "group_norm": ("group_norm", {"X": rand(22, 2, 6, 3, 4),
                                  "Scale": rand(23, 6), "Bias": rand(24, 6)},
                   {"groups": 3, "epsilon": 1e-5}, F32_TOL),
    "group_norm_mean100": ("group_norm", {"X": MEAN100}, {"groups": 2},
                           NORM100_TOL),
    "group_norm_bf16": ("group_norm", {"X": Bf16(rand(25, 2, 4, 3, 3))},
                        {"groups": 4}, BF16_TOL),
    "instance_norm": ("instance_norm", {"X": rand(26, 2, 3, 4, 5),
                                        "Scale": rand(27, 3),
                                        "Bias": rand(28, 3)}, {}, F32_TOL),
    "instance_norm_mean100": ("instance_norm", {"X": MEAN100},
                              {"epsilon": 1e-3}, NORM100_TOL),
    "norm": ("norm", {"X": rand(29, 3, 5, 2)}, {"axis": 1}, F32_TOL),
    "norm_zero_row": ("norm", {"X": np.concatenate(
        [np.zeros((1, 4), np.float32), rand(30, 2, 4)])},
        {"axis": -1, "epsilon": 1e-12}, F32_TOL),
    # embedding / one-hot
    "embedding_with_scaled_gradient": ("embedding_with_scaled_gradient", {
        "W": rand(31, 7, 3), "Ids": IDS}, {"padding_idx": 3}, EXACT),
    "one_hot_v2": ("one_hot_v2", {"X": IDS}, {"depth": 7}, EXACT),
    "one_hot": ("one_hot", {"X": IDS[..., None]}, {"depth": 5}, EXACT),
    "one_hot_int32_float": ("one_hot_v2", {"X": np.array(
        [1.0, 2.5, NAN, -0.0, 4.0], np.float32)}, {"depth": 5}, EXACT),
    # losses
    "cross_entropy_hard": ("cross_entropy", {"X": P_ZERO[:5],
                                             "Label": HARD}, {}, F32_TOL),
    "cross_entropy_ignore_2": ("cross_entropy", {
        "X": P_ZERO, "Label": np.array([1, 2, 2, 4, 2], np.int32)},
        {"ignore_index": 2}, F32_TOL),
    "cross_entropy_soft": ("cross_entropy", {"X": P_ZERO,
                                             "Label": _probs(32, 5, 6)},
                           {"soft_label": True}, F32_TOL),
    "cross_entropy_3d": ("cross_entropy", {
        "X": _probs(33, 2, 3, 4),
        "Label": np.array([[[0], [3], [1]], [[2], [-100], [0]]], np.int64)},
        {}, F32_TOL),
    "cross_entropy_bf16": ("cross_entropy", {"X": Bf16(P), "Label": np.array(
        [[1], [0], [5], [-100]], np.int64)}, {}, BF16_TOL),
    "cross_entropy2": ("cross_entropy2", {"X": P_ZERO[:5], "Label": HARD},
                       {}, F32_TOL),
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits", {
        "X": LOGITS, "Label": np.concatenate(
            [np.array([[1, 0, -100, 0.5, 1, 0, -100, 1]], np.float32),
             BIN[:, :8]], 1)}, {}, F32_TOL),
    "sigmoid_ce_normalize": ("sigmoid_cross_entropy_with_logits", {
        "X": rand(34, 2, 8), "Label": np.where(
            rand(35, 2, 8) > 0.5, -1.0, BIN.reshape(2, 8)).astype(
                np.float32)}, {"ignore_index": -1, "normalize": True},
        F32_TOL),
    "bce_loss": ("bce_loss", {"X": np.array([[0.0, 1.0, 0.3, 0.999]],
                                            np.float32),
                              "Label": np.array([[1.0, 0.0, 0.2, 1.0]],
                                                np.float32)}, {}, F32_TOL),
    "smooth_l1_loss": ("smooth_l1_loss", {"X": rand(36, 3, 4),
                                          "Y": rand(37, 3, 4)},
                       {"sigma": 2.0}, F32_TOL),
    "smooth_l1_loss_weights": ("smooth_l1_loss", {
        "X": rand(38, 3, 2, 2), "Y": rand(39, 3, 2, 2),
        "InsideWeight": rand(40, 3, 2, 2), "OutsideWeight": rand(41, 3, 2, 2)},
        {}, F32_TOL),
    "huber_loss": ("huber_loss", {"X": rand(42, 4, 3) * 2,
                                  "Y": rand(43, 4, 3)}, {"delta": 0.8},
                   F32_TOL),
    "log_loss": ("log_loss", {"Predicted": _probs(44, 4, 1) * 0 + np.array(
        [[0.0], [0.3], [0.9], [1.0]], np.float32),
        "Labels": np.array([[0.0], [1.0], [0.5], [1.0]], np.float32)},
        {"epsilon": 1e-4}, F32_TOL),
    **{f"kldiv_loss_{r}": ("kldiv_loss", {"X": rand(45, 2, 4),
                                          "Target": ZERO_T},
                           {"reduction": r}, F32_TOL)
       for r in ("mean", "sum", "batchmean", "none")},
    "label_smooth": ("label_smooth", {"X": np.eye(5, dtype=np.float32)[
        [0, 3, 1]]}, {"epsilon": 0.1}, F32_TOL),
    "label_smooth_prior": ("label_smooth", {
        "X": np.eye(4, dtype=np.float32)[[0, 3]],
        "PriorDist": np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)},
        {"epsilon": 0.25}, F32_TOL),
    "label_smooth_bf16": ("label_smooth", {"X": Bf16(np.eye(6)[[1, 5]])},
                          {"epsilon": 0.1}, BF16_TOL),
    "mse_loss": ("mse_loss", {"X": rand(46, 3, 4), "Y": rand(47, 3, 4)},
                 {}, F32_TOL),
    "margin_rank_loss": ("margin_rank_loss", {
        "X1": np.array([[1.0], [0.5], [2.0], [0.0]], np.float32),
        "X2": np.array([[0.5], [0.5], [1.0], [0.1]], np.float32),
        "Label": np.array([[1.0], [-1.0], [-1.0], [1.0]], np.float32)},
        {"margin": 0.1}, F32_TOL),
    # metrics
    "accuracy": ("accuracy", {
        "Out": rand(48, 5, 2), "Indices": np.array(
            [[1, 0], [2, 3], [0, 4], [4, 1], [3, 3]], np.int32),
        "Label": np.array([[0], [1], [4], [4], [2]], np.int64)}, {}, EXACT),
    "auc_roc": _auc_ins("ROC") + (F32_TOL,),
    "auc_pr": _auc_ins("PR") + (F32_TOL,),
}


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax(name):
    op, ins, attrs, tol = EMIT[name]
    if tol is EXACT:
        assert_emit_matches(op, ins, attrs, exact=True)
    else:
        assert_emit_matches(op, ins, attrs, exact=False, atol=tol[0],
                            rtol=tol[1])


_SHAPE_CASES = sorted({c[0]: n for n, c in sorted(EMIT.items())}.values())


@pytest.mark.parametrize("name", _SHAPE_CASES)
def test_shape_inference_matches_jax(name):
    op, ins, attrs, _ = EMIT[name]
    shape_inference_matches(op, ins, attrs)


@pytest.mark.parametrize("curve", ["ROC", "PR"])
def test_auc_buckets_nan_and_huge_scores_as_jax(curve):
    """NaN and -1e10 land in bucket 0, 1e10 and +inf in num_thresholds
    (XLA's saturating convert before the clip), the counts exactly."""
    op, ins, attrs = _auc_ins(curve)
    j, t = emit_jax(op, ins, attrs), emit_torch(op, ins, attrs)
    for slot in ("StatPosOut", "StatNegOut"):
        np.testing.assert_array_equal(t[slot][0].numpy(),
                                      np.asarray(j[slot][0]))
    pos = t["StatPosOut"][0].numpy() - STATS
    neg = t["StatNegOut"][0].numpy() - STATS[::-1]
    assert pos[10] == 1 and neg[0] == 3 and neg[10] == 1


def test_accuracy_dtypes_and_counts():
    op, ins, attrs, _ = EMIT["accuracy"]
    t = emit_torch(op, ins, attrs)
    assert [t[s][0].dtype for s in ("Accuracy", "Correct", "Total")] == [
        torch.float32, torch.int32, torch.int32]
    assert t["Correct"][0].item() == 3 and t["Total"][0].item() == 5


def test_one_hot_out_of_range_gives_zero_rows():
    t = emit_torch("one_hot_v2", {"X": IDS}, {"depth": 7})["Out"][0]
    assert t.sum(-1).tolist() == [[1.0, 1.0, 0.0], [0.0, 1.0, 0.0]]


def test_group_norm_variance_is_two_pass():
    """At mean 1e4 and std 1 the two-pass variance (jnp.var's, the port's)
    is within 1e-3 of the float64 one; E[x^2] - E[x]^2 in f32 is off by
    far more."""
    x = (1e4 + rand(5, 2, 4, 8, 8)).astype(np.float32)
    attrs = {"groups": 2}
    t = emit_torch("group_norm", {"X": x}, attrs)["Variance"][0].numpy()
    j = np.asarray(emit_jax("group_norm", {"X": x}, attrs)["Variance"][0])
    x64 = x.astype(np.float64).reshape(2, 2, -1)
    want = x64.var(-1)
    xg = torch.as_tensor(x).reshape(2, 2, -1)
    one_pass = ((xg * xg).mean(-1) - xg.mean(-1) ** 2).numpy()
    np.testing.assert_allclose(t, want, rtol=1e-3)
    np.testing.assert_allclose(j, want, rtol=1e-3)
    assert np.abs(one_pass - want).max() > 0.1


def test_conv2d_transpose_string_padding_raises_at_stride_2():
    ins = {"Input": X_NCHW, "Filter": rand(9, 4, 3, 3, 3)}
    attrs = {"strides": [2, 2], "padding_algorithm": "SAME"}
    with pytest.raises(ValueError, match="String padding"):
        emit_jax("conv2d_transpose", ins, attrs)
    with pytest.raises(ValueError, match="String padding"):
        emit_torch("conv2d_transpose", ins, attrs)


def test_conv2d_transpose_output_padding_appends_zeros():
    """The JAX emitter's output_padding: zeros after the last row and
    column, where the library's conv-transpose computes values."""
    op, ins, attrs, _ = EMIT["conv2d_transpose_output_padding"]
    t = emit_torch(op, ins, attrs)["Output"][0]
    assert (t[:, :, -1, :] == 0).all() and (t[:, :, :, -1] == 0).all()
    lib = torch.nn.functional.conv_transpose2d(
        torch.as_tensor(ins["Input"]), torch.as_tensor(ins["Filter"]),
        stride=2, padding=1, output_padding=1)
    assert lib.shape == t.shape and lib[:, :, -1].abs().max() > 0.1


# differentiable cases: name -> (output slot, tolerance)
GRAD = {
    "depthwise_conv2d_nchw": ("Output", CONV_TOL),
    "depthwise_conv2d_nhwc_x2": ("Output", CONV_TOL),
    "conv2d_transpose_s2": ("Output", CONV_TOL),
    "conv2d_transpose_output_padding": ("Output", CONV_TOL),
    "conv2d_transpose_asym_dil": ("Output", CONV_TOL),
    "conv2d_transpose_groups": ("Output", CONV_TOL),
    "conv2d_transpose_same_s1": ("Output", CONV_TOL),
    "conv2d_transpose_neg_pad": ("Output", CONV_TOL),
    "conv3d_same_s2_groups": ("Output", CONV_TOL),
    "conv3d_asym_dil": ("Output", CONV_TOL),
    "group_norm": ("Y", None), "instance_norm": ("Y", None),
    "norm_zero_row": ("Out", None),
    "embedding_with_scaled_gradient": ("Out", None),
    "cross_entropy_hard": ("Y", None), "cross_entropy_ignore_2": ("Y", None),
    "cross_entropy_soft": ("Y", None), "cross_entropy_3d": ("Y", None),
    "cross_entropy2": ("Y", None), "sigmoid_ce": ("Out", None),
    "sigmoid_ce_normalize": ("Out", None), "bce_loss": ("Out", None),
    "smooth_l1_loss_weights": ("Out", None), "huber_loss": ("Out", None),
    "log_loss": ("Loss", None), "kldiv_loss_mean": ("Loss", None),
    "kldiv_loss_none": ("Loss", None), "label_smooth_prior": ("Out", None),
    "mse_loss": ("Out", None), "margin_rank_loss": ("Out", None),
}


# held against the eager jax.vjp: compiled, XLA rewrites log(1 - p + eps)
# at p = 1, which moves dLabels by 1e-4
_EAGER_VJP = {"log_loss"}


@pytest.mark.parametrize("name", sorted(GRAD))
def test_gradient_matches_jax_vjp(name):
    op, ins, attrs, _ = EMIT[name]
    slot, tol = GRAD[name]
    tol = tol or (2e-6, 1e-6)
    assert_vjp_matches(op, ins, attrs, slot, atol=tol[0], rtol=tol[1],
                       jit=name not in _EAGER_VJP)


def test_ignored_and_out_of_range_labels_take_no_gradient():
    """At the ignored label -100 and at a label past the classes the
    gradient is 0 in every class (jnp.take_along_axis drops it; torch's
    gather would raise), and the loss 0 and NaN."""
    x = torch.as_tensor(P_ZERO[:5]).requires_grad_()
    y = treg.get("cross_entropy").emit(
        treg.EmitContext(), {"X": [x], "Label": [torch.as_tensor(HARD)]},
        {})["Y"][0]
    assert y[1].item() == 0.0 and torch.isnan(y[3]).all()
    torch.where(torch.isnan(y), 0.0, y).sum().backward()
    assert (x.grad[1] == 0).all() and (x.grad[3] == 0).all()
    assert x.grad[0, 2] != 0 and x.grad[2, 5] != 0    # -1 wraps to 5


def test_kldiv_gradient_where_the_target_is_zero():
    """-0.0 to X and NaN to Target, as JAX's where passes its zero
    cotangent through log(0)."""
    x = torch.as_tensor(rand(45, 2, 4)).requires_grad_()
    t = torch.as_tensor(ZERO_T).requires_grad_()
    treg.get("kldiv_loss").emit(treg.EmitContext(), {"X": [x], "Target": [t]},
                                {"reduction": "sum"})["Loss"][0].backward()
    zero = torch.as_tensor(ZERO_T) == 0
    assert (x.grad[zero] == 0).all() and x.grad[zero].signbit().all()
    assert torch.isnan(t.grad[zero]).all()


def test_max_gradient_is_lax_s_product_rule():
    """Repaired: lax.max's derivative is the cotangent times 0 / 0.5 / 1,
    so an infinite cotangent gives NaN to the operand that lost (the
    port's select gave 0).  elementwise_max then log at 0."""
    x = np.array([0.0, 2.0, 1.0], np.float32)
    y = np.array([-1.0, 3.0, 1.0], np.float32)
    import jax
    import jax.numpy as jnp

    want = jax.grad(lambda a, b: jnp.log(jreg.get("elementwise_max").emit(
        jreg.EmitContext(), {"X": [a], "Y": [b]}, {})["Out"][0]).sum(),
        (0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.as_tensor(x).requires_grad_()
    yt = torch.as_tensor(y).requires_grad_()
    torch.log(treg.get("elementwise_max").emit(
        treg.EmitContext(), {"X": [xt], "Y": [yt]}, {})["Out"][0]).sum() \
        .backward()
    for got, w in zip((xt.grad, yt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
    assert torch.isnan(yt.grad[0])


@pytest.mark.parametrize("op,x,y,neg", [
    ("elementwise_max", -0.0, 0.0, False), ("elementwise_max", 0.0, -0.0,
                                            False),
    ("elementwise_max", -0.0, -0.0, True), ("elementwise_min", 0.0, -0.0,
                                            True),
    ("elementwise_min", -0.0, 0.0, True), ("elementwise_min", 0.0, 3.0,
                                           False)])
def test_elementwise_extremes_sign_zeros_as_xla(op, x, y, neg):
    """Repaired: XLA's max and min order -0.0 below +0.0; torch.maximum /
    minimum returned whichever zero came first."""
    ins = {"X": np.array([x], np.float32), "Y": np.array([y], np.float32)}
    assert_emit_matches(op, ins, {}, exact=True)
    assert bool(emit_torch(op, ins, {})["Out"][0].signbit()) == neg


# ---------------------------------------------------------------------------
# the fluid.layers callables
# ---------------------------------------------------------------------------


def _build(fluid, body):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [2, 4, 6, 6], "float32", append_batch_size=False)
        p = L.data("p", [8, 10], "float32", append_batch_size=False)
        lbl = L.data("lbl", [8, 1], "int64", append_batch_size=False)
        body(fluid, L, x, p, lbl)

    def ops(prog):
        return [(op.type, op.inputs, op.outputs,
                 {k: v for k, v in op.attrs.items()
                  if not k.startswith("__")})
                for op in prog.global_block().ops]

    vs = {n: (v.shape, str(v.dtype), v.stop_gradient, v.persistable)
          for n, v in main.global_block().vars.items()}
    return ops(main), ops(startup), vs


def _head(fluid, L, x, p, lbl):
    """The image-classification recipe's head: one_hot -> label_smooth ->
    softmax -> cross_entropy(soft) -> mean; accuracy at k 1 and 5."""
    sm = L.softmax(p)
    smooth = L.label_smooth(L.one_hot(lbl, 10), epsilon=0.1)
    L.mean(L.cross_entropy(sm, smooth, soft_label=True))
    L.accuracy(sm, lbl, k=1)
    L.accuracy(sm, lbl, k=5)
    L.cross_entropy(sm, lbl, ignore_index=3)


LAYERS = {
    "head": _head,
    "losses": lambda f, L, x, p, lbl: (
        L.sigmoid_cross_entropy_with_logits(p, p, -1, normalize=True),
        L.smooth_l1(p, p, p, p, 3.0), L.smooth_l1(p, p),
        L.huber_loss(p, p, 0.5), L.kldiv_loss(p, p, "batchmean"),
        L.log_loss(p, p, 1e-3), L.label_smooth(p, L.reduce_mean(p, 0),
                                               0.2),
        L.one_hot(L.reshape(lbl, [8]), 4)),
    "norms": lambda f, L, x, p, lbl: (
        L.group_norm(x, 2, act="relu"),
        L.group_norm(x, 4, param_attr=False, bias_attr=False),
        L.instance_norm(x, 1e-3), L.l2_normalize(p, 1)),
    "convs": lambda f, L, x, p, lbl: (
        L.conv2d_transpose(x, 6, filter_size=3, stride=2, padding=1,
                           act="relu"),
        L.conv2d_transpose(x, 4, output_size=13, stride=2, groups=2,
                           param_attr=f.ParamAttr(
                               initializer=f.initializer.Bilinear())),
        L.conv2d(x, 5, 3, param_attr=f.ParamAttr(
            initializer=f.initializer.MSRA(uniform=False))),
        L.conv2d(x, 5, 3, param_attr=f.ParamAttr(
            initializer=f.initializer.MSRAInitializer(fan_in=12))),
        L.adaptive_pool2d(x, 3, "avg"), L.adaptive_pool2d(x, [4, 2])),
    "reductions_shape": lambda f, L, x, p, lbl: (
        L.reduce_min(x, [1, 2], keep_dim=True), L.reduce_prod(p),
        L.reduce_all(L.cast(p, "bool"), 0), L.reduce_any(
            L.cast(p, "bool")), L.shape(x)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_same_ops_as_jax(name):
    """Same ops in the main and startup programs (types, slots,
    attributes) and the same vars (shapes, dtypes, stop_gradient,
    persistable) as the JAX package's layers."""
    assert _build(tfluid, LAYERS[name]) == _build(jfluid, LAYERS[name])


def test_layers_exported_and_ops_registered():
    L = tfluid.layers
    names = ("accuracy", "adaptive_pool2d", "conv2d_transpose",
             "cross_entropy", "group_norm", "huber_loss", "instance_norm",
             "kldiv_loss", "l2_normalize", "label_smooth", "log_loss",
             "one_hot", "reduce_all", "reduce_any", "reduce_min",
             "reduce_prod", "shape", "sigmoid_cross_entropy_with_logits",
             "smooth_l1", "unique_name_layer", "auc")
    assert [n for n in names if not hasattr(L, n)] == []
    with pytest.raises(NotImplementedError):
        L.unique_name_layer()
    assert set(treg.registered_ops()) >= {
        o for o in jreg.registered_ops()
        if jreg.get(o).emit.__module__ == "paddle_tpu.ops.nn_ops"}


def test_auc_layer_matches_jax_and_accumulates():
    """The auc layer's program, and two runs of it on one scope: the stat
    buffers carry the first batch's counts into the second, as the JAX
    package's do."""
    from paddle_tpu.fluid.layers import misc as jmisc
    from paddle_tpu_torch.fluid.layers import misc as tmisc

    def build(fluid, misc):
        misc._suffix_counter[0] = 0
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            pr = L.data("pr", [8, 2], "float32", append_batch_size=False)
            lb = L.data("lb", [8, 1], "int64", append_batch_size=False)
            out, stats = L.auc(pr, lb, num_thresholds=10)
        return main, startup, out, stats

    jm, js, jo, jst = build(jfluid, jmisc)
    tm, ts, to, tst = build(tfluid, tmisc)
    assert [s.name for s in tst] == [s.name for s in jst] == [
        "auc_stat_pos_1", "auc_stat_neg_2"]
    feed = {"pr": np.clip(np.abs(SCORES), 0, 1).astype(np.float32),
            "lb": AUC_LABEL}
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    texe, tscope = tfluid.Executor(device="cpu"), tfluid.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    for _ in range(2):
        want = jexe.run(jm, feed=feed, fetch_list=[jo] + jst, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[to] + tst, scope=tscope)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
    assert np.asarray(got[1]).sum() == 2 * AUC_LABEL.sum()
