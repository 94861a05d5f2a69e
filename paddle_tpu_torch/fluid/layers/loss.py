"""Loss layers built as compositions over the op set: mse_loss,
dice_loss, bpr_loss, center_loss, rank_loss, margin_rank_loss,
npair_loss, sigmoid_focal_loss, teacher_student_sigmoid_loss,
sampled_softmax_with_cross_entropy.

Parity surface: reference python/paddle/fluid/layers/loss.py + nn.py
loss entries; ported from the JAX package's ``fluid/layers/loss.py``,
all ten: each builds the same ops with the same attrs as the JAX layer.
Every loss is ordinary ops (the reference's dedicated loss kernels have
no counterpart here).
"""
from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import nn as _nn
from . import ops as _ops
from . import tensor as _tensor

__all__ = [
    "mse_loss", "dice_loss", "bpr_loss", "center_loss",
    "rank_loss", "margin_rank_loss", "npair_loss", "sigmoid_focal_loss",
    "teacher_student_sigmoid_loss", "sampled_softmax_with_cross_entropy",
]


def mse_loss(input, label):
    """mean((input - label)^2) (reference mse_loss)."""
    return _nn.reduce_mean(_nn.square_error_cost(input, label))


def _one_hot_of(label, n):
    return _nn.one_hot(_nn.squeeze(label, axes=[-1]), n)


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2|X n Y| / (|X| + |Y|) over the trailing class dim (reference
    dice_loss): input [N, ..., C] probabilities, label [N, ..., 1] ids."""
    one_hot = _one_hot_of(label, input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inter = _nn.reduce_sum(_nn.elementwise_mul(input, one_hot),
                           dim=reduce_dims)
    union = _nn.elementwise_add(_nn.reduce_sum(input, dim=reduce_dims),
                                _nn.reduce_sum(one_hot, dim=reduce_dims))
    dice = _nn.elementwise_div(_nn.scale(inter, scale=2.0),
                               _nn.scale(union, bias=epsilon))
    return _nn.reduce_mean(_nn.scale(dice, scale=-1.0, bias=1.0))


def bpr_loss(input, label, name=None):
    """Bayesian personalized ranking loss (reference bpr_loss_op.cc): per
    row [N, 1], -mean over j != y of log(sigmoid(x_y - x_j))."""
    n = input.shape[-1]
    pos = _nn.reduce_sum(
        _nn.elementwise_mul(input, _one_hot_of(label, n)),
        dim=[-1], keep_dim=True)
    diff = _nn.elementwise_sub(pos, input)  # [B, C]: x_y - x_j
    # log(sigmoid(d)) = -softplus(-d)
    logsig = _nn.scale(_ops.softplus(_nn.scale(diff, scale=-1.0)),
                       scale=-1.0)
    mask = _nn.scale(_one_hot_of(label, n), scale=-1.0, bias=1.0)
    per_row = _nn.elementwise_div(
        _nn.reduce_sum(_nn.elementwise_mul(logsig, mask), dim=[-1],
                       keep_dim=True),
        _tensor.fill_constant([1], input.dtype, float(n - 1)))
    return _nn.scale(per_row, scale=-1.0)


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """Distance to per-class centers (reference center_loss_op.cc): the
    value is 0.5 ||x - c||^2 a row ([N, 1]) against stop-gradient
    centers, plus (``update_center``) a term of value zero, alpha * 0.5 ||
    sg(x) - c||^2 - sg(the same), whose gradient alpha (c - x) moves the
    centers at rate alpha times the optimizer's."""
    helper = LayerHelper("center_loss", param_attr=param_attr)
    dtype = input.dtype
    centers = helper.create_parameter(
        ParamAttr(name=f"{helper.name}.centers"),
        shape=[num_classes, input.shape[-1]], dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    picked = _nn.gather(centers, _nn.squeeze(label, axes=[-1]))
    picked_sg = _tensor.assign(picked)
    picked_sg.stop_gradient = True
    loss = _nn.scale(
        _nn.reduce_sum(_ops.square(_nn.elementwise_sub(input, picked_sg)),
                       dim=[-1], keep_dim=True), scale=0.5)
    if update_center:
        x_sg = _tensor.assign(input)
        x_sg.stop_gradient = True
        cterm = _nn.scale(
            _nn.reduce_sum(_ops.square(_nn.elementwise_sub(x_sg, picked)),
                           dim=[-1], keep_dim=True),
            scale=0.5 * float(alpha))
        cterm_sg = _tensor.assign(cterm)
        cterm_sg.stop_gradient = True
        loss = _nn.elementwise_sub(_nn.elementwise_add(loss, cterm),
                                   cterm_sg)
    return loss


def rank_loss(label, left, right, name=None):
    """RankNet pairwise loss (reference rank_loss_op.cc): the mean of
    log(1 + e^o) - t o with o = left - right."""
    o = _nn.elementwise_sub(left, right)
    return _nn.reduce_mean(
        _nn.elementwise_sub(_ops.softplus(o), _nn.elementwise_mul(label, o)))


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label], "X1": [left], "X2": [right]},
        outputs={"Out": [out]},
        attrs={"margin": float(margin)},
    )
    return out


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair metric loss (reference npair_loss composition)."""
    b = anchor.shape[0]
    labels = _nn.reshape(labels, [b, 1])
    eq = _tensor.cast(_tensor.equal(labels, _nn.transpose(labels, [1, 0])),
                      anchor.dtype)
    target = _nn.elementwise_div(eq, _nn.reduce_sum(eq, dim=[1],
                                                    keep_dim=True))
    logits = _nn.matmul(anchor, positive, transpose_y=True)
    xent = _nn.softmax_with_cross_entropy(logits, target, soft_label=True)
    l2 = _nn.scale(
        _nn.elementwise_add(
            _nn.reduce_mean(_nn.reduce_sum(_ops.square(anchor), dim=[1])),
            _nn.reduce_mean(_nn.reduce_sum(_ops.square(positive), dim=[1]))),
        scale=l2_reg * 0.25)
    return _nn.elementwise_add(_nn.reduce_mean(xent), l2)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """Focal loss (reference sigmoid_focal_loss_op.cc): x [N, C] logits,
    label [N, 1] int (0 the background, class c -> column c - 1), fg_num
    [1] the normalizer."""
    c = x.shape[-1]
    # one-hot over C + 1, column 0 (the background) dropped
    pos = _nn.slice(_one_hot_of(label, c + 1), axes=[1], starts=[1],
                    ends=[c + 1])
    p = _ops.sigmoid(x)
    ce_pos = _ops.softplus(_nn.scale(x, scale=-1.0))   # -log(sigmoid)
    ce_neg = _ops.softplus(x)                           # -log(1 - sigmoid)
    w_pos = _nn.elementwise_pow(_nn.scale(p, scale=-1.0, bias=1.0),
                                _tensor.fill_constant([1], x.dtype, gamma))
    w_neg = _nn.elementwise_pow(p, _tensor.fill_constant([1], x.dtype,
                                                         gamma))
    loss = _nn.elementwise_add(
        _nn.elementwise_mul(
            _nn.elementwise_mul(pos, _nn.elementwise_mul(w_pos, ce_pos)),
            _tensor.fill_constant([1], x.dtype, alpha)),
        _nn.elementwise_mul(
            _nn.elementwise_mul(_nn.scale(pos, scale=-1.0, bias=1.0),
                                _nn.elementwise_mul(w_neg, ce_neg)),
            _tensor.fill_constant([1], x.dtype, 1.0 - alpha)))
    fg = _nn.elementwise_max(_tensor.cast(fg_num, x.dtype),
                             _tensor.fill_constant([1], x.dtype, 1.0))
    return _nn.elementwise_div(loss, fg)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Distillation loss (reference teacher_student_sigmoid_loss_op.cc) in
    its closed form for labels in [0, 1]: log(1 + e^z) - z label, z the
    input clipped to the bounds."""
    z = _nn.clip(input, soft_max_lower_bound, soft_max_up_bound)
    return _nn.elementwise_sub(_ops.softplus(z),
                               _nn.elementwise_mul(z, label))


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Softmax cross-entropy over the true class and ``num_samples``
    uniformly sampled negatives (reference
    sampled_softmax_with_cross_entropy_op.cc, uniform sampler).  The
    negatives are drawn at build time from ``RandomState(seed)``, as the
    JAX package draws them, and enter the program as a constant."""
    c = logits.shape[-1]
    rng = np.random.RandomState(seed or 0)
    sampled = rng.randint(0, c, size=[num_samples]).astype("int64")
    samp_var = _tensor.assign(sampled)
    neg = _nn.transpose(_nn.gather(_nn.transpose(logits, [1, 0]), samp_var),
                        [1, 0])  # [B, S]
    pos = _nn.reduce_sum(
        _nn.elementwise_mul(logits, _one_hot_of(label, c)),
        dim=[-1], keep_dim=True)  # [B, 1]
    if remove_accidental_hits:
        # a sampled column equal to the true label is pushed down by 1e9
        hit = _tensor.cast(
            _tensor.equal(
                _nn.expand_as(label, neg),
                _nn.expand_as(_nn.reshape(samp_var, [1, num_samples]), neg)),
            logits.dtype)
        neg = _nn.elementwise_sub(neg, _nn.scale(hit, scale=1e9))
    joined = _tensor.concat([pos, neg], axis=1)  # the true class: column 0
    zeros = _tensor.fill_constant([logits.shape[0], 1], "int64", 0)
    return _nn.softmax_with_cross_entropy(joined, zeros)
