"""AMP op lists.

Parity: python/paddle/fluid/contrib/mixed_precision/fp16_lists.py in the
reference; ported from the JAX package's ``contrib/mixed_precision/
fp16_lists.py`` with the same lists (ops the port does not register yet
match nothing).  White = compute in low precision (tensor-core ops),
black = keep float32
(reductions / loss / normalization statistics), gray = follow neighbors
(here: left untouched; mixed-dtype elementwise promotes to f32 naturally).
"""
from __future__ import annotations


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)


white_list = {
    "matmul",
    "matmul_v2",
    "mul",
    "conv2d",
    "conv3d",
    "depthwise_conv2d",
    "conv2d_transpose",
    "fused_multihead_attention",
    # the whole fused stack runs in bf16; its emitter keeps layer_norm and
    # softmax internals in f32 (ops/encoder_stack.py), so this is safe
    "fused_encoder_stack",
    "fused_decoder_stack",
    "fc",
    # these emitters compute statistics in f32 internally (ops/nn_ops.py),
    # so bf16 in/out only halves the residual-stream bandwidth
    "layer_norm",
    "batch_norm",
    # fused conv+BN(+relu): conv in bf16, statistics and the normalize
    # chain in f32 inside the kernel
    "fused_conv_bn",
}

black_list = {
    "softmax_with_cross_entropy",
    "cross_entropy",
    "cross_entropy2",
    "group_norm",
    "instance_norm",
    "reduce_sum",
    "reduce_mean",
    "mean",
    "sum",
    "softmax",
    "log_softmax",
    "exp",
    "square",
    "sigmoid_cross_entropy_with_logits",
    "bce_loss",
    "squared_l2_norm",
}
