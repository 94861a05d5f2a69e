"""Neural network layers (the ``fluid.layers.*`` DSL): the ones BERT,
ResNet and the hapi models build with, and the shape, selection and
math layers over ``ops/manipulation.py`` and ``ops/math_ops.py``
(split, stack, squeeze, topk, cumsum, pad, scatter, prelu, log_softmax,
cos_sim, clip, ...), and the losses, metrics, norms and convolutions
over ``ops/nn_ops.py`` (cross_entropy, one_hot, label_smooth, accuracy,
group_norm, instance_norm, l2_normalize, conv2d_transpose,
adaptive_pool2d, ...) with the reductions and ``shape``.

Parity surface: python/paddle/fluid/layers/nn.py in the reference;
ported from the JAX package's ``fluid/layers/nn.py``.  Each function
appends ops through LayerHelper with the same op types, slots and attrs
as the JAX package, so both packages build the same Program.
``unique_name_layer`` is the JAX package's stub, which raises.
"""
from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer (reference layers/nn.py fc). Multiple inputs
    sum."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = helper.multiple_input()
    dtype = helper.input_dtype()
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        flat = int(np.prod([abs(d) for d in inp.shape[num_flatten_dims:]]))
        w = helper.create_parameter(pattr, shape=[flat, size], dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference layers/nn.py embedding (lookup_table_v2)."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None
                   else padding_idx if padding_idx >= 0
                   else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table_v2",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse},
    )
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """2-D convolution; the filter is OIHW whatever ``data_format``, drawn
    from N(0, sqrt(2 / (kh * kw * C)))."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype,
                                default_initializer=NormalInitializer(0.0,
                                                                      std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "data_format": data_format},
    )
    if data_format == "NCHW":
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    else:
        pre_act = helper.append_bias_op(pre_bias, dim_start=3)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 2-D convolution, NCHW, filter [C, num_filters / groups,
    kh, kw]; the filter size from ``output_size`` when not given."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    if filter_size is None:
        if output_size is None:
            raise ValueError("either filter_size or output_size must be set")
        if isinstance(output_size, int):
            output_size = [output_size, output_size]
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1,
        ]
    elif isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    filter_shape = [num_channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format},
    )
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "adaptive": True},
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Batch normalisation: Scale and Bias are trainable; the moving Mean
    and Variance are non-trainable persistables (stop_gradient), read and
    written back by the op under the same names."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, shape=[channels], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[channels],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name,
                  initializer=ConstantInitializer(0.0), trainable=False),
        shape=[channels], dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name,
                  initializer=ConstantInitializer(1.0), trainable=False),
        shape=[channels], dtype=dtype)
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats},
    )
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = list(input.shape[begin_norm_axis:])
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=norm_shape, dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def _scale_bias_inputs(helper, input, dtype):
    """X with the Scale (ones) and Bias parameters a norm layer takes,
    each left out where its attr is False."""
    channels = input.shape[1]
    inputs = {"X": [input]}
    if helper.param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr, shape=[channels], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if helper.bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=[channels], dtype=dtype, is_bias=True)]
    return inputs


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    inputs = _scale_bias_inputs(helper, input, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="group_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"groups": groups, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = input.dtype
    inputs = _scale_bias_inputs(helper, input, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    sm = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    sv = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="instance_norm",
        inputs=inputs,
        outputs={"Y": [out], "SavedMean": [sm], "SavedVariance": [sv]},
        attrs={"epsilon": epsilon},
    )
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8",
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation},
    )
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def one_hot(input, depth, allow_out_of_range=False):
    """float32 one-hot rows (zero for an id outside [0, depth)); the op is
    ``one_hot`` for ids with a trailing dim of 1, else ``one_hot_v2``."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    op_type = ("one_hot" if (input.shape and input.shape[-1] == 1)
               else "one_hot_v2")
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    out.stop_gradient = True
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: ``top_k`` then ``accuracy`` (Accuracy f32, Correct
    and Total int32)."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]},
    )
    acc_out.stop_gradient = True
    return acc_out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_min = _elementwise("elementwise_min")
elementwise_max = _elementwise("elementwise_max")
elementwise_pow = _elementwise("elementwise_pow")
elementwise_mod = _elementwise("elementwise_mod")
elementwise_floordiv = _elementwise("elementwise_floordiv")


def where(condition, x=None, y=None):
    """paddle.where / fluid.layers.where: the elementwise select."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)},
    )
    return out


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            if isinstance(dim, int):
                dim = [dim]
            attrs = {"dim": list(dim), "keep_dim": keep_dim}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    nrm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [nrm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand_as",
                     inputs={"X": [x], "target_tensor": [target_tensor]},
                     outputs={"Out": [out]})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)},
    )
    return out


# build-time salt of each attention op's dropout draw (the JAX package's
# counter): one per fused_multihead_attention layer call
_rng_salt_counter = [0]


def fused_multihead_attention(q, k, v, attn_bias=None, num_heads=1,
                              dropout_prob=0.0, is_test=False, causal=False,
                              name=None):
    """Fused scaled-dot-product attention over head-interleaved [B, S, H]
    tensors (ops/attention.py).  causal=True masks future positions."""
    helper = LayerHelper("fused_multihead_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    _rng_salt_counter[0] += 1
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["BiasQK"] = [attn_bias]
    helper.append_op(
        type="fused_multihead_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"num_heads": num_heads, "dropout_prob": dropout_prob,
               "is_test": is_test, "causal": bool(causal),
               "rng_salt": _rng_salt_counter[0]},
    )
    return out


def moe_ffn(input, num_experts, expert_hidden, top_k=2, capacity_factor=1.25,
            act="gelu", param_attr=None, name=None):
    """Mixture-of-Experts FFN (ops/moe_ops.py): top-k router, capacity-
    bounded dispatch, a two-layer FFN per expert; the expert dim of its
    weights shards over an "ep" mesh axis
    (DistributedStrategy.expert_parallel).

    input: [B, S, H].  Returns (out [B, S, H], aux_loss [] scalar); add
    ``aux_weight * aux_loss`` to the training loss to keep experts
    balanced."""
    helper = LayerHelper("moe_ffn", input=input, param_attr=param_attr,
                         name=name)
    dtype = helper.input_dtype()
    h = input.shape[-1]
    e, f = num_experts, expert_hidden

    def _param(suffix, shape, is_bias=False):
        attr = ParamAttr._to_attr(param_attr)
        # biases stay zero-initialised whatever the weights' initializer,
        # as the dense FFN's fc biases
        init = attr.initializer if (attr and not is_bias) else None
        attr = ParamAttr(name=f"{name or helper.name}_{suffix}",
                         initializer=init)
        return helper.create_parameter(attr, shape=shape, dtype=dtype,
                                       is_bias=is_bias)

    gate_w = _param("gate.w_0", [h, e])
    w1 = _param("expert.w1", [e, h, f])
    b1 = _param("expert.b1", [e, f], is_bias=True)
    w2 = _param("expert.w2", [e, f, h])
    b2 = _param("expert.b2", [e, h], is_bias=True)

    out = helper.create_variable_for_type_inference(dtype)
    aux = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [input], "GateW": [gate_w], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"top_k": int(top_k), "capacity_factor": float(capacity_factor),
               "activation": act})
    return out, aux


def _one_out(op_type, x, attrs, name=None, layer=None, ins=None,
             out_slot="Out"):
    """Append ``op_type`` over X (or ``ins``) with one output (``Out``) in
    X's dtype."""
    helper = LayerHelper(layer or op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs=ins or {"X": [x]},
                     outputs={out_slot: [out]}, attrs=attrs)
    return out


def log_softmax(input, axis=-1, name=None):
    return _one_out("log_softmax", input, {"axis": axis}, name)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _one_out("mul", x, {"x_num_col_dims": x_num_col_dims,
                               "y_num_col_dims": y_num_col_dims}, name,
                    ins={"X": [x], "Y": [y]})


def clip(x, min, max, name=None):
    return _one_out("clip", x, {"min": float(min), "max": float(max)}, name)


def clip_by_norm(x, max_norm, name=None):
    return _one_out("clip_by_norm", x, {"max_norm": float(max_norm)}, name)


def _with_xshape(op_type, x, attrs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]}, attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _with_xshape("squeeze2", input, {"axes": list(axes)}, name)


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", x, {"axis": axis}, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    axis = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections, n_out = num_or_sections, [], num_or_sections
    else:
        num, sections = 0, list(num_or_sections)
        n_out = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": axis, "num": num, "sections": sections})
    return outs


def stack(x, axis=0, name=None):
    helper = LayerHelper("stack", name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    return _one_out("expand", x, {"expand_times": list(expand_times)}, name)


def gather_nd(input, index, name=None):
    return _one_out("gather_nd", input, {}, name,
                    ins={"X": [input], "Index": [index]})


def scatter(input, index, updates, name=None, overwrite=True):
    return _one_out("scatter", input, {"overwrite": overwrite}, name,
                    ins={"X": [input], "Ids": [index],
                         "Updates": [updates]})


def scatter_nd_add(ref, index, updates, name=None):
    return _one_out("scatter_nd_add", ref, {}, name,
                    ins={"X": [ref], "Index": [index],
                         "Updates": [updates]})


def pad(x, paddings, pad_value=0.0, name=None):
    return _one_out("pad", x, {"paddings": list(paddings),
                               "pad_value": float(pad_value)}, name)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _one_out("pad2d", input, {"paddings": list(paddings),
                                     "mode": mode,
                                     "pad_value": float(pad_value),
                                     "data_format": data_format}, name)


def strided_slice(input, axes, starts, ends, strides):
    return _one_out("strided_slice", input, {
        "axes": list(axes), "starts": list(starts), "ends": list(ends),
        "strides": list(strides)}, ins={"Input": [input]})


def cumsum(x, axis=None, exclusive=None, reverse=None):
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    return _one_out("cumsum", x, attrs)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity (reference layers cos_sim)."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": float(delta)})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    return _one_out("kldiv_loss", x, {"reduction": reduction}, name,
                    ins={"X": [x], "Target": [target]}, out_slot="Loss")


def log_loss(input, label, epsilon=1e-4, name=None):
    return _one_out("log_loss", input, {"epsilon": float(epsilon)}, name,
                    ins={"Predicted": [input], "Labels": [label]},
                    out_slot="Loss")


def unique_name_layer():  # the JAX package's placeholder stub
    raise NotImplementedError
