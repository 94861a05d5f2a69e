"""Unary activation layers (reference layers/ops.py pattern: the
``__activations_noattr__`` layers generated from a list of op types),
and the activations with attributes (leaky_relu, elu, relu6, swish, the
hard and soft shrinks, ...).  Ported from the JAX package's
``fluid/layers/ops.py``: the same 31 generated layers and the same
attributed ones, each appending one op of its name."""
from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt", "abs",
    "ceil", "floor", "round", "cos", "sin", "tan", "acos", "asin", "atan",
    "sinh", "cosh", "square", "reciprocal", "softplus", "softsign",
    "logsigmoid", "erf", "mish", "sign", "silu", "log2", "log10", "log1p",
]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)


def _act(op_type, x, attrs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def gelu(x, approximate=False):
    return _act("gelu", x, {"approximate": approximate})


def leaky_relu(x, alpha=0.02, name=None):
    return _act("leaky_relu", x, {"alpha": alpha}, name)


def elu(x, alpha=1.0, name=None):
    return _act("elu", x, {"alpha": alpha}, name)


def relu6(x, threshold=6.0, name=None):
    return _act("relu6", x, {"threshold": threshold}, name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _act("hard_sigmoid", x, {"slope": slope, "offset": offset}, name)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _act("hard_swish", x, {"threshold": threshold, "scale": scale,
                                  "offset": offset}, name)


def swish(x, beta=1.0, name=None):
    return _act("swish", x, {"beta": beta}, name)


def pow(x, factor=1.0, name=None):
    return _act("pow", x, {"factor": factor}, name)


def soft_shrink(x, alpha=0.5):
    return _act("soft_shrink", x, {"lambda": alpha})


def hard_shrink(x, threshold=0.5):
    return _act("hard_shrink", x, {"threshold": threshold})


def thresholded_relu(x, threshold=1.0):
    return _act("thresholded_relu", x, {"threshold": threshold})


def maxout(x, groups, name=None):
    return _act("maxout", x, {"groups": groups}, name)
