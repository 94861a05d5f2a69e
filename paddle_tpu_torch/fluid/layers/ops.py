"""Unary layers (reference layers/ops.py pattern): the activations BERT,
ResNet and the Transformer NMT use (tanh, gelu, relu, exp, log), and the
math the learning-rate schedules build with (floor, ceil, cos, pow,
...).  Ported from the JAX package's ``fluid/layers/ops.py``."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def _unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


tanh = _unary("tanh")
relu = _unary("relu")
exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
abs = _unary("abs")
ceil = _unary("ceil")
floor = _unary("floor")
round = _unary("round")
cos = _unary("cos")
sin = _unary("sin")
square = _unary("square")
reciprocal = _unary("reciprocal")


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out


def gelu(x, approximate=False):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out
