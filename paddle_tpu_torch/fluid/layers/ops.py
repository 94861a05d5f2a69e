"""Unary activation layers (reference layers/ops.py pattern), the ones
BERT, ResNet and the Transformer NMT use: tanh, gelu, relu, exp and log.  Ported from the JAX package's
``fluid/layers/ops.py``."""
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


def gelu(x, approximate=False):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out
