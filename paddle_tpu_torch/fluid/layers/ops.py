"""Unary activation layers (reference layers/ops.py pattern), the ones
BERT uses: tanh and gelu.  Ported from the JAX package's
``fluid/layers/ops.py``."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def tanh(x, name=None):
    helper = LayerHelper("tanh", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="tanh", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def gelu(x, approximate=False):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out
