"""Tensor-creation layers: data, create_parameter, fill_constant, cast.

Parity surface: python/paddle/fluid/layers/tensor.py in the reference;
ported from the JAX package's ``fluid/layers/tensor.py``.
"""
from __future__ import annotations

from .. import framework
from ..dtypes import convert_dtype
from ..layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """fluid.layers.data — prepends a -1 batch dim unless told otherwise."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    shape = [-1 if s is None else int(s) for s in shape]
    block = framework.default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, is_data=True,
                            stop_gradient=True)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name, param_attr=attr)
    attr = helper.param_attr
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
               "value": float(value)},
    )
    out.stop_gradient = True
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": convert_dtype(dtype)})
    return out
