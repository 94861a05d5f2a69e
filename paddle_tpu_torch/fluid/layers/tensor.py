"""Tensor-creation layers: data, create_parameter, fill_constant, cast,
assign; and the comparison and logical layers and increment, which the
learning-rate schedules and the meta-optimizers build with.

Parity surface: python/paddle/fluid/layers/tensor.py in the reference;
ported from the JAX package's ``fluid/layers/tensor.py``.
"""
from __future__ import annotations

import numpy as np

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


def assign(input, output=None):
    """Copy a Variable (``assign``) or a numpy array (``assign_value``,
    its values held in the op's attrs) into ``output``."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={"shape": list(input.shape),
                   "dtype": convert_dtype(input.dtype),
                   "values": input.flatten().tolist()})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


# -- comparisons (reference layers/control_flow.py less_than etc.) ----------


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    cond.stop_gradient = True
    return cond


def less_than(x, y, cond=None, name=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None, name=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None, name=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None, name=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None, name=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None, name=None):
    return _compare("not_equal", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _compare("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _compare("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _compare("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def increment(x, value=1.0, in_place=True):
    """reference layers/control_flow.py increment: the step bump."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
