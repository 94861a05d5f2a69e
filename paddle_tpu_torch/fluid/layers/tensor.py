"""Tensor layers: creation (data, create_parameter, fill_constant,
zeros, ones, ...), cast, assign, concat; the comparison and logical
layers and increment, which the learning-rate schedules and the
meta-optimizers build with; the selection, sorting and linear-algebra
layers over ``ops/manipulation.py`` and ``ops/math_ops.py`` (argmax,
argsort, flip, roll, tile, index_select, tril, diag, dot, kron, trace,
cholesky, inverse, ...); the isfinite family; and the creation layers
over ``ops/creation.py`` (ones_like, full_like, range / arange,
linspace, eye, fill_constant_batch_size_like).

Parity surface: python/paddle/fluid/layers/tensor.py in the reference;
ported from the JAX package's ``fluid/layers/tensor.py``.
"""
from __future__ import annotations

import builtins

import numpy as np

from .. import framework
from ..dtypes import convert_dtype
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper, emit_op


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx},
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


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable_for_type_inference(dtype=dtype)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        persistable=persistable, shape=tuple(shape),
        dtype=convert_dtype(dtype))
    helper.set_variable_initializer(var, ConstantInitializer(value))
    if not persistable:
        # a non-persistable global still needs a value in every run
        helper.main_program.global_block().append_op(
            type="fill_constant", outputs={"Out": [var]},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "value": float(value)})
    return var


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0})
    return out


def full_like(x, fill_value, dtype=None):
    helper = LayerHelper("full_like")
    out = helper.create_variable_for_type_inference(dtype=dtype or x.dtype)
    attrs = {"value": float(fill_value)}
    if dtype is not None:
        attrs["dtype"] = convert_dtype(dtype)
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def range(start, end, step, dtype="int64"):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="range",
        outputs={"Out": [out]},
        attrs={"start": float(start), "end": float(end),
               "step": float(step), "dtype": convert_dtype(dtype)},
    )
    out.stop_gradient = True
    return out


arange = range


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="linspace",
        outputs={"Out": [out]},
        attrs={"start": float(start), "stop": float(stop), "num": int(num),
               "dtype": convert_dtype(dtype)},
    )
    return out


def eye(num_rows, num_columns=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="eye",
        outputs={"Out": [out]},
        attrs={"num_rows": int(num_rows),
               "num_columns": int(num_columns or num_rows),
               "dtype": convert_dtype(dtype)},
    )
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(dtype=diagonal.dtype)
    helper.append_op(type="diag_v2", inputs={"X": [diagonal]},
                     outputs={"Out": [out]}, attrs={})
    return out


def _arg(op_type, layer, x, axis):
    helper = LayerHelper(layer)
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    out.stop_gradient = True
    return out


def argmax(x, axis=0):
    return _arg("arg_max", "argmax", x, axis)


def argmin(x, axis=0):
    return _arg("arg_min", "argmin", x, axis)


def argsort(x, axis=-1, descending=False):
    helper = LayerHelper("argsort")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op(type="flip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(axis)})
    return out


def _bool_layer(op_type, layer, x):
    helper = LayerHelper(layer)
    out = helper.create_variable_for_type_inference(dtype="bool")
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_inf(x):
    return _bool_layer("isinf", "has_inf", x)


def has_nan(x):
    return _bool_layer("isnan", "has_nan", x)


def isfinite(x):
    return _bool_layer("isfinite", "isfinite", x)


def isfinite_v2(x, name=None):
    """Elementwise finite test (op isfinite_v2); ``isfinite`` reduces."""
    out = _bool_layer("isfinite_v2", "isfinite_v2", x)
    out.stop_gradient = True
    return out


def _unary_layer(op_type, x, attrs=None, out_dtype=None, in_slot="X",
                 out_slot="Out"):
    return emit_op(op_type, {in_slot: [x]}, attrs, out_slots=(out_slot,),
                   out_dtype=out_dtype)


def tile(x, repeat_times, name=None):
    return _unary_layer("tile", x, {"repeat_times": list(repeat_times)})


def flip(x, axis, name=None):
    axis = [axis] if isinstance(axis, int) else list(axis)
    return _unary_layer("flip", x, {"axis": axis})


def roll(x, shifts, axis=None, name=None):
    shifts = [shifts] if isinstance(shifts, int) else list(shifts)
    if axis is not None:
        axis = [axis] if isinstance(axis, int) else list(axis)
    return _unary_layer("roll", x, {"shifts": shifts, "axis": axis or []})


def tril(x, diagonal=0, name=None):
    return _unary_layer("tril_triu", x, {"lower": True, "diagonal": diagonal})


def triu(x, diagonal=0, name=None):
    return _unary_layer("tril_triu", x, {"lower": False,
                                         "diagonal": diagonal})


def meshgrid(*args, name=None):
    inputs = (list(args[0]) if len(args) == 1
              and isinstance(args[0], (list, tuple)) else list(args))
    helper = LayerHelper("meshgrid")
    outs = [helper.create_variable_for_type_inference(inputs[0].dtype)
            for _ in inputs]
    helper.append_op(type="meshgrid", inputs={"X": inputs},
                     outputs={"Out": outs}, attrs={})
    return outs


def index_select(x, index, axis=0, name=None):
    helper = LayerHelper("index_select")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="index_select",
                     inputs={"X": [x], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"dim": axis})
    return out


def take_along_axis(x, indices, axis, name=None):
    helper = LayerHelper("take_along_axis")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="take_along_axis",
                     inputs={"Input": [x], "Index": [indices]},
                     outputs={"Result": [out]}, attrs={"Axis": axis})
    return out


def unbind(x, axis=0, name=None):
    helper = LayerHelper("unbind")
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in builtins.range(x.shape[axis])]
    helper.append_op(type="unbind", inputs={"X": [x]}, outputs={"Out": outs},
                     attrs={"axis": axis})
    return outs


def _binary_layer(op_type, x, y, attrs=None, x_slot="X", y_slot="Y"):
    return emit_op(op_type, {x_slot: [x], y_slot: [y]}, attrs)


def dot(x, y, name=None):
    return _binary_layer("dot", x, y)


def kron(x, y, name=None):
    return _binary_layer("kron", x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    helper = LayerHelper("addmm")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="addmm",
                     inputs={"Input": [input], "X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"Alpha": alpha, "Beta": beta})
    return out


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _unary_layer("trace", x, {"offset": offset, "axis1": axis1,
                                     "axis2": axis2}, in_slot="Input")


def cholesky(x, upper=False, name=None):
    return _unary_layer("cholesky", x, {"upper": upper})


def inverse(x, name=None):
    return _unary_layer("inverse", x, in_slot="Input", out_slot="Output")


def matrix_power(x, n, name=None):
    return _unary_layer("matrix_power", x, {"n": n})


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    helper = LayerHelper("allclose")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="allclose", inputs={"Input": [x], "Other": [y]},
                     outputs={"Out": [out]},
                     attrs={"rtol": rtol, "atol": atol,
                            "equal_nan": equal_nan})
    return out


def isnan_v2(x, name=None):
    return _unary_layer("isnan_v2", x, out_dtype="bool")


def isinf_v2(x, name=None):
    return _unary_layer("isinf_v2", x, out_dtype="bool")
