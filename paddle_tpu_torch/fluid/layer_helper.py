"""LayerHelper: shared plumbing for fluid.layers.* functions.

Parity surface: python/paddle/fluid/layer_helper.py — creates parameters
(with startup-program init ops), temp variables, appends ops and
activations.  Ported from the JAX package's ``fluid/layer_helper.py``
without ``emit_op`` (the dygraph front end is not ported).
"""
from __future__ import annotations

import copy

from . import framework, unique_name
from .dtypes import convert_dtype
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        if name is None:
            name = unique_name.generate(layer_type)
        self.name = name

    @property
    def main_program(self) -> framework.Program:
        return framework.default_main_program()

    @property
    def startup_program(self) -> framework.Program:
        return framework.default_startup_program()

    # ------------------------------------------------------------------
    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, framework.Variable):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for i in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = i.dtype
            elif dtype != i.dtype:
                raise ValueError("mixed input dtypes")
        return dtype

    # ------------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "w" if not is_bias else "b"]))
        if default_initializer is None:
            if is_bias:
                initializer = attr.initializer or ConstantInitializer(0.0)
            else:
                initializer = attr.initializer or XavierInitializer()
        else:
            initializer = attr.initializer or default_initializer
        dtype = convert_dtype(dtype or "float32")
        kwargs = {k: v for k, v in attr._to_kwargs().items() if k != "name"}

        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(attr.name, shape, dtype, **kwargs)
        initializer(sp, startup_block)
        main_block = self.main_program.global_block()
        return main_block.create_parameter(attr.name, shape, dtype, **kwargs)

    def create_variable_for_type_inference(self, dtype=None, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=convert_dtype(dtype or "float32"),
            shape=None,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    # ------------------------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype,
                                  is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
