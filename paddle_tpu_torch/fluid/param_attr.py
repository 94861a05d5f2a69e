"""ParamAttr / WeightNormParamAttr. Parity: python/paddle/fluid/param_attr.py.

A copy of the JAX package's ``fluid/param_attr.py``.
"""
from __future__ import annotations

from .initializer import Initializer


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=True,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            return False  # "no parameter" (e.g. bias_attr=False)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")

    def _to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "need_clip": self.need_clip,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


WeightNormParamAttr = ParamAttr
