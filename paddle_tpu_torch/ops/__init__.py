"""Operators of the port: torch emitters registered by op type.

Importing this package registers every ported op (the analog of the
reference's static REGISTER_OPERATOR initializers); the hand-written
CUDA kernels live in ``ops.kernels``.
"""
from . import registry  # noqa: F401
from . import (  # noqa: F401
    attention,
    collective_ops,
    compare_ops,
    creation,
    encoder_stack,
    manipulation,
    math_ops,
    moe_ops,
    nn_ops,
    optimizer_ops,
    ps_ops,
    recompute,
    reduce_ops,
)
from .registry import EmitContext, get, register  # noqa: F401
