"""Dense math ops: elementwise (with paddle axis-broadcast), the matmul
family, the activations and softmax that BERT uses.

Parity surface: reference operators/elementwise/*, matmul_op.cc,
mul_op.cc, activation_op.cc, softmax_op.cc; ported from the JAX
package's ``ops/math_ops.py``.  Matrix products are ``torch.matmul``
(cuBLAS on the card), as the JAX package left them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register


def _paddle_broadcast(x, y, axis):
    """Paddle elementwise broadcast: align y's dims to x starting at
    ``axis`` (reference operators/elementwise/elementwise_op_function.h)."""
    xr, yr = x.dim(), y.dim()
    if xr <= yr:  # same rank, or numpy-style broadcast from the left
        return x, y
    a = axis if axis is not None and axis >= 0 else xr - yr
    return x, y.reshape((1,) * a + tuple(y.shape) + (1,) * (xr - a - yr))


def _ew(name, fn):
    @register(name)
    def _emit(ctx, ins, attrs, _fn=fn):
        x, y = _paddle_broadcast(ins["X"][0], ins["Y"][0],
                                 attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}

    return _emit


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.true_divide)


@register("sum")
def sum_op(ctx, ins, attrs):
    """Add N tensors (reference sum_op.cc; fc over several inputs)."""
    out = ins["X"][0]
    for x in ins["X"][1:]:
        out = out + x
    return {"Out": [out]}


@register("matmul")
def matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    # transpose of a 1-D operand is the identity
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register("mul")
def mul(ctx, ins, attrs):
    """Flattening matmul (reference mul_op.cc): x flattened at
    x_num_col_dims, y at y_num_col_dims, then one 2-D product."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xn]), math.prod(xs[xn:]))
    y2 = y.reshape(math.prod(ys[:yn]), math.prod(ys[yn:]))
    return {"Out": [(x2 @ y2).reshape(xs[:xn] + ys[yn:])]}


def _act(name, fn):
    @register(name)
    def _emit(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}

    return _emit


_act("tanh", lambda x, a: torch.tanh(x))
_act("gelu", lambda x, a: F.gelu(
    x, approximate="tanh" if a.get("approximate", False) else "none"))


@register("softmax")
def softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}
