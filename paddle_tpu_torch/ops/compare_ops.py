"""Comparison and logical ops, elementwise maximum / minimum, allclose.

Parity surface: reference operators/controlflow/compare_op.cc and
logical_op.cc; ported from the JAX package's ``ops/compare_ops.py``.
Operands are promoted first, as jnp promotes them (an int32 X against a
float32 Y compares in float32); the comparisons and logical ops give
bool and have no gradient.
"""
from __future__ import annotations

import torch

from .math_ops import _min_max, _promoted
from .registry import register


def _cmp(name, fn):
    @register(name, stop_gradient=True, no_vjp_grad=True)
    def _emit(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(*_promoted(ins["X"][0], ins["Y"][0]))]}

    return _emit


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
# jnp.logical_*: any nonzero element is True
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@register("logical_not", stop_gradient=True, no_vjp_grad=True)
def logical_not(ctx, ins, attrs):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register("allclose", stop_gradient=True, no_vjp_grad=True)
def allclose(ctx, ins, attrs):
    """A 0-d bool, reduced on the device (no host read)."""
    x, y = _promoted(ins["Input"][0], ins["Other"][0])
    close = torch.isclose(x, y, rtol=float(attrs.get("rtol", 1e-5)),
                          atol=float(attrs.get("atol", 1e-8)),
                          equal_nan=bool(attrs.get("equal_nan", False)))
    return {"Out": [close.all()]}


@register("maximum")
def maximum(ctx, ins, attrs):
    return {"Out": [_min_max(torch.maximum)(ins["X"][0], ins["Y"][0])]}


@register("minimum")
def minimum(ctx, ins, attrs):
    return {"Out": [_min_max(torch.minimum)(ins["X"][0], ins["Y"][0])]}
