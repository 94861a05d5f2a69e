"""Reductions: reduce_sum / reduce_mean / reduce_max with attrs dim /
keep_dim / reduce_all, and the whole-tensor ``mean``.  Parity surface: reference
operators/reduce_ops/, mean_op.cc; ported from the JAX package's
``ops/reduce_ops.py``."""
from __future__ import annotations

import torch

from .registry import register


def _axes(x, attrs):
    if attrs.get("reduce_all", False):
        return None
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    if len(dim) == 0:
        return None
    return tuple(d % x.dim() for d in dim)


def _reduce(name, fn, float_out=False):
    @register(name)
    def _emit(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        if float_out and not x.is_floating_point():
            x = x.float()  # jnp.mean of integers gives float32 means
        axes = _axes(x, attrs)
        keep = attrs.get("keep_dim", False)
        out = _fn(x) if axes is None and not keep else _fn(
            x, dim=axes if axes is not None else tuple(range(x.dim())),
            keepdim=keep)
        if out.dim() == 0:
            out = out.reshape(1)  # fluid reductions keep at least rank 1
        return {"Out": [_narrow_int_sum(out, x)]}

    return _emit


def _narrow_int_sum(out, x):
    """torch widens sums of narrow ints and bools to int64; jnp.sum gives
    int32, and uint32 for uint8."""
    if out.dtype == torch.int64 and x.dtype != torch.int64:
        return out.to(torch.uint32 if x.dtype == torch.uint8
                      else torch.int32)
    return out


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean, float_out=True)
# amax, not max(x, dim): where values tie, it splits the gradient evenly
# between them, as jnp.max's VJP does
_reduce("reduce_max", torch.amax)


@register("mean")
def mean(ctx, ins, attrs):
    """Whole-tensor mean to a [1] tensor (reference mean_op.cc)."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.float()  # jnp.mean of integers gives a float32 mean
    return {"Out": [torch.mean(x).reshape(1)]}
