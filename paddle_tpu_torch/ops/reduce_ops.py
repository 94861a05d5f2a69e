"""Reductions: reduce_sum / mean / max / min / prod / all / any with
attrs dim / keep_dim / reduce_all, the whole-tensor ``mean`` and
``frobenius_norm``; every op type of the JAX package's
``ops/reduce_ops.py``.  Parity surface: reference operators/reduce_ops/,
mean_op.cc.  None has a ``pallas_call`` in the JAX package: each is
plain torch on every device.  A reduction to rank 0 keeps shape [1], as
the JAX ``_reduce`` does."""
from __future__ import annotations

import torch

from .math_ops import extreme
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


def _reduce(name, fn, float_out=False, stop_grad=False):
    @register(name, stop_gradient=stop_grad)
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
# amax / amin, not max(x, dim): where values tie, they split the gradient
# evenly between them, as jnp.max's VJP does; zeros signed as XLA's
_reduce("reduce_max", lambda x, dim=None, keepdim=False: extreme(
    x, False, dim, keepdim))
_reduce("reduce_min", lambda x, dim=None, keepdim=False: extreme(
    x, True, dim, keepdim))


def _prod(x, dim=None, keepdim=False):
    """jnp.prod over any set of dims (torch.prod takes one at a time):
    the reduced dims moved last and flattened into one."""
    if dim is None:
        return torch.prod(x)
    keep = [d for d in range(x.dim()) if d not in dim]
    flat = x.permute(keep + list(dim)).reshape(
        [x.shape[d] for d in keep] + [-1])
    out = torch.prod(flat, dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dim else n
                           for d, n in enumerate(x.shape)])
    return out


def _all_any(fn):
    """jnp.all / jnp.any: bool whatever X's dtype (torch keeps uint8)."""
    def red(x, dim=None, keepdim=False):
        if dim is None:
            return fn(x).bool()
        return fn(x, dim=dim, keepdim=keepdim).bool()

    return red


_reduce("reduce_prod", _prod)
_reduce("reduce_all", _all_any(torch.all), stop_grad=True)
_reduce("reduce_any", _all_any(torch.any), stop_grad=True)


@register("mean")
def mean(ctx, ins, attrs):
    """Whole-tensor mean to a [1] tensor (reference mean_op.cc)."""
    x = ins["X"][0]
    if not x.is_floating_point():
        x = x.float()  # jnp.mean of integers gives a float32 mean
    return {"Out": [torch.mean(x).reshape(1)]}


@register("frobenius_norm")
def frobenius_norm(ctx, ins, attrs):
    x = ins["X"][0]
    axes = _axes(x, attrs)
    keep = attrs.get("keep_dim", False)
    sq = torch.square(x)
    s = sq.sum() if axes is None and not keep else sq.sum(
        dim=axes if axes is not None else tuple(range(x.dim())),
        keepdim=keep)
    out = torch.sqrt(_narrow_int_sum(s, x))
    return {"Out": [out.reshape(1) if out.dim() == 0 else out]}
