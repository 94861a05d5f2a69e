"""Reductions: reduce_sum / reduce_mean with attrs dim / keep_dim /
reduce_all.  Parity surface: reference operators/reduce_ops/; ported from
the JAX package's ``ops/reduce_ops.py``."""
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


def _reduce(name, fn):
    @register(name)
    def _emit(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        axes = _axes(x, attrs)
        keep = attrs.get("keep_dim", False)
        out = _fn(x) if axes is None and not keep else _fn(
            x, dim=axes if axes is not None else tuple(range(x.dim())),
            keepdim=keep)
        if out.dim() == 0:
            out = out.reshape(1)  # fluid reductions keep at least rank 1
        if out.dtype == torch.int64 and x.dtype == torch.int32:
            out = out.to(torch.int32)  # torch widens int sums; JAX keeps i32
        return {"Out": [out]}

    return _emit


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
