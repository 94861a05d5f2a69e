"""Tensor manipulation ops that BERT uses: reshape, transpose, slice,
unsqueeze, gather.

Parity surface: reference reshape_op.cc, transpose_op.cc, slice_op.cc,
unsqueeze_op.cc, gather_op.cc; ported from the JAX package's
``ops/manipulation.py``.  The *2 variants also emit an XShape output
carrying the pre-op shape, matching the reference's grad plumbing: a
zero-size tensor kept only for desc parity.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _xshape(x):
    return x.new_empty((0,) + tuple(x.shape))


def _infer_reshape(shape_attr, in_shape):
    shape = [int(s) for s in shape_attr]
    numel = math.prod(in_shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = in_shape[i]
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(s for s in shape if s != -1)
        shape[i] = numel // max(rest, 1)
    return tuple(shape)


@register("reshape")
def reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_infer_reshape(attrs["shape"], tuple(x.shape)))]}


@register("reshape2")
def reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x.reshape(_infer_reshape(attrs["shape"], tuple(x.shape)))
    return {"Out": [out], "XShape": [_xshape(x)]}


@register("transpose2")
def transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register("slice")
def slice_op(ctx, ins, attrs):
    x = ins["Input"][0]
    decrease = set(attrs.get("decrease_axis", []))
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        st = min(max(st if st >= 0 else st + dim, 0), dim)
        en = min(max(en if en >= 0 else en + dim, 0), dim)
        idx[ax] = slice(st, en)
    out = x[tuple(idx)]
    if decrease:
        out = out.reshape(tuple(d for i, d in enumerate(out.shape)
                                if i not in decrease))
    return {"Out": [out]}


def _unsqueeze(x, axes):
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


@register("unsqueeze")
def unsqueeze(ctx, ins, attrs):
    return {"Out": [_unsqueeze(ins["X"][0], attrs["axes"])]}


@register("unsqueeze2")
def unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_unsqueeze(x, attrs["axes"])], "XShape": [_xshape(x)]}


@register("expand_as")
def expand_as(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["target_tensor"][0]
    return {"Out": [x.expand(tgt.shape)]}


def _fill_value(dtype):
    """``jnp.take``'s default fill: NaN for floats, True for bool, the most
    negative signed and the largest unsigned integer."""
    if dtype.is_floating_point:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take(x, idx, axis=0):
    """``jnp.take(x, idx, axis)`` in its default ``mode="fill"``: an index
    in [-n, 0) wraps, one outside [-n, n) gives the fill value.  The index
    is clamped before the read, so an out-of-range one reads a valid row
    (on the card no device assert) and is masked after; the masked
    elements take no gradient."""
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = x.index_select(axis, idx.clamp(0, max(n - 1, 0)).reshape(-1))
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    ok = ok.reshape(idx.shape + (1,) * (x.dim() - axis - 1))
    return torch.where(ok, out, _fill_value(x.dtype))


@register("gather")
def gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [take(x, idx.reshape(-1), attrs.get("axis", 0) % x.dim())]}
