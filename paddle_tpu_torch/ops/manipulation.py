"""Tensor manipulation ops that BERT uses: reshape, transpose, slice,
unsqueeze, gather; and where, the select of the meta-optimizers' masked
updates.

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


# a table with at most this many rows takes its gradient as one masked
# sum per row: its ids repeat so often that the sorted scatter, which
# adds the copies of one id one after another, runs long
_SMALL_TABLE_ROWS = 8


def index_sum(shape, axis, idx, g):
    """The gradient of ``x.index_select(axis, idx)``: ``g``'s slices summed
    into a zero tensor of ``shape`` at ``idx`` along ``axis``, the copies
    of a repeated index in a fixed order.  On the CPU ``index_add_``
    (sequential).  On the card, where ``index_add_`` adds with atomics in
    whatever order the threads arrive, a table of at most
    ``_SMALL_TABLE_ROWS`` rows is summed row by row under a mask
    (``torch.sum``'s fixed-order reduction), and a larger one through
    ``index_put_(accumulate=True)``, which sorts the ids and adds each
    one's copies in order."""
    if g.device.type != "cuda":
        return g.new_zeros(shape).index_add_(axis, idx, g)
    return ordered_index_sum(shape, axis, idx, g)


def ordered_index_sum(shape, axis, idx, g):
    """``index_sum``'s card method, on any device: the masked sums of a
    small table, else the sorted ``index_put_``."""
    dx = g.new_zeros(shape)
    out, src = dx.movedim(axis, 0), g.movedim(axis, 0)
    if shape[axis] <= _SMALL_TABLE_ROWS:
        mask = idx.view((-1,) + (1,) * (src.dim() - 1))
        for r in range(shape[axis]):
            out[r] = torch.where(mask == r, src, 0).sum(0)
    else:
        out.index_put_((idx,), src, accumulate=True)
    return dx


class _IndexSelect(torch.autograd.Function):
    """``x.index_select(axis, idx)`` whose backward sums the rows of a
    repeated index in a fixed order on the card too (``index_sum``), so
    two runs of a training step give the same embedding gradient to the
    bit.  Autograd's own backward adds them with atomics on CUDA."""

    @staticmethod
    def forward(ctx, x, axis, idx):
        ctx.save_for_backward(idx)
        ctx.axis, ctx.shape = axis, x.shape
        return x.index_select(axis, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return index_sum(ctx.shape, ctx.axis, idx, g), None, None


def take(x, idx, axis=0):
    """``jnp.take(x, idx, axis)`` in its default ``mode="fill"``: an index
    in [-n, 0) wraps, one outside [-n, n) gives the fill value.  The index
    is clamped before the read, so an out-of-range one reads a valid row
    (on the card no device assert) and is masked after; the masked
    elements take no gradient, and the gradient of a repeated index is
    summed in a fixed order (``_IndexSelect``)."""
    n = x.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    flat = idx.clamp(0, max(n - 1, 0)).reshape(-1)
    if torch.is_grad_enabled() and x.requires_grad:
        out = _IndexSelect.apply(x, axis, flat)
    else:
        out = x.index_select(axis, flat)
    out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
    ok = ok.reshape(idx.shape + (1,) * (x.dim() - axis - 1))
    return torch.where(ok, out, _fill_value(x.dtype))


@register("gather")
def gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [take(x, idx.reshape(-1), attrs.get("axis", 0) % x.dim())]}


@register("where")
def where(ctx, ins, attrs):
    """jnp.where(cond, x, y): X and Y promoted, a non-bool condition true
    where nonzero, every operand broadcast (GradientMerge's (1,) step
    condition against a parameter of any shape)."""
    cond, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    if cond.dtype != torch.bool:
        cond = cond != 0
    dt = torch.promote_types(x.dtype, y.dtype)
    return {"Out": [torch.where(cond, x.to(dt), y.to(dt))]}
