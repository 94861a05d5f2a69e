"""Tensor manipulation ops: reshape / transpose / concat / split / slice /
gather / scatter / pad / sort / cumsum and the rest of the JAX package's
``ops/manipulation.py``, with the same op types, slots and attributes.

Parity surface: reference reshape_op.cc, transpose_op.cc, concat_op.cc,
split_op.cc, slice_op.cc, strided_slice_op.cc, stack_op.cc,
squeeze_op.cc, unsqueeze_op.cc, flatten_op.cc, expand_op.cc, tile_op.cc,
gather_op.cc, gather_nd_op.cc, scatter_op.cc, scatter_nd_add_op.cc,
pad_op.cc, pad2d_op.cc, pad3d_op.cc, arg_min_max_op_base.h,
argsort_op.cc, top_k_op.cc, cumsum_op.cc, flip_op.cc, roll_op.cc,
tril_triu_op.cc, diag_v2_op.cc, index_select_op.cc, meshgrid_op.cc,
take_along_axis_op.cc, shard_index_op.cc, where_op.cc.  The *2 variants
also emit an XShape output carrying the pre-op shape, matching the
reference's grad plumbing: a zero-size tensor kept only for desc parity.

None of these op types has a ``pallas_call`` in the JAX package, so none
has a hand-written kernel here: each emitter is plain torch and is the
op's only path, on the CPU and on the card alike.  Where the obvious
torch call answers differently from the JAX emitter, the emitter spells
out the JAX rule so that both devices give the JAX package's CPU
answer: ``top_k`` orders by the float total order (-0.0 below 0.0, NaN
above inf) and breaks ties toward the lower index; ``argsort`` is
stable; a scatter with repeated ids lets the last update win, or adds
them one after another in id order, with no atomics; ``cumsum`` adds in
the blocked order of XLA's reduce-window scan; a negative
``strided_slice`` step goes through ``flip``.
"""
from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.nn.functional as F

from ..fluid.dtypes import runtime_dtype, to_torch_dtype
from .registry import register, set_grad_maker


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


# ---------------------------------------------------------------------------
# the rest of the JAX package's manipulation.py
# ---------------------------------------------------------------------------


def _index_dtype():
    """The dtype of an index output: int64 narrowed as the JAX package
    narrows it with 64-bit types off (``runtime_dtype``)."""
    return to_torch_dtype(runtime_dtype("int64"))


def _promote_all(xs):
    """Every tensor in the promoted dtype of all, as jnp.concatenate and
    jnp.stack promote their operands."""
    dt = functools.reduce(torch.promote_types, [x.dtype for x in xs])
    return [x.to(dt) for x in xs]


@register("transpose")
def transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("concat")
def concat(ctx, ins, attrs):
    return {"Out": [torch.cat(_promote_all(ins["X"]),
                              dim=attrs.get("axis", 0))]}


@register("split")
def split(ctx, ins, attrs):
    """jnp.split: ``sections`` cut at their running sums (all but the
    last), else ``num`` equal parts, which must divide the axis."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        cuts = list(itertools.accumulate(int(s) for s in sections))[:-1]
        return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError("array split does not result in an equal division: "
                         f"rest is {x.shape[axis] % num}")
    return {"Out": list(torch.tensor_split(x, num, dim=axis))}


def _strided(x, ax, st, en, sd):
    """``x[.., st:en:sd, ..]`` on axis ``ax`` with Python's slice rules; a
    negative step (which torch refuses) as the ascending slice of the
    same elements, flipped."""
    start, stop, step = slice(st, en, sd).indices(x.shape[ax])
    idx = [slice(None)] * x.dim()
    if step > 0:
        idx[ax] = slice(start, stop, step)
        return x[tuple(idx)]
    n = len(range(start, stop, step))
    low = start + (n - 1) * step      # the lowest index read
    idx[ax] = slice(low, start + 1, -step) if n else slice(0, 0)
    return torch.flip(x[tuple(idx)], [ax])


@register("strided_slice")
def strided_slice(ctx, ins, attrs):
    x = ins["Input"][0]
    spec = {}
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"],
                              attrs["ends"], attrs["strides"]):
        spec[ax % x.dim()] = (st, en, sd)   # a repeated axis: the last
    for ax, (st, en, sd) in spec.items():
        x = _strided(x, ax, st, en, sd)
    return {"Out": [x]}


@register("stack")
def stack(ctx, ins, attrs):
    return {"Y": [torch.stack(_promote_all(ins["X"]),
                              dim=attrs.get("axis", 0))]}


@register("unstack")
def unstack(ctx, ins, attrs):
    """Every slice along ``axis`` (its length, whatever ``num`` says)."""
    return {"Y": list(ins["X"][0].unbind(attrs.get("axis", 0)))}


@register("unbind")
def unbind(ctx, ins, attrs):
    return {"Out": list(ins["X"][0].unbind(attrs.get("axis", 0)))}


def _squeeze(x, axes):
    """jnp.squeeze over the size-1 axes among ``axes`` (all size-1 axes
    when none is named); a repeated axis raises, as jnp's does."""
    if not axes:
        dims = tuple(i for i, d in enumerate(x.shape) if d == 1)
    else:
        dims = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    if len(set(dims)) != len(dims):
        raise ValueError(f"dimensions are not unique: {dims}")
    return x.squeeze(dims) if dims else x


@register("squeeze")
def squeeze(ctx, ins, attrs):
    return {"Out": [_squeeze(ins["X"][0], attrs.get("axes", []))]}


@register("squeeze2")
def squeeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_squeeze(x, attrs.get("axes", []))],
            "XShape": [_xshape(x)]}


def _flatten(x, axis):
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    return x.reshape(lead, -1)


@register("flatten")
def flatten(ctx, ins, attrs):
    return {"Out": [_flatten(ins["X"][0], attrs.get("axis", 1))]}


@register("flatten2")
def flatten2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_flatten(x, attrs.get("axis", 1))],
            "XShape": [_xshape(x)]}


@register("flatten_contiguous_range")
def flatten_contiguous_range(ctx, ins, attrs):
    x = ins["X"][0]
    start = attrs.get("start_axis", 1) % max(x.dim(), 1)
    stop = attrs.get("stop_axis", -1) % max(x.dim(), 1)
    shape = (tuple(x.shape[:start]) + (math.prod(x.shape[start:stop + 1]),)
             + tuple(x.shape[stop + 1:]))
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register("expand")
def expand(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register("expand_v2")
def expand_v2(ctx, ins, attrs):
    """Broadcast to ``shape``; a -1 keeps the input's dim there."""
    x = ins["X"][0]
    shape = list(attrs["shape"])
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    tgt = tuple(xs if s == -1 else s for s, xs in zip(shape, xshape))
    return {"Out": [x.reshape(xshape).expand(tgt)]}


@register("tile")
def tile(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["repeat_times"]))]}


def _nd_rows(shape, idx):
    """The row of ``x.reshape(prod(shape[:nd]), -1)`` each index of
    ``idx[..., nd]`` names, each coordinate wrapped once if negative, and
    whether every coordinate is then inside ``shape``."""
    nd = idx.shape[-1]
    idx = idx.long()
    dims = torch.tensor(shape[:nd], dtype=torch.long, device=idx.device)
    idx = torch.where(idx < 0, idx + dims, idx)
    ok = ((idx >= 0) & (idx < dims)).all(-1)
    strides = [math.prod(shape[i + 1:nd]) for i in range(nd)]
    st = torch.tensor(strides, dtype=torch.long, device=idx.device)
    return idx, (idx * st).sum(-1), ok


@register("gather_nd")
def gather_nd(ctx, ins, attrs):
    """``x[idx[..., 0], idx[..., 1], ...]`` as jnp indexing reads it: a
    negative coordinate wraps once, then every coordinate is clamped
    into range; an index that was clamped passes no gradient back."""
    x, idx = ins["X"][0], ins["Index"][0]
    nd = idx.shape[-1]
    idx, _, ok = _nd_rows(tuple(x.shape), idx)
    hi = torch.tensor(x.shape[:nd], dtype=torch.long, device=idx.device) - 1
    idx = torch.minimum(idx.clamp_min(0), hi)
    out = x[tuple(idx[..., i] for i in range(nd))]
    # a clamped read takes no gradient: jax's transpose drops it
    ok = ok.reshape(ok.shape + (1,) * (out.dim() - ok.dim()))
    return {"Out": [torch.where(ok, out, out.detach())]}


def _in_order_add(base, rows, ok, upd):
    """``base`` [N, ...] with each update row ``upd[j]`` added at
    ``rows[j]`` where ``ok[j]``, the updates of one row added one after
    another in their order, as the JAX package's CPU scatter-add does:
    round k adds every row's k-th update, so no two writes of a round
    meet and no atomic add decides the order.  The same on both
    devices."""
    n = base.shape[0]
    if base.device.type == "meta" or rows.numel() == 0:
        return base.clone()
    rows = torch.where(ok, rows, n)            # dropped: a spare row n
    s, order = torch.sort(rows, stable=True)
    pos = torch.arange(s.numel(), device=s.device)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos).scatter_(0, order, pos - start)
    out = base
    tail = (1,) * (base.dim() - 1)
    for k in range(int(rank.max()) + 1):
        at = torch.where(rank == k, rows, n)
        buf = upd.new_zeros((n + 1,) + tuple(base.shape[1:]))
        buf = buf.index_put((at,), upd)
        hit = torch.zeros(n + 1, dtype=torch.bool, device=base.device)
        hit = hit.index_put((at,), torch.ones_like(at, dtype=torch.bool))
        out = torch.where(hit[:n].view((n,) + tail), out + buf[:n], out)
    return out


def _last_wins(base, rows, ok, upd):
    """``base`` [N, ...] with row ``rows[j]`` set to ``upd[j]``, the last
    update of a repeated row winning, as the JAX package's CPU scatter
    does; the winner found by a max over positions, the same on both
    devices (and only the winner takes a gradient, as jax's scatter
    VJP gives it)."""
    n = base.shape[0]
    pos = torch.arange(rows.numel(), device=rows.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=rows.device)
    last = last.scatter_reduce(0, torch.where(ok, rows, n),
                               torch.where(ok, pos, -1), "amax")[:n]
    hit = (last >= 0).view((n,) + (1,) * (base.dim() - 1))
    return torch.where(hit, upd.index_select(0, last.clamp_min(0)), base)


@register("scatter")
def scatter(ctx, ins, attrs):
    """x.at[ids].set(updates) (``overwrite``) or the rows at ids zeroed and
    their updates added: a negative id wraps once, one still outside the
    table is dropped."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    _, rows, ok = _nd_rows((x.shape[0],), ids.reshape(-1, 1))
    upd = upd.to(x.dtype)
    if attrs.get("overwrite", True):
        return {"Out": [_last_wins(x, rows, ok, upd)]}
    zeros = _last_wins(x, rows, ok, torch.zeros_like(upd))
    return {"Out": [_in_order_add(zeros, rows, ok, upd)]}


@register("scatter_nd_add")
def scatter_nd_add(ctx, ins, attrs):
    """x.at[idx[..., 0], idx[..., 1], ...].add(updates), an index with a
    coordinate outside x (after one wrap) dropped."""
    x, idx, upd = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    nd = idx.shape[-1]
    shape = tuple(x.shape)
    _, rows, ok = _nd_rows(shape, idx)
    flat = x.reshape((math.prod(shape[:nd]),) + shape[nd:])
    u = upd.to(x.dtype).reshape((-1,) + shape[nd:])
    out = _in_order_add(flat, rows.reshape(-1), ok.reshape(-1), u)
    return {"Out": [out.reshape(shape)]}


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of an axis padded by (lo, hi):
    numpy's "edge", "reflect" (about the end elements, repeating) and
    "wrap"."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def _gather_axis(x, idx, axis):
    """``x.index_select(axis, idx)`` with the fixed-order backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _IndexSelect.apply(x, axis, idx)
    return x.index_select(axis, idx)


def _pad(x, cfg, mode, value):
    """jnp.pad with per-axis (lo, hi) ``cfg``: "constant" fills ``value``
    cast to x's dtype; "edge", "reflect" and "wrap" read x by index, so
    every dtype pads and the gradient sums in a fixed order."""
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        fill = torch.tensor(value).to(x.dtype).item()
        return F.pad(x, flat, value=fill)
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = _gather_axis(x, _pad_index(x.shape[ax], lo, hi, mode,
                                           x.device), ax)
    return x


@register("pad")
def pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    cfg = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return {"Out": [_pad(x, cfg, "constant", attrs.get("pad_value", 0.0))]}


@register("pad2d")
def pad2d(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]   # [top, bottom, left, right]
    hw = [(p[0], p[1]), (p[2], p[3])]
    cfg = ([(0, 0)] + hw + [(0, 0)]
           if attrs.get("data_format", "NCHW") == "NHWC"
           else [(0, 0), (0, 0)] + hw)
    mode = {"constant": "constant", "reflect": "reflect",
            "edge": "edge"}[attrs.get("mode", "constant")]
    return {"Out": [_pad(x, cfg, mode, attrs.get("pad_value", 0.0))]}


@register("pad3d")
def pad3d(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]   # [left, right, top, bottom, front, back]
    dhw = [(p[4], p[5]), (p[2], p[3]), (p[0], p[1])]
    cfg = ([(0, 0)] + dhw + [(0, 0)]
           if attrs.get("data_format", "NCDHW") == "NDHWC"
           else [(0, 0), (0, 0)] + dhw)
    mode = {"constant": "constant", "reflect": "reflect", "replicate": "edge",
            "circular": "wrap"}[attrs.get("mode", "constant")]
    return {"Out": [_pad(x, cfg, mode, attrs.get("value", 0.0))]}


def _arg(fn):
    def emit(ctx, ins, attrs):
        """jnp.argmax / argmin: the first index of the extreme, a NaN
        counting as both; a bool X read as 0 / 1."""
        x = ins["X"][0]
        axis = attrs.get("axis", -1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        out = fn(x, dim=axis).to(_index_dtype())
        if attrs.get("keepdims", False):
            out = out.unsqueeze(axis)
        return {"Out": [out]}

    return emit


register("arg_max", stop_gradient=True, no_vjp_grad=True)(_arg(torch.argmax))
register("arg_min", stop_gradient=True, no_vjp_grad=True)(_arg(torch.argmin))


def _neg(x):
    """jnp.negative as the CPU takes it: a float's sign bit flipped, a
    NaN's too (the card's arithmetic negation gives its canonical NaN, so
    a float is negated on its bits); an unsigned integer wraps; a bool
    raises TypeError."""
    if x.dtype == torch.bool:
        raise TypeError("neg does not accept dtype bool")
    if not x.is_floating_point():
        return -x
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return (x.view(ity) ^ torch.iinfo(ity).min).view(x.dtype)


@register("argsort", no_vjp_grad=True)
def argsort(ctx, ins, attrs):
    """jnp.argsort, stable (-0.0 equal to 0.0, every NaN last, whatever
    its sign); descending order is the ascending order of -x, as the JAX
    emitter takes it.  The sort runs on an integer key (``_sort_key``):
    the card's float sort places a NaN by its sign bit."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = _neg(x) if attrs.get("descending", False) else x
    idx = torch.sort(_sort_key(key), dim=axis, stable=True).indices
    return {"Out": [torch.gather(x, axis, idx)],
            "Indices": [idx.to(_index_dtype())]}


def _scatter_back(x, idx, dout, axis):
    """d(take_along_axis)/dx: dout put back at the saved indices (distinct
    along ``axis``, so no two writes meet)."""
    return torch.zeros_like(x).scatter(axis, idx.long(), dout.to(x.dtype))


@register("argsort_grad", no_vjp_grad=True)
def argsort_grad(ctx, ins, attrs):
    return {"X@GRAD": [_scatter_back(ins["X"][0], ins["Indices"][0],
                                     ins["Out@GRAD"][0],
                                     attrs.get("axis", -1))]}


def _indices_grad_maker(grad_type):
    """Out is differentiable through the saved Indices (reference
    top_k_op.cc / argsort_op.cc grad kernels); Indices carries none."""
    def maker(op, out_grads, block):
        og = out_grads.get("Out")
        if og is None:
            return [], {}
        xname = op.input("X")[0]
        gname = xname + "@GRAD"
        desc = {"type": grad_type,
                "inputs": {"X": [xname],
                           "Indices": [op.output("Indices")[0]],
                           "Out@GRAD": [og[0]]},
                "outputs": {"X@GRAD": [gname]},
                "attrs": dict(op.attrs)}
        return [desc], {xname: gname}

    return maker


set_grad_maker("argsort", _indices_grad_maker("argsort_grad"))


def _total_order_key(x):
    """An integer key whose order is lax.top_k's order of x: floats by
    the IEEE total order (-NaN < -inf < ... < -0.0 < 0.0 < ... < inf <
    NaN), integers as they are, bool as 0 / 1."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if not x.is_floating_point():
        return x
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    bits = x.view(ity)
    return torch.where(bits < 0, bits ^ torch.iinfo(ity).max, bits)


def _sort_key(x):
    """An integer key whose order is jnp.sort's: the total order with both
    zeros equal and every NaN above inf."""
    key = _total_order_key(x)
    if not x.is_floating_point():
        return key
    key = torch.where(x == 0, 0, key)
    return torch.where(torch.isnan(x), torch.iinfo(key.dtype).max, key)


def _top_k_last(x, k):
    """lax.top_k over the last axis: the k largest in descending total
    order, ties to the lower index (a stable sort of the key)."""
    idx = torch.sort(_total_order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


@register("top_k", no_vjp_grad=True)
def top_k(ctx, ins, attrs):
    vals, idx = _top_k_last(ins["X"][0], attrs["k"])
    return {"Out": [vals], "Indices": [idx.to(_index_dtype())]}


@register("top_k_grad", no_vjp_grad=True)
def top_k_grad(ctx, ins, attrs):
    return {"X@GRAD": [_scatter_back(ins["X"][0], ins["Indices"][0],
                                     ins["Out@GRAD"][0], -1)]}


set_grad_maker("top_k", _indices_grad_maker("top_k_grad"))


@register("top_k_v2", no_vjp_grad=True)
def top_k_v2(ctx, ins, attrs):
    """top_k along ``axis``; the smallest as the largest of -x, negated
    back, as the JAX emitter takes them."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1) % x.dim()
    largest = attrs.get("largest", True)
    xm = x.movedim(axis, -1)
    vals, idx = _top_k_last(xm if largest else _neg(xm), attrs["k"])
    if not largest:
        vals = _neg(vals)
    return {"Out": [vals.movedim(-1, axis)],
            "Indices": [idx.to(_index_dtype()).movedim(-1, axis)]}


@register("top_k_v2_grad", no_vjp_grad=True)
def top_k_v2_grad(ctx, ins, attrs):
    x = ins["X"][0]
    return {"X@GRAD": [_scatter_back(x, ins["Indices"][0],
                                     ins["Out@GRAD"][0],
                                     attrs.get("axis", -1) % x.dim())]}


set_grad_maker("top_k_v2", _indices_grad_maker("top_k_v2_grad"))


# XLA's reduce-window rewrite scans a long axis in blocks of this many
_SCAN_BLOCK = 16


def _scan_seq(x):
    """The inclusive running sum of the last axis, one add at a time from
    a +0.0 start, each rounded to x's dtype."""
    acc = torch.zeros_like(x[..., 0])
    outs = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        outs.append(acc)
    return torch.stack(outs, -1)


def _scan_blocked(x):
    """jnp.cumsum's float order on the last axis, as XLA's CPU backend
    computes it: an axis longer than 16 is padded to whole blocks of 16,
    each block summed from the left, the blocks' totals scanned the same
    way (recursively), and each block's running sums offset by the total
    of the blocks before it.  Every add rounds to x's dtype, so a bf16
    cumsum rounds as the JAX package's does, the same on both devices."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _scan_seq(x)
    m = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, m * _SCAN_BLOCK - n)).reshape(
        x.shape[:-1] + (m, _SCAN_BLOCK))
    inner = _scan_seq(blocks)
    before = F.pad(_scan_blocked(inner[..., -1])[..., :-1], (1, 0))
    out = inner + before[..., None]
    return out.reshape(x.shape[:-1] + (m * _SCAN_BLOCK,))[..., :n]


class _CumsumFloat(torch.autograd.Function):
    """The blocked scan of a float X along ``axis``; its backward the same
    scan of the cotangent from the other end (cumsum's transpose)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _scan_blocked(x.movedim(axis, -1)).movedim(-1, axis)

    @staticmethod
    def backward(ctx, g):
        gm = g.flip(ctx.axis).movedim(ctx.axis, -1)
        return _scan_blocked(gm).movedim(-1, ctx.axis).flip(ctx.axis), None


def _cumsum(x, axis):
    """jnp.cumsum: a float X in its own dtype in XLA's order; a bool X in
    int32, an integer one in its own dtype, wrapping."""
    if x.is_floating_point():
        if x.device.type == "meta" or x.numel() == 0:
            return x.clone()
        return _CumsumFloat.apply(x, axis % x.dim())
    dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return torch.cumsum(x, axis, dtype=torch.int64).to(dt)


@register("cumsum")
def cumsum(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    reverse = attrs.get("reverse", False)
    if reverse:
        x = torch.flip(x, [axis])
    out = _cumsum(x, axis)
    if attrs.get("exclusive", False):
        out = out - x      # as the JAX emitter takes it, rounding included
    if reverse:
        out = torch.flip(out, [axis])
    return {"Out": [out]}


@register("flip")
def flip(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0], list(attrs["axis"]))]}


@register("roll")
def roll(ctx, ins, attrs):
    axis = attrs.get("axis", None)
    return {"Out": [torch.roll(ins["X"][0], list(attrs["shifts"]),
                               list(axis) if axis else None)]}


@register("tril_triu")
def tril_triu(ctx, ins, attrs):
    x, d = ins["X"][0], attrs.get("diagonal", 0)
    return {"Out": [torch.tril(x, d) if attrs.get("lower", True)
                    else torch.triu(x, d)]}


@register("diag_v2", no_vjp_grad=True)
def diag_v2(ctx, ins, attrs):
    """A 1-D X on the ``offset`` diagonal of a square of
    ``padding_value`` (cast to X's dtype); of a 2-D X its diagonal."""
    x = ins["X"][0]
    offset = attrs.get("offset", 0)
    if x.dim() != 1:
        return {"Out": [torch.diagonal(x, offset)]}
    n = x.shape[0] + abs(offset)
    fill = torch.tensor(attrs.get("padding_value", 0.0)).to(x.dtype).item()
    out = torch.full((n, n), fill, dtype=x.dtype, device=x.device)
    i = torch.arange(x.shape[0], device=x.device)
    r, c = (i, i + offset) if offset >= 0 else (i - offset, i)
    return {"Out": [out.index_put((r, c), x)]}


@register("index_select")
def index_select(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [take(x, idx, attrs.get("dim", 0) % x.dim())]}


@register("meshgrid")
def meshgrid(ctx, ins, attrs):
    """jnp.meshgrid(indexing="ij"), each grid in its own input's dtype
    (torch.meshgrid wants one dtype for all)."""
    xs = ins["X"]
    shape = tuple(x.numel() for x in xs)
    one = (1,) * len(xs)
    return {"Out": [x.reshape(one[:i] + (-1,) + one[i + 1:]).expand(shape)
                    for i, x in enumerate(xs)]}


@register("take_along_axis")
def take_along_axis(ctx, ins, attrs):
    x, idx = ins["Input"][0], ins["Index"][0]
    return {"Result": [take_along(x, idx, attrs.get("Axis", 0) % x.dim())]}


def take_along(x, idx, axis):
    """jnp.take_along_axis: the index broadcast against x off the axis, a
    negative index wrapped once, one still out of range read as the
    fill value (NaN for floats, as ``take``) and given no gradient."""
    shape = list(torch.broadcast_shapes(
        x.shape[:axis] + (1,) + x.shape[axis + 1:],
        idx.shape[:axis] + (1,) + idx.shape[axis + 1:]))
    n = x.shape[axis]
    shape[axis] = n
    xb = x.expand(shape)
    shape[axis] = idx.shape[axis]
    idx = idx.long().expand(shape)
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = torch.gather(xb, axis, idx.clamp(0, max(n - 1, 0)))
    return torch.where(ok, out, _fill_value(x.dtype))


@register("shard_index", stop_gradient=True, no_vjp_grad=True)
def shard_index(ctx, ins, attrs):
    """Global ids to this shard's local ids, ``ignore_value`` elsewhere
    (reference shard_index_op.cc)."""
    x = ins["X"][0]
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    mine = torch.floor_divide(x, size) == attrs["shard_id"]
    return {"Out": [torch.where(mine, torch.remainder(x, size),
                                attrs.get("ignore_value", -1)).to(x.dtype)]}
