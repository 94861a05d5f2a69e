"""Dense math ops: elementwise (with paddle axis-broadcast), the matmul
family, the activations and softmax that BERT and ResNet use (exp and
log for the Transformer NMT's label smoothing), the unary and binary
ops the learning-rate schedules and the meta-optimizers emit (min, max,
mod, pow, floor, cos, ...), and the clip / norm ops the optimizer's
gradient clipping and regularizers emit.

Parity surface: reference operators/elementwise/*, matmul_op.cc,
mul_op.cc, activation_op.cc, softmax_op.cc, clip_op.cc,
clip_by_norm_op.cc, squared_l2_norm_op.cc; ported from the JAX package's
``ops/math_ops.py``.  Matrix products are ``torch.matmul``
(cuBLAS on the card), as the JAX package left them to XLA; under a
``tp_region`` attr ``mul`` and ``matmul`` run a Megatron region over
"tp" on this rank's block of the weight (``fleet`` module note).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import distributed as dist
from ..parallel import tp_mesh
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


def _promoted(x, y):
    """Both operands in their promoted dtype (bf16 x f32 -> f32, int32 x
    f32 -> f32, int8 x uint8 -> int16), as jnp promotes before a binary
    op or a product."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _binary(fn):
    return lambda x, y: fn(*_promoted(x, y))


def _promoted_numeric(x, y):
    """``_promoted``, then two bools to int32, as jnp's numeric ops
    promote them (``promote_dtypes_numeric``)."""
    x, y = _promoted(x, y)
    if x.dtype == torch.bool:
        return x.to(torch.int32), y.to(torch.int32)
    return x, y


def _mod(x, y):
    """jnp.mod: an integer divisor of 0 (and a signed -1, which torch may
    trap on at the type's minimum) is taken as 1, so the remainder is 0;
    a float divisor of 0 gives NaN.  uint8 has no -1: torch compares its
    255 equal to -1, so the rule stays off it."""
    if x.is_floating_point():
        return torch.remainder(x, y)
    one = y == 0
    if x.dtype != torch.uint8:
        one = one | (y == -1)
    return torch.remainder(x, torch.where(one, 1, y))


def _floordiv(x, y):
    """jnp.floor_divide, its zero rules written out so that the CPU and the
    card agree: a float divisor of 0 gives NaN (its float_divmod takes
    fmod(x, 0)); an integer one gives XLA's quotient -1 (all ones
    unsigned) less 1 where the dividend is not 0, as the sign test
    then fires; a divisor of -1 negates, wrapping the type's minimum."""
    zero = y == 0
    if x.is_floating_point():
        return torch.where(zero, float("nan"), torch.floor_divide(x, y))
    if x.dtype == torch.uint8:
        return torch.where(zero, 255, torch.floor_divide(
            x, torch.where(zero, 1, y)))
    neg1 = y == -1
    q = torch.floor_divide(x, torch.where(zero | neg1, 1, y))
    q = torch.where(neg1, -x, q)
    return torch.where(zero, torch.where(x != 0, -2, -1).to(x.dtype), q)


def _int_product(x, y):
    """An integer or bool matmul computed the same way on the CPU and on
    the card (cuBLAS has no integer or bool product): int64 products
    summed over K in chunks, then wrapped to the operands' dtype as jnp's
    integer dot wraps; a bool product is True where any AND is."""
    x64 = x.to(torch.int64) if x.dim() > 1 else x.to(torch.int64)[None]
    y64 = y.to(torch.int64) if y.dim() > 1 else y.to(torch.int64)[:, None]
    m, k, n = x64.shape[-2], x64.shape[-1], y64.shape[-1]
    acc = torch.zeros(torch.broadcast_shapes(x64.shape[:-2], y64.shape[:-2])
                      + (m, n), dtype=torch.int64, device=x.device)
    step = max(1, (1 << 24) // max(1, acc.numel()))
    for i in range(0, k, step):
        acc += (x64[..., i:i + step, None]
                * y64[..., i:i + step, :].unsqueeze(-3)).sum(-2)
    if x.dim() == 1:
        acc = acc.squeeze(-2)
    if y.dim() == 1:
        acc = acc.squeeze(-1)
    return acc != 0 if x.dtype == torch.bool else acc.to(x.dtype)


def _product(x, y):
    """``torch.matmul``, but for integer and bool operands."""
    if x.is_floating_point():
        return torch.matmul(x, y)
    return _int_product(x, y)


def _unbroadcast(g, shape):
    """``g`` summed down to ``shape`` over the dims a broadcast grew."""
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _MinMax(torch.autograd.Function):
    """torch.minimum / maximum whose gradient follows lax.min / lax.max:
    an operand gets the cotangent where it equals the result, half of it
    where both do (a tie, -0.0 against 0.0 included), and none where the
    result is NaN (torch would pass it to the NaN operand)."""

    @staticmethod
    def forward(ctx, x, y, fn):
        z = fn(x, y)
        ctx.save_for_backward(x, y, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        xz, yz = x == z, y == z
        half = torch.where(xz & yz, 0.5, 1.0).to(g.dtype)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return (_unbroadcast(torch.where(xz, g * half, zero), x.shape),
                _unbroadcast(torch.where(yz, g * half, zero), y.shape), None)


def _min_max(fn):
    def op(x, y):
        x, y = _promoted(x, y)
        if x.is_floating_point() and (x.requires_grad or y.requires_grad):
            return _MinMax.apply(x, y, fn)
        return fn(x, y)

    return op


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.true_divide)
# jnp.minimum / maximum (NaN wins; the gradient lax.min's), jnp.mod and
# floor_divide (the divisor's sign, floor rounding), jnp.power
_ew("elementwise_min", _min_max(torch.minimum))
_ew("elementwise_max", _min_max(torch.maximum))
_ew("elementwise_mod", lambda x, y: _mod(*_promoted_numeric(x, y)))
_ew("elementwise_floordiv",
    lambda x, y: _floordiv(*_promoted_numeric(x, y)))
_ew("elementwise_pow", _binary(torch.pow))


@register("sum")
def sum_op(ctx, ins, attrs):
    """Add N tensors (reference sum_op.cc; fc over several inputs)."""
    out = ins["X"][0]
    for x in ins["X"][1:]:
        out = out + x
    return {"Out": [out]}


def _tp_in(ctx, attrs, x):
    """A product's input entering its tensor-parallel region: a column-
    parallel product (and the tied vocabulary head) reads the whole X
    through f, whose backward sums dX over "tp"."""
    mesh = tp_mesh(ctx, attrs)
    if mesh is not None and attrs["tp_region"] in ("column", "vocab_head"):
        return dist.copy_to_region(x, "tp", mesh)
    return x


def _tp_out(ctx, attrs, out):
    """A product's output leaving its region: a row-parallel one sums its
    partial result over "tp" with g (backward the identity); the tied
    vocabulary head gathers its [.., V/tp] logits along the vocabulary;
    a column-parallel one keeps its local columns."""
    mesh = tp_mesh(ctx, attrs)
    if mesh is None:
        return out
    if attrs["tp_region"] == "row":
        return dist.reduce_from_region(out, "tp", mesh)
    if attrs["tp_region"] == "vocab_head":
        return dist.all_gather(out, "tp", out.dim() - 1, mesh)
    return out


@register("matmul")
def matmul(ctx, ins, attrs):
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    x = _tp_in(ctx, attrs, x)
    # transpose of a 1-D operand is the identity
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = _product(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:  # alpha in Out's dtype first, as jnp.asarray casts it
        out = out * torch.tensor(alpha, device=out.device).to(out.dtype)
    return {"Out": [_tp_out(ctx, attrs, out)]}


@register("mul")
def mul(ctx, ins, attrs):
    """Flattening matmul (reference mul_op.cc): x flattened at
    x_num_col_dims, y at y_num_col_dims, then one 2-D product.  Under a
    tp_region attr the product runs Megatron's region over "tp" on this
    rank's block of Y (``fleet`` module note)."""
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    x = _tp_in(ctx, attrs, x)
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xn]), math.prod(xs[xn:]))
    y2 = y.reshape(math.prod(ys[:yn]), math.prod(ys[yn:]))
    return {"Out": [_tp_out(ctx, attrs,
                            _product(x2, y2).reshape(xs[:xn] + ys[yn:]))]}


def _act(name, fn):
    @register(name)
    def _emit(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}

    return _emit


_act("relu", lambda x, a: torch.relu(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("sqrt", lambda x, a: torch.sqrt(x))
_act("exp", lambda x, a: torch.exp(x))
_act("log", lambda x, a: torch.log(x))


def _sign(x, a):
    """jnp.sign: NaN and -0.0 kept (torch.sign gives 0 and +0.0; the kept
    elements are detached, so the gradient stays zero everywhere); a bool
    X raises, as jnp.sign refuses it."""
    if x.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    return torch.where((x == 0) | torch.isnan(x), x.detach(), torch.sign(x))


_act("sign", _sign)


def _inexact(x):
    """An integer or bool X in float32, as jnp's inexact-only functions
    (cos, sin) take it."""
    return x if x.is_floating_point() else x.float()


def _integral_kept(fn, name):
    """jnp.floor / ceil / round: an integer X is returned as it is (a
    bool one too, but round refuses it with ValueError)."""

    def op(x, a):
        if x.is_floating_point():
            return fn(x)
        if x.dtype == torch.bool and name == "round":
            raise ValueError("round does not accept dtype bool")
        return x

    return op


def _rsqrt(x, a):
    """lax.rsqrt refuses an integer or bool X (TypeError)."""
    if not x.is_floating_point():
        raise TypeError(f"rsqrt does not accept dtype {x.dtype}")
    return torch.rsqrt(x)


_act("abs", lambda x, a: x if x.dtype == torch.bool else torch.abs(x))
_act("floor", _integral_kept(torch.floor, "floor"))
_act("ceil", _integral_kept(torch.ceil, "ceil"))
_act("round", _integral_kept(torch.round, "round"))  # half to even
_act("cos", lambda x, a: torch.cos(_inexact(x)))
_act("sin", lambda x, a: torch.sin(_inexact(x)))
_act("reciprocal", lambda x, a: torch.reciprocal(_inexact(x)))
_act("rsqrt", _rsqrt)
# jnp.square of a bool X is int32
_act("square", lambda x, a: torch.square(
    x.to(torch.int32) if x.dtype == torch.bool else x))


@register("pow")
def pow_op(ctx, ins, attrs):
    """jnp.power(x, factor): an integer X with a float factor gives
    float32, with an int factor stays integer."""
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}
# jax.nn.gelu of an integer or bool X computes in float32
_act("gelu", lambda x, a: F.gelu(
    x if x.is_floating_point() else x.float(),
    approximate="tanh" if a.get("approximate", False) else "none"))


@register("softmax")
def softmax(ctx, ins, attrs):
    """jax.nn.softmax: float X as torch.softmax; an integer X gives
    float32, its x - max taken in X's own dtype first (so a uint8 X wraps
    there and gives the reference's NaN); a bool X raises, as jnp's
    subtraction refuses it."""
    x, axis = ins["X"][0], attrs.get("axis", -1)
    if x.is_floating_point():
        return {"Out": [torch.softmax(x, dim=axis)]}
    if x.dtype == torch.bool:
        raise TypeError("softmax: sub does not accept dtype bool")
    e = torch.exp((x - torch.amax(x, dim=axis, keepdim=True)).float())
    return {"Out": [e / e.sum(dim=axis, keepdim=True)]}


class _Clip(torch.autograd.Function):
    """clamp whose gradient follows jnp.clip = min(max(x, lo), hi) under
    lax.max / lax.min's tie rule: half the cotangent where x equals a
    bound, all of it strictly inside, none outside."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        w = torch.ones_like(g)
        for bound, inside in ((lo, lambda: x > lo), (hi, lambda: x < hi)):
            if bound is not None:
                w = torch.where(inside(), w,
                                torch.where(x == bound, 0.5 * w, 0.0 * w))
        return g * w, None, None


@register("clip")
def clip(ctx, ins, attrs):
    return {"Out": [_Clip.apply(ins["X"][0], attrs.get("min"),
                                attrs.get("max"))]}


@register("clip_by_norm")
def clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [x * (max_norm / torch.clamp_min(norm, max_norm))]}


@register("squared_l2_norm")
def squared_l2_norm(ctx, ins, attrs):
    """jnp.sum(jnp.square(x)): the square in X's dtype (a narrow int
    wraps there, a bool stays itself), the sum of an integer or bool X
    in int32, and uint32 for uint8 (``reduce_ops._narrow_int_sum``)."""
    from .reduce_ops import _narrow_int_sum

    x = ins["X"][0]
    sq = x if x.dtype == torch.bool else torch.square(x)
    return {"Out": [_narrow_int_sum(torch.sum(sq), x).reshape(1)]}
