"""Dense math ops: elementwise (with paddle axis-broadcast), the matmul
family (matmul, matmul_v2, mul, dot, addmm, kron), the activations of
the JAX package's ``_act`` table, softmax and log_softmax, the clip /
norm ops (clip, clip_by_norm, squared_l2_norm, p_norm), the isfinite
family, maxout, prelu, logsumexp, cos_sim, trace and the linear algebra
(cholesky, inverse, matrix_power): the op types of the JAX package's
``ops/math_ops.py``, with the same slots and attributes.

Parity surface: reference operators/elementwise/*, matmul_op.cc,
matmul_v2_op.cc, mul_op.cc, dot_op.cc, addmm_op.cc, kron_op.cc,
activation_op.cc, softmax_op.cc, log_softmax_op.cc, clip_op.cc,
clip_by_norm_op.cc, squared_l2_norm_op.cc, p_norm_op.cc,
isfinite_op.cc, maxout_op.cc, prelu_op.cc, logsumexp_op.cc,
cos_sim_op.cc, trace_op.cc, cholesky_op.cc, inverse_op.cc,
matrix_power_op.cc; ported from the JAX package's ``ops/math_ops.py``.
Matrix products are ``torch.matmul`` (cuBLAS on the card, TF32 off),
as the JAX package left them to XLA, and the linear algebra is
``torch.linalg``; under a ``tp_region`` attr ``mul`` and ``matmul`` run
a Megatron region over "tp" on this rank's block of the weight
(``fleet`` module note).

None of these op types has a ``pallas_call`` in the JAX package, so
none has a hand-written kernel here: each emitter is plain torch and is
the op's only path, on the CPU and on the card alike.  Where torch's
derivative differs from JAX's, the emitter takes JAX's: lax.min / max's
tie rule (``_MinMax``, ``_Clip``: half the cotangent on a tie or a clip
bound), lax.abs's (``_Abs``: the cotangent at 0), ``leaky_relu``'s 1 at
0, the 2-norm's NaN at a zero vector.
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


class _Resigned(torch.autograd.Function):
    """``fixed`` (``z`` with the sign of its zeros set) as the value, the
    gradient passed to ``z`` as it is."""

    @staticmethod
    def forward(ctx, z, fixed):
        return fixed

    @staticmethod
    def backward(ctx, g):
        return g, None


def xla_zero_sign(z, neg_zero):
    """``z`` whose zeros are -0.0 where ``neg_zero``, else +0.0, its
    gradient untouched.  XLA's min and max order -0.0 below +0.0 (a zero
    min is -0.0 if either zero is, a zero max +0.0 if either is); torch's
    minimum, maximum, amin and amax return whichever zero they met
    first."""
    if not z.is_floating_point():
        return z
    fixed = torch.where(z == 0, torch.where(neg_zero, -0.0, 0.0).to(z.dtype),
                        z)
    if z.requires_grad:
        return _Resigned.apply(z, fixed)
    return fixed


def extreme(x, is_min, dim=None, keepdim=False):
    """jnp.min / jnp.max over ``dim`` (all if None): torch.amin / amax
    (ties share the gradient evenly, as jnp's VJP), zeros signed as
    XLA's (``xla_zero_sign``)."""
    fn = torch.amin if is_min else torch.amax
    z = fn(x) if dim is None else fn(x, dim=dim, keepdim=keepdim)
    if not x.is_floating_point():
        return z
    # min: -0.0 if the slice holds a -0.0; max: +0.0 unless every zero
    # of the slice is -0.0
    zero = (x == 0) & (x.signbit() if is_min else ~x.signbit())
    has = zero.any() if dim is None else zero.any(dim=dim, keepdim=keepdim)
    return xla_zero_sign(z, has if is_min else ~has)


class _MinMax(torch.autograd.Function):
    """torch.minimum / maximum whose gradient follows lax.min / lax.max:
    the cotangent times 1 where an operand equals the result, 0.5 where
    both do (a tie, -0.0 against 0.0 included), 0 where it does not or
    the result is NaN (torch would pass it to the NaN operand).  A
    product, as lax's rule is: an infinite or NaN cotangent gives NaN
    to the operand that lost, where a select would give 0."""

    @staticmethod
    def forward(ctx, x, y, fn):
        z = _signed_min_max(fn, x, y)
        ctx.save_for_backward(x, y, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        xz, yz = x == z, y == z
        half = torch.where(xz & yz, 0.5, 1.0)
        return (_unbroadcast(g * torch.where(xz, half, 0.0).to(g.dtype),
                             x.shape),
                _unbroadcast(g * torch.where(yz, half, 0.0).to(g.dtype),
                             y.shape), None)


def _signed_min_max(fn, x, y):
    """torch.minimum / maximum with XLA's signed zeros: a zero min is -0.0
    if either operand is -0.0, a zero max -0.0 only if both are."""
    z = fn(x, y)
    if not z.is_floating_point():
        return z
    if fn is torch.minimum:
        return xla_zero_sign(z, x.signbit() | y.signbit())
    return xla_zero_sign(z, x.signbit() & y.signbit())


def _min_max(fn):
    def op(x, y):
        x, y = _promoted(x, y)
        if x.is_floating_point() and (x.requires_grad or y.requires_grad):
            return _MinMax.apply(x, y, fn)
        return _signed_min_max(fn, x, y)

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


class _Abs(torch.autograd.Function):
    """torch.abs whose gradient follows lax.abs's: the cotangent where
    x >= 0 (so at 0 and -0.0 too), its negative elsewhere (at NaN too);
    torch's own gives 0 at 0 and NaN at NaN."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    if x.is_floating_point() and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


_act("abs", lambda x, a: x if x.dtype == torch.bool else _abs(x))
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


# ---------------------------------------------------------------------------
# the rest of the JAX package's math_ops.py: products, activations,
# normalizers, the isfinite family, norms and linear algebra
# ---------------------------------------------------------------------------


@register("matmul_v2")
def matmul_v2(ctx, ins, attrs):
    x, y = _promoted(ins["X"][0], ins["Y"][0])
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [_product(x, y)]}


@register("dot")
def dot(ctx, ins, attrs):
    """jnp.sum(x * y, -1), keeping the axis for a batch of rows: the
    product in the promoted dtype (a narrow int wraps there, two bools
    AND), the sum of an integer or bool product in int32."""
    from .reduce_ops import _narrow_int_sum

    x, y = _promoted(ins["X"][0], ins["Y"][0])
    p = x & y if x.dtype == torch.bool else x * y
    out = torch.sum(p, dim=-1, keepdim=x.dim() > 1)
    return {"Out": [_narrow_int_sum(out, p)]}


@register("addmm")
def addmm(ctx, ins, attrs):
    """beta * Input + alpha * (X @ Y); Python-float scales, so an integer
    operand gives float32, as jnp's weak floats promote it."""
    inp = ins["Input"][0]
    prod = _product(*_promoted(ins["X"][0], ins["Y"][0]))
    return {"Out": [attrs.get("Beta", 1.0) * inp
                    + attrs.get("Alpha", 1.0) * prod]}


@register("kron")
def kron(ctx, ins, attrs):
    return {"Out": [torch.kron(*_promoted(ins["X"][0], ins["Y"][0]))]}


def _no_int(name):
    """An op whose JAX function refuses integer and bool X (TypeError)."""
    def check(x):
        if not x.is_floating_point():
            raise TypeError(f"{name} does not accept dtype {x.dtype}")
        return x

    return check


def _no_bool(name):
    """An op that negates X first, which jnp refuses for bool."""
    def check(x):
        if x.dtype == torch.bool:
            raise TypeError(f"{name}: neg does not accept dtype bool")
        return x

    return check


def _clip(x, lo, hi):
    """jnp.clip with float bounds: an integer or bool X in float32 first,
    the gradient halved on a bound (``_Clip``)."""
    return _Clip.apply(_inexact(x), lo, hi)


def _maximum0(x):
    """jnp.maximum(x, 0.0) under lax.max's tie rule (``_MinMax``)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return _min_max(torch.maximum)(x, zero)


def _softplus(x):
    """jax.nn.softplus = jnp.logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _log_sigmoid(x, a):
    """jax.nn.log_sigmoid = -softplus(-x), -x in X's own dtype first."""
    return -_softplus(_inexact(-_no_bool("logsigmoid")(x)))


def _softsign(x, a):
    """x / (|x| + 1), |x| and + 1 in X's own dtype (jnp.abs of bool is
    bool, and bool + 1 an int), the division in float32."""
    den = (x.to(torch.int32) if x.dtype == torch.bool else torch.abs(x)) + 1
    return torch.true_divide(x, den)


def _shrink(x, a):
    """soft_shrink: sign(x) * max(|x| - lambda, 0), |x| in X's own dtype
    (an integer X's minimum wraps there), jnp.sign's NaN and -0.0 kept."""
    ax = _abs(_no_bool("soft_shrink")(x))
    return _sign(x, a) * _maximum0(_inexact(ax) - a.get("lambda", 0.5))


def _hard_shrink(x, a):
    ax = x if x.dtype == torch.bool else torch.abs(x)
    return torch.where(ax > a.get("threshold", 0.5), _inexact(x), 0.0)


def _elu(x, a):
    """jax.nn.elu: x where x > 0, else alpha * expm1(x), the expm1 taken
    of 0 where x > 0 (no overflow, no NaN gradient)."""
    x = _inexact(x)
    pos = x > 0
    return torch.where(pos, x, a.get("alpha", 1.0) * torch.expm1(
        torch.where(pos, torch.zeros_like(x), x)))


_act("sigmoid", lambda x, a: torch.sigmoid(_no_int("logistic")(x)))
_act("tan", lambda x, a: torch.tan(_inexact(x)))
_act("acos", lambda x, a: torch.acos(_inexact(x)))
_act("asin", lambda x, a: torch.asin(_inexact(x)))
_act("atan", lambda x, a: torch.atan(_inexact(x)))
_act("sinh", lambda x, a: torch.sinh(_inexact(x)))
_act("cosh", lambda x, a: torch.cosh(_inexact(x)))
_act("log2", lambda x, a: torch.log2(_inexact(x)))
_act("log10", lambda x, a: torch.log10(_inexact(x)))
_act("log1p", lambda x, a: torch.log1p(_inexact(x)))
_act("softplus", lambda x, a: _softplus(_inexact(x)))
_act("softsign", _softsign)
_act("silu", lambda x, a: x * torch.sigmoid(_no_int("logistic")(x)))
_act("swish", lambda x, a: _inexact(x) * torch.sigmoid(
    a.get("beta", 1.0) * _inexact(x)))
_act("logsigmoid", _log_sigmoid)
_act("relu6", lambda x, a: _clip(x, 0.0, a.get("threshold", 6.0)))
# jax.nn.leaky_relu: x where x >= 0, so the gradient at 0 is 1
_act("leaky_relu", lambda x, a: torch.where(
    x >= 0, _inexact(x), a.get("alpha", 0.02) * _inexact(x)))
_act("elu", _elu)
_act("hard_sigmoid", lambda x, a: _clip(
    a.get("slope", 0.2) * _inexact(x) + a.get("offset", 0.5), 0.0, 1.0))
_act("hard_swish", lambda x, a: _inexact(x) * _clip(
    _inexact(x) + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), _inexact(x), 0.0))
_act("hard_shrink", _hard_shrink)
_act("soft_shrink", _shrink)
_act("erf", lambda x, a: torch.erf(_no_int("erf")(x)))
_act("mish", lambda x, a: _inexact(x) * torch.tanh(_softplus(_inexact(x))))


@register("prelu")
def prelu(ctx, ins, attrs):
    """x where x > 0, else alpha * x; a "channel" alpha on axis 1."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register("log_softmax")
def log_softmax(ctx, ins, attrs):
    """jax.nn.log_softmax: a float X as torch.log_softmax; an integer X
    gives float32, x - max taken in X's own dtype first (a uint8 X wraps
    there); a bool X raises, as jnp's subtraction refuses it."""
    x, axis = ins["X"][0], attrs.get("axis", -1)
    if x.is_floating_point():
        return {"Out": [torch.log_softmax(x, dim=axis)]}
    if x.dtype == torch.bool:
        raise TypeError("log_softmax: sub does not accept dtype bool")
    s = (x - torch.amax(x, dim=axis, keepdim=True)).float()
    return {"Out": [s - torch.log(torch.exp(s).sum(dim=axis,
                                                   keepdim=True))]}


@register("maxout")
def maxout(ctx, ins, attrs):
    """The max over each group of ``groups`` channels (``extreme``: the
    gradient split evenly between tied values, as jnp.max's VJP does)."""
    x = ins["X"][0]
    g = attrs["groups"]
    n, c = x.shape[0], x.shape[1]
    return {"Out": [extreme(x.reshape((n, c // g, g) + tuple(x.shape[2:])),
                            False, dim=2)]}


@register("isfinite", stop_gradient=True, no_vjp_grad=True)
def isfinite(ctx, ins, attrs):
    """One bool of shape [1]: every element of every X finite (reference
    isfinite_op)."""
    ok = torch.ones((), dtype=torch.bool, device=ins["X"][0].device)
    for x in ins["X"]:
        ok = ok & torch.isfinite(x).all()
    return {"Out": [ok.reshape(1)]}


@register("isinf", stop_gradient=True, no_vjp_grad=True)
def isinf_reduce(ctx, ins, attrs):
    return {"Out": [torch.isinf(ins["X"][0]).any().reshape(1)]}


@register("isnan", stop_gradient=True, no_vjp_grad=True)
def isnan_reduce(ctx, ins, attrs):
    return {"Out": [torch.isnan(ins["X"][0]).any().reshape(1)]}


for _name, _fn in (("isfinite_v2", torch.isfinite), ("isinf_v2", torch.isinf),
                   ("isnan_v2", torch.isnan)):
    register(_name, stop_gradient=True, no_vjp_grad=True)(
        lambda ctx, ins, attrs, _fn=_fn: {"Out": [_fn(ins["X"][0])]})


@register("p_norm")
def p_norm(ctx, ins, attrs):
    """jnp.linalg.norm's vector norms, spelled as jnp spells them (an
    integer X in float32): inf / -inf the max / min of |x| (the max then
    taken with 0, jnp's ``initial``, under lax.max's tie rule), 0 the count
    of nonzeros, 1 the sum of |x|, 2 sqrt(sum(x * x)), else
    sum(|x| ** p) ** (1 / p).  So the gradient of the 2-norm at a zero
    vector is NaN, as in JAX (torch.linalg.vector_norm gives 0), and |x|
    takes lax.abs's derivative (``_abs``)."""
    x = _inexact(ins["X"][0])
    p = float(attrs.get("porder", 2.0))
    axis = attrs.get("axis", -1)
    keep = attrs.get("keepdim", False)
    if p == math.inf:   # amax(.., initial=0): a max with 0 after
        return {"Out": [_maximum0(torch.amax(_abs(x), dim=axis,
                                             keepdim=keep))]}
    if p == -math.inf:
        return {"Out": [torch.amin(_abs(x), dim=axis, keepdim=keep)]}
    if p == 0:
        return {"Out": [torch.sum(x != 0, dim=axis, keepdim=keep,
                                  dtype=x.dtype)]}
    if p == 1:
        return {"Out": [torch.sum(_abs(x), dim=axis, keepdim=keep)]}
    if p == 2:
        return {"Out": [torch.sqrt(torch.sum(x * x, dim=axis,
                                             keepdim=keep))]}
    s = torch.sum(_abs(x) ** p, dim=axis, keepdim=keep)
    return {"Out": [s ** torch.reciprocal(torch.tensor(p, dtype=x.dtype))
                    .item()]}


@register("trace")
def trace_op(ctx, ins, attrs):
    """jnp.trace: the sum of the ``offset`` diagonal of (axis1, axis2); an
    integer or bool X sums in int32 (uint8 in uint32)."""
    from .reduce_ops import _narrow_int_sum

    x = ins["Input"][0]
    d = torch.diagonal(x, attrs.get("offset", 0), attrs.get("axis1", 0),
                       attrs.get("axis2", 1))
    return {"Out": [_narrow_int_sum(torch.sum(d, dim=-1), x)]}


@register("cholesky")
def cholesky(ctx, ins, attrs):
    """jnp.linalg.cholesky: the factor of X's symmetric part (so the
    gradient is symmetric, as lax's); a matrix that is not positive
    definite gives NaN in the lower triangle, not an error; ``upper``
    transposes."""
    x = ins["X"][0]
    sym = (x + x.transpose(-1, -2)) / 2
    if x.device.type == "meta":
        out = sym
    else:
        low, info = torch.linalg.cholesky_ex(sym)
        bad = (info != 0).reshape(info.shape + (1, 1))
        out = torch.where(bad, torch.full_like(low, math.nan), low).tril()
    if attrs.get("upper", False):
        out = out.transpose(-1, -2)
    return {"Out": [out]}


@register("inverse")
def inverse(ctx, ins, attrs):
    """jnp.linalg.inv: a singular matrix gives infinities, not an
    error."""
    x = ins["Input"][0]
    if x.device.type == "meta":
        return {"Output": [x.clone()]}
    return {"Output": [torch.linalg.inv_ex(x).inverse]}


@register("matrix_power")
def matrix_power(ctx, ins, attrs):
    """jnp.linalg.matrix_power's square-and-multiply, its products in the
    same order: n = 0 the identity, n < 0 the power of the inverse."""
    x, n = ins["X"][0], int(attrs["n"])
    if n == 0:
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return {"Out": [eye.expand(x.shape).clone()]}
    if n < 0:
        x, n = inverse(ctx, {"Input": [x]}, {})["Output"][0], -n
    z = result = None
    while n > 0:
        z = x if z is None else _product(z, z)
        n, bit = divmod(n, 2)
        if bit:
            result = z if result is None else _product(result, z)
    return {"Out": [result]}


@register("logsumexp")
def logsumexp(ctx, ins, attrs):
    """jax.scipy.special.logsumexp: an integer X in float32; the max taken
    out, as a constant and only where finite; at least rank 1."""
    x = _inexact(ins["X"][0])
    axis = attrs.get("axis", None)
    dims = tuple(range(x.dim())) if not axis else tuple(
        a % x.dim() for a in axis)
    keep = attrs.get("keepdim", False)
    amax = torch.amax(x.detach(), dim=dims, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0)
    s = torch.sum(torch.exp(x - amax), dim=dims, keepdim=keep)
    out = torch.log(torch.abs(s)) + (amax if keep else amax.squeeze(dims))
    return {"Out": [out.reshape(1) if out.dim() == 0 else out]}


@register("cos_sim")
def cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity (reference cos_sim_op.cc): X [N, D],
    Y [N, D] or [1, D]; Out [N, 1] and the saved norms; the floor 1e-12
    under lax.max's tie rule."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    d = torch.sum(x * y, dim=1, keepdim=True)
    den = xn * yn
    floor = torch.tensor(1e-12, dtype=den.dtype, device=den.device)
    return {"Out": [d / _min_max(torch.maximum)(den, floor)],
            "XNorm": [xn], "YNorm": [yn]}
