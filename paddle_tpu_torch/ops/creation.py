"""Tensor creation / initialization ops.

Parity surface: reference ops fill_constant_op.cc,
fill_constant_batch_size_like_op.cc, fill_any_like_op.cc,
uniform_random_op.cc, gaussian_random_op.cc,
truncated_gaussian_random_op.cc, assign_value_op.cc, cast_op.cc,
scale_op.cc, shape_op.cc, range_op.cc, linspace_op.cc, eye_op.cc,
fill_zeros_like_op.cc, assign_op.cc; ported from the JAX package's
``ops/creation.py``, every op type of it, with its ``no_vjp_grad``
flags.  None has a ``pallas_call`` in the JAX package: each is plain
torch (``range``: numpy, as jnp.arange with a step is) on every device.
A constant takes the value lax's convert gives it (an integer dtype
saturates and takes NaN as 0); ``range`` and ``linspace`` repeat jnp's
arithmetic in the requested dtype, where torch.arange and
torch.linspace answer otherwise.  Random ops draw from the generator the
Executor's step context hands them (``ctx.rng()``), never from a global
one.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..fluid.dtypes import runtime_dtype, to_torch_dtype
from .registry import register


def _attr_dtype(attrs, default="float32"):
    return to_torch_dtype(runtime_dtype(attrs.get("dtype", default)))


def _attr_shape(attrs):
    return tuple(int(d) for d in attrs.get("shape", ()))


def _fill_scalar(value, dt):
    """``value`` as lax's convert gives it in ``dt``: an integer dtype
    saturates (torch.full raises) and takes NaN as 0, a bool is value !=
    0 (NaN true), a float rounds."""
    v = float(value)
    if dt == torch.bool or dt.is_floating_point:
        return v
    if math.isnan(v):
        return 0
    info = torch.iinfo(dt)
    return int(min(max(v, info.min), info.max))


def _full(shape, value, dt, device):
    return torch.full(tuple(shape), _fill_scalar(value, dt), dtype=dt,
                      device=device)


def _saturate(x, dt):
    """A float tensor in an integer dtype as XLA's convert gives it: NaN
    to 0, out of range saturated (torch's cast is undefined there; the
    bounds are exact in float64, not in f32)."""
    info = torch.iinfo(dt)
    return torch.nan_to_num(x.double(), nan=0.0).clamp(
        info.min, info.max).to(dt)


def _uniform(ctx, shape, lo, hi):
    u = torch.rand(shape, generator=ctx.rng(), device=ctx.device)
    return u * (hi - lo) + lo


@register("fill_constant", no_vjp_grad=True)
def fill_constant(ctx, ins, attrs):
    val = attrs.get("value", 0.0)
    if attrs.get("str_value"):
        val = float(attrs["str_value"])  # str_value overrides value
    return {"Out": [_full(_attr_shape(attrs), val, _attr_dtype(attrs),
                          ctx.device)]}


@register("fill_constant_batch_size_like", no_vjp_grad=True)
def fill_constant_batch_size_like(ctx, ins, attrs):
    shape = list(_attr_shape(attrs))
    shape[int(attrs.get("output_dim_idx", 0))] = ins["Input"][0].shape[
        int(attrs.get("input_dim_idx", 0))]
    return {"Out": [_full(shape, attrs.get("value", 0.0),
                          _attr_dtype(attrs), ctx.device)]}


@register("fill_any_like", no_vjp_grad=True)
def fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dt = attrs.get("dtype")
    dt = x.dtype if dt is None else to_torch_dtype(runtime_dtype(dt))
    return {"Out": [_full(x.shape, attrs.get("value", 0.0), dt, x.device)]}


@register("shape", stop_gradient=True, no_vjp_grad=True)
def shape_op(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(list(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register("range", no_vjp_grad=True)
def range_op(ctx, ins, attrs):
    """jnp.arange(start, end, step, dtype), which with a step hands the
    work to numpy: ``np.arange`` in the requested dtype (the first two
    values rounded to it, then start + i * delta in it), so
    arange(0, 1, 0.1) in float32 ends in 0.90000004, where torch.arange
    gives 0.9.  bfloat16 (no numpy dtype here) as ml_dtypes fills it:
    start + i * delta in float32 from the two rounded values."""
    start, end = attrs["start"], attrs["end"]
    step = attrs.get("step", 1)
    dt = runtime_dtype(attrs.get("dtype", "int64"))
    tdt = to_torch_dtype(dt)
    if tdt != torch.bfloat16:
        return {"Out": [torch.as_tensor(np.arange(start, end, step, dtype=dt),
                                        device=ctx.device)]}
    n = max(0, math.ceil((end - start) / step))
    two = torch.tensor([start, start + step],
                       dtype=torch.float64).to(tdt).float()
    f = np.float32
    vals = f(two[0]) + np.arange(n).astype(f) * (f(two[1]) - f(two[0]))
    if n:
        vals[0] = f(two[0])
    return {"Out": [torch.as_tensor(vals, device=ctx.device).to(tdt)]}


@register("eye", no_vjp_grad=True)
def eye(ctx, ins, attrs):
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", n))
    return {"Out": [torch.eye(n, m, dtype=_attr_dtype(attrs),
                              device=ctx.device)]}


@register("linspace", no_vjp_grad=True)
def linspace(ctx, ins, attrs):
    """jnp.linspace(start, stop, num) (endpoint included) op by op in its
    computation dtype (the requested float dtype, float32 for an integer
    one): start and stop rounded to float32 and then to it, step = iota /
    (num - 1), start * (1 - step) + stop * step, then stop itself last;
    an integer dtype floors and converts (saturating).  torch.linspace
    computes the points otherwise and differs in most of them by an ulp
    or so.  (XLA's compiler may fold iota / (num - 1) into a reciprocal
    product and fuse the products into FMAs, which moves a jitted JAX
    program's own points by an ulp; this is jnp's arithmetic as
    written.)"""
    dt = _attr_dtype(attrs)
    comp = dt if dt.is_floating_point else torch.float32
    num = int(attrs["num"])

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32,
                            device=ctx.device).to(comp)

    start, stop = scalar(attrs["start"]), scalar(attrs["stop"])
    if num > 1:
        div = num - 1
        step = (torch.arange(div, dtype=comp, device=ctx.device)
                / torch.tensor(div, dtype=comp, device=ctx.device))
        out = torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if not dt.is_floating_point:
        out = _saturate(torch.floor(out), dt) if dt != torch.bool \
            else out.to(dt)
    return {"Out": [out]}


@register("uniform_random", no_vjp_grad=True)
def uniform_random(ctx, ins, attrs):
    out = _uniform(ctx, _attr_shape(attrs), float(attrs.get("min", -1.0)),
                   float(attrs.get("max", 1.0)))
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("gaussian_random", no_vjp_grad=True)
def gaussian_random(ctx, ins, attrs):
    z = torch.randn(_attr_shape(attrs), generator=ctx.rng(),
                    device=ctx.device)
    out = float(attrs.get("mean", 0.0)) + float(attrs.get("std", 1.0)) * z
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("truncated_gaussian_random", no_vjp_grad=True)
def truncated_gaussian_random(ctx, ins, attrs):
    """Normal truncated to [-2, 2] standard deviations (as
    ``jax.random.truncated_normal(-2, 2)``): inverse-CDF sampling of a
    uniform drawn between the CDF's values at -2 and 2."""
    cdf = [0.5 * (1.0 + math.erf(a / math.sqrt(2.0))) for a in (-2.0, 2.0)]
    u = _uniform(ctx, _attr_shape(attrs), cdf[0], cdf[1])
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    out = float(attrs.get("mean", 0.0)) + float(attrs.get("std", 1.0)) * z
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("assign_value", no_vjp_grad=True)
def assign_value(ctx, ins, attrs):
    dt = runtime_dtype(attrs.get("dtype", "float32"))
    vals = attrs.get("values")
    if vals is None:  # Paddle's typed attr names
        vals = (attrs.get("fp32_values") or attrs.get("int32_values")
                or attrs.get("int64_values"))
    arr = np.asarray(vals, dtype=dt).reshape(_attr_shape(attrs))
    return {"Out": [torch.as_tensor(arr, device=ctx.device)]}


@register("fill_zeros_like", no_vjp_grad=True)
def fill_zeros_like(ctx, ins, attrs):
    """The zero cotangent of an output no grad reached (fluid.backward)."""
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("assign")
def assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register("cast")
def cast(ctx, ins, attrs):
    x = ins["X"][0]
    dt = to_torch_dtype(runtime_dtype(
        attrs.get("out_dtype", attrs.get("dtype", "float32"))))
    if x.is_floating_point() and not (dt.is_floating_point or dt == torch.bool):
        return {"Out": [_saturate(x, dt)]}
    return {"Out": [x.to(dt)]}


@register("scale")
def scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    # the bias takes X's dtype first, as jnp.asarray(b, x.dtype) does: an
    # integer X drops its fraction, a bf16 X rounds it
    b = torch.tensor(attrs.get("bias", 0.0), dtype=x.dtype)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register("increment")
def increment(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                     device=x.device)]}
