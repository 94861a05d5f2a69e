"""Tensor creation / initialization ops.

Parity surface: reference ops fill_constant_op.cc, uniform_random_op.cc,
gaussian_random_op.cc, truncated_gaussian_random_op.cc, assign_value_op.cc,
cast_op.cc, scale_op.cc, fill_zeros_like_op.cc, assign_op.cc; ported
from the JAX package's ``ops/creation.py``, with its ``no_vjp_grad``
flags.  Random ops draw from the generator the Executor's step context
hands them (``ctx.rng()``), never from a global one.
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


def _uniform(ctx, shape, lo, hi):
    u = torch.rand(shape, generator=ctx.rng(), device=ctx.device)
    return u * (hi - lo) + lo


@register("fill_constant", no_vjp_grad=True)
def fill_constant(ctx, ins, attrs):
    val = attrs.get("value", 0.0)
    if attrs.get("str_value"):
        val = float(attrs["str_value"])  # str_value overrides value
    return {"Out": [torch.full(_attr_shape(attrs), val,
                               dtype=_attr_dtype(attrs), device=ctx.device)]}


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
        # XLA's convert saturates and maps NaN to 0; torch's is undefined
        # out of range.  The bounds are exact in float64, not in f32.
        info = torch.iinfo(dt)
        x = torch.nan_to_num(x.double(), nan=0.0).clamp(info.min, info.max)
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
