"""Tensor creation / initialization ops.

Parity surface: reference ops fill_constant_op.cc, uniform_random_op.cc,
gaussian_random_op.cc, truncated_gaussian_random_op.cc, assign_value_op.cc,
cast_op.cc, scale_op.cc; ported from the JAX package's
``ops/creation.py``.  Random ops draw from the generator the Executor's
step context hands them (``ctx.rng()``), never from a global one.
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


@register("fill_constant")
def fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(_attr_shape(attrs), attrs.get("value", 0.0),
                               dtype=_attr_dtype(attrs), device=ctx.device)]}


@register("uniform_random")
def uniform_random(ctx, ins, attrs):
    out = _uniform(ctx, _attr_shape(attrs), float(attrs.get("min", -1.0)),
                   float(attrs.get("max", 1.0)))
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("gaussian_random")
def gaussian_random(ctx, ins, attrs):
    z = torch.randn(_attr_shape(attrs), generator=ctx.rng(),
                    device=ctx.device)
    out = float(attrs.get("mean", 0.0)) + float(attrs.get("std", 1.0)) * z
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("truncated_gaussian_random")
def truncated_gaussian_random(ctx, ins, attrs):
    """Normal truncated to [-2, 2] standard deviations (as
    ``jax.random.truncated_normal(-2, 2)``): inverse-CDF sampling of a
    uniform drawn between the CDF's values at -2 and 2."""
    cdf = [0.5 * (1.0 + math.erf(a / math.sqrt(2.0))) for a in (-2.0, 2.0)]
    u = _uniform(ctx, _attr_shape(attrs), cdf[0], cdf[1])
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
    out = float(attrs.get("mean", 0.0)) + float(attrs.get("std", 1.0)) * z
    return {"Out": [out.to(_attr_dtype(attrs))]}


@register("assign_value")
def assign_value(ctx, ins, attrs):
    dt = runtime_dtype(attrs.get("dtype", "float32"))
    arr = np.asarray(attrs["values"], dtype=dt).reshape(_attr_shape(attrs))
    return {"Out": [torch.as_tensor(arr, device=ctx.device)]}


@register("cast")
def cast(ctx, ins, attrs):
    dt = attrs.get("out_dtype", attrs.get("dtype", "float32"))
    return {"Out": [ins["X"][0].to(to_torch_dtype(runtime_dtype(dt)))]}


@register("scale")
def scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}
