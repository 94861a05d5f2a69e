"""Parameter initializers. Parity surface: python/paddle/fluid/initializer.py
(ConstantInitializer, UniformInitializer, NormalInitializer,
TruncatedNormalInitializer, XavierInitializer, MSRAInitializer,
NumpyArrayInitializer, BilinearInitializer), ported from the JAX
package's ``fluid/initializer.py``, all of it.  Each appends an init op
to the startup program; the Executor runs it once and the value lives in
the Scope.  The random ones draw from the generator the Executor's step
context hands each op, never from a global one.
"""
from __future__ import annotations

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = float(value)

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed},
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed},
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming He init (reference initializer.py MSRAInitializer): uniform
    in +-sqrt(6 / fan_in), or normal with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0, negative_slope=0.0,
                 nonlinearity="relu"):
        self.uniform = uniform
        self.fan_in, self.seed = fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / fan_in))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "values": self.value.astype(var.dtype).flatten().tolist()},
        )


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a ``conv2d_transpose``
    upsampler: every [kh, kw] slice of the
    4-D weight holds (1 - |x / f - c|)(1 - |y / f - c|), f = ceil(kw / 2),
    c = (2 f - 1 - f % 2) / (2 f); the JAX package's array bit for bit,
    through ``assign_value``."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs a 4-D weight")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        idx = np.arange(int(np.prod(shape)))
        x = idx % shape[3]
        y = (idx // shape[3]) % shape[2]
        weight.flat[:] = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        return NumpyArrayInitializer(weight)(var, block)


# paddle-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
