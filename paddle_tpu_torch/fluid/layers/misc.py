"""Miscellaneous layers the hapi Transformer NMT builds with.

Parity surface: python/paddle/fluid/layers (add_position_encoding) in the
reference; ported from the JAX package's ``fluid/layers/misc.py``.
"""
from __future__ import annotations

import numpy as np

from . import nn as _nn
from . import tensor as _tensor


def add_position_encoding(input, alpha, beta, name=None):
    """x * alpha + beta * the sinusoid position encoding of [T, d]
    (reference add_position_encoding_op.cc), emitted as a constant table
    (``assign``), a broadcast (``expand_as``) and elementwise ops."""
    b, t, d = input.shape
    half = d // 2
    pos = np.arange(t, dtype=np.float32)[:, None]
    inv = 1.0 / np.power(10000.0, np.arange(half, dtype=np.float32) / half)
    table = np.zeros((t, d), np.float32)
    table[:, :half] = np.sin(pos * inv[None, :])
    table[:, half:2 * half] = np.cos(pos * inv[None, :])
    enc = _tensor.assign(table)
    enc3 = _nn.reshape(enc, [1, t, d])
    return _nn.elementwise_add(
        _nn.scale(input, scale=float(alpha)),
        _nn.scale(_nn.expand_as(enc3, input), scale=float(beta)),
    )
