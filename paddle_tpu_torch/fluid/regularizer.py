"""Weight-decay regularizers. Parity: python/paddle/fluid/regularizer.py;
ported from the JAX package's ``fluid/regularizer.py`` (the same scale /
sign / sum ops under the same grad-var names)."""
from __future__ import annotations


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad, block):
        decayed = block.create_var(
            name=grad.name + "@L2DECAY", dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decayed]},
            attrs={"scale": self.regularization_coeff},
        )
        out = block.create_var(
            name=grad.name + "@REG", dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(
            type="sum", inputs={"X": [grad, decayed]}, outputs={"Out": [out]}
        )
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(
            name=grad.name + "@L1SIGN", dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decayed = block.create_var(
            name=grad.name + "@L1DECAY", dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decayed]},
            attrs={"scale": self.regularization_coeff},
        )
        out = block.create_var(
            name=grad.name + "@REG", dtype=grad.dtype, shape=grad.shape
        )
        block.append_op(
            type="sum", inputs={"X": [grad, decayed]}, outputs={"Out": [out]}
        )
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
        else:
            out.append((param, reg.append_regularization_op(param, grad, grad.block)))
    return out
