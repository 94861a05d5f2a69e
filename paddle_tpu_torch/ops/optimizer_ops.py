"""Optimizer update ops: sgd, momentum, adam, adamw.

Parity surface: reference operators/optimizers/ (sgd_op.cc,
momentum_op.cc, adam_op.cc); ported from the JAX package's
``ops/optimizer_ops.py``.  Like the reference, updates are ops in the
program: the Executor runs them after the backward in the same step, and
parameters and moments never leave the device.  Each output is a new
tensor (the JAX package's functional update); the Executor writes
``ParamOut`` / ``Moment*Out`` back to the scope under the input names.
The other eight update ops of the JAX package (adamax, adagrad,
decayed_adagrad, rmsprop, lamb, lars_momentum, ftrl, dpsgd) are not
ported yet (ROADMAP A6).

ZeRO-2 (fleet's ``strategy.sharding``): an update op with the attr
``zero_axis`` reads its moments as this rank's block of rows (dim 0
split over the axis) and updates only those rows of the parameter, from
the same rows of the (already averaged) gradient; the new rows are
all-gathered over the axis into the whole parameter.  The update is
elementwise, so every element is the unsharded update's, bit for bit.
"""
from __future__ import annotations

import functools

import torch

from .registry import register


def _zero(update):
    """``update`` on this rank's rows when the op is ZeRO-sharded."""

    @functools.wraps(update)
    def emit(ctx, ins, attrs):
        axis = attrs.get("zero_axis")
        mesh = ctx.mesh
        if not axis or mesh is None or mesh.shape.get(axis, 1) <= 1:
            return update(ctx, ins, attrs)
        from .. import distributed as dist

        p = ins["Param"][0]
        n = mesh.shape[axis]
        blk = p.shape[0] // n
        rows = slice(mesh.coords[axis] * blk, (mesh.coords[axis] + 1) * blk)
        for slot, vals in ins.items():
            v = vals[0]
            if (slot not in ("Param", "Grad") and v.dim() == p.dim()
                    and v.shape[0] not in (blk, 1)):
                raise ValueError(
                    f"ZeRO update: {slot} holds {v.shape[0]} rows, this "
                    f"rank's block of the {p.shape[0]} over {axis!r} is "
                    f"{blk}")
        ins = dict(ins, Param=[p[rows]], Grad=[ins["Grad"][0][rows]])
        out = update(ctx, ins, attrs)
        out["ParamOut"] = [dist.all_gather(out["ParamOut"][0].contiguous(),
                                           axis, 0, mesh)]
        return out

    return emit


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [p - _lr(ins) * g.to(p.dtype)]}


def momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    if attrs.get("regularization_method", "") == "l2_decay":
        g = g + attrs.get("regularization_coeff", 0.0) * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - lr * (g + mu * v_out)
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


def adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    g = g.to(m1.dtype)
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t * (m1o / (torch.sqrt(m2o) + eps)).to(p.dtype)
    return {
        "ParamOut": [p_out.to(p.dtype)],
        "Moment1Out": [m1o],
        "Moment2Out": [m2o],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


def adamw(ctx, ins, attrs):
    coeff = attrs.get("coeff", 0.01)
    lr = _lr(ins)
    p = ins["Param"][0]
    out = adam(ctx, ins, attrs)
    # decoupled weight decay (AdamW): decay applied on top of adam step
    if attrs.get("with_decay", True):
        out["ParamOut"] = [out["ParamOut"][0] - lr * coeff * p]
    return out


for _name, _fn in (("sgd", sgd), ("momentum", momentum), ("adam", adam),
                   ("adamw", adamw)):
    register(_name, no_vjp_grad=True)(_zero(_fn))
