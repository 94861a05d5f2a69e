"""Optimizer update ops: sgd, momentum, adam, adamw, adamax, adagrad,
decayed_adagrad, rmsprop, lamb, lars_momentum, ftrl and dpsgd.

Parity surface: reference operators/optimizers/ (sgd_op.cc,
momentum_op.cc, adam_op.cc, adamax_op.cc, adagrad_op.cc, rmsprop_op.cc,
lamb_op.cc, lars_momentum_op.cc, ftrl_op.cc, dpsgd_op.cc); ported from
the JAX package's ``ops/optimizer_ops.py``.  Like the reference, updates
are ops in the program: the Executor runs them after the backward in the
same step, and parameters and moments never leave the device.  Each
output is a new tensor (the JAX package's functional update); the
Executor writes ``ParamOut`` / ``Moment*Out`` back to the scope under
the input names.  ``dpsgd`` draws its noise from the step's generator
(``ctx.rng()``): the same seed gives the same bits in the port, which
are not the JAX PRNG's.

ZeRO-2 (fleet's ``strategy.sharding``): an update op with the attr
``zero_axis`` reads its moments as this rank's block of rows (dim 0
split over the axis) and updates only those rows of the parameter, from
the same rows of the (already averaged) gradient; the new rows are
all-gathered over the axis into the whole parameter.  An elementwise
update is the unsharded one bit for bit.  lamb and lars_momentum take
norms of the whole parameter and update: their squared sums over the
rows are summed over the axis (``_norm``), so the trust ratio is the
unsharded one.  A parameter that tp, pp or ep split reaches these ops as
a block, and fleet refuses that (``_finish_param_sharding``).

float16 AMP's skip (the reference's conditional skip of an overflowed
step, branch free): an update op with a ``SkipUpdate`` input (the
decorator's bool [1] ``found_inf``) selects each of its old inputs for
the matching output where the flag is set, so a skipped step leaves the
parameter, its moments and its beta powers bit for bit.
"""
from __future__ import annotations

import functools

import torch

from .registry import register


def _zero(update):
    """``update`` on this rank's rows when the op is ZeRO-sharded."""

    @functools.wraps(update)
    def emit(ctx, ins, attrs):
        axis = _zero_axis(ctx, attrs)
        if axis is None:
            return update(ctx, ins, attrs)
        from .. import distributed as dist

        mesh = ctx.mesh
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


def _skippable(update):
    """``update``, with every output replaced by its input where the
    op's ``SkipUpdate`` flag is set."""

    @functools.wraps(update)
    def emit(ctx, ins, attrs):
        skip = ins.get("SkipUpdate")
        if not skip:
            return update(ctx, ins, attrs)
        flag = skip[0].reshape(()).to(torch.bool)
        ins = {k: v for k, v in ins.items() if k != "SkipUpdate"}
        out = update(ctx, ins, attrs)
        for slot, vals in out.items():
            old = ins.get(slot[:-3]) or ins.get(slot[:-3] + "ulator")
            if old is None:
                raise ValueError(f"SkipUpdate: {slot} has no input to keep")
            out[slot] = [torch.where(flag, old[0], vals[0])]
        return out

    return emit


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _zero_axis(ctx, attrs):
    """The mesh axis a ZeRO-sharded update op holds a block of rows on,
    or None (the test of ``_zero``)."""
    axis = attrs.get("zero_axis")
    mesh = ctx.mesh
    if not axis or mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return axis


def _norm(ctx, attrs, x):
    """The L2 norm of the whole tensor ``x`` is a block of: under ZeRO the
    rows' squared sum is summed over the axis first."""
    axis = _zero_axis(ctx, attrs)
    if axis is None:
        return torch.linalg.vector_norm(x)
    from .. import distributed as dist

    sq = torch.sum(torch.square(x))
    return torch.sqrt(dist.all_reduce(sq, group=axis, mesh=ctx.mesh))


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


def adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    mo = b1 * m + (1 - b1) * g
    info = torch.maximum(b2 * inf, torch.abs(g))
    p_out = p - (lr / (1 - b1p.reshape(()))) * (mo / (info + eps))
    return {"ParamOut": [p_out], "MomentOut": [mo], "InfNormOut": [info]}


def adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    mo = m + g * g
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(mo) + eps)],
            "MomentOut": [mo]}


def decayed_adagrad(ctx, ins, attrs):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mo = decay * m + (1 - decay) * g * g
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(mo) + eps)],
            "MomentOut": [mo]}


def rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * g * g
    out = {"MeanSquareOut": [ms_out]}
    if attrs.get("centered", False):
        mg_out = rho * ins["MeanGrad"][0] + (1 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
        out["MeanGradOut"] = [mg_out]
    else:
        denom = ms_out + eps
    mom_out = mu * mom + _lr(ins) * g / torch.sqrt(denom)
    out.update(ParamOut=[p - mom_out], MomentOut=[mom_out])
    return out


def lamb(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    lr = _lr(ins)
    g = g.to(m1.dtype)
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    mhat = m1o / (1 - b1p.reshape(()))
    vhat = m2o / (1 - b2p.reshape(()))
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p
    p_norm, r_norm = _norm(ctx, attrs, p), _norm(ctx, attrs, r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    return {
        "ParamOut": [p - lr * trust * r],
        "Moment1Out": [m1o],
        "Moment2Out": [m2o],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


def lars_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(ins)
    p_norm, g_norm = _norm(ctx, attrs, p), _norm(ctx, attrs, g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                           lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [p - v_out], "VelocityOut": [v_out]}


def ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if power == -0.5:
        new_acc, acc = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        new_acc, acc = new_sq ** (-power), sq ** (-power)
    lin_out = lin + g - (new_acc - acc) / lr * p
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": [pre / (new_acc / lr + 2 * l2)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [lin_out]}


def dpsgd(ctx, ins, attrs):
    """Differentially private SGD (reference dpsgd_op.cc): the gradient
    clipped to norm ``clip``, plus Gaussian noise of std sigma * clip."""
    p, g = ins["Param"][0], ins["Grad"][0]
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    batch = attrs.get("batch_size", 16.0)
    scale = torch.clamp(clip / torch.clamp(torch.linalg.vector_norm(g),
                                           min=1e-12), max=1.0)
    noise = sigma * clip * torch.randn(g.shape, generator=ctx.rng(),
                                       device=g.device, dtype=g.dtype)
    return {"ParamOut": [p - _lr(ins) * (g * scale + noise) / batch]}


_UPDATES = (("sgd", sgd), ("momentum", momentum), ("adam", adam),
            ("adamw", adamw), ("adamax", adamax), ("adagrad", adagrad),
            ("decayed_adagrad", decayed_adagrad), ("rmsprop", rmsprop),
            ("lamb", lamb), ("lars_momentum", lars_momentum),
            ("ftrl", ftrl), ("dpsgd", dpsgd))
# the op types that take a SkipUpdate input
UPDATE_OPS = frozenset(name for name, _ in _UPDATES)
for _name, _fn in _UPDATES:
    register(_name, no_vjp_grad=True)(_skippable(_zero(_fn)))
