"""In-graph learning-rate schedules.

Parity surface: the reference's python/paddle/fluid/layers/
learning_rate_scheduler.py (noam_decay, exponential_decay,
natural_exp_decay, inverse_time_decay, polynomial_decay, piecewise_decay,
cosine_decay, linear_lr_warmup); ported from the JAX package's
``fluid/learning_rate_scheduler.py``, op for op.

The schedule is part of the main program: a persistable float32 step
counter (``@LR_DECAY_COUNTER@``) is incremented once every run, and the
learning rate is computed from it by ops, so the step, the rate and the
update run together on the device, and a checkpoint of the persistables
carries the counter (a resumed run goes on with its warmup where it
stopped).
"""
from __future__ import annotations

import math

from . import layers
from .framework import Variable, default_main_program, default_startup_program
from .initializer import ConstantInitializer

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin: int = 0) -> Variable:
    """Persistable float32 step counter, incremented once per program run."""
    main_block = default_main_program().global_block()
    if LR_COUNTER_NAME in main_block.vars:
        # counter already materialized in this program: reuse BOTH the var
        # and its increment op (avoid double-increment)
        return main_block.var(LR_COUNTER_NAME)
    counter = main_block.create_var(
        name=LR_COUNTER_NAME, shape=(1,), dtype="float32", persistable=True
    )
    sblock = default_startup_program().global_block()
    sv = sblock.create_var(
        name=LR_COUNTER_NAME, shape=(1,), dtype="float32", persistable=True
    )
    # increment runs before any read, so the first observed value is `begin`
    ConstantInitializer(float(begin) - 1.0)(sv, sblock)
    main_block.append_op(
        type="increment",
        inputs={"X": [counter]},
        outputs={"Out": [counter]},
        attrs={"step": 1.0},
    )
    counter.stop_gradient = True
    return counter


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr = learning_rate * d_model^-0.5 * min(step^-0.5, step*warmup^-1.5)."""
    step = _decay_step_counter(begin=1)
    a = layers.pow(step, -0.5)
    b = layers.scale(step, scale=warmup_steps ** -1.5)
    lr = layers.elementwise_min(a, b)
    return layers.scale(lr, scale=float(learning_rate) * (d_model ** -0.5))


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    return layers.scale(
        layers.elementwise_pow(
            layers.fill_constant([1], "float32", decay_rate), div
        ),
        scale=float(learning_rate),
    )


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    return layers.scale(
        layers.exp(layers.scale(div, scale=-decay_rate)), scale=float(learning_rate)
    )


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    denom = layers.scale(div, scale=decay_rate, bias=1.0)
    return layers.elementwise_div(
        layers.fill_constant([1], "float32", float(learning_rate)), denom
    )


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False):
    step = _decay_step_counter()
    if cycle:
        ratio = layers.scale(step, scale=1.0 / decay_steps)
        div_res = layers.ceil(ratio)
        # avoid zero: when step == 0, use 1
        # the JAX package's unread zero, kept: the same ops, op for op
        layers.fill_constant([1], "float32", 0.0)
        one = layers.fill_constant([1], "float32", 1.0)
        div_res = layers.elementwise_max(div_res, one)
        decay_steps_var = layers.scale(div_res, scale=float(decay_steps))
        frac = layers.elementwise_div(step, decay_steps_var)
    else:
        mx = layers.fill_constant([1], "float32", float(decay_steps))
        capped = layers.elementwise_min(step, mx)
        frac = layers.scale(capped, scale=1.0 / decay_steps)
    one_minus = layers.scale(frac, scale=-1.0, bias=1.0)
    poly = layers.pow(one_minus, power)
    return layers.scale(poly, scale=float(learning_rate) - end_learning_rate, bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] for step in (boundaries[i-1], boundaries[i]], branch-free
    (a masked sum): no control flow, the same ops every step."""
    assert len(values) == len(boundaries) + 1
    step = _decay_step_counter()
    lr = layers.fill_constant([1], "float32", float(values[0]))
    for i, b in enumerate(boundaries):
        bound = layers.fill_constant([1], "float32", float(b))
        past = layers.cast(layers.less_than(bound, step), "float32")  # step > b
        # lr = past ? values[i+1] : lr
        lr = layers.elementwise_add(
            layers.elementwise_mul(past, layers.fill_constant([1], "float32", float(values[i + 1]))),
            layers.elementwise_mul(layers.scale(past, scale=-1.0, bias=1.0), lr),
        )
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    epoch = layers.floor(layers.scale(step, scale=1.0 / step_each_epoch))
    cos_arg = layers.scale(epoch, scale=math.pi / epochs)
    return layers.scale(
        layers.cos(cos_arg), scale=0.5 * float(learning_rate), bias=0.5 * float(learning_rate)
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr -> end_lr over warmup_steps, then the wrapped
    schedule (variable or float)."""
    step = _decay_step_counter()
    if not isinstance(learning_rate, Variable):
        learning_rate = layers.fill_constant([1], "float32", float(learning_rate))
    warm = layers.fill_constant([1], "float32", float(warmup_steps))
    in_warmup = layers.cast(layers.less_than(step, warm), "float32")
    ramp = layers.scale(
        layers.elementwise_div(step, warm), scale=float(end_lr - start_lr), bias=float(start_lr)
    )
    return layers.elementwise_add(
        layers.elementwise_mul(in_warmup, ramp),
        layers.elementwise_mul(layers.scale(in_warmup, scale=-1.0, bias=1.0), learning_rate),
    )
