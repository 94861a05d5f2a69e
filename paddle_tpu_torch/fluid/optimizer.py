"""Optimizers: build backward + parameter-update ops into the program.

Parity surface: python/paddle/fluid/optimizer.py (Optimizer:55 and its
subclasses :913-5171); ported from the JAX package's
``fluid/optimizer.py`` with the same accumulators, op descs and attrs:
SGD, Momentum, LarsMomentum, Adam, AdamW, Adagrad, Adamax,
DecayedAdagrad, RMSProp, Lamb, Ftrl and Dpsgd; the meta-optimizers that
rewrite the program around an inner one (GradientMerge, Lookahead,
Recompute, Pipeline); and ExponentialMovingAverage and ModelAverage.
Updates are emitted as ops (operators/optimizers/ in the reference), so
the Executor runs forward, backward and update in one step and
parameters never leave the device.

``backward`` runs the conv+BN fusion pass first (FLAGS_conv_bn_fusion,
``fluid/fusion_pass.py``), as the JAX package does.  Not ported
(ROADMAP): the dygraph path (``minimize`` in dygraph mode,
``state_dict``) and the numerics hooks (FLAGS_tensor_stats,
FLAGS_check_numerics).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from . import framework, unique_name
from .backward import append_backward
from .clip import GradientClipBase
from .framework import Variable, program_guard
from .initializer import ConstantInitializer
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(
        self,
        learning_rate=0.001,
        parameter_list=None,
        regularization=None,
        grad_clip: Optional[GradientClipBase] = None,
        name=None,
    ):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self.type = getattr(self, "type", "optimizer")
        self._learning_rate_var: Optional[Variable] = None
        # accumulators: name -> {param_name: var}
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)

    # ------------------------------------------------------------------
    def _create_global_learning_rate(self):
        if self._learning_rate_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        lr_name = unique_name.generate("learning_rate")
        main_block = framework.default_main_program().global_block()
        self._learning_rate_var = main_block.create_var(
            name=lr_name, shape=(1,), dtype="float32", persistable=True
        )
        startup_block = framework.default_startup_program().global_block()
        sv = startup_block.create_var(
            name=lr_name, shape=(1,), dtype="float32", persistable=True
        )
        ConstantInitializer(float(self._learning_rate))(sv, startup_block)

    def _global_learning_rate(self):
        return self._learning_rate_var

    @property
    def current_step_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        """Update the LR in-place (scope-level, no recompile needed)."""
        from .executor import global_scope

        self._learning_rate = value
        if self._learning_rate_var is not None:
            scope = global_scope()
            if scope.find_var(self._learning_rate_var.name) is not None:
                scope.set_var(
                    self._learning_rate_var.name,
                    np.full((1,), value, dtype=np.float32),
                )

    # ------------------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None, dtype=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        main_block = framework.default_main_program().global_block()
        v = main_block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True,
        )
        startup_block = framework.default_startup_program().global_block()
        sv = startup_block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True
        )
        ConstantInitializer(float(fill_value))(sv, startup_block)
        self._accumulators[name][param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ------------------------------------------------------------------
    def backward(
        self,
        loss,
        startup_program=None,
        parameter_list=None,
        no_grad_set=None,
        callbacks=None,
    ):
        # graph-level fusion runs BEFORE backward so grad synthesis
        # differentiates the fused ops (a no-op with the flag off)
        from .fusion_pass import maybe_apply_conv_bn_fusion

        maybe_apply_conv_bn_fusion(loss.block.program)
        return append_backward(
            loss, parameter_list or self._parameter_list, no_grad_set, callbacks
        )

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        grad_clip = self._grad_clip
        if grad_clip is None and params_grads:
            # fluid.clip.set_gradient_clip() stores the clip on the program
            grad_clip = getattr(
                params_grads[0][0].block.program, "_grad_clip", None
            )
        if grad_clip is not None:
            params_grads = grad_clip(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        self._create_global_learning_rate()
        optimize_ops = []
        block = framework.default_main_program().global_block()
        self._create_accumulators(block, [p for p, _ in params_grads])
        for p, g in params_grads:
            if g is None:
                continue
            optimize_ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        return optimize_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(loss.block.program, startup_program):
            return self.apply_gradients(params_grads)

    def minimize(
        self,
        loss,
        startup_program=None,
        parameter_list=None,
        no_grad_set=None,
    ):
        params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set
        )
        # always anchor optimizer/LR ops to the loss's own program — the
        # default program may be a different one (reference optimizer.py
        # guards with loss.block.program in minimize)
        startup = (
            startup_program
            if startup_program is not None
            else framework.default_startup_program()
        )
        with program_guard(loss.block.program, startup):
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # subclass hooks -----------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


def _create_persistable_var(name, shape, dtype, fill_value=0.0):
    """A persistable main-program var and its constant startup init (the
    pattern of ``Optimizer._add_accumulator``); an existing one as it is."""
    main_block = framework.default_main_program().global_block()
    if name in main_block.vars:
        return main_block.vars[name]
    v = main_block.create_var(name=name, shape=tuple(shape), dtype=dtype,
                              persistable=True, stop_gradient=True)
    startup_block = framework.default_startup_program().global_block()
    sv = startup_block.create_var(name=name, shape=tuple(shape), dtype=dtype,
                                  persistable=True)
    ConstantInitializer(float(fill_value))(sv, startup_block)
    return v


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [p],
                "Grad": [g],
                "LearningRate": [self._learning_rate_var],
            },
            outputs={"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Velocity": [v],
                "LearningRate": [self._learning_rate_var],
            },
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(
        self,
        learning_rate=0.001,
        beta1=0.9,
        beta2=0.999,
        epsilon=1e-8,
        lazy_mode=False,
        **kwargs,
    ):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=(1,))
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=(1,))

    def _optimize_inputs_outputs(self, p, g):
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        inputs = {
            "Param": [p],
            "Grad": [g],
            "Moment1": [m1],
            "Moment2": [m2],
            "Beta1Pow": [b1p],
            "Beta2Pow": [b2p],
            "LearningRate": [self._learning_rate_var],
        }
        outputs = {
            "ParamOut": [p],
            "Moment1Out": [m1],
            "Moment2Out": [m2],
            "Beta1PowOut": [b1p],
            "Beta2PowOut": [b2p],
        }
        return inputs, outputs

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs, outputs = self._optimize_inputs_outputs(p, g)
        return block.append_op(
            type="adam",
            inputs=inputs,
            outputs=outputs,
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )


class AdamWOptimizer(AdamOptimizer):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, apply_decay_param_fun=None, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._weight_decay = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs, outputs = self._optimize_inputs_outputs(p, g)
        with_decay = True
        if self._apply_decay_param_fun is not None and not self._apply_decay_param_fun(p.name):
            with_decay = False
        return block.append_op(
            type="adamw",
            inputs=inputs,
            outputs=outputs,
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
                "coeff": self._weight_decay,
                "with_decay": with_decay,
            },
        )



class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon},
        )


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon},
        )


class AdamaxOptimizer(Optimizer):
    """Adamax (reference adamax_op.cc): Adam with the L-infinity norm in
    place of the second moment.  The op has no Beta1PowOut slot, so the
    beta1 power advances by a scale op in ``_finish_update``."""

    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "InfNorm": [inf],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block, params_grads):
        for p, g in params_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                attrs={"scale": self._beta1, "bias": 0.0,
                       "bias_after_scale": True})


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad whose squared-gradient accumulator decays by ``decay`` each
    step (reference decayed_adagrad_op.cc)."""

    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum_acc", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum_acc", p)
        inputs = {"Param": [p], "Grad": [g], "MeanSquare": [ms],
                  "Moment": [mom], "LearningRate": [self._learning_rate_var]}
        outputs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            inputs["MeanGrad"] = [mg]
            outputs["MeanGradOut"] = [mg]
        return block.append_op(
            type="rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
        )


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs, outputs = self._optimize_inputs_outputs(p, g)
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            type="lamb", inputs=inputs, outputs=outputs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd},
        )


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
        )


class DpsgdOptimizer(Optimizer):
    type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._learning_rate_var]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma},
        )


# ---------------------------------------------------------------------------
# meta-optimizers: wrappers that rewrite the program around an inner
# optimizer (reference optimizer.py:3627-5171).  As in the JAX package, a
# conditional update is a `where` select, not the reference's
# conditional_block op, so every step runs the same op list.
# ---------------------------------------------------------------------------


def _append_step_cond(block, counter_name, k):
    """Emit counter += 1; cond = (counter % k == 0) and return the bool
    cond var (shape (1,)).  The counter is a persistable int32 (exact to
    2**31 steps, where a float32 one would stop at 2**24)."""
    step = _create_persistable_var(counter_name, (1,), "int32", 0.0)
    block.append_op(type="increment", inputs={"X": [step]},
                    outputs={"Out": [step]}, attrs={"step": 1.0})
    k_name = unique_name.generate(counter_name + "_k")
    block.append_op(type="fill_constant", outputs={"Out": [k_name]},
                    attrs={"shape": [1], "dtype": "int32", "value": float(k)})
    mod_name = unique_name.generate(counter_name + "_mod")
    block.append_op(type="elementwise_mod",
                    inputs={"X": [step], "Y": [k_name]},
                    outputs={"Out": [mod_name]})
    zero_name = unique_name.generate(counter_name + "_zero")
    block.append_op(type="fill_constant", outputs={"Out": [zero_name]},
                    attrs={"shape": [1], "dtype": "int32", "value": 0.0})
    cond_name = unique_name.generate(counter_name + "_cond")
    block.append_op(type="equal", inputs={"X": [mod_name], "Y": [zero_name]},
                    outputs={"Out": [cond_name]})
    return block.var(cond_name)


def _mask_region(block, cond, start_idx):
    """Make the persistable writes of ops[start_idx:] conditional on
    ``cond``: an ``assign`` snapshot of each written persistable before
    the region, a ``where(cond, new, old)`` after it (the branch-free
    form of the reference's conditional_block)."""
    written = []
    for op in block.ops[start_idx:]:
        for n in op.output_names():
            v = block._find_var_recursive(n)
            if v is not None and v.persistable and n not in written:
                written.append(n)
    for i, n in enumerate(written):
        block._insert_op(start_idx + i, type="assign", inputs={"X": [n]},
                         outputs={"Out": [n + "@MASK_OLD"]})
    for n in written:
        block.append_op(type="where",
                        inputs={"Condition": [cond], "X": [n],
                                "Y": [n + "@MASK_OLD"]},
                        outputs={"Out": [n]})


def _startup_of(startup_program):
    return (startup_program if startup_program is not None
            else framework.default_startup_program())


class GradientMergeOptimizer:
    """Accumulate the gradients over k_steps microbatches and apply the
    inner update on the k-th (reference optimizer.py:4948).  The update
    ops run every step; their persistable writes are masked by a
    (step % k == 0) select, so parameters and moments change only on the
    boundary step.  ``backward`` and ``apply_optimize`` split as an
    optimizer's do, so fleet can sum the gradients over "dp" between
    them (every microbatch's gradient is the dp mean, as in the JAX
    package's GSPMD step)."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_opt = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self.inner_opt.backward(loss, startup_program, parameter_list,
                                       no_grad_set, callbacks)

    def apply_optimize(self, loss, startup_program, params_grads):
        main = loss.block.program
        startup = _startup_of(startup_program)
        with program_guard(main, startup):
            block = main.global_block()
            cond = _append_step_cond(
                block, unique_name.generate("gradient_merge_step"),
                self.k_steps)
            merged = []
            for p, g in params_grads:
                if g is None:
                    continue
                acc = _create_persistable_var(p.name + "@GradientMerge",
                                              p.shape, p.dtype, 0.0)
                block.append_op(type="elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]})
                if self.avg:
                    avg_name = acc.name + "@AVG"
                    block.append_op(type="scale", inputs={"X": [acc]},
                                    outputs={"Out": [avg_name]},
                                    attrs={"scale": 1.0 / self.k_steps,
                                           "bias": 0.0})
                    merged.append((p, block.var(avg_name)))
                else:
                    merged.append((p, acc))
            start_idx = len(block.ops)
            optimize_ops = self.inner_opt.apply_optimize(loss, startup,
                                                         merged)
            _mask_region(block, cond, start_idx)
            # the accumulators restart from zero after the boundary step
            for p, g in params_grads:
                if g is None:
                    continue
                acc_name = p.name + "@GradientMerge"
                z = unique_name.generate(acc_name + "_zero")
                block.append_op(type="fill_zeros_like",
                                inputs={"X": [acc_name]},
                                outputs={"Out": [z]})
                block.append_op(type="where",
                                inputs={"Condition": [cond], "X": [z],
                                        "Y": [acc_name]},
                                outputs={"Out": [acc_name]})
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = _params_grads(self.backward(
            loss, startup_program, parameter_list, no_grad_set))
        return (self.apply_optimize(loss, startup_program, params_grads),
                params_grads)

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


def _params_grads(res):
    """backward()'s params_grads across optimizer flavors: the AMP
    decorator returns (scaled_loss, params_grads)."""
    if isinstance(res, tuple) and len(res) == 2 and isinstance(res[1], list):
        return res[1]
    return res


class LookaheadOptimizer:
    """Lookahead (k steps forward, 1 step back; reference
    optimizer.py:4787): the inner (fast) optimizer steps every iteration;
    every k steps the slow weights move alpha of the way toward the fast
    ones and the fast weights are reset to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert 0.0 <= alpha <= 1.0
        self.inner_opt = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        optimize_ops, params_grads = self.inner_opt.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        main = loss.block.program
        startup = _startup_of(startup_program)
        with program_guard(main, startup):
            block = main.global_block()
            cond = _append_step_cond(
                block, unique_name.generate("lookahead_step"), self.k)
            sblock = startup.global_block()
            for p, _ in params_grads:
                slow_name = p.name + "@SLOW"
                _create_persistable_var(slow_name, p.shape, p.dtype, 0.0)
                # the slow weights start as the initialized parameters
                sblock.append_op(type="assign", inputs={"X": [p.name]},
                                 outputs={"Out": [slow_name]})
                diff = unique_name.generate(p.name + "_la_diff")
                block.append_op(type="elementwise_sub",
                                inputs={"X": [p.name], "Y": [slow_name]},
                                outputs={"Out": [diff]})
                scaled = unique_name.generate(p.name + "_la_scaled")
                block.append_op(type="scale", inputs={"X": [diff]},
                                outputs={"Out": [scaled]},
                                attrs={"scale": self.alpha, "bias": 0.0})
                new_slow = unique_name.generate(p.name + "_la_new_slow")
                block.append_op(type="elementwise_add",
                                inputs={"X": [slow_name], "Y": [scaled]},
                                outputs={"Out": [new_slow]})
                for target in (slow_name, p.name):
                    block.append_op(type="where",
                                    inputs={"Condition": [cond],
                                            "X": [new_slow], "Y": [target]},
                                    outputs={"Out": [target]})
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


class RecomputeOptimizer:
    """Activation recompute between user-marked checkpoints (reference
    optimizer.py:4478 and backward.py:629): each segment between
    checkpoints becomes one ``recompute_segment`` op
    (``ops/recompute.py``) whose forward keeps only its outputs and whose
    grad op runs the segment again.  Intermediates inside a segment can
    no longer be fetched, as in the reference."""

    def __init__(self, optimizer):
        self.inner_opt = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [c.name if isinstance(c, Variable) else str(c)
                             for c in (checkpoints or [])]

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if not self._checkpoints:
            raise ValueError("RecomputeOptimizer needs _set_checkpoints(...)")
        _fuse_recompute_segments(loss, self._checkpoints)
        return self.inner_opt.backward(loss, startup_program, parameter_list,
                                       no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self.inner_opt.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.inner_opt.apply_optimize(loss, startup_program,
                                             params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = _params_grads(self.backward(
            loss, startup_program, parameter_list, no_grad_set))
        optimize_ops = self.inner_opt.apply_optimize(
            loss, _startup_of(startup_program), params_grads)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


def _fuse_recompute_segments(loss, checkpoint_names):
    """Split the forward of loss's block after each checkpoint-producing
    op and collapse each segment of two or more ops into one
    ``recompute_segment`` op (salt ``0x7EC0 + segment index``)."""
    block = loss.block
    ckpts = set(checkpoint_names)
    loss_idx = None
    for i in reversed(range(len(block.ops))):
        if loss.name in block.ops[i].output_names():
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError(f"loss var {loss.name!r} is not produced by any op")
    fwd_ops = block.ops[: loss_idx + 1]
    tail_ops = block.ops[loss_idx + 1:]

    segments, cur = [], []
    for op in fwd_ops:
        cur.append(op)
        if any(n in ckpts for n in op.output_names()):
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)

    # what each segment's later segments and the tail read
    read_after = [set() for _ in segments]
    later = {n for op in tail_ops for n in op.input_names()}
    for si in reversed(range(len(segments))):
        read_after[si] = set(later)
        for op in segments[si]:
            later.update(op.input_names())

    new_ops = []
    for si, seg in enumerate(segments):
        if len(seg) < 2:
            new_ops.extend(seg)
            continue
        produced = list(dict.fromkeys(n for op in seg
                                      for n in op.output_names()))
        # every read before the segment writes the name is an input, the
        # vars it reads and then overwrites in place (batch_norm's
        # Mean/MeanOut) included: those are inputs AND outputs
        in_names, seen_out = [], set()
        for op in seg:
            for n in op.input_names():
                if n not in seen_out and n not in in_names:
                    in_names.append(n)
            seen_out.update(op.output_names())
        # names still observable after the segment: later reads,
        # checkpoints, persistables (batch-norm running stats), the loss
        out_names = []
        for n in produced:
            v = block._find_var_recursive(n)
            if (n in read_after[si] or n in ckpts or n == loss.name
                    or (v is not None and v.persistable)):
                out_names.append(n)
        if not out_names:
            out_names = [produced[-1]]
        out_metas = [(tuple(block._find_var_recursive(n).shape),
                      block._find_var_recursive(n).dtype) for n in out_names]
        fused = framework.Operator(
            block, "recompute_segment",
            inputs={"X": in_names}, outputs={"Out": out_names},
            attrs={"recompute_sub_ops": seg,
                   "recompute_in_names": in_names,
                   "recompute_out_names": out_names,
                   "recompute_out_metas": out_metas,
                   "recompute_seg_salt": 0x7EC0 + si})
        for n in out_names:
            block._find_var_recursive(n).op = fused
        new_ops.append(fused)
    block.ops = new_ops + tail_ops
    block.program._bump_version()


class ExponentialMovingAverage:
    """EMA of the trainable parameters (reference optimizer.py:3381).

    ``update()`` appends the in-graph accumulation ops (call it after
    ``minimize``); ``apply()`` / ``restore()`` swap scope values, which
    stay tensors on the scope's device.  ``thres_steps`` (a Variable)
    schedules the decay as min(decay, (1 + t) / (10 + t)); the zero-init
    bias is corrected at ``apply()`` by 1 - prod(decay_t), which is the
    reference's 1 - decay**t for a constant decay and stays exact when
    it is scheduled."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or ""
        self._pairs = []  # (param_name, ema_name)
        self._step_name = unique_name.generate(self._name + "@EMA@step")
        self._decay_pow_name = unique_name.generate(
            self._name + "@EMA@decay_pow")
        self._backup = {}

    def _append_decay_var(self, block):
        """The step's effective decay, a (1,) float32 var."""
        if self._thres_steps is None:
            name = unique_name.generate(self._name + "@EMA@decay")
            block.append_op(type="fill_constant", outputs={"Out": [name]},
                            attrs={"shape": [1], "dtype": "float32",
                                   "value": self._decay})
            return name
        thres = self._thres_steps
        tname = thres.name if isinstance(thres, Variable) else str(thres)
        tf = unique_name.generate(tname + "_f")
        block.append_op(type="cast", inputs={"X": [tname]},
                        outputs={"Out": [tf]},
                        attrs={"out_dtype": "float32"})
        num = unique_name.generate(tname + "_num")
        block.append_op(type="scale", inputs={"X": [tf]},
                        outputs={"Out": [num]},
                        attrs={"scale": 1.0, "bias": 1.0})
        den = unique_name.generate(tname + "_den")
        block.append_op(type="scale", inputs={"X": [tf]},
                        outputs={"Out": [den]},
                        attrs={"scale": 1.0, "bias": 10.0})
        ramp = unique_name.generate(tname + "_ramp")
        block.append_op(type="elementwise_div",
                        inputs={"X": [num], "Y": [den]},
                        outputs={"Out": [ramp]})
        dconst = unique_name.generate(tname + "_dconst")
        block.append_op(type="fill_constant", outputs={"Out": [dconst]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": self._decay})
        name = unique_name.generate(self._name + "@EMA@decay")
        block.append_op(type="elementwise_min",
                        inputs={"X": [dconst], "Y": [ramp]},
                        outputs={"Out": [name]})
        return name

    def update(self):
        main = framework.default_main_program()
        block = main.global_block()
        step = _create_persistable_var(self._step_name, (1,), "int32", 0.0)
        block.append_op(type="increment", inputs={"X": [step]},
                        outputs={"Out": [step]}, attrs={"step": 1.0})
        decay_name = self._append_decay_var(block)
        one_minus = unique_name.generate(decay_name + "_om")
        block.append_op(type="scale", inputs={"X": [decay_name]},
                        outputs={"Out": [one_minus]},
                        attrs={"scale": -1.0, "bias": 1.0})
        # the running product of the decays: the debias of apply()
        _create_persistable_var(self._decay_pow_name, (1,), "float32", 1.0)
        block.append_op(type="elementwise_mul",
                        inputs={"X": [self._decay_pow_name],
                                "Y": [decay_name]},
                        outputs={"Out": [self._decay_pow_name]})
        for p in main.all_parameters():
            if not p.trainable:
                continue
            ema_name = p.name + "@EMA" + self._name
            _create_persistable_var(ema_name, p.shape, p.dtype, 0.0)
            t1 = unique_name.generate(ema_name + "_t1")
            block.append_op(type="elementwise_mul",
                            inputs={"X": [ema_name], "Y": [decay_name]},
                            outputs={"Out": [t1]})
            t2 = unique_name.generate(ema_name + "_t2")
            block.append_op(type="elementwise_mul",
                            inputs={"X": [p.name], "Y": [one_minus]},
                            outputs={"Out": [t2]})
            block.append_op(type="elementwise_add",
                            inputs={"X": [t1], "Y": [t2]},
                            outputs={"Out": [ema_name]})
            # update() may be called again (the reference allows it): a
            # pair held twice would back up an already-swapped value
            if (p.name, ema_name) not in self._pairs:
                self._pairs.append((p.name, ema_name))

    def apply(self, executor=None, need_restore=True):
        """Context manager: the parameters hold their debiased EMA."""
        import contextlib

        from .executor import global_scope

        @contextlib.contextmanager
        def _guard():
            scope = global_scope()
            decay_pow = float(scope.find_var(self._decay_pow_name)
                              .reshape(-1)[0])
            debias = max(1.0 - decay_pow, 1e-12)
            self._backup = {}
            for pname, ename in self._pairs:
                self._backup.setdefault(pname, scope.find_var(pname))
                ema = scope.find_var(ename)
                scope.set_var(pname, (ema / debias).to(ema.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _guard()

    def restore(self, executor=None):
        from .executor import global_scope

        scope = global_scope()
        for pname, val in self._backup.items():
            scope.set_var(pname, val)
        self._backup = {}


class ModelAverage:
    """Running average of the parameters over a trailing window (reference
    optimizer.py:3068).  The window restarts when num_accumulates >=
    min_average_window and num_accumulates >= min(max_average_window,
    num_updates * average_window_rate) (reference :3091).  Where the
    reference rotates three sum buffers, one (sum, count) pair restarts
    from the current parameter, as in the JAX package: the same averaged
    weights."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._pairs = []  # (param, sum_name, num_name)
        self._backup = {}
        main = framework.default_main_program()
        block = main.global_block()

        def fill(key, value):
            name = unique_name.generate(key)
            block.append_op(type="fill_constant", outputs={"Out": [name]},
                            attrs={"shape": [1], "dtype": "float32",
                                   "value": float(value)})
            return name

        num_upd = _create_persistable_var(
            unique_name.generate("@MA@num_updates"), (1,), "int32", 0.0)
        block.append_op(type="increment", inputs={"X": [num_upd]},
                        outputs={"Out": [num_upd]}, attrs={"step": 1.0})
        updf = unique_name.generate("@MA@num_updates_f")
        block.append_op(type="cast", inputs={"X": [num_upd]},
                        outputs={"Out": [updf]},
                        attrs={"out_dtype": "float32"})
        ratew = unique_name.generate("@MA@rate_window")
        block.append_op(type="scale", inputs={"X": [updf]},
                        outputs={"Out": [ratew]},
                        attrs={"scale": self.average_window, "bias": 0.0})
        maxw = fill("@MA@maxw", self.max_average_window)
        window = unique_name.generate("@MA@window")
        block.append_op(type="elementwise_min",
                        inputs={"X": [maxw], "Y": [ratew]},
                        outputs={"Out": [window]})
        minw = fill("@MA@minw", self.min_average_window)

        for p in main.all_parameters():
            if not p.trainable:
                continue
            sum_name = p.name + "@MA_SUM"
            num_name = p.name + "@MA_NUM"
            _create_persistable_var(sum_name, p.shape, p.dtype, 0.0)
            _create_persistable_var(num_name, (1,), "float32", 0.0)
            ge_min = unique_name.generate(num_name + "_ge_min")
            block.append_op(type="greater_equal",
                            inputs={"X": [num_name], "Y": [minw]},
                            outputs={"Out": [ge_min]})
            ge_win = unique_name.generate(num_name + "_ge_win")
            block.append_op(type="greater_equal",
                            inputs={"X": [num_name], "Y": [window]},
                            outputs={"Out": [ge_win]})
            restart = unique_name.generate(num_name + "_restart")
            block.append_op(type="logical_and",
                            inputs={"X": [ge_min], "Y": [ge_win]},
                            outputs={"Out": [restart]})
            acc = unique_name.generate(sum_name + "_acc")
            block.append_op(type="elementwise_add",
                            inputs={"X": [sum_name], "Y": [p.name]},
                            outputs={"Out": [acc]})
            block.append_op(type="where",
                            inputs={"Condition": [restart], "X": [p.name],
                                    "Y": [acc]},
                            outputs={"Out": [sum_name]})
            bumped = unique_name.generate(num_name + "_bump")
            block.append_op(type="increment", inputs={"X": [num_name]},
                            outputs={"Out": [bumped]}, attrs={"step": 1.0})
            one = fill(num_name + "_one", 1.0)
            block.append_op(type="where",
                            inputs={"Condition": [restart], "X": [one],
                                    "Y": [bumped]},
                            outputs={"Out": [num_name]})
            self._pairs.append((p.name, sum_name, num_name))

    def apply(self, executor=None, need_restore=True):
        """Context manager: the parameters hold their window average."""
        import contextlib

        from .executor import global_scope

        @contextlib.contextmanager
        def _guard():
            scope = global_scope()
            self._backup = {}
            for pname, sname, nname in self._pairs:
                self._backup[pname] = scope.find_var(pname)
                s = scope.find_var(sname)
                n = float(scope.find_var(nname).reshape(-1)[0])
                if n > 0:
                    scope.set_var(pname, (s / n).to(s.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _guard()

    def restore(self, executor=None):
        from .executor import global_scope

        scope = global_scope()
        for pname, val in self._backup.items():
            scope.set_var(pname, val)
        self._backup = {}


class PipelineOptimizer:
    """Pipeline-parallel training (reference optimizer.py:3627 and its
    PipelineTrainer / SectionWorker, framework/section_worker.cc:82).

    As in the JAX package, the pipeline lives inside the ops, not in
    per-device sections on threads: each ``fused_encoder_stack`` takes
    the GPipe schedule over the "pp" mesh axis (its stacked parameters
    sharded on the layer dim, microbatches handed stage to stage;
    ``ops/encoder_stack.py`` ``_gpipe_stack``), and the step stays one
    program.  ``device_guard`` stage tags (attr "op_device") are
    accepted; a program tagged with more than one stage raises, since no
    stage placement is performed, unless
    FLAGS_pipeline_single_program_fallback accepts running them in one
    program (with a warning)."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        self.inner_opt = optimizer
        self._num_microbatches = int(num_microbatches)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        # mark the stacks BEFORE backward: grad ops copy the attrs
        for block in program.blocks:
            for op in block.ops:
                if op.type == "fused_encoder_stack":
                    op._set_attr("pipeline", True)
                    op._set_attr("num_microbatches",
                                 self._num_microbatches)
        self._stage_ops = self._collect_stages(program)
        if len(self._stage_ops) > 1:
            from .flags import flag

            stages = ", ".join(sorted(self._stage_ops))
            if not flag("FLAGS_pipeline_single_program_fallback"):
                raise RuntimeError(
                    f"PipelineOptimizer: this program tags ops with "
                    f"{len(self._stage_ops)} device_guard stages "
                    f"({stages}), but the port runs ONE program and places "
                    f"no stage: the tags would be silently ignored.  Use "
                    f"the 'pp' mesh axis (fused_encoder_stack's GPipe "
                    f"schedule) for pipeline parallelism, or set "
                    f"FLAGS_pipeline_single_program_fallback=1 to accept "
                    f"running them co-scheduled in one program.")
            import warnings

            warnings.warn(
                f"PipelineOptimizer: device_guard names "
                f"{len(self._stage_ops)} stages ({stages}); running them "
                f"co-scheduled in ONE program "
                f"(FLAGS_pipeline_single_program_fallback=1).  Stage "
                f"placement is not performed: use the 'pp' mesh axis with "
                f"fused_encoder_stack for pipeline parallelism.",
                stacklevel=2)
        return self.inner_opt.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)

    @staticmethod
    def _collect_stages(program):
        """The ops of each device_guard tag."""
        stages = {}
        for block in program.blocks:
            for op in block.ops:
                dev = op.attr("op_device")
                if dev is not None:
                    stages.setdefault(dev, []).append(op)
        return stages

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


# reference aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
Ftrl = FtrlOptimizer
Dpsgd = DpsgdOptimizer
LarsMomentum = LarsMomentumOptimizer
