"""Optimizers: build backward + parameter-update ops into the program.

Parity surface: python/paddle/fluid/optimizer.py (Optimizer:55 and its
subclasses :913-5171); ported from the JAX package's
``fluid/optimizer.py``: ``Optimizer``, ``SGDOptimizer``,
``MomentumOptimizer``, ``AdamOptimizer`` and ``AdamWOptimizer``, with the
same accumulators, op descs and attrs, and ``PipelineOptimizer``.  Updates are emitted as ops
(operators/optimizers/ in the reference), so the Executor runs forward,
backward and update in one step and parameters never leave the device.

``backward`` runs the conv+BN fusion pass first (FLAGS_conv_bn_fusion,
``fluid/fusion_pass.py``), as the JAX package does.  Not ported
(ROADMAP): the other optimizers, the dygraph path (``minimize`` in
dygraph mode, ``state_dict``) and the numerics hooks (FLAGS_tensor_stats,
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
AdamW = AdamWOptimizer
