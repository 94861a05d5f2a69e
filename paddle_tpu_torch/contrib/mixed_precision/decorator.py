"""AMP optimizer decorator.

Parity: python/paddle/fluid/contrib/mixed_precision/decorator.py in the
reference (decorate:218, OptimizerWithMixedPrecision:27); ported from
the JAX package's ``contrib/mixed_precision/decorator.py``.

bfloat16 (the default): the loss scale is 1.0 and there is no found_inf
pass (bf16 has the f32 exponent range); the f32 gradients go straight to
the optimizer, whose update runs on the f32 master parameters.  It
composes as the JAX package's does: inside ``RecomputeOptimizer``
(fleet's order: AMP, then recompute), whose ``backward`` fuses the
segments first, so ``rewrite_program`` places the casts among a fused
segment's own ops (``fp16_utils``); and around any update, LAMB's
included.  The float16 branch (dynamic loss scaling, found_inf,
``where(isfinite(g), g, 0)``) still needs the isfinite_v2 and
reduce_all emitters: ``use_bf16=False`` raises NotImplementedError
(ROADMAP A7).
"""
from __future__ import annotations

from typing import Optional

from ...fluid import framework, layers, unique_name
from ...fluid.dtypes import dtype_name
from ...fluid.initializer import ConstantInitializer
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    def __init__(
        self,
        optimizer,
        amp_lists: Optional[AutoMixedPrecisionLists] = None,
        init_loss_scaling: float = 2.0 ** 15,
        use_dynamic_loss_scaling: bool = True,
        incr_every_n_steps: int = 1000,
        decr_every_n_nan_or_inf: int = 2,
        incr_ratio: float = 2.0,
        decr_ratio: float = 0.8,
        use_bf16: bool = True,
    ):
        if not use_bf16:
            raise NotImplementedError(
                "float16 AMP (loss scaling with found_inf) needs the "
                "isfinite_v2 and reduce_all emitters, which are not ported "
                "yet (ROADMAP A7); use use_bf16=True")
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = "bfloat16"
        self._init_loss_scaling = 1.0
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def _create_scaling_state(self):
        name = unique_name.generate("loss_scaling")
        main_block = framework.default_main_program().global_block()
        self._loss_scaling = main_block.create_var(
            name=name, shape=(1,), dtype="float32", persistable=True)
        sblock = framework.default_startup_program().global_block()
        sv = sblock.create_var(name=name, shape=(1,), dtype="float32",
                               persistable=True)
        ConstantInitializer(self._init_loss_scaling)(sv, sblock)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        # fuse BEFORE the cast rewrite: the matcher sees the raw
        # conv2d -> batch_norm [-> relu] triples, and the fused op then
        # takes its own white-list casts (Input/Filter bf16, stats f32)
        from ...fluid.fusion_pass import maybe_apply_conv_bn_fusion

        maybe_apply_conv_bn_fusion(program)
        rewrite_program(program, self._amp_lists, self._dest_dtype)
        self._create_scaling_state()
        with framework.program_guard(
                program,
                startup_program or framework.default_startup_program()):
            scaled_loss = layers.elementwise_mul(loss, self._loss_scaling)
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set,
            callbacks)
        return scaled_loss, params_grads

    def apply_gradients(self, params_grads):
        # bf16 has the f32 exponent range: the scale stays 1.0 and the
        # cast itself cannot overflow, so the unscale + found_inf pass (a
        # full extra read of every gradient) is pure overhead — feed f32
        # grads straight to the optimizer
        with framework.program_guard(params_grads[0][0].block.program,
                                     framework.default_startup_program()):
            final = []
            for p, g in params_grads:
                if g is not None and dtype_name(g.dtype) != "float32":
                    g = layers.cast(g, "float32")
                final.append((p, g))
            return self._optimizer.apply_gradients(final)

    def apply_optimize(self, loss, startup_program, params_grads):
        """Same contract as Optimizer.apply_optimize: THIS level's
        apply_gradients (the f32 cast), not the inner's."""
        with framework.program_guard(
                loss.block.program,
                startup_program or framework.default_startup_program()):
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        scaled_loss, params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set)
        with framework.program_guard(
                loss.block.program,
                startup_program or framework.default_startup_program()):
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(
    optimizer,
    amp_lists=None,
    init_loss_scaling=2.0 ** 15,
    incr_every_n_steps=1000,
    decr_every_n_nan_or_inf=2,
    incr_ratio=2.0,
    decr_ratio=0.8,
    use_dynamic_loss_scaling=True,
    use_bf16=True,
):
    """reference decorator.py:218: wrap an optimizer with AMP."""
    return OptimizerWithMixedPrecision(
        optimizer,
        amp_lists=amp_lists,
        init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio,
        decr_ratio=decr_ratio,
        use_bf16=use_bf16,
    )
