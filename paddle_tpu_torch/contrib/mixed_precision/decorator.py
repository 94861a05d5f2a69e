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
included.

float16 (``use_bf16=False``) keeps the reference's dynamic loss-scaling
protocol, as the JAX package's branch does: the loss is multiplied by
the persistable ``loss_scaling`` var; ``_apply`` casts every gradient to
f32, ORs ``not reduce_all(isfinite_v2(g))`` into ``found_inf``, selects
``where(isfinite_v2(g), g, 0)`` and multiplies by ``1 / scale`` and by
``keep = not found_inf``, so an overflowed step updates with zero
gradients; ``_update_loss_scaling`` grows or shrinks the scale branch
free and resets the ``good_steps`` / ``bad_steps`` counters when they
fire.  The three vars are persistables, so a checkpoint carries them.
A rank that holds only its block of the gradients (ZeRO-2, tp, pp, ep)
reduces ``found_inf`` across the job first (fleet sets
``_found_inf_rings``: a ``c_allreduce_max`` of the flag, as f32 [1],
over each mesh axis), so every rank skips the same steps and keeps the
same scale.  Each update op takes ``found_inf`` as its ``SkipUpdate``
input (``ops/optimizer_ops.py``): an overflowed step leaves the
parameters, the moments and the beta powers bit for bit, as the
reference's conditional skip does (the JAX package zeroes the gradients
and runs the update, which still decays Adam's moments).
``use_dynamic_loss_scaling=False`` keeps the scale fixed.  Under
FLAGS_check_numerics the JAX branch adds a bad-step guard that the
port's executor cannot read yet: that combination raises
NotImplementedError (ROADMAP A8).
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
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = "bfloat16" if use_bf16 else "float16"
        self._use_dynamic_loss_scaling = (use_dynamic_loss_scaling
                                          and not use_bf16)
        self._init_loss_scaling = init_loss_scaling if not use_bf16 else 1.0
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None
        # found_inf from this rank's gradients, and as every rank agrees
        # on it (the same var without a reduction)
        self._found_inf_local = None
        self._found_inf = None
        # the ring ids of the mesh axes found_inf is reduced over (fleet
        # sets them where a rank holds only its block of the gradients)
        self._found_inf_rings = ()

    def get_loss_scaling(self):
        return self._loss_scaling

    def _create_scaling_state(self):
        def persist(name, value):
            main_block = framework.default_main_program().global_block()
            v = main_block.create_var(
                name=name, shape=(1,), dtype="float32", persistable=True)
            sblock = framework.default_startup_program().global_block()
            sv = sblock.create_var(name=name, shape=(1,), dtype="float32",
                                   persistable=True)
            ConstantInitializer(value)(sv, sblock)
            return v

        self._loss_scaling = persist(unique_name.generate("loss_scaling"),
                                     self._init_loss_scaling)
        if self._use_dynamic_loss_scaling:
            self._good_steps = persist(unique_name.generate("good_steps"),
                                       0.0)
            self._bad_steps = persist(unique_name.generate("bad_steps"), 0.0)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        if self._dest_dtype == "float16":
            from ...fluid.flags import flag

            if flag("FLAGS_check_numerics"):
                raise NotImplementedError(
                    "float16 AMP under FLAGS_check_numerics: its "
                    "check_numerics_bad_amp_* guard waits for the "
                    "executor's numerics guards (ROADMAP A8)")
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
        with framework.program_guard(params_grads[0][0].block.program,
                                     framework.default_startup_program()):
            if self._dest_dtype == "bfloat16":
                # bf16 has the f32 exponent range: the scale stays 1.0
                # and the cast itself cannot overflow, so the unscale +
                # found_inf pass (a full extra read of every gradient) is
                # pure overhead — feed f32 grads straight to the optimizer
                final = []
                for p, g in params_grads:
                    if g is not None and dtype_name(g.dtype) != "float32":
                        g = layers.cast(g, "float32")
                    final.append((p, g))
                return self._optimizer.apply_gradients(final)
            return self._apply_fp16(params_grads)

    def _apply_fp16(self, params_grads):
        inv = layers.elementwise_div(
            layers.fill_constant([1], "float32", 1.0), self._loss_scaling)
        # found_inf = any grad non-finite (after the cast to f32)
        found_inf = layers.fill_constant([1], "bool", 0.0)
        new_pgs = []
        for p, g in params_grads:
            if g is None:
                new_pgs.append((p, g))
                continue
            g32 = (layers.cast(g, "float32")
                   if dtype_name(g.dtype) != "float32" else g)
            bad = layers.logical_not(
                layers.reduce_all(layers.isfinite_v2(g32)))
            found_inf = layers.logical_or(found_inf, bad)
            new_pgs.append((p, g32))
        self._found_inf_local = found_inf
        if self._found_inf_rings:
            # the OR over every rank of the job: a max of the flag over
            # each mesh axis in turn
            flag = layers.cast(found_inf, "float32")
            for ring in self._found_inf_rings:
                flag.block.append_op(
                    type="c_allreduce_max", inputs={"X": [flag]},
                    outputs={"Out": [flag]},
                    attrs={"ring_id": ring, "use_calc_stream": True})
            found_inf = layers.cast(flag, "bool")
        self._found_inf = found_inf
        keep = layers.cast(layers.logical_not(found_inf), "float32")
        zero = layers.fill_constant([1], "float32", 0.0)
        final = []
        for p, g in new_pgs:
            if g is None:
                final.append((p, g))
                continue
            # select, not multiply: inf * 0 is NaN, which would poison
            # the params on the very step the keep factor means to skip.
            # where() drops the non-finite entries first; keep then
            # zeroes the rest of the overflowed step
            g = layers.where(layers.isfinite_v2(g), g, zero)
            g = layers.elementwise_mul(g, layers.elementwise_mul(inv, keep))
            final.append((p, g))
        if self._use_dynamic_loss_scaling:
            self._update_loss_scaling(found_inf)
        block = found_inf.block.program.global_block()
        start = len(block.ops)
        optimize_ops = self._optimizer.apply_gradients(final)
        # the reference skips an overflowed step: every update op keeps
        # its parameter, moments and beta powers where found_inf is set
        # (zero gradients alone would still decay Adam's moments)
        from ...ops.optimizer_ops import UPDATE_OPS

        for op in block.ops[start:]:
            if op.type in UPDATE_OPS:
                op.inputs["SkipUpdate"] = [found_inf.name]
        return optimize_ops

    def _update_loss_scaling(self, found_inf):
        """Branch-free grow / shrink of the scale (reference
        fp16_utils.update_loss_scaling:333 semantics)."""
        bad = layers.cast(found_inf, "float32")
        good = layers.scale(bad, scale=-1.0, bias=1.0)
        new_good = layers.elementwise_mul(
            layers.increment(self._good_steps, 1.0, in_place=False), good)
        new_bad = layers.elementwise_mul(
            layers.increment(self._bad_steps, 1.0, in_place=False), bad)
        grow = layers.cast(layers.greater_equal(
            new_good, layers.fill_constant(
                [1], "float32", float(self._incr_every_n_steps))), "float32")
        shrink = layers.cast(layers.greater_equal(
            new_bad, layers.fill_constant(
                [1], "float32", float(self._decr_every_n_nan_or_inf))),
            "float32")
        factor = 1.0 + grow * (self._incr_ratio - 1.0)
        factor = layers.elementwise_mul(
            factor, layers.scale(shrink, scale=self._decr_ratio - 1.0,
                                 bias=1.0))
        new_scale = layers.elementwise_mul(self._loss_scaling, factor)
        layers.assign(new_scale, self._loss_scaling)
        # reset the counters when they fire
        layers.assign(layers.elementwise_mul(
            new_good, layers.scale(grow, scale=-1.0, bias=1.0)),
            self._good_steps)
        layers.assign(layers.elementwise_mul(
            new_bad, layers.scale(shrink, scale=-1.0, bias=1.0)),
            self._bad_steps)

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
