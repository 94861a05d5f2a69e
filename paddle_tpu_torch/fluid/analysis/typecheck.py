"""Type/shape checks: recorded IR metadata vs recomputed inference.

The IR records each var's (shape, dtype) from the op's emitter run on
meta tensors at append time (framework.infer_op_outputs). A rewrite that
splices ops in by hand (fusion, hand-built grad descs) can leave the
recorded metadata inconsistent with what the emitter will actually
produce — the step then fails deep inside a later op. This module
re-runs the SAME inference (framework.compute_op_output_metas, -1-dim
tolerant) and cross-checks, plus two dtype lints the inference cannot
see: mixed-width float operands and silently-truncating fill_constants.
"""
from __future__ import annotations

from .. import framework
from ..dtypes import (convert_dtype, dtype_name, is_floating, is_integer,
                      runtime_dtype)
from .core import ERROR, INFO, WARNING, CheckContext, register_check

GRAD = framework.GRAD_VAR_SUFFIX


def _shape_mismatch(a, b) -> bool:
    """True when shapes disagree; -1 (dynamic batch) matches anything."""
    if a is None or b is None:
        return False
    if len(a) != len(b):
        return True
    return any(x != -1 and y != -1 and x != y for x, y in zip(a, b))


def _rt(dtype):
    return runtime_dtype(convert_dtype(dtype))


@register_check("shape-dtype")
def check_shape_dtype(ctx: CheckContext):
    from ...ops import registry

    for view in ctx.views:
        block = view.block
        for i, op in enumerate(block.ops):
            spec = registry.get(op.type)
            if spec is None:
                ctx.report(
                    "shape-dtype", ERROR,
                    f"op type {op.type!r} has no registered emitter — "
                    f"the Executor will refuse to compile this block",
                    block_idx=block.idx, op_index=i, op=op)
                continue
            if op.type.endswith("_grad") or spec.generic_vjp:
                continue  # grad convention checked in gradcheck
            try:
                metas = framework.compute_op_output_metas(block, op)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                ctx.report(
                    "shape-dtype", INFO,
                    f"output metas not recomputable ({type(e).__name__}: "
                    f"{e})", block_idx=block.idx, op_index=i, op=op)
                continue
            if metas is None:
                continue
            for slot, names in op.outputs.items():
                ms = metas.get(slot)
                if ms is None:
                    continue
                for n, (shape, dt) in zip(names, ms):
                    v = block._find_var_recursive(n)
                    if v is None:
                        continue  # dangling-ref owns that finding
                    if (dt is not None and v.dtype is not None
                            and _rt(v.dtype) != _rt(dt)):
                        ctx.report(
                            "shape-dtype", ERROR,
                            f"{n!r} records dtype "
                            f"{dtype_name(v.dtype)}, but the emitter "
                            f"produces {dtype_name(dt)}",
                            block_idx=block.idx, op_index=i, op=op, var=n)
                    if shape is not None and v.shape is not None and \
                            _shape_mismatch(tuple(v.shape), tuple(shape)):
                        ctx.report(
                            "shape-dtype", ERROR,
                            f"{n!r} records shape {tuple(v.shape)}, but "
                            f"the emitter produces {tuple(shape)}",
                            block_idx=block.idx, op_index=i, op=op, var=n)


# multi-operand numeric ops where the IR expects ALIGNED dtypes (AMP
# inserts explicit casts; silent type promotion hides missed ones)
_ALIGNED_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "sum",
    "greater_than", "greater_equal", "less_than", "less_equal",
    "equal", "not_equal", "matmul", "mul",
})


def _amp_promotion(block, op, floats) -> bool:
    """A gray op of an AMP program (neither on the default white nor
    black list) that reads a low-precision and a float32 operand.  AMP
    lets a gray op follow its inputs, so it promotes to float32 as the
    rewrite intends; the JAX package's verifier reports this site as a
    dtype-clash ERROR, the port's accepts it (ROADMAP §C, slice 14).  A
    white op with mixed widths is still a missed cast."""
    if not getattr(block.program, "_amp_enabled", False):
        return False
    from ...contrib.mixed_precision import fp16_lists
    return (floats in ({"bfloat16", "float32"}, {"float16", "float32"})
            and op.type not in fp16_lists.white_list
            and op.type not in fp16_lists.black_list)


@register_check("dtype-clash")
def check_dtype_clash(ctx: CheckContext):
    for view in ctx.views:
        block = view.block
        for i, op in enumerate(block.ops):
            if op.type not in _ALIGNED_OPS:
                continue
            dts = []
            for n in op.input_names():
                v = block._find_var_recursive(n)
                if v is not None and v.dtype is not None:
                    dts.append((n, _rt(v.dtype)))
            if len(dts) < 2:
                continue
            floats = {d.name for _, d in dts if is_floating(d)}
            ints = {d.name for _, d in dts if is_integer(d)}
            bools = [n for n, d in dts if d.kind == "b"]
            pairs = ", ".join(f"{n}:{d.name}" for n, d in dts)
            if len(floats) > 1 and _amp_promotion(block, op, floats):
                continue
            if len(floats) > 1:
                # mixed float widths silently promote and throw away the
                # low-precision operand's perf win — the missed-AMP-cast
                # bug class
                ctx.report(
                    "dtype-clash", ERROR,
                    f"operands mix float widths {sorted(floats)} "
                    f"({pairs}); insert an explicit cast",
                    block_idx=block.idx, op_index=i, op=op,
                    var=dts[0][0])
            elif floats and ints:
                ctx.report(
                    "dtype-clash", WARNING,
                    f"operands mix integer and float dtypes ({pairs}); "
                    f"type promotion decides the result dtype implicitly",
                    block_idx=block.idx, op_index=i, op=op,
                    var=dts[0][0])
            elif bools and (floats or ints):
                ctx.report(
                    "dtype-clash", WARNING,
                    f"bool operand mixed with numeric ({pairs})",
                    block_idx=block.idx, op_index=i, op=op, var=bools[0])


@register_check("fill-truncation")
def check_fill_truncation(ctx: CheckContext):
    """fill_constant with an integer/bool declared dtype and a
    fractional value: the fill silently truncates (0.5 -> 0), turning a
    scalar-broadcast expression into the wrong constant. This is the
    bug Variable._binary used to build for `int_var * 0.5`."""
    for view in ctx.views:
        block = view.block
        for i, op in enumerate(block.ops):
            if op.type not in ("fill_constant",
                               "fill_constant_batch_size_like"):
                continue
            try:
                value = float(op.attr("value", 0.0))
            except (TypeError, ValueError):
                continue
            dt = convert_dtype(op.attr("dtype", "float32"))
            if not is_floating(dt) and not value.is_integer():
                ctx.report(
                    "fill-truncation", ERROR,
                    f"fill_constant declares dtype {dt.name} but value "
                    f"{value} is fractional — it will be silently "
                    f"truncated to {int(value)}",
                    block_idx=block.idx, op_index=i, op=op,
                    var=(op.output_names() or [None])[0])
