"""Grad-graph integrity after append_backward.

The backward builder's contract (fluid/backward.py): every `<var>@GRAD`
(or `@GRAD@RENAME@n` partial) an op consumes was produced by an earlier
op in the same block, and a generic-vjp grad op's input-grad outputs
mirror the forward inputs' metadata (backward copies them; shapes are
never re-traced). A pass that rewrites the forward AFTER backward ran —
or a hand-built grad desc — can break either invariant; the compiled
step then fails deep inside an emitter or, worse, trains on garbage.
"""
from __future__ import annotations

from .. import framework
from ..dtypes import runtime_dtype
from .core import ERROR, CheckContext, register_check
from .typecheck import _shape_mismatch

GRAD = framework.GRAD_VAR_SUFFIX


@register_check("grad-integrity")
def check_grad_integrity(ctx: CheckContext):
    """Every consumed @GRAD name has an earlier producer. Grad vars are
    never feeds; a persistable @GRAD (DGC error-feedback style buffers)
    is scope state and exempt."""
    for view in ctx.views:
        block = view.block
        produced = set(view.entry_names)
        for i, op in enumerate(block.ops):
            for n in op.input_names():
                if GRAD in n and n not in produced:
                    v = block._find_var_recursive(n)
                    if v is not None and v.persistable:
                        continue
                    ctx.report(
                        "grad-integrity", ERROR,
                        f"gradient {n!r} is consumed but no earlier op "
                        f"produces it — the grad graph is torn (was the "
                        f"forward rewritten after append_backward?)",
                        block_idx=block.idx, op_index=i, op=op, var=n)
            produced.update(op.output_names())


@register_check("grad-shape-mirror")
def check_grad_shape_mirror(ctx: CheckContext):
    """Generic-vjp grad ops (attr __fwd_in_slots__): the grad var of
    forward input X must carry X's (shape, dtype) — backward.py copies
    them instead of re-tracing, so a mismatch means someone edited one
    side of the pair."""
    for view in ctx.views:
        block = view.block
        for i, op in enumerate(block.ops):
            slots = op.attrs.get("__fwd_in_slots__")
            if not op.type.endswith("_grad") or not slots:
                continue
            for slot in slots:
                fwd_names = op.inputs.get(slot) or []
                grad_names = op.outputs.get(slot + GRAD) or []
                for fn_, gn in zip(fwd_names, grad_names):
                    if gn.endswith("@UNUSED"):
                        continue
                    fv = block._find_var_recursive(fn_)
                    gv = block._find_var_recursive(gn)
                    if fv is None or gv is None:
                        continue
                    if gv.shape is None and gv.dtype is None:
                        continue
                    if _shape_mismatch(fv.shape, gv.shape):
                        ctx.report(
                            "grad-shape-mirror", ERROR,
                            f"grad {gn!r} records shape "
                            f"{tuple(gv.shape or ())} but its forward "
                            f"var {fn_!r} is {tuple(fv.shape or ())}",
                            block_idx=block.idx, op_index=i, op=op,
                            var=gn)
                    elif (fv.dtype is not None and gv.dtype is not None
                          and runtime_dtype(fv.dtype)
                          != runtime_dtype(gv.dtype)):
                        ctx.report(
                            "grad-shape-mirror", ERROR,
                            f"grad {gn!r} records dtype {gv.dtype} but "
                            f"its forward var {fn_!r} is {fv.dtype}",
                            block_idx=block.idx, op_index=i, op=op,
                            var=gn)
