"""AMP graph rewrite: insert casts around white/black-listed ops.

Parity: python/paddle/fluid/contrib/mixed_precision/fp16_utils.py in the
reference (rewrite_program:190); ported from the JAX package's
``contrib/mixed_precision/fp16_utils.py``: the same walk, the same cast
ops on the same vars, the same ``_KEEP_F32_SLOTS``.  Dtypes go through
``fluid.dtypes`` (the IR's bfloat16 has no numpy dtype here).

Master weights are implicit: parameters stay float32 and are cast at
use; the cast's backward returns float32 gradients, which is the
master-weight contract.
"""
from __future__ import annotations

from ...fluid import framework, unique_name
from ...fluid.dtypes import convert_dtype, dtype_name


def rewrite_program(program, amp_lists, dest_dtype="bfloat16"):
    """Walk block-0 ops; before each white op insert casts of its float32
    inputs to ``dest_dtype``, before each black op casts of low-precision
    inputs back to float32.  Shapes/dtypes of downstream vars are
    re-inferred op by op as the rewrite proceeds."""
    block = program.global_block()
    _rewrite_ops(block, amp_lists, convert_dtype(dest_dtype),
                 convert_dtype("float32"))
    program._amp_enabled = True
    program._bump_version()


def _rewrite_ops(block, amp_lists, dest, f32):
    # walk in program order, re-inferring each op after its (possible)
    # input rewiring: downstream cast decisions then see current dtypes
    # (a white op's bf16 output decides where black-op casts fire)
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type == "cast":
            i += 1
            continue
        if op.type == "recompute_segment":
            _rewrite_segment(block, op, amp_lists, dest, f32)
            i += 1
            continue
        if op.type in amp_lists.white_list:
            i += _cast_op_inputs(block, i, op, want=dest, source_kind=f32)
        elif op.type in amp_lists.black_list:
            i += _cast_op_inputs(block, i, op, want=f32, source_kind=dest)
        framework.infer_op_outputs(block, op)
        i += 1


def _rewrite_segment(block, op, amp_lists, dest, f32):
    """The same walk inside a fused recompute segment (RecomputeOptimizer
    fuses before the AMP decorator's backward rewrites): the casts land
    among the segment's own ops, so they are recomputed with it and the
    segment computes what the unfused program does.  (The JAX package's
    walk passes a segment by, leaving its ops in float32.)"""
    outer = block.ops
    block.ops = list(op.attrs["recompute_sub_ops"])
    try:
        _rewrite_ops(block, amp_lists, dest, f32)
        op.attrs["recompute_sub_ops"] = block.ops
    finally:
        block.ops = outer
    op.attrs["recompute_out_metas"] = [
        (tuple(block.var(n).shape), block.var(n).dtype)
        for n in op.attrs["recompute_out_names"]]


# input slots AMP must NEVER down-cast on white-listed ops: running
# statistics and affine params whose f32 state is written back each step
_KEEP_F32_SLOTS = {
    "batch_norm": {"Mean", "Variance", "Scale", "Bias"},
    "fused_conv_bn": {"Mean", "Variance", "Scale", "Bias"},
    "layer_norm": {"Scale", "Bias"},
}


def _cast_op_inputs(block, idx, op, want, source_kind) -> int:
    """Insert cast ops before block.ops[idx] for inputs of dtype
    source_kind; rewires op inputs.  Returns #ops inserted."""
    keep = _KEEP_F32_SLOTS.get(op.type, ())
    inserted = 0
    for slot, names in list(op.inputs.items()):
        if slot in keep and want != convert_dtype("float32"):
            continue
        new_names = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.dtype is None or \
                    convert_dtype(v.dtype) != source_kind:
                new_names.append(n)
                continue
            cast_name = unique_name.generate(f"{n}.cast_{dtype_name(want)}")
            block.create_var(name=cast_name, shape=v.shape, dtype=want,
                             stop_gradient=v.stop_gradient)
            block._insert_op(
                idx + inserted,
                type="cast",
                inputs={"X": [n]},
                outputs={"Out": [cast_name]},
                attrs={"in_dtype": v.dtype, "out_dtype": want},
                infer=False,
            )
            new_names.append(cast_name)
            inserted += 1
        op.inputs[slot] = new_names
    return inserted
