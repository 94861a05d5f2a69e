"""Dataflow checks: dangling refs, ordering, stale writers, dead code.

These are the bug classes graph REWRITES introduce (a fusion pass that
deletes ops, a backward builder that renames partials): an op reading a
name nothing defines, a producer moved after its consumer, a
`Variable.op` last-writer link pointing at an op no longer in any
block, outputs nothing will ever read.
"""
from __future__ import annotations

from .. import framework
from .core import ERROR, WARNING, CheckContext, register_check


def _producer_indices(block):
    """name -> first op index in `block` producing it."""
    first = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            first.setdefault(n, i)
    return first


@register_check("use-before-def")
def check_use_before_def(ctx: CheckContext):
    """Three findings share this walker:

    dangling-ref        consumed name resolves to NO variable anywhere
    use-before-def      producer exists but runs AFTER the consumer, or
                        (sub-blocks) the name is readable at build time
                        via parent scoping but is NOT in the emitter's
                        env contract (captured/loop/step names) — a
                        guaranteed runtime KeyError in emit_ops
    maybe-uninitialized root-block var with no producer that is neither
                        a data var nor persistable: it must arrive via
                        feed or pre-populated scope, which the program
                        alone cannot prove
    """
    for view in ctx.views:
        block = view.block
        producers = _producer_indices(block)
        defined = set(view.entry_names)
        for i, op in enumerate(block.ops):
            for n in op.input_names():
                if n in defined:
                    continue
                v = block._find_var_recursive(n)
                if v is None:
                    ctx.report(
                        "dangling-ref", ERROR,
                        f"op consumes {n!r}, which no block defines",
                        block_idx=block.idx, op_index=i, op=op, var=n)
                    continue
                if view.is_sub:
                    owner = view.owner_op
                    ctx.report(
                        "use-before-def", ERROR,
                        f"sub-block op reads {n!r}, which is neither "
                        f"captured by the enclosing {owner.type!r} op nor "
                        f"produced earlier in the sub-block — emit_ops "
                        f"will KeyError at trace time",
                        block_idx=block.idx, op_index=i, op=op, var=n)
                    continue
                if v.is_data or v.persistable:
                    continue
                p = producers.get(n)
                if p is not None and p > i:
                    ctx.report(
                        "use-before-def", ERROR,
                        f"{n!r} is consumed at op#{i} but first produced "
                        f"at op#{p}",
                        block_idx=block.idx, op_index=i, op=op, var=n)
                elif p is None:
                    ctx.report(
                        "maybe-uninitialized", WARNING,
                        f"{n!r} has no producer and is not a data/"
                        f"persistable var; it must be fed or already in "
                        f"scope at run time",
                        block_idx=block.idx, op_index=i, op=op, var=n)
            defined.update(op.output_names())


def _live_op_ids(program):
    ids = set()
    for b in program.blocks:
        for op in b.ops:
            ids.add(id(op))
            for sop in op.attrs.get("recompute_sub_ops") or ():
                ids.add(id(sop))
    return ids


@register_check("stale-last-writer")
def check_stale_last_writer(ctx: CheckContext):
    """Variable.op must point at a live op that actually outputs the
    var. A rewrite that deletes or rewires ops without maintaining the
    link breaks backward's producer lookup and pruning — the exact
    breakage conv+BN fusion had before it dropped its dead
    intermediates."""
    live = _live_op_ids(ctx.program)
    for block in ctx.program.blocks:
        for name, v in block.vars.items():
            op = v.op
            if op is None:
                continue
            if id(op) not in live:
                ctx.report(
                    "stale-last-writer", ERROR,
                    f"{name!r} records last-writer op {op.type!r}, which "
                    f"is no longer in any block (removed by a rewrite "
                    f"without updating the link)",
                    block_idx=block.idx, var=name, op=op)
            elif name not in op.output_names():
                ctx.report(
                    "stale-last-writer", ERROR,
                    f"{name!r} records last-writer op {op.type!r}, but "
                    f"that op does not output it (rewired without "
                    f"updating the link)",
                    block_idx=block.idx, var=name, op=op)


def _attr_strings(op):
    """Names referenced through attrs (sub-block out/carry name lists):
    consumers the input slots cannot show."""
    out = []
    for k, v in op.attrs.items():
        if k.startswith("__"):
            continue
        if isinstance(v, str):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, str))
    return out


@register_check("dead-op")
def check_dead_code(ctx: CheckContext):
    """dead-op: every output is non-persistable and nothing consumes it
    (no op input, no attr name list, not in the caller's live set) — the
    op still costs trace+compile time and usually marks a broken rewrite.
    unused-var: a var with neither producer nor consumer (fusion debris).
    Both WARNING: the verifier cannot see fetch lists it was not given
    (pass live_out= / proglint passes feeds+loss)."""
    program = ctx.program
    consumed = set(ctx.live_out)
    for b in program.blocks:
        for op in b.ops:
            consumed.update(op.input_names())
            consumed.update(_attr_strings(op))
    producers = set()
    for view in ctx.views:
        block = view.block
        for i, op in enumerate(block.ops):
            outs = op.output_names()
            producers.update(outs)
            if not outs:
                continue

            def _live(n):
                if n in consumed:
                    return True
                if n.endswith(framework.GRAD_VAR_SUFFIX):
                    # a trainable parameter's gradient is append_backward's
                    # deliverable (params_grads) even before an optimizer
                    # consumes it
                    base = block._find_var_recursive(
                        n[: -len(framework.GRAD_VAR_SUFFIX)])
                    if isinstance(base, framework.Parameter):
                        return True
                v = block._find_var_recursive(n)
                return v is not None and (v.persistable or v.is_data)

            if not any(_live(n) for n in outs):
                ctx.report(
                    "dead-op", WARNING,
                    f"no output of this op ({outs}) is persistable or "
                    f"consumed anywhere; if it is a fetch target, pass "
                    f"it via live_out",
                    block_idx=block.idx, op_index=i, op=op,
                    var=outs[0])
    for view in ctx.views:
        block = view.block
        for name, v in block.vars.items():
            if (v.op is None and name not in producers
                    and name not in consumed and not v.persistable
                    and not v.is_data
                    and not isinstance(v, framework.Parameter)):
                ctx.report(
                    "unused-var", WARNING,
                    f"{name!r} is neither produced nor consumed by any "
                    f"op (debris from a rewrite?)",
                    block_idx=block.idx, var=name)
