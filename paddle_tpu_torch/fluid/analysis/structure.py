"""Structural hazards: control-flow sub-blocks and pipeline stages.

The functional lowering gives sub-blocks (cond / while_loop / recurrent)
an isolated env: only declared carries/outs escape. Two op classes are
hazards there:

  * writes to persistable vars — the write lands in the sub-block's
    local env and is silently DISCARDED (the reference's per-step Scope
    would have persisted it), e.g. batch_norm running stats inside a
    cond branch;
  * ctx.rng()-drawing ops inside while_loop/recurrent bodies — the body
    is traced ONCE into lax.while/scan, so every iteration replays the
    SAME key (same dropout mask each step), unlike the reference's
    per-step execution.

device-stage covers pipeline programs: device_guard tags must describe
contiguous, fully-annotated forward stages or PipelineOptimizer's
stage model (and any future per-stage GPipe split) is meaningless.
"""
from __future__ import annotations

from .core import WARNING, ERROR, CheckContext, register_check

# ops whose emitters draw from the trace-threaded PRNG (ctx.rng())
_RNG_OPS = frozenset({
    "dropout", "uniform_random", "gaussian_random",
    "truncated_gaussian_random", "uniform_random_batch_size_like",
    "randint", "randperm", "bernoulli", "multinomial", "sampling_id",
})

# sub-block owners whose bodies are traced once and iterated on device
_LOOP_OPS = frozenset({"while_loop", "recurrent"})


@register_check("subblock-persistable-write")
def check_subblock_persistable_write(ctx: CheckContext):
    for view in ctx.views:
        if not view.is_sub:
            continue
        block = view.block
        for i, op in enumerate(block.ops):
            for n in op.output_names():
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    ctx.report(
                        "subblock-persistable-write", ERROR,
                        f"op writes persistable {n!r} inside a "
                        f"{view.owner_op.type!r} sub-block; the "
                        f"functional lowering discards the write (only "
                        f"declared block outputs escape) — hoist the "
                        f"write out of the sub-block or carry it as a "
                        f"loop var",
                        block_idx=block.idx, op_index=i, op=op, var=n)


@register_check("subblock-rng")
def check_subblock_rng(ctx: CheckContext):
    for view in ctx.views:
        if not view.is_sub or view.owner_op.type not in _LOOP_OPS:
            continue
        block = view.block
        for i, op in enumerate(block.ops):
            if op.type in _RNG_OPS and not op.attr("is_test", False):
                ctx.report(
                    "subblock-rng", WARNING,
                    f"{op.type!r} draws from the trace-time PRNG inside "
                    f"a {view.owner_op.type!r} body: the body traces "
                    f"once, so every iteration replays the SAME random "
                    f"draw (identical dropout mask per step). Use a "
                    f"salted per-iteration key or hoist the randomness",
                    block_idx=block.idx, op_index=i, op=op)


@register_check("device-stage")
def check_device_stage(ctx: CheckContext):
    """Pipeline stage tags (device_guard -> attr op_device) on the root
    block must be (a) complete — an untagged op between tagged ones has
    no stage — and (b) contiguous over the FORWARD segment (backward
    naturally revisits stages in reverse; it is excluded). Both WARNING:
    the single-program lowering still runs these programs, but the tags
    lie about a partition."""
    block = ctx.program.global_block()
    fwd_end = len(block.ops)
    for i, op in enumerate(block.ops):
        if any("@GRAD" in n for n in op.output_names()):
            fwd_end = i
            break
    tags = [(i, op.attrs.get("op_device"))
            for i, op in enumerate(block.ops[:fwd_end])]
    tagged = [(i, t) for i, t in tags if t]
    stages = {t for _, t in tagged}
    if len(stages) < 2:
        return
    first_i, last_i = tagged[0][0], tagged[-1][0]
    untagged = [i for i, t in tags if not t and first_i < i < last_i]
    if untagged:
        op = block.ops[untagged[0]]
        ctx.report(
            "device-stage", WARNING,
            f"{len(untagged)} op(s) between stage-tagged ops carry no "
            f"device_guard tag (first at op#{untagged[0]}); every op in "
            f"a pipeline region needs a stage",
            block_idx=block.idx, op_index=untagged[0], op=op)
    seen, closed = [], set()
    for i, t in tagged:
        if not seen or seen[-1] != t:
            if t in closed:
                ctx.report(
                    "device-stage", WARNING,
                    f"stage {t!r} reappears at op#{i} after other "
                    f"stages ran — stages must be contiguous for any "
                    f"per-stage split to be meaningful",
                    block_idx=block.idx, op_index=i, op=block.ops[i])
            if seen:
                closed.add(seen[-1])
            seen.append(t)
