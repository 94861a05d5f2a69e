"""Recompute (activation checkpointing) as a fused segment op.

Parity surface: the reference's RecomputeOptimizer
(python/paddle/fluid/optimizer.py:4478) and its checkpoint-aware
backward (backward.py:629), which re-append the forward ops of each
segment between checkpoints into the backward, so the activations inside
a segment are recomputed there instead of stored.  Ported from the JAX
package's ``ops/recompute.py``: ``RecomputeOptimizer`` collapses each
segment into one ``recompute_segment`` op holding the segment's sub-ops,
and its generic grad op differentiates the segment as a whole.

Where the JAX package replays the sub-ops under ``jax.checkpoint``, the
port marks the op ``no_capture`` (``ops/registry.py``): the forward runs
the sub-ops without autograd and keeps only the segment's outputs (the
checkpoints, and what later ops read); the grad op runs the segment
again under autograd, from its saved inputs, and pulls the output
gradients back through that one segment's graph, which is dropped when
the grad op returns.  The primal-reuse capture, which keeps a
forward's whole graph until its grad op, would keep every activation of
the segment alive and so undo the recompute.

Randomness: a segment's sub-ops run in a sub-``EmitContext`` with the
step's seed (the data-shard salt it carries under a mesh included) and
the step's draw counter where the segment's first run found it; the
counter is recorded under the segment's salt (``0x7EC0 + segment
index``, ``recompute_seg_salt``), and the replay in the backward starts
from it again.  So the replay draws the primal's dropout masks and
flash Philox seeds, and both draw what the unfused program draws: a
recompute run computes the loss of the run without it, bit for bit.
(The JAX package seeds each segment from ``salted_rng(salt)`` instead,
so its recompute run draws other masks than its unfused run.)
"""
from __future__ import annotations

from .registry import EmitContext, emit_ops, register


def _infer_recompute(in_metas, attrs):
    # the outputs keep the metadata recorded when the segment was fused:
    # inferring them would run the whole segment on meta tensors
    return {"Out": [tuple(m) for m in attrs["recompute_out_metas"]]}


@register("recompute_segment", no_capture=True,
          infer_shape=_infer_recompute)
def recompute_segment(ctx: EmitContext, ins, attrs):
    key = int(attrs.get("recompute_seg_salt", 0))
    first = key not in ctx.segment_draws
    if first:
        ctx.segment_draws[key] = ctx._draws
    sub = EmitContext(seed=ctx.seed, device=ctx.device, mesh=ctx.mesh,
                      axis_env=ctx.axis_env, manual_axes=ctx.manual_axes)
    sub._draws = ctx.segment_draws[key]
    env = dict(zip(attrs["recompute_in_names"], ins["X"]))
    emit_ops(sub, attrs["recompute_sub_ops"], env)
    if first:
        ctx._draws = sub._draws  # later ops draw on, as unfused
    return {"Out": [env[n] for n in attrs["recompute_out_names"]]}
