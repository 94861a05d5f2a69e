"""Inference pruning (the part of the JAX package's ``fluid/io.py`` that
``freeze_program`` uses).  Saving and loading models
(``save_inference_model``, ``load_inference_model``, params and
persistables) wait for the server slice."""
from __future__ import annotations

from typing import List, Sequence

from . import framework


def _prune_for_inference(program, feed_names: List[str], fetch_vars,
                         state_vars: Sequence[str] = ()) -> "framework.Program":
    """Backward slice from fetch vars, like the reference's prune
    (io.py:1164 save_inference_model -> Program._prune_with_input), of a
    ``clone(for_test=True)`` of ``program``.

    state_vars: extra slice roots for state-carrying vars (decode-step
    caches read at an earlier op and written back at a later one), so
    their writer chain stays live."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = {v.name if isinstance(v, framework.Variable) else str(v)
              for v in fetch_vars} | {str(n) for n in state_vars}
    keep = set()
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if any(n in needed for n in op.output_names()):
            keep.add(i)
            needed.update(op.input_names())
    block.ops = [op for i, op in enumerate(block.ops) if i in keep]
    return pruned
