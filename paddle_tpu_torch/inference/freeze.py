"""Program freezing: training Program -> self-contained inference model.

Ported from the JAX package's ``inference/freeze.py`` (the serving-side
analog of the reference's AnalysisPredictor program preparation):

  1. ``clone(for_test=True)`` — every op holding an ``is_test`` attr flips
     to test mode (dropout off, attention dropout off);
  2. backward slice from the fetch targets (``fluid/io.py``'s inference
     prune) — backward ops, optimizer update ops and feed-queue glue all
     fall out because nothing downstream of the fetches needs them;
  3. the conv+BN fold: ``apply_conv_bn_fusion`` on the ``is_test``
     program, whose ``fused_conv_bn`` emitter folds each BN into its
     conv's weights (one conv and one bias add; no kernel runs);
  4. dead-variable sweep: vars only the stripped ops touched leave
     ``block.vars``.

``load_frozen`` freezes a model saved by ``fluid.io.save_inference_model``
(either package's), as a serving replica loads it.

The frozen weights are captured by reference into the FrozenModel's own
scope: the executor replaces a scope entry after a step and never writes
into a captured tensor, so serving stays isolated from further training.

As in the JAX package, the static verifier (``fluid/analysis``) runs
around and after the freeze: the prune is pass-sandwiched under
FLAGS_program_verify, and the frozen program (``verify_program``) and
its captured scope (``assert_scope_valid``) are verified every time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..fluid import executor as _executor
from ..fluid import framework
from ..fluid.analysis import (ERROR, ProgramVerifyError, assert_scope_valid,
                              pass_sandwich, verify_program)
from ..fluid.executor import Scope
from ..fluid.fusion_pass import apply_conv_bn_fusion
from ..fluid.io import _prune_for_inference, load_inference_model


@dataclass
class FrozenModel:
    """A self-contained inference model: pruned ``is_test`` program +
    captured weights.  Everything a Predictor needs."""

    program: framework.Program
    feed_names: List[str]
    fetch_names: List[str]
    param_names: List[str]
    scope: Scope
    fused_conv_bn: int = 0
    meta: Dict[str, object] = field(default_factory=dict)

    def model_info(self) -> dict:
        """JSON-ready description (the ``model_info`` serving verb)."""
        blk = self.program.global_block()

        def var_meta(n):
            v = blk._find_var_recursive(n)
            return {"shape": list(v.shape) if v is not None and
                    v.shape is not None else None,
                    "dtype": str(v.dtype) if v is not None and
                    v.dtype is not None else None}

        return {
            "feeds": {n: var_meta(n) for n in self.feed_names},
            "fetches": {n: var_meta(n) for n in self.fetch_names},
            "num_ops": len(blk.ops),
            "num_params": len(self.param_names),
            "fused_conv_bn": self.fused_conv_bn,
            **self.meta,
        }


def _infer_feed_names(program) -> List[str]:
    return [v.name for v in program.global_block().vars.values()
            if getattr(v, "is_data", False)]


def _detect_state_vars(program, feed_names: Sequence[str],
                       fetch_names: Sequence[str]) -> List[str]:
    """State-carrying cache vars of a decode program: persistable
    non-Parameter vars that the inference slice reads at op index i and
    some op writes back at index j >= i.  The executor writes such vars
    back into the scope after every run, so the frozen program keeps
    their writer ops live.  Computed on a for_test clone (BN batch
    statistics are written in training mode only) and restricted to vars
    the fetch-rooted slice reads (optimizer accumulators stay out),
    iterated to a fixpoint because a kept writer chain can read further
    state vars."""
    test = program.clone(for_test=True)
    blk = test.global_block()
    first_read: Dict[str, int] = {}
    last_write: Dict[str, int] = {}
    for i, op in enumerate(blk.ops):
        for n in op.input_names():
            first_read.setdefault(n, i)
        for n in op.output_names():
            last_write[n] = i
    feeds = set(feed_names)

    state: set = set()
    while True:
        needed = set(str(n) for n in fetch_names) | state
        for i in range(len(blk.ops) - 1, -1, -1):
            op = blk.ops[i]
            if any(n in needed for n in op.output_names()):
                needed.update(op.input_names())
        new = set()
        for n in needed - state:
            if n in feeds:
                continue
            wi, ri = last_write.get(n), first_read.get(n)
            if wi is None or ri is None or ri > wi:
                continue
            v = blk._find_var_recursive(n)
            if v is None or not v.persistable \
                    or isinstance(v, framework.Parameter):
                continue
            new.add(n)
        if not new:
            return sorted(state)
        state |= new


def _relink(program) -> None:
    """Point each var of block 0 at the last op that writes it (None
    for a var no op writes)."""
    blk = program.global_block()
    for v in blk.vars.values():
        v.op = None
    for op in blk.ops:
        for n in op.output_names():
            v = blk._find_var_recursive(n)
            if v is not None:
                v.op = op
    program._bump_version()


def freeze_program(program, scope=None, feed_names: Optional[Sequence[str]]
                   = None, fetch_list: Sequence = ()) -> FrozenModel:
    """Clone ``program`` into a pruned ``is_test`` inference Program and
    capture its weights from ``scope`` (default: the global scope).

    fetch_list: Variables or names the model serves (required).
    feed_names: defaults to the program's data vars.
    """
    if not fetch_list:
        raise ValueError("freeze_program needs a non-empty fetch_list")
    scope = scope or _executor.global_scope()
    fetch_names = [v.name if isinstance(v, framework.Variable) else str(v)
                   for v in fetch_list]
    if feed_names is None:
        feed_names = _infer_feed_names(program)
    feed_names = [str(n) for n in feed_names]
    state_vars = _detect_state_vars(program, feed_names, fetch_names)
    live_out = set(feed_names) | set(fetch_names) | set(state_vars)

    with pass_sandwich(program, "freeze_program", live_out=live_out):
        frozen = _prune_for_inference(program, feed_names, fetch_names,
                                      state_vars=state_vars)
    blk = frozen.global_block()
    # the prune dropped the backward and optimizer ops: relink first, so
    # the fold's own sandwich does not see their vars' stale writers
    _relink(frozen)
    # conv+BN fold: is_test is set, so the fused emitter folds the BN into
    # the conv weights
    fused = apply_conv_bn_fusion(frozen)

    # dead-variable sweep, then rebuild the last-writer links of the
    # surviving vars (a param whose writer was pruned points at no op)
    used = set(live_out)
    for op in blk.ops:
        used.update(op.input_names())
        used.update(op.output_names())
    for name in [n for n in blk.vars if n not in used]:
        del blk.vars[name]
    _relink(frozen)

    # a frozen model ships to serving replicas: always worth one verify
    errors = [f for f in verify_program(frozen, live_out=live_out)
              if f.severity == ERROR]
    if errors:
        raise ProgramVerifyError(errors, where="freeze_program result")

    # capture every persistable the frozen ops still read
    param_names = sorted(
        v.name for v in frozen.list_vars()
        if v.persistable and v.name in used and v.name not in feed_names)
    fscope = Scope()
    missing = []
    for n in param_names:
        val = scope.find_var(n)
        if val is None:
            missing.append(n)
        else:
            fscope.set_var(n, val)
    if missing:
        raise RuntimeError(
            f"freeze_program: {len(missing)} persistable(s) are "
            f"uninitialized in the scope (run the startup program "
            f"first): {missing[:5]}")
    # the frozen program reads only its captured weights and state vars,
    # each of the var's shape and dtype
    assert_scope_valid(frozen, fscope, feed_names=feed_names,
                       where="freeze_program captured scope")
    return FrozenModel(program=frozen, feed_names=list(feed_names),
                       fetch_names=fetch_names, param_names=param_names,
                       scope=fscope, fused_conv_bn=fused,
                       meta={"state_vars": state_vars})


def load_frozen(model_dir: str, model_filename=None, params_filename=None,
                device=None) -> FrozenModel:
    """Freeze a saved inference model (``fluid.io.save_inference_model``
    output of either package) — the disk path serving replicas load
    from.  The weights land on ``device`` (None: the CUDA card)."""
    exe = _executor.Executor(device=device)
    scope = Scope()
    with _executor.scope_guard(scope):
        prog, feeds, fetches = load_inference_model(
            model_dir, exe, model_filename=model_filename,
            params_filename=params_filename)
    fm = freeze_program(prog, scope=scope, feed_names=feeds,
                        fetch_list=fetches)
    fm.meta["model_dir"] = model_dir
    return fm
