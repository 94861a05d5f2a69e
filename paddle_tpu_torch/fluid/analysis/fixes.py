"""proglint --fix: auto-rewrites for mechanically-fixable findings.

The verifier's findings split into two classes: bugs that need a human
(a shape contract violated, a grad mirrored wrong) and debris a machine
can sweep — exactly the classes a rewrite pass leaves behind when it
forgets to clean up after itself. The fixers here repair the second
class:

  torn-grads          drop ops consuming a producer-less @GRAD (the
                      grad-integrity finding): the forward was rewritten
                      after append_backward and the orphaned grad chain
                      can only KeyError at trace time
  dead-code           sweep dead-op / unused-var findings to a fixpoint
                      (removing a dead op can orphan its inputs' only
                      producer)
  stale-last-writer   recompute Variable.op for vars whose recorded
                      writer was removed or rewired (the freeze_program
                      relink, applied surgically)
  startup-init        append a fill_constant(0) initializer to the
                      startup program for persistables main reads but
                      nothing initializes (NOT semantics-preserving for
                      training quality — it makes a torn job runnable
                      and visible, the value is a placeholder)

Safety protocol (the inverse of `pass_sandwich`, whose contract is
"valid in, valid out" — a fixer's input is broken BY DEFINITION):
verify AFTER each fix and compare against the error set from before it;
any NEW error raises ProgramVerifyError attributed `fix:<name>`.
Pre-existing errors may legitimately remain (a later fixer or the final
lint owns them). The first three fixers are semantics-preserving on the
live (fetch-reachable) graph — `tools/proglint.py --fix` and the ci.sh
round-trip assert bit-identical loss traces for them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .. import framework
from .core import ERROR, Finding, ProgramVerifyError, verify_program
from .dataflow import _attr_strings

GRAD = framework.GRAD_VAR_SUFFIX


@dataclass
class FixReport:
    """One fixer's outcome: what it rewrote, in human-readable lines."""

    name: str
    actions: List[str] = field(default_factory=list)

    @property
    def changed(self) -> bool:
        return bool(self.actions)


# ---------------------------------------------------------------------------
# individual fixers — each mutates in place, returns action lines
# ---------------------------------------------------------------------------


def _remove_op_and_relink(program, block, index: int):
    """Remove block.ops[index] AND repair the last-writer links of its
    outputs (earlier producer in the block, or None) — an op removal
    must not leave the stale-last-writer breakage it would take another
    fixer to clean."""
    op = block.ops[index]
    block._remove_op(index)
    for n in op.output_names():
        v = block._find_var_recursive(n)
        if v is None or v.op is not op:
            continue
        v.op = None
        for cand in reversed(block.ops):
            if n in cand.output_names():
                v.op = cand
                break


def fix_torn_grads(program, live_out: Iterable[str] = ()) -> List[str]:
    """Remove root-block ops consuming a @GRAD name no earlier op
    produces (persistable @GRAD buffers are scope state and exempt).
    Iterates: removing an orphan's consumer can orphan the consumers of
    ITS outputs. Sub-blocks are left alone — a captured grad name there
    is the owner op's contract, not debris."""
    blk = program.global_block()
    actions: List[str] = []
    while True:
        produced: set = set()
        doomed = None
        for i, op in enumerate(blk.ops):
            for n in op.input_names():
                if GRAD not in n or n in produced:
                    continue
                v = blk._find_var_recursive(n)
                if v is not None and v.persistable:
                    continue
                doomed = (i, op, n)
                break
            if doomed:
                break
            produced.update(op.output_names())
        if not doomed:
            break
        i, op, n = doomed
        _remove_op_and_relink(program, blk, i)
        actions.append(f"dropped op#{i} {op.type!r}: consumed torn "
                       f"gradient {n!r} with no producer")
    return actions


def _grad_of_parameter(block, name: str) -> bool:
    if not name.endswith(GRAD):
        return False
    base = block._find_var_recursive(name[: -len(GRAD)])
    return isinstance(base, framework.Parameter)


def fix_dead_code(program, live_out: Iterable[str] = ()) -> List[str]:
    """Sweep dead-op and unused-var findings to a fixpoint, with the
    same liveness the dataflow check uses: an output is live if anything
    consumes it (op input, attr name list, live_out) or it is
    persistable / a data var / a Parameter's gradient."""
    actions: List[str] = []
    live_out = {str(n) for n in live_out}
    while True:
        consumed = set(live_out)
        for b in program.blocks:
            for op in b.ops:
                consumed.update(op.input_names())
                consumed.update(_attr_strings(op))

        def _live(block, n):
            if n in consumed or _grad_of_parameter(block, n):
                return True
            v = block._find_var_recursive(n)
            return v is not None and (v.persistable or v.is_data)

        removed = False
        for b in program.blocks:
            for i in range(len(b.ops) - 1, -1, -1):
                op = b.ops[i]
                outs = op.output_names()
                if outs and not any(_live(b, n) for n in outs):
                    _remove_op_and_relink(program, b, i)
                    actions.append(
                        f"removed dead op#{i} {op.type!r} in block "
                        f"{b.idx} (outputs {outs} never consumed)")
                    removed = True
        if not removed:
            break
    # unused vars: neither produced nor consumed once the ops settled
    touched = set(live_out)
    for b in program.blocks:
        for op in b.ops:
            touched.update(op.input_names())
            touched.update(op.output_names())
            touched.update(_attr_strings(op))
    for b in program.blocks:
        for name in [n for n in b.vars if n not in touched]:
            v = b.vars[name]
            if v.persistable or v.is_data \
                    or isinstance(v, framework.Parameter):
                continue
            del b.vars[name]
            program._bump_version()
            actions.append(f"removed unused var {name!r} from block "
                           f"{b.idx}")
    return actions


def fix_stale_last_writer(program, live_out: Iterable[str] = ()) -> List[str]:
    """Recompute Variable.op for vars whose recorded last writer is no
    longer in any block or no longer outputs them. Only broken links
    are touched — a var legitimately written by a fused op's
    recompute_sub_ops keeps its link."""
    live_ids = set()
    for b in program.blocks:
        for op in b.ops:
            live_ids.add(id(op))
            for sop in op.attrs.get("recompute_sub_ops") or ():
                live_ids.add(id(sop))
    actions: List[str] = []
    for b in program.blocks:
        for name, v in b.vars.items():
            op = v.op
            if op is None:
                continue
            if id(op) in live_ids and name in op.output_names():
                continue
            new_op = None
            for cand in reversed(b.ops):
                if name in cand.output_names():
                    new_op = cand
                    break
            v.op = new_op
            program._bump_version()
            actions.append(
                f"relinked last-writer of {name!r}: stale {op.type!r} "
                f"-> " + (f"{new_op.type!r}" if new_op else "None"))
    return actions


def fix_missing_startup_init(main, startup,
                             restore_provided: Iterable[str] = (),
                             feed_names: Iterable[str] = ()) -> List[str]:
    """Append a fill_constant(0) to `startup` for every persistable the
    main program reads before writing that startup never initializes.
    Vars with unknown or partial shapes cannot be synthesized and are
    reported as skipped (a human owns those)."""
    from .crosscheck import check_startup_main

    actions: List[str] = []
    sblk = startup.global_block()
    for f in check_startup_main(startup, main,
                                restore_provided=restore_provided,
                                feed_names=feed_names):
        if f.check != "startup-missing-init":
            continue
        v = main.global_block()._find_var_recursive(f.var)
        if (v is None or v.shape is None or any(d < 0 for d in v.shape)
                or v.dtype is None):
            actions.append(f"SKIPPED {f.var!r}: shape/dtype unknown, "
                           f"cannot synthesize an initializer")
            continue
        sblk.create_var(name=v.name, shape=tuple(v.shape), dtype=v.dtype,
                        persistable=True)
        sblk.append_op(
            type="fill_constant",
            outputs={"Out": [v.name]},
            attrs={"shape": list(v.shape), "dtype": v.dtype,
                   "value": 0.0})
        actions.append(f"appended fill_constant(0) initializer for "
                       f"{v.name!r} {tuple(v.shape)} to the startup "
                       f"program (placeholder value — review)")
    return actions


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

# name -> (fixer, needs_startup); applied in this order — torn grads
# first (their removal creates dead code), dead-code sweep, then the
# link repair, then the cross-program startup patch
FIXERS = (
    ("torn-grads", fix_torn_grads, False),
    ("dead-code", fix_dead_code, False),
    ("stale-last-writer", fix_stale_last_writer, False),
    ("startup-init", fix_missing_startup_init, True),
)


def _error_keys(program, live_out):
    return {f.key() for f in verify_program(program, live_out=live_out)
            if f.severity == ERROR}


def apply_fixes(program, live_out: Iterable[str] = (), startup=None,
                fixes: Optional[Iterable[str]] = None,
                feed_names: Iterable[str] = (),
                restore_provided: Iterable[str] = ()) -> List[FixReport]:
    """Run the mechanical fixers over `program` in place. `startup`
    enables the cross-program startup-init fixer. `fixes` restricts to a
    subset of FIXERS names. After EACH fixer the program is re-verified:
    an error that was not present before that fixer ran raises
    ProgramVerifyError attributed `fix:<name>` — a fixer may leave
    pre-existing breakage for a later fixer, but may not add its own."""
    wanted = set(fixes) if fixes is not None else None
    unknown = (wanted or set()) - {n for n, _, _ in FIXERS}
    if unknown:
        raise ValueError(f"unknown fix pass(es): {sorted(unknown)}; "
                         f"known: {[n for n, _, _ in FIXERS]}")
    live_out = {str(n) for n in live_out}
    reports: List[FixReport] = []
    for name, fn, needs_startup in FIXERS:
        if wanted is not None and name not in wanted:
            continue
        if needs_startup and startup is None:
            continue
        before = _error_keys(program, live_out)
        if needs_startup:
            actions = fn(program, startup,
                         restore_provided=restore_provided,
                         feed_names=feed_names)
        else:
            actions = fn(program, live_out)
        report = FixReport(name=name, actions=actions)
        reports.append(report)
        if not report.changed:
            continue
        after = verify_program(program, live_out=live_out)
        fresh = [f for f in after
                 if f.severity == ERROR and f.key() not in before]
        if fresh:
            for f in fresh:
                f.pass_name = f"fix:{name}"
            raise ProgramVerifyError(
                fresh, where=f"after fix pass {name!r} — the fix "
                             f"introduced new errors and must not ship")
    return reports
