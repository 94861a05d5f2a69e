"""Scope-aware lint: a Program verified against LIVE state.

The registered checks see one Program in isolation; this module checks
the contract between a program and the state it will run against — a
live `Scope`, a checkpoint's array manifest, or a FrozenModel's captured
weights. The bug class is "fails mid-step": a persistable the program
reads that is absent/None in the scope aborts deep in the step, and a
shape/dtype-mismatched restore fails inside some op's emitter far from
the var that caused it. Here both surface as verifier findings naming
the var AND the owning layer (the first consumer op's build-time call
stack).

Check catalog (reported, not registered — these need scope state the
`register_check` contract does not carry):

  scope-missing-persistable  ERROR    read-before-write persistable
                                      absent from the scope (run the
                                      startup program / restore first)
  scope-uninitialized        ERROR    present but still None (a
                                      Scope.var() placeholder nothing
                                      ever wrote)
  scope-shape-mismatch       ERROR    scope array shape disagrees with
                                      the var meta (-1 dims tolerant)
  scope-dtype-mismatch       ERROR    scope array dtype disagrees
                                      (runtime-normalized: float64
                                      runs as float32)
  scope-orphan-var           WARNING  scope entry no program var names
                                      (stale state from another program
                                      sharing the scope)

Wired into: Executor first-touch (plan-cache miss) under
FLAGS_program_verify; CheckpointManager restore (mismatch raises
RestoreMismatchError naming the var + layer BEFORE anything touches the
scope); freeze_program (the frozen program must read only its captured
weights + detected state vars — unconditional, like the freeze verify).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .. import framework
from ..dtypes import convert_dtype, runtime_dtype
from .core import ERROR, WARNING, Finding, ProgramVerifyError
from .typecheck import _shape_mismatch

_SEV_ORDER = {ERROR: 0, WARNING: 1}


def _scope_items(scope_or_mapping):
    """Duck-typed view over a live Scope OR a plain {name: array}
    mapping (a checkpoint's state["arrays"]): returns the dict."""
    vars_ = getattr(scope_or_mapping, "vars", None)
    if isinstance(vars_, dict):
        return vars_
    return scope_or_mapping


def persistable_reads(program, feed_names: Iterable[str] = ()
                      ) -> Dict[str, Tuple[int, object]]:
    """Persistables the program READS BEFORE WRITING, in op order —
    the names that must already exist in the scope when the block runs
    (params, BN running stats, optimizer moments, decode caches).
    Returns {name: (op_index, op)} of the first reading op in block 0
    (sub-block reads count at their owner op's site), for finding
    attribution. Feeds and data vars are the caller's to provide and
    are excluded."""
    feeds = {str(n) for n in feed_names}
    written: set = set()
    reads: Dict[str, Tuple[int, object]] = {}

    def note_reads(block, op, site_idx, site_op):
        for n in op.input_names():
            if n in written or n in feeds or n in reads:
                continue
            v = block._find_var_recursive(n)
            if v is None or not v.persistable or v.is_data:
                continue
            reads[n] = (site_idx, site_op)
        # sub-blocks execute inside the owner op, after its inputs are
        # read and before its outputs are written
        from .core import _SUB_BLOCK_SPECS

        for blk_attr, _seeds in _SUB_BLOCK_SPECS.get(op.type, ()):
            sub = op.attrs.get(blk_attr)
            if isinstance(sub, framework.Block):
                for sop in sub.ops:
                    note_reads(sub, sop, site_idx, site_op)

    root = program.global_block()
    for i, op in enumerate(root.ops):
        note_reads(root, op, i, op)
        written.update(op.output_names())
    return reads


def _meta_of(value) -> Tuple[Optional[tuple], Optional[object]]:
    """(shape, dtype) of a scope value without materializing it —
    works for tensors, numpy arrays and checkpoint host entries."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    return (tuple(shape) if shape is not None else None, dtype)


def verify_scope(program, scope, feed_names: Iterable[str] = (),
                 check_orphans: bool = True) -> List[Finding]:
    """Verify `program` against `scope` (a Scope or a {name: array}
    mapping). Returns verifier findings, most severe first."""
    entries = _scope_items(scope)
    findings: List[Finding] = []
    for name, (op_idx, op) in sorted(persistable_reads(
            program, feed_names).items()):
        v = program.global_block()._find_var_recursive(name)
        if name not in entries:
            findings.append(Finding(
                check="scope-missing-persistable", severity=ERROR,
                message=f"program reads persistable {name!r}, which is "
                        f"not in the scope — run the startup program "
                        f"(or restore a checkpoint) first",
                op_index=op_idx, op_type=op.type, var=name,
                callstack=op.attrs.get(framework.OP_CALLSTACK_ATTR)))
            continue
        value = entries[name]
        if value is None:
            findings.append(Finding(
                check="scope-uninitialized", severity=ERROR,
                message=f"persistable {name!r} is in the scope but "
                        f"still None (created but never initialized)",
                op_index=op_idx, op_type=op.type, var=name,
                callstack=op.attrs.get(framework.OP_CALLSTACK_ATTR)))
            continue
        shape, dtype = _meta_of(value)
        if (v is not None and v.shape is not None and shape is not None
                and _shape_mismatch(tuple(v.shape), shape)):
            findings.append(Finding(
                check="scope-shape-mismatch", severity=ERROR,
                message=f"persistable {name!r}: program expects shape "
                        f"{tuple(v.shape)} but the scope holds {shape}",
                op_index=op_idx, op_type=op.type, var=name,
                callstack=op.attrs.get(framework.OP_CALLSTACK_ATTR)))
        elif (v is not None and v.dtype is not None and dtype is not None
              and runtime_dtype(convert_dtype(v.dtype))
              != runtime_dtype(convert_dtype(dtype))):
            findings.append(Finding(
                check="scope-dtype-mismatch", severity=ERROR,
                message=f"persistable {name!r}: program expects dtype "
                        f"{convert_dtype(v.dtype).name} but the scope "
                        f"holds {convert_dtype(dtype).name}",
                op_index=op_idx, op_type=op.type, var=name,
                callstack=op.attrs.get(framework.OP_CALLSTACK_ATTR)))
    if check_orphans:
        named = set()
        for b in program.blocks:
            named.update(b.vars)
        for name in sorted(entries):
            if name not in named:
                findings.append(Finding(
                    check="scope-orphan-var", severity=WARNING,
                    message=f"scope holds {name!r}, which no program "
                            f"var names (stale state from another "
                            f"program sharing this scope?)",
                    var=name))
    findings.sort(key=lambda f: (_SEV_ORDER.get(f.severity, 2),
                                 f.var or ""))
    return findings


def assert_scope_valid(program, scope, feed_names: Iterable[str] = (),
                       check_orphans: bool = True,
                       where: str = "") -> List[Finding]:
    """verify_scope, raising ProgramVerifyError on error findings
    (orphan warnings never raise). Returns the findings otherwise."""
    findings = verify_scope(program, scope, feed_names=feed_names,
                            check_orphans=check_orphans)
    if any(f.severity == ERROR for f in findings):
        raise ProgramVerifyError(findings, where=where)
    return findings
