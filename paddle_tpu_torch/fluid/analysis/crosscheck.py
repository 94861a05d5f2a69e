"""Cross-program checks: contracts BETWEEN programs.

Every program pair in a fluid job carries an implicit contract the
single-program verifier cannot see:

  startup/main      every persistable main reads before writing must be
                    written by the startup program (or arrive from a
                    checkpoint restore) — a missed initializer is a
                    None-in-scope crash on step one.
  train/eval clone  hapi's eval program REBUILDS the network, sharing
                    parameters by NAME: the shared Parameters must agree
                    on shape/dtype, every op holding an `is_test` attr
                    must have it flipped True, no optimizer/@GRAD ops
                    may survive in eval, and eval batch_norm ops must
                    read the SAME moving-stats vars train updates
                    (divergent names silently evaluate with frozen
                    init-time statistics).
  PS geometry       a transpiled program's distributed_lookup_table ops
                    name host/pserver tables; the registered table's
                    (rows, dim) must match what the program's output
                    var shapes expect — a stale table from a previous
                    transpile returns wrongly-sized rows.

Entry points: the check_* functions return verifier findings;
`verify_pair` bundles them; `assert_pair_valid` raises
ProgramVerifyError on error findings. Wired (flag-armed) into
hapi.Model.prepare (the fit/evaluate clones) and
DistributeTranspiler.transpile.
"""
from __future__ import annotations

from typing import Iterable, List

from .. import framework
from ..dtypes import convert_dtype, runtime_dtype
from .core import ERROR, WARNING, Finding, ProgramVerifyError
from .scopecheck import persistable_reads
from .typecheck import _shape_mismatch

GRAD = framework.GRAD_VAR_SUFFIX

# op types the optimizer layer emits (reference convention: Param +
# Grad input slots, ParamOut output). Eval programs must carry none.
_OPTIMIZER_SLOTS = ("Param", "Grad")


def _written_names(program) -> set:
    out = set()
    for b in program.blocks:
        for op in b.ops:
            out.update(op.output_names())
    return out


def _referenced_names(program) -> set:
    out = set()
    for b in program.blocks:
        for op in b.ops:
            out.update(op.input_names())
            out.update(op.output_names())
    return out


def _cs(op):
    return op.attrs.get(framework.OP_CALLSTACK_ATTR)


# ---------------------------------------------------------------------------
# startup/main pairing
# ---------------------------------------------------------------------------


def check_startup_main(startup, main,
                       restore_provided: Iterable[str] = (),
                       feed_names: Iterable[str] = ()) -> List[Finding]:
    """startup-missing-init (ERROR): a persistable main reads before any
    write that startup never writes and no restore provides.
    startup-orphan-init (WARNING): startup initializes a var main never
    references — debris from an abandoned builder, or a startup paired
    with the wrong main."""
    findings: List[Finding] = []
    provided = _written_names(startup) | {str(n) for n in restore_provided}
    for name, (op_idx, op) in sorted(
            persistable_reads(main, feed_names).items()):
        if name not in provided:
            findings.append(Finding(
                check="startup-missing-init", severity=ERROR,
                message=f"main reads persistable {name!r} before any "
                        f"write, but the startup program never "
                        f"initializes it (and it is not marked "
                        f"restore-provided)",
                op_index=op_idx, op_type=op.type, var=name,
                callstack=_cs(op)))
    referenced = _referenced_names(main)
    for b in startup.blocks:
        for i, op in enumerate(b.ops):
            for n in op.output_names():
                v = b._find_var_recursive(n)
                if (v is not None and v.persistable
                        and n not in referenced):
                    findings.append(Finding(
                        check="startup-orphan-init", severity=WARNING,
                        message=f"startup initializes {n!r}, which the "
                                f"main program never references (wrong "
                                f"pairing, or builder debris)",
                        block_idx=b.idx, op_index=i, op_type=op.type,
                        var=n, callstack=_cs(op)))
    return findings


# ---------------------------------------------------------------------------
# train/eval clone consistency
# ---------------------------------------------------------------------------


def _is_optimizer_op(op) -> bool:
    return all(s in op.inputs for s in _OPTIMIZER_SLOTS) \
        and "ParamOut" in op.outputs


def check_train_eval(train, eval_program) -> List[Finding]:
    """The hapi clone contract (parameters shared by NAME, not object):

    clone-param-mismatch  ERROR  an eval Parameter is absent from train
                                 or disagrees on shape/dtype — they
                                 share scope storage, so eval would
                                 read tensors of the wrong geometry
    clone-train-mode      ERROR  an eval op holding an `is_test` attr
                                 still runs training semantics
                                 (dropout on, BN updating stats)
    clone-grad-op         ERROR  an optimizer op or a @GRAD-touching op
                                 survives in eval — evaluate() would
                                 TRAIN on the eval set
    clone-bn-stats        ERROR  an eval batch_norm's Mean/Variance
                                 input is not a train persistable —
                                 eval would normalize with frozen
                                 init-time statistics instead of the
                                 running stats train maintains
    """
    findings: List[Finding] = []
    train_blk = train.global_block()
    train_persist = {v.name for v in train.list_vars() if v.persistable}
    for ev in eval_program.list_vars():
        if not isinstance(ev, framework.Parameter):
            continue
        tv = train_blk._find_var_recursive(ev.name)
        if tv is None:
            findings.append(Finding(
                check="clone-param-mismatch", severity=ERROR,
                message=f"eval Parameter {ev.name!r} does not exist in "
                        f"the train program — the clones were built "
                        f"without shared unique_name state",
                var=ev.name))
        elif _shape_mismatch(ev.shape, tv.shape) or (
                ev.dtype is not None and tv.dtype is not None
                and runtime_dtype(convert_dtype(ev.dtype))
                != runtime_dtype(convert_dtype(tv.dtype))):
            findings.append(Finding(
                check="clone-param-mismatch", severity=ERROR,
                message=f"Parameter {ev.name!r} disagrees between the "
                        f"clones: train {tuple(tv.shape or ())}/"
                        f"{convert_dtype(tv.dtype).name} vs eval "
                        f"{tuple(ev.shape or ())}/"
                        f"{convert_dtype(ev.dtype).name} — they share "
                        f"scope storage by name",
                var=ev.name))
    for b in eval_program.blocks:
        for i, op in enumerate(b.ops):
            if "is_test" in op.attrs and not op.attrs.get("is_test"):
                findings.append(Finding(
                    check="clone-train-mode", severity=ERROR,
                    message=f"eval op {op.type!r} still has "
                            f"is_test=False — the clone was not "
                            f"flipped to inference semantics",
                    block_idx=b.idx, op_index=i, op_type=op.type,
                    callstack=_cs(op)))
            grads = [n for n in list(op.input_names())
                     + list(op.output_names()) if GRAD in n]
            if _is_optimizer_op(op) or grads:
                findings.append(Finding(
                    check="clone-grad-op", severity=ERROR,
                    message=f"eval program contains "
                            f"{'optimizer' if _is_optimizer_op(op) else 'gradient'} "
                            f"op {op.type!r} — evaluate() would train "
                            f"on the eval set",
                    block_idx=b.idx, op_index=i, op_type=op.type,
                    var=(grads[0] if grads else None),
                    callstack=_cs(op)))
            if op.type in ("batch_norm", "instance_norm"):
                for slot in ("Mean", "Variance"):
                    for n in op.inputs.get(slot) or ():
                        if n not in train_persist:
                            findings.append(Finding(
                                check="clone-bn-stats", severity=ERROR,
                                message=f"eval {op.type} reads "
                                        f"{slot}={n!r}, which is not a "
                                        f"train persistable — the "
                                        f"moving statistics diverged "
                                        f"between the clones",
                                block_idx=b.idx, op_index=i,
                                op_type=op.type, var=n,
                                callstack=_cs(op)))
    return findings


# ---------------------------------------------------------------------------
# PS-table geometry
# ---------------------------------------------------------------------------


def check_ps_geometry(program) -> List[Finding]:
    """Every distributed_lookup_table op must name a table registered in
    this process whose embedding dim matches the op's output var shape
    (ps-table-missing / ps-table-geometry, both ERROR). Programs with no
    distributed ops return [] without importing the PS layer."""
    findings: List[Finding] = []
    ops = [(b, i, op) for b in program.blocks
           for i, op in enumerate(b.ops)
           if op.type == "distributed_lookup_table"]
    if not ops:
        return findings
    from ...distributed import ps

    for b, i, op in ops:
        names = op.attr("table_names", []) or (
            [op.attr("table_name")] if op.attr("table_name") else [])
        for name in names:
            try:
                table = ps.get_table(name)
            except KeyError:
                findings.append(Finding(
                    check="ps-table-missing", severity=ERROR,
                    message=f"op references PS table {name!r}, but no "
                            f"such table is registered in this process "
                            f"(create_table/transpile before running)",
                    block_idx=b.idx, op_index=i, op_type=op.type,
                    var=name, callstack=_cs(op)))
                continue
            dim = getattr(table, "dim", None)
            for out in op.outputs.get("Outputs") or op.output_names():
                v = b._find_var_recursive(out)
                if (v is not None and v.shape and dim is not None
                        and int(v.shape[-1]) not in (-1, int(dim))):
                    findings.append(Finding(
                        check="ps-table-geometry", severity=ERROR,
                        message=f"PS table {name!r} has embedding dim "
                                f"{dim}, but output {out!r} expects "
                                f"{v.shape[-1]} (stale table from a "
                                f"previous transpile?)",
                        block_idx=b.idx, op_index=i, op_type=op.type,
                        var=name, callstack=_cs(op)))
    return findings


# ---------------------------------------------------------------------------
# bundled entry
# ---------------------------------------------------------------------------


def verify_pair(main, startup=None, eval_program=None,
                restore_provided: Iterable[str] = (),
                feed_names: Iterable[str] = ()) -> List[Finding]:
    """Run every cross-program check the given programs allow:
    startup/main pairing when `startup` is given, train/eval clone
    consistency when `eval_program` is given, and PS-table geometry on
    each program. Returns findings most-severe-first."""
    findings: List[Finding] = []
    if startup is not None:
        findings.extend(check_startup_main(
            startup, main, restore_provided=restore_provided,
            feed_names=feed_names))
    if eval_program is not None:
        findings.extend(check_train_eval(main, eval_program))
        findings.extend(check_ps_geometry(eval_program))
    findings.extend(check_ps_geometry(main))
    findings.sort(key=lambda f: (0 if f.severity == ERROR else 1,
                                 f.check, f.var or ""))
    return findings


def assert_pair_valid(main, startup=None, eval_program=None,
                      restore_provided: Iterable[str] = (),
                      feed_names: Iterable[str] = (),
                      where: str = "") -> List[Finding]:
    findings = verify_pair(main, startup=startup,
                           eval_program=eval_program,
                           restore_provided=restore_provided,
                           feed_names=feed_names)
    if any(f.severity == ERROR for f in findings):
        raise ProgramVerifyError(findings, where=where)
    return findings
