"""Core of the static verifier: findings, check registry, pass manager.

A check is a function fn(ctx: CheckContext) registered under a stable
name; it walks ctx.program and reports findings. The PassManager runs a
set of checks and returns the findings sorted most-severe-first. The
whole layer is read-only by contract: no check may mutate the program
(verify_program asserts the version counter did not move).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .. import framework

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

# frames inside the package are framework plumbing; attribution wants the
# deepest frame OUTSIDE it — the user's layer call (reference op_callstack
# convention: the Python stack minus the C++/framework frames)
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # .../paddle_tpu_torch


def user_frame(callstack) -> Optional[Tuple[str, int, str]]:
    """Deepest (file, line, fn) frame not inside paddle_tpu_torch — the user's
    layer call — or None when the whole stack is framework-internal."""
    for frame in callstack or ():
        fname = frame[0]
        if not fname.startswith(_PKG_DIR + os.sep):
            return tuple(frame)
    return None


@dataclasses.dataclass
class Finding:
    check: str
    severity: str
    message: str
    block_idx: int = 0
    op_index: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    pass_name: Optional[str] = None
    callstack: Optional[tuple] = None  # ((file, line, fn), ...)

    def key(self):
        """Identity for sandwich diffing: op indices shift under rewrites,
        so the key is positional-free."""
        return (self.check, self.block_idx, self.op_type, self.var,
                self.message)

    def format(self) -> str:
        where = f"block {self.block_idx}"
        if self.op_index is not None:
            where += f" op#{self.op_index}"
        if self.op_type:
            where += f" [{self.op_type}]"
        if self.var:
            where += f" var {self.var!r}"
        head = f"{self.severity.upper()} {self.check}: {self.message} ({where})"
        if self.pass_name:
            head += f" [introduced by pass: {self.pass_name}]"
        uf = user_frame(self.callstack)
        if uf is not None:
            head += f"\n    at {uf[0]}:{uf[1]} in {uf[2]}"
        return head


class ProgramVerifyError(RuntimeError):
    """Raised (flag-gated) when verification finds error-severity
    problems; carries the structured findings so handlers/tests can
    inspect them instead of parsing the message."""

    def __init__(self, findings: Sequence[Finding], where: str = ""):
        self.findings = list(findings)
        errors = [f for f in self.findings if f.severity == ERROR]
        head = (f"program verification failed"
                f"{f' ({where})' if where else ''}: "
                f"{len(errors)} error(s)")
        super().__init__("\n".join([head] + [f.format() for f in errors]))


@dataclasses.dataclass
class BlockView:
    """One block in execution context: `entry_names` are the names the
    runtime seeds the block's env with (sub-blocks see ONLY these plus
    their own ops' outputs — emit_ops raises on anything else)."""
    block: "framework.Block"
    entry_names: frozenset
    owner_op: Optional["framework.Operator"] = None  # None for block 0
    owner_block_idx: int = 0
    owner_op_index: Optional[int] = None

    @property
    def is_sub(self) -> bool:
        return self.owner_op is not None


# op type -> ((block_attr, (seed name-list attrs...)), ...) — the
# sub-block env contract each control-flow emitter establishes
# (the JAX package's ops/control_flow_ops.py; the port has no
# control-flow op yet, so every walk here stops at block 0)
_SUB_BLOCK_SPECS = {
    "cond": (
        ("true_block", ("captured_names",)),
        ("false_block", ("captured_names",)),
    ),
    "while_loop": (
        ("cond_block", ("captured_names", "loop_var_names")),
        ("body_block", ("captured_names", "loop_var_names")),
    ),
    "recurrent": (
        ("step_block", ("captured_names", "step_input_names",
                        "memory_in_names")),
    ),
}


def walk_blocks(program) -> List[BlockView]:
    """Blocks in execution order: block 0 first, each sub-block at its
    owner op's site with the entry names the emitter will seed. Blocks
    in program.blocks that no op references are skipped (orphans from
    abandoned builders never execute)."""
    views: List[BlockView] = []

    def recurse(block, entry, owner=None, owner_blk=0, owner_idx=None):
        views.append(BlockView(block, frozenset(entry), owner,
                               owner_blk, owner_idx))
        for i, op in enumerate(block.ops):
            spec = _SUB_BLOCK_SPECS.get(op.type)
            if spec is None:
                continue
            for blk_attr, seed_attrs in spec:
                sub = op.attrs.get(blk_attr)
                if not isinstance(sub, framework.Block):
                    continue
                seeds = []
                for a in seed_attrs:
                    seeds.extend(op.attrs.get(a) or ())
                recurse(sub, seeds, op, block.idx, i)

    root = program.global_block()
    recurse(root, ())
    return views


class CheckContext:
    def __init__(self, program, live_out: Iterable[str] = ()):
        self.program = program
        # names the caller declares live (feeds/fetches): consumers the
        # graph itself cannot show, consulted by the dead-code check
        self.live_out = frozenset(live_out)
        self.findings: List[Finding] = []
        self.views = walk_blocks(program)

    def report(self, check: str, severity: str, message: str, *,
               block_idx: int = 0, op_index: Optional[int] = None,
               op=None, var: Optional[str] = None) -> Finding:
        f = Finding(
            check=check, severity=severity, message=message,
            block_idx=block_idx, op_index=op_index,
            op_type=op.type if op is not None else None, var=var,
            callstack=op.attrs.get("__op_callstack__")
            if op is not None else None,
        )
        self.findings.append(f)
        return f


_CHECKS: Dict[str, Callable[[CheckContext], None]] = {}


def register_check(name: str):
    def deco(fn):
        _CHECKS[name] = fn
        return fn

    return deco


def all_checks() -> List[str]:
    return sorted(_CHECKS)


class PassManager:
    """Runs a set of named checks over a program. One CheckContext is
    shared so checks reuse the block walk."""

    def __init__(self, checks: Optional[Sequence[str]] = None,
                 live_out: Iterable[str] = ()):
        self.check_names = list(checks) if checks is not None else None
        self.live_out = frozenset(live_out)

    def run(self, program) -> List[Finding]:
        names = self.check_names
        if names is None:
            names = all_checks()
        unknown = [n for n in names if n not in _CHECKS]
        if unknown:
            raise ValueError(f"unknown check(s) {unknown}; "
                             f"registered: {all_checks()}")
        ctx = CheckContext(program, live_out=self.live_out)
        version = program._version
        for n in names:
            _CHECKS[n](ctx)
        # read-only contract: a check that mutated the program would make
        # "verify" change what gets compiled — exactly the bug class this
        # layer exists to catch
        assert program._version == version, (
            "a verifier check mutated the program (version "
            f"{version} -> {program._version})")
        ctx.findings.sort(key=lambda f: (_SEV_ORDER.get(f.severity, 3),
                                         f.block_idx, f.op_index
                                         if f.op_index is not None else -1))
        return ctx.findings


def verify_program(program, checks: Optional[Sequence[str]] = None,
                   live_out: Iterable[str] = ()) -> List[Finding]:
    """Run the (given or full) check suite; returns findings sorted
    most-severe-first. Never raises on findings — see assert_valid."""
    return PassManager(checks, live_out=live_out).run(program)


def assert_valid(program, live_out: Iterable[str] = (),
                 where: str = "") -> List[Finding]:
    """verify_program, raising ProgramVerifyError when any finding is
    error-severity. Returns the findings (incl. warnings) otherwise."""
    findings = verify_program(program, live_out=live_out)
    if any(f.severity == ERROR for f in findings):
        raise ProgramVerifyError(findings, where=where)
    return findings


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "no findings"
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    summary = ", ".join(f"{counts[s]} {s}(s)" for s in (ERROR, WARNING, INFO)
                        if s in counts)
    return "\n".join([f.format() for f in findings] + [summary])
