"""Static verification framework over the Program IR.

Ported from the JAX package's ``fluid/analysis`` (which holds no JAX):
the same checks, findings and entry points, over the port's Program.
The Executor interprets a block op by op, so a malformed graph —
dangling input, dtype clash, stale last-writer left behind by a rewrite
pass — surfaces as an error deep inside some op's emitter, far from the
layer call that caused it.  This package is the rebuild of the
reference's C++ InferShape checks + `op_callstack` attribution
(operator.cc exception enrichment): a pass manager running pluggable
whole-graph checks, each finding carrying severity, op position, and
the USER call stack captured at `Block.append_op` time.

Two entry points (the JAX package's proglint CLI is not ported yet):

  verify-on-plan      FLAGS_program_verify=1 makes Executor._ensure_plan
                      verify every program on a plan-cache miss, before
                      any op runs, raising a structured
                      ProgramVerifyError that points at the user's layer
                      call instead of failing inside an emitter later.
  pass sandwich       apply_conv_bn_fusion / append_backward /
                      freeze_program verify the program before AND after
                      rewriting (same flag); findings the pass introduced
                      are attributed to it — the MLIR-verifier convention
                      for rewrite pipelines.

The shape-dtype check asks the port's op registry: an op type the port
does not register is an ERROR finding here (the port's executor refuses
it), where the JAX package, which registers it, finds nothing.

Check catalog (registered name -> module):

  dangling-ref, use-before-def, maybe-uninitialized   analysis/dataflow.py
  stale-last-writer, dead-op, unused-var              analysis/dataflow.py
  shape-dtype (eval_shape recompute, -1 tolerant)     analysis/typecheck.py
  dtype-clash, fill-truncation                        analysis/typecheck.py
  grad-integrity, grad-shape-mirror                   analysis/gradcheck.py
  subblock-persistable-write, subblock-rng            analysis/structure.py
  device-stage                                        analysis/structure.py

Whole-job checks (not registered — they need state beyond one Program):

  scope-missing-persistable, scope-uninitialized,     analysis/scopecheck.py
  scope-shape-mismatch, scope-dtype-mismatch,           (verify_scope — a
  scope-orphan-var                                       Program vs a live
                                                         Scope/manifest)
  startup-missing-init, startup-orphan-init           analysis/crosscheck.py
  clone-param-mismatch, clone-train-mode,               (verify_pair —
  clone-grad-op, clone-bn-stats                          startup/main +
  ps-table-missing, ps-table-geometry                    train/eval pairs)

Mechanical repair: analysis/fixes.py `apply_fixes`
runs torn-grads / dead-code / stale-last-writer / startup-init fixers,
re-verifying after each — a fixer that introduces a NEW error raises
attributed `fix:<name>`.

Beyond the checks, the package hosts the static LIVE-RANGE pass
(analysis/liverange.py): first-def/last-use and byte size per
Variable, peak simultaneous-bytes estimate with donation awareness, and
the params/optimizer-state/gradients/feeds/activations categorization.
"""
from .core import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    CheckContext,
    Finding,
    PassManager,
    ProgramVerifyError,
    all_checks,
    assert_valid,
    format_findings,
    register_check,
    user_frame,
    verify_program,
    walk_blocks,
)
from .sandwich import pass_sandwich  # noqa: F401
from .scopecheck import (  # noqa: F401
    assert_scope_valid,
    persistable_reads,
    verify_scope,
)
from .crosscheck import (  # noqa: F401
    assert_pair_valid,
    check_ps_geometry,
    check_startup_main,
    check_train_eval,
    verify_pair,
)
from .fixes import FIXERS, FixReport, apply_fixes  # noqa: F401
from .liverange import (  # noqa: F401
    BufferInfo,
    LiveRangeAnalysis,
    analyze_live_ranges,
)

# importing the check modules registers their checks with core
from . import dataflow, gradcheck, structure, typecheck  # noqa: F401,E402
