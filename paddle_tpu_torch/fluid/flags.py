"""Global flags registry (reference platform/flags.cc:33-485 — 27 gflags
re-exported to Python via global_value_getter_setter.cc and settable with
FLAGS_* environment variables).

A copy of the JAX package's ``fluid/flags.py``: the same names, defaults
and FLAGS_* environment, so one environment configures both packages.
The help strings and the notes below describe the JAX package's wiring;
the port reads only the flags its ported modules consult
(FLAGS_ps_fault_injection, FLAGS_mem_profile).

TPU-native notes: flags that tuned the CUDA allocator / cuDNN / NCCL are
accepted for API parity but inert — PJRT owns memory and XLA owns
collectives; each such flag documents what subsumes it. Meaningful flags
are wired where listed.
"""
from __future__ import annotations

import os
from typing import Any, Dict

# flag -> (default, wired_into | None)
_DEFS: Dict[str, tuple] = {
    # --- wired ---
    "FLAGS_check_nan_inf": (False, "Executor.run scans fetches + updated "
                                   "state every step and raises naming the "
                                   "first bad variable"),
    "FLAGS_benchmark": (False, "Executor.run blocks until the step "
                               "finishes (sync timing)"),
    "FLAGS_use_flash_attention": (True, "ops/attention.py pallas gate"),
    "FLAGS_use_fused_ln": (True, "ops/pallas/add_ln.py residual+LayerNorm "
                                 "kernel gate (encoder/decoder stacks, "
                                 "layer_norm emitter)"),
    "FLAGS_enable_unused_var_check": (
        False, "Executor._compile warns when a feed variable is consumed "
               "by no op (reference unused_var_check.cc / operator.cc:987 "
               "— the silently-ignored-input bug class)"),
    "FLAGS_conv_bn_fusion": (
        False, "fluid/fusion_pass.py: rewrite conv2d->batch_norm[->relu] "
               "triples into one fused_conv_bn op before append_backward "
               "(Pallas conv+stats+normalize mega-kernel, "
               "ops/pallas/conv_bn.py; is_test folds BN into the conv "
               "weights). Applied by Optimizer.backward and the AMP "
               "decorator; off = program is bit-identical to the unfused "
               "baseline"),
    "FLAGS_pipeline_single_program_fallback": (
        False, "fluid/optimizer.py PipelineOptimizer: explicitly accept "
               "multi-stage device_guard programs as ONE co-scheduled XLA "
               "program (warn instead of raise). Off = minimize raises, "
               "honoring the no-silently-ignored-flags rule: stage tags "
               "name a partition the single-program lowering does not "
               "perform"),
    "FLAGS_conv_dw_im2col": (
        False, "ops/nn_ops.py conv2d: reformulate the WEIGHT gradient as "
               "im2col patches + one matmul (MXU-friendly) instead of "
               "XLA's dW-convolution lowering; NHWC groups=1 non-1x1 "
               "kernels only. The TPU answer to the reference's cudnn "
               "exhaustive dW algo search (conv_cudnn_op.cu.cc)"),
    "FLAGS_ps_fault_injection": (
        False, "distributed/faults.py: deterministic fault layer "
               "(PADDLE_PS_FAULT_SPEC rules drop/refuse/delay the Nth "
               "client RPC, kill the pserver after N handled RPCs, or "
               "crash the process at a named phase of the checkpoint "
               "commit protocol) — drives tests/test_ps_faults.py, "
               "tests/test_checkpoint.py and the tools/ci.sh chaos "
               "smoke. Off = injector() returns None and the data plane "
               "is bit-identical to a build without the layer"),
    "FLAGS_check_numerics": (
        False, "bad-step guard on the fp32 path (AMP has its own "
               "found_inf protocol): Optimizer.apply_gradients emits an "
               "in-graph any-gradient-non-finite reduction into a "
               "persistable check_numerics_bad_* var, Executor.run "
               "refuses to commit a step whose guard tripped (raises "
               "checkpoint.BadStepError with the scope untouched), and "
               "the training loops (Model.fit, train_from_dataset) skip "
               "the step — after FLAGS_check_numerics_max_bad_steps "
               "consecutive bad steps they roll back to the last valid "
               "checkpoint. Off = no guard ops, donation unchanged: "
               "bit-identical to baseline"),
    "FLAGS_check_numerics_max_bad_steps": (
        3, "consecutive BadStepError count that triggers a rollback to "
           "the newest valid checkpoint (or re-raises when no "
           "CheckpointManager is active). Only read when "
           "FLAGS_check_numerics is on"),
    "FLAGS_tensor_stats": (
        False, "in-graph tensor statistics (telemetry/numerics.py): "
               "graph construction (Optimizer.apply_gradients, "
               "fluid/clip.py global-norm clip) appends one "
               "tensor_stats reduction per watched variable — "
               "per-layer gradients, parameters, the clip global norm "
               "— into persistable numstat__* vars that ride the "
               "step's state outputs; the host samples them every "
               "PADDLE_NUMERICS_EVERY steps into kind=\"numerics\" "
               "sink records, numerics_* gauges and the /numericz "
               "history ring (tools/numtop.py is the CLI). The flag "
               "rides the Executor compile-cache key; off = no stat "
               "vars or ops are built and the program, loss trace and "
               "step-record schema are bit-identical to a build "
               "without the layer"),
    "FLAGS_check_numerics_amp_scale_floor": (
        1.0, "unified AMP path for the bad-step guard: with "
             "FLAGS_check_numerics on, an fp16 dynamic-loss-scaling "
             "overflow that would push the scale BELOW this floor "
             "(backoff exhausted — the model is producing non-finite "
             "values at any scale) trips a check_numerics_bad_amp_* "
             "guard var, so the Executor raises BadStepError and the "
             "NaN-provenance doctor dumps a numrec for AMP runs too. "
             "Transient overflows (scale still above the floor) keep "
             "AMP's zero-and-shrink skip semantics. Only read when "
             "FLAGS_check_numerics is on"),
    "FLAGS_program_verify": (
        False, "fluid/analysis static verifier: Executor._ensure_compiled "
               "verifies every program on compile-cache miss (raising "
               "ProgramVerifyError with the offending op's build-time "
               "call stack instead of letting XLA fail later), and "
               "apply_conv_bn_fusion / append_backward run pass-"
               "sandwiched (verify before/after; NEW error findings are "
               "attributed to the pass, MLIR-verifier style). Off = no "
               "check runs and the compile path is bit-identical. "
               "Standalone linting: tools/proglint.py"),
    "FLAGS_op_callstack": (
        True, "Block.append_op captures the Python call stack into the "
              "op's __op_callstack__ attr (reference OpDesc op_callstack) "
              "so verifier findings point at the USER layer call. Capture "
              "is a frame walk (no source reads, ~µs/op); disable for "
              "build-speed-critical jobs — diagnostics then lose source "
              "attribution"),
    "FLAGS_op_profile": (
        False, "per-op device-time attribution (telemetry/cost.py): the "
               "Executor wraps each op's lowering in "
               "jax.named_scope('op<idx>:<type>') so xplane device events "
               "carry the op scope in their HLO op_name metadata — "
               "tools/proftop.py and telemetry.cost join the profile back "
               "to Program IR ops (+ user callstacks). The flag is part "
               "of the compile-cache key; off = the traced computation is "
               "bit-identical to a build without the layer"),
    "FLAGS_mem_profile": (
        False, "per-op HBM attribution (telemetry/memory.py): on every "
               "compile-cache miss the static live-range pass "
               "(fluid/analysis/liverange.py) computes per-variable "
               "byte sizes, first-def/last-use ranges and the peak "
               "simultaneous-bytes estimate, publishes the "
               "hbm_* gauges and the debugz /memz report, and emits a "
               "kind=\"mem_report\" sink record. Host-only analysis — "
               "NOT in the compile-cache key (the traced computation is "
               "unchanged); off = one flag read per compile miss and "
               "step records / wire bytes / loss trace are "
               "bit-identical. The OOM doctor and the "
               "PADDLE_HBM_BUDGET_BYTES gate work independently of "
               "this flag; tools/memtop.py is the CLI"),
    "FLAGS_kernel_autotune": (
        False, "Pallas kernel autotuner (paddle_tpu/tuning): the three "
               "Pallas kernels (flash attention BSH, fused add+LN, "
               "fused conv+BN) consult the per-chip tuning cache "
               "(~/.cache/paddle_tpu/autotune/<chip>.json overlaid on "
               "the checked-in paddle_tpu/tuning/defaults, "
               "$PADDLE_AUTOTUNE_CACHE pins an explicit file) for their "
               "tile/block configs at trace time; a missing entry falls "
               "back to the hand-picked chooser (no behavior cliff). "
               "The active cache fingerprint rides the Executor "
               "compile-cache key so editing the cache retraces. Off = "
               "no lookup runs and emitted programs are bit-identical "
               "to a build without the tuning layer. Search/inspect: "
               "tools/autotune.py"),
    "FLAGS_dataloader_require_spawn": (
        False, "fluid/dataloader: raise instead of warning when worker "
               "args are unpicklable and the loader would fall back to "
               "fork() (which can deadlock under the multithreaded JAX "
               "runtime) — the production-config hard-fail"),
    # --- parity, inert on TPU (subsumed) ---
    "FLAGS_allocator_strategy": ("naive_best_fit", None),  # PJRT allocator
    "FLAGS_fraction_of_gpu_memory_to_use": (0.92, None),
    "FLAGS_eager_delete_tensor_gb": (0.0, None),  # XLA buffer liveness
    "FLAGS_fuse_parameter_memory_size": (-1, None),  # XLA fusion
    "FLAGS_cudnn_deterministic": (False, None),  # XLA is deterministic
    "FLAGS_cpu_deterministic": (False, None),
    "FLAGS_paddle_num_threads": (1, None),  # XLA threadpool
    "FLAGS_inner_op_parallelism": (0, None),
    "FLAGS_sync_nccl_allreduce": (True, None),  # ICI collectives
    "FLAGS_enable_parallel_graph": (False, None),  # GSPMD
}

_values: Dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _init_from_env():
    for name, (default, _) in _DEFS.items():
        raw = os.environ.get(name)
        _values[name] = _coerce(default, raw) if raw is not None else default


_init_from_env()


def get_flags(flags):
    """reference fluid.get_flags: str or list -> {flag: value}."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        if n not in _values:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _values[n]
    return out


def set_flags(flags: Dict[str, Any]):
    """reference fluid.set_flags."""
    for n, v in flags.items():
        if n not in _values:
            raise ValueError(f"unknown flag {n!r}")
        default = _DEFS[n][0]
        _values[n] = _coerce(default, v) if isinstance(v, str) else type(default)(v)


def flag(name: str):
    return _values[name]
