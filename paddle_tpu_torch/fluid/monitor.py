"""Executor step bookkeeping: the part of the JAX package's
``fluid/monitor.py`` that the checkpoint reads.

Ported: the process step counter (``mark_step``, called by every
``Executor.run``; ``global_step``), ``observe_checkpoint_save`` (the
``checkpoint_save_ms`` histogram) and ``reset_for_tests``.  Not ported
yet (ROADMAP A8): the per-step records (data wait, device, fetch, idle
and checkpoint-save ms, the JSONL sink), the device-memory statistics,
the heartbeat's step-rate sample and the env-gated consumers
``_arm_aux`` starts.
"""
from __future__ import annotations

import threading

from ..telemetry import get_registry

_reg = get_registry()
_lock = threading.Lock()
_step_count = 0


def mark_step() -> int:
    """Count one completed ``Executor.run``; returns the index of the step
    just completed (0-based, monotone per process)."""
    global _step_count
    _reg.counter("executor_steps_total",
                 help="Executor.run completions").inc()
    with _lock:
        step = _step_count
        _step_count += 1
    return step


def global_step() -> int:
    return _step_count


def observe_checkpoint_save(ms: float) -> None:
    """A CheckpointManager.save's time on the step loop (the snapshot
    only, for an async save)."""
    _reg.histogram("checkpoint_save_ms",
                   help="CheckpointManager.save durations").observe(ms)


def reset_for_tests() -> None:
    """Zero the per-process step state (unit tests only; the registry is
    reset separately via ``telemetry.get_registry().reset()``)."""
    global _step_count
    with _lock:
        _step_count = 0
