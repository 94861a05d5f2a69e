"""Executor step bookkeeping: the part of the JAX package's
``fluid/monitor.py`` that the checkpoint and the heartbeat read.

Ported: the process step counter (``mark_step``, called by every
``Executor.run``; ``global_step``), the step-rate sample the heartbeat
stamps carry (``step_rate_sample``: the global step and the average
seconds of the recent steps, registered with
``heartbeat.set_step_provider`` on the first executed step),
``observe_checkpoint_save`` (the ``checkpoint_save_ms`` histogram) and
``reset_for_tests``.  Not ported yet (ROADMAP A8): the per-step records
(data wait, device, fetch, idle and checkpoint-save ms, the JSONL
sink), the device-memory statistics, the data-wait fraction the stamps'
aux provider carries and the env-gated consumers ``_arm_aux`` starts.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Tuple

from ..telemetry import get_registry

_reg = get_registry()
_lock = threading.Lock()
_step_count = 0
# monotonic end times of the recent steps: the step-rate sample
_recent = collections.deque(maxlen=16)
_hb_registered = False


def mark_step() -> int:
    """Count one completed ``Executor.run``; returns the index of the step
    just completed (0-based, monotone per process).  The first call
    publishes ``step_rate_sample`` through the heartbeat stamps."""
    global _step_count, _hb_registered
    _reg.counter("executor_steps_total",
                 help="Executor.run completions").inc()
    with _lock:
        step = _step_count
        _step_count += 1
        _recent.append(time.monotonic())
    if not _hb_registered:
        _hb_registered = True
        from ..distributed import heartbeat

        heartbeat.set_step_provider(step_rate_sample)
    return step


def global_step() -> int:
    return _step_count


def step_rate_sample() -> Tuple[int, Optional[float]]:
    """(steps completed, recent average step seconds or None): the
    payload of the heartbeat stamps."""
    with _lock:
        n = _step_count
        if len(_recent) >= 2:
            span = _recent[-1] - _recent[0]
            avg = span / (len(_recent) - 1) if span > 0 else None
        else:
            avg = None
    return n, avg


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
        _recent.clear()
