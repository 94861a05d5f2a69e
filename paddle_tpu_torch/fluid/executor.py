"""Executor: runs a Program's global block op by op on one torch device.

Parity surface: reference Executor (python/paddle/fluid/executor.py:896)
and Scope (paddle/fluid/framework/scope.h:46); ported from the JAX
package's ``fluid/executor.py``.

Where the JAX Executor traces a whole block into one jitted XLA program,
this one interprets it eagerly: each op's torch emitter runs in program
order on the executor's device, and the hand-written CUDA kernels launch
from inside the emitters.  What carries over unchanged:

* the variable classification of a block (reference executor:522-578):
  vars read before any op writes them and not fed come from the scope
  (``state_in``); op outputs that are persistable, or already held by
  the scope, go back to it after the step (``state_out``);
* the feed cast to each data var's declared dtype, then to its runtime
  dtype (64-bit types narrow to 32 bits, as the JAX package runs them);
* the per-step randomness: the scope holds a seed; every step hands it
  to the ops (``EmitContext``) and advances it, so dropout draws differ
  from step to step and repeat from run to run;
* the plan cache keyed like the JAX package's compile cache (program
  serial + version, feed signature, fetch names): the classification is
  computed once per key;
* the spans ``step``, ``data_wait``, ``device`` and ``fetch`` of the
  port's ``telemetry/tracing.py`` (armed by PADDLE_TRACING=1).

The executor has no backward yet, so every block runs under
``torch.inference_mode()``.  Not ported yet: the step monitor, the
numerics guards (FLAGS_check_nan_inf, FLAGS_check_numerics), the memory
OOM doctor and ``memory_analysis``, the mesh / shard_map paths and the
dataset loops (ROADMAP §C).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import framework
from .dtypes import runtime_dtype, to_torch_dtype
from ..ops import registry
from ..telemetry import tracing as _tracing


def _to_tensor(value, device, dtype=None) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of its runtime dtype on
    ``device``; ``dtype`` first casts it to a declared dtype.  A tensor
    moves to ``device`` in the runtime dtype of ``dtype`` (or its own)."""
    if isinstance(value, torch.Tensor):
        want = (value.dtype if dtype is None
                else to_torch_dtype(runtime_dtype(dtype)))
        return value.to(device, want)
    arr = np.asarray(value)
    if dtype is not None and arr.dtype != dtype:
        arr = arr.astype(dtype)
    rt = runtime_dtype(arr.dtype)
    if arr.dtype != rt:
        arr = arr.astype(rt)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class Scope:
    """name -> tensor holder (reference scope.h:46; flat, as in the JAX
    package), plus the per-step seed of the programs run in it."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}
        self._rng_seed: Optional[int] = None

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device=None) -> "Scope":
        """A scope holding ``arrays`` as tensors on ``device`` (None: the
        CUDA card).  It carries weights across from another runtime,
        e.g. the JAX package's initialized scope, since the two packages'
        startup programs draw different random numbers."""
        from .. import resolve_device

        dev = resolve_device(device)
        scope = cls()
        for name, value in arrays.items():
            scope.set_var(name, _to_tensor(value, dev))
        return scope

    def find_var(self, name: str):
        return self.vars.get(name)

    def set_var(self, name: str, value):
        self.vars[name] = value


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


class _BlockPlan:
    """What one cache key of a block needs: its ops and the scope
    variables it reads (``state_in``) and writes back (``state_out``)."""

    def __init__(self, ops, state_in, state_out):
        self.ops = ops
        self.state_in = state_in
        self.state_out = state_out


class Executor:
    """Runs programs on ``device`` (None: the CUDA card; ``"cpu"`` for
    the CPU).  ``place`` is accepted for API parity."""

    def __init__(self, place=None, device=None):
        from .. import resolve_device

        self.place = place
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._cache: Dict[tuple, _BlockPlan] = {}

    def run(
        self,
        program: Optional[framework.Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,  # parity arg; always cached
    ):
        with _tracing.step_span():
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy):
        if program is None:
            program = framework.default_main_program()
        scope = scope or global_scope()
        fetch_names = tuple(
            v.name if isinstance(v, framework.Variable) else str(v)
            for v in (fetch_list or []))
        block = program.global_block()

        with _tracing.span("data_wait"):
            feeds = self._prepare_feed(block, dict(feed or {}))
        plan = self._ensure_plan(program, block, feeds, fetch_names, scope)
        if scope._rng_seed is None:
            scope._rng_seed = int(program.random_seed or 0)

        env: Dict[str, Any] = {}
        for n in plan.state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"Variable {n!r} is used before initialization; run "
                    f"the startup program first.")
            if not isinstance(v, torch.Tensor):
                v = _to_tensor(v, self.device)
            elif v.device != self.device:
                raise RuntimeError(
                    f"Variable {n!r} lives on {v.device}; this executor "
                    f"runs on {self.device}")
            env[n] = v
        env.update(feeds)
        seed = scope._rng_seed
        with torch.inference_mode(), _tracing.span("device"):
            ctx = registry.EmitContext(seed=seed, device=self.device)
            registry.emit_ops(ctx, plan.ops, env)
            fetches = [env[n] for n in fetch_names]
        # advance the step seed even if no op drew from it
        scope._rng_seed = registry.mix_seed(seed, 0x5EED)
        for n in plan.state_out:
            scope.set_var(n, env[n])
        if return_numpy:
            with _tracing.span("fetch"):
                return [f.cpu().numpy() for f in fetches]
        return fetches

    # ------------------------------------------------------------------
    def _ensure_plan(self, program, block, feeds, fetch_names, scope):
        key = self._cache_key(program, feeds, fetch_names)
        plan = self._cache.get(key)
        if plan is None:
            plan = self._cache[key] = self._plan(program, block, feeds,
                                                 fetch_names, scope)
        return plan

    @staticmethod
    def _cache_key(program, feeds, fetch_names):
        feed_sig = tuple((n, tuple(a.shape), str(a.dtype))
                         for n, a in sorted(feeds.items()))
        return (program._serial, program._version, feed_sig, fetch_names)

    def _prepare_feed(self, block, feed):
        out = {}
        for name, value in feed.items():
            # a tensor already on the device is used as it is: no host
            # round trip
            var = block._find_var_recursive(name)
            out[name] = _to_tensor(value, self.device,
                                   None if var is None else var.dtype)
        return out

    @staticmethod
    def _plan(program, block, feeds, fetch_names, scope) -> _BlockPlan:
        ops = list(block.ops)
        written = set(feeds)
        state_in: List[str] = []
        for op in ops:
            if registry.get(op.type) is None:
                raise KeyError(f"op {op.type!r} has no registered emitter")
            for n in op.input_names():
                if n not in written and n not in state_in:
                    state_in.append(n)
            written.update(op.output_names())
        # fetches that are pure feeds/state also work
        for n in fetch_names:
            if n not in written and n not in state_in:
                state_in.append(n)
        persistable = {v.name for v in program.list_vars() if v.persistable}
        state_out = [
            n for n in dict.fromkeys(n for op in ops for n in op.output_names())
            if n in persistable or scope.find_var(n) is not None
        ]
        return _BlockPlan(ops, state_in, state_out)
