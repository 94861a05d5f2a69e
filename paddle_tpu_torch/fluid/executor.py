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
* buffer reuse, eagerly: a var leaves the step's env after the last op
  that reads or writes it, unless it goes back to the scope or is
  fetched (``_BlockPlan.free_after``), so a step holds what a compiled
  step would and ``memory_analysis`` measures that;
* the spans ``step``, ``data_wait``, ``device`` and ``fetch`` of the
  port's ``telemetry/tracing.py`` (armed by PADDLE_TRACING=1), and the
  step count of ``fluid/monitor.py`` (``mark_step``);
* the static verifier under FLAGS_program_verify: on a plan-cache miss,
  before any op runs, the program is verified (``assert_valid``) and so
  is the scope it reads (``assert_scope_valid``); with the flag off the
  cost is one flag read a miss.

Autograd mode.  A block that holds grad ops (``fluid.backward``) runs
under ``torch.no_grad()``: the registry switches autograd on only for
the forward ops whose generic grad op follows and inside the grad ops
(primal reuse, ``ops/registry.py``).  A block with no grad op that writes
no scope state (the frozen ``infer`` program) runs under
``torch.inference_mode()``.  A block that writes scope state (a startup
program, a forward with persistable outputs) runs under ``no_grad`` too,
so the scope never holds an inference tensor: autograd refuses to save
one for the backward of a later training step.  The optimizer ops write
``ParamOut``/``Moment*Out`` under the input names: each is a new tensor,
and ``state_out`` writes it back detached, so no step's graph outlives
the step.  ``memory_analysis`` measures one trial step (see there).  Not
ported yet: the step monitor's records, the numerics guards
(FLAGS_check_nan_inf, FLAGS_check_numerics), the memory OOM doctor and
the dataset loops (ROADMAP §C).

Under a mesh (``program._mesh``, attached by ``fleet``) every rank runs
this executor on its own process: a feed keeps the rank's block of its
data axes (``_local_block``), the step seed is salted by the data shard,
and the ops run their own regions over "sp", "tp" and "pp".  A startup
program runs at the global shapes on every rank, unsalted, takes rank
0's values (broadcast, but for the constants every rank computes
alike), and then keeps each rank's block of every persistable that
its spec shards (``parallel.local_shard``: tp, pp and ep parameters,
ZeRO's moments, the multi-slice state), so every layout starts from one
process's weights.  A fetch of such a variable is gathered back to its
global value (``_sync_fetch``).

The JAX package's manual (dcn, dp) path (fleet's ``hybrid_dcn``:
``program._manual_axes``) is the same per-rank step: the feeds split
over both axes, the ops' ``EmitContext.manual_axes`` set, so the
program's c_dcn_grad_sync ops do the two-level gradient sync and
``moe_ffn`` routes each shard's tokens alone, as inside its shard_map.
LocalSGD's divergent parameters and accumulators
(``program._dcn_divergent_names``) are held as the slice's [1, *shape]
block of [n_dcn, *shape] and read by the ops as [*shape].
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import framework, monitor
from .dtypes import runtime_dtype, to_torch_dtype
from .flags import flag
from ..ops import registry
from ..telemetry import tracing as _tracing

from ..parallel import REGION_AXES


# startup ops whose output is the same on every rank, whatever its seed
_CONSTANT_OPS = ("fill_constant", "assign_value")


def _local_block(value, var, mesh):
    """This rank's block of a global feed along the data axes its spec
    names; flat batch indices (``parallel.set_flat_index``) re-based."""
    spec = getattr(var, "_sharding", None)
    for d, axis in enumerate(spec or ()):
        axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
        axes = [a for a in axes if a not in REGION_AXES and mesh.shape[a] > 1]
        if not axes:
            continue
        n = int(np.prod([mesh.shape[a] for a in axes]))
        size = value.shape[d]
        if size % n:
            raise ValueError(f"feed dim {d} of size {size} does not divide "
                             f"over mesh axes {axes} ({n} shards)")
        blk, i = size // n, mesh.shard_index(axes)
        value = value[(slice(None),) * d + (slice(i * blk, (i + 1) * blk),)]
        flat = getattr(var, "_flat_index", None)
        if flat is not None and d == 0:
            batch, row_len = flat
            value = value - i * (batch // n) * row_len
    return value


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


def _sync_fetch(name, x, mesh, spec=None, state=False):
    """A fetch under a mesh: scope state sharded on a mesh axis gathered
    to its global value; other scope state as this rank holds it; a float
    scalar averaged over the mesh, an integer scalar refused, anything
    else gathered on dim 0 over the data axes (the JAX package's
    manual-path contract)."""
    from .. import distributed as dist
    from ..parallel import gather_shard, param_axes

    if state and param_axes(spec):
        return gather_shard(x, spec, mesh)
    if state:
        return x
    if x.dim() == 0 or x.numel() == 1:
        if x.is_floating_point():
            return dist.all_reduce(x, group=None, mesh=mesh) / mesh.size
        raise TypeError(
            f"mesh fetch {name!r} is a non-float scalar: per-shard integer "
            f"metrics have no canonical global reduction; cast it to "
            f"float32 in-program (mean semantics) or sum counts in-program "
            f"before fetching")
    for a in reversed(mesh.data_axes):
        x = dist.all_gather(x, a, 0, mesh)
    return x


class Scope:
    """name -> tensor holder (reference scope.h:46; flat, as in the JAX
    package), plus the per-step seed of the programs run in it."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}
        self._rng_seed: Optional[int] = None

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device=None,
                   program=None) -> "Scope":
        """A scope holding ``arrays`` as tensors on ``device`` (None: the
        CUDA card).  It carries weights across from another runtime,
        e.g. the JAX package's initialized scope, since the two packages'
        startup programs draw different random numbers.  With a
        ``program`` under a mesh, each array is the global value and the
        scope keeps this rank's block of every variable the program
        shards on "tp" or "pp" (``parallel.local_shard``)."""
        from .. import resolve_device
        from ..parallel import local_shard

        dev = resolve_device(device)
        mesh = None if program is None else getattr(program, "_mesh", None)
        block = None if mesh is None else program.global_block()
        scope = cls()
        for name, value in arrays.items():
            var = None if block is None else block._find_var_recursive(name)
            spec = getattr(var, "_sharding", None)
            if spec is not None:
                value = np.ascontiguousarray(local_shard(value, spec, mesh))
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
    """What one cache key of a block needs: its ops, the scope variables
    it reads (``state_in``) and writes back (``state_out``), and the vars
    each op is the last to touch (``free_after``)."""

    def __init__(self, ops, state_in, state_out, fetch_names):
        self.ops = ops
        self.state_in = state_in
        self.state_out = state_out
        # inference mode only for a block with no backward that writes
        # no scope state (see the module note)
        self.inference = not state_out and not registry.has_grad_ops(ops)
        # an eager step frees a var after the last op that reads or
        # writes it, as a compiled step reuses its buffer; what goes back
        # to the scope or to the caller stays
        keep = set(state_out) | set(fetch_names)
        last = {}
        for i, op in enumerate(ops):
            for n in op.input_names() + op.output_names():
                last[n] = i
        self.free_after = [[] for _ in ops]
        for n, i in last.items():
            if n not in keep:
                self.free_after[i].append(n)


def _cpu_high_water(events) -> int:
    """The largest running sum of the profiler's memory records: each
    op's own bytes (``self_cpu_memory_usage``) and each free, taken in
    the order they started."""
    live = high = 0
    for e in sorted(events, key=lambda e: e.time_range.start):
        live += e.self_cpu_memory_usage
        high = max(high, live)
    return high


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
            out = self._run_impl(program, feed, fetch_list, scope,
                                 return_numpy)
        monitor.mark_step()
        return out

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy):
        scope = scope or global_scope()
        plan, env, fetches, seed = self._step(program, feed, fetch_list,
                                              scope)
        # advance the step seed even if no op drew from it
        scope._rng_seed = registry.mix_seed(seed, 0x5EED)
        mesh = getattr(program or framework.default_main_program(),
                       "_mesh", None)
        if mesh is not None and not plan.state_in and plan.state_out:
            # a startup program: every rank takes rank 0's values (a
            # constant, such as a zeroed moment, is every rank's alike),
            # and keeps its block of what the mesh shards
            from .. import distributed as dist
            from ..parallel import local_shard

            block = (program or framework.default_main_program()) \
                .global_block()
            drawn = {n for op in plan.ops if op.type not in _CONSTANT_OPS
                     for n in op.output_names()}
            for n in plan.state_out:
                if n in drawn:
                    env[n] = dist.broadcast(env[n], 0, None, mesh)
                var = block._find_var_recursive(n)
                spec = None if var is None else getattr(var, "_sharding",
                                                        None)
                if spec is not None:
                    env[n] = local_shard(env[n], spec, mesh).contiguous()
        for n in plan.state_out:
            scope.set_var(n, env[n].detach())
        if return_numpy:
            with _tracing.span("fetch"):
                return [f.cpu().numpy() for f in fetches]
        return fetches

    def _step(self, program, feed, fetch_list, scope):
        """Run one step of ``program`` and return (plan, env, fetches,
        seed) without touching ``scope``: the caller writes back."""
        if program is None:
            program = framework.default_main_program()
        fetch_names = tuple(
            v.name if isinstance(v, framework.Variable) else str(v)
            for v in (fetch_list or []))
        block = program.global_block()

        mesh = getattr(program, "_mesh", None)
        with _tracing.span("data_wait"):
            feeds = self._prepare_feed(block, dict(feed or {}), mesh)
        plan = self._ensure_plan(program, block, feeds, fetch_names, scope)
        seed = scope._rng_seed
        if seed is None:
            seed = int(program.random_seed or 0)
        step_seed = seed
        if mesh is not None and mesh.data_shards > 1 and plan.state_in:
            step_seed = registry.mix_seed(
                seed, 0xDA7A0000 + mesh.shard_index(mesh.data_axes))

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
        # LocalSGD's per-slice state: held as this slice's [1, *shape]
        # block of the JAX package's [n_dcn, *shape], read by the ops as
        # [*shape]
        divergent = [n for n in getattr(program, "_dcn_divergent_names", ())
                     if n in env]
        for n in divergent:
            env[n] = env[n][0]
        mode = (torch.inference_mode() if plan.inference
                else torch.no_grad())
        from ..parallel import mesh_guard

        with mode, _tracing.span("device"), mesh_guard(mesh):
            ctx = registry.EmitContext(
                seed=step_seed, device=self.device, mesh=mesh,
                axis_env=None if mesh is None else mesh.axis_env,
                manual_axes=getattr(program, "_manual_axes", ()))
            registry.emit_ops(ctx, plan.ops, env, plan.free_after)
            for n in divergent:
                env[n] = env[n][None]
            fetches = [env[n].detach() for n in fetch_names]
            if mesh is not None:
                state = set(plan.state_in) | set(plan.state_out)
                specs = [getattr(block._find_var_recursive(n), "_sharding",
                                 None) for n in fetch_names]
                fetches = [_sync_fetch(n, f, mesh, spec, n in state)
                           for n, f, spec in zip(fetch_names, fetches,
                                                 specs)]
        return plan, env, fetches, seed

    def memory_analysis(self, program=None, feed=None, fetch_list=None,
                        scope=None) -> Dict[str, int]:
        """The memory one step of ``program`` takes, with the JAX
        package's keys: ``argument_size_in_bytes`` (the scope state the
        step reads, and the feeds), ``output_size_in_bytes`` (the state it
        writes back, and the fetches), ``temp_size_in_bytes`` (the
        step's high-water mark above what it started with, less its
        outputs), ``alias_size_in_bytes`` and
        ``generated_code_size_in_bytes`` (0: an eager step updates no
        buffer in place and compiles no program), and ``peak_bytes`` =
        arguments + outputs + temps - aliased.

        Where the JAX package asks XLA's compiler for an estimate, this
        runs one trial step and measures it; the step's state is not
        written back and the step seed does not advance, so ``scope`` is
        left as it was and the next ``run`` gives the loss it would have
        given without this call.  The startup program must have run in
        ``scope`` first (RuntimeError otherwise).  On the card the
        high-water mark is ``torch.cuda.max_memory_allocated`` after
        ``reset_peak_memory_stats``.  On the CPU, where torch keeps no
        allocator statistics, it is the running sum of the
        ``torch.profiler`` memory records (``profile_memory=True``): each
        op's own allocations and each free, in time order; a buffer an op
        allocates and frees inside itself falls between the records."""
        scope = scope or global_scope()
        fetch_list = list(fetch_list or [])
        block = (program or framework.default_main_program()).global_block()
        # feeds reach the device before the window: arguments, not temps
        feed = self._prepare_feed(block, dict(feed or {}))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            plan, env, fetches, _ = self._step(program, feed, fetch_list,
                                               scope)
            torch.cuda.synchronize(self.device)
            high = torch.cuda.max_memory_allocated(self.device) - base
        else:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU],
                         profile_memory=True) as prof:
                plan, env, fetches, _ = self._step(program, feed,
                                                   fetch_list, scope)
            high = _cpu_high_water(prof.events())
        seen = set()

        def nbytes(tensors):
            total = 0
            for t in tensors:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    total += t.numel() * t.element_size()
            return total

        # env holds the step's new state under the old names: the
        # arguments are the scope's, which the step left as they were
        args = nbytes([scope.find_var(n) for n in plan.state_in
                       if n not in feed]) + nbytes(feed.values())
        outs = nbytes([env[n] for n in plan.state_out]) + nbytes(fetches)
        out = {"argument_size_in_bytes": args,
               "output_size_in_bytes": outs,
               "temp_size_in_bytes": max(0, high - outs),
               "alias_size_in_bytes": 0,
               "generated_code_size_in_bytes": 0}
        out["peak_bytes"] = (out["argument_size_in_bytes"]
                             + out["output_size_in_bytes"]
                             + out["temp_size_in_bytes"]
                             - out["alias_size_in_bytes"])
        return out

    # ------------------------------------------------------------------
    def _ensure_plan(self, program, block, feeds, fetch_names, scope):
        key = self._cache_key(program, feeds, fetch_names)
        plan = self._cache.get(key)
        if plan is None:
            if flag("FLAGS_program_verify"):
                self._verify(program, feeds, fetch_names, scope)
            plan = self._cache[key] = self._plan(program, block, feeds,
                                                 fetch_names, scope)
        return plan

    @staticmethod
    def _verify(program, feeds, fetch_names, scope):
        """The static verifier before a new plan's first step: a
        malformed graph, or a persistable the scope lacks or holds at
        another shape or dtype, raises ProgramVerifyError naming the op's
        build-time call stack instead of failing inside an emitter.
        Orphan-scope warnings are skipped: scopes are shared across
        programs (startup, then main)."""
        from .analysis import assert_scope_valid, assert_valid

        where = "Executor plan (FLAGS_program_verify)"
        assert_valid(program, live_out=set(feeds) | set(fetch_names),
                     where=where)
        assert_scope_valid(program, scope, feed_names=set(feeds),
                           check_orphans=False, where=where)

    @staticmethod
    def _cache_key(program, feeds, fetch_names):
        feed_sig = tuple((n, tuple(a.shape), str(a.dtype))
                         for n, a in sorted(feeds.items()))
        return (program._serial, program._version, feed_sig, fetch_names)

    def _prepare_feed(self, block, feed, mesh=None):
        out = {}
        for name, value in feed.items():
            # a tensor already on the device is used as it is: no host
            # round trip
            var = block._find_var_recursive(name)
            if mesh is not None and var is not None:
                value = _local_block(value, var, mesh)
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
        return _BlockPlan(ops, state_in, state_out, fetch_names)
