"""Fleet 2.0-style distributed API: data, sequence, tensor, pipeline and
expert parallelism, ZeRO-2 and the multi-slice (dcn) modes.

Ported from the JAX package's ``fleet/__init__.py`` (parity surface:
the reference's python/paddle/fleet/base/fleet_base.py, init:25,
distributed_optimizer:213, minimize:234).

The JAX package's ``minimize`` builds backward and the update as usual,
then attaches a mesh and PartitionSpecs; GSPMD inserts every collective.
The port runs one process per rank (``parallel``), so it inserts the one
collective data parallelism needs itself, as the reference's
GradAllReduce transpile does
(the reference's python/paddle/fluid/transpiler/collective.py:178):
``DistributedOptimizer.minimize`` splits backward from the update (the
JAX package's own manual path does the same, ``_backward_params_grads``
and ``_DCNGradSyncOptimizer``) and puts one ``c_allreduce_sum`` and one
``scale(1/dp)`` per parameter gradient, in place, over the "dp" ring,
before the first update op.  The program is otherwise the JAX package's
op for op.  Sequence parallelism marks the attention-bearing ops
(``apply_sequence_parallel``) before backward, as the JAX package does;
their sp regions (``ops/encoder_stack.py``, ``ops/attention.py``) make
every parameter gradient whole on each sp rank, so only dp needs the
mean.  ``strategy.amp`` decorates the inner optimizer (bf16).

Tensor parallelism (a "tp" axis with ``tensor_parallel_rules``).  The
rules shard parameters (``apply_tensor_parallel_rules``): a rank holds
its block of each, and the ops that read them run Megatron's regions
over "tp" on the blocks: a column-parallel ``mul`` / ``matmul`` (weight
``(None, "tp")``, its bias ``("tp",)``) reads its input through f (the
identity, whose backward sums the cotangent over tp) and keeps its
local output columns; the attention op runs on the local heads; a
row-parallel product (weight ``("tp", None)``) sums its partial result
with g (the sum over tp, whose backward is the identity), the bias added
after it by its own ``elementwise_add``; a vocabulary-parallel
``lookup_table`` looks the rows it holds up and sums with g; the tied
MLM head gathers its [N, V/tp] logits along the vocabulary.  The rules
mark each such op (attr ``tp_region``) before backward, so its grad op
replays the same region, and the program stays the JAX package's op for
op.  Inserting ``c_identity`` / ``c_allreduce_sum`` ops around the
regions instead was not chosen: their generic grad ops would go through
``_AllReduceSum``'s convention (the backward all-reduces the cotangent),
which is right for the sp weight sums but would multiply every
gradient behind a row-parallel sum by tp.  Every other op that reads a
tensor-parallel value, and every op that sums over a whole sharded
parameter or its gradient (a global-norm clip's ``squared_l2_norm``),
raises NotImplementedError.

Pipeline parallelism (a "pp" axis with ``strategy.pipeline``).
``PipelineOptimizer`` is outermost: it marks each ``fused_encoder_stack``
for the GPipe schedule (``ops/encoder_stack.py``) before any backward;
``accumulate_steps <= 1`` becomes pp microbatches.  The stacked layer
parameters are sharded on their layer dim (``_shard_pipeline_params``):
stage s holds layers [s L/pp, (s+1) L/pp).  Everything outside the stack
runs on every pp rank alike.  With ``sequence_parallel`` and an "sp"
axis the stages' attention is the ring over sp (pp x sp).

Expert parallelism (``strategy.expert_parallel`` and an "ep" axis):
``apply_expert_parallel`` shards every ``moe_ffn``'s expert weights on
their expert dim; the tokens stay dp-sharded and the router replicated,
and the op exchanges over "ep" through Megatron's f and g
(``ops/moe_ops.py``).

ZeRO-2 (``strategy.sharding``, ``_shard_optimizer_states``): each
optimizer moment whose leading dim dp divides is held as this rank's
[d0/dp, ...] block; its update op (attr ``zero_axis``) updates the
matching rows of the parameter from the dp-averaged gradient and
all-gathers them over "dp", so the parameters stay bit for bit those of
the unsharded run.  The moments of a parameter that tp, pp or ep already
shard keep its spec.

The multi-slice modes (``strategy.hybrid_dcn = n``, a (dcn, dp) mesh):
as the JAX package's manual path, a ``c_dcn_grad_sync`` op per
parameter gradient (``_DCNGradSyncOptimizer``: a mean over "dp", then
over "dcn", dense, on a bf16 wire under AMP unless
``amp_configs["bf16_grad_sync"]`` is off, or DGC with its error
feedback), or LocalSGD (``_DCNLocalSGDOptimizer``: the mean over "dp"
only, per-slice parameters and accumulators averaged over "dcn" every
k steps); no ``c_allreduce_sum`` of fleet's own.

The training-breadth strategies, as the JAX package composes them:
``strategy.lamb`` / ``strategy.lars`` swap the inner optimizer for
``LambOptimizer`` / ``LarsMomentumOptimizer`` (its learning rate, a
schedule's Variable too, carried over); then AMP decorates it,
``strategy.recompute`` wraps it in ``RecomputeOptimizer`` (the
checkpoints of ``recompute_configs``) and ``strategy.gradient_merge``
in ``GradientMergeOptimizer``, with the gradient sync around them and
the pipeline outermost.  LAMB and LARS take norms of the whole
parameter: under ZeRO their ops sum the rows' squares over "dp"
(``ops/optimizer_ops.py``); a parameter tp, pp or ep split is refused
for them (``_finish_param_sharding``), and so is gradient merge with tp,
pp or ep.

Refused by name (``_reject_unsupported``, ``_check_axes``; none is
silently ignored): tp together with sp or pp (ROADMAP A4 item 6); and
what the JAX package refuses: dgc or
localsgd without hybrid_dcn, hybrid_dcn with tp, pp, sp, ep, sharding
or gradient merge, a mesh whose "dcn" axis does not match hybrid_dcn.
elastic and auto raise as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from . import metrics  # noqa: F401  (reference paddle.fleet.metrics)
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (PaddleCloudRoleMaker,  # noqa: F401
                              UserDefinedRoleMaker)
from .. import parallel as _parallel
from ..parallel import (check_shardable, create_mesh, get_var_sharding,
                        param_axes, set_var_sharding)
from ..parallel.env import get_rank, get_world_size, init_parallel_env

_fleet_state = {"initialized": False, "role_maker": None, "strategy": None}

# the queue item that brings each refused mode
_TP_MIX = "ROADMAP A4, next slice item 6: tp together with sp or pp"
_TP_SLICE = "the tensor-parallel slice of ROADMAP A4 runs Megatron regions " \
            "only"


def _distributed():
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None):
    """Initialise the process group when the job has more than one rank
    (``init_parallel_env``: NCCL on the card, gloo on the CPU); a process
    that already initialised it keeps it."""
    if get_world_size() > 1 and not _distributed():
        init_parallel_env()
    _fleet_state.update(initialized=True, role_maker=role_maker,
                        strategy=strategy or DistributedStrategy())


def worker_index() -> int:
    if _distributed():
        import torch.distributed as dist

        return dist.get_rank()
    return get_rank()


def worker_num() -> int:
    if _distributed():
        import torch.distributed as dist

        return dist.get_world_size()
    return get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def worker_endpoints():
    """Launcher-provided endpoints; empty with no launcher env."""
    from ..parallel.env import get_endpoints

    return get_endpoints()


def barrier_worker():
    """A real barrier over every rank; a single process returns."""
    if worker_num() <= 1 or not _distributed():
        return
    import torch.distributed as dist

    dist.barrier()


# -- PS-role lifecycle (reference fleet_base.py:235-249) -------------------


def init_worker(device=None) -> None:
    """Trainer-side PS bootstrap (reference fleet_base.init_worker).
    RemoteTable clients connect lazily on create_table, so this only
    bootstraps the coordination env: the process group (and with it the
    launcher's heartbeat / lease) when the job has more than one rank,
    as ``init`` does; launched trainer scripts can call it
    unconditionally."""
    if get_world_size() > 1 and not _distributed():
        init_parallel_env(device=device)


def init_server(model_dir: Optional[str] = None,
                snapshot_dir: Optional[str] = None,
                snapshot_secs: Optional[float] = None, **kwargs) -> None:
    """Server-side init (reference fleet_base.init_server): record the
    checkpoint directory whose `<table>.pkl` state_dicts preload each
    table on first creation (saved via `ps.get_table(n).state_dict()`).

    snapshot_secs > 0 makes run_server() checkpoint every table
    atomically on that interval (ps_server.PSServer.snapshot), into
    snapshot_dir — defaulting to model_dir, so a crashed-and-restarted
    server resumes from its own latest snapshot through the same preload
    path (bounded-staleness recovery; env fallbacks:
    PADDLE_PS_SNAPSHOT_DIR / PADDLE_PS_SNAPSHOT_SECS).

    Cross-job adoption: each snapshot dir carries a `manifest.json`
    (snapshot epoch, trainer-group generation, table geometries) written
    atomically AFTER the table pickles. Point a NEW job's model_dir — or
    its launcher's stable PADDLE_PS_SNAPSHOT_DIR — at a previous job's
    snapshot dir (of either package) and the tables are adopted;
    inspect what will be adopted with fleet.ps_snapshot_manifest(dir)."""
    _fleet_state["ps_model_dir"] = model_dir
    _fleet_state["ps_snapshot_dir"] = snapshot_dir or model_dir
    _fleet_state["ps_snapshot_secs"] = snapshot_secs


def membership() -> Optional[dict]:
    """The job control plane's membership table: epoch, world size, and
    each member's lease state, straight from the launcher's coordinator
    (PADDLE_COORDINATOR_ENDPOINT). None when no control plane is armed
    — single-process runs and lease-less launches."""
    from ..distributed import coordinator

    return coordinator.query_membership()


def ps_snapshot_manifest(dirname: str) -> Optional[dict]:
    """Parsed manifest.json of a PS snapshot directory (snapshot epoch,
    generation, tables), or None for absent/pre-manifest dirs."""
    from ..distributed.ps_server import read_snapshot_manifest

    return read_snapshot_manifest(dirname)


def ps_stats(table_name: Optional[str] = None) -> dict:
    """PS data-plane telemetry through the idempotent `stats` verb:
    per-verb latency summaries, retry / replay-dedup counters and bytes
    in/out from each pserver process, plus per-table traffic counters.
    Replicated tables (PADDLE_PS_REPLICATION > 1) add a "replication"
    section — factor plus each partition's replica roles, epochs,
    last-applied seqs and lag. Every table also carries a "memory"
    section: per-partition resident bytes (rows x row width + optimizer
    accumulators + the replication log ring).

    table_name names one registered table; None reports every table
    this process created. Hosted tables (RemoteTable) fan the verb out
    to their pservers; in-process tables report their local counters.
    Returns {table_name: stats_dict}."""
    from ..distributed import ps

    names = [table_name] if table_name else sorted(ps._tables)
    out = {}
    for n in names:
        t = ps.get_table(n)
        # GeoSGDClient wraps either table kind: unwrap to whatever can
        # actually report (RemoteTable.stats or the local counters)
        target = t if hasattr(t, "stats") else getattr(t, "server", t)
        if hasattr(target, "stats"):
            out[n] = target.stats()
        else:  # in-process ShardedHostTable
            mem = target.memory_stats()
            out[n] = {"push_calls": target.push_calls,
                      "pushed_bytes": target.pushed_bytes,
                      "servers": [],
                      "memory": {"partitions": {n: mem},
                                 "resident_bytes": mem["resident_bytes"]}}
    return out


def run_server() -> None:
    """Run the pserver event loop on PADDLE_PORT (blocks until a client
    sends shutdown — the listen_and_serv analog, distributed/
    ps_server.py; host memory only, the card is never touched). The
    process role contract matches the reference: TRAINING_ROLE=PSERVER
    processes call init_server() + run_server(), trainers call
    init_worker() and train. PADDLE_PORT is required: trainers resolve a
    FIXED port from PADDLE_PSERVERS_IP_PORT_LIST, so binding an
    ephemeral one would wedge the job undiscoverably."""
    import os as _os

    from ..distributed import ps_server

    port = int(_os.environ.get("PADDLE_PORT", 0))
    if port <= 0:
        raise RuntimeError(
            "fleet.run_server: PADDLE_PORT is not set; the pserver must "
            "bind the port trainers were told about "
            "(PADDLE_PSERVERS_IP_PORT_LIST). For an OS-assigned port use "
            "`python -m paddle_tpu_torch.distributed.ps_server --port 0`, "
            "which prints the bound port")

    def ready(addr):
        print(f"[fleet.run_server] listening on {addr[0]}:{addr[1]}",
              flush=True)

    ps_server.serve(
        port=port,
        preload_dir=_fleet_state.get("ps_model_dir"),
        snapshot_dir=_fleet_state.get("ps_snapshot_dir"),
        snapshot_secs=_fleet_state.get("ps_snapshot_secs"),
        ready_cb=ready,
    )


def stop_worker() -> None:
    """Trainer-side teardown (reference fleet_base.stop_worker): flush
    pending Geo deltas, close RemoteTable connections, and drop the
    tables from the process-local registry so a restarted training
    phase can create_table again."""
    from ..distributed import ps

    for name, t in list(ps._tables.items()):
        if hasattr(t, "flush"):
            t.flush()
        closer = getattr(t, "close", None) or getattr(
            getattr(t, "server", None), "close", None)
        if closer:
            closer()
        ps.drop_table(name)


class DistributedOptimizer:
    """Wraps an inner Optimizer; ``minimize`` = backward, the dp gradient
    all-reduce, the update, and the mesh attached to the programs."""

    def __init__(self, optimizer, strategy: Optional[DistributedStrategy]
                 = None):
        self.inner_opt = optimizer
        self.user_defined_strategy = (strategy or _fleet_state.get("strategy")
                                      or DistributedStrategy())

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..fluid import framework

        strategy = self.user_defined_strategy
        inner = self.inner_opt
        program = loss.block.program
        _reject_unsupported(strategy)
        dcn = int(strategy.hybrid_dcn or 0)
        mesh = strategy.mesh
        if mesh is None:
            axes = dict(strategy.mesh_axes) if strategy.mesh_axes else {}
            if dcn >= 2 and "dcn" not in axes:
                axes = {"dcn": dcn, **(axes or {"dp": -1})}
            axes = axes or {"dp": -1}
            _check_axes(axes, dcn)
            mesh = create_mesh(axes)
        else:
            _check_axes(mesh.shape, dcn)
        if dcn >= 2 and mesh.shape.get("dcn") != dcn:
            # without the outer axis c_dcn_grad_sync would be the
            # identity: slices that silently diverge
            raise ValueError(
                f"strategy.hybrid_dcn={dcn} but the resolved mesh "
                f"{dict(mesh.shape)} has no matching 'dcn' axis; give the "
                f"mesh a 'dcn' axis of exactly that size (or drop "
                f"strategy.mesh/mesh_axes and let fleet build it)")
        sp_active = (strategy.sequence_parallel and "sp" in mesh.axis_names
                     and mesh.shape["sp"] > 1)
        tp_active = "tp" in mesh.axis_names and mesh.shape["tp"] > 1
        pp_active = (strategy.pipeline and "pp" in mesh.axis_names
                     and mesh.shape["pp"] > 1)
        ep_active = (strategy.expert_parallel and "ep" in mesh.axis_names
                     and mesh.shape["ep"] > 1)
        dp = mesh.shape.get("dp", 1)
        if strategy.gradient_merge and (tp_active or pp_active
                                        or ep_active):
            raise NotImplementedError(
                "strategy.gradient_merge with tp, pp or ep: its "
                "accumulators are whole parameters, the gradients a "
                "rank's blocks; not ported (ROADMAP A7)")
        # marks the attention ops BEFORE backward: the grad ops snapshot
        # the forward attrs, so the backward ring is sequence-parallel too
        if sp_active:
            apply_sequence_parallel(program, mesh)
        # the tp regions likewise, so every grad op replays its region
        if tp_active:
            apply_tensor_parallel_rules(program,
                                        strategy.tensor_parallel_rules, mesh)
        inner = _swap_optimizer(inner, strategy)
        if strategy.amp:
            from ..contrib.mixed_precision import decorate

            amp_cfg = dict(strategy.amp_configs or {})
            amp_cfg.pop("bf16_grad_sync", None)  # a dcn-mode knob
            inner = decorate(inner, **amp_cfg)
        if strategy.recompute and strategy.recompute_configs.get(
                "checkpoints"):
            from ..fluid.optimizer import RecomputeOptimizer

            inner = RecomputeOptimizer(inner)
            inner._set_checkpoints(strategy.recompute_configs["checkpoints"])
        if strategy.gradient_merge:
            from ..fluid.optimizer import GradientMergeOptimizer

            cfg = strategy.gradient_merge_configs
            inner = GradientMergeOptimizer(inner,
                                           k_steps=cfg.get("k_steps", 1),
                                           avg=cfg.get("avg", True))
        if dcn >= 2:
            # the JAX package's manual path: the c_dcn_* ops do the whole
            # gradient sync, dp mean included
            inner = (_DCNLocalSGDOptimizer(inner, strategy)
                     if strategy.localsgd
                     else _DCNGradSyncOptimizer(inner, strategy))
        elif "dp" in mesh.axis_names:
            inner = _GradAllReduceOptimizer(inner, mesh)
        if pp_active:
            # outermost: its minimize marks the encoder stacks for the
            # GPipe schedule before backward.  accumulate_steps <= 1 (the
            # default) would be one microbatch, every stage idle
            # (pp-1)/pp of the time: pp microbatches instead
            from ..fluid.optimizer import PipelineOptimizer

            acc = int(strategy.pipeline_configs.get("accumulate_steps", 1))
            if acc <= 1:
                acc = mesh.shape["pp"]
            inner = PipelineOptimizer(inner, num_microbatches=acc)
        result = inner.minimize(loss, startup_program=startup_program,
                                parameter_list=parameter_list,
                                no_grad_set=no_grad_set)
        startup = startup_program or framework.default_startup_program()
        if dcn >= 2:
            program._manual_axes = tuple(a for a in ("dcn", "dp")
                                         if a in mesh.axis_names)
            _parallel.shard_program_data_parallel(
                program, mesh, axis=program._manual_axes)
        elif "dp" in mesh.axis_names:
            _parallel.shard_program_data_parallel(program, mesh, axis="dp")
        if sp_active:
            _parallel.shard_program_sequence_parallel(program, mesh,
                                                      axis="sp")
        if pp_active:
            _shard_pipeline_params(program, mesh)
        if ep_active:
            apply_expert_parallel(program, mesh)
        zero = strategy.sharding and dp > 1      # refused under dcn
        if tp_active or pp_active or ep_active or zero or dcn >= 2:
            _finish_param_sharding(program, startup)
        if zero:
            _shard_optimizer_states(inner, mesh, program, startup)
        program._mesh = mesh
        startup._mesh = mesh
        startup._bump_version()
        return result

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy]
                          = None):
    return DistributedOptimizer(optimizer, strategy)


def _swap_optimizer(inner, strategy):
    """strategy.lamb / strategy.lars: the inner optimizer replaced, as the
    reference's fleet/meta_optimizers/{lamb,lars}_optimizer.py do; its
    learning rate (a float or a schedule's Variable) carries over."""
    lr = getattr(inner, "_learning_rate", 0.001)
    if strategy.lamb:
        from ..fluid.optimizer import LambOptimizer

        cfg = strategy.lamb_configs or {}
        return LambOptimizer(
            learning_rate=lr,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            beta1=cfg.get("beta1", 0.9), beta2=cfg.get("beta2", 0.999),
            epsilon=cfg.get("epsilon", 1e-6))
    if strategy.lars:
        from ..fluid.optimizer import LarsMomentumOptimizer

        cfg = strategy.lars_configs or {}
        return LarsMomentumOptimizer(
            learning_rate=lr,
            momentum=cfg.get("momentum", getattr(inner, "_momentum", 0.9)),
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            epsilon=cfg.get("epsilon", 0))
    return inner


def _backward_params_grads(inner, loss, startup_program, parameter_list,
                           no_grad_set):
    """backward() across inner-optimizer flavors: the AMP decorator
    returns (scaled_loss, params_grads), a plain optimizer params_grads."""
    from ..fluid.optimizer import _params_grads

    return _params_grads(inner.backward(loss, startup_program,
                                        parameter_list, no_grad_set))


class _DCNGradSyncOptimizer:
    """backward, then a c_dcn_grad_sync op per parameter gradient (its
    output a new variable, as in the JAX package), then the inner update
    of the synced gradients.  DGC adds each parameter's error feedback,
    [n_dcn, *shape] sharded on "dcn" (each slice its own), and with
    ``rampup_begin_step`` a step counter incremented after the syncs."""

    def __init__(self, inner, strategy):
        self.inner_opt = inner
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..fluid import unique_name
        from ..fluid.optimizer import _create_persistable_var

        strategy = self._strategy
        n_dcn = int(strategy.hybrid_dcn)
        params_grads = _backward_params_grads(
            self.inner_opt, loss, startup_program, parameter_list,
            no_grad_set)
        block = loss.block.program.global_block()
        use_dgc = bool(strategy.dgc)
        cfgs = strategy.dgc_configs or {}
        sparsity = float(cfgs.get("sparsity", 0.999))
        rampup = int(cfgs.get("rampup_begin_step", 0))
        # under AMP the slow dcn hop carries bf16 (the reference's
        # fp16_allreduce) unless amp_configs["bf16_grad_sync"] is off
        wire = ("bfloat16" if strategy.amp and (strategy.amp_configs or {})
                .get("bf16_grad_sync", True) else "")
        step_var = None
        if use_dgc and rampup > 0:
            # incremented after the syncs: step i reads i, so exactly
            # rampup steps are dense
            step_var = _create_persistable_var(
                unique_name.generate("dcn_dgc_step"), [1], "float32", 0.0)
        synced = []
        for p, g in params_grads:
            if g is None:
                synced.append((p, g))
                continue
            inputs, outputs = {"X": [g]}, {}
            if use_dgc:
                ef = _create_persistable_var(
                    p.name + "@DGCErrorFeedback",
                    (n_dcn,) + tuple(p.shape), "float32", 0.0)
                set_var_sharding(ef, ("dcn",) + (None,) * len(p.shape))
                inputs["ErrorFeedback"] = [ef]
                outputs["ErrorFeedback"] = [ef]
                if step_var is not None:
                    inputs["Step"] = [step_var]
            out_name = unique_name.generate(g.name + "@DCNSync")
            block.append_op(
                type="c_dcn_grad_sync", inputs=inputs,
                outputs={"Out": [out_name], **outputs},
                attrs={"use_dgc": use_dgc, "sparsity": sparsity,
                       "rampup_begin_step": rampup, "dcn_axis": "dcn",
                       "wire_dtype": wire})
            synced.append((p, block.var(out_name)))
        if step_var is not None:
            block.append_op(type="scale", inputs={"X": [step_var]},
                            outputs={"Out": [step_var]},
                            attrs={"scale": 1.0, "bias": 1.0})
        opt_ops = self.inner_opt.apply_optimize(loss, startup_program,
                                                synced)
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


class _DCNLocalSGDOptimizer:
    """LocalSGD across "dcn" (the reference's transpiler/collective.py:270
    LocalSGD transpile): gradients averaged over "dp" only (an
    ``intra_only`` c_dcn_grad_sync), the inner update of per-slice
    parameters, and every k_steps a c_dcn_localsgd_sync averaging each
    parameter over "dcn".  Parameters and accumulators are divergent:
    [n_dcn, *shape] sharded on "dcn" (``dcn_expand_param`` in startup),
    each rank holding its slice's."""

    def __init__(self, inner, strategy):
        self.inner_opt = inner
        self._strategy = strategy

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..fluid import framework, unique_name
        from ..fluid.optimizer import _create_persistable_var

        strategy = self._strategy
        n_dcn = int(strategy.hybrid_dcn)
        k_steps = max(1, int((strategy.localsgd_configs or {})
                             .get("k_steps", 1)))
        params_grads = _backward_params_grads(
            self.inner_opt, loss, startup_program, parameter_list,
            no_grad_set)
        program = loss.block.program
        block = program.global_block()
        synced = []
        for p, g in params_grads:
            if g is None:
                synced.append((p, g))
                continue
            out_name = unique_name.generate(g.name + "@DPSync")
            block.append_op(type="c_dcn_grad_sync", inputs={"X": [g]},
                            outputs={"Out": [out_name]},
                            attrs={"intra_only": True, "dcn_axis": "dcn"})
            synced.append((p, block.var(out_name)))
        opt_ops = self.inner_opt.apply_optimize(loss, startup_program,
                                                synced)
        # int32, incremented after the syncs: step i reads i, so the
        # first average follows exactly k local updates
        step_var = _create_persistable_var(
            unique_name.generate("localsgd_step"), [1], "int32", 0.0)
        divergent = set(getattr(program, "_dcn_divergent_names", ()))
        for p, g in params_grads:
            if g is None:
                continue
            block.append_op(type="c_dcn_localsgd_sync",
                            inputs={"X": [p], "Step": [step_var]},
                            outputs={"Out": [p]},
                            attrs={"k_steps": k_steps, "dcn_axis": "dcn"})
            divergent.add(p.name)
            set_var_sharding(p, ("dcn",) + (None,) * len(p.shape))
        block.append_op(type="increment", inputs={"X": [step_var]},
                        outputs={"Out": [step_var]}, attrs={"step": 1})
        # the accumulators follow their slice's gradients
        for slot in getattr(self.inner_opt, "_accumulators", {}).values():
            for acc_var in slot.values():
                divergent.add(acc_var.name)
                set_var_sharding(acc_var,
                                 ("dcn",) + (None,) * len(acc_var.shape))
        program._dcn_divergent_names = divergent
        startup = startup_program or framework.default_startup_program()
        sblock = startup.global_block()
        for name in sorted(divergent):
            if name in sblock.vars:
                sv = sblock.var(name)
                sblock.append_op(type="dcn_expand_param", inputs={"X": [sv]},
                                 outputs={"Out": [sv]},
                                 attrs={"n_dcn": n_dcn,
                                        "param_rank": len(sv.shape)})
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


class _GradAllReduceOptimizer:
    """backward, then per parameter gradient g: c_allreduce_sum(g) -> g
    over the "dp" ring and scale(g, 1/dp) -> g (none at dp 1), then the
    inner update."""

    def __init__(self, inner, mesh):
        self.inner_opt = inner
        self._mesh = mesh

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = _backward_params_grads(
            self.inner_opt, loss, startup_program, parameter_list,
            no_grad_set)
        block = loss.block.program.global_block()
        dp = self._mesh.shape["dp"]
        ring = self._mesh.ring_id("dp")
        for _, g in params_grads:
            if g is None or dp == 1:      # a dp of 1 has nothing to sum
                continue
            block.append_op(type="c_allreduce_sum", inputs={"X": [g]},
                            outputs={"Out": [g]},
                            attrs={"ring_id": ring, "use_calc_stream": True,
                                   "grad_sync": True})
            block.append_op(type="scale", inputs={"X": [g]},
                            outputs={"Out": [g]},
                            attrs={"scale": 1.0 / dp, "bias": 0.0,
                                   "bias_after_scale": True,
                                   "grad_sync": True})
        opt_ops = self.inner_opt.apply_optimize(loss, startup_program,
                                                params_grads)
        return opt_ops, params_grads

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


def _check_axes(axes, dcn: int = 0):
    for name in axes:
        if name not in ("dp", "sp", "tp", "pp", "ep", "dcn"):
            raise ValueError(f"unknown mesh axis {name!r} (axes: dp, sp, "
                             f"tp, pp, ep, dcn)")
    if "tp" in axes:
        for other in ("sp", "pp"):
            if other in axes:
                raise NotImplementedError(
                    f"mesh axes tp and {other} together: not ported yet "
                    f"({_TP_MIX})")
    if "dcn" in axes and dcn < 2:
        raise NotImplementedError(
            "mesh axis 'dcn' is the slices of a multi-slice job: set "
            "strategy.hybrid_dcn to its size, so that the gradients sync "
            "over it (c_dcn_grad_sync)")
    if dcn >= 2:
        other = [a for a in axes if a not in ("dcn", "dp")]
        if other:
            raise NotImplementedError(
                f"strategy.hybrid_dcn composes with data parallelism and "
                f"amp for now; the mesh also has {other}")


def _reject_unsupported(strategy):
    """Every strategy field the port does not run raises, naming the
    queue item that brings it, and so does every combination the JAX
    package refuses, with its reason."""
    refused = (
        (int(strategy.nccl_comm_num) != 1, "nccl_comm_num",
         "one communicator an axis; bucketing is perf_opt work"),
        (int(strategy.hierarchical_allreduce_inter_nranks) != 1,
         "hierarchical_allreduce_inter_nranks",
         "the two-level sync is strategy.hybrid_dcn's (c_dcn_grad_sync)"),
    )
    for on, name, where in refused:
        if on:
            raise NotImplementedError(
                f"strategy.{name}: not ported yet ({where})")
    dcn = int(strategy.hybrid_dcn or 0)
    if strategy.dgc and dcn < 2:
        raise NotImplementedError(
            "strategy.dgc: deep gradient compression exists to survive "
            "slow interconnects (the reference's details/"
            "sparse_all_reduce_op_handle.cc); without a slow axis to "
            "cross, compression only costs accuracy: set "
            "strategy.hybrid_dcn to the slice count to apply DGC across "
            "the slow dcn axis, where it belongs")
    if dcn >= 2:
        for flag, name in ((strategy.tensor_parallel, "tensor_parallel"),
                           (strategy.pipeline, "pipeline"),
                           (strategy.sequence_parallel, "sequence_parallel"),
                           (strategy.expert_parallel, "expert_parallel"),
                           (strategy.gradient_merge, "gradient_merge")):
            if flag:
                raise NotImplementedError(
                    f"strategy.hybrid_dcn composes with data parallelism "
                    f"and amp for now; unset strategy.{name}")
        if strategy.sharding:
            raise NotImplementedError(
                "strategy.sharding + hybrid_dcn: the multi-slice step runs "
                "manually sharded over (dcn, dp), where the JAX package "
                "cannot meet a dp-sharded accumulator with its replicated "
                "parameter; use sharding on single-slice meshes")
    if strategy.localsgd:
        if dcn < 2:
            raise NotImplementedError(
                "strategy.localsgd: LocalSGD's infrequent sync is for the "
                "slow dcn axis: set strategy.hybrid_dcn to the slice count "
                "(per-slice divergent weights, k-step consensus)")
        if strategy.dgc:
            raise NotImplementedError(
                "strategy.localsgd + strategy.dgc: pick ONE dcn-axis sync "
                "model: k-step parameter averaging (localsgd) or per-step "
                "compressed gradients (dgc)")
    if strategy.elastic:
        raise NotImplementedError(
            "strategy.elastic: a dead flag in the reference too "
            "(distributed_strategy.proto:106, no trainer-side impl); the "
            "recovery story is checkpoint/resume via fluid.checkpoint")
    if strategy.auto:
        raise NotImplementedError(
            "strategy.auto: automatic strategy search is not implemented; "
            "set mesh_axes explicitly")


def apply_sequence_parallel(program, mesh):
    """Mark every attention-bearing op to use the ring over "sp"
    (``parallel/ring_attention.py``).  Must run before append_backward:
    grad ops snapshot forward attrs at creation."""
    for block in program.blocks:
        for op in block.ops:
            if op.type in ("fused_multihead_attention", "fused_encoder_stack",
                           "fused_decoder_stack"):
                op._set_attr("sequence_parallel", True)
    program._bump_version()


# ops that carry a tensor-parallel value through, elementwise
_TP_ELEMENTWISE = ("gelu", "relu", "tanh", "sigmoid", "silu", "cast",
                   "scale")
# ops that sum over every element of their input
_REDUCTIONS = ("squared_l2_norm", "clip_by_norm", "reduce_sum",
               "reduce_mean", "reduce_max", "reduce_min", "mean", "p_norm")
_COLUMN, _ROW, _BIAS = (None, "tp"), ("tp", None), ("tp",)
# update ops that take norms over a whole parameter or its gradient
_NORM_UPDATES = ("lamb", "lars_momentum", "dpsgd")
_SPLIT = "split"      # an activation whose last dim is this rank's block


def apply_tensor_parallel_rules(program, rules, mesh=None):
    """rules: [(name regex, spec)], the first that matches a parameter's
    name gives its PartitionSpec (a Megatron layer is a pair of rules:
    ``models.bert.tensor_parallel_rules``).  Then every op that reads a
    sharded parameter or a tensor-parallel activation is marked with the
    region it runs (attr ``tp_region``: "column", "row", "vocab",
    "vocab_head", "head"; see the module note) or refused.  Must run
    before append_backward, as ``apply_sequence_parallel``: grad ops
    snapshot the forward's attrs.  ``mesh`` (else ``program._mesh``)
    checks that tp divides every sharded dim (ValueError: the JAX package
    pads, the port does not)."""
    import re

    if not rules:
        return
    block = program.global_block()
    if any(op.type.endswith("_grad") for op in block.ops):
        raise RuntimeError(
            "apply_tensor_parallel_rules must run before backward: the "
            "grad ops snapshot their forward's tp_region attr")
    mesh = mesh if mesh is not None else getattr(program, "_mesh", None)
    layout = {}
    for p in program.all_parameters():
        for pattern, spec in rules:
            if re.search(pattern, p.name):
                if mesh is not None:
                    check_shardable(p, spec, mesh)
                set_var_sharding(p, spec)
                layout[p.name] = tuple(spec)
                break
    for op in block.ops:
        _mark_tp_op(op, layout)
    program._bump_version()


def _mark_tp_op(op, layout):
    """Mark ``op``'s region from the layouts of its inputs (a sharded
    parameter's spec, or _SPLIT) and record its outputs' layout."""
    seen = {n: layout[n] for n in op.input_names() if n in layout}
    if not seen:
        return
    t = op.type

    def one(slot):
        names = op.inputs.get(slot) or [None]
        return layout.get(names[0])

    def out(kind):
        for names in op.outputs.values():
            for n in names:
                if kind is not None:
                    layout[n] = kind

    region = None
    if t in ("mul", "matmul"):
        lx, ly = one("X"), one("Y")
        ty = t == "matmul" and bool(op.attr("transpose_Y"))
        tx = t == "matmul" and bool(op.attr("transpose_X"))
        if not tx and not ty and lx is None and ly == _COLUMN:
            region, kind = "column", _SPLIT
        elif not tx and not ty and lx == _SPLIT and ly == _ROW:
            region, kind = "row", None
        elif t == "matmul" and ty and not tx and lx is None and ly == _ROW:
            region, kind = "vocab_head", None     # the tied MLM head
    elif t in ("lookup_table", "lookup_table_v2"):
        if one("W") == _ROW and len(seen) == 1:
            region, kind = "vocab", None
    elif t == "elementwise_add":
        if one("X") == _SPLIT and one("Y") in (_SPLIT, _BIAS):
            region, kind = "", _SPLIT             # local, nothing to run
    elif t in _TP_ELEMENTWISE:
        if one("X") in (_SPLIT, _COLUMN, _ROW, _BIAS):
            region, kind = "", one("X")
    elif t == "fused_multihead_attention":
        if (one("Q") == one("K") == one("V") == _SPLIT
                and one("BiasQK") is None):
            region, kind = "head", _SPLIT
    if region is None:
        raise NotImplementedError(
            f"op {t!r} reads the tensor-parallel "
            f"{', '.join(f'{n} ({k})' for n, k in seen.items())}, and it "
            f"has no tensor-parallel region ({_TP_SLICE}: column- and "
            f"row-parallel mul/matmul, their biases, elementwise "
            f"activations, the fused attention on local heads, the "
            f"vocabulary-parallel lookup_table and tied head)")
    if region:
        op._set_attr("tp_region", region)
    out(kind)


def _finish_param_sharding(program, startup):
    """After minimize: each optimizer state of a parameter sharded on tp,
    pp or ep (a same-shaped input of its update op: moments, velocity)
    takes the parameter's spec; an op that sums over a whole parameter
    such an axis splits, or its gradient, raises; the startup program's
    vars take every persistable's spec, so the executor keeps each
    rank's block after it."""
    from ..parallel import SPLIT_AXES

    block = program.global_block()
    specs = {v.name: get_var_sharding(v) for v in program.list_vars()
             if v.persistable and param_axes(get_var_sharding(v))}

    def split(spec):
        return sorted({a for _, a in param_axes(spec) if a in SPLIT_AXES})

    for op in block.ops:
        pname = (op.inputs.get("Param") or [None])[0]
        if pname not in specs or not split(specs[pname]):
            continue
        if op.type in _NORM_UPDATES:
            raise NotImplementedError(
                f"op {op.type!r} takes norms of the whole of {pname!r}, "
                f"which each rank holds a block of (sharded on "
                f"{', '.join(split(specs[pname]))}); the port sums them "
                f"over dp for ZeRO only: use another optimizer with tp, pp "
                f"or ep")
        pshape = tuple(block._find_var_recursive(pname).shape)
        for n in op.input_names():
            v = block._find_var_recursive(n)
            if (v is not None and v.persistable and n not in specs
                    and tuple(v.shape) == pshape):
                set_var_sharding(v, specs[pname])
                specs[n] = specs[pname]
    # the split tensors and what an elementwise op derives from them
    roots = {n for n, spec in specs.items() if split(spec)}
    derived = roots | {n + "@GRAD" for n in roots}
    for op in block.ops:
        ins = [n for n in op.input_names() if n in derived]
        if not ins:
            continue
        if op.type in _REDUCTIONS:
            axes = split(specs.get(ins[0].split("@")[0]))
            raise NotImplementedError(
                f"op {op.type!r} sums over the whole of {ins[0]!r}, which "
                f"each rank holds a block of (sharded on "
                f"{', '.join(axes) or 'tp'}); the port does not sum it "
                f"over those axes ({_TP_SLICE}): leave out the global-"
                f"norm clip or the per-parameter norm")
        if op.type in ("cast", "scale", "sum", "elementwise_mul",
                       "elementwise_div", "c_allreduce_sum"):
            derived.update(op.output_names())
    sblock = startup.global_block()
    for n, spec in specs.items():
        v = sblock._find_var_recursive(n)
        if v is not None:
            set_var_sharding(v, spec)


def _cast_source(block, name):
    """The variable ``name`` is a cast of (through any chain of casts,
    such as bf16 AMP's before a white op), or ``name`` itself."""
    producers = {n: op for op in block.ops if op.type == "cast"
                 for n in op.output_names()}
    while name in producers:
        name = producers[name].inputs["X"][0]
    return name


def _shard_pipeline_params(program, mesh):
    """Shard the stacked layer parameters of every pipelined
    fused_encoder_stack on their layer dim over "pp" (the JAX package's
    placement analog of the reference's per-section scopes,
    pipeline_trainer.cc:212): stage s holds layers [s L/pp, (s+1) L/pp)."""
    npp = mesh.shape["pp"]
    for block in program.blocks:
        for op in block.ops:
            if op.type != "fused_encoder_stack" or not op.attr("pipeline"):
                continue
            for slot, names in op.inputs.items():
                if slot in ("Hidden", "AttnBias"):
                    continue
                for n in names:
                    v = block._find_var_recursive(_cast_source(block, n))
                    if v is None or not v.persistable or not v.shape:
                        continue
                    if int(v.shape[0]) % npp:
                        raise ValueError(
                            f"num layers {v.shape[0]} must divide by "
                            f"pp={npp}")
                    set_var_sharding(
                        v, ("pp",) + (None,) * (len(v.shape) - 1))


def apply_expert_parallel(program, mesh, axis: str = "ep"):
    """Shard every moe_ffn op's expert-indexed parameters (W1/B1/W2/B2,
    dim 0 = expert) over ``axis``: a rank holds E/ep experts.  The tokens
    stay dp-sharded and the router (GateW) replicated; the op runs its
    own experts and exchanges over ``axis`` through f and g
    (ops/moe_ops.py)."""
    ep = mesh.shape[axis]
    for block in program.blocks:
        for op in block.ops:
            if op.type != "moe_ffn":
                continue
            for slot in ("W1", "B1", "W2", "B2"):
                for n in op.inputs.get(slot, []):
                    v = block._find_var_recursive(_cast_source(block, n))
                    if v is None or not v.shape:
                        continue
                    if v.shape[0] % ep != 0:
                        raise ValueError(
                            f"moe_ffn param {v.name}: num_experts "
                            f"{v.shape[0]} not divisible by ep axis size "
                            f"{ep}")
                    set_var_sharding(v, (axis,) + (None,) *
                                     (len(v.shape) - 1))
    program._bump_version()


def _unwrap_optimizer(opt):
    while True:
        for attr in ("inner_opt", "_optimizer"):
            nxt = getattr(opt, attr, None)
            if nxt is not None:
                opt = nxt
                break
        else:
            return opt


def _shard_optimizer_states(inner, mesh, program, startup):
    """ZeRO-2 (``strategy.sharding``): each moment accumulator of a
    parameter no other axis shards, whose leading dim dp divides, is
    held as this rank's [d0/dp, ...] block (the JAX package's
    ``("dp", None, ...)`` spec); its update op updates the matching rows
    of the parameter and all-gathers them over "dp" (attr ``zero_axis``,
    ops/optimizer_ops.py).  The parameters stay replicated, Adam's [1]
    beta powers too."""
    opt = _unwrap_optimizer(inner)
    accs = getattr(opt, "_accumulators", None)
    if not accs:
        return
    dp = mesh.shape["dp"]
    block = program.global_block()
    sblock = startup.global_block()
    sharded = set()
    for by_param in accs.values():
        for pname, v in by_param.items():
            pvar = block._find_var_recursive(pname)
            if param_axes(get_var_sharding(pvar)) or param_axes(
                    get_var_sharding(v)):
                continue
            if v.shape and v.shape[0] % dp == 0 and v.shape[0] >= dp:
                spec = ("dp",) + (None,) * (len(v.shape) - 1)
                set_var_sharding(v, spec)
                sv = sblock._find_var_recursive(v.name)
                if sv is not None:
                    set_var_sharding(sv, spec)
                sharded.add(v.name)
    for op in block.ops:
        if (op.inputs.get("Param")
                and any(n in sharded for n in op.input_names())):
            op._set_attr("zero_axis", "dp")
    program._bump_version()
