"""Fleet 2.0-style distributed API: data and sequence parallelism.

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

Not ported yet, and refused by name (``_reject_unsupported``; none is
silently ignored): tensor, pipeline and expert parallelism, ZeRO
sharding and the multi-slice (dcn) modes with DGC and LocalSGD (ROADMAP
A4's next slice); lamb and lars, recompute and gradient merge (A7);
the parameter-server roles (A6).  elastic and auto raise as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

from . import metrics  # noqa: F401  (reference paddle.fleet.metrics)
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (PaddleCloudRoleMaker,  # noqa: F401
                              UserDefinedRoleMaker)
from .. import parallel as _parallel
from ..parallel import create_mesh
from ..parallel.env import get_rank, get_world_size, init_parallel_env

_fleet_state = {"initialized": False, "role_maker": None, "strategy": None}

# the queue item that brings each refused mode
_TP = "ROADMAP A4, next slice item 1: tensor_parallel_rules as per-rank " \
      "column/row-parallel layers"
_PP = "ROADMAP A4, next slice item 2: GPipe and pp x sp"
_EP = "ROADMAP A4, next slice item 3: moe_ops.py with ep all-to-alls"
_ZERO = "ROADMAP A4, next slice item 4: sharding (ZeRO-2)"
_DCN = "ROADMAP A4, next slice item 5: the executor's (dcn, dp) manual " \
       "path and c_dcn_*"
_PS = "ROADMAP A6: the parameter server and the job control plane"
_A7 = "ROADMAP A7: training breadth"


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


def _ps_refused(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"fleet.{name}: not ported yet ({_PS})")

    fn.__name__ = name
    return fn


# parameter-server and control-plane roles (reference fleet_base.py:235-249)
init_worker = _ps_refused("init_worker")
init_server = _ps_refused("init_server")
run_server = _ps_refused("run_server")
stop_worker = _ps_refused("stop_worker")
membership = _ps_refused("membership")
ps_snapshot_manifest = _ps_refused("ps_snapshot_manifest")
ps_stats = _ps_refused("ps_stats")


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
        mesh = strategy.mesh
        if mesh is None:
            axes = dict(strategy.mesh_axes) if strategy.mesh_axes \
                else {"dp": -1}
            _check_axes(axes)
            mesh = create_mesh(axes)
        else:
            _check_axes(mesh.shape)
        sp_active = (strategy.sequence_parallel and "sp" in mesh.axis_names
                     and mesh.shape["sp"] > 1)
        # marks the attention ops BEFORE backward: the grad ops snapshot
        # the forward attrs, so the backward ring is sequence-parallel too
        if sp_active:
            apply_sequence_parallel(program, mesh)
        if strategy.amp:
            from ..contrib.mixed_precision import decorate

            amp_cfg = dict(strategy.amp_configs or {})
            amp_cfg.pop("bf16_grad_sync", None)  # a dcn-mode knob
            inner = decorate(inner, **amp_cfg)
        if "dp" in mesh.axis_names:
            inner = _GradAllReduceOptimizer(inner, mesh)
        result = inner.minimize(loss, startup_program=startup_program,
                                parameter_list=parameter_list,
                                no_grad_set=no_grad_set)
        if "dp" in mesh.axis_names:
            _parallel.shard_program_data_parallel(program, mesh, axis="dp")
        if sp_active:
            _parallel.shard_program_sequence_parallel(program, mesh,
                                                      axis="sp")
        program._mesh = mesh
        startup = startup_program or framework.default_startup_program()
        startup._mesh = mesh
        startup._bump_version()
        return result

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy]
                          = None):
    return DistributedOptimizer(optimizer, strategy)


def _backward_params_grads(inner, loss, startup_program, parameter_list,
                           no_grad_set):
    """backward() across inner-optimizer flavors: the AMP decorator
    returns (scaled_loss, params_grads), a plain optimizer params_grads."""
    res = inner.backward(loss, startup_program, parameter_list, no_grad_set)
    if (isinstance(res, tuple) and len(res) == 2
            and isinstance(res[1], list)):
        return res[1]
    return res


class _GradAllReduceOptimizer:
    """backward, then per parameter gradient g: c_allreduce_sum(g) -> g
    over the "dp" ring and scale(g, 1/dp) -> g, then the inner update."""

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
            if g is None:
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


def _check_axes(axes):
    for name in axes:
        if name in ("dp", "sp"):
            continue
        where = {"tp": _TP, "pp": _PP, "ep": _EP, "dcn": _DCN}.get(name)
        if where:
            raise NotImplementedError(
                f"mesh axis {name!r}: not ported yet ({where})")
        raise ValueError(f"unknown mesh axis {name!r} (axes: dp, sp, tp, "
                         f"pp, ep, dcn)")


def _reject_unsupported(strategy):
    """Every strategy field this slice does not run raises, naming the
    queue item that brings it."""
    refused = (
        (strategy.tensor_parallel or strategy.tensor_parallel_rules,
         "tensor_parallel", _TP),
        (strategy.pipeline, "pipeline", _PP),
        (strategy.expert_parallel, "expert_parallel", _EP),
        (strategy.sharding, "sharding", _ZERO),
        (int(strategy.hybrid_dcn or 0) >= 2, "hybrid_dcn", _DCN),
        (strategy.dgc, "dgc", _DCN),
        (strategy.localsgd, "localsgd", _DCN),
        (strategy.lamb, "lamb", _A7 + " (the lamb update op)"),
        (strategy.lars, "lars", _A7 + " (the lars_momentum update op)"),
        (strategy.recompute, "recompute",
         _A7 + " (RecomputeOptimizer)"),
        (strategy.gradient_merge, "gradient_merge",
         _A7 + " (GradientMergeOptimizer)"),
        (int(strategy.nccl_comm_num) != 1, "nccl_comm_num",
         "one communicator an axis; bucketing is perf_opt work"),
        (int(strategy.hierarchical_allreduce_inter_nranks) != 1,
         "hierarchical_allreduce_inter_nranks", _DCN),
    )
    for on, name, where in refused:
        if on:
            raise NotImplementedError(
                f"strategy.{name}: not ported yet ({where})")
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


def apply_tensor_parallel_rules(program, rules):
    raise NotImplementedError(f"tensor parallel rules: not ported yet ({_TP})")


def apply_expert_parallel(program, mesh, axis: str = "ep"):
    raise NotImplementedError(f"expert parallelism: not ported yet ({_EP})")
