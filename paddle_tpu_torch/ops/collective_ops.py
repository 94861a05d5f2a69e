"""Collective ops: c_allreduce_* / c_broadcast / c_allgather /
c_reducescatter / c_identity and the stream / bootstrap no-ops.

Ported from the JAX package's ``ops/collective_ops.py`` (parity surface:
the reference's operators/collective/, c_allreduce_op.h:73-106 calling
ncclAllReduce on the ring keyed by ring_id).  ``ring_id`` names a mesh
axis through ``EmitContext.axis_env`` (``Mesh.axis_env``: an axis's
position in the mesh), which the executor fills when it runs a program
under a mesh; the collective then runs over that axis's process group
through ``paddle_tpu_torch.distributed`` (NCCL on the card, gloo on the
CPU).  Emitted with no axis bound (no mesh, shape inference) each op is
its single-participant self, as in the JAX package, except that shape
inference scales c_allgather's dim 0 up and c_reducescatter's down by
the ``nranks`` attr when it is given (the reference's InferShape).

The stream-sync and bootstrap ops (c_sync_*, c_wait_*, c_gen_nccl_id,
c_comm_init*) are no-ops: ``init_parallel_env`` makes the process groups
and torch orders a rank's collectives on its stream.  The multi-slice
ops c_dcn_grad_sync, dcn_expand_param and c_dcn_localsgd_sync raise:
they come with the executor's (dcn, dp) manual path (ROADMAP A4, the next
slice).
"""
from __future__ import annotations

from .registry import register


def _axis(ctx, attrs):
    env = getattr(ctx, "axis_env", None) or {}
    return env.get(int(attrs.get("ring_id", 0)))


def _nranks_shape(x, attrs, up: bool):
    n = int(attrs.get("nranks", 0) or 0)
    if x.device.type != "meta" or n <= 1 or x.dim() == 0:
        return x
    shape = list(x.shape)
    shape[0] = shape[0] * n if up else shape[0] // n
    return x.new_empty(shape)


def _allreduce(op_name):
    def emit(ctx, ins, attrs):
        from .. import distributed as dist

        x = ins["X"][0]
        ax = _axis(ctx, attrs)
        if ax is None:
            return {"Out": [x]}
        return {"Out": [dist.all_reduce(x, op=op_name, group=ax,
                                        mesh=ctx.mesh)]}

    return emit


register("c_allreduce_sum")(_allreduce("sum"))
register("c_allreduce_max")(_allreduce("max"))
register("c_allreduce_min")(_allreduce("min"))
register("c_allreduce_prod")(_allreduce("prod"))


@register("c_broadcast")
def c_broadcast(ctx, ins, attrs):
    from .. import distributed as dist

    x = ins["X"][0]
    ax = _axis(ctx, attrs)
    if ax is None:
        return {"Out": [x]}
    return {"Out": [dist.broadcast(x, src=int(attrs.get("root", 0)),
                                   group=ax, mesh=ctx.mesh)]}


@register("c_allgather")
def c_allgather(ctx, ins, attrs):
    from .. import distributed as dist

    x = ins["X"][0]
    ax = _axis(ctx, attrs)
    if ax is None:
        return {"Out": [_nranks_shape(x, attrs, up=True)]}
    return {"Out": [dist.all_gather(x, group=ax, mesh=ctx.mesh)]}


@register("c_reducescatter")
def c_reducescatter(ctx, ins, attrs):
    from .. import distributed as dist

    x = ins["X"][0]
    ax = _axis(ctx, attrs)
    if ax is None:
        return {"Out": [_nranks_shape(x, attrs, up=False)]}
    return {"Out": [dist.reduce_scatter(x, group=ax, mesh=ctx.mesh)]}


@register("c_identity")
def c_identity(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


def _noop(ctx, ins, attrs):
    out = ins.get("X")
    return {"Out": [out[0]]} if out else {}


register("c_sync_calc_stream", no_vjp_grad=True)(_noop)
register("c_sync_comm_stream", no_vjp_grad=True)(_noop)
register("c_wait_compute", no_vjp_grad=True)(_noop)
register("c_wait_comm", no_vjp_grad=True)(_noop)
register("c_gen_nccl_id", no_vjp_grad=True)(lambda ctx, ins, attrs: {})
register("c_comm_init", no_vjp_grad=True)(lambda ctx, ins, attrs: {})
register("c_comm_init_all", no_vjp_grad=True)(lambda ctx, ins, attrs: {})


def _next_slice(name):
    def emit(ctx, ins, attrs):
        raise NotImplementedError(
            f"{name}: the multi-slice (dcn, dp) manual path is not ported "
            f"yet (ROADMAP A4, the next slice: the executor's (dcn, dp) "
            f"path and c_dcn_*)")

    return emit


for _name in ("c_dcn_grad_sync", "dcn_expand_param", "c_dcn_localsgd_sync"):
    register(_name, no_vjp_grad=True)(_next_slice(_name))
