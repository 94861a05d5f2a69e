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
and torch orders a rank's collectives on its stream.

The multi-slice ops (fleet's ``hybrid_dcn``) run in the executor's
manual (dcn, dp) path (``EmitContext.manual_axes``); outside it each is
the identity, as in the JAX package.  ``c_dcn_grad_sync`` is the
two-level gradient sync (the reference's hierarchical all-reduce,
platform/nccl_helper.h:185, and DGC's sparse all-reduce,
details/sparse_all_reduce_op_handle.cc): a mean over the inner axes,
then a dense mean over "dcn" (on the ``wire_dtype`` under AMP) or DGC:
the top-k entries by magnitude of gradient + error feedback, their
(value, index) pairs all-gathered over "dcn" and scatter-added, what
was not sent (the bf16 quantisation error included) kept as the next
step's feedback, and a dense step before ``rampup_begin_step``.  The
top-k keeps the lower index among equal magnitudes, as ``lax.top_k``
does (a stable sort; ``torch.topk`` promises no order).
``dcn_expand_param`` tiles a parameter to [n_dcn, *shape] in startup;
``c_dcn_localsgd_sync`` averages LocalSGD's per-slice parameter over
"dcn" on the steps where step % k == k - 1.  The step counters are read
on the host: every rank holds the same one, so all take the same branch
of the collectives.
"""
from __future__ import annotations

import torch

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


def _pmean(x, axes, ctx):
    from .. import distributed as dist

    n = 1
    for a in axes:
        x = dist.all_reduce(x, "sum", a, ctx.mesh)
        n *= ctx.mesh.shape[a]
    return x / n if n > 1 else x


def _top_k_lower_index(flat, k):
    """The indices of the k largest |flat|, the lower index first among
    equal magnitudes (``lax.top_k``'s rule)."""
    return torch.sort(-flat.abs(), stable=True).indices[:k]


def _wire(attrs):
    from ..fluid.dtypes import to_torch_dtype

    w = attrs.get("wire_dtype", "") or ""
    return to_torch_dtype(w) if w else None


@register("c_dcn_grad_sync", no_vjp_grad=True)
def c_dcn_grad_sync(ctx, ins, attrs):
    from .. import distributed as dist

    g = ins["X"][0]
    manual = ctx.manual_axes
    dcn = attrs.get("dcn_axis", "dcn")
    ef = ins.get("ErrorFeedback")
    if dcn not in manual:
        return {"Out": [g], **({"ErrorFeedback": [ef[0]]} if ef else {})}
    inner = [a for a in manual if a != dcn]
    g = _pmean(g, inner, ctx)
    if attrs.get("intra_only", False):
        return {"Out": [g]}      # LocalSGD: gradients sync in the slice
    wire = _wire(attrs)
    if not attrs.get("use_dgc", False):
        gw = g.to(wire) if wire is not None else g
        out = {"Out": [_pmean(gw, [dcn], ctx).to(g.dtype)]}
        if ef:
            out["ErrorFeedback"] = [ef[0]]
        return out
    n_dcn = ctx.mesh.shape[dcn]
    e3 = ef[0]                                    # this slice's [1, *shape]
    acc = (g + e3[0]).float()
    rampup = int(attrs.get("rampup_begin_step", 0))
    if rampup > 0 and "Step" in ins \
            and float(ins["Step"][0].reshape(-1)[0]) < rampup:
        # DGC's warm-up: dense, and no residual
        return {"Out": [_pmean(acc, [dcn], ctx).to(g.dtype)],
                "ErrorFeedback": [torch.zeros_like(e3)]}
    flat = acc.reshape(-1)
    k = max(1, int(round(flat.numel() * (1.0 - float(
        attrs.get("sparsity", 0.999))))))
    top = _top_k_lower_index(flat, k)
    vals = flat[top]
    if wire is not None:
        vals = vals.to(wire)
    sent = torch.zeros_like(flat).index_put_((top,), vals.to(flat.dtype))
    e_new = (flat - sent).reshape(acc.shape)
    # k values and k int32 indices a slice on the wire (lax.top_k's)
    all_vals = dist.all_gather(vals, dcn, 0, ctx.mesh)       # n_dcn * k
    all_idx = dist.all_gather(top.to(torch.int32), dcn, 0,
                              ctx.mesh).long()
    synced = torch.zeros_like(flat).index_add_(
        0, all_idx, all_vals.to(flat.dtype)).reshape(acc.shape) / n_dcn
    return {"Out": [synced.to(g.dtype)],
            "ErrorFeedback": [e_new[None].to(e3.dtype)]}


@register("dcn_expand_param", no_vjp_grad=True)
def dcn_expand_param(ctx, ins, attrs):
    """[n_dcn, *shape] copies of a parameter (idempotent)."""
    x = ins["X"][0]
    n = int(attrs["n_dcn"])
    if x.dim() == int(attrs["param_rank"]) + 1 and x.shape[0] == n:
        return {"Out": [x]}
    return {"Out": [x[None].repeat((n,) + (1,) * x.dim())]}


@register("c_dcn_localsgd_sync", no_vjp_grad=True)
def c_dcn_localsgd_sync(ctx, ins, attrs):
    p = ins["X"][0]
    dcn = attrs.get("dcn_axis", "dcn")
    if dcn not in ctx.manual_axes:
        return {"Out": [p]}
    k = max(1, int(attrs.get("k_steps", 1)))
    step = int(ins["Step"][0].reshape(-1)[0])
    return {"Out": [_pmean(p, [dcn], ctx) if step % k == k - 1 else p]}
