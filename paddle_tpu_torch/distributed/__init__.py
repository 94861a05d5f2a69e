"""paddle.distributed-style collectives over a mesh, one process per rank.

Ported from the JAX package's ``distributed/__init__.py`` (parity
surface: the reference's python/paddle/distributed/ and the c_* op
family, operators/collective/).  There a "process group" is a named mesh
axis and each collective is the ``jax.lax`` primitive over it, inside a
``shard_map`` body.  Here each rank is a process and each axis a
``torch.distributed`` process group of the ``Mesh``
(``parallel/__init__.py``): ``group`` names the axis, resolved on the
``mesh`` passed in or on the one bound by ``parallel.mesh_guard`` (the
executor and ``collective`` bind theirs).  An axis without a process
group (a size-1 mesh in a process that never initialised
``torch.distributed``) makes every collective the identity.

Autograd: the differentiable collectives are ``torch.autograd.Function``s
whose backward passes are the transposes JAX derives for the same
per-rank body:

* ``all_reduce`` (sum): its backward all-reduces the cotangent;
* ``send_recv`` / ``ppermute``: the cotangent travels the inverse
  permutation;
* ``all_gather``, used in a replicated context (every rank holds the
  same cotangent of the gathered value): its backward keeps this rank's
  block of it;
* ``reduce_scatter``: its backward all-gathers the cotangent;
* ``copy_to_region`` (Megatron's "f", the reference's ``c_identity``
  around a model-parallel region; ``sp_identity`` is its name on "sp"):
  the identity, whose backward all-reduces (sums) the cotangent over the
  axis, so a tensor every rank of the axis reads whole (a weight used on
  every rank's tokens, the input of a column-parallel product) gets the
  whole gradient on each;
* ``reduce_from_region`` (Megatron's "g"): the all-reduce (sum) of each
  rank's partial result, whose backward is the identity.  Every rank
  computes the same loss from the summed tensor, so each already holds
  the whole cotangent; all-reducing it again, as ``all_reduce``'s
  backward does, would multiply the gradient by the axis size;
* ``broadcast_from_last``: every rank of the axis gets its last rank's
  tensor (the pipeline's last stage output), and the backward hands
  each rank its own cotangent once, for the same reason;
* ``shard_slice``: this rank's block of a replicated tensor, whose
  backward all-gathers the cotangent (the entry of a sequence-parallel
  region; ``all_gather`` is its exit).

``all_reduce`` max / min / prod, ``broadcast``, ``reduce`` and
``scatter`` are forward only, with the JAX semantics: prod gathers and
multiplies in rank order (negatives included), ``reduce`` gives zeros on
the ranks other than ``dst``, ``scatter`` raises on a dim the group size
does not divide.  ``barrier`` is a real ``dist.barrier``.

Backends.  NCCL takes CUDA tensors for every collective here.  gloo
takes host tensors, so for the gloo backend only, and explicitly, a CUDA
tensor is staged through host memory: copied to the host, reduced or
exchanged there, copied back.  This keeps one code path per collective on
gloo whatever its CUDA support; gloo's own CUDA all-reduce stages
through host memory too.  gloo has no reduce-scatter, so on gloo it is
an all-reduce followed by this rank's block (twice the bytes), and
all-gather is gloo's list all-gather.  NCCL never becomes gloo: the
backend is the process group's, chosen at ``init_parallel_env``.

The job control plane is in submodules, as in the JAX package, whose
``distributed/__init__.py`` exports none of it: ``launch`` (``python -m
paddle_tpu_torch.distributed.launch``), ``coordinator`` (leases,
per-rank budgets, eviction, the sharded checkpoints' commit barrier,
durable state and the warm standby), ``heartbeat`` and ``faults``.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..parallel import create_mesh, current_mesh, mesh_guard  # noqa: F401
from ..parallel.env import (get_rank, get_world_size,  # noqa: F401
                            init_parallel_env)


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


# what this rank's collectives cost since the last reset_stats():
# calls, bytes handed to the backend, and on gloo the host wall time
# inside the collective layer (``ms``, the stream synchronised first, so
# it holds no compute) and the part of it spent copying CUDA tensors to
# the host and back (``stage_ms``); ``by`` splits calls, bytes and ms by
# "collective:axis"; chip_smoke.py reads them a step
stats = {"calls": 0, "bytes": 0, "ms": 0.0, "stage_ms": 0.0, "by": {}}


def reset_stats():
    stats.update(calls=0, bytes=0, ms=0.0, stage_ms=0.0, by={})


class _Axis:
    """One axis of a mesh as a collective sees it."""

    def __init__(self, group, mesh):
        self.name = group or "world"
        if group is None:                        # the whole mesh
            self.pg = mesh.world_group if mesh.groups else None
            self.size = mesh.size
            self.index = mesh.rank
            self.ranks = list(range(mesh.size))
        else:
            self.pg = mesh.group(group)
            self.size = mesh.shape[group]
            self.index = mesh.coords[group]
            self.ranks = mesh.group_ranks.get(group, [mesh.rank])

    @property
    def live(self) -> bool:
        return self.pg is not None


def _axis(group, mesh) -> _Axis:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"collective over {group!r}: no mesh; pass mesh= or run inside "
            f"collective() / an executor step under a mesh")
    if group is not None and group not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {group!r}")
    return _Axis(group, mesh)


def _backend(ax) -> str:
    import torch.distributed as dist

    return dist.get_backend(ax.pg)


class _Clock:
    """Times one gloo collective of a CUDA tensor into ``stats`` (and its
    ``key``'s entry of ``stats["by"]``)."""

    def __init__(self, key: str):
        self.t0 = None
        self.key = key

    def start(self, t, ax):
        if t.is_cuda and _backend(ax) == "gloo":
            torch.cuda.current_stream(t.device).synchronize()
            self.t0 = time.perf_counter()
        return self

    def stage(self, fn):
        """A host copy, timed into stage_ms."""
        if self.t0 is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        stats["stage_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def stop(self):
        if self.t0 is not None:
            ms = (time.perf_counter() - self.t0) * 1e3
            stats["ms"] += ms
            _entry(self.key)["ms"] += ms


def _to_backend(t, ax, clock):
    """(tensor for the backend, staged?): gloo gets host copies."""
    t = t.contiguous()
    if t.is_cuda and _backend(ax) == "gloo":
        return clock.stage(t.cpu), True
    return t, False


def _back(buf, x, staged, clock):
    """The backend's result on ``x``'s device."""
    out = clock.stage(lambda: buf.to(x.device)) if staged else buf
    clock.stop()
    return out


def _entry(key):
    return stats["by"].setdefault(key, {"calls": 0, "bytes": 0, "ms": 0.0})


def _count(t, key):
    n = t.numel() * t.element_size()
    stats["calls"] += 1
    stats["bytes"] += n
    e = _entry(key)
    e["calls"] += 1
    e["bytes"] += n


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN"}


def _raw_all_reduce(x, ax, op=ReduceOp.SUM):
    import torch.distributed as dist

    if not ax.live or x.device.type == "meta":
        return x
    clock = _Clock(f"all_reduce:{ax.name}").start(x, ax)
    buf, staged = _to_backend(x, ax, clock)
    if not staged:            # the backend works in place
        buf = buf.clone()
    _count(buf, clock.key)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _TORCH_OPS[op]),
                    group=ax.pg)
    return _back(buf, x, staged, clock)


def _raw_all_gather(x, ax, dim=0):
    import torch.distributed as dist

    if x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] *= ax.size
        return x.new_empty(shape)
    if not ax.live:
        return x
    clock = _Clock(f"all_gather:{ax.name}").start(x, ax)
    buf, staged = _to_backend(x, ax, clock)
    parts = [torch.empty_like(buf) for _ in range(ax.size)]
    _count(buf, clock.key)
    dist.all_gather(parts, buf, group=ax.pg)
    return _back(torch.cat(parts, dim=dim), x, staged, clock)


def _block(x, ax, dim):
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dim {dim} of size {n} is not divisible by the "
                         f"group size {ax.size}")
    b = n // ax.size
    return x.narrow(dim, ax.index * b, b)


def _raw_reduce_scatter(x, ax, dim=0):
    import torch.distributed as dist

    if x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] //= ax.size
        return x.new_empty(shape)
    if not ax.live:
        return x
    if _backend(ax) == "gloo":
        # gloo has no reduce-scatter: all-reduce, keep this rank's block
        return _block(_raw_all_reduce(x, ax), ax, dim).contiguous()
    blocks = [t.contiguous() for t in x.chunk(ax.size, dim=dim)]
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} is not "
                         f"divisible by the group size {ax.size}")
    out = torch.empty_like(blocks[0])
    _count(x, f"reduce_scatter:{ax.name}")
    dist.reduce_scatter(out, blocks, op=dist.ReduceOp.SUM, group=ax.pg)
    return out


def _raw_ppermute(x, perm, ax):
    """perm: [(src, dst)] over axis indices; a rank no pair sends to gets
    zeros (lax.ppermute)."""
    import torch.distributed as dist

    if x.device.type == "meta":
        return torch.empty_like(x)
    send_to = [d for s, d in perm if s == ax.index]
    recv_from = [s for s, d in perm if d == ax.index]
    if not ax.live:
        return x.clone() if recv_from else torch.zeros_like(x)
    clock = _Clock(f"ppermute:{ax.name}").start(x, ax)
    buf, staged = _to_backend(x, ax, clock)
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, ax.ranks[d], ax.pg)
           for d in send_to]
    ops += [dist.P2POp(dist.irecv, out, ax.ranks[s], ax.pg)
            for s in recv_from]
    if ops:
        _count(buf, clock.key)
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return _back(out, x, staged, clock)


def _raw_broadcast(x, src, ax):
    import torch.distributed as dist

    if not ax.live or x.device.type == "meta":
        return x
    clock = _Clock(f"broadcast:{ax.name}").start(x, ax)
    buf, staged = _to_backend(x, ax, clock)
    if not staged:            # the backend works in place
        buf = buf.clone()
    _count(buf, clock.key)
    dist.broadcast(buf, src=ax.ranks[src], group=ax.pg)
    return _back(buf, x, staged, clock)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


def _fresh(out, x):
    """A Function's output must not be its input object."""
    return out.view_as(out) if out is x else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _fresh(_raw_all_reduce(x, ax), x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _fresh(_raw_all_gather(x, ax, dim), x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.ax.live:
            return g, None, None
        return _block(g, ctx.ax, ctx.dim).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _fresh(_raw_reduce_scatter(x, ax, dim), x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.ax, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, ax):
        ctx.perm, ctx.ax = perm, ax
        return _raw_ppermute(x, perm, ax)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _raw_ppermute(g, inv, ctx.ax), None, None


class _CopyToRegion(torch.autograd.Function):
    """f: forward the identity, backward the sum of the cotangent over
    the axis.  Each rank's region reads the whole input and contributes a
    partial cotangent (its tokens, its columns): the input's gradient is
    their sum, whole on every rank."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.ax), None


class _ReduceFromRegion(torch.autograd.Function):
    """g: forward the sum over the axis, backward the identity.  The sum
    is replicated and every rank computes the same loss from it, so each
    rank's cotangent already is the whole cotangent of the sum, and so
    the whole cotangent of its own partial term (unlike
    ``_AllReduceSum``, whose backward would sum the copies)."""

    @staticmethod
    def forward(ctx, x, ax):
        return _fresh(_raw_all_reduce(x, ax), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BroadcastFromLast(torch.autograd.Function):
    """The last rank's tensor on every rank of the axis; the backward
    hands each rank's own cotangent through once (not summed over the
    axis), since every rank computes the same loss from the copy.  Only
    the last rank's input is connected to what produced it (the pipeline's
    last stage), so only its cotangent reaches a computation."""

    @staticmethod
    def forward(ctx, x, ax):
        return _fresh(_raw_broadcast(x, ax.size - 1, ax), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ShardSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        if not ax.live and ax.size == 1:
            return x.view_as(x)
        return _block(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        if not ctx.ax.live and ctx.ax.size == 1:
            return g, None, None
        return _raw_all_gather(g, ctx.ax, ctx.dim), None, None


# ---------------------------------------------------------------------------
# the functional API (the JAX package's names and defaults)
# ---------------------------------------------------------------------------


def all_reduce(tensor, op: str = ReduceOp.SUM, group: Optional[str] = "dp",
               mesh=None):
    """Reduce across the ``group`` axis (reference
    c_allreduce_{sum,max,min,prod}_op); ``group`` None: the whole mesh."""
    ax = _axis(group, mesh)
    if op == ReduceOp.SUM:
        return _AllReduceSum.apply(tensor, ax)
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        return _raw_all_reduce(tensor.detach(), ax, op)
    if op == ReduceOp.PROD:
        # gather, then multiply in rank order (the JAX package's way:
        # every rank gets the same bits, negatives included)
        parts = _raw_all_gather(tensor.detach().unsqueeze(0), ax, 0)
        return torch.prod(parts, dim=0)
    raise ValueError(f"unknown reduce op {op!r}")


def all_gather(tensor, group: str = "dp", axis: int = 0, mesh=None):
    """Concatenate every participant's tensor along ``axis`` (reference
    c_allgather_op)."""
    return _AllGather.apply(tensor, _axis(group, mesh), axis)


def reduce_scatter(tensor, group: str = "dp", axis: int = 0, mesh=None):
    """Sum across participants, keep this rank's block of ``axis``
    (reference c_reducescatter_op)."""
    return _ReduceScatter.apply(tensor, _axis(group, mesh), axis)


def broadcast(tensor, src: int = 0, group: Optional[str] = "dp",
              mesh=None):
    """Every participant gets rank ``src``'s tensor (reference
    c_broadcast_op); ``src`` is an index on the axis (``group`` None: the
    whole mesh, ``src`` a rank)."""
    return _raw_broadcast(tensor.detach(), src, _axis(group, mesh))


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group: str = "dp",
           mesh=None):
    """Reduce to axis index ``dst``; the other ranks get zeros (reference
    c_reduce_op)."""
    ax = _axis(group, mesh)
    total = all_reduce(tensor.detach(), op, group, mesh)
    return total if ax.index == dst else torch.zeros_like(total)


def scatter(tensor, src: int = 0, group: str = "dp", axis: int = 0,
            mesh=None):
    """Rank ``src``'s tensor is split along ``axis``; axis index i gets
    block i (reference c_scatter_op)."""
    ax = _axis(group, mesh)
    full = broadcast(tensor, src, group, mesh)
    if full.shape[axis] % ax.size != 0:
        raise ValueError(
            f"scatter: dim {axis} of size {full.shape[axis]} is not "
            f"divisible by the group size {ax.size}")
    return _block(full, ax, axis).contiguous()


def send_recv(tensor, perm: Sequence, group: str = "dp", mesh=None):
    """Point-to-point exchange: ``perm`` is [(src, dst), ...] over axis
    indices (lax.ppermute; the reference's send/recv ops)."""
    return _PPermute.apply(tensor, [tuple(p) for p in perm],
                           _axis(group, mesh))


ppermute = send_recv


def copy_to_region(tensor, group: str, mesh=None):
    """Megatron's f over ``group``: the identity whose backward sums the
    cotangent over the axis (the reference's c_identity)."""
    return _CopyToRegion.apply(tensor, _axis(group, mesh))


def sp_identity(tensor, group: str = "sp", mesh=None):
    """``copy_to_region`` over "sp": a weight read whole by every rank's
    tokens."""
    return copy_to_region(tensor, group, mesh)


def reduce_from_region(tensor, group: str, mesh=None):
    """Megatron's g over ``group``: the sum of every rank's partial
    tensor, whose backward is the identity."""
    return _ReduceFromRegion.apply(tensor, _axis(group, mesh))


def broadcast_from_last(tensor, group: str = "pp", mesh=None):
    """The last rank's tensor on every rank of ``group``; the backward
    passes each rank's own cotangent through once."""
    return _BroadcastFromLast.apply(tensor, _axis(group, mesh))


def shard_slice(tensor, group: str = "sp", axis: int = 1, mesh=None):
    """This rank's block of a replicated tensor along ``axis``; the
    backward all-gathers the cotangent."""
    return _ShardSlice.apply(tensor, _axis(group, mesh), axis)


def barrier(group: Optional[str] = "dp", mesh=None):
    """A real barrier over ``group`` (the whole mesh for None); without
    a process group there is nothing to wait for."""
    import torch.distributed as dist

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        if dist.is_available() and dist.is_initialized():
            dist.barrier()
        return None
    ax = _axis(group, mesh)
    if ax.live:
        dist.barrier(group=ax.pg)
    return None


def _spec_dims(spec, ndim):
    dims = list(spec or ())
    return dims + [None] * (ndim - len(dims))


def _slice_in(x, spec, mesh):
    for d, axis in enumerate(_spec_dims(spec, x.dim())):
        for a in ((axis,) if isinstance(axis, str) else (axis or ())):
            x = shard_slice(x, a, d, mesh)
    return x


def _gather_out(y, spec, mesh):
    dims = _spec_dims(spec, y.dim())
    for d in reversed(range(len(dims))):
        axis = dims[d]
        for a in reversed((axis,) if isinstance(axis, str)
                          else (axis or ())):
            y = all_gather(y, a, d, mesh)
    return y


def _is_spec(s) -> bool:
    """A single spec (a PartitionSpec, or a tuple of axis names / None)
    rather than a list or tuple of specs."""
    from ..parallel import PartitionSpec

    if isinstance(s, PartitionSpec):
        return True
    return isinstance(s, tuple) and all(
        a is None or isinstance(a, str) for a in s)


def collective(fn, mesh, in_specs, out_specs, check_vma: bool = False):
    """Run per-rank ``fn`` over global tensors on ``mesh`` (the JAX
    package's shard_map wrapper): each input is sliced to this rank's
    block by its spec (a tuple of axis names / None per dim; () is
    replicated), ``fn`` runs with the mesh bound, and each output is
    all-gathered back by its spec.  Differentiable: a sliced input's
    gradient is all-gathered, a gathered output's cotangent sliced, so
    the gradients are the JAX package's for sharded inputs; a replicated
    input's gradient is this rank's own.  ``check_vma`` is accepted for
    parity."""
    single = _is_spec(out_specs)

    def run(*args):
        ins = [_slice_in(a, s, mesh) for a, s in zip(args, in_specs)]
        with mesh_guard(mesh):
            outs = fn(*ins)
        if single:
            return _gather_out(outs, out_specs, mesh)
        return type(outs)(_gather_out(o, s, mesh)
                          for o, s in zip(outs, out_specs))

    return run


def get_group(axis: str = "dp"):
    """Parity helper: a 'group' is a mesh axis name."""
    return axis


from ..parallel.ring_attention import (ring_attention,  # noqa: E402,F401
                                       ring_attention_global)
