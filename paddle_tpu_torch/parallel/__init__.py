"""Device meshes and sharding annotations, one process per rank.

Ported from the JAX package's ``parallel/__init__.py``.  There a mesh is
a ``jax.sharding.Mesh`` held by one controller, annotations are
PartitionSpecs, and GSPMD shards the global arrays.  The port runs one
process per rank over ``torch.distributed``: its ``Mesh`` is the named
axes and their sizes, this rank's coordinates on them, and one process
group per axis, over the ranks that differ only on that axis.  Ranks are
laid out row-major over the axes in their order ({"dp": 2, "sp": 2}:
rank = dp * 2 + sp).  A ``ring_id`` of the c_* ops is an axis's position
in that order (``Mesh.axis_env``).

A mesh in a process where ``torch.distributed`` is not initialised must
have size 1; it holds no process group and every collective over it is
the identity, so single-process paths are unchanged.  Once the process
group is up, every axis has a group, size-1 axes included, and the
collectives run on its backend.  A mesh whose size differs from the world
size raises (the JAX package takes a prefix of the devices; ROADMAP §C).

Axes convention: "dp" (data), "tp" (tensor), "pp" (pipeline), "sp"
(sequence), "ep" (expert), "dcn" (the slices of a multi-slice job).

Persistable state sharded on a mesh axis (``PARAM_AXES``): parameters on
"tp", "pp" or "ep", ZeRO's optimizer moments on "dp", the multi-slice
modes' per-slice state ([n_dcn, ...] on "dcn").  Where GSPMD holds one
global array and places its shards, a rank of the port holds only its
block of such a variable: the block its coordinates on the axes of the
variable's spec name (``local_shard``; ``set_var_sharding`` /
``get_var_sharding`` carry the spec).  The startup program runs at the
global shapes on every rank, and the executor keeps each rank's block;
a fetch, a checkpoint, gathers it back to the global layout
(``gather_shard``).  A dim the axis does not divide raises ValueError,
where the JAX package pads (BERT-base's vocabulary, 30522, at tp 4;
ROADMAP §C).  The specs of feed variables name the data axes too; the
executor slices a feed by them (``_local_block``), and only persistable
variables are held as blocks.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, Optional, Sequence

from . import env  # noqa: F401
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401


# mesh axes whose sharding the ops realise inside their own regions
# (ops/encoder_stack.py, ops/attention.py, ops/moe_ops.py): outside them
# every rank of such an axis holds the whole tensor, so feeds are not
# sliced on them
REGION_AXES = ("sp", "tp", "pp", "ep")
# mesh axes that shard persistable state: a rank holds its block of it
PARAM_AXES = ("tp", "pp", "ep", "dp", "dcn")
# the axes on which an op reads a parameter block inside the step (the
# others' blocks are whole there: ZeRO's moments meet their rows of the
# parameter, a slice's state is its own)
SPLIT_AXES = ("tp", "pp", "ep")


class Mesh:
    """Named axes over the ranks of this job, seen from one rank."""

    def __init__(self, axes: Dict[str, int], rank: int = 0, groups=None,
                 group_ranks=None, world_group=None):
        self.axis_names = tuple(axes)
        self.shape = {n: int(axes[n]) for n in self.axis_names}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.coords = {}
        r = self.rank
        for n in reversed(self.axis_names):
            self.coords[n] = r % self.shape[n]
            r //= self.shape[n]
        self.coords = {n: self.coords[n] for n in self.axis_names}
        self.groups = dict(groups or {})
        self.group_ranks = dict(group_ranks or {})
        self.world_group = world_group

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def group(self, axis: str):
        """The process group of ``axis`` (None: no process group, the
        collectives are the identity)."""
        return self.groups.get(axis)

    def ring_id(self, axis: str) -> int:
        return self.axis_names.index(axis)

    @property
    def axis_env(self) -> Dict[int, str]:
        """ring_id -> axis name, as the c_* ops' EmitContext reads it."""
        return dict(enumerate(self.axis_names))

    @property
    def data_axes(self):
        """The axes that shard the batch (every axis but REGION_AXES)."""
        return [a for a in self.axis_names if a not in REGION_AXES]

    @property
    def data_shards(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` (row-major), e.g. its data shard."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def _axis_rank_lists(names, sizes):
    """For each axis, the rank lists of its groups: ranks that differ
    only on that axis, in a fixed order every rank computes alike."""
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    out = {}
    for i, n in enumerate(names):
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        lists = []
        for rest in itertools.product(*others):
            base = 0
            k = 0
            for j in range(len(sizes)):
                if j == i:
                    continue
                base += rest[k] * strides[j]
                k += 1
            lists.append([base + c * strides[i] for c in range(sizes[i])])
        out[n] = lists
    return out


def create_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A Mesh over this job's ranks with named axes (ordered
    {axis: size}; one size may be -1: the world size over the others).
    The product must equal the world size.  Every rank must call this
    with the same axes, in the same order (it creates process groups)."""
    import torch.distributed as dist

    if devices is not None:
        raise ValueError("create_mesh: the port's mesh spans the ranks of "
                         "the process group; it takes no device list")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else get_world_size()
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} has {total} ranks, the world "
            f"has {world}: the port's mesh covers exactly the world")
    if not initialized:
        if total != 1:
            raise RuntimeError(
                f"mesh {dict(zip(names, sizes))} needs torch.distributed: "
                f"call init_parallel_env() (or fleet.init()) first")
        return Mesh(dict(zip(names, sizes)), 0)
    rank = dist.get_rank()
    groups, group_ranks = {}, {}
    for n, lists in _axis_rank_lists(names, sizes).items():
        for ranks in lists:
            g = dist.new_group(ranks)     # every rank creates every group
            if rank in ranks:
                groups[n], group_ranks[n] = g, ranks
    return Mesh(dict(zip(names, sizes)), rank, groups, group_ranks,
                world_group=dist.group.WORLD)


_bound = []


@contextlib.contextmanager
def mesh_guard(mesh: Optional[Mesh]):
    """Bind ``mesh`` for the collectives called without one (the port's
    analog of the axis names a shard_map body sees)."""
    _bound.append(mesh)
    try:
        yield mesh
    finally:
        _bound.pop()


def current_mesh() -> Optional[Mesh]:
    return _bound[-1] if _bound else None


class PartitionSpec(tuple):
    """A spec: one mesh axis name (or a tuple of names, or None) a dim
    (``jax.sharding.PartitionSpec``'s shape, a tuple)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def partition_spec(*axes):
    return PartitionSpec(*axes)


def set_var_sharding(var, spec: Optional[Sequence[Optional[str]]]):
    """Annotate a program Variable with a spec (mesh axis name / None per
    dim).  The executor slices a fed variable's batch block by it, and a
    rank holds its block of a persistable sharded on "tp" or "pp"
    (``local_shard``); unannotated vars are replicated."""
    var._sharding = None if spec is None else PartitionSpec(*spec)
    var.block.program._bump_version()  # invalidate the executor's plans


def get_var_sharding(var):
    return getattr(var, "_sharding", None)


def param_axes(spec):
    """[(dim, axis)] of the state-sharding axes ``spec`` names."""
    out = []
    for d, axis in enumerate(spec or ()):
        for a in ((axis,) if isinstance(axis, str) else (axis or ())):
            if a in PARAM_AXES:
                out.append((d, a))
    return out


def local_shard(value, spec, mesh):
    """This rank's block of the global ``value`` (a tensor or an array)
    along each dim that ``spec`` shards on a state axis of ``mesh``
    (``PARAM_AXES``); ValueError where the axis does not divide the dim.
    The executor (after a startup program), the checkpoint restore and
    the tests share it."""
    for d, a in param_axes(spec):
        n = mesh.shape.get(a, 1)
        if n <= 1:
            continue
        size = value.shape[d]
        if size % n:
            raise ValueError(
                f"dim {d} of size {size} is not divisible by mesh axis "
                f"{a!r} of size {n}: the port shards a parameter into "
                f"equal blocks and pads nothing")
        blk, i = size // n, mesh.coords[a]
        value = value[(slice(None),) * d + (slice(i * blk, (i + 1) * blk),)]
    return value


def gather_shard(x, spec, mesh):
    """The global value of a tensor this rank holds its ``local_shard``
    of: all-gathered over each parameter axis of ``spec`` (a collective:
    every rank of those axes calls it)."""
    from .. import distributed as dist

    for d, a in reversed(param_axes(spec)):
        if mesh.shape.get(a, 1) > 1:
            x = dist.all_gather(x, a, d, mesh)
    return x


def check_shardable(var, spec, mesh):
    """ValueError unless every parameter axis of ``spec`` divides its dim
    of ``var``'s (global) shape."""
    for d, a in param_axes(spec):
        n = mesh.shape.get(a, 1)
        if d >= len(var.shape) or (n > 1 and int(var.shape[d]) % n):
            raise ValueError(
                f"{var.name}: dim {d} of shape {list(var.shape)} is not "
                f"divisible by mesh axis {a!r} of size {n}; the port "
                f"shards a parameter into equal blocks and pads nothing "
                f"(the JAX package pads)")


def tp_mesh(ctx, attrs):
    """The mesh of an op's tensor-parallel region (its ``tp_region`` attr,
    set by ``fleet.apply_tensor_parallel_rules``) when the mesh's "tp"
    axis has more than one rank; else None (the op runs whole)."""
    mesh = ctx.mesh
    if (not attrs.get("tp_region") or mesh is None
            or mesh.shape.get("tp", 1) <= 1):
        return None
    return mesh


def set_flat_index(var, batch_size: int, row_len: int):
    """Declare that a fed int variable holds flat indices into a
    [batch_size * row_len] batch-major tensor (BERT's mask_positions):
    when the executor keeps shard i of the batch, it subtracts
    i * (batch_size / shards) * row_len, so the indices address this
    rank's rows as the global ones addressed the global batch."""
    var._flat_index = (int(batch_size), int(row_len))


# op types whose static ``shape`` attr shapes their input X (a grad op
# replays its forward with a copy of the forward's attrs)
_RESHAPES = ("reshape", "reshape2", "reshape_grad", "reshape2_grad")
_UNKNOWN = -1        # batch-carrying, its batch dim not known


def _out_batch_dim(block, op, dims, out):
    """The batch dim of ``out``, an output var of ``op`` (``dims``: var
    name -> batch dim or _UNKNOWN; absent = holds no batch).  A reshape
    keeps its input's (dim 0 once localized), a transpose moves it, any
    other op gives the batch dim of an input whose static size there the
    output shares.  None: no input carries a batch."""
    carried = [(block._find_var_recursive(n), dims[n])
               for names in op.inputs.values() for n in names if n in dims]
    if not carried:
        return None
    if op.type in _RESHAPES:
        return dims.get(op.inputs["X"][0])
    if op.type in ("transpose", "transpose2"):
        d = dims.get(op.inputs["X"][0], _UNKNOWN)
        return _UNKNOWN if d == _UNKNOWN else list(op.attr("axis")).index(d)
    for v, d in carried:
        if (d != _UNKNOWN and v is not None
                and d < min(len(v.shape), len(out.shape))
                and v.shape[d] == out.shape[d]):
            return d
    return _UNKNOWN


def _localize_reshape(op, d, shards: int):
    """``op``'s static target shape as a rank holds it, its input's batch
    dim being ``d`` (None: the input holds no batch)."""
    x = op.inputs["X"][0]
    shape = [int(s) for s in op.attr("shape")]
    if d is None or not shape or shape[0] <= 0:
        return                       # no batch, or dim 0 from the input
    if d != 0:
        raise NotImplementedError(
            f"{op.type} of {x!r} to {shape}: its batch dim is "
            f"{'not known' if d == _UNKNOWN else d}, not 0; the "
            f"data-parallel plan places a static reshape only of a tensor "
            f"whose dim 0 is the batch")
    if shape[0] % shards:
        raise ValueError(f"{op.type} of {x!r} to {shape}: dim 0 does not "
                         f"divide over {shards} data shards")
    op._set_attr("shape", [shape[0] // shards] + shape[1:])


def _localize_reshapes(program, axis: str, shards: int):
    """Rewrite each static reshape of a batch-carrying tensor to this
    rank's batch block, once, when the mesh is attached.  The program is
    built at the global batch; a rank holds 1/shards of it along dim 0 of
    every fed variable sharded on ``axis``.  Batch-major data keeps its
    batch as the outermost factor of its row-major layout, so a reshape of
    a tensor whose dim 0 is the batch holds this rank's block exactly when
    the target's dim 0 is divided by ``shards``.  A static reshape of a
    tensor whose batch dim is not dim 0, or not known, raises: the plan
    cannot place it."""
    block = program.global_block()
    dims = {v.name: 0 for v in block.vars.values()
            if (get_var_sharding(v) or (None,))[0] == axis}
    for op in block.ops:
        if op.type in _RESHAPES:
            _localize_reshape(op, dims.get(op.inputs["X"][0]), shards)
        for names in op.outputs.values():
            for n in names:
                v = block._find_var_recursive(n)
                if v is None or v.persistable or not v.shape or all(
                        int(s) == 1 for s in v.shape):
                    continue          # state, or a scalar
                d = _out_batch_dim(block, op, dims, v)
                if d is not None:
                    dims[n] = d


def shard_program_data_parallel(program, mesh, axis="dp"):
    """Mark every data (feed) variable as batch-sharded along ``axis``
    (an axis name, or a tuple of them: the multi-slice (dcn, dp)) (the
    JAX package's annotation, the reference's GradAllReduce transpile,
    the reference's python/paddle/fluid/transpiler/collective.py:178, in
    spirit: fleet inserts the gradient all-reduce the JAX package leaves
    to GSPMD)."""
    for v in program.list_vars():
        if getattr(v, "is_data", False) and v.shape:
            set_var_sharding(v, (axis,) + (None,) * (len(v.shape) - 1))
    shards = math.prod(mesh.shape[a] for a in (
        (axis,) if isinstance(axis, str) else axis))
    if shards > 1 and getattr(program, "_mesh", None) is None:
        _localize_reshapes(program, axis, shards)
    program._mesh = mesh


def shard_program_sequence_parallel(program, mesh, axis: str = "sp"):
    """Additionally mark the sequence dim (dim 1) of feed variables as
    sharded over ``axis`` where it divides (the JAX package's
    annotation).  In the port the ranks of ``axis`` are fed the whole
    sequence: the sequence-parallel ops slice it on entry to their region
    and gather it on exit (``ops/encoder_stack.py``, ``ops/attention.py``)."""
    sp_size = mesh.shape[axis]
    for v in program.list_vars():
        if not (getattr(v, "is_data", False) and v.shape
                and len(v.shape) >= 2):
            continue
        s = v.shape[1]
        if s is None or s <= 1 or (s > 0 and s % sp_size != 0):
            continue
        cur = get_var_sharding(v)
        dims = list(cur) if cur is not None else []
        dims += [None] * (len(v.shape) - len(dims))
        dims[1] = axis
        set_var_sharding(v, dims)
