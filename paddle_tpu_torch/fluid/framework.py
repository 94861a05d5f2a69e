"""Static-graph IR: Program / Block / Variable / Operator / Parameter.

Parity surface: python/paddle/fluid/framework.py in the reference
(Program:3857, Block:2395, Operator:1821, Variable:834, Parameter:4970),
ported from the JAX package's ``fluid/framework.py``.

The Program is the source of truth in Python; the Executor interprets a
block op by op through the registered torch emitters.  Output
shape/dtype inference runs each op's emitter on ``device="meta"``
tensors (shapes and dtypes only, no data, no kernel launch) instead of
``jax.eval_shape``; the same two-probe substitution propagates -1
(batch) dims: the op is evaluated with -1 read as 3 and as 5, and every
output dim that differs between the two becomes -1.

Not ported yet: ``device_guard`` stage tags and the op-callstack
diagnostics attr (the pipeline and verifier slices), dygraph mode, and
the mesh a fleet pass attaches.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Dict, List, Optional, Sequence

from . import unique_name
from .dtypes import convert_dtype, dtype_name, is_floating

_dummy_batch_probes = (3, 5)


class Variable:
    """A named tensor slot in a Block (reference framework.py:834)."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        trainable: bool = True,
        **kwargs,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        # op that produces this var (last writer), for pruning
        self.op: Optional["Operator"] = None

    def __repr__(self):
        return (
            f"Variable(name={self.name}, shape={self.shape}, "
            f"dtype={dtype_name(self.dtype)}, persistable={self.persistable}, "
            f"stop_gradient={self.stop_gradient})"
        )

    __str__ = __repr__

    # arithmetic sugar (static graph) — emits ops through layers
    def _binary(self, other, fn_name, reverse=False):
        from . import layers

        fn = getattr(layers, fn_name)
        if not isinstance(other, Variable):
            value = float(other)
            dtype = self.dtype
            if not is_floating(dtype) and not value.is_integer():
                # an int var against a fractional scalar: a same-dtype
                # constant would truncate it (x * 0.5 -> x * 0)
                dtype = "float32"
            other = layers.fill_constant(shape=[1], dtype=dtype, value=value)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)


class Parameter(Variable):
    """Trainable persistable variable. Reference: framework.py:4970."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("stop_gradient", False)
        super().__init__(block, name, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.regularizer = kwargs.get("regularizer", None)
        self.need_clip = kwargs.get("need_clip", True)
        self.is_distributed = kwargs.get("is_distributed", False)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})


class Operator:
    """One op in a block: type + named input/output var lists + attrs
    (reference framework.py:1821).  Inputs/outputs map slot name -> list
    of variable names."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, List[str]]] = None,
        outputs: Optional[Dict[str, List[str]]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return (f"Op(type={self.type}, inputs={self.inputs}, "
                f"outputs={self.outputs})")


class Block:
    """Ordered op list + var map. Reference: framework.py:2395."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- variables ----------------------------------------------------------
    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        # parameters live in the global (root) block, like the reference
        global_block = self.program.global_block()
        p = Parameter(global_block, name, shape, dtype, **kwargs)
        global_block.vars[name] = p
        self.program._bump_version()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    # -- ops ----------------------------------------------------------------
    def append_op(
        self,
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
        infer: bool = True,
    ) -> Operator:
        op = Operator(self, type, inputs=_normalize_io(inputs),
                      outputs=_normalize_io(outputs), attrs=attrs)
        self.ops.append(op)
        self._post_insert(op, infer)
        return op

    def _post_insert(self, op: Operator, infer: bool):
        # ensure output vars exist; infer their shapes/dtypes from the emitter
        for names in op.outputs.values():
            for n in names:
                if self._find_var_recursive(n) is None:
                    self.create_var(name=n)
        if infer:
            try:
                infer_op_outputs(self, op)
            except Exception as e:  # noqa: BLE001 — surface op context
                raise RuntimeError(
                    f"shape inference failed for op {op.type}: {e}"
                ) from e
        for n in op.output_names():
            self._find_var_recursive(n).op = op
        self.program._bump_version()

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, parent={self.parent_idx}) {{"]
        lines += [f"  {v}" for v in self.vars.values()]
        lines += [f"  {op}" for op in self.ops]
        lines.append("}")
        return "\n".join(lines)


_program_serial_counter = itertools.count()


class Program:
    """A list of blocks; block 0 is global. Reference: framework.py:3857."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # monotonic identity for the executor's plan cache: id() can be
        # reused by CPython after a Program is collected
        self._serial = next(_program_serial_counter)

    def _bump_version(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program. for_test=True marks test mode: every op
        holding an ``is_test`` attr (dropout, fused attention) gets
        ``is_test=True``."""
        p = Program.__new__(Program)
        p.blocks = [Block(p, b.idx, b.parent_idx) for b in self.blocks]
        p.current_block_idx = 0
        p.random_seed = self.random_seed
        p._version = 0
        p._serial = next(_program_serial_counter)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                cls = Parameter if isinstance(v, Parameter) else Variable
                nv = cls.__new__(cls)
                nv.__dict__.update({k: w for k, w in v.__dict__.items()
                                    if k not in ("block", "op")})
                nv.block = nb
                nv.op = None
                nb.vars[name] = nv
            for op in b.ops:
                attrs = {k: (v if not isinstance(v, Block) else p.blocks[v.idx])
                         for k, v in op.attrs.items()}
                nop = Operator(nb, op.type, inputs=copy.deepcopy(op.inputs),
                               outputs=copy.deepcopy(op.outputs), attrs=attrs)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
                for n in nop.output_names():
                    fv = nb._find_var_recursive(n)
                    if fv is not None:
                        fv.op = nop
        p._bump_version()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# ---------------------------------------------------------------------------
# shape/dtype inference by evaluating the op emitter on meta tensors
# ---------------------------------------------------------------------------


def compute_op_output_metas(block: Block, op: Operator):
    """Pure output-meta inference: {slot: [(shape, dtype)]} from the
    registered emitter run on meta tensors (two probes for -1 dims).
    Never mutates the program."""
    from ..ops import registry

    spec = registry.get(op.type)
    if spec is None:
        raise KeyError(f"op {op.type!r} is not registered")
    in_metas = {
        slot: [_var_meta(block, n) for n in names]
        for slot, names in op.inputs.items()
    }
    has_dynamic = any(
        (m[0] is not None and -1 in m[0]) for ms in in_metas.values() for m in ms
    )
    probes = _dummy_batch_probes if has_dynamic else (_dummy_batch_probes[0],)
    results = [registry.abstract_eval(op.type, in_metas, op.attrs, probe)
               for probe in probes]
    out0 = results[0]
    metas = {}
    for slot in out0:
        metas[slot] = []
        for i, (shape0, dt) in enumerate(out0[slot]):
            if len(results) > 1:
                shape1 = results[1][slot][i][0]
                shape = tuple(-1 if a != b else a for a, b in zip(shape0, shape1))
            else:
                shape = shape0
            metas[slot].append((shape, dt))
    return metas


def infer_op_outputs(block: Block, op: Operator):
    """Set shapes/dtypes of op's output vars from its emitter."""
    metas = compute_op_output_metas(block, op)
    for slot, names in op.outputs.items():
        ms = metas.get(slot)
        if ms is None:
            continue
        for n, (shape, dt) in zip(names, ms):
            v = block._find_var_recursive(n)
            v.shape = tuple(shape)
            v.dtype = convert_dtype(dt)


def _var_meta(block, name):
    v = block.var(name)
    return (v.shape, v.dtype)


def _normalize_io(io: Optional[Dict[str, Any]]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for slot, val in (io or {}).items():
        if val is None:
            continue
        if isinstance(val, (Variable, str)):
            val = [val]
        out[slot] = [v.name if isinstance(v, Variable) else str(v) for v in val]
    return out


# ---------------------------------------------------------------------------
# default programs & guards (reference: framework.py program_guard etc.)
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)

