"""Static live-range analysis over the Program IR.

Answers "where would the MEMORY go" before a step allocates a byte:
for every Variable in block 0, the first op that defines it and the
last op that reads it, its byte size, and its category — so the peak
simultaneous-bytes estimate, the per-category breakdown and the "which
buffer is fattest at the high-water point" ranking are all pure
functions of the program.  Ported from the JAX package's pass, whose
execution model (a compiled step) it keeps, so both packages give the
same bytes for the same program; the port's own step is measured by
``Executor.memory_analysis``.  Byte sizes come from the IR dtype
(``fluid/dtypes.py``: bfloat16 is 2 bytes).

Execution model this mirrors (the JAX package's executor._compile):

  - feeds and state (persistables / scope vars) are live at step ENTRY;
  - state that is read AND written (donate_names) is DONATED — the
    compiled step aliases the input buffer to the output, so one name is
    ONE buffer for the whole step (the default; donation=False models
    the diagnostic no-donate modes, where the updating op briefly holds
    both the old and the new buffer);
  - a non-persistable intermediate is live from its producing op to its
    last consuming op (fetch targets stay live to the end);
  - sub-block internals (cond/while bodies) are bounded by their owner
    op's execution — they are charged to the owner op as workspace and
    not tracked per-name here.

Categories (documented contract, memtop/--memz render them):

  params            framework.Parameter instances
  optimizer_state   persistable non-Parameter state (optimizer moments,
                    LR / beta-pow accumulators, BN running stats, guard
                    vars — everything the step carries forward that is
                    not a trainable weight)
  gradients         names containing @GRAD (incl. backward's
                    @GRAD@RENAME@<n> accumulation partials)
  feeds             data vars / fed names (the batch)
  activations       everything else — forward intermediates kept alive
                    for the backward pass; the remat lever

What the static estimate cannot see: workspace an op allocates inside
itself (kernel scratch, autograd's saved tensors) has no IR name, and an
allocator may reuse dead buffers — so the static peak is an ESTIMATE,
not an allocator prediction.

Stdlib + numpy only; never mutates the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import framework
from ..dtypes import convert_dtype, dtype_name
from .core import user_frame

PARAMS = "params"
OPTIMIZER_STATE = "optimizer_state"
GRADIENTS = "gradients"
FEEDS = "feeds"
ACTIVATIONS = "activations"

CATEGORIES = (PARAMS, OPTIMIZER_STATE, GRADIENTS, FEEDS, ACTIVATIONS)


@dataclasses.dataclass
class BufferInfo:
    """One Variable's static buffer: size, range, identity."""

    name: str
    bytes: int
    shape: Optional[tuple]
    dtype: str
    category: str
    first_def: int              # producing op index; -1 = live at entry
    last_use: int               # last consuming op index; n_ops = live-out
    op_index: Optional[int]     # owning op (producer, else first consumer)
    op_type: Optional[str]
    layer: Optional[str]        # "file:line in fn" user layer call
    callstack: Optional[tuple] = None
    donated: bool = False
    persistable: bool = False
    batch_scaled: bool = False  # leading dim is the batch (what-if lever)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("callstack", None)
        d["shape"] = list(self.shape) if self.shape is not None else None
        return d


@dataclasses.dataclass
class LiveRangeAnalysis:
    """The pass result: per-buffer ranges + the sweep's peak."""

    buffers: List[BufferInfo]
    n_ops: int
    peak_bytes: int                  # max simultaneous live bytes
    peak_op_index: int               # op index where the sweep peaked
    peak_op_type: Optional[str]
    peak_layer: Optional[str]
    live_at_peak: List[str]          # names live at the peak op
    categories: Dict[str, int]       # category -> total bytes
    categories_at_peak: Dict[str, int]
    resident_bytes: int              # entry-live state + feeds
    model_bytes: int                 # params + optimizer_state
    live_bytes_at: List[int]         # per-op live bytes (the sweep curve)
    unsized: List[str]               # vars whose bytes could not be sized
    batch_hint: Optional[int] = None

    def by_name(self) -> Dict[str, BufferInfo]:
        return {b.name: b for b in self.buffers}

    def top(self, k: int = 20, live_at_peak_only: bool = False
            ) -> List[BufferInfo]:
        rows = self.buffers
        if live_at_peak_only:
            live = set(self.live_at_peak)
            rows = [b for b in rows if b.name in live]
        return sorted(rows, key=lambda b: -b.bytes)[:k]


def _dtype_itemsize(dtype) -> int:
    try:
        return int(convert_dtype(dtype).itemsize)
    except TypeError:
        return 4  # unknown recorded dtype: assume fp32


def _sized_shape(shape, batch_hint: Optional[int]) -> Optional[tuple]:
    """Concrete shape with -1 dims substituted by the batch hint; None
    when unresolvable."""
    if shape is None:
        return None
    out = []
    for d in shape:
        d = int(d)
        if d < 0:
            if not batch_hint:
                return None
            d = int(batch_hint)
        out.append(d)
    return tuple(out)


def _attr_strings(op) -> List[str]:
    """Names referenced through attrs (sub-block out/carry name lists) —
    consumers the input slots cannot show (mirrors dataflow.py)."""
    out: List[str] = []
    for k, v in op.attrs.items():
        if k.startswith("__"):
            continue
        if isinstance(v, str):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, str))
    return out


def analyze_live_ranges(
    program,
    feed_names: Iterable[str] = (),
    fetch_names: Iterable[str] = (),
    batch_hint: Optional[int] = None,
    shapes: Optional[Dict[str, Sequence[int]]] = None,
    donation: bool = True,
) -> LiveRangeAnalysis:
    """Run the pass over block 0. `shapes` overrides recorded var shapes
    with concrete ones (memtop passes the feed arrays' shapes so -1
    batch dims resolve exactly); remaining -1 dims use `batch_hint`.
    Read-only: the program version must not move (asserted)."""
    if hasattr(program, "_program"):  # CompiledProgram wrapper
        program = program._program
    version = program._version
    block = program.global_block()
    ops = list(block.ops)
    n_ops = len(ops)
    feed_names = set(feed_names)
    fetch_names = set(fetch_names)
    shapes = dict(shapes or {})
    if batch_hint is None:
        # infer from an overriding feed shape vs its recorded -1 dim
        for n, s in shapes.items():
            v = block._find_var_recursive(n)
            if (v is not None and v.shape and s
                    and len(s) == len(v.shape)):
                for rec, got in zip(v.shape, s):
                    if int(rec) == -1:
                        batch_hint = int(got)
                        break
            if batch_hint is not None:
                break

    # -- def/use walk (block 0; mirrors executor._compile's view) -------
    first_def: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    written: set = set(feed_names)
    state_in: List[str] = []
    for i, op in enumerate(ops):
        for n in op.input_names() + _attr_strings(op):
            if block._find_var_recursive(n) is None:
                continue
            last_use[n] = i
            if n not in written and n not in state_in:
                state_in.append(n)
        for n in op.output_names():
            written.add(n)
            first_def.setdefault(n, i)

    persistable = {v.name for v in program.list_vars() if v.persistable}
    state_out = [n for n in dict.fromkeys(
        n for op in ops for n in op.output_names()) if n in persistable]
    donate = set(state_in) & set(state_out) if donation else set()

    names = sorted(set(first_def) | set(last_use) | feed_names
                   | (set(state_in)))
    buffers: List[BufferInfo] = []
    unsized: List[str] = []
    for name in names:
        v = block._find_var_recursive(name)
        if v is None:
            continue
        shape = _sized_shape(shapes.get(name, v.shape), batch_hint)
        if shape is None:
            unsized.append(name)
            nbytes = 0
        else:
            nbytes = int(np.prod(shape, dtype=np.int64)
                         * _dtype_itemsize(v.dtype)) if shape else \
                _dtype_itemsize(v.dtype)
        is_param = isinstance(v, framework.Parameter)
        is_feed = v.is_data or name in feed_names
        if is_param:
            cat = PARAMS
        elif framework.GRAD_VAR_SUFFIX in name:
            # includes backward's @GRAD@RENAME@<n> accumulation partials
            cat = GRADIENTS
        elif v.persistable:
            cat = OPTIMIZER_STATE
        elif is_feed:
            cat = FEEDS
        else:
            cat = ACTIVATIONS

        # entry-live: feeds and state the step reads (or persistable
        # state at all — it occupies memory whether or not this program
        # touches it first); live-out: persistable state survives the
        # step, fetch targets are materialized for the host
        fd = first_def.get(name, -1)
        if is_feed or name in state_in or v.persistable:
            fd = -1
        lu = last_use.get(name, fd)
        if v.persistable or name in fetch_names:
            lu = n_ops
        lu = max(lu, fd)

        owner_idx: Optional[int] = first_def.get(name)
        if owner_idx is None:
            lo = last_use.get(name)
            owner_idx = lo if lo is not None else None
        op = ops[owner_idx] if owner_idx is not None else None
        cs = op.attrs.get(framework.OP_CALLSTACK_ATTR) if op is not None \
            else None
        uf = user_frame(cs) if cs else None
        buffers.append(BufferInfo(
            name=name, bytes=nbytes, shape=shape,
            dtype=dtype_name(v.dtype) if v.dtype is not None else "?",
            category=cat, first_def=fd, last_use=lu,
            op_index=owner_idx,
            op_type=op.type if op is not None else None,
            layer=f"{uf[0]}:{uf[1]} in {uf[2]}" if uf else None,
            callstack=cs, donated=name in donate,
            persistable=bool(v.persistable),
            batch_scaled=bool(shape and batch_hint
                              and shape[0] == batch_hint),
        ))

    # -- sweep: peak simultaneous bytes ---------------------------------
    # A donated name is ONE buffer across its whole range (input aliases
    # output). Without donation, the writing op holds old + new at once:
    # model that as double bytes at the writer's op index.
    by_name = {b.name: b for b in buffers}
    defs_at: Dict[int, List[BufferInfo]] = {}
    frees_at: Dict[int, List[BufferInfo]] = {}
    entry_bytes = 0
    for b in buffers:
        if b.first_def < 0:
            entry_bytes += b.bytes
        else:
            defs_at.setdefault(b.first_def, []).append(b)
        if b.last_use < n_ops:
            frees_at.setdefault(b.last_use, []).append(b)

    undonated_extra: Dict[int, int] = {}
    if not donation:
        for n in set(state_in) & set(state_out):
            b = by_name.get(n)
            if b is not None:
                w = first_def.get(n)
                if w is not None:
                    undonated_extra[w] = undonated_extra.get(w, 0) + b.bytes

    cur = entry_bytes
    live: set = {b.name for b in buffers if b.first_def < 0}
    peak, peak_idx = cur, -1
    live_at_peak = set(live)
    curve: List[int] = []
    for i in range(n_ops):
        for b in defs_at.get(i, ()):  # outputs materialize during op i
            cur += b.bytes
            live.add(b.name)
        at_op = cur + undonated_extra.get(i, 0)
        curve.append(at_op)
        if at_op > peak:
            peak, peak_idx, live_at_peak = at_op, i, set(live)
        for b in frees_at.get(i, ()):  # last use done -> buffer freed
            cur -= b.bytes
            live.discard(b.name)

    cats = {c: 0 for c in CATEGORIES}
    cats_peak = {c: 0 for c in CATEGORIES}
    for b in buffers:
        cats[b.category] += b.bytes
        if b.name in live_at_peak:
            cats_peak[b.category] += b.bytes
    peak_op = ops[peak_idx] if 0 <= peak_idx < n_ops else None
    peak_uf = user_frame(peak_op.attrs.get(framework.OP_CALLSTACK_ATTR)
                         ) if peak_op is not None else None

    assert program._version == version, (
        "live-range analysis mutated the program "
        f"({version} -> {program._version})")
    return LiveRangeAnalysis(
        buffers=buffers, n_ops=n_ops, peak_bytes=int(peak),
        peak_op_index=peak_idx,
        peak_op_type=peak_op.type if peak_op is not None else None,
        peak_layer=(f"{peak_uf[0]}:{peak_uf[1]} in {peak_uf[2]}"
                    if peak_uf else None),
        live_at_peak=sorted(live_at_peak,
                            key=lambda n: -by_name[n].bytes),
        categories=cats, categories_at_peak=cats_peak,
        resident_bytes=int(entry_bytes),
        model_bytes=int(cats[PARAMS] + cats[OPTIMIZER_STATE]),
        live_bytes_at=curve, unsized=unsized, batch_hint=batch_hint,
    )
