"""Op registry: op type -> torch emitter (+ optional overrides).

Ported from the JAX package's ``ops/registry.py`` (the counterpart of
the reference's operator registry, op_registry.h:223).  Each op
registers ONE ``emit(ctx, ins, attrs) -> {slot: [tensor]}`` function over
torch tensors.  Three services derive from it:

  * execution — the Executor calls the emitters op by op, eagerly, on
    the run's device (``emit_ops``);
  * shape/dtype inference — the same emitter on ``device="meta"``
    tensors (``abstract_eval``; framework.py), where kernel wrappers take
    their plain versions and nothing runs;
  * autodiff — a synthesized ``<op>_grad`` op whose emitter is the
    vector-Jacobian product of the forward emitter, taken by
    ``torch.autograd.grad``; ops with randomness or saved residuals
    register explicit grad ops instead (``dropout_grad`` reads the saved
    Mask).

Primal reuse (the JAX package's ``vjp_cache``): a forward op whose
generic grad op comes later in the same list runs under
``torch.enable_grad()`` on detached, grad-requiring copies of its float
inputs, and its (outputs, inputs) wait in ``EmitContext.vjp_cache`` under
the forward's key; the grad op pulls them back through autograd, so the
forward runs once.  A grad op whose forward was not captured re-runs the
forward (``_make_generic_grad_emit``).

Randomness: ``EmitContext`` holds one 64-bit seed per executor step.
``rng()`` hands each random op a ``torch.Generator`` on the run's device
(Philox on CUDA) seeded with the step seed mixed with the op's position
in the draw order; ``salted_rng(salt)`` mixes a build-time salt instead,
so an op's draw does not depend on how many random ops ran before it —
a forward re-run by the fallback grad op draws the same mask.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

Ins = Dict[str, List[Any]]  # slot -> list of tensors
Attrs = Dict[str, Any]

_MASK64 = (1 << 64) - 1


def mix_seed(seed: int, salt: int) -> int:
    """splitmix64 of ``seed ^ salt``: a well-spread 63-bit seed (torch
    generators take seeds below 2**63)."""
    z = ((int(seed) ^ (int(salt) * 0x9E3779B97F4A7C15)) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class EmitContext:
    """Per-step context handed to emitters: the run's device, its random
    state, the primal-reuse cache, and under a mesh the ``Mesh``
    (``parallel``), ``axis_env`` (ring_id -> axis name, read by the c_*
    ops) and ``manual_axes``."""

    def __init__(self, seed: int = 0, device="cpu", mesh=None,
                 axis_env=None, manual_axes=()):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.mesh = mesh
        self.axis_env = dict(axis_env or {})
        # the executor's manual (dcn, dp) path: each rank a shard of the
        # JAX package's shard_map body, collectives only where an op
        # names one (c_dcn_*)
        self.manual_axes = tuple(manual_axes or ())
        self._draws = 0
        # forward key -> LIFO of (outs, fwd_ins) awaiting their grad op
        self.vjp_cache: Dict[tuple, list] = {}
        # recompute segment key -> the draw counter its first run began
        # at, where its replay begins again (ops/recompute.py)
        self.segment_draws: Dict[int, int] = {}

    def _generator(self, seed: int) -> Optional[torch.Generator]:
        if self.device.type == "meta":
            return None  # shape inference draws nothing
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def rng(self) -> Optional[torch.Generator]:
        """A fresh generator for the next random op of this step."""
        self._draws += 1
        return self._generator(mix_seed(self.seed, self._draws))

    def salted_seed(self, salt: int) -> int:
        """The seed of ``salted_rng(salt)``, a host integer."""
        return mix_seed(self.seed, (1 << 32) + int(salt))

    def salted_rng(self, salt: int) -> Optional[torch.Generator]:
        """The generator of a build-time salt (one per attention op): the
        same for every call within the step, whatever ran before."""
        return self._generator(self.salted_seed(salt))


@dataclasses.dataclass
class OpSpec:
    type: str
    emit: Callable[[EmitContext, Ins, Attrs], Dict[str, List[Any]]]
    # custom grad-op builder: fn(op, out_grads: {slot: [names]}, block)
    #   -> (list_of_op_descs, {fwd_input_name: grad_name})
    grad_maker: Optional[Callable] = None
    # ops that must NOT take the generic vjp grad path (randomness /
    # non-differentiable): they either register grad_maker or are leaves
    no_vjp_grad: bool = False
    # stateless ops whose outputs are never differentiable (compare etc.)
    stop_gradient: bool = False
    # True for lazily synthesized "<base>_grad" specs (generic vjp)
    generic_vjp: bool = False
    # a forward the primal-reuse capture skips (and its grad op): the
    # forward runs without autograd and the grad op re-runs it
    # (recompute_segment: keeping the forward's graph would keep every
    # activation the recompute exists to drop)
    no_capture: bool = False
    # optional fn(in_metas, attrs) -> {slot: [(shape, dtype)]} in place of
    # running the emitter on meta tensors
    infer_shape: Optional[Callable] = None


_REGISTRY: Dict[str, OpSpec] = {}


def register(type: str, *, no_vjp_grad=False, stop_gradient=False,
             no_capture=False, infer_shape=None):
    """Decorator: register ``emit`` for op ``type`` (a grad maker is set
    after, by ``set_grad_maker``)."""

    def deco(emit_fn):
        _REGISTRY[type] = OpSpec(type=type, emit=emit_fn,
                                 no_vjp_grad=no_vjp_grad,
                                 stop_gradient=stop_gradient,
                                 no_capture=no_capture,
                                 infer_shape=infer_shape)
        return emit_fn

    return deco


def set_grad_maker(type: str, grad_maker):
    _REGISTRY[type].grad_maker = grad_maker


def get(type: str) -> Optional[OpSpec]:
    spec = _REGISTRY.get(type)
    if spec is not None:
        return spec
    # lazily synthesize generic vjp-based grad ops: "<base>_grad"
    if type.endswith("_grad"):
        base = _REGISTRY.get(type[: -len("_grad")])
        if base is not None and not base.no_vjp_grad:
            spec = OpSpec(type=type, emit=_make_generic_grad_emit(base),
                          generic_vjp=True, no_capture=base.no_capture)
            _REGISTRY[type] = spec
            return spec
    return None


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# generic vjp grad
# ---------------------------------------------------------------------------

GRAD = "@GRAD"


def _leaf_inputs(ins: Ins) -> Ins:
    """Detached copies of the op's inputs, float ones requiring grad: the
    leaves the op's vjp differentiates with respect to."""
    return {slot: [v.detach().requires_grad_(v.is_floating_point())
                   if isinstance(v, torch.Tensor) else v for v in vals]
            for slot, vals in ins.items()}


def _apply_vjp(ins: Ins, outs, fwd_ins: Ins):
    """Pull the grad op's "<slot>@GRAD" inputs back through the graph from
    ``fwd_ins`` (leaves) to ``outs``; inputs the graph does not reach get
    zeros, as JAX's float0 / None cotangents do."""
    ys, cots = [], []
    for slot, vals in outs.items():
        gs = ins.get(slot + GRAD) or []
        for i, v in enumerate(vals):
            g = gs[i] if i < len(gs) else None
            if g is None or not isinstance(v, torch.Tensor) \
                    or not v.requires_grad:
                continue  # a zero cotangent contributes nothing
            ys.append(v)
            cots.append(g.to(v.dtype))
    leaves = [(slot, i, v) for slot, vals in fwd_ins.items()
              for i, v in enumerate(vals)
              if isinstance(v, torch.Tensor) and v.requires_grad]
    grads = [None] * len(leaves)
    if ys and leaves:
        with torch.enable_grad():
            grads = torch.autograd.grad(ys, [v for _, _, v in leaves],
                                        cots, allow_unused=True)
    got = {(slot, i): g for (slot, i, _), g in zip(leaves, grads)}
    result = {}
    for slot, vals in fwd_ins.items():
        result[slot + GRAD] = [
            got.get((slot, i)) if got.get((slot, i)) is not None
            else torch.zeros_like(v.detach()) for i, v in enumerate(vals)]
    return result


def _make_generic_grad_emit(base: OpSpec):
    """The FALLBACK emitter of ``<base>_grad``, for a grad op whose
    forward was not captured in this step (e.g. ``gradients()`` on a
    block run without its forward): re-run the forward under autograd.

    Grad-op convention (established by backward.append_backward):
      inputs : forward inputs under their original slots, plus available
               output grads under "<out_slot>@GRAD"
      outputs: input grads under "<in_slot>@GRAD"
      attrs  : forward attrs + "__fwd_in_slots__" (list of fwd input slots)
    """

    def grad_emit(ctx: EmitContext, ins: Ins, attrs: Attrs):
        fwd_attrs = {k: v for k, v in attrs.items() if not k.startswith("__")}
        in_slots = list(attrs["__fwd_in_slots__"])
        fwd_ins = _leaf_inputs({s: list(ins[s]) for s in in_slots if s in ins})
        with torch.enable_grad():
            outs = base.emit(ctx, fwd_ins, fwd_attrs)
        return _apply_vjp(ins, outs, fwd_ins)

    return grad_emit


# ---------------------------------------------------------------------------
# block emission
# ---------------------------------------------------------------------------


def _attrs_sig(attrs):
    """Stable signature of forward attrs. The grad desc carries a shallow
    COPY of the forward attrs (backward.py: dict(op.attrs)), so contained
    objects are identical and repr() is consistent between the pair."""
    return tuple(sorted(
        (k, repr(v)) for k, v in attrs.items() if not k.startswith("__")
    ))


def _fwd_key_from_fwd(op):
    # attrs are part of the key: two same-type ops over the same inputs
    # but different attrs (e.g. scale by 2 vs 3) must not share a vjp
    return (op.type, tuple(sorted(
        (s, tuple(ns)) for s, ns in op.inputs.items() if ns
    )), _attrs_sig(op.attrs))


def _fwd_key_from_grad(op):
    slots = op.attrs.get("__fwd_in_slots__", ())
    return (op.type[: -len("_grad")], tuple(sorted(
        (s, tuple(op.inputs.get(s, ()))) for s in slots if op.inputs.get(s)
    )), _attrs_sig(op.attrs))


def has_grad_ops(ops) -> bool:
    """Whether a list of ops holds a backward (any ``*_grad`` op)."""
    return any(op.type.endswith("_grad") for op in ops)


def emit_ops(ctx: EmitContext, ops, env: Dict[str, Any],
             free_after=None) -> Dict[str, Any]:
    """Run a list of framework Operators.  ``env`` maps var name ->
    tensor and is updated in place (op outputs land there).
    ``free_after[i]`` (optional) names the vars to drop from ``env`` once
    op i has run: no later op touches them, so their memory can go.

    The caller runs the list under ``torch.no_grad()`` (or inference
    mode when it holds no grad op); autograd is switched on here only for
    the forward ops whose generic grad op appears later in the list
    (primal reuse, see the module note; a ``no_capture`` op is never
    captured) and inside the grad ops."""
    wanted: Dict[tuple, int] = {}
    for op in ops:
        if op.type.endswith("_grad"):
            spec = get(op.type)
            if spec is not None and spec.generic_vjp \
                    and not spec.no_capture:
                k = _fwd_key_from_grad(op)
                wanted[k] = wanted.get(k, 0) + 1

    for i, op in enumerate(ops):
        spec = get(op.type)
        if spec is None:
            raise KeyError(f"op {op.type!r} has no registered emitter")
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if n not in env:
                    raise RuntimeError(
                        f"op {op.type}: input var {n!r} not produced, fed, "
                        f"nor in scope")
                vals.append(env[n])
            if vals:
                ins[slot] = vals
        outs = None
        if spec.generic_vjp and not spec.no_capture:
            cached = ctx.vjp_cache.get(_fwd_key_from_grad(op))
            if cached:
                f_outs, fwd_ins = cached.pop()
                outs = _apply_vjp(ins, f_outs, fwd_ins)
        elif (not spec.no_vjp_grad and not spec.stop_gradient
              and spec.grad_maker is None and not spec.no_capture
              and wanted.get(_fwd_key_from_fwd(op), 0) > 0):
            key = _fwd_key_from_fwd(op)
            fwd_ins = _leaf_inputs(ins)
            with torch.enable_grad():
                outs = spec.emit(ctx, fwd_ins, op.attrs)
            ctx.vjp_cache.setdefault(key, []).append((outs, fwd_ins))
            wanted[key] -= 1
        if outs is None:
            outs = spec.emit(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                env[n] = v
        for n in (free_after[i] if free_after is not None else ()):
            env.pop(n, None)
    return env


def abstract_eval(op_type: str, in_metas, attrs, dyn_probe: int):
    """Run the emitter on meta tensors.

    in_metas: {slot: [(shape|None, np.dtype)]}; -1 dims replaced by
    dyn_probe.  Returns {slot: [(shape, np.dtype)]}."""
    from ..fluid.dtypes import from_torch_dtype, runtime_dtype, to_torch_dtype

    spec = get(op_type)
    ins = {
        slot: [torch.empty(tuple(dyn_probe if d == -1 else d
                                 for d in (shape or ())),
                           dtype=to_torch_dtype(runtime_dtype(dtype)),
                           device="meta")
               for shape, dtype in metas]
        for slot, metas in in_metas.items()
    }
    with torch.no_grad():
        out = spec.emit(EmitContext(device="meta"), ins, dict(attrs))
    return {
        slot: [(tuple(int(d) for d in v.shape), from_torch_dtype(v.dtype))
               for v in vals]
        for slot, vals in out.items()
    }
