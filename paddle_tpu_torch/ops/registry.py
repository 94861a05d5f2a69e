"""Op registry: op type -> torch emitter (+ optional overrides).

Ported from the JAX package's ``ops/registry.py`` (the counterpart of
the reference's operator registry, op_registry.h:223).  Each op
registers ONE ``emit(ctx, ins, attrs) -> {slot: [tensor]}`` function over
torch tensors.  Two services derive from it:

  * execution — the Executor calls the emitters op by op, eagerly, on
    the run's device (``emit_ops``);
  * shape/dtype inference — the same emitter on ``device="meta"``
    tensors (``abstract_eval``; framework.py), where kernel wrappers take
    their plain versions and nothing runs.

Randomness: ``EmitContext`` holds one 64-bit seed per executor step.
``rng()`` hands each random op a ``torch.Generator`` on the run's device
(Philox on CUDA) seeded with the step seed mixed with the op's position
in the draw order; ``salted_rng(salt)`` mixes a build-time salt instead,
so an op's draw does not depend on how many random ops ran before it.
The generic vjp grad ops and the primal-reuse cache wait for the
training slice.
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
    """Per-step context handed to emitters: the run's device and its
    random state."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.seed = int(seed)
        self._draws = 0

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

    def salted_rng(self, salt: int) -> Optional[torch.Generator]:
        """The generator of a build-time salt (one per attention op): the
        same for every call within the step, whatever ran before."""
        return self._generator(mix_seed(self.seed, (1 << 32) + int(salt)))


@dataclasses.dataclass
class OpSpec:
    type: str
    emit: Callable[[EmitContext, Ins, Attrs], Dict[str, List[Any]]]


_REGISTRY: Dict[str, OpSpec] = {}


def register(type: str):
    """Decorator: register ``emit`` for op ``type``."""

    def deco(emit_fn):
        _REGISTRY[type] = OpSpec(type=type, emit=emit_fn)
        return emit_fn

    return deco


def get(type: str) -> Optional[OpSpec]:
    return _REGISTRY.get(type)


def emit_ops(ctx: EmitContext, ops, env: Dict[str, Any]) -> Dict[str, Any]:
    """Run a list of framework Operators.  ``env`` maps var name ->
    tensor and is updated in place (op outputs land there)."""
    for op in ops:
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
        outs = spec.emit(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                env[n] = v
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
    out = spec.emit(EmitContext(device="meta"), ins, dict(attrs))
    return {
        slot: [(tuple(int(d) for d in v.shape), from_torch_dtype(v.dtype))
               for v in vals]
        for slot, vals in out.items()
    }
