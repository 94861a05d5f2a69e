"""Program-level reverse-mode autodiff: append_backward / calc_gradient.

Parity surface: python/paddle/fluid/backward.py (append_backward:1215,
_append_backward_ops_:862, grad accumulation via sum-op insertion:372);
ported from the JAX package's ``fluid/backward.py`` with the same op
descs, grad-var names (``<var>@GRAD``, ``@RENAME@<i>`` partials summed by
``sum`` ops, ``@ZERO`` fills by ``fill_zeros_like``, ``@UNUSED``
placeholders) and grad-var metadata.

Grad ops follow the reference's desc convention (inputs = forward inputs
+ output grads, outputs = input grads named ``<var>@GRAD``); the default
grad op ``<type>_grad`` is synthesized from the forward emitter through
``torch.autograd`` (ops/registry.py).  Ops with randomness or saved
residuals (dropout) register explicit grad makers.

Under FLAGS_program_verify the builder runs pass-sandwiched
(``fluid/analysis``), as in the JAX package: the program is verified
before and after, and an error finding the pass introduced raises a
ProgramVerifyError attributed to ``append_backward``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import framework
from .dtypes import is_floating
from ..ops import registry

GRAD = framework.GRAD_VAR_SUFFIX


def _needs_grad_set(block, upto: int, parameter_list, no_grad_set) -> Set[str]:
    """Forward-propagate 'requires grad' from trainable parameters."""
    no_grad = set(no_grad_set or ())
    needs: Set[str] = set()
    for v in block.program.global_block().vars.values():
        if isinstance(v, framework.Parameter) and v.trainable and v.name not in no_grad:
            if parameter_list is None or v.name in parameter_list:
                needs.add(v.name)
    if parameter_list is not None:
        needs |= set(parameter_list)
    for op in block.ops[: upto + 1]:
        spec = registry.get(op.type)
        if spec is not None and spec.stop_gradient:
            continue
        if any(n in needs for n in op.input_names()):
            for n in op.output_names():
                v = block._find_var_recursive(n)
                if v is None or v.stop_gradient or n in no_grad:
                    continue
                if v.dtype is not None and not is_floating(v.dtype):
                    continue
                needs.add(n)
    return needs


def append_backward(
    loss: framework.Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
    checkpoints: Optional[List] = None,
) -> List[Tuple[framework.Parameter, framework.Variable]]:
    """Append grad ops for `loss` to its block; return [(param, grad_var)].

    callbacks and checkpoints are accepted for API parity (the
    reference's recompute segments); the fused encoder stack's remat
    attrs do the recompute here.
    """
    from .analysis import pass_sandwich

    with pass_sandwich(loss.block.program, "append_backward",
                       live_out=(loss.name,)):
        return _append_backward_impl(
            loss, parameter_list, no_grad_set, callbacks, checkpoints)


def _append_backward_impl(
    loss: framework.Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
    checkpoints: Optional[List] = None,
) -> List[Tuple[framework.Parameter, framework.Variable]]:
    if parameter_list is not None:
        parameter_list = [
            p.name if isinstance(p, framework.Variable) else p for p in parameter_list
        ]
    block = loss.block

    # locate the op producing the loss
    loss_idx = None
    for i in reversed(range(len(block.ops))):
        if loss.name in block.ops[i].output_names():
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError(f"loss var {loss.name!r} is not produced by any op")

    needs = _needs_grad_set(block, loss_idx, parameter_list, no_grad_set)

    # d(loss)/d(loss) = 1
    loss_grad_name = loss.name + GRAD
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad_name]},
        attrs={
            "shape": list(loss.shape or (1,)),
            "dtype": loss.dtype,
            "value": 1.0,
        },
    )

    # partial grads per forward var (accumulated with sum ops on demand)
    partials: Dict[str, List[str]] = defaultdict(list)
    partials[loss.name].append(loss_grad_name)

    def finalize(var_name: str) -> Optional[str]:
        ps = partials.get(var_name)
        if not ps:
            return None
        if len(ps) == 1:
            return ps[0]
        out = var_name + GRAD
        block.append_op(
            type="sum", inputs={"X": list(ps)}, outputs={"Out": [out]}
        )
        partials[var_name] = [out]
        return out

    used_grad_names = {loss_grad_name}

    def new_partial_name(var_name: str) -> str:
        # unique across ALL allocations (a var feeding two slots of one op
        # must get two distinct partials, so counting partials[] alone is
        # not enough — partials are appended only after the op is emitted)
        base = var_name + GRAD
        name, i = base, 0
        while name in used_grad_names:
            i += 1
            name = f"{base}@RENAME@{i}"
        used_grad_names.add(name)
        return name

    for op in reversed(block.ops[: loss_idx + 1]):
        spec = registry.get(op.type)
        if spec is None or spec.stop_gradient:
            continue
        # finalized grads for this op's outputs
        out_grads: Dict[str, List[Optional[str]]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs = [finalize(n) for n in names]
            if any(g is not None for g in gs):
                out_grads[slot] = gs
                any_grad = True
        if not any_grad:
            continue
        diff_inputs = [n for n in op.input_names() if n in needs]
        if not diff_inputs:
            continue

        if spec.grad_maker is not None:
            descs, in_map = spec.grad_maker(op, {
                s: [g for g in gs if g is not None] for s, gs in out_grads.items()
            }, block)
            # Grad makers name outputs '<var>@GRAD'; if a partial with that
            # name already exists (var consumed by several ops), rename this
            # one so accumulation sums distinct values instead of duplicating.
            renames = {}
            for fwd_name, gname in in_map.items():
                uniq = new_partial_name(fwd_name)
                if uniq != gname:
                    renames[gname] = uniq
            for d in descs:
                outs = d.get("outputs") or {}
                if renames:
                    outs = {
                        s: [renames.get(n, n) for n in ns]
                        for s, ns in outs.items()
                    }
                block.append_op(
                    type=d["type"],
                    inputs=d.get("inputs"),
                    outputs=outs,
                    attrs=d.get("attrs"),
                )
            for fwd_name, gname in in_map.items():
                if fwd_name in needs:
                    partials[fwd_name].append(renames.get(gname, gname))
            continue

        # ---- generic vjp grad op ----
        if registry.get(op.type + "_grad") is None:
            raise NotImplementedError(
                f"op {op.type!r} is marked non-differentiable (no_vjp_grad) "
                f"and registers no grad maker, but a gradient flows through "
                f"it; mark the consuming path stop_gradient or add a grad "
                f"maker for {op.type!r}"
            )
        grad_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        for slot, gs in out_grads.items():
            filled: List[str] = []
            for g, n in zip(gs, op.outputs[slot]):
                if g is None:
                    z = n + GRAD + "@ZERO"
                    block.append_op(
                        type="fill_zeros_like",
                        inputs={"X": [n]},
                        outputs={"Out": [z]},
                    )
                    filled.append(z)
                else:
                    filled.append(g)
            grad_inputs[slot + GRAD] = filled

        grad_outputs: Dict[str, List[str]] = {}
        registered: List[Tuple[str, str]] = []
        for slot, names in op.inputs.items():
            outs = []
            produce = False
            for n in names:
                if n in needs:
                    gname = new_partial_name(n)
                    outs.append(gname)
                    registered.append((n, gname))
                    produce = True
                else:
                    # slot-aligned placeholder; value discarded
                    outs.append(f"{n}{GRAD}@UNUSED")
            if produce:
                grad_outputs[slot + GRAD] = outs
        if not grad_outputs:
            continue

        attrs = dict(op.attrs)
        attrs["__fwd_in_slots__"] = list(op.inputs.keys())
        block.append_op(
            type=op.type + "_grad",
            inputs=grad_inputs,
            outputs=grad_outputs,
            attrs=attrs,
            infer=False,  # grad shapes mirror forward inputs; skip re-trace
        )
        # set grad var metadata from forward vars
        for n, gname in registered:
            fv = block._find_var_recursive(n)
            gv = block._find_var_recursive(gname)
            if fv is not None and gv is not None:
                gv.shape = fv.shape
                gv.dtype = fv.dtype
        for n, gname in registered:
            partials[n].append(gname)

    # collect (target var, grad) — targets default to all trainable params
    if parameter_list is not None:
        target_names = list(parameter_list)
    else:
        target_names = [
            p.name
            for p in block.program.global_block().all_parameters()
            if p.trainable
        ]
    params_grads: List[Tuple[framework.Variable, framework.Variable]] = []
    for name in target_names:
        v = block._find_var_recursive(name)
        if v is None:
            continue
        g = finalize(name)
        if g is None:
            continue
        params_grads.append((v, block._find_var_recursive(g)))
    return params_grads


def calc_gradient(
    targets,
    inputs,
    target_gradients=None,
    no_grad_set=None,
):
    """Gradients of targets wrt inputs (reference backward.py:1665)."""
    if isinstance(targets, framework.Variable):
        targets = [targets]
    if isinstance(inputs, framework.Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise NotImplementedError("calc_gradient currently supports one target")
    loss = targets[0]
    names = [v.name for v in inputs]
    pg = append_backward(loss, parameter_list=names, no_grad_set=no_grad_set)
    by_name = {p.name: g for p, g in pg}
    block = loss.block
    outs = []
    for v in inputs:
        g = by_name.get(v.name)
        if g is None:
            gname = v.name + GRAD
            g = block._find_var_recursive(gname)
        outs.append(g)
    return outs


gradients = calc_gradient
