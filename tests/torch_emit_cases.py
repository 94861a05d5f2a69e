"""Shared helpers of the op-emitter parity tests: run one op's emitter in
both packages on the same numpy inputs and compare what they give.

An input is a numpy array, a ``Bf16`` (a float32 array the two sides
round to bfloat16 themselves) or a list of either (a multi-tensor slot).
``exact`` comparisons hold dtype, shape and every value equal, bf16 bit
for bit, NaN where the reference has NaN and the sign of every zero;
the others hold dtype and shape equal and values within ``atol`` /
``rtol``, NaN and infinities in the same places.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.fluid import dtypes as tdtypes
from paddle_tpu_torch.ops import registry as treg

NAN, INF = np.nan, np.inf
# f32 with NaN, both infinities and both zeros
SPECIAL = np.array([[-3.0, -0.0, 0.0, 0.5], [2.0, NAN, INF, -INF]],
                   np.float32)


class Bf16:
    """A float32 array that each side rounds to bfloat16."""

    def __init__(self, a):
        self.a = np.asarray(a, np.float32)
        self.shape = self.a.shape
        self.dtype = "bfloat16"


def rand(seed, *shape, pos=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.1 if pos else a


def _one(a, side):
    if isinstance(a, Bf16):
        # both sides get the bits jnp rounds to (torch's own rounding of
        # a NaN sets its sign bit)
        j = jnp.asarray(a.a, jnp.bfloat16)
        if side == "jax":
            return j
        return torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
    return jnp.asarray(a) if side == "jax" else torch.as_tensor(np.array(a))


def inputs(ins, side):
    return {k: [_one(a, side) for a in (v if isinstance(v, list) else [v])]
            for k, v in ins.items()}


def emit_jax(op, ins, attrs):
    """The JAX emitter under one ``jax.jit`` (one XLA compile for the
    case, as the JAX executor compiles a whole block).  Gradients stay
    eager (``assert_vjp_matches``): a fused ``slope * x + offset`` is one
    FMA there, which moves a clip bound's tie."""
    fn = jax.jit(lambda i: jreg.get(op).emit(jreg.EmitContext(), i,
                                             dict(attrs)))
    return fn(inputs(ins, "jax"))


def emit_torch(op, ins, attrs):
    return treg.get(op).emit(treg.EmitContext(), inputs(ins, "torch"),
                             dict(attrs))


def _host(t):
    """A torch result as (float64 or integer numpy values, numpy dtype,
    raw bits or None)."""
    dt = tdtypes.from_torch_dtype(t.dtype)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), dt, t.view(torch.int16).numpy()
    return t.numpy(), dt, None


def assert_same(j, t, exact, atol=0.0, rtol=0.0, what=""):
    """One JAX result ``j`` against one torch result ``t``."""
    a = np.asarray(j)
    b, bdt, bits = _host(t)
    assert tuple(t.shape) == a.shape, (what, tuple(t.shape), a.shape)
    if a.dtype == jnp.bfloat16:
        assert t.dtype == torch.bfloat16, (what, t.dtype)
        abits, a = a.view(np.int16), a.astype(np.float32)
        if exact:
            nan = np.isnan(a)
            np.testing.assert_array_equal(np.isnan(b), nan, err_msg=what)
            np.testing.assert_array_equal(bits[~nan], abits[~nan],
                                          err_msg=what)
            return
    else:
        assert bdt == a.dtype, (what, bdt, a.dtype)
    if exact:
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(b), np.isnan(a),
                                          err_msg=what)
            ok = ~np.isnan(a)
            np.testing.assert_array_equal(b[ok], a[ok], err_msg=what)
            np.testing.assert_array_equal(np.signbit(b[ok]),
                                          np.signbit(a[ok]), err_msg=what)
        else:
            np.testing.assert_array_equal(b, a, err_msg=what)
        return
    np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


def assert_emit_matches(op, ins, attrs, exact, atol=0.0, rtol=0.0):
    """Both emitters on the same inputs: the same slots, and each output
    the same (``assert_same``)."""
    j = emit_jax(op, ins, attrs)
    t = emit_torch(op, ins, attrs)
    assert sorted(t) == sorted(j)
    for slot in j:
        assert len(t[slot]) == len(j[slot]), slot
        for i, (a, b) in enumerate(zip(j[slot], t[slot])):
            assert_same(a, b, exact, atol, rtol, f"{op} {slot}[{i}]")


def shape_inference_matches(op, ins, attrs):
    metas = {k: [(a.shape, a.dtype if not isinstance(a, Bf16)
                  else jnp.bfloat16) for a in
                  (v if isinstance(v, list) else [v])]
             for k, v in ins.items()}

    def named(res):   # the two packages' bfloat16 are distinct objects
        return {k: [(s, d.name) for s, d in v] for k, v in res.items()}

    assert (named(treg.abstract_eval(op, metas, attrs, 3))
            == named(jreg.abstract_eval(op, metas, attrs, 3)))


def float_slots(ins):
    """The (slot, position) of every input that takes a gradient: the f32
    arrays (not bf16), in list slots too."""
    out = []
    for k in sorted(ins):
        v = ins[k]
        for i, a in enumerate(v if isinstance(v, list) else [v]):
            if not isinstance(a, Bf16) and a.dtype.kind == "f":
                out.append((k, i))
    return out


def _with(ins, leaves):
    out = {k: list(v) for k, v in ins.items()}
    for (k, i), a in leaves.items():
        out[k][i] = a
    return out


def assert_vjp_matches(op, ins, attrs, out_slot="Out", seed=4, atol=2e-6,
                       rtol=1e-6, jit=False):
    """The gradient of ``out_slot``'s first output with respect to every
    f32 input, one random cotangent: torch autograd through the port's
    emitter against jax.vjp of the JAX emitter (both at the same
    primal); with ``jit`` the JAX side compiled as one program (one XLA
    compile instead of one dispatch a primitive), for ops whose
    derivative no FMA contraction moves."""
    names = float_slots(ins)
    jins = inputs(ins, "jax")

    def jfn(*args):
        return jreg.get(op).emit(jreg.EmitContext(),
                                 _with(jins, dict(zip(names, args))),
                                 dict(attrs))[out_slot][0]

    primals = [jins[k][i] for k, i in names]
    out = jax.eval_shape(jfn, *primals)
    g = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)

    def pullback(ct, *args):
        return jax.vjp(jfn, *args)[1](ct)

    want = (jax.jit(pullback) if jit else pullback)(
        jnp.asarray(g, out.dtype), *primals)
    tins = inputs(ins, "torch")
    leaves = {n: tins[n[0]][n[1]].requires_grad_() for n in names}
    got = treg.get(op).emit(treg.EmitContext(), _with(tins, leaves),
                            dict(attrs))[out_slot][0]
    if got.requires_grad:   # else a constant: the gradient is zero
        got.backward(torch.as_tensor(g).to(got.dtype))
    for n, w in zip(names, want):
        gr = leaves[n].grad
        gr = torch.zeros_like(leaves[n]) if gr is None else gr
        np.testing.assert_allclose(gr.numpy(), np.asarray(w), atol=atol,
                                   rtol=rtol, err_msg=f"{op} d{n}")
