"""The port's ``ops/reduce_ops.py`` op types of this slice (``reduce_min``,
``reduce_prod``, ``reduce_all``, ``reduce_any``, ``frobenius_norm``)
against the JAX package's emitters on the CPU, on the same numpy inputs
from a seed, over f32 with NaN, both infinities and both zeros, bf16,
int32, uint8 and bool; with a list of dims, ``keep_dim`` and
``reduce_all``, and a reduction to rank 0, which keeps shape [1].

Tolerances: ``reduce_min`` / ``reduce_all`` / ``reduce_any`` and every
integer result exact (dtype, shape, values, the sign of zeros); a float
product or norm 1e-6 / 2e-6 (f32: another order of at most 16 factors
or terms), 0 / 2**-7 in bf16 (one bf16 rounding step).  Gradients
against ``jax.vjp`` at 2e-6 / 1e-6, among them ``reduce_min``'s ties
(split evenly, as jnp.min's), ``reduce_prod`` over zeros and NaN, and
``frobenius_norm``.  The layers build the same ops as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from torch_emit_cases import (NAN, SPECIAL, Bf16, assert_emit_matches,
                              assert_vjp_matches, emit_torch, rand,
                              shape_inference_matches)

F32_TOL = (1e-6, 2e-6)
BF16_TOL = (0.0, 2.0 ** -7)

I32 = np.array([[3, -7, 3, 0], [-1, 2, -2, 5]], np.int32)
U8 = np.array([[1, 255, 3, 0], [7, 2, 200, 5]], np.uint8)
BOOL = np.array([[True, False, True, True], [True, True, True, True]])
R = rand(1, 2, 3, 4)
TIES = np.array([[1.0, -2.0, -2.0, 3.0], [0.0, -0.0, 4.0, 0.0]],
                np.float32)
PROD = np.array([[1.5, 0.0, -2.0, 0.5], [NAN, 2.0, 0.25, -1.0],
                 [0.0, 0.0, 3.0, 1.0]], np.float32)

DIMS = {"d1": {"dim": [1]}, "all": {"reduce_all": True},
        "keep": {"dim": [0, -1], "keep_dim": True}}
INPUTS = {"f32": SPECIAL, "bf16": Bf16(SPECIAL), "int": I32, "uint8": U8,
          "bool": BOOL}
EXACT_OPS = ("reduce_min", "reduce_all", "reduce_any")

EMIT = {}
for _op in ("reduce_min", "reduce_prod", "reduce_all", "reduce_any",
            "frobenius_norm"):
    for _k, _x in INPUTS.items():
        if _op == "frobenius_norm" and _k == "bool":
            continue   # jnp.square refuses bool in the JAX emitter
        for _d, _a in DIMS.items():
            exact = _op in EXACT_OPS or _k in ("int", "uint8", "bool")
            tol = None if exact else BF16_TOL if _k == "bf16" else F32_TOL
            EMIT[f"{_op}_{_k}_{_d}"] = (_op, {"X": _x}, _a, tol)
EMIT.update({
    "reduce_prod_3d": ("reduce_prod", {"X": R}, {"dim": [0, 2]}, F32_TOL),
    "reduce_prod_zeros_nan": ("reduce_prod", {"X": PROD}, {"dim": [1]},
                              F32_TOL),
    "reduce_min_ties": ("reduce_min", {"X": TIES}, {"dim": [1]}, None),
    "reduce_min_3d_keep": ("reduce_min", {"X": R}, {"dim": [1, 2],
                                                    "keep_dim": True}, None),
    "frobenius_norm_3d": ("frobenius_norm", {"X": R}, {"dim": [1, 2]},
                          F32_TOL),
    "reduce_all_float": ("reduce_all", {"X": R}, {"dim": [2]}, None),
    "reduce_any_int_rank0": ("reduce_any", {"X": I32 * 0},
                             {"reduce_all": True}, None),
})


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax(name):
    op, ins, attrs, tol = EMIT[name]
    if tol is None:
        assert_emit_matches(op, ins, attrs, exact=True)
    else:
        assert_emit_matches(op, ins, attrs, exact=False, atol=tol[0],
                            rtol=tol[1])


_SHAPE_CASES = sorted({c[0]: n for n, c in sorted(EMIT.items())}.values())


@pytest.mark.parametrize("name", _SHAPE_CASES)
def test_shape_inference_matches_jax(name):
    op, ins, attrs, _ = EMIT[name]
    shape_inference_matches(op, ins, attrs)


@pytest.mark.parametrize("name", [
    "reduce_min_ties", "reduce_min_3d_keep", "reduce_min_f32_all",
    "reduce_prod_3d", "reduce_prod_zeros_nan", "frobenius_norm_3d",
    "frobenius_norm_f32_keep"])
def test_gradient_matches_jax_vjp(name):
    op, ins, attrs, _ = EMIT[name]
    # a NaN min's gradient against the eager jax.vjp: compiled, XLA
    # places the NaNs otherwise
    assert_vjp_matches(op, ins, attrs, jit=name != "reduce_min_f32_all")


@pytest.mark.parametrize("op,x,neg", [
    ("reduce_max", [-0.0, 0.0, -1.0], False),
    ("reduce_max", [-0.0, -0.0], True),
    ("reduce_min", [0.0, -0.0, 4.0, 0.0], True),
    ("reduce_min", [0.0, 2.0], False)])
def test_zero_extremes_are_signed_as_xla(op, x, neg):
    """Repaired (reduce_max was ported before): XLA's max and min order -0.0
    below +0.0, where torch.amax / amin return the first zero met."""
    x = np.array([x], np.float32)
    assert_emit_matches(op, {"X": x}, {"dim": [1]}, exact=True)
    assert bool(emit_torch(op, {"X": x}, {"dim": [1]})["Out"][0].signbit()) \
        == neg


def test_rank0_reductions_keep_shape_1():
    for op in ("reduce_min", "reduce_prod", "reduce_all", "reduce_any",
               "frobenius_norm"):
        out = emit_torch(op, {"X": R}, {"reduce_all": True})["Out"][0]
        assert tuple(out.shape) == (1,), op


def _build(fluid, body):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [2, 3, 4], "float32", append_batch_size=False)
        body(L, x)
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in main.global_block().ops], {
        n: (v.shape, str(v.dtype)) for n, v in main.global_block().vars.items()}


@pytest.mark.parametrize("layer", ["reduce_min", "reduce_prod", "reduce_all",
                                   "reduce_any"])
def test_layer_builds_the_same_ops_as_jax(layer):
    def body(L, x):
        fn = getattr(L, layer)
        if layer in ("reduce_all", "reduce_any"):
            x = L.cast(x, "bool")
        fn(x)
        fn(x, 1)
        fn(x, [0, 2], keep_dim=True)

    assert _build(tfluid, body) == _build(jfluid, body)
    assert set(treg.registered_ops()) >= {
        o for o in jreg.registered_ops()
        if jreg.get(o).emit.__module__ == "paddle_tpu.ops.reduce_ops"}
