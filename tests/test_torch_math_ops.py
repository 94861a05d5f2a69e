"""The port's ``ops/math_ops.py`` op types of this slice against the JAX
package's emitters on the CPU, on the same numpy inputs from a seed.

Tolerances (absolute / relative), each the width of what two correct
float implementations may differ by, not of a known fault:

* f32 activations, norms and reductions: 1e-6 / 2e-6 (an ulp or two of
  the transcendental functions);
* f32 products (``matmul_v2``, ``dot``, ``addmm``, ``kron``, ``cos_sim``)
  and linear algebra (``cholesky``, ``inverse``, ``matrix_power``): 1e-5 /
  1e-5, the accumulation order of a product of K <= 64;
* bf16 outputs: 0 / 2**-7, one bf16 rounding step of the result;
* integer, bool and index outputs, the isfinite family, ``prelu``,
  ``maxout``: exact.

Gradients against ``jax.vjp`` of the JAX emitters at 2e-6 / 1e-6 (f32),
at the boundary points where torch's own derivative differs: ``relu6``,
``hard_sigmoid`` and ``hard_swish`` on their clip bounds (half the
cotangent, as ``jnp.clip``), ``leaky_relu`` at 0 (1, not alpha),
``p_norm`` at a zero vector (NaN, not 0), ``soft_shrink`` at +-lambda,
``maxout`` ties (split evenly).
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from torch_emit_cases import (INF, NAN, SPECIAL, Bf16, assert_emit_matches,
                              assert_vjp_matches, emit_jax, emit_torch, rand,
                              shape_inference_matches)

F32_TOL = (1e-6, 2e-6)
MM_TOL = (1e-5, 1e-5)
BF16_TOL = (0.0, 2.0 ** -7)
EXACT = None

I32 = np.array([[3, -7, 1, 0], [-1, 2, -2, 5]], np.int32)
BOOL = np.array([[True, False, True, True], [False, False, True, False]])
R = rand(1, 3, 5)
# the clip bounds of relu6 / hard_sigmoid / hard_swish, 0, +-lambda of
# the shrinks and the threshold of thresholded_relu, each side of them
BOUND = np.array([[-3.5, -3.0, -2.5, -1.0, -0.5, -0.2, 0.0, 0.2, 0.5],
                  [0.7, 1.0, 1.3, 2.5, 3.0, 4.0, 6.0, 6.5, -7.0]],
                 np.float32)

ACTS = {
    "sigmoid": {}, "tan": {}, "acos": {}, "asin": {}, "atan": {},
    "sinh": {}, "cosh": {}, "log2": {}, "log10": {}, "log1p": {},
    "softplus": {}, "softsign": {}, "silu": {}, "swish": {"beta": 1.5},
    "logsigmoid": {}, "relu6": {"threshold": 6.0},
    "leaky_relu": {"alpha": 0.02}, "elu": {"alpha": 0.7},
    "hard_sigmoid": {"slope": 0.2, "offset": 0.5},
    "hard_swish": {"threshold": 6.0, "scale": 6.0, "offset": 3.0},
    "thresholded_relu": {"threshold": 1.0},
    "hard_shrink": {"threshold": 0.5}, "soft_shrink": {"lambda": 0.5},
    "erf": {}, "mish": {},
}
# jax.nn.sigmoid / silu and lax.erf refuse integer and bool X; the ops
# that negate X first refuse bool
_NO_INT = {"sigmoid", "silu", "erf"}
_NO_BOOL = _NO_INT | {"logsigmoid", "soft_shrink"}

# NaN, both infinities, both zeros and the boundary points in one row
ACT_X = np.concatenate([SPECIAL.ravel(), BOUND.ravel()])

EMIT = {}
for _op, _a in ACTS.items():
    EMIT[f"{_op}_f32"] = (_op, {"X": ACT_X}, _a, F32_TOL)
    EMIT[f"{_op}_bf16"] = (_op, {"X": Bf16(ACT_X)}, _a, BF16_TOL)
    if _op not in _NO_INT:
        EMIT[f"{_op}_int"] = (_op, {"X": I32}, _a, F32_TOL)
    if _op not in _NO_BOOL:
        EMIT[f"{_op}_bool"] = (_op, {"X": BOOL}, _a, F32_TOL)

SPD = np.einsum("bij,bkj->bik", rand(2, 3, 4, 4), rand(2, 3, 4, 4)) \
    + 4 * np.eye(4, dtype=np.float32)
EMIT.update({
    "matmul_v2": ("matmul_v2", {"X": rand(3, 2, 5, 64), "Y": rand(4, 64, 3)},
                  {}, MM_TOL),
    "matmul_v2_trans": ("matmul_v2", {"X": rand(5, 2, 64, 5),
                                      "Y": rand(6, 2, 3, 64)},
                        {"trans_x": True, "trans_y": True}, MM_TOL),
    "matmul_v2_vec": ("matmul_v2", {"X": rand(7, 64), "Y": rand(8, 64, 3)},
                      {}, MM_TOL),
    "matmul_v2_int": ("matmul_v2", {"X": I32, "Y": I32.T.copy()}, {}, EXACT),
    "matmul_v2_bool": ("matmul_v2", {"X": BOOL, "Y": BOOL.T.copy()}, {},
                       EXACT),
    "matmul_v2_bf16_f32": ("matmul_v2", {"X": Bf16(rand(9, 2, 16)),
                                         "Y": rand(10, 16, 4)}, {}, MM_TOL),
    "dot": ("dot", {"X": rand(11, 3, 64), "Y": rand(12, 3, 64)}, {}, MM_TOL),
    "dot_vec": ("dot", {"X": rand(13, 64), "Y": rand(14, 64)}, {}, MM_TOL),
    "dot_int8": ("dot", {"X": np.array([[1, 2]], np.int8),
                         "Y": np.array([[100, 100]], np.int8)}, {}, EXACT),
    "dot_bool": ("dot", {"X": BOOL, "Y": BOOL[::-1].copy()}, {}, EXACT),
    "dot_bf16": ("dot", {"X": Bf16(rand(15, 2, 8)), "Y": Bf16(rand(16, 2, 8))},
                 {}, BF16_TOL),
    "addmm": ("addmm", {"Input": rand(17, 3, 4), "X": rand(18, 3, 64),
                        "Y": rand(19, 64, 4)}, {"Alpha": 0.5, "Beta": 2.0},
              MM_TOL),
    "addmm_int": ("addmm", {"Input": I32[:, :2].copy(), "X": I32,
                            "Y": I32.T[:, :2].copy()}, {}, EXACT),
    "kron": ("kron", {"X": rand(20, 2, 3), "Y": rand(21, 3, 2)}, {}, MM_TOL),
    "kron_mixed": ("kron", {"X": np.array([1, 2], np.int32),
                            "Y": np.array([0.5, -1.0], np.float32)}, {},
                   EXACT),
    "prelu_all": ("prelu", {"X": SPECIAL, "Alpha": np.array([0.25],
                                                           np.float32)},
                  {"mode": "all"}, EXACT),
    "prelu_channel": ("prelu", {"X": rand(22, 2, 3, 2, 2),
                                "Alpha": rand(23, 3)}, {"mode": "channel"},
                      EXACT),
    "prelu_element": ("prelu", {"X": rand(24, 2, 3, 4),
                                "Alpha": rand(25, 3, 4)},
                      {"mode": "element"}, EXACT),
    "log_softmax": ("log_softmax", {"X": rand(26, 2, 3, 9)}, {"axis": -1},
                    F32_TOL),
    "log_softmax_axis1": ("log_softmax", {"X": BOUND}, {"axis": 0}, F32_TOL),
    "log_softmax_special": ("log_softmax", {"X": SPECIAL}, {"axis": 1},
                            F32_TOL),
    "log_softmax_int": ("log_softmax", {"X": I32}, {"axis": 1}, F32_TOL),
    "log_softmax_uint8": ("log_softmax", {"X": np.array([[0, 3, 255]],
                                                        np.uint8)},
                          {"axis": 1}, F32_TOL),
    "log_softmax_bf16": ("log_softmax", {"X": Bf16(rand(27, 3, 9))},
                         {"axis": -1}, BF16_TOL),
    "maxout": ("maxout", {"X": rand(28, 2, 6, 3)}, {"groups": 3}, EXACT),
    "maxout_ties_nan": ("maxout", {"X": np.array(
        [[[1.0], [1.0], [NAN], [2.0]]], np.float32)}, {"groups": 2}, EXACT),
    "maxout_int": ("maxout", {"X": I32.reshape(1, 8)}, {"groups": 4}, EXACT),
    "isfinite": ("isfinite", {"X": [R, SPECIAL]}, {}, EXACT),
    "isfinite_true": ("isfinite", {"X": [R, I32, BOOL]}, {}, EXACT),
    "isinf": ("isinf", {"X": SPECIAL}, {}, EXACT),
    "isinf_int": ("isinf", {"X": I32}, {}, EXACT),
    "isnan": ("isnan", {"X": Bf16(SPECIAL)}, {}, EXACT),
    "isnan_false": ("isnan", {"X": R}, {}, EXACT),
    "isfinite_v2": ("isfinite_v2", {"X": SPECIAL}, {}, EXACT),
    "isfinite_v2_int": ("isfinite_v2", {"X": I32}, {}, EXACT),
    "isinf_v2": ("isinf_v2", {"X": Bf16(SPECIAL)}, {}, EXACT),
    "isnan_v2": ("isnan_v2", {"X": SPECIAL}, {}, EXACT),
    "isnan_v2_bool": ("isnan_v2", {"X": BOOL}, {}, EXACT),
    **{f"p_norm_{p}": ("p_norm", {"X": np.concatenate([R, np.zeros(
        (1, 5), np.float32)])}, {"porder": float(p), "axis": 1}, F32_TOL)
       for p in (2, 1, 0, 3, 0.5, INF, -INF)},
    "p_norm_keepdim": ("p_norm", {"X": R}, {"porder": 2.0, "axis": 0,
                                            "keepdim": True}, F32_TOL),
    "p_norm_int": ("p_norm", {"X": I32}, {"porder": 2.0, "axis": -1},
                   F32_TOL),
    "p_norm_bf16": ("p_norm", {"X": Bf16(R)}, {"porder": 2.0, "axis": 1},
                    BF16_TOL),
    "trace": ("trace", {"Input": rand(29, 4, 5)}, {"offset": 1}, F32_TOL),
    "trace_3d": ("trace", {"Input": rand(30, 3, 4, 4)},
                 {"offset": -1, "axis1": 1, "axis2": 2}, F32_TOL),
    "trace_int": ("trace", {"Input": I32}, {}, EXACT),
    "trace_uint8": ("trace", {"Input": np.full((3, 3), 200, np.uint8)}, {},
                    EXACT),
    "trace_bool": ("trace", {"Input": BOOL}, {"offset": 1}, EXACT),
    "cholesky": ("cholesky", {"X": SPD}, {}, MM_TOL),
    "cholesky_upper": ("cholesky", {"X": SPD}, {"upper": True}, MM_TOL),
    "cholesky_not_pd": ("cholesky", {"X": np.array([[1.0, 2.0], [2.0, 1.0]],
                                                   np.float32)}, {}, MM_TOL),
    "inverse": ("inverse", {"Input": SPD}, {}, MM_TOL),
    "inverse_singular": ("inverse", {"Input": np.array(
        [[1.0, 2.0], [2.0, 4.0]], np.float32)}, {}, MM_TOL),
    "matrix_power": ("matrix_power", {"X": SPD / 6}, {"n": 5}, MM_TOL),
    "matrix_power_zero": ("matrix_power", {"X": SPD}, {"n": 0}, EXACT),
    "matrix_power_neg": ("matrix_power", {"X": SPD}, {"n": -2}, MM_TOL),
    "matrix_power_int": ("matrix_power", {"X": np.array([[1, 1], [1, 0]],
                                                        np.int32)},
                         {"n": 7}, EXACT),
    "logsumexp": ("logsumexp", {"X": rand(31, 2, 3, 4)}, {"axis": [1]},
                  F32_TOL),
    "logsumexp_all": ("logsumexp", {"X": R}, {"axis": []}, F32_TOL),
    "logsumexp_keep": ("logsumexp", {"X": R}, {"axis": [0, 1],
                                               "keepdim": True}, F32_TOL),
    "logsumexp_inf_rows": ("logsumexp", {"X": np.array(
        [[-INF, -INF], [INF, 1.0], [NAN, 0.0]], np.float32)},
        {"axis": [1]}, F32_TOL),
    "logsumexp_int": ("logsumexp", {"X": I32}, {"axis": [-1]}, F32_TOL),
    "logsumexp_bf16": ("logsumexp", {"X": Bf16(R)}, {"axis": [1]},
                       BF16_TOL),
    "cos_sim": ("cos_sim", {"X": rand(32, 4, 8), "Y": rand(33, 4, 8)}, {},
                MM_TOL),
    "cos_sim_bcast_zero_row": ("cos_sim", {
        "X": np.concatenate([np.zeros((1, 8), np.float32), rand(34, 2, 8)]),
        "Y": rand(35, 1, 8)}, {}, MM_TOL),
})


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax(name):
    op, ins, attrs, tol = EMIT[name]
    if tol is EXACT:
        assert_emit_matches(op, ins, attrs, exact=True)
    else:
        assert_emit_matches(op, ins, attrs, exact=False, atol=tol[0],
                            rtol=tol[1])


_SHAPE_CASES = sorted({c[0]: n for n, c in sorted(EMIT.items())}.values())


@pytest.mark.parametrize("name", _SHAPE_CASES)
def test_shape_inference_matches_jax(name):
    op, ins, attrs, _ = EMIT[name]
    shape_inference_matches(op, ins, attrs)


@pytest.mark.parametrize("op", sorted(ACTS))
def test_activation_gradient_matches_jax_vjp(op):
    """At the clip bounds, 0, +-lambda and the thresholds (``BOUND``) and
    at random points (inside the domain of acos, asin and the logs)."""
    x = np.concatenate([BOUND.ravel(), R.ravel()])
    if op in ("acos", "asin"):
        x = np.clip(x, -0.9, 0.9)
    elif op in ("log2", "log10", "log1p"):
        x = np.abs(x) + 0.1
    assert_vjp_matches(op, {"X": x}, ACTS[op])


GRAD = {
    "matmul_v2": MM_TOL, "dot": MM_TOL, "addmm": MM_TOL, "kron": MM_TOL,
    "prelu_channel": None, "prelu_element": None, "log_softmax": None,
    "maxout": None, "maxout_ties_nan": None,
    **{f"p_norm_{p}": None for p in (2, 1, 0.5, INF, -INF)},
    "trace_3d": None, "cholesky_upper": MM_TOL, "inverse": "Output",
    "matrix_power": MM_TOL, "matrix_power_neg": MM_TOL,
    "logsumexp_keep": None, "cos_sim_bcast_zero_row": MM_TOL,
}


@pytest.mark.parametrize("name", sorted(GRAD))
def test_gradient_matches_jax_vjp(name):
    """With respect to every f32 input, the 2-norm at a zero row (NaN in
    both) and maxout's tie and NaN group among them."""
    op, ins, attrs, _ = EMIT[name]
    slot, tol = "Out", GRAD[name] or (2e-6, 1e-6)
    if tol == "Output":
        slot, tol = "Output", MM_TOL
    assert_vjp_matches(op, ins, attrs, slot, atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("x,op,attrs,want", [
    (0.0, "leaky_relu", {"alpha": 0.02}, 1.0),
    (6.0, "relu6", {"threshold": 6.0}, 0.5),
    (0.0, "relu6", {"threshold": 6.0}, 0.5),
    (2.5, "hard_sigmoid", {"slope": 0.2, "offset": 0.5}, 0.1),
    (0.5, "soft_shrink", {"lambda": 0.5}, 0.5),
])
def test_boundary_derivatives_are_jax_s(x, op, attrs, want):
    """The derivative at a boundary is JAX's (torch's own: leaky_relu 0.02
    at 0, clamp 1.0 or 0.0 on a bound), so a training step's gradient
    does not depend on which package took it."""
    import torch

    xt = torch.tensor([x], requires_grad=True)
    treg.get(op).emit(treg.EmitContext(), {"X": [xt]},
                      dict(attrs))["Out"][0].sum().backward()
    assert xt.grad.item() == pytest.approx(want, abs=1e-7)


def test_p_norm_gradient_at_zero_is_nan_as_in_jax():
    import torch

    x = torch.zeros(1, 3, requires_grad=True)
    treg.get("p_norm").emit(treg.EmitContext(), {"X": [x]},
                            {"porder": 2.0, "axis": 1})["Out"][0].sum() \
        .backward()
    assert torch.isnan(x.grad).all()


@pytest.mark.parametrize("op,x", [
    ("sigmoid", I32), ("silu", BOOL), ("erf", I32), ("logsigmoid", BOOL),
    ("soft_shrink", BOOL), ("log_softmax", BOOL)])
def test_raises_type_error_as_in_jax(op, x):
    with pytest.raises(TypeError):
        emit_jax(op, {"X": x}, ACTS.get(op, {}))
    with pytest.raises(TypeError):
        emit_torch(op, {"X": x}, ACTS.get(op, {}))


# ---------------------------------------------------------------------------
# the fluid.layers callables
# ---------------------------------------------------------------------------


def _build(fluid, body):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [2, 4, 4], "float32", append_batch_size=False)
        y = L.data("y", [4], "float32", append_batch_size=False)
        body(L, x, y)

    def ops(p):
        return [(op.type, op.inputs, op.outputs,
                 {k: v for k, v in op.attrs.items()
                  if not k.startswith("__")})
                for op in p.global_block().ops]

    vs = {n: (v.shape, v.dtype, v.stop_gradient, v.persistable)
          for n, v in main.global_block().vars.items()}
    return ops(main), ops(startup), vs


def _ops_layers(L, x, y):
    for n in ("sigmoid", "tan", "acos", "asin", "atan", "sinh", "cosh",
              "log2", "log10", "log1p", "softplus", "softsign", "silu",
              "logsigmoid", "erf", "mish", "sign"):
        getattr(L, n)(x)
    L.leaky_relu(x, 0.1)
    L.elu(x, 0.5)
    L.relu6(x, 5.0)
    L.hard_sigmoid(x, 0.3, 0.4)
    L.hard_swish(x, 5.0, 4.0, 2.0)
    L.swish(x, 2.0)
    L.soft_shrink(x, 0.3)
    L.hard_shrink(x, 0.2)
    L.thresholded_relu(x, 0.7)
    L.maxout(L.reshape(x, [2, 4, 2, 2]), 2)
    L.pow(x, 3.0)
    L.gelu(x, True)


LAYERS = {
    "ops": _ops_layers,
    "products": lambda L, x, y: (
        L.dot(y, y), L.kron(x, x), L.addmm(x, x, x, beta=0.5, alpha=2.0),
        L.mul(x, y, x_num_col_dims=2), L.matmul(x, x)),
    "linalg": lambda L, x, y: (
        L.trace(x, 1, 1, 2), L.cholesky(x, upper=True), L.inverse(x),
        L.matrix_power(x, 3)),
    "isfinite": lambda L, x, y: (
        L.isfinite(x), L.has_inf(x), L.has_nan(y), L.isfinite_v2(x),
        L.isnan_v2(x), L.isinf_v2(y), L.allclose(x, x, 1e-3, 1e-4, True)),
    "nn_math": lambda L, x, y: (
        L.prelu(L.reshape(x, [2, 4, 2, 2]), "channel"),
        L.prelu(x, "all"), L.prelu(x, "element"), L.log_softmax(x, 1),
        L.cos_sim(L.reshape(x, [2, 16]), L.reshape(x, [2, 16])),
        L.clip(x, -1, 2), L.clip_by_norm(x, 3)),
    "creation": lambda L, x, y: (
        L.zeros([2, 3], "int32"), L.ones([4], "float32"), L.zeros_like(x),
        L.sums([x, x, x]), L.sum([y, y]), L.sum(y), L.create_tensor("int64"),
        L.create_global_var([2], 1.5, "float32", persistable=True),
        L.create_global_var([1], 2.0, "int32"), L.rank(x), L.size(x),
        L.is_empty(x), L.autoincreased_step_counter()),
    "random": lambda L, x, y: (
        L.gaussian_random([2, 3], 1.0, 2.0, 7),
        L.uniform_random([4], "float32", -2.0, 3.0, 5),
        L.gaussian_random_batch_size_like(x, [1, 8]),
        L.uniform_random_batch_size_like(y, [3, 1], output_dim_idx=1)),
    "scatter_nd_shard": lambda L, x, y: (
        L.scatter_nd(L.cast(L.reshape(y, [4, 1]), "int32"), y, [6]),
        L.shard_index(L.cast(y, "int64"), 20, 4, 1, -2)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_same_ops_as_jax(name):
    """Same ops in the main and startup programs (types, slots,
    attributes) and the same vars (shapes, dtypes, stop_gradient,
    persistable) as the JAX package's layers."""
    assert _build(tfluid, LAYERS[name]) == _build(jfluid, LAYERS[name])


def test_layers_exported_and_ops_registered():
    L = tfluid.layers
    names = ("sigmoid", "tan", "acos", "asin", "atan", "sinh", "cosh",
             "log2", "log10", "log1p", "softplus", "softsign", "silu",
             "swish", "logsigmoid", "relu6", "leaky_relu", "elu",
             "hard_sigmoid", "hard_swish", "thresholded_relu",
             "hard_shrink", "soft_shrink", "erf", "mish", "maxout", "sign",
             "dot", "kron", "addmm", "trace", "cholesky", "inverse",
             "matrix_power", "isfinite", "has_inf", "has_nan", "sums",
             "zeros", "ones", "prelu", "log_softmax", "cos_sim", "mul",
             "clip", "clip_by_norm", "sum", "shard_index",
             "gaussian_random", "uniform_random")
    assert [n for n in names if not hasattr(L, n)] == []
    assert set(treg.registered_ops()) >= {
        o for o in jreg.registered_ops()
        if jreg.get(o).emit.__module__ == "paddle_tpu.ops.math_ops"}


def test_abs_gradient_matches_jax_vjp_at_zero_and_nan():
    """The ``abs`` op took torch's derivative, 0 at 0 and NaN at NaN;
    lax.abs's is the cotangent where x >= 0 (both zeros) and its
    negative elsewhere.  Repaired with ``_Abs``; ``p_norm`` at porder 1
    and inf and ``soft_shrink`` take the same |x|."""
    x = np.array([-0.0, 0.0, NAN, -2.0, 3.0, -INF], np.float32)
    assert_vjp_matches("abs", {"X": x}, {})
