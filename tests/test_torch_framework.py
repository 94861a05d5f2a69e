"""The port's Program IR, layers, op emitters and Executor against the JAX
package's.

* The same ``program_guard`` build in both packages, under
  ``unique_name.guard()``, gives the same ops (types, slots, attrs), the
  same variables (names, shapes with the -1 batch dim, dtypes, flags)
  and the same startup program; ``clone(for_test=True)`` flips the same
  ``is_test`` attrs.
* Each ported emitter against the JAX package's emitter, in f32 on one
  random input (tolerance 2e-6: the same math, summed in another order;
  1e-5 where a matmul sums over 64 or more terms).
* The Executor on the CPU: startup, state read and written back, the
  per-step seed, Scope.from_numpy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import dtypes as tdtypes
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.ops import registry as treg

TOL, MM_TOL = 2e-6, 1e-5


def _model(fluid, nn):
    """Every layer the BERT path uses, on a -1 batch dim."""
    L = fluid.layers
    nn._rng_salt_counter[0] = 0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [16], "int64")
        x = L.data("x", [16, 64], "float32")
        lbl = L.data("lbl", [1], "int32")
        mask = L.data("mask", [16], "float32")
        emb = L.embedding(ids, size=[50, 64], padding_idx=0)
        h = L.elementwise_add(x, emb)
        h = L.layer_norm(h, begin_norm_axis=2)
        h = L.dropout(h, 0.1, dropout_implementation="upscale_in_train")
        q = L.fc(h, 64, num_flatten_dims=2, act="gelu")
        k = L.fc(h, 64, num_flatten_dims=2)
        bias = L.unsqueeze(L.unsqueeze(L.scale(L.cast(mask, "float32"),
                                               scale=1e4, bias=-1e4), [1]),
                           [1])
        a = L.fused_multihead_attention(q, k, h, bias, num_heads=1,
                                        dropout_prob=0.1)
        s = L.softmax(L.matmul(a, k, transpose_y=True, alpha=0.125))
        t = L.transpose(L.reshape(s, [-1, 16, 4, 4]), [0, 2, 1, 3])
        first = L.reshape(L.slice(h, axes=[1], starts=[0], ends=[1]),
                          [-1, 64])
        pooled = L.fc(first, 8, act="tanh")
        w = L.create_parameter(shape=[8], dtype="float32", name="out_b")
        logits = L.elementwise_add(pooled, w)
        loss = L.reduce_mean(L.softmax_with_cross_entropy(logits, lbl))
        g = L.gather(L.reshape(h, [-1, 64]), L.cast(lbl, "int32"))
        total = L.elementwise_add(
            loss, L.reduce_sum(L.elementwise_mul(g, g)) / 100.0)
        total = total - L.fill_constant([1], "float32", 0.5)
        total = L.elementwise_div(L.reduce_sum(t, dim=[1, 2]), total)
    return main, startup, total


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in program.global_block().ops]


def _vars(program):
    return {n: (v.shape, v.dtype, v.persistable, v.is_data, v.stop_gradient,
                type(v).__name__)
            for n, v in program.global_block().vars.items()}


@pytest.fixture
def both():
    return _model(jfluid, jnn), _model(tfluid, tnn)


def test_same_ops_and_attrs(both):
    (jm, js, _), (tm, ts, _) = both
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)


def test_same_vars_shapes_and_dtypes(both):
    (jm, js, jt), (tm, ts, tt) = both
    assert _vars(tm) == _vars(jm)
    assert _vars(ts) == _vars(js)
    assert tt.shape == jt.shape and tt.shape[0] == -1


def test_clone_for_test_flips_the_same_attrs(both):
    (jm, _, _), (tm, _, _) = both
    jc, tc = jm.clone(for_test=True), tm.clone(for_test=True)
    flipped = [op.type for op in tc.global_block().ops
               if "is_test" in op.attrs]
    assert flipped == ["dropout", "fused_multihead_attention"]
    assert all(op.attrs["is_test"] for op in tc.global_block().ops
               if "is_test" in op.attrs)
    assert _ops(tc) == _ops(jc)
    assert not any(op.attrs.get("is_test") for op in tm.global_block().ops)
    assert tc._serial != tm._serial


def test_last_writer_links(both):
    _, (tm, _, total) = both
    assert total.op is tm.global_block().ops[-1]


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

_R = np.random.default_rng(0)


def _f(*shape):
    return _R.standard_normal(shape).astype(np.float32)


class _Bf16:
    """An EMIT input handed to both packages as bfloat16."""

    def __init__(self, a):
        self.a = a


def _bf16(*shape):
    return _Bf16(_f(*shape))


# ties, rows of -inf, NaN, integers, bf16, keep_dim and reduce_all
_TIES = np.array([[1.0, 3.0, 3.0, -2.0], [-np.inf] * 4, [0.5, np.nan, 2.0,
                                                         2.0]], np.float32)
_MAX_CASES = {
    "ties_dim1": (_TIES, {"dim": [1]}),
    "ties_dim0_keep": (_TIES, {"dim": [0], "keep_dim": True}),
    "neg_dim": (_f(2, 3, 4), {"dim": [-1], "keep_dim": True}),
    "all": (_f(3, 4), {"reduce_all": True}),
    "all_keep": (_f(2, 3), {"reduce_all": True, "keep_dim": True}),
    "int": (np.array([[3, -7, 3], [-1, -9, -1]], np.int32), {"dim": [1]}),
    "bf16": (_bf16(4, 8), {"dim": [1]}),
}
_UNARY_CASES = {
    "f32": np.array([[-3.0, -0.0, 0.0, 0.5], [2.0, np.nan, np.inf,
                                             -np.inf]], np.float32),
    "rand": np.abs(_f(3, 5)) + 0.1,
    "int": np.array([0, 1, 3, -2], np.int32),
    "bf16": _bf16(3, 4),
}


EMIT = {
    "elementwise_add_axis": ("elementwise_add",
                             {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    "elementwise_sub": ("elementwise_sub", {"X": _f(2, 3), "Y": _f(2, 3)},
                        {"axis": -1}),
    "elementwise_mul_trailing": ("elementwise_mul",
                                 {"X": _f(2, 3, 4), "Y": _f(4)}, {"axis": -1}),
    "elementwise_div": ("elementwise_div",
                        {"X": _f(2, 3), "Y": np.abs(_f(2, 3)) + 0.5}, {}),
    "mul": ("mul", {"X": _f(2, 5, 64), "Y": _f(64, 7)},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "matmul_t_alpha": ("matmul", {"X": _f(2, 5, 64), "Y": _f(2, 6, 64)},
                       {"transpose_X": False, "transpose_Y": True,
                        "alpha": 0.125}),
    "matmul_tx": ("matmul", {"X": _f(64, 5), "Y": _f(64, 3)},
                  {"transpose_X": True, "transpose_Y": False, "alpha": 1.0}),
    # mixed dtypes promote before the product, as jnp does: bf16 x f32
    "mul_bf16_f32": ("mul", {"X": _bf16(2, 16), "Y": _f(16, 4)}, {}),
    "matmul_bf16_f32": ("matmul", {"X": _bf16(2, 16), "Y": _f(16, 4)},
                        {"transpose_X": False, "transpose_Y": False,
                         "alpha": 1.0}),
    "matmul_f32_bf16_ty": ("matmul", {"X": _f(3, 16), "Y": _bf16(5, 16)},
                           {"transpose_X": False, "transpose_Y": True,
                            "alpha": 0.5}),
    "sum": ("sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}),
    "softmax": ("softmax", {"X": _f(2, 3, 9)}, {"axis": -1}),
    "softmax_axis1": ("softmax", {"X": _f(2, 3, 9)}, {"axis": 1}),
    "tanh": ("tanh", {"X": _f(4, 5)}, {}),
    "gelu": ("gelu", {"X": _f(4, 5)}, {"approximate": False}),
    "gelu_tanh": ("gelu", {"X": _f(4, 5)}, {"approximate": True}),
    "reshape2": ("reshape2", {"X": _f(2, 3, 4)}, {"shape": [0, -1]}),
    "reshape": ("reshape", {"X": _f(2, 3, 4)}, {"shape": [4, 6]}),
    "transpose2": ("transpose2", {"X": _f(2, 3, 4)}, {"axis": [2, 0, 1]}),
    "slice": ("slice", {"Input": _f(3, 8, 4)},
              {"axes": [1, 2], "starts": [1, -3], "ends": [100, -1]}),
    "slice_decrease": ("slice", {"Input": _f(3, 8, 4)},
                       {"axes": [1], "starts": [0], "ends": [1],
                        "decrease_axis": [1]}),
    "unsqueeze": ("unsqueeze", {"X": _f(3, 4)}, {"axes": [0, 2]}),
    "unsqueeze2": ("unsqueeze2", {"X": _f(3, 4)}, {"axes": [1]}),
    "gather": ("gather", {"X": _f(6, 4),
                          "Index": np.array([[5], [0], [2]], np.int32)}, {}),
    "cast_int": ("cast", {"X": _f(3, 4) * 4},
                 {"out_dtype": np.dtype("int32")}),
    "cast_int64_narrows": ("cast", {"X": _f(3)},
                           {"out_dtype": np.dtype("int64")}),
    "scale": ("scale", {"X": _f(3, 4)}, {"scale": 2.5, "bias": -1.0}),
    "scale_bias_first": ("scale", {"X": _f(3, 4)},
                         {"scale": 2.5, "bias": -1.0,
                          "bias_after_scale": False}),
    "fill_constant": ("fill_constant", {},
                      {"shape": [2, 3], "dtype": np.dtype("float32"),
                       "value": 0.25}),
    "fill_constant_int64": ("fill_constant", {},
                            {"shape": [4], "dtype": np.dtype("int64"),
                             "value": 3.0}),
    "fill_constant_str_value": ("fill_constant", {},
                                {"shape": [2, 3],
                                 "dtype": np.dtype("float32"), "value": 0.0,
                                 "str_value": "0.5"}),
    "assign_value_fp32_values": ("assign_value", {},
                                 {"shape": [3], "dtype": np.dtype("float32"),
                                  "fp32_values": [0.5, -1.0, 2.0]}),
    "assign_value_int32_values": ("assign_value", {},
                                  {"shape": [2, 2],
                                   "dtype": np.dtype("int32"),
                                   "int32_values": [1, -2, 3, 4]}),
    "assign_value_int64_values": ("assign_value", {},
                                  {"shape": [2], "dtype": np.dtype("int64"),
                                   "int64_values": [7, 9]}),
    "assign_value": ("assign_value", {},
                     {"shape": [2, 2], "dtype": np.dtype("float32"),
                      "values": [1.0, 2.0, 3.0, 4.0]}),
    "reduce_sum_all": ("reduce_sum", {"X": _f(3, 4)}, {"reduce_all": True}),
    "reduce_sum_dims": ("reduce_sum", {"X": _f(2, 3, 4)},
                        {"dim": [1, 2], "keep_dim": False}),
    "reduce_sum_int": ("reduce_sum", {"X": np.arange(12, dtype=np.int32)
                                      .reshape(3, 4)}, {"dim": [1]}),
    "reduce_mean_keep": ("reduce_mean", {"X": _f(2, 3, 4)},
                         {"dim": [-1], "keep_dim": True}),
    "reduce_mean_int": ("reduce_mean", {"X": np.arange(12, dtype=np.int32)
                                        .reshape(3, 4)}, {"dim": [1]}),
    "reduce_mean_int_all": ("reduce_mean", {"X": np.arange(
        12, dtype=np.int32).reshape(3, 4) - 5}, {"reduce_all": True}),
    "layer_norm_plain": ("layer_norm", {"X": _f(2, 3, 8), "Scale": _f(24),
                                        "Bias": _f(24)},
                         {"epsilon": 1e-5, "begin_norm_axis": 1}),
    "layer_norm_fused": ("layer_norm", {"X": _f(2, 3, 8), "Scale": _f(8),
                                        "Bias": _f(8)},
                         {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "lookup_table_v2_pad": ("lookup_table_v2",
                            {"W": _f(10, 4), "Ids": np.array(
                                [[1, 0, 9], [3, 3, 0]], np.int32)},
                            {"padding_idx": 0}),
    "lookup_table_v1": ("lookup_table",
                        {"W": _f(10, 4), "Ids": np.array(
                            [[1], [7]], np.int32)}, {"padding_idx": -1}),
    "dropout_test_downgrade": ("dropout", {"X": _f(3, 4)},
                               {"dropout_prob": 0.25, "is_test": True}),
    "dropout_test_upscale": ("dropout", {"X": _f(3, 4)},
                             {"dropout_prob": 0.25, "is_test": True,
                              "dropout_implementation":
                                  "upscale_in_train"}),
    "softmax_ce_hard": ("softmax_with_cross_entropy",
                        {"Logits": _f(4, 6), "Label": np.array(
                            [[0], [5], [-100], [2]], np.int32)}, {}),
    "softmax_ce_soft": ("softmax_with_cross_entropy",
                        {"Logits": _f(4, 6), "Label": np.abs(_f(4, 6))},
                        {"soft_label": True}),
    "attention_composition": ("fused_multihead_attention",
                              {"Q": _f(2, 8, 32), "K": _f(2, 8, 32),
                               "V": _f(2, 8, 32),
                               "BiasQK": np.where(_f(2, 1, 1, 8) > -1, 0.0,
                                                  -1e4).astype(np.float32)},
                              {"num_heads": 4, "is_test": True}),
    "attention_composition_causal": ("fused_multihead_attention",
                                     {"Q": _f(1, 8, 32), "K": _f(1, 8, 32),
                                      "V": _f(1, 8, 32)},
                                     {"num_heads": 2, "is_test": True,
                                      "causal": True}),
    "attention_full_bias": ("fused_multihead_attention",
                            {"Q": _f(1, 8, 32), "K": _f(1, 8, 32),
                             "V": _f(1, 8, 32), "BiasQK": _f(1, 2, 8, 8)},
                            {"num_heads": 2, "is_test": True}),
    # the re-anchor probe's six faults, on its inputs
    "mean_int": ("mean", {"X": np.array([[1, 2], [3, 4]], np.int32)}, {}),
    **{f"reduce_sum_{dt}": ("reduce_sum", {"X": np.ones((2, 3), dt)},
                            {"dim": [1]})
       for dt in ("bool", "int8", "uint8", "int16")},
    "scale_int_frac_bias": ("scale", {"X": np.array([1, 2, 3], np.int32)},
                            {"scale": 2.5, "bias": 0.5}),
    "scale_int_frac_bias_first": ("scale",
                                  {"X": np.array([1, 2, 3], np.int32)},
                                  {"scale": 2.5, "bias": -1.5,
                                   "bias_after_scale": False}),
    "sign_nan_negzero": ("sign", {"X": np.array([np.nan, -0.0, 2.0, -3.0],
                                                np.float32)}, {}),
    "gather_wrap_fill": ("gather", {"X": np.arange(12, dtype=np.float32)
                                    .reshape(6, 2),
                                    "Index": np.array([-1, 6], np.int32)},
                         {}),
    "gather_int_fill": ("gather", {"X": np.arange(12, dtype=np.int32)
                                   .reshape(6, 2),
                                   "Index": np.array([-1, 6, -7, 2],
                                                     np.int32)}, {}),
    "gather_axis1_fill": ("gather", {"X": _f(2, 6),
                                     "Index": np.array([5, -6, 6],
                                                       np.int32)},
                          {"axis": 1}),
    "lookup_table_v2_past_table": ("lookup_table_v2",
                                   {"W": _f(5, 3), "Ids": np.array(
                                       [[4, 5], [-1, 0]], np.int32)},
                                   {"padding_idx": -1}),
    **{f"cast_saturate_{dt}": ("cast", {"X": np.array(
        [3e9, -3e9, np.nan, 300.7, -300.7, 2.5, -2.5, np.inf, -np.inf],
        np.float32)}, {"out_dtype": np.dtype(dt)})
       for dt in ("int8", "int16", "int32", "int64", "uint8")},
    # the next re-anchor probe's four faults, on its inputs
    "gelu_int": ("gelu", {"X": np.array([0, 1, -3, 7], np.int32)},
                 {"approximate": False}),
    "gelu_bool": ("gelu", {"X": np.array([True, False, True])}, {}),
    **{f"softmax_{dt}": ("softmax", {"X": np.array(
        [[0, 1, 3, 7], [2, 200 if dt == "uint8" else 2, 0, 1]], dt)},
        {"axis": -1}) for dt in ("int8", "int32", "uint8")},
    **{f"squared_l2_norm_{dt}": ("squared_l2_norm", {"X": np.array(
        [[0, 1, 3, 7], [2, 200 if dt == "uint8" else 12, 0, 1]], dt)}, {})
       for dt in ("int8", "int32", "uint8", "bool")},
    # the Transformer NMT's label-smoothing chain: reduce_max, exp, log
    **{f"reduce_max_{k}": ("reduce_max", {"X": x}, a)
       for k, (x, a) in _MAX_CASES.items()},
    **{f"{op}_{k}": (op, {"X": x}, {})
       for op in ("exp", "log") for k, x in _UNARY_CASES.items()},
    # the training-breadth slice: what the learning-rate schedules and
    # the meta-optimizers emit, over f32 (NaN, infinities, -0.0), int32,
    # bool and bf16 inputs, jnp's promotions between them
    **{f"{op}_{k}": (op, {"X": x}, {})
       for op in ("abs", "floor", "ceil", "round", "cos", "sin",
                  "reciprocal", "rsqrt", "square")
       for k, x in _UNARY_CASES.items() if (op, k) != ("rsqrt", "int")},
    **{f"{op}_bool": (op, {"X": np.array([True, False, True])}, {})
       for op in ("abs", "floor", "ceil", "cos", "square", "reciprocal")},
    "pow_half": ("pow", {"X": np.abs(_f(3, 4)) + 0.1}, {"factor": 0.5}),
    "pow_neg": ("pow", {"X": np.abs(_f(3, 4)) + 0.1}, {"factor": -0.5}),
    "pow_int_float_factor": ("pow", {"X": np.array([1, 2, -3], np.int32)},
                             {"factor": 2.0}),
    "pow_int_int_factor": ("pow", {"X": np.array([1, 2, -3], np.int32)},
                           {"factor": 3}),
    "pow_bf16": ("pow", {"X": _Bf16(np.abs(_f(3, 4)))}, {"factor": 2.0}),
    **{f"{op}_{k}": (op, ins, {"axis": -1})
       for op in ("elementwise_min", "elementwise_max", "elementwise_mod",
                  "elementwise_floordiv", "elementwise_pow")
       for k, ins in {
           "f32": {"X": _f(3, 4), "Y": np.abs(_f(3, 4)) + 0.5},
           "neg_divisor": {"X": _f(3, 4) * 4, "Y": -np.abs(_f(4)) - 0.5},
           "int": {"X": np.array([[7, -7, 3], [0, 5, -9]], np.int32),
                   "Y": np.array([[2, 3, -4], [5, 2, 2]], np.int32)},
           "int_f32": {"X": np.array([3, -7, 2], np.int32),
                       "Y": np.array([1.5, 2.0, 0.5], np.float32)},
           "bf16": {"X": _bf16(2, 3), "Y": _Bf16(np.abs(_f(2, 3)) + 0.5)},
           "bf16_f32": {"X": _bf16(2, 3), "Y": np.abs(_f(2, 3)) + 0.5},
       }.items() if not (op == "elementwise_pow"
                         and k in ("neg_divisor", "int"))},
    # an int to a negative int power is undefined in jnp
    "elementwise_pow_int": ("elementwise_pow", {
        "X": np.array([[7, -7, 3], [0, 5, -9]], np.int32),
        "Y": np.array([[2, 3, 0], [5, 1, 2]], np.int32)}, {}),
    "elementwise_min_nan_ties": ("elementwise_min", {
        "X": np.array([1.0, np.nan, 2.0, -0.0], np.float32),
        "Y": np.array([1.0, 0.0, np.nan, 0.0], np.float32)}, {}),
    "elementwise_max_axis": ("elementwise_max",
                             {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    **{f"{op}_{k}": (op, ins, {})
       for op in ("equal", "not_equal", "less_than", "less_equal",
                  "greater_than", "greater_equal", "maximum", "minimum")
       for k, ins in {
           "f32": {"X": np.array([1.0, 2.0, np.nan, -0.0, 3.0], np.float32),
                   "Y": np.array([1.0, 3.0, np.nan, 0.0, 2.0], np.float32)},
           "int_f32": {"X": np.array([1, 2, 3], np.int32),
                       "Y": np.array([1.0, 2.5, 2.5], np.float32)},
           "bf16": {"X": _bf16(3, 4), "Y": _bf16(3, 4)},
           "broadcast": {"X": np.array([[1, 2], [3, 4]], np.int32),
                         "Y": np.array([2], np.int32)},
       }.items()},
    **{f"{op}_{k}": (op, ins, {})
       for op in ("logical_and", "logical_or", "logical_xor")
       for k, ins in {
           "bool": {"X": np.array([True, True, False, False]),
                    "Y": np.array([True, False, True, False])},
           "f32": {"X": np.array([1.0, 0.0, -2.0, 0.0], np.float32),
                   "Y": np.array([3.0, 0.0, 0.0, np.nan], np.float32)},
       }.items()},
    "logical_not_bool": ("logical_not", {"X": np.array([True, False])}, {}),
    "logical_not_int": ("logical_not", {"X": np.array([0, 3, -1],
                                                      np.int32)}, {}),
    "allclose_true": ("allclose", {"Input": np.array([1.0, 2.0], np.float32),
                                   "Other": np.array([1.0, 2.0 + 1e-6],
                                                     np.float32)}, {}),
    "allclose_false_nan": ("allclose", {
        "Input": np.array([1.0, np.nan], np.float32),
        "Other": np.array([1.0, np.nan], np.float32)},
        {"rtol": 1e-5, "atol": 1e-8}),
    "allclose_equal_nan": ("allclose", {
        "Input": np.array([1.0, np.nan], np.float32),
        "Other": np.array([1.0, np.nan], np.float32)}, {"equal_nan": True}),
    "where_step_cond": ("where", {"Condition": np.array([True]),
                                  "X": _f(3, 4), "Y": _f(3, 4)}, {}),
    "where_step_cond_false": ("where", {"Condition": np.array([False]),
                                        "X": _bf16(2, 4), "Y": _bf16(2, 4)},
                              {}),
    "where_mask_mixed": ("where", {"Condition": _f(3, 4) > 0,
                                   "X": _bf16(3, 4), "Y": _f(3, 4)}, {}),
    "where_int_cond": ("where", {"Condition": np.array([0, 2, -1],
                                                       np.int32),
                                 "X": np.array([1, 2, 3], np.int32),
                                 "Y": np.array([7.0, 8.0, 9.0],
                                               np.float32)}, {}),
}

# ROADMAP C1-C5, the five faults of the edge-case probe: zero divisors, bool
# operands, matmul's alpha in Out's dtype, bool products
_I32 = np.array([5, -5, 0, 7], np.int32)
_BOOL = np.array([True, False, True, True])
_SMALL = np.random.default_rng(21)
EDGE = {
    "elementwise_floordiv_f32_by_zero": ("elementwise_floordiv", {
        "X": np.array([5.0, -5.0, 0.0, np.inf, -np.inf, 3.0], np.float32),
        "Y": np.array([0.0, -0.0, 0.0, 0.0, -0.0, 2.0], np.float32)}, {}),
    "elementwise_floordiv_bf16_by_zero": ("elementwise_floordiv", {
        "X": _Bf16(np.array([5.0, -5.0, 0.0, 3.0], np.float32)),
        "Y": _Bf16(np.array([0.0, 0.0, 0.0, 2.0], np.float32))}, {}),
    **{f"elementwise_{op}_{t}_by_zero": (f"elementwise_{op}", {
        "X": _I32.astype(t), "Y": np.array([0, 0, 0, 2], t)}, {})
       for op in ("mod", "floordiv") for t in ("int32", "int8")},
    **{f"elementwise_{op}_uint8_by_zero": (f"elementwise_{op}", {
        "X": np.array([5, 0, 255, 7], np.uint8),
        "Y": np.array([0, 0, 0, 2], np.uint8)}, {})
       for op in ("mod", "floordiv")},
    **{f"elementwise_{op}_bool": (f"elementwise_{op}", {
        "X": _BOOL, "Y": np.array([True, True, False, True])}, {})
       for op in ("mod", "floordiv")},
    "matmul_int_alpha_half": ("matmul", {
        "X": np.arange(6, dtype=np.int32).reshape(2, 3),
        "Y": np.arange(6, dtype=np.int32).reshape(3, 2) - 2},
        {"alpha": 0.5}),
    "matmul_int_alpha_neg": ("matmul", {
        "X": np.arange(6, dtype=np.int32).reshape(2, 3),
        "Y": np.ones((3, 2), np.int32)}, {"alpha": -1.5}),
    # integer-valued bf16: every sum is exact, only alpha's rounding shows
    **{f"matmul_bf16_alpha_{a}": ("matmul", {
        "X": _Bf16(_SMALL.integers(-3, 4, (4, 8, 64)).astype(np.float32)),
        "Y": _Bf16(_SMALL.integers(-3, 4, (4, 64, 8)).astype(np.float32))},
        {"alpha": a}) for a in (0.3, 0.1)},
    "matmul_bool": ("matmul", {"X": np.ones((2, 3), bool),
                               "Y": np.ones((3, 2), bool)}, {}),
    "matmul_bool_t": ("matmul", {
        "X": np.array([[True, False, True], [False, False, False]]),
        "Y": np.array([[True, False, False], [False, True, False]])},
        {"transpose_Y": True}),
    "mul_bool": ("mul", {
        "X": np.array([[[True, False], [False, False]],
                       [[False, True], [True, True]]]),
        "Y": np.array([[False, True, True], [True, False, True]])},
        {"x_num_col_dims": 2, "y_num_col_dims": 1}),
}
# paths the repairs rewrote, which the parent already got right
EDGE_KEPT = {
    **{f"elementwise_{op}_int_min_by_minus_one": (f"elementwise_{op}", {
        "X": np.array([-2 ** 31, 7, -7], np.int32),
        "Y": np.array([-1, -1, -1], np.int32)}, {})
       for op in ("mod", "floordiv")},
    # uint8 has no -1 for the signed rule to catch (torch reads 255 as -1)
    **{f"elementwise_{op}_uint8_by_255": (f"elementwise_{op}", {
        "X": np.array([5, 254, 255], np.uint8),
        "Y": np.array([255, 255, 255], np.uint8)}, {})
       for op in ("mod", "floordiv")},
    "mul_int8_wraps":("mul", {"X": np.full((2, 64), 5, np.int8),
                               "Y": np.full((64, 3), 3, np.int8)}, {}),
}
EMIT.update(EDGE)
EMIT.update(EDGE_KEPT)


def _as(ins, conv):
    def one(a):
        if not isinstance(a, _Bf16):
            return conv(a)
        if conv is torch.as_tensor:
            return torch.as_tensor(a.a).to(torch.bfloat16)
        return jnp.asarray(a.a, jnp.bfloat16)

    return {k: [one(a) for a in (v if isinstance(v, list) else [v])]
            for k, v in ins.items()}


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax(name):
    op, ins, attrs = EMIT[name]
    j = jreg.get(op).emit(jreg.EmitContext(), _as(ins, jnp.asarray),
                          dict(attrs))
    t = treg.get(op).emit(treg.EmitContext(), _as(ins, torch.as_tensor),
                          dict(attrs))
    assert sorted(t) == sorted(j)
    tol = MM_TOL if op in ("mul", "matmul", "fused_multihead_attention") \
        else TOL
    for slot in j:
        for a, b in zip(j[slot], t[slot]):
            a = np.asarray(a)
            assert tuple(b.shape) == a.shape, slot
            if b.dtype == torch.bfloat16:  # numpy has no bf16 of its own
                assert a.dtype == jnp.bfloat16, slot
                a, b = a.astype(np.float32), b.float()
            assert tdtypes.from_torch_dtype(b.dtype) == a.dtype, slot
            np.testing.assert_allclose(b.numpy(), a, atol=tol, rtol=0)


@pytest.mark.parametrize("name", sorted(EDGE) + sorted(EDGE_KEPT))
def test_edge_case_emitters_match_jax_exactly(name):
    """C1-C5: dtype, shape and every value equal to the JAX emitter's,
    bf16 bit for bit, NaN where it has NaN (of any sign)."""
    op, ins, attrs = {**EDGE, **EDGE_KEPT}[name]
    j = jreg.get(op).emit(jreg.EmitContext(), _as(ins, jnp.asarray),
                          dict(attrs))["Out"][0]
    t = treg.get(op).emit(treg.EmitContext(), _as(ins, torch.as_tensor),
                          dict(attrs))["Out"][0]
    a = np.asarray(j)
    assert tuple(t.shape) == a.shape
    if t.dtype == torch.bfloat16:  # NaN's sign and payload are the host's
        assert a.dtype == jnp.bfloat16
        nan = np.isnan(a.astype(np.float32))
        np.testing.assert_array_equal(t.isnan().numpy(), nan)
        np.testing.assert_array_equal(t.view(torch.int16).numpy()[~nan],
                                      a.view(np.int16)[~nan])
        return
    assert tdtypes.from_torch_dtype(t.dtype) == a.dtype
    np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("name", ["elementwise_add_axis", "mul", "slice",
                                  "layer_norm_fused", "attention_full_bias",
                                  "fill_constant_int64", "reduce_sum_int",
                                  "cast_int64_narrows", "reduce_sum_uint8",
                                  "gather_axis1_fill", "cast_saturate_int8",
                                  "lookup_table_v2_past_table",
                                  "reduce_max_all_keep", "reduce_max_int",
                                  "exp_int", "log_f32",
                                  "squared_l2_norm_uint8",
                                  "squared_l2_norm_bool", "softmax_uint8",
                                  "gelu_int", "cos_int", "square_bool",
                                  "pow_int_float_factor",
                                  "elementwise_mod_int_f32",
                                  "elementwise_max_axis",
                                  "less_than_broadcast", "logical_or_f32",
                                  "allclose_true", "where_mask_mixed"])
def test_shape_inference_matches_jax(name):
    op, ins, attrs = EMIT[name]
    metas = {k: [(a.shape, a.dtype) for a in v]
             for k, v in _as(ins, np.asarray).items()}
    assert (treg.abstract_eval(op, metas, attrs, 3)
            == jreg.abstract_eval(op, metas, attrs, 3))


@pytest.mark.parametrize("bounds", [(-0.5, 0.5), (-0.5, None), (None, 0.5),
                                    (0.2, 0.2)])
def test_clip_gradient_matches_jax_vjp(bounds):
    """clip's cotangent where x sits on a bound is half, as jnp.clip's
    lax.max / lax.min tie rule gives it."""
    x = np.array([-0.5, 0.5, 0.2, 1.0, -2.0, 0.0], np.float32)
    g = _f(6)
    attrs = {"min": bounds[0], "max": bounds[1]}

    def jclip(a):
        return jreg.get("clip").emit(jreg.EmitContext(), {"X": [a]},
                                     dict(attrs))["Out"][0]

    out, vjp = jax.vjp(jclip, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    got = treg.get("clip").emit(treg.EmitContext(), {"X": [xt]},
                                dict(attrs))["Out"][0]
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=0, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["reduce_max_ties_dim1",
                                  "reduce_max_ties_dim0_keep",
                                  "reduce_max_all", "reduce_max_neg_dim",
                                  "exp_f32", "log_f32", "log_rand"])
def test_max_exp_log_gradients_match_jax_vjp(case):
    """The gradients of reduce_max (split evenly between tied maxima, NaN
    over a row whose max is NaN, even over a row of -inf), exp and log
    (infinities and NaN included) against jax.vjp of the JAX emitters."""
    op, ins, attrs = EMIT[case]
    x = ins["X"]

    def jfn(a):
        return jreg.get(op).emit(jreg.EmitContext(), {"X": [a]},
                                 dict(attrs))["Out"][0]

    out, vjp = jax.vjp(jfn, jnp.asarray(x))
    g = np.random.default_rng(3).standard_normal(out.shape).astype(
        np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    got = treg.get(op).emit(treg.EmitContext(), {"X": [xt]},
                            dict(attrs))["Out"][0]
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("op", ["sign", "softmax"])
def test_bool_input_raises_type_error_as_in_jax(op):
    """jnp.sign refuses a bool X, and so does jax.nn.softmax's x - max:
    the port raises TypeError where the reference does."""
    x = np.array([[True, False, True]])
    with pytest.raises(TypeError):
        jreg.get(op).emit(jreg.EmitContext(), {"X": [jnp.asarray(x)]}, {})
    with pytest.raises(TypeError, match="bool"):
        treg.get(op).emit(treg.EmitContext(), {"X": [torch.as_tensor(x)]},
                          {})


@pytest.mark.parametrize("op,x,err", [
    ("rsqrt", np.array([1, 4], np.int32), TypeError),
    ("rsqrt", np.array([True, False]), TypeError),
    ("round", np.array([True, False]), ValueError)])
def test_integer_rsqrt_and_bool_round_raise_as_in_jax(op, x, err):
    with pytest.raises(err):
        jreg.get(op).emit(jreg.EmitContext(), {"X": [jnp.asarray(x)]}, {})
    with pytest.raises(err):
        treg.get(op).emit(treg.EmitContext(), {"X": [torch.as_tensor(x)]},
                          {})


@pytest.mark.parametrize("case", [
    "cos_f32", "sin_rand", "reciprocal_rand", "rsqrt_rand", "square_f32",
    "abs_rand", "floor_rand", "round_rand", "pow_half", "pow_neg",
    "elementwise_min_nan_ties", "elementwise_max_axis",
    "elementwise_min_f32", "elementwise_pow_f32", "elementwise_mod_f32",
    "elementwise_mod_neg_divisor", "maximum_f32", "minimum_f32",
    "where_step_cond", "where_mask_mixed"])
def test_training_breadth_gradients_match_jax_vjp(case):
    """The gradients of the schedule and meta-optimizer math (min / max
    split at a tie, NaN and -0.0 included; pow, mod, where) against
    jax.vjp of the JAX emitters, with respect to every float input."""
    op, ins, attrs = EMIT[case]
    names = sorted(k for k, v in ins.items()
                   if not isinstance(v, _Bf16) and v.dtype.kind == "f")
    jins = _as(ins, jnp.asarray)

    def jfn(*args):
        return jreg.get(op).emit(jreg.EmitContext(),
                                 dict(jins, **{n: [a] for n, a in
                                               zip(names, args)}),
                                 dict(attrs))["Out"][0]

    out, vjp = jax.vjp(jfn, *[jins[n][0] for n in names])
    g = np.random.default_rng(4).standard_normal(out.shape).astype(
        np.float32)
    want = vjp(jnp.asarray(g, out.dtype))
    tins = _as(ins, torch.as_tensor)
    leaves = {n: tins[n][0].requires_grad_() for n in names}
    got = treg.get(op).emit(treg.EmitContext(), tins, dict(attrs))["Out"][0]
    got.backward(torch.as_tensor(g).to(got.dtype))
    for n, w in zip(names, want):
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(w),
                                   atol=TOL, rtol=1e-6, err_msg=n)


def test_sign_keeps_negative_zero_and_has_a_zero_gradient():
    """jnp.sign(-0.0) is -0.0 (the EMIT case cannot see the sign bit), and
    its gradient is zero everywhere, NaN and zeros included."""
    x = np.array([np.nan, -0.0, 0.0, 2.0, -3.0], np.float32)
    want = np.asarray(jnp.sign(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_()
    got = treg.get("sign").emit(treg.EmitContext(), {"X": [xt]},
                                {})["Out"][0]
    np.testing.assert_array_equal(np.signbit(got.detach().numpy()),
                                  np.signbit(want))
    got.sum().backward()
    assert not xt.grad.any()


def _lookup_vjp_case():
    w = _f(5, 3)
    ids = np.array([[4, 7], [-1, 0], [2, 4]], np.int32)  # 7: past the table
    return w, ids, _f(3, 2, 3)


def test_lookup_gradient_past_table_matches_jax_vjp():
    """An id past the table reads a NaN row and sends no gradient; a
    negative id wraps and sends it to the wrapped row (jax.vjp of the
    reference emitter)."""
    w, ids, g = _lookup_vjp_case()

    def jlookup(a):
        return jreg.get("lookup_table_v2").emit(
            jreg.EmitContext(), {"W": [a], "Ids": [jnp.asarray(ids)]},
            {"padding_idx": -1})["Out"][0]

    out, vjp = jax.vjp(jlookup, jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    wt = torch.as_tensor(w).requires_grad_()
    got = treg.get("lookup_table_v2").emit(
        treg.EmitContext(), {"W": [wt], "Ids": [torch.as_tensor(ids)]},
        {"padding_idx": -1})["Out"][0]
    got.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    assert np.isnan(got.detach().numpy()[0, 1]).all()
    np.testing.assert_allclose(wt.grad.numpy(), want, atol=TOL, rtol=0)


def test_gather_gradient_past_the_end_matches_jax_vjp():
    x = _f(6, 2)
    idx = np.array([-1, 6, 2, 5], np.int32)
    g = _f(4, 2)

    def jgather(a):
        return jreg.get("gather").emit(
            jreg.EmitContext(), {"X": [a], "Index": [jnp.asarray(idx)]},
            {})["Out"][0]

    _, vjp = jax.vjp(jgather, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.as_tensor(x).requires_grad_()
    got = treg.get("gather").emit(
        treg.EmitContext(), {"X": [xt], "Index": [torch.as_tensor(idx)]},
        {})["Out"][0]
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("rows,axis", [(2, 0), (8, 1), (9, 0), (50, 1)])
def test_ordered_index_sum_matches_jax_vjp(rows, axis):
    """The card's fixed-order embedding gradient (masked sums for a table
    of at most ``_SMALL_TABLE_ROWS`` rows, the sorted ``index_put_``
    above), run here on CPU tensors: ``jax.vjp`` of the reference
    ``gather`` within TOL, and the same bits on a second call."""
    from paddle_tpu_torch.ops import manipulation

    shape = (rows, 3) if axis == 0 else (2, rows, 3)
    x = _f(*shape)
    idx = np.random.default_rng(rows).integers(0, rows, 40).astype(np.int32)
    gshape = list(shape)
    gshape[axis] = idx.size
    g = _f(*gshape)

    def jgather(a):
        return jreg.get("gather").emit(
            jreg.EmitContext(), {"X": [a], "Index": [jnp.asarray(idx)]},
            {"axis": axis})["Out"][0]

    _, vjp = jax.vjp(jgather, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    runs = [manipulation.ordered_index_sum(
        shape, axis, torch.as_tensor(idx, dtype=torch.int64),
        torch.as_tensor(g)) for _ in range(2)]
    np.testing.assert_allclose(runs[0].numpy(), want, atol=TOL, rtol=0)
    assert torch.equal(runs[0], runs[1])


def test_uint8_sum_is_uint32_in_the_ir():
    """jnp.sum of uint8 gives uint32; the port's IR carries it both ways.
    torch keeps only casts, views and copies for uint32 (no add, no sum),
    the gap ROADMAP.md section C records."""
    assert tdtypes.to_torch_dtype("uint32") is torch.uint32
    assert tdtypes.from_torch_dtype(torch.uint32) == np.dtype("uint32")
    out = treg.get("reduce_sum").emit(
        treg.EmitContext(), {"X": [torch.full((4, 100), 255, dtype=torch.uint8)]},
        {"dim": [1]})["Out"][0]
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), np.full(4, 25500, np.uint32))


def test_dropout_training_draws_from_the_step_generator():
    x = torch.ones(64, 64)
    attrs = {"dropout_prob": 0.5, "is_test": False,
             "dropout_implementation": "upscale_in_train"}

    def run(seed):
        return treg.get("dropout").emit(treg.EmitContext(seed=seed),
                                        {"X": [x]}, attrs)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["Out"][0], b["Out"][0])
    assert not torch.equal(a["Out"][0], c["Out"][0])
    kept = a["Mask"][0].bool()
    assert torch.equal(a["Out"][0][kept], torch.full_like(x, 2.0)[kept])
    assert 0.4 < kept.float().mean().item() < 0.6


def test_random_init_ops_draw_the_right_distributions():
    ctx = treg.EmitContext(seed=3)
    shape = {"shape": [200, 200], "dtype": np.dtype("float32")}
    u = treg.get("uniform_random").emit(ctx, {}, dict(shape, min=-2.0,
                                                      max=1.0))["Out"][0]
    n = treg.get("gaussian_random").emit(ctx, {}, dict(shape, mean=1.0,
                                                       std=2.0))["Out"][0]
    t = treg.get("truncated_gaussian_random").emit(
        ctx, {}, dict(shape, mean=0.0, std=0.02))["Out"][0]
    assert -2.0 <= u.min() and u.max() < 1.0 and abs(u.mean() + 0.5) < 0.02
    assert abs(n.mean() - 1.0) < 0.03 and abs(n.std() - 2.0) < 0.03
    assert t.abs().max() <= 0.04 + 1e-7
    # a normal truncated at 2 sigma has std 0.8796 sigma
    assert abs(t.std().item() / 0.02 - 0.8796) < 0.01


def test_emit_context_seeds():
    a, b = treg.EmitContext(seed=5), treg.EmitContext(seed=5)
    x1 = torch.rand(4, generator=a.rng())
    x2 = torch.rand(4, generator=a.rng())
    assert torch.equal(x1, torch.rand(4, generator=b.rng()))
    assert not torch.equal(x1, x2)
    s1 = torch.rand(4, generator=a.salted_rng(7))
    assert torch.equal(s1, torch.rand(4, generator=b.salted_rng(7)))
    assert treg.EmitContext(device="meta").rng() is None
    assert 0 <= treg.mix_seed(2 ** 64 - 1, 2 ** 40) < 2 ** 63


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _counter_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [4], "float32")
        w = L.create_parameter([4], "float32", name="w",
                               default_initializer=fluid.initializer.
                               Constant(2.0))
        y = L.elementwise_mul(x, w)
        drop = L.dropout(y, 0.5)
    return main, startup, y, drop


def test_executor_runs_startup_and_main_on_cpu():
    main, startup, y, _ = _counter_program(tfluid)
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    assert exe.run(startup, scope=scope) == []
    w = scope.find_var("w")
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    out, w_fetch = exe.run(main, feed={"x": np.ones((2, 4), np.float64)},
                           fetch_list=[y, "w"], scope=scope)
    assert out.dtype == np.float32  # feed cast to the var's dtype
    np.testing.assert_array_equal(out, np.full((2, 4), 2.0, np.float32))
    np.testing.assert_array_equal(w_fetch, np.full(4, 2.0, np.float32))


def test_executor_refuses_uninitialized_state():
    main, _, y, _ = _counter_program(tfluid)
    with pytest.raises(RuntimeError, match="startup"):
        tfluid.Executor(device="cpu").run(
            main, feed={"x": np.ones((1, 4))}, fetch_list=[y],
            scope=tfluid.Scope())


def test_executor_step_seed_advances_and_repeats():
    main, startup, _, drop = _counter_program(tfluid)
    exe = tfluid.Executor(device="cpu")
    feed = {"x": np.ones((64, 4), np.float32)}

    def two_steps():
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        return [exe.run(main, feed=feed, fetch_list=[drop], scope=scope)[0]
                for _ in range(2)]

    a, b = two_steps(), two_steps()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])


def test_executor_frees_each_var_after_its_last_use():
    """A training step drops every var from its env after the last op
    that reads or writes it, and keeps what goes back to the scope and
    what is fetched; the fetched values are those of a run that frees
    nothing."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tnn.fc(tfluid.layers.data("x", [4, 8], "float32",
                                      append_batch_size=False), 16)
        h = tfluid.layers.relu(x)
        loss = tnn.reduce_mean(tnn.fc(h, 1))
        tfluid.optimizer.AdamOptimizer(1e-2).minimize(loss)
    exe, scope = tfluid.Executor(device="cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32)}
    plan, env, fetches, _ = exe._step(main, feed, [loss, h], scope)
    kept = set(plan.state_out) | {loss.name, h.name}
    touched = {n for op in plan.ops
               for n in op.input_names() + op.output_names()}
    assert set(env) == kept | (set(feed) - touched)
    freed = {n for names in plan.free_after for n in names}
    assert freed == touched - kept
    assert x.name in freed and h.name not in freed
    ops = plan.ops
    for i, names in enumerate(plan.free_after):
        for n in names:
            assert not any(n in op.input_names() + op.output_names()
                           for op in ops[i + 1:]), n
    ctx = treg.EmitContext(seed=scope._rng_seed or 0, device="cpu")
    full = {n: scope.find_var(n) for n in plan.state_in if n not in feed}
    full.update({k: torch.as_tensor(v) for k, v in feed.items()})
    with torch.no_grad():
        treg.emit_ops(ctx, ops, full)
    for got, name in zip(fetches, (loss.name, h.name)):
        assert torch.equal(got, full[name].detach()), name


def test_scope_from_numpy_narrows_to_runtime_dtypes():
    scope = tfluid.Scope.from_numpy(
        {"a": np.arange(3, dtype=np.int64), "b": np.ones(2, np.float64),
         "c": np.ones((2, 2), np.float32)}, device="cpu")
    assert scope.find_var("a").dtype == torch.int32
    assert scope.find_var("b").dtype == torch.float32
    assert scope.find_var("c").shape == (2, 2)


def test_dtypes_mirror_the_jax_package():
    from paddle_tpu.fluid import dtypes as jd

    for spec in ("float32", "int64", "int32", "bool", "uint8", np.float64,
                 np.dtype("int16")):
        assert tdtypes.convert_dtype(spec) == jd.convert_dtype(spec)
        assert tdtypes.runtime_dtype(spec) == jd.runtime_dtype(spec)
    assert tdtypes.convert_dtype(torch.int32) == np.dtype("int32")
    assert tdtypes.to_torch_dtype("float32") is torch.float32
    # bfloat16: the port's own IR dtype (numpy has none), named as JAX's
    bf16 = tdtypes.convert_dtype("bfloat16")
    assert tdtypes.dtype_name(bf16) == jd.dtype_name("bfloat16")
    assert tdtypes.is_floating(bf16) and jd.is_floating("bfloat16")
    assert tdtypes.convert_dtype(jd.convert_dtype("bfloat16")) is bf16
    assert tdtypes.to_torch_dtype(bf16) is torch.bfloat16
    assert tdtypes.from_torch_dtype(torch.bfloat16) is bf16
    assert tdtypes.runtime_dtype(bf16) is bf16
    with pytest.raises(TypeError, match="no torch dtype"):
        tdtypes.to_torch_dtype("U4")
