"""The port's ``ops/manipulation.py`` op types against the JAX package's
emitters on the CPU, on the same numpy inputs from a seed.

* ``EMIT``: every op type of the slice over f32 (with NaN, both
  infinities and -0.0), bf16, int32 and bool inputs where the op takes
  them.  Data movement is held exact: dtype, shape, every value, bf16 bit
  for bit, NaN where the reference has NaN and the sign of every zero.
  ``cumsum`` is arithmetic, but the port adds in the blocked order of
  XLA's CPU scan, so it is held exact too, bf16 over 299 values
  included.
* Shape inference on meta tensors equals the JAX package's.
* Gradients of the differentiable ops against ``jax.vjp`` of the JAX
  emitters (tolerance 2e-6 absolute, 1e-6 relative, f32), among them a
  negative-stride ``strided_slice``, a ``scatter`` with repeated ids and
  ``top_k`` ties; the explicit grad ops (``argsort_grad``, ``top_k_grad``,
  ``top_k_v2_grad``) against the JAX grad ops, exactly.
* The errors the JAX emitters raise, raised alike.
* The ``fluid.layers`` callables over these ops build the same ops,
  attributes, shapes and dtypes as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from torch_emit_cases import (INF, NAN, SPECIAL, Bf16, assert_emit_matches,
                              assert_same, assert_vjp_matches, emit_jax,
                              emit_torch, rand, shape_inference_matches)

I32 = np.array([[3, -7, 3, 0], [-1, 2 ** 31 - 1, -2 ** 31, 5]], np.int32)
BOOL = np.array([[True, False, True, True], [False, False, True, False]])
F3 = rand(1, 2, 3, 4)
BF = Bf16(rand(2, 2, 3, 4))
# ties, NaN, both zeros and infinities along the last axis
TIES = np.array([[3.0, 1.0, 3.0, 2.0, 3.0, -0.0, 0.0],
                 [NAN, INF, -INF, NAN, 0.0, -0.0, 1.0]], np.float32)
# a NaN with its sign bit set (torch's bf16 rounding of a NaN makes one):
# jnp.sort puts every NaN last, lax.top_k this one below -inf
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
SIGNED_NANS = np.array([[1.0, NEG_NAN, -INF, NAN, -0.0, 0.0, INF]],
                       np.float32)
TABLE = rand(3, 5, 3)
IDS = np.array([0, 3, 0, -1, 9, -6, 3], np.int32)   # repeats, wraps, drops
UPD = rand(4, 7, 3)
ND_IDX = np.array([[0, 1], [4, 2], [-1, 0], [0, -1], [5, 0], [2, 9]],
                  np.int32)
CUM = rand(5, 4, 299) * 10


def _each(op, attrs, **xs):
    """One case per input dtype: ``{op}_{kind}`` over X."""
    return {f"{op}_{k}": (op, {"X": x}, attrs) for k, x in xs.items()}


EMIT = {
    **_each("transpose", {"axis": [2, 0, 1]}, f32=F3, bf16=BF),
    **_each("transpose", {"axis": [1, 0]}, int=I32, bool=BOOL),
    "concat_f32": ("concat", {"X": [F3, rand(5, 2, 1, 4)]}, {"axis": 1}),
    "concat_neg_axis": ("concat", {"X": [SPECIAL, SPECIAL]}, {"axis": -1}),
    "concat_bf16": ("concat", {"X": [BF, BF]}, {"axis": 0}),
    "concat_int_bool": ("concat", {"X": [I32, BOOL]}, {"axis": 0}),
    "concat_uint8_int8": ("concat", {"X": [np.array([1, 255], np.uint8),
                                           np.array([-1, 7], np.int8)]},
                          {"axis": 0}),
    "concat_bf16_f32": ("concat", {"X": [BF, F3]}, {"axis": 2}),
    "split_num": ("split", {"X": F3}, {"axis": 2, "num": 2}),
    "split_sections": ("split", {"X": F3}, {"axis": 2, "sections": [1, 3]}),
    "split_sections_minus1": ("split", {"X": SPECIAL},
                              {"axis": 1, "sections": [1, -1]}),
    "split_int": ("split", {"X": I32}, {"axis": 0, "num": 2}),
    "split_bool": ("split", {"X": BOOL}, {"axis": 1, "sections": [3, 1]}),
    "strided_slice": ("strided_slice", {"Input": F3},
                      {"axes": [1, 2], "starts": [0, 1], "ends": [3, 100],
                       "strides": [2, 2]}),
    "strided_slice_neg": ("strided_slice", {"Input": rand(6, 10, 3)},
                          {"axes": [0], "starts": [8], "ends": [1],
                           "strides": [-3]}),
    "strided_slice_neg_all": ("strided_slice", {"Input": SPECIAL},
                              {"axes": [1, 0], "starts": [-1, 5],
                               "ends": [-100, -100], "strides": [-1, -2]}),
    "strided_slice_neg_empty": ("strided_slice", {"Input": I32},
                                {"axes": [1], "starts": [0], "ends": [3],
                                 "strides": [-1]}),
    "strided_slice_bool": ("strided_slice", {"Input": BOOL},
                           {"axes": [1], "starts": [3], "ends": [0],
                            "strides": [-2]}),
    "stack": ("stack", {"X": [F3, F3 * 2]}, {"axis": 1}),
    "stack_neg": ("stack", {"X": [SPECIAL, SPECIAL]}, {"axis": -1}),
    "stack_int_f32": ("stack", {"X": [I32, SPECIAL]}, {"axis": 0}),
    "stack_bf16": ("stack", {"X": [BF, BF]}, {"axis": 3}),
    "unstack": ("unstack", {"X": F3}, {"axis": 1, "num": 3}),
    "unstack_bool": ("unstack", {"X": BOOL}, {"axis": 0}),
    "unbind": ("unbind", {"X": SPECIAL}, {"axis": 1}),
    "unbind_bf16": ("unbind", {"X": BF}, {"axis": -1}),
    "squeeze": ("squeeze", {"X": rand(6, 1, 3, 1)}, {"axes": [0, -1]}),
    "squeeze_all": ("squeeze", {"X": rand(7, 1, 3, 1)}, {"axes": []}),
    "squeeze2": ("squeeze2", {"X": rand(8, 2, 1, 4)}, {"axes": [1, 0]}),
    "squeeze2_int": ("squeeze2", {"X": I32[None]}, {"axes": [0]}),
    "squeeze2_bool": ("squeeze2", {"X": BOOL[:, None]}, {"axes": [1]}),
    "flatten": ("flatten", {"X": F3}, {"axis": 2}),
    "flatten_axis0": ("flatten", {"X": F3}, {"axis": 0}),
    "flatten2": ("flatten2", {"X": F3}, {"axis": 2}),
    "flatten2_bf16": ("flatten2", {"X": BF}, {"axis": 1}),
    "flatten2_int": ("flatten2", {"X": I32[None]}, {"axis": 2}),
    "flatten_contiguous_range": ("flatten_contiguous_range", {"X": F3},
                                 {"start_axis": 1, "stop_axis": -1}),
    "flatten_contiguous_range_0d": ("flatten_contiguous_range",
                                    {"X": np.array(3.0, np.float32)}, {}),
    "flatten_contiguous_range_bool": ("flatten_contiguous_range",
                                      {"X": BOOL[None]},
                                      {"start_axis": 0, "stop_axis": 1}),
    "expand": ("expand", {"X": SPECIAL}, {"expand_times": [2, 3]}),
    "expand_more": ("expand", {"X": I32}, {"expand_times": [2, 1, 2]}),
    "expand_bf16": ("expand", {"X": BF}, {"expand_times": [1, 2, 1]}),
    "expand_v2": ("expand_v2", {"X": rand(9, 3, 1)},
                  {"shape": [2, -1, 4]}),
    "expand_v2_bool": ("expand_v2", {"X": BOOL[:, :1]}, {"shape": [2, 5]}),
    "tile": ("tile", {"X": SPECIAL}, {"repeat_times": [2]}),
    "tile_int": ("tile", {"X": I32}, {"repeat_times": [2, 1, 2]}),
    "tile_bf16": ("tile", {"X": BF}, {"repeat_times": [1, 1, 2]}),
    "gather_nd": ("gather_nd", {"X": TABLE, "Index": ND_IDX}, {}),
    "gather_nd_rows": ("gather_nd", {"X": TABLE,
                                     "Index": IDS[:, None]}, {}),
    "gather_nd_int": ("gather_nd", {"X": I32, "Index": ND_IDX[:3]}, {}),
    "gather_nd_bf16": ("gather_nd", {"X": BF, "Index": ND_IDX[:4]}, {}),
    "scatter_overwrite": ("scatter", {"X": TABLE, "Ids": IDS,
                                      "Updates": UPD}, {"overwrite": True}),
    "scatter_add": ("scatter", {"X": TABLE, "Ids": IDS, "Updates": UPD},
                    {"overwrite": False}),
    "scatter_ids_2d": ("scatter", {"X": TABLE, "Ids": IDS[:, None],
                                   "Updates": UPD}, {}),
    "scatter_add_bf16": ("scatter", {"X": Bf16(TABLE), "Ids": IDS,
                                     "Updates": Bf16(UPD * 100)},
                         {"overwrite": False}),
    "scatter_int": ("scatter", {"X": I32.T.copy(),
                                "Ids": np.array([1, 1, 0], np.int32),
                                "Updates": I32.T[:3] * 3},
                    {"overwrite": False}),
    "scatter_nd_add": ("scatter_nd_add", {"X": TABLE, "Index": ND_IDX,
                                          "Updates": rand(10, 6)}, {}),
    "scatter_nd_add_rows": ("scatter_nd_add", {
        "X": TABLE, "Index": IDS[:, None], "Updates": UPD}, {}),
    "scatter_nd_add_bf16": ("scatter_nd_add", {
        "X": Bf16(TABLE), "Index": np.repeat(ND_IDX[:1], 40, 0),
        "Updates": Bf16(rand(11, 40) * 9)}, {}),
    "pad": ("pad", {"X": SPECIAL}, {"paddings": [1, 0, 2, 3],
                                    "pad_value": -0.5}),
    "pad_int_value_cast": ("pad", {"X": I32}, {"paddings": [0, 1, 1, 1],
                                               "pad_value": 2.7}),
    "pad_bool": ("pad", {"X": BOOL}, {"paddings": [1, 1, 0, 0]}),
    "pad_bf16": ("pad", {"X": BF}, {"paddings": [0, 0, 1, 0, 0, 2],
                                    "pad_value": 0.1}),
    **{f"pad2d_{m}_{fmt}": ("pad2d", {"X": rand(12, 2, 3, 4, 3)},
                            {"paddings": [1, 2, 3, 0], "mode": m,
                             "pad_value": 1.5, "data_format": fmt})
       for m in ("constant", "reflect", "edge") for fmt in ("NCHW", "NHWC")},
    "pad2d_reflect_wide": ("pad2d", {"X": rand(13, 1, 1, 2, 3)},
                           {"paddings": [0, 1, 5, 4], "mode": "reflect"}),
    "pad2d_edge_int": ("pad2d", {"X": I32[None, None]},
                       {"paddings": [1, 1, 2, 2], "mode": "edge"}),
    "pad2d_reflect_bf16": ("pad2d", {"X": Bf16(rand(14, 1, 2, 3, 3))},
                           {"paddings": [2, 1, 1, 2], "mode": "reflect"}),
    **{f"pad3d_{m}_{fmt}": ("pad3d", {"X": rand(15, 1, 2, 3, 4, 3)},
                            {"paddings": [1, 2, 0, 1, 2, 0], "mode": m,
                             "value": -2.0, "data_format": fmt})
       for m in ("constant", "reflect", "replicate", "circular")
       for fmt in ("NCDHW", "NDHWC")},
    "pad3d_circular_wide": ("pad3d", {"X": rand(16, 1, 1, 1, 1, 3)},
                            {"paddings": [4, 5, 0, 0, 0, 0],
                             "mode": "circular"}),
    **_each("arg_max", {"axis": 1}, f32=TIES, bf16=Bf16(TIES), int=I32,
            bool=BOOL),
    **_each("arg_min", {"axis": -1}, f32=TIES, bf16=Bf16(TIES), int=I32,
            bool=BOOL),
    "arg_max_keepdims": ("arg_max", {"X": F3}, {"axis": 0, "keepdims": True}),
    "arg_min_zeros": ("arg_min", {"X": np.array([0.0, -0.0], np.float32)},
                      {"axis": 0}),
    **_each("argsort", {"axis": -1}, f32=TIES, bf16=Bf16(TIES), int=I32,
            bool=BOOL),
    **{f"argsort_desc_{k}": ("argsort", {"X": x},
                             {"axis": 1, "descending": True})
       for k, x in (("f32", TIES), ("bf16", Bf16(TIES)), ("int", I32),
                    ("uint8", np.array([[0, 1, 255, 1]], np.uint8)))},
    "argsort_axis0": ("argsort", {"X": F3}, {"axis": 0}),
    "argsort_signed_nans": ("argsort", {"X": SIGNED_NANS}, {}),
    "argsort_desc_signed_nans": ("argsort", {"X": SIGNED_NANS},
                                 {"descending": True}),
    "top_k_signed_nans": ("top_k", {"X": SIGNED_NANS}, {"k": 7}),
    "top_k_v2_smallest_signed_nans": ("top_k_v2", {"X": SIGNED_NANS},
                                      {"k": 7, "largest": False}),
    **_each("top_k", {"k": 5}, f32=TIES, bf16=Bf16(TIES)),
    **_each("top_k", {"k": 3}, int=I32, bool=BOOL),
    "top_k_3d": ("top_k", {"X": F3}, {"k": 2}),
    "top_k_v2": ("top_k_v2", {"X": TIES}, {"k": 6, "axis": -1}),
    "top_k_v2_smallest": ("top_k_v2", {"X": TIES},
                          {"k": 7, "axis": 1, "largest": False}),
    "top_k_v2_axis0": ("top_k_v2", {"X": F3}, {"k": 1, "axis": 0}),
    "top_k_v2_int_smallest": ("top_k_v2", {"X": I32},
                              {"k": 3, "largest": False}),
    "top_k_v2_bf16": ("top_k_v2", {"X": BF}, {"k": 2, "axis": 1}),
    "cumsum_f32": ("cumsum", {"X": CUM}, {"axis": -1}),
    "cumsum_bf16": ("cumsum", {"X": Bf16(CUM)}, {"axis": 1}),
    "cumsum_bf16_axis0": ("cumsum", {"X": Bf16(CUM.T[:40])}, {"axis": 0}),
    "cumsum_long": ("cumsum", {"X": rand(17, 5000)}, {"axis": 0}),
    "cumsum_special": ("cumsum", {"X": SPECIAL}, {"axis": 1}),
    "cumsum_exclusive": ("cumsum", {"X": np.array([1e8, 1.0, 3.0, -0.0],
                                                  np.float32)},
                         {"exclusive": True}),
    "cumsum_reverse": ("cumsum", {"X": CUM[:2]}, {"reverse": True}),
    "cumsum_reverse_exclusive_bf16": ("cumsum", {"X": Bf16(CUM[:2])},
                                      {"reverse": True, "exclusive": True}),
    "cumsum_flatten": ("cumsum", {"X": F3}, {"flatten": True}),
    "cumsum_int": ("cumsum", {"X": I32}, {"axis": 1}),
    "cumsum_bool": ("cumsum", {"X": BOOL}, {"axis": 1}),
    "cumsum_int8": ("cumsum", {"X": np.full((2, 60), 7, np.int8)}, {}),
    "cumsum_uint8": ("cumsum", {"X": np.full((70,), 9, np.uint8)}, {}),
    **_each("flip", {"axis": [0, 2]}, f32=F3, bf16=BF),
    **_each("flip", {"axis": [-1]}, int=I32, bool=BOOL),
    "roll": ("roll", {"X": F3}, {"shifts": [1, -2], "axis": [0, 2]}),
    "roll_flat": ("roll", {"X": SPECIAL}, {"shifts": [3], "axis": []}),
    "roll_int": ("roll", {"X": I32}, {"shifts": [5], "axis": [1]}),
    "roll_bool_bf16": ("roll", {"X": BOOL}, {"shifts": [-1], "axis": [0]}),
    **{f"tril_triu_{k}_{lo}": ("tril_triu", {"X": x},
                               {"diagonal": d, "lower": lo})
       for k, x, d in (("f32", F3, 1), ("bf16", BF, -1), ("int", I32, 0),
                       ("bool", BOOL, 2)) for lo in (True, False)},
    "diag_v2_vec": ("diag_v2", {"X": rand(18, 3)}, {"offset": 1}),
    "diag_v2_vec_pad": ("diag_v2", {"X": np.array([1, 2], np.int32)},
                        {"offset": -1, "padding_value": 9.5}),
    "diag_v2_mat": ("diag_v2", {"X": SPECIAL}, {"offset": 1}),
    "diag_v2_mat_neg": ("diag_v2", {"X": I32}, {"offset": -1}),
    "diag_v2_bf16": ("diag_v2", {"X": Bf16(rand(19, 4))}, {}),
    "index_select": ("index_select", {"X": TABLE, "Index": IDS[:5]},
                     {"dim": 0}),
    "index_select_dim1": ("index_select", {"X": SPECIAL,
                                           "Index": np.array([3, -1, 0, 4],
                                                             np.int32)},
                          {"dim": 1}),
    "index_select_int": ("index_select", {"X": I32,
                                          "Index": np.array([1, 5, -3],
                                                            np.int32)},
                         {"dim": -1}),
    "index_select_bf16": ("index_select", {"X": BF,
                                           "Index": np.array([2, 0],
                                                             np.int32)},
                          {"dim": 1}),
    "meshgrid": ("meshgrid", {"X": [rand(20, 3), rand(21, 2), rand(22, 4)]},
                 {}),
    "meshgrid_mixed": ("meshgrid", {"X": [np.array([1, 2], np.int32),
                                          np.array([0.5], np.float32)]}, {}),
    "take_along_axis": ("take_along_axis", {
        "Input": SPECIAL, "Index": np.array([[0, 3], [-1, 9]], np.int32)},
        {"Axis": 1}),
    "take_along_axis_bcast": ("take_along_axis", {
        "Input": F3, "Index": np.array([[[1, 0]]], np.int32)}, {"Axis": 2}),
    "take_along_axis_int": ("take_along_axis", {
        "Input": I32, "Index": np.array([[1], [7]], np.int32)}, {"Axis": 1}),
    "take_along_axis_bool": ("take_along_axis", {
        "Input": BOOL, "Index": np.array([[0, 1, 1, 0]], np.int32)},
        {"Axis": 0}),
    "shard_index": ("shard_index", {
        "X": np.array([[-3], [0], [5], [7], [13], [14], [19], [20]],
                      np.int32)},
        {"index_num": 20, "nshards": 3, "shard_id": 1}),
    "shard_index_ignore": ("shard_index", {
        "X": np.arange(-4, 12, dtype=np.int32).reshape(8, 2)},
        {"index_num": 8, "nshards": 2, "shard_id": 0, "ignore_value": -7}),
}


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax_exactly(name):
    op, ins, attrs = EMIT[name]
    assert_emit_matches(op, ins, attrs, exact=True)


# the shapes and dtypes of abstract evaluation, a case of each op type
_SHAPE_CASES = sorted({c[0]: n for n, c in sorted(EMIT.items())}.values())


@pytest.mark.parametrize("name", _SHAPE_CASES)
def test_shape_inference_matches_jax(name):
    op, ins, attrs = EMIT[name]
    shape_inference_matches(op, ins, attrs)


GRAD = {
    "transpose_f32": "Out", "concat_f32": "Out", "split_sections": "Out",
    "strided_slice": "Out", "strided_slice_neg": "Out", "stack": "Y", "unstack": "Y",
    "unbind": "Out", "squeeze": "Out", "squeeze2": "Out", "flatten": "Out",
    "flatten2": "Out", "flatten_contiguous_range": "Out", "expand": "Out",
    "expand_v2": "Out", "tile": "Out", "gather_nd": "Out",
    "scatter_overwrite": "Out", "scatter_add": "Out",
    "scatter_nd_add": "Out", "pad": "Out", "pad2d_reflect_wide": "Out",
    "pad3d_circular_NCDHW": "Out", "cumsum_f32": "Out",
    "cumsum_exclusive": "Out", "cumsum_reverse": "Out",
    "cumsum_long": "Out", "flip_f32": "Out", "roll": "Out",
    "tril_triu_f32_True": "Out", "index_select": "Out", "meshgrid": "Out",
    "take_along_axis": "Result",
}


@pytest.mark.parametrize("name", sorted(GRAD))
def test_gradient_matches_jax_vjp(name):
    """torch autograd through the port's emitter against jax.vjp of the
    JAX emitter, with respect to every f32 input; the multi-output ops
    through their first output."""
    op, ins, attrs = EMIT[name]
    slot = GRAD[name]
    if name == "cumsum_long":   # the backward scans 5000 values as well
        assert_vjp_matches(op, ins, attrs, slot, atol=2e-5, rtol=1e-5)
    else:
        assert_vjp_matches(op, ins, attrs, slot)


# the explicit grad ops: X, Indices from the forward, a cotangent for Out
_GRAD_OPS = {
    "argsort_grad": ("argsort", {"X": TIES}, {"axis": 1,
                                             "descending": True}),
    "argsort_grad_axis0": ("argsort", {"X": F3}, {"axis": 0}),
    "top_k_grad": ("top_k", {"X": TIES}, {"k": 4}),
    "top_k_v2_grad": ("top_k_v2", {"X": F3}, {"k": 2, "axis": 1,
                                              "largest": False}),
}


@pytest.mark.parametrize("name", sorted(_GRAD_OPS))
def test_explicit_grad_ops_match_jax(name):
    """The grad op of each: the forward's Indices and a cotangent of Out
    put back exactly where the JAX grad op puts them (ties included)."""
    op, ins, attrs = _GRAD_OPS[name]
    fwd = emit_jax(op, ins, attrs)
    g = rand(5, *np.asarray(fwd["Out"][0]).shape)
    gins = {"X": ins["X"], "Indices": np.asarray(fwd["Indices"][0]),
            "Out@GRAD": g}
    j = emit_jax(op + "_grad", gins, attrs)["X@GRAD"][0]
    t = emit_torch(op + "_grad", gins, attrs)["X@GRAD"][0]
    assert_same(j, t, exact=True)


def test_top_k_breaks_ties_toward_the_lower_index():
    """lax.top_k([3, 1, 3, 2, 3], 2) is [0, 2]; torch.topk gives [2, 4]."""
    x = np.array([3.0, 1.0, 3.0, 2.0, 3.0], np.float32)
    got = emit_torch("top_k", {"X": x}, {"k": 2})["Indices"][0]
    assert got.tolist() == [0, 2]
    assert np.asarray(emit_jax("top_k", {"X": x},
                               {"k": 2})["Indices"][0]).tolist() == [0, 2]


def test_top_k_gradient_through_the_program_matches_jax():
    """top_k's grad maker in a built program: the tied maxima take their
    gradient at the indices lax.top_k chose, in both packages."""
    x = TIES[:1, :5]

    def run(fluid, exe):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            xv = L.data("x", [5], "float32", append_batch_size=False)
            xv.stop_gradient = False
            w = L.create_parameter([1, 5], "float32", name="w")
            h = L.elementwise_mul(L.reshape(xv, [1, 5]), w)
            vals, _ = L.topk(h, 2)
            loss = L.reduce_sum(L.elementwise_mul(vals, vals))
            grads = fluid.backward.gradients([loss], [w])
        exe.run(startup)
        scope = fluid.global_scope()
        scope.set_var("w", np.ones((1, 5), np.float32))
        return np.asarray(exe.run(main, feed={"x": x.reshape(5)},
                                  fetch_list=grads)[0])

    with jfluid.scope_guard(jfluid.Scope()):
        want = run(jfluid, jfluid.Executor())
    with tfluid.scope_guard(tfluid.Scope()):
        got = run(tfluid, tfluid.Executor(device="cpu"))
    np.testing.assert_allclose(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("op,ins,attrs,err", [
    ("split", {"X": np.arange(5, dtype=np.float32)}, {"num": 2}, ValueError),
    ("squeeze2", {"X": np.ones((1, 2, 1), np.float32)}, {"axes": [0, -3]},
     ValueError),
    ("argsort", {"X": BOOL}, {"descending": True}, TypeError),
    ("top_k_v2", {"X": BOOL}, {"k": 1, "largest": False}, TypeError),
])
def test_raises_as_in_jax(op, ins, attrs, err):
    with pytest.raises(err):
        emit_jax(op, ins, attrs)
    with pytest.raises(err):
        emit_torch(op, ins, attrs)


def test_scatter_repeated_ids_last_update_wins():
    """x.at[ids].set(updates) on the JAX package's CPU: of a repeated id
    the last update wins; an id still outside the table after one wrap
    is dropped."""
    x = np.zeros((3, 1), np.float32)
    ids = np.array([0, 2, 0, -1, 3], np.int32)
    upd = np.arange(1, 6, dtype=np.float32)[:, None]
    got = emit_torch("scatter", {"X": x, "Ids": ids, "Updates": upd}, {})
    assert got["Out"][0].reshape(-1).tolist() == [3.0, 0.0, 4.0]


# ---------------------------------------------------------------------------
# the fluid.layers callables
# ---------------------------------------------------------------------------


def _build(fluid, body):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [2, 3, 4], "float32", append_batch_size=False)
        i = L.data("i", [6], "int32", append_batch_size=False)
        body(L, x, i)
    ops = [(op.type, op.inputs, op.outputs,
            {k: v for k, v in op.attrs.items() if not k.startswith("__")})
           for op in main.global_block().ops]
    vs = {n: (v.shape, v.dtype, v.stop_gradient)
          for n, v in main.global_block().vars.items()}
    return ops, vs


LAYERS = {
    "concat": lambda L, x, i: L.concat([x, x], axis=1),
    "split_num": lambda L, x, i: L.split(x, 2, dim=-1),
    "split_sections": lambda L, x, i: L.split(x, [1, 2], dim=1),
    "stack": lambda L, x, i: L.stack([x, x], axis=1),
    "unstack": lambda L, x, i: L.unstack(x, axis=1),
    "squeeze": lambda L, x, i: L.squeeze(L.unsqueeze(x, [1]), axes=[1]),
    "flatten": lambda L, x, i: L.flatten(x, axis=2),
    "expand": lambda L, x, i: L.expand(x, [1, 2, 1]),
    "gather_nd": lambda L, x, i: L.gather_nd(x, L.reshape(i, [3, 2])),
    "scatter": lambda L, x, i: L.scatter(
        L.reshape(x, [6, 4]), i, L.reshape(x, [6, 4]), overwrite=False),
    "scatter_nd_add": lambda L, x, i: L.scatter_nd_add(
        x, L.reshape(i, [3, 2]), L.gather_nd(x, L.reshape(i, [3, 2]))),
    "pad": lambda L, x, i: L.pad(x, [0, 0, 1, 2, 0, 1], pad_value=1.0),
    "pad2d": lambda L, x, i: L.pad2d(L.unsqueeze(x, [1]), [1, 0, 0, 2],
                                     mode="reflect"),
    "strided_slice": lambda L, x, i: L.strided_slice(x, [1, 2], [2, 3],
                                                     [0, 0], [-1, -2]),
    "topk": lambda L, x, i: L.topk(x, 2),
    "cumsum": lambda L, x, i: (L.cumsum(x), L.cumsum(
        x, axis=1, exclusive=True, reverse=True)),
    "argmax": lambda L, x, i: (L.argmax(x, axis=1), L.argmin(x)),
    "argsort": lambda L, x, i: L.argsort(x, axis=1, descending=True),
    "flip_reverse": lambda L, x, i: (L.flip(x, 1), L.reverse(x, [0, 2])),
    "roll": lambda L, x, i: (L.roll(x, 1), L.roll(x, [1, 2], [1, 2])),
    "tile": lambda L, x, i: L.tile(x, [1, 2, 2]),
    "tril_triu": lambda L, x, i: (L.tril(x, 1), L.triu(x)),
    "diag": lambda L, x, i: L.diag(L.cast(i, "float32")),
    "index_select": lambda L, x, i: L.index_select(x, i, axis=2),
    "take_along_axis": lambda L, x, i: L.take_along_axis(
        x, L.cast(x, "int32"), 2),
    "meshgrid": lambda L, x, i: L.meshgrid(L.cast(i, "float32"), i),
    "shard_index": lambda L, x, i: L.shard_index(i, 20, 2, 1),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_same_ops_as_jax(name):
    """Same ops (types, slots, attributes) and the same vars (shapes,
    dtypes, stop_gradient) as the JAX package's layer."""
    assert _build(tfluid, LAYERS[name]) == _build(jfluid, LAYERS[name])


def test_unbind_layer_builds_where_the_jax_layer_raises():
    """The JAX package's ``unbind`` layer calls ``range(n)`` in a module
    whose own ``range`` layer shadows the builtin, and raises TypeError;
    the port's builds the one ``unbind`` op the JAX layer means to."""
    body = lambda L, x, i: L.unbind(x, 1)  # noqa: E731
    with pytest.raises(TypeError, match="range"):
        _build(jfluid, body)
    ops, vs = _build(tfluid, body)
    outs = [f"unbind_0.tmp_{k}" for k in range(3)]
    assert ops == [("unbind", {"X": ["x"]}, {"Out": outs}, {"axis": 1})]
    assert [vs[n][:2] for n in outs] == [((2, 4), "float32")] * 3


def test_layers_exported():
    names = ("concat", "split", "stack", "unstack", "squeeze", "flatten",
             "expand", "gather_nd", "scatter", "scatter_nd_add", "pad",
             "pad2d", "strided_slice", "topk", "cumsum", "argmax", "argmin",
             "argsort", "flip", "reverse", "roll", "tile", "tril", "triu",
             "diag", "index_select", "take_along_axis", "unbind", "meshgrid",
             "shard_index")
    missing = [n for n in names if not hasattr(tfluid.layers, n)]
    assert not missing
    assert set(treg.registered_ops()) >= {
        o for o in jreg.registered_ops()
        if jreg.get(o).emit.__module__ == "paddle_tpu.ops.manipulation"}
