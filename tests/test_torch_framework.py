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
}


def _as(ins, conv):
    return {k: [conv(a) for a in (v if isinstance(v, list) else [v])]
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
            assert tdtypes.from_torch_dtype(b.dtype) == a.dtype, slot
            np.testing.assert_allclose(b.numpy(), a, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["elementwise_add_axis", "mul", "slice",
                                  "layer_norm_fused", "attention_full_bias",
                                  "fill_constant_int64", "reduce_sum_int",
                                  "cast_int64_narrows"])
def test_shape_inference_matches_jax(name):
    op, ins, attrs = EMIT[name]
    metas = {k: [(a.shape, a.dtype) for a in v]
             for k, v in _as(ins, np.asarray).items()}
    assert (treg.abstract_eval(op, metas, attrs, 3)
            == jreg.abstract_eval(op, metas, attrs, 3))


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
    with pytest.raises(TypeError, match="bfloat16"):
        tdtypes.convert_dtype("bfloat16")
