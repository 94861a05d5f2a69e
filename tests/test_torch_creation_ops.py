"""The port's ``ops/creation.py`` op types of this slice
(``fill_constant_batch_size_like``, ``shape``, ``range``,
``fill_any_like``, ``eye``, ``linspace``) against the JAX package's
emitters on the CPU, and the MSRA and Bilinear initializers against the
JAX package's.

Every case is exact: dtype, shape, every value bit for bit.  ``range``
with a step is numpy's ``arange`` in the JAX package too, so it is held
against the jitted emitter; ``arange(0, 1, 0.1)`` in float32 ends in
0.90000004 there, where torch.arange gives 0.9.  ``linspace`` is held
bit for bit against the JAX emitter run op by op (``jax.disable_jit``):
jnp's arithmetic as written, which torch.linspace does not repeat (669
of 1001 points differ at -3.3 .. 7.1).  Under ``jax.jit`` XLA's CPU
compiler folds the division by num - 1 into a reciprocal product and
fuses the products into FMAs, so the jitted JAX program's own points
move by up to 3 ulps of the larger bound (an integer dtype's floor by
1); the port is held there within 4.  A constant of an integer dtype
saturates and takes NaN as 0, as lax's convert does at run time, held
against the JAX emitter run op by op (``fill_constant`` repaired: it
raised); under ``jax.jit`` XLA folds such a constant with a C++ cast,
which on x86 gives INT_MIN for NaN and every out-of-range value.  MSRA
draws from the executor's generator, so its
values are held by their law (the bound, the spread) and its op against
the JAX package's; Bilinear's array bit for bit.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as treg
from torch_emit_cases import (Bf16, assert_emit_matches, assert_same,
                              emit_jax, emit_torch, rand,
                              shape_inference_matches)

X = rand(1, 3, 5)

EMIT = {
    "fcbsl": ("fill_constant_batch_size_like", {"Input": X}, {
        "shape": [-1, 4], "value": 2.5, "dtype": "float32"}),
    "fcbsl_idx_int": ("fill_constant_batch_size_like", {"Input": X}, {
        "shape": [2, 1, 7], "value": -3.7, "dtype": "int64",
        "input_dim_idx": 1, "output_dim_idx": 2}),
    "fcbsl_bf16": ("fill_constant_batch_size_like", {"Input": X}, {
        "shape": [1, 2], "value": 0.1, "dtype": "bfloat16"}),
    "shape": ("shape", {"Input": X}, {}),
    "shape_empty_dim": ("shape", {"Input": np.zeros((2, 0, 4), np.int32)},
                        {}),
    "shape_bf16_scalar": ("shape", {"Input": Bf16(np.float32(2.0))}, {}),
    "fill_any_like": ("fill_any_like", {"X": X}, {"value": 1.0}),
    "fill_any_like_int": ("fill_any_like", {"X": X},
                          {"value": -1.5, "dtype": "int32"}),
    "fill_any_like_bool": ("fill_any_like", {"X": X},
                           {"value": 0.5, "dtype": "bool"}),
    "fill_any_like_bf16_in": ("fill_any_like", {"X": Bf16(X)},
                              {"value": 3.3}),
    "fill_any_like_int_in": ("fill_any_like", {"X": np.ones(3, np.int32)},
                             {"value": 7.9}),
    "eye": ("eye", {}, {"num_rows": 3, "num_columns": 5}),
    "eye_square_int64": ("eye", {}, {"num_rows": 4, "dtype": "int64"}),
    "eye_bf16": ("eye", {}, {"num_rows": 2, "num_columns": 1,
                             "dtype": "bfloat16"}),
    "eye_bool": ("eye", {}, {"num_rows": 3, "dtype": "bool"}),
}
# constants an integer dtype cannot hold
SATURATE = {
    "fcbsl": ("fill_constant_batch_size_like", {"Input": X}, {
        "shape": [1], "value": 1e10, "dtype": "int32"}),
    "fill_any_like_int64_huge": ("fill_any_like", {"X": X},
                                 {"value": 1e12, "dtype": "int64"}),
    "fill_any_like_uint8_nan": ("fill_any_like", {"X": X},
                                {"value": float("nan"), "dtype": "uint8"}),
    "fill_any_like_uint8_negative": ("fill_any_like", {"X": X},
                                     {"value": -1.5, "dtype": "uint8"}),
    "fill_constant": ("fill_constant", {}, {
        "shape": [2], "value": -1e10, "dtype": "int32"}),
    "fill_constant_nan": ("fill_constant", {}, {
        "shape": [1, 2], "value": float("nan"), "dtype": "int64"}),
}
RANGE = {
    "f32_tenths": (0.0, 1.0, 0.1, "float32"),
    "f32_irregular": (0.5, 100.0, 0.37, "float32"),
    "f32_negative_step": (10.0, -5.0, -1.5, "float32"),
    "f64_as_f32": (1.0, 1000.0, 7.3, "float64"),
    "int64": (-3.0, 10.0, 3.0, "int64"),
    "int32_fraction": (0.0, 10.0, 2.5, "int32"),
    "empty": (0.0, 0.0, 1.0, "int64"),
    "bf16": (0.0, 3.0, 0.1, "bfloat16"),
}
LINSPACE = {
    "f32": (-3.3, 7.1, 1001, "float32"),
    "f32_tenths": (0.0, 1.0, 11, "float32"),
    "f32_descending": (2.5, -1.25, 64, "float32"),
    "f32_wide": (-100.0, 100.0, 333, "float32"),
    "f64_as_f32": (0.5, 300.7, 997, "float64"),
    "int64": (-100.0, 100.0, 333, "int64"),
    "int32": (0.0, 9.0, 4, "int32"),
    "bf16": (0.001, 5.5, 77, "bfloat16"),
    "one": (3.0, 3.0, 1, "float32"),
    "none": (1.0, 2.0, 0, "float32"),
}


@pytest.mark.parametrize("name", sorted(EMIT))
def test_emitter_matches_jax_exactly(name):
    op, ins, attrs = EMIT[name]
    assert_emit_matches(op, ins, attrs, exact=True)


@pytest.mark.parametrize("name", sorted(SATURATE))
def test_integer_constants_saturate_as_lax_convert(name):
    op, ins, attrs = SATURATE[name]
    with jax.disable_jit():
        j = jreg.get(op).emit(jreg.EmitContext(), {
            k: [jax.numpy.asarray(v)] for k, v in ins.items()}, dict(attrs))
    assert_same(j["Out"][0], emit_torch(op, ins, attrs)["Out"][0],
                exact=True)


@pytest.mark.parametrize("name", sorted(RANGE))
def test_range_matches_jax_exactly(name):
    start, end, step, dt = RANGE[name]
    assert_emit_matches("range", {}, {"start": start, "end": end,
                                      "step": step, "dtype": dt}, exact=True)


@pytest.mark.parametrize("name", sorted(LINSPACE))
def test_linspace_is_jnp_s_arithmetic_bit_for_bit(name):
    start, stop, num, dt = LINSPACE[name]
    attrs = {"start": start, "stop": stop, "num": num, "dtype": dt}
    with jax.disable_jit():
        j = jreg.get("linspace").emit(jreg.EmitContext(), {}, dict(attrs))
    t = emit_torch("linspace", {}, attrs)
    assert_same(j["Out"][0], t["Out"][0], exact=True)
    # against the jitted program: 4 ulps of the larger bound
    jj = np.asarray(emit_jax("linspace", {}, attrs)["Out"][0]).astype(
        np.float64)
    ulp = 1.0 if dt.startswith("int") else 4 * float(
        np.spacing(np.float32(max(abs(start), abs(stop)))))
    if dt == "bfloat16":
        ulp *= 2 ** 16
    np.testing.assert_allclose(t["Out"][0].double().numpy(), jj, rtol=0,
                               atol=ulp)


def test_torch_s_own_arange_and_linspace_answer_otherwise():
    """Why the port does not call them."""
    t = emit_torch("range", {}, {"start": 0.0, "end": 1.0, "step": 0.1,
                                 "dtype": "float32"})["Out"][0]
    assert t[-1].item() == np.float32(0.90000004)
    assert torch.arange(0.0, 1.0, 0.1)[-1].item() == np.float32(0.9)
    with jax.disable_jit():
        j = np.asarray(jreg.get("linspace").emit(jreg.EmitContext(), {}, {
            "start": -3.3, "stop": 7.1, "num": 1001,
            "dtype": "float32"})["Out"][0])
    lib = torch.linspace(-3.3, 7.1, 1001).numpy()
    assert (lib != j).sum() > 500


_SHAPE_CASES = sorted({c[0]: n for n, c in sorted(EMIT.items())}.values())


@pytest.mark.parametrize("name", _SHAPE_CASES)
def test_shape_inference_matches_jax(name):
    op, ins, attrs = EMIT[name]
    shape_inference_matches(op, ins, attrs)


def _build(fluid, body):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [4, 3], "float32", append_batch_size=False)
        body(fluid, L, x)

    def ops(prog):
        return [(op.type, op.inputs, op.outputs,
                 {k: str(v) for k, v in op.attrs.items()
                  if not k.startswith("__")})
                for op in prog.global_block().ops]

    vs = {n: (v.shape, str(v.dtype), v.stop_gradient, v.persistable)
          for n, v in main.global_block().vars.items()}
    return ops(main), ops(startup), vs


LAYERS = {
    "creation": lambda f, L, x: (
        L.ones_like(x), L.full_like(x, 2.5), L.full_like(x, 3, "int32"),
        L.range(0, 10, 2), L.arange(0.5, 3.0, 0.5, "float32"),
        L.linspace(-1, 1, 9), L.linspace(0, 10, 4, "int64"),
        L.eye(3), L.eye(2, 5, "int32"),
        L.fill_constant_batch_size_like(x, [-1, 7], "float32", 1.5),
        L.fill_constant_batch_size_like(x, [2, 1], "int64", 0, 0, 1)),
    "initializers": lambda f, L, x: (
        L.create_parameter([6, 4, 3, 3], "float32",
                           default_initializer=f.initializer.MSRA()),
        L.create_parameter([6, 4, 3, 3], "float32",
                           default_initializer=f.initializer.MSRAInitializer(
                               uniform=False, fan_in=10, seed=3)),
        L.create_parameter([3, 1, 4, 4], "float32",
                           default_initializer=f.initializer.Bilinear()),
        L.create_parameter([2, 2, 3, 5], "float32", default_initializer=(
            f.initializer.BilinearInitializer()))),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_same_ops_as_jax(name):
    assert _build(tfluid, LAYERS[name]) == _build(jfluid, LAYERS[name])


def test_ops_registered():
    assert set(treg.registered_ops()) >= {
        o for o in jreg.registered_ops()
        if jreg.get(o).emit.__module__ == "paddle_tpu.ops.creation"}


def _startup_values(fluid, device=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        LAYERS["initializers"](fluid, fluid.layers, None)
    scope = fluid.Scope()
    exe = fluid.Executor() if device is None else fluid.Executor(
        device=device)
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters()]
    return [np.asarray(scope.find_var(n)) if device is None
            else scope.find_var(n).numpy() for n in names]


def test_msra_and_bilinear_arrays():
    """Bilinear: the JAX package's array bit for bit.  MSRA (the
    executor's generator, not JAX's): uniform within +-sqrt(6 / fan_in)
    and filling it; normal with the std sqrt(2 / fan_in) within 25% on
    216 draws."""
    j = _startup_values(jfluid)
    t = _startup_values(tfluid, "cpu")
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_array_equal(a, b)
    lim = np.sqrt(6.0 / 36)
    assert np.abs(t[0]).max() <= lim and np.abs(t[0]).max() > 0.9 * lim
    assert abs(t[1].std() / np.sqrt(2.0 / 10) - 1) < 0.25
