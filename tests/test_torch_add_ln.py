"""The port's residual-add + LayerNorm (the plain PyTorch version, the one
CPU tensors take) against the JAX package's ``fused_add_ln`` — its Pallas
forward in interpret mode — with and without the residual, and the
``layer_norm`` op emitter's Y / Mean / Variance against the JAX
package's emitter, on the same numpy inputs.  Also the CUDA wrapper's
input checks.

Tolerances (f32): out 2e-6 and the stats 1e-6 (the same math; XLA and
torch sum the row in other orders).  Variance: the port's emitter forms
it from the kernel's rstd as 1/rstd**2 - eps, a few f32 ulps of
var + eps from the direct variance: rtol 2e-6 on var + eps.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu.ops.pallas import add_ln as jax_add_ln
from paddle_tpu_torch.fluid.flags import set_flags
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import add_ln

OUT_TOL, STAT_TOL, VAR_RTOL = 2e-6, 1e-6, 2e-6


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    return dict(x=rng.standard_normal(shape).astype(np.float32),
                y=rng.standard_normal(shape).astype(np.float32),
                scale=(1 + 0.2 * rng.standard_normal(h)).astype(np.float32),
                shift=(0.2 * rng.standard_normal(h)).astype(np.float32))


SHAPES = [(16, 128), (2, 8, 256), (64, 768)]


@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_fused_add_ln(shape, with_y):
    x = _inputs(0, shape)
    y = x["y"] if with_y else None
    want = jax_add_ln.fused_add_ln(
        jnp.asarray(x["x"]), None if y is None else jnp.asarray(y),
        jnp.asarray(x["scale"]), jnp.asarray(x["shift"]), eps=1e-5)
    got = add_ln.fused_add_ln(
        torch.as_tensor(x["x"]), None if y is None else torch.as_tensor(y),
        torch.as_tensor(x["scale"]), torch.as_tensor(x["shift"]), eps=1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL,
                               rtol=0)


@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
def test_stats_match_the_pallas_forward(with_y):
    x = _inputs(1, (32, 256))
    y = x["y"] if with_y else None
    _, mean_j, rstd_j = jax_add_ln._ln_fwd(
        jnp.asarray(x["x"]), None if y is None else jnp.asarray(y),
        jnp.asarray(x["scale"]), jnp.asarray(x["shift"]), eps=1e-5)
    _, mean_t, rstd_t = add_ln.fused_add_ln_fwd(
        torch.as_tensor(x["x"]), None if y is None else torch.as_tensor(y),
        torch.as_tensor(x["scale"]), torch.as_tensor(x["shift"]), eps=1e-5)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j)[0],
                               atol=STAT_TOL, rtol=0)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(rstd_j)[0],
                               atol=STAT_TOL, rtol=0)


def test_bf16_rounds_once_from_f32_stats():
    x = _inputs(2, (16, 128))
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    o16, m16, r16 = add_ln.fused_add_ln_fwd(t["x"].bfloat16(),
                                            t["y"].bfloat16(), t["scale"],
                                            t["shift"])
    o32, m32, r32 = add_ln.fused_add_ln_fwd(t["x"].bfloat16().float(),
                                            t["y"].bfloat16().float(),
                                            t["scale"], t["shift"])
    assert o16.dtype == torch.bfloat16 and m16.dtype == torch.float32
    assert torch.equal(o16, o32.bfloat16())
    assert torch.equal(m16, m32) and torch.equal(r16, r32)


def _emit_both(ins_np, attrs):
    j = jax_registry.get("layer_norm").emit(
        jax_registry.EmitContext(),
        {k: [jnp.asarray(v)] for k, v in ins_np.items()}, dict(attrs))
    t = registry.get("layer_norm").emit(
        registry.EmitContext(),
        {k: [torch.as_tensor(v)] for k, v in ins_np.items()}, dict(attrs))
    return j, t


LN_CASES = {
    # last-axis affine: the fused kernel path of both packages
    "last_axis_affine": ((2, 8, 128), 2, True, True),
    "last_axis_2d": ((16, 256), 1, True, True),
    # the plain f32-stats path of both packages
    "no_shift": ((2, 8, 128), 2, True, False),
    "two_axes": ((2, 4, 8, 32), 2, True, True),
}


@pytest.mark.parametrize("force", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", sorted(LN_CASES))
def test_layer_norm_emitter_matches_jax(case, force):
    shape, axis, with_scale, with_bias = LN_CASES[case]
    x = _inputs(3, shape)
    tail = int(np.prod(shape[axis:]))
    rng = np.random.default_rng(4)
    ins = {"X": x["x"] * 3 + 1}
    if with_scale:
        ins["Scale"] = (1 + 0.2 * rng.standard_normal(tail)).astype(np.float32)
    if with_bias:
        ins["Bias"] = (0.2 * rng.standard_normal(tail)).astype(np.float32)
    attrs = {"epsilon": 1e-5, "begin_norm_axis": axis}
    jax_attention.FORCE_PALLAS = force
    try:
        j, t = _emit_both(ins, attrs)
    finally:
        jax_attention.FORCE_PALLAS = False
    np.testing.assert_allclose(t["Y"][0].numpy(), np.asarray(j["Y"][0]),
                               atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(t["Mean"][0].numpy(), np.asarray(j["Mean"][0]),
                               atol=STAT_TOL * 4, rtol=0)
    var_j = np.asarray(j["Variance"][0])
    np.testing.assert_allclose(t["Variance"][0].numpy() + 1e-5, var_j + 1e-5,
                               atol=0, rtol=VAR_RTOL)
    assert t["Mean"][0].shape == tuple(shape[:axis])


def test_layer_norm_flag_off_takes_the_plain_path(monkeypatch):
    x = _inputs(5, (4, 128))
    ins = {"X": x["x"], "Scale": x["scale"], "Bias": x["shift"]}
    calls = []
    monkeypatch.setattr("paddle_tpu_torch.ops.nn_ops.fused_add_ln_fwd",
                        lambda *a, **k: calls.append(1) or
                        add_ln.fused_add_ln_fwd(*a, **k))
    attrs = {"epsilon": 1e-5, "begin_norm_axis": 1}
    _, on = _emit_both(ins, attrs)
    assert calls == [1]
    set_flags({"FLAGS_use_fused_ln": False})
    try:
        _, off = _emit_both(ins, attrs)
    finally:
        set_flags({"FLAGS_use_fused_ln": True})
    assert calls == [1]
    np.testing.assert_allclose(on["Y"][0].numpy(), off["Y"][0].numpy(),
                               atol=OUT_TOL, rtol=0)


def _good(r=8, h=768, dtype=torch.float32, y=True):
    return dict(x=torch.zeros(r, h, dtype=dtype),
                y=torch.zeros(r, h, dtype=dtype) if y else None,
                scale=torch.ones(h), shift=torch.zeros(h))


@pytest.mark.parametrize("kw", [dict(), dict(y=False), dict(h=4),
                                dict(h=4096), dict(dtype=torch.bfloat16)],
                         ids=["y", "no_y", "h4", "h4096", "bf16"])
def test_kernel_check_accepts_supported_inputs(kw):
    add_ln.check_kernel_inputs(**_good(**kw))


BAD = {
    "x_float64": lambda x: x.update(x=x["x"].double(), y=x["y"].double()),
    "x_float16": lambda x: x.update(x=x["x"].half(), y=x["y"].half()),
    "h_not_multiple_of_4": lambda x: x.update(
        x=torch.zeros(8, 766), y=torch.zeros(8, 766),
        scale=torch.ones(766), shift=torch.zeros(766)),
    "h_too_wide": lambda x: x.update(
        x=torch.zeros(2, 4100), y=torch.zeros(2, 4100),
        scale=torch.ones(4100), shift=torch.zeros(4100)),
    "y_dtype_differs": lambda x: x.update(y=x["y"].bfloat16()),
    "y_shape_differs": lambda x: x.update(y=x["y"][:4]),
    "scale_shape": lambda x: x.update(scale=torch.ones(767)),
    "shift_float64": lambda x: x.update(shift=x["shift"].double()),
    "x_not_contiguous": lambda x: x.update(
        x=torch.zeros(768, 8).t(), y=torch.zeros(768, 8).t()),
    "x_misaligned": lambda x: x.update(
        x=torch.zeros(8 * 768 + 1)[1:].view(8, 768)),
    "y_other_device": lambda x: x.update(
        y=torch.zeros(8, 768, device="meta")),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_kernel_check_refuses(name):
    x = _good()
    BAD[name](x)
    with pytest.raises(ValueError):
        add_ln.check_kernel_inputs(**x)


def test_bounds_count_the_bytes():
    x = torch.zeros(4096, 768)
    act = 4096 * 768 * 4
    assert add_ln.bound_bytes(x, None) == 2 * act + 2 * 4 * 768 + 2 * 4 * 4096
    assert add_ln.bound_bytes(x, x) == 3 * act + 2 * 4 * 768 + 2 * 4 * 4096
    assert add_ln.bound_flops(x, None) == 8 * x.numel()


def test_launch_counter_counts_only_kernel_launches():
    x = _good()
    n0 = add_ln.fused_add_ln.launches
    add_ln.fused_add_ln(**x)
    assert add_ln.fused_add_ln.launches == n0  # CPU: the plain version
