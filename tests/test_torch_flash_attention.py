"""The port's BSH flash attention (the plain PyTorch version, the one CPU
tensors take) against the JAX package's: the Pallas BSH kernel in
interpret mode (``attention.FORCE_PALLAS``, as tests/test_flash_bsh.py
runs it) and its ``_flash_fwd_bsh`` forward with the lse, on the same
numpy inputs.  Also the dispatch gates against the JAX package's, and
the CUDA wrapper's input checks, which refuse what the kernel does not
take (dropout included).

Tolerances: o 2e-6 and lse 2e-5 in f32 (the same math; the Pallas kernel
sums its online softmax tile by tile, torch in one pass, and the lse is
a log of a sum of up to 128 terms of size up to e^4).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.kernels import flash_attention as fa

B, S, NH, D = 1, 128, 2, 64
H = NH * D
O_TOL, LSE_TOL = 2e-6, 2e-5


@pytest.fixture
def force_pallas():
    jax_attention.FORCE_PALLAS = True
    yield
    jax_attention.FORCE_PALLAS = False


def _inputs(seed, b=B, sq=S, skv=S, bias=False):
    rng = np.random.default_rng(seed)
    x = {n: (rng.standard_normal((b, s, H)) * 0.5).astype(np.float32)
         for n, s in (("q", sq), ("k", skv), ("v", skv))}
    if bias:
        live = rng.random((b, 1, 1, skv)) > 0.25
        x["bias"] = np.where(live, 0.0, -1e4).astype(np.float32)
    return x


CASES = {"no_bias": dict(bias=False, causal=False),
         "key_bias": dict(bias=True, causal=False),
         "causal": dict(bias=False, causal=True),
         "causal_key_bias": dict(bias=True, causal=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_bsh_forward_o_and_lse(case, force_pallas):
    kw = CASES[case]
    x = _inputs(1, bias=kw["bias"])
    bias = x.get("bias")
    sm_scale = 1.0 / math.sqrt(D)
    o_j, lse_j = jfa._flash_fwd_bsh(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        None if bias is None else jnp.asarray(bias.reshape(B, 1, S)),
        None, None, None, sm_scale=sm_scale, nh=NH, causal=kw["causal"],
        dropout_prob=0.0)
    o_t, lse_t = fa.flash_attention_bsh_fwd(
        torch.as_tensor(x["q"]), torch.as_tensor(x["k"]),
        torch.as_tensor(x["v"]),
        None if bias is None else torch.as_tensor(bias),
        num_heads=NH, causal=kw["causal"])
    assert o_t.shape == (B, S, H) and lse_t.shape == (B, NH, S)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("sq,skv", [(128, 128), (128, 256), (256, 128)])
def test_public_entry_matches_jax(sq, skv, force_pallas):
    x = _inputs(2, b=2, sq=sq, skv=skv, bias=True)
    o_j = jfa.flash_attention_bsh(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["bias"]), num_heads=NH)
    o_t = fa.flash_attention_bsh(
        *(torch.as_tensor(x[n]) for n in ("q", "k", "v", "bias")),
        num_heads=NH)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_TOL,
                               rtol=0)


def test_bf16_rounds_once_from_f32_math():
    x = _inputs(3, bias=True)
    args = [torch.as_tensor(x[n]).bfloat16() for n in ("q", "k", "v")]
    o16, lse16 = fa.flash_attention_bsh_fwd(*args, torch.as_tensor(x["bias"]),
                                            num_heads=NH)
    o32, lse32 = fa.flash_attention_bsh_fwd(*(a.float() for a in args),
                                            torch.as_tensor(x["bias"]),
                                            num_heads=NH)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert torch.equal(o16, o32.bfloat16())
    assert torch.equal(lse16, lse32)


def test_rectangular_causal_is_refused():
    x = _inputs(4, sq=128, skv=256)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_bsh(*(torch.as_tensor(x[n]) for n in "qkv"),
                               num_heads=NH, causal=True)


def test_dropout_on_cpu_draws_from_the_generator():
    x = _inputs(5)
    args = [torch.as_tensor(x[n]) for n in ("q", "k", "v")]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return fa.flash_attention_bsh(*args, num_heads=NH, dropout_prob=0.5,
                                      dropout_generator=g)

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    full = fa.flash_attention_bsh(*args, num_heads=NH)
    assert not torch.equal(run(7), full)


@pytest.mark.parametrize("scale", [1 / 8, 1 / 16, 1 / math.sqrt(128), 0.1,
                                   1.0, 0.5])
def test_prescale_rule_matches_jax(scale):
    assert fa.prescale_ok(scale) == jfa._prescale_ok(scale)


GATE_CASES = [
    # sq, skv, h, nh, bias shape, batch, causal
    (128, 128, 128, 2, None, 2, False),
    (512, 512, 768, 12, (8, 1, 1, 512), 8, False),
    (512, 512, 768, 12, (8, 1, 512), 8, False),
    (256, 128, 256, 2, (2, 1, 1, 128), 2, False),
    (128, 128, 1536, 12, None, 2, True),
    (128, 256, 128, 2, None, 2, True),          # rectangular causal
    (100, 100, 128, 2, None, 2, False),         # S % 128
    (128, 128, 96, 3, None, 2, False),          # D = 32
    (128, 128, 128, 2, (2, 2, 128, 128), 2, False),  # full bias
    (128, 128, 128, 2, (2, 1, 128, 128), 2, False),  # per-query bias
    (128, 128, 128, 2, (3, 1, 1, 128), 2, False),    # bias batch differs
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_bsh_gate_matches_jax(case, force_pallas):
    sq, skv, h, nh, bshape, batch, causal = GATE_CASES[case]
    got = fa.bsh_dispatch_ok(
        sq, skv, h, nh, bias=None if bshape is None else torch.zeros(bshape),
        batch=batch, causal=causal)
    want = jfa.bsh_dispatch_ok(
        sq, skv, h, nh, bias=None if bshape is None else jnp.zeros(bshape),
        batch=batch, causal=causal)
    assert got == want


def test_gate_follows_the_flag():
    from paddle_tpu_torch.fluid.flags import set_flags

    assert fa.flash_shapes_ok(128, 64)
    set_flags({"FLAGS_use_flash_attention": False})
    try:
        assert not fa.flash_shapes_ok(128, 64)
        assert not fa.bsh_dispatch_ok(128, 128, 128, 2)
    finally:
        set_flags({"FLAGS_use_flash_attention": True})


def _good(b=2, sq=128, skv=128, nh=2, d=64, dtype=torch.float32):
    h = nh * d
    return dict(q=torch.zeros(b, sq, h, dtype=dtype),
                k=torch.zeros(b, skv, h, dtype=dtype),
                v=torch.zeros(b, skv, h, dtype=dtype),
                bias=torch.zeros(b, 1, 1, skv), num_heads=nh)


@pytest.mark.parametrize("kw", [dict(), dict(d=128), dict(d=256),
                                dict(dtype=torch.bfloat16), dict(skv=192),
                                dict(sq=64, skv=64)],
                         ids=["d64", "d128", "d256", "bf16", "rect", "s64"])
def test_kernel_check_accepts_supported_inputs(kw):
    fa.check_kernel_inputs(**_good(**kw))
    x = _good(**kw)
    x["bias"] = x["bias"][:, 0]  # [B, 1, Skv]
    fa.check_kernel_inputs(**x)
    x["bias"] = None
    fa.check_kernel_inputs(**x, causal=x["q"].shape[1] == x["k"].shape[1])


BAD = {
    "q_float64": lambda x: x.update(q=x["q"].double()),
    "q_float16": lambda x: x.update(q=x["q"].half()),
    "k_dtype_differs": lambda x: x.update(k=x["k"].bfloat16()),
    "q_2d": lambda x: x.update(q=x["q"][0]),
    "k_v_shapes_differ": lambda x: x.update(v=x["v"][:, :64]),
    "batch_differs": lambda x: x.update(k=x["k"][:1], v=x["v"][:1]),
    "heads_do_not_divide": lambda x: x.update(num_heads=3),
    "head_dim_32": lambda x: x.update(num_heads=4),
    "length_not_64": lambda x: x.update(k=x["k"][:, :96].contiguous(),
                                        v=x["v"][:, :96].contiguous(),
                                        bias=x["bias"][..., :96]),
    "full_bias": lambda x: x.update(bias=torch.zeros(2, 2, 128, 128)),
    "per_query_bias": lambda x: x.update(bias=torch.zeros(2, 1, 128, 128)),
    "q_not_contiguous": lambda x: x.update(
        q=torch.zeros(2, 128, 128).transpose(1, 2)),
    "k_other_device": lambda x: x.update(
        k=torch.zeros(2, 128, 128, device="meta")),
    "rectangular_causal": lambda x: x.update(
        k=torch.zeros(2, 256, 128), v=torch.zeros(2, 256, 128),
        bias=None, causal=True),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_kernel_check_refuses(name):
    x = _good()
    BAD[name](x)
    with pytest.raises(ValueError):
        fa.check_kernel_inputs(**x)


def test_kernel_check_refuses_dropout_until_the_training_slice():
    with pytest.raises(NotImplementedError, match="training slice"):
        fa.check_kernel_inputs(**_good(), dropout_prob=0.1)


def test_bounds_count_the_work():
    x = _good(b=8, sq=512, skv=512, nh=12, d=64)
    q, k, v, bias = x["q"], x["k"], x["v"], x["bias"]
    assert fa.bound_flops(q, k, 12) == 4 * 8 * 12 * 512 * 512 * 64
    assert fa.bound_flops(q, k, 12, causal=True) == 4 * 8 * 12 * (
        512 * 513 // 2) * 64
    act = 8 * 512 * 768 * 4
    assert fa.bound_bytes(q, k, v, bias, 12) == (4 * act + 8 * 512 * 4
                                                 + 8 * 12 * 512 * 4)


def test_launch_counter_counts_only_kernel_launches():
    x = _good()
    n0 = fa.flash_attention_bsh.launches
    fa.flash_attention_bsh(x["q"], x["k"], x["v"], x["bias"], num_heads=2)
    assert fa.flash_attention_bsh.launches == n0  # CPU: the plain version
