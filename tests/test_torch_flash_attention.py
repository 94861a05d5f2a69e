"""The port's BSH flash attention (the plain PyTorch versions, the ones
CPU tensors take) against the JAX package's: the Pallas BSH kernels in
interpret mode (``attention.FORCE_PALLAS``, as tests/test_flash_bsh.py
runs them), its ``_flash_fwd_bsh`` forward with the lse, and the
gradients of its custom VJP (``jax.vjp``) against the port's autograd
Function, with bias and causal, and with dropout from the same explicit
uint8 keep mask on both sides.  Also the dispatch gates against the JAX
package's, and the CUDA wrappers' input checks, which refuse what the
kernels do not take.  float16 (float16 AMP): the BSH kernels take it on
their wgmma route; the plain forward and backward in f16 against the
JAX kernels on f16 inputs, each held at one f16 ulp (2^-10).

Tolerances: o 2e-6 and lse 2e-5 in f32 (the same math; the Pallas kernel
sums its online softmax tile by tile, torch in one pass, and the lse is
a log of a sum of up to 128 terms of size up to e^4); gradients 1e-5
(sums over up to 256 terms of products of two such quantities).
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
O_TOL, LSE_TOL, GRAD_TOL = 2e-6, 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _f32_state(monkeypatch):
    """What both sides of every comparison here read, pinned against
    state another test in the same worker may leave: torch's float32
    matmul precision (at "medium" a CPU with bf16 units runs the plain
    versions' f32 matmuls in bf16, far past these limits), and
    the JAX BSH tile choice (``_resolve_bsh_blocks``: PADDLE_FLASH_BLOCK
    and the autotune flag with its cache).  Each is restored afterwards."""
    from paddle_tpu.fluid import flags as jflags

    precision = torch.get_float32_matmul_precision()
    autotune = jflags.get_flags(["FLAGS_kernel_autotune"])
    torch.set_float32_matmul_precision("highest")
    jflags.set_flags({"FLAGS_kernel_autotune": False})
    monkeypatch.delenv("PADDLE_FLASH_BLOCK", raising=False)
    yield
    jflags.set_flags(autotune)
    torch.set_float32_matmul_precision(precision)


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setattr(jax_attention, "FORCE_PALLAS", True)


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


def _grid(rng, shape, step, top):
    """Random multiples of ``step`` in [-top, top]: bf16-exact values
    whose products and sums here are exact in f32 in any order."""
    n = int(round(top / step))
    return torch.as_tensor(rng.integers(-n, n + 1, shape) * step,
                           dtype=torch.float32)


def _rows_past(a, w, n, ulp=2.0 ** -7):
    """Rows of ``a`` (last dim n) with an element past 1e-5 + ulp |w|
    (one bf16 ulp by default)."""
    a = np.asarray(a, np.float32).reshape(-1, n)
    w = np.asarray(w, np.float32).reshape(a.shape)
    return int((np.abs(a - w) > 1e-5 + ulp * np.abs(w)).any(1).sum())


BF16_FWD = {
    # key bias, causal, head dim, dropout p (from a shared mask)
    "none_d64": (False, False, 64, 0.0),
    "none_causal_d64": (False, True, 64, 0.0),
    "key_d64": (True, False, 64, 0.0),
    "key_causal_d64": (True, True, 64, 0.0),
    "none_d128": (False, False, 128, 0.0),
    "none_causal_d128": (False, True, 128, 0.0),
    "key_d128": (True, False, 128, 0.0),
    "key_causal_d128": (True, True, 128, 0.0),
    "key_mask_d64": (True, False, 64, 0.2),
    "none_mask_causal_d128": (False, True, 128, 0.2),
}


@pytest.mark.parametrize("case", sorted(BF16_FWD))
def test_bf16_rounds_once_from_f32_math(case, force_pallas):
    """bf16 o and lse of the port's plain forward against
    ``_flash_fwd_bsh`` (``_make_fwd_bsh_kernel`` in interpret mode) on the
    same bf16 inputs: both compute the scores and the softmax in f32 and
    round p c once, to bf16, before P.V.  S = 128 is one JAX key block, so
    JAX's running max is the row's max and both round the same p.  The
    inputs lie on coarse grids, so S is exact in any summation order;
    what is left is the two libraries' exp, an f32 ulp apart for some
    arguments, which where it straddles a bf16 boundary rounds one p to
    its neighbour.  So o is held within one bf16 ulp (rtol 2^-7) plus
    1e-5 save at most 2 of its 512 rows of D, the lse within 2e-5; P.V of
    the unrounded p is shown to miss that limit in more than half the
    rows."""
    key_bias, causal, d, p = BF16_FWD[case]
    b, nh = 2, 2
    rng = np.random.default_rng(21)
    q, k, v = (_grid(rng, (b, S, nh * d), 1 / 8, 2).to(torch.bfloat16)
               for _ in range(3))
    bias = None
    if key_bias:
        pad = torch.as_tensor(rng.random((b, 1, 1, S)) > 0.8)
        bias = torch.where(pad, -1e4, _grid(rng, (b, 1, 1, S), 1 / 16, 2))
    mask = (torch.as_tensor(rng.random((b, nh, S, S)) > p).to(torch.uint8)
            if p else None)
    sm = 1.0 / math.sqrt(d)
    assert jfa._resolve_bsh_blocks(S, S, nh * d, jnp.bfloat16)[:2] == (S, S)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    o_j, lse_j = jfa._flash_fwd_bsh(
        j(q), j(k), j(v),
        None if bias is None else jnp.asarray(bias.numpy().reshape(b, 1, S)),
        None if mask is None else jnp.asarray(mask.numpy()), None, None,
        sm_scale=sm, nh=nh, causal=causal, dropout_prob=p)
    o_t, lse_t = fa.flash_attention_bsh_fwd(q, k, v, bias, num_heads=nh,
                                            causal=causal, dropout_prob=p,
                                            mask=mask)
    assert o_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    assert fa.bsh_fwd_route(q.dtype) == "tc"
    o_j = np.asarray(o_j.astype(jnp.float32))
    assert _rows_past(o_t.float().numpy(), o_j, d) <= 2
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=LSE_TOL, rtol=0)
    # the limit tells the rounding from its absence
    p_num, m, l_safe = fa.bsh_fwd_probs_reference(
        q, k, bias, nh, sm, causal, mask, 1.0 - p)
    sc = fa._scores(q, k, bias, nh, sm, causal)
    pr = torch.exp(sc - m)
    if mask is not None:
        pr = torch.where(mask != 0, pr / (1.0 - p), 0.0)
    assert torch.equal(p_num, pr.to(torch.bfloat16).float())
    unrounded = torch.matmul(pr, fa._heads(v, b, S, nh)) / l_safe
    unrounded = unrounded.transpose(1, 2).reshape(b, S, nh * d)
    assert _rows_past(unrounded.numpy(), o_j, d) > 256


def test_plain_forward_products_of_tiles_are_the_plain_forward():
    """o from a tiled forward's intermediates
    (``bsh_fwd_products_reference``: p c rounded relative to the running
    max of each 64-key tile, scaled by exp(m_t - lse)) equals the plain
    forward's within f32 rounding when the p c are the plain version's
    own (the tiles' running max then the row's max), with a key bias, a
    keep mask and a rectangular Skv."""
    x = _inputs(22, b=2, sq=128, skv=256, bias=True)
    q, k, v, bias = (torch.as_tensor(x[n]) for n in ("q", "k", "v", "bias"))
    mask = torch.as_tensor(np.random.default_rng(23).random(
        (2, NH, 128, 256)) > 0.1).to(torch.uint8)
    sm = 1.0 / math.sqrt(D)
    p_num, m, l_safe = fa.bsh_fwd_probs_reference(q, k, bias, NH, sm,
                                                  mask=mask, keep_div=0.9)
    o, lse = fa.flash_attention_bsh_reference(q, k, v, bias, NH, sm,
                                              dropout_prob=0.1, mask=mask,
                                              keep_div=0.9)
    m_tiles = m.expand(2, NH, 128, 256 // fa.KERNEL_ROWS)
    got = fa.bsh_fwd_products_reference(v, p_num, m_tiles, lse, NH)
    assert got.shape == o.shape
    np.testing.assert_allclose(got.numpy(), o.numpy(), atol=O_TOL, rtol=0)


# the ids the cases had while float16 took the SIMT route (the kernel
# refused it then)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt"),
                                         (torch.float16, "tc")],
                         ids=["dtype0-tc", "dtype1-simt", "dtype2-simt"])
def test_forward_route_by_dtype(dtype, route):
    """Row 4 on the wgmma kernel for bf16 and f16 (its f16 form); f32
    (which tensor cores would round to TF32) stays on the SIMT kernel."""
    assert fa.bsh_fwd_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_a_cpu_forward_counts_no_launch_on_either_route(dtype):
    x = _good(dtype=dtype)
    n0 = (fa.flash_attention_bsh.launches, fa.flash_attention_bsh.launches_tc)
    o, lse, bits, checks = fa.flash_attention_bsh_fwd(
        **x, return_bits=True, return_probs=True)
    assert o.dtype == dtype and bits is None and checks is None
    o2, lse2 = fa.flash_attention_bsh_fwd(**x, causal=True)
    assert o2.dtype == dtype and lse2.shape == (2, 2, 128)
    assert (fa.flash_attention_bsh.launches,
            fa.flash_attention_bsh.launches_tc) == n0


class _Dev:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "fwd_tc_launch"),
                                         (torch.float32, "launch")])
def test_forward_launches_by_route_and_never_falls_back(dtype, entry,
                                                        monkeypatch):
    """On the card row 4 goes through its route's library entry:
    ``flash_attention_bsh_fwd_tc_launch`` for bf16 (the wgmma kernel, two
    check outputs: p c bf16 [B, nh, Sq, Skv] and the running max [B, nh,
    Sq, Skv / 64], NEG_INF where a tile is skipped, passed only with
    ``return_probs``), ``flash_attention_bsh_launch`` for f32;
    ``launches_tc`` counts the tensor-core launches.  A launch that
    fails raises and counts nothing: nothing retries it on the SIMT
    kernel or the plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    x = _good(dtype=dtype)
    n0 = (fa.flash_attention_bsh.launches, fa.flash_attention_bsh.launches_tc)
    tc = dtype == torch.bfloat16
    o, lse, bits, checks = fa._cuda_flash_bsh(
        x["q"], x["k"], x["v"], x["bias"], 2, 0.125, False, 0.0, None, None,
        0, False, return_probs=True)
    (name, args), = calls
    assert name == entry and len(args) == (25 if tc else 23)
    assert args[14] == fa._DTYPE_CODES[dtype] and bits is None
    assert o.shape == x["q"].shape and lse.shape == (2, 2, 128)
    assert (fa.flash_attention_bsh.launches,
            fa.flash_attention_bsh.launches_tc) == (n0[0] + 1, n0[1] + tc)
    if tc:
        p_out, m_out = checks
        assert p_out.shape == (2, 2, 128, 128) and p_out.dtype == dtype
        assert m_out.shape == (2, 2, 128, 2) and bool(
            (m_out == fa.NEG_INF).all())
        assert args[22:24] == (p_out.data_ptr(), m_out.data_ptr())
        calls.clear()
        fa._cuda_flash_bsh(x["q"], x["k"], x["v"], x["bias"], 2, 0.125,
                           False, 0.0, None, None, 0, False)
        assert calls[0][1][22:24] == (None, None)
    else:
        assert checks is None

    calls.clear()
    monkeypatch.setattr(fa, "_launcher", lambda name: lambda *a: (
        calls.append(name) or 700))
    n1 = (fa.flash_attention_bsh.launches, fa.flash_attention_bsh.launches_tc)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa._cuda_flash_bsh(x["q"], x["k"], x["v"], x["bias"], 2, 0.125,
                           False, 0.0, None, None, 0, False)
    assert calls == [entry]
    assert (fa.flash_attention_bsh.launches,
            fa.flash_attention_bsh.launches_tc) == n1


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
                                dict(sq=64, skv=64),
                                dict(dtype=torch.float16)],
                         ids=["d64", "d128", "d256", "bf16", "rect", "s64",
                              "f16"])
def test_kernel_check_accepts_supported_inputs(kw):
    fa.check_kernel_inputs(**_good(**kw))
    x = _good(**kw)
    x["bias"] = x["bias"][:, 0]  # [B, 1, Skv]
    fa.check_kernel_inputs(**x)
    x["bias"] = None
    fa.check_kernel_inputs(**x, causal=x["q"].shape[1] == x["k"].shape[1])


BAD = {
    "q_float64": lambda x: x.update(q=x["q"].double()),
    # float16 is a kernel dtype (float16 AMP): f16 q beside f32 k, v is not
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


def test_kernel_check_accepts_dropout():
    fa.check_kernel_inputs(**_good(), dropout_prob=0.1)
    x = _good()
    mask = torch.ones(2, 2, 128, 128, dtype=torch.uint8)
    fa.check_kernel_inputs(**x, dropout_prob=0.1, mask=mask)
    for bad in (mask.float(), mask[:, :1], mask.transpose(2, 3)):
        with pytest.raises(ValueError, match="mask"):
            fa.check_kernel_inputs(**x, dropout_prob=0.1, mask=bad)
    with pytest.raises(ValueError, match="dropout_prob"):
        fa.check_kernel_inputs(**x, dropout_prob=1.0)


def _jax_vjp(x, cot, *, causal=False, dropout_prob=0.0, mask=None):
    """o and (dq, dk, dv) of the JAX package's BSH custom VJP."""
    import jax

    bias = x.get("bias")
    b, sq = x["q"].shape[:2]
    skv = x["k"].shape[1]
    core = jfa._make_flash_core_bsh(sm_scale=1.0 / math.sqrt(D), nh=NH,
                                    causal=causal,
                                    dropout_prob=dropout_prob)
    jb = None if bias is None else jnp.asarray(bias.reshape(b, 1, skv))
    jm = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v):
        return core(q, k, v, jb, jm, None, None)

    o, vjp = jax.vjp(fn, *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_grads(x, cot, **kw):
    leaves = [torch.as_tensor(x[n]).requires_grad_() for n in "qkv"]
    bias = x.get("bias")
    o = fa.flash_attention_bsh(
        *leaves, None if bias is None else torch.as_tensor(bias),
        num_heads=NH, **kw)
    grads = torch.autograd.grad(o, leaves, torch.as_tensor(cot))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_vjp(case, force_pallas):
    kw = CASES[case]
    x = _inputs(6, b=2, bias=kw["bias"])
    cot = np.random.default_rng(7).standard_normal((2, S, H)).astype(
        np.float32)
    o_j, g_j = _jax_vjp(x, cot, causal=kw["causal"])
    o_t, g_t = _torch_grads(x, cot, causal=kw["causal"])
    np.testing.assert_allclose(o_t, o_j, atol=O_TOL, rtol=0)
    for name, a, b in zip("qkv", g_j, g_t):
        np.testing.assert_allclose(b, a, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dropout_with_the_same_mask_matches_jax(causal, force_pallas):
    x = _inputs(8, b=2, bias=True)
    rng = np.random.default_rng(9)
    mask = (rng.random((2, NH, S, S)) > 0.2).astype(np.uint8)
    cot = rng.standard_normal((2, S, H)).astype(np.float32)
    o_j, g_j = _jax_vjp(x, cot, causal=causal, dropout_prob=0.2, mask=mask)
    o_t, g_t = _torch_grads(x, cot, causal=causal, dropout_prob=0.2,
                            mask=torch.as_tensor(mask))
    np.testing.assert_allclose(o_t, o_j, atol=O_TOL, rtol=0)
    for name, a, b in zip("qkv", g_j, g_t):
        np.testing.assert_allclose(b, a, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")
    o_nodrop, _ = _torch_grads(x, cot, causal=causal)
    assert not np.allclose(o_t, o_nodrop)


def test_bias_gets_no_gradient():
    x = _inputs(10, b=2, bias=True)
    leaves = [torch.as_tensor(x[n]).requires_grad_() for n in "qkv"]
    bias = torch.as_tensor(x["bias"]).requires_grad_()
    o = fa.flash_attention_bsh(*leaves, bias, num_heads=NH)
    grads = torch.autograd.grad(o.sum(), leaves + [bias], allow_unused=True)
    assert grads[3] is None and all(g is not None for g in grads[:3])


def test_plain_backward_refuses_philox_without_the_mask():
    x = _good()
    o, lse = fa.flash_attention_bsh_fwd(x["q"], x["k"], x["v"], x["bias"],
                                        num_heads=2)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention_bsh_bwd(x["q"], x["k"], x["v"], x["bias"], o,
                                   lse, o, 2, dropout_prob=0.1,
                                   dropout_seed=5)


def test_dropout_threshold_matches_jax():
    for keep in (0.0, 0.5, 0.9, 0.999, 1.0, 0.12345):
        assert fa.dropout_quantized_thresh(keep) == \
            jfa._dropout_quantized_thresh(keep)


def test_bounds_count_the_work():
    x = _good(b=8, sq=512, skv=512, nh=12, d=64)
    q, k, v, bias = x["q"], x["k"], x["v"], x["bias"]
    assert fa.bound_flops(q, k, 12) == 4 * 8 * 12 * 512 * 512 * 64
    assert fa.bound_flops(q, k, 12, causal=True) == 4 * 8 * 12 * (
        512 * 513 // 2) * 64
    act = 8 * 512 * 768 * 4
    assert fa.bound_bytes(q, k, v, bias, 12) == (4 * act + 8 * 512 * 4
                                                 + 8 * 12 * 512 * 4)


def test_backward_bounds_count_the_work():
    x = _good(b=8, sq=512, skv=512, nh=12, d=64)
    q, k, v, bias = x["q"], x["k"], x["v"], x["bias"]
    # 10 * B * nh * S^2 * D: 16.1 GFLOP at BERT-base's shapes
    assert fa.bound_flops_bwd(q, k, 12) == 16_106_127_360
    act = 8 * 512 * 768 * 4
    assert fa.bound_bytes_bwd(q, k, v, bias, 12) == (
        8 * act + 8 * 512 * 4 + 8 * 12 * 512 * 4)


def test_launch_counter_counts_only_kernel_launches():
    x = _good()
    n0 = (fa.flash_attention_bsh.launches,
          fa.flash_attention_bsh_bwd.launches)
    q = x["q"].requires_grad_()
    o = fa.flash_attention_bsh(q, x["k"], x["v"], x["bias"], num_heads=2)
    o.sum().backward()
    # CPU: the plain versions
    assert (fa.flash_attention_bsh.launches,
            fa.flash_attention_bsh_bwd.launches) == n0


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_plain_backward_rounds_as_the_tpu_kernel(causal, force_pallas):
    """bf16 dq/dk/dv of the port's plain backward against the JAX kernel
    ``_flash_bwd_bsh`` (interpret mode), both fed the same bf16 q, k, v,
    dO, o and f32 lse: both round p c and ds to bf16 before the dv, dk
    and dq products and sum in f32, so they agree to one bf16 ulp of the
    output (rtol 2^-7) plus 1e-5; the f32 products of unrounded p and ds
    miss that by up to 5e-3."""
    b = 2
    rng = np.random.default_rng(3)
    x = {n: torch.as_tensor(rng.standard_normal((b, S, H)),
                            dtype=torch.float32).to(torch.bfloat16)
         for n in ("q", "k", "v", "do")}
    bias = np.where(rng.random((b, 1, 1, S)) > 0.25, 0.0, -1e4).astype(
        np.float32)
    tb = torch.as_tensor(bias)
    # o and lse of the f32 forward (o rounded once to bf16): any o and
    # lse will do, both backwards take the same
    o, lse = fa.flash_attention_bsh_fwd(x["q"].float(), x["k"].float(),
                                        x["v"].float(), tb, num_heads=NH,
                                        causal=causal)
    o = o.bfloat16()
    got = fa.flash_attention_bsh_bwd(x["q"], x["k"], x["v"], tb, o, lse,
                                     x["do"], NH, causal=causal)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    res = (j(x["q"]), j(x["k"]), j(x["v"]),
           jnp.asarray(bias.reshape(b, 1, S)), None, None, None, j(o),
           jnp.asarray(lse.numpy()))
    want = jfa._flash_bwd_bsh(res, j(x["do"]), sm_scale=1.0 / math.sqrt(D),
                              nh=NH, causal=causal, dropout_prob=0.0)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), w, atol=1e-5,
                                   rtol=2.0 ** -7, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt"),
                                         (torch.float16, "tc")])
def test_backward_route_by_dtype(dtype, route):
    """The wgmma pair takes bf16 and f16 (its f16 form); f32 stays on the
    SIMT pair, which tensor cores would round to TF32."""
    assert fa.bsh_bwd_route(dtype) == route


def test_cpu_backward_counts_no_launch_on_either_route():
    x = _good(dtype=torch.bfloat16)
    n0 = (fa.flash_attention_bsh_bwd.launches,
          fa.flash_attention_bsh_bwd.launches_tc)
    q = x["q"].requires_grad_()
    o = fa.flash_attention_bsh(q, x["k"], x["v"], x["bias"], num_heads=2)
    o.float().sum().backward()
    assert q.grad is not None and q.grad.dtype == torch.bfloat16
    assert (fa.flash_attention_bsh_bwd.launches,
            fa.flash_attention_bsh_bwd.launches_tc) == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_is_its_intermediates_through_the_products(dtype):
    """The split the card's check uses: ``bwd_probs_reference`` (p c, ds
    rounded to the dtype) through ``bwd_products_reference`` is the plain
    backward, bit for bit; the intermediates are [B, nh, Sq, Skv] values
    of the dtype."""
    rng = np.random.default_rng(4)
    x = {n: torch.as_tensor(rng.standard_normal((2, 128, 128)),
                            dtype=torch.float32).to(dtype)
         for n in ("q", "k", "v")}
    x["bias"] = torch.as_tensor(np.where(rng.random((2, 1, 1, 128)) > 0.2,
                                         0.0, -1e4), dtype=torch.float32)
    mask = torch.as_tensor(rng.random((2, 2, 128, 128)) > 0.1).to(
        torch.uint8)
    do = torch.as_tensor(rng.standard_normal(x["q"].shape),
                         dtype=torch.float32).to(dtype)
    o, lse = fa.flash_attention_bsh_fwd(x["q"], x["k"], x["v"], x["bias"],
                                        num_heads=2, dropout_prob=0.1,
                                        mask=mask)
    args = (x["q"], x["k"], x["v"], x["bias"], o, lse, do, 2)
    p_num, ds = fa.bwd_probs_reference(*args, mask=mask, keep_div=0.9)
    assert p_num.shape == ds.shape == (2, 2, 128, 128)
    for t in (p_num, ds):
        assert torch.equal(t, t.to(dtype).float())
    got = fa.bwd_products_reference(x["q"], x["k"], x["v"], do, p_num, ds, 2)
    want = fa.flash_attention_bsh_bwd_reference(*args, mask=mask,
                                                keep_div=0.9)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_unaligned_rows_are_copied_for_the_kernels():
    t = torch.zeros(17, dtype=torch.bfloat16)
    assert fa._aligned(t) is t
    v = t[1:]
    assert v.data_ptr() % 16 and fa._aligned(v).data_ptr() % 16 == 0
    assert torch.equal(fa._aligned(v), v)


@pytest.mark.parametrize("d,sq,want", [(64, 512, (4, 12, 8)),
                                       (64, 192, (2, 12, 8)),
                                       (128, 512, (8, 12, 8)),
                                       (256, 64, (2, 12, 8))],
                         ids=["infer", "ragged", "d128", "d256"])
def test_simt_forward_grid(d, sq, want):
    """One 256-thread block a query tile of ``SIMT_FWD_TILES`` (a ragged
    last tile included), head and batch row; each thread's tile of O
    (BQ / 16 rows x D / 8 columns) is 64 floats at every D, and at D = 64
    8 x 8, as is its tile of S (BQ / 16 x BK / 16)."""
    assert fa.simt_fwd_grid(8, sq, 12, d) == want
    bq, bk = fa.SIMT_FWD_TILES[d]
    assert bq % 16 == 0 and bk % 32 == 0
    assert (bq // 16) * (d // 8) == 64
    if d == 64:
        assert (bq // 16, bk // 16) == (8, 8)


def test_infer_grid_ends_on_a_nearly_full_wave():
    # BERT-base infer: 8 x 512, 12 heads of 64 -> 384 blocks, one an SM
    blocks = math.prod(fa.simt_fwd_grid(8, 512, 12, 64))
    assert blocks == 384 and 2.9 < blocks / 132 < 3.0


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "fwd_tc_launch"),
                                         (torch.float32, "launch")])
def test_both_forward_routes_get_aligned_rows(dtype, entry, monkeypatch):
    """Both forward kernels cp.async 16-byte rows of q, k, v and the key
    bias: an unaligned tensor reaches either as an aligned copy."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    x = _good(dtype=dtype)
    q = torch.zeros(x["q"].numel() + 1, dtype=dtype)[1:].view(x["q"].shape)
    bias = torch.zeros(2 * 128 + 1)[1:].view(2, 1, 1, 128)
    assert q.data_ptr() % 16 and bias.data_ptr() % 16
    fa._cuda_flash_bsh(q, x["k"], x["v"], bias, 2, 0.125, False, 0.0, None,
                       None, 0, False)
    (name, args), = calls
    assert name == entry
    assert args[0] % 16 == 0 and args[0] != q.data_ptr()
    assert args[3] % 16 == 0 and args[3] != bias.data_ptr()
    assert args[1] == x["k"].data_ptr() and args[2] == x["v"].data_ptr()


F16_FWD = {n: BF16_FWD[n] for n in ("none_causal_d64", "key_d64",
                                    "key_causal_d128", "key_mask_d64")}


@pytest.mark.parametrize("case", sorted(F16_FWD))
def test_f16_rounds_once_from_f32_math(case, force_pallas):
    """float16 o and lse of the port's plain forward against
    ``_flash_fwd_bsh`` (interpret mode) on the same f16 inputs, as the
    bf16 test above: f32 scores and softmax, p c rounded once, to f16,
    before P.V.  o within one f16 ulp (rtol 2^-10) plus 1e-5 save at
    most 2 of its 256 rows of D, the lse within 2e-5; the port rounds p c
    to f16 exactly (``bsh_fwd_probs_reference``)."""
    key_bias, causal, d, p = F16_FWD[case]
    b, nh = 2, 2
    rng = np.random.default_rng(23)
    q, k, v = (_grid(rng, (b, S, nh * d), 1 / 8, 2).to(torch.float16)
               for _ in range(3))
    bias = None
    if key_bias:
        pad = torch.as_tensor(rng.random((b, 1, 1, S)) > 0.8)
        bias = torch.where(pad, -1e4, _grid(rng, (b, 1, 1, S), 1 / 16, 2))
    mask = (torch.as_tensor(rng.random((b, nh, S, S)) > p).to(torch.uint8)
            if p else None)
    sm = 1.0 / math.sqrt(d)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.float16)

    o_j, lse_j = jfa._flash_fwd_bsh(
        j(q), j(k), j(v),
        None if bias is None else jnp.asarray(bias.numpy().reshape(b, 1, S)),
        None if mask is None else jnp.asarray(mask.numpy()), None, None,
        sm_scale=sm, nh=nh, causal=causal, dropout_prob=p)
    o_t, lse_t = fa.flash_attention_bsh_fwd(q, k, v, bias, num_heads=nh,
                                            causal=causal, dropout_prob=p,
                                            mask=mask)
    assert o_t.dtype == torch.float16 and lse_t.dtype == torch.float32
    o_j = np.asarray(o_j.astype(jnp.float32))
    assert _rows_past(o_t.float().numpy(), o_j, d, 2.0 ** -10) <= 2
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=LSE_TOL, rtol=0)
    p_num, m, _ = fa.bsh_fwd_probs_reference(
        q, k, bias, nh, sm, causal, mask, 1.0 - p)
    pr = torch.exp(fa._scores(q, k, bias, nh, sm, causal) - m)
    if mask is not None:
        pr = torch.where(mask != 0, pr / (1.0 - p), 0.0)
    assert torch.equal(p_num, pr.to(torch.float16).float())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_f16_plain_backward_rounds_as_the_tpu_kernel(causal, force_pallas):
    """float16 dq/dk/dv of the port's plain backward against
    ``_flash_bwd_bsh`` (interpret mode) on the same f16 q, k, v, dO, o
    and f32 lse: both round p c and ds to f16 before the products and
    sum in f32.  XLA's exp and torch's differ by an f32 ulp for some
    arguments; where that straddles an f16 boundary one p c or ds rounds
    to its neighbour, which moves the outputs that sum it by one f16 ulp
    of that term (at most 2^-10 of the largest gradient).  So each
    gradient agrees to one f16 ulp (rtol 2^-10) plus 1e-5 save at most
    0.2% of its elements, and every element within 2^-10 of the largest
    |gradient|."""
    b = 2
    rng = np.random.default_rng(5)
    x = {n: torch.as_tensor(rng.standard_normal((b, S, H)),
                            dtype=torch.float32).to(torch.float16)
         for n in ("q", "k", "v", "do")}
    bias = np.where(rng.random((b, 1, 1, S)) > 0.25, 0.0, -1e4).astype(
        np.float32)
    tb = torch.as_tensor(bias)
    o, lse = fa.flash_attention_bsh_fwd(x["q"].float(), x["k"].float(),
                                        x["v"].float(), tb, num_heads=NH,
                                        causal=causal)
    o = o.half()
    got = fa.flash_attention_bsh_bwd(x["q"], x["k"], x["v"], tb, o, lse,
                                     x["do"], NH, causal=causal)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.float16)

    res = (j(x["q"]), j(x["k"]), j(x["v"]),
           jnp.asarray(bias.reshape(b, 1, S)), None, None, None, j(o),
           jnp.asarray(lse.numpy()))
    want = jfa._flash_bwd_bsh(res, j(x["do"]), sm_scale=1.0 / math.sqrt(D),
                              nh=NH, causal=causal, dropout_prob=0.0)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.float16
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(a.float().numpy() - w)
        past = err > 1e-5 + 2.0 ** -10 * np.abs(w)
        assert past.mean() <= 2e-3, (name, past.sum())
        assert err.max() <= 2.0 ** -10 * np.abs(w).max(), name
