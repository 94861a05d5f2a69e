"""The port's BHSD flash attention (rows 6-9: the plain PyTorch versions,
the ones CPU tensors take) against the JAX package's: the Pallas BHSD
kernels in interpret mode (``_flash_fwd`` for o and the lse,
``flash_attention`` and ``flash_block_with_lse`` and their custom VJPs
through ``jax.vjp``) on the same numpy inputs, B 2, two heads of 64, S
128 (256 for the causal offsets).

Covered: every bias mode and broadcast (none; per key [B,1,1,S] and
[1,1,1,S]; full [B,nh,S,S], [B,1,S,S], [1,nh,S,S], [1,1,S,S]), causal,
causal at (q_offset, k_offset) including a q block that sees no key, the
lse cotangent of ``flash_block_with_lse``, dropout from one shared
explicit keep mask, dbias with ``bias_requires_grad`` on and a zero bias
cotangent without it; the bf16 full-bias backward, which rounds p c and
ds to bf16 as the TPU's split kernels do, against ``_flash_bwd`` (its
own tolerance, in its docstring); the attention op's BHSD branch against
the JAX op with ``FORCE_PALLAS`` on and off; the CUDA wrappers' input
checks, the backward's route (the wgmma kernels for bf16 with a full
bias, no fallback), the bounds at the path's shapes, and the launch
counters (only a kernel launch counts).

Tolerances (f32, the same math in another summation order; the Pallas
kernels sum their online softmax block by block, torch in one pass): o
2e-6, lse 2e-5 (a log of a sum of up to 256 terms of size up to e^5), dq
dk dv 1e-5 (sums over up to 256 products of such terms), dbias 2e-5 (a
key bias sums ds over both heads and all rows as well).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import flash_attention as fa

B, NH, S, D = 2, 2, 128, 64
O_TOL, LSE_TOL, GRAD_TOL, DBIAS_TOL = 2e-6, 2e-5, 1e-5, 2e-5

BIASES = {"none": None, "key": (B, 1, 1, S), "key_shared": (1, 1, 1, S),
          "full": (B, NH, S, S), "full_b1": (B, 1, S, S),
          "full_1h": (1, NH, S, S), "full_11": (1, 1, S, S)}


def _qkv(seed, s=S):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, NH, s, D)) * 0.5).astype(np.float32)
            for _ in range(3)], rng


def _bias(rng, name, s=S):
    shape = BIASES[name]
    if shape is None:
        return None
    shape = tuple(s if n == S else n for n in shape)
    if name.startswith("key"):  # a padding mask with a random offset
        return (np.where(rng.random(shape) > 0.25, 0.0, -1e4)
                + rng.standard_normal(shape)).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, grad=False):
    return None if x is None else torch.as_tensor(x).requires_grad_(grad)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("bias", sorted(BIASES))
def test_plain_forward_matches_jax_o_and_lse(bias, causal):
    (q, k, v), rng = _qkv(1)
    bs = _bias(rng, bias)
    sm_scale = 1.0 / math.sqrt(D)
    biask, mode, dims = jfa._classify_bias(_j(bs), B, NH, S)
    o_j, lse_j = jfa._flash_fwd(
        *(jnp.asarray(x.reshape(B * NH, S, D)) for x in (q, k, v)), biask,
        None, None, None, sm_scale=sm_scale, num_heads=NH, causal=causal,
        dropout_prob=0.0, bias_mode=mode, bias_dims=dims)
    o_t, lse_t = fa.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bs),
                                        causal=causal)
    assert o_t.shape == (B, NH, S, D) and lse_t.shape == (B, NH, S)
    _close(o_t.numpy().reshape(B * NH, S, D), o_j, O_TOL)
    _close(lse_t.numpy().reshape(B * NH, 1, S), lse_j, LSE_TOL)
    # the kernel's bias form: never a broadcast copy
    bk, tmode, tdims = fa._classify_bias(_t(bs), B, NH, S)
    assert (tmode, tdims) == (mode, dims)
    if mode == "key":
        assert tuple(bk.shape) == (dims[0], S)
    elif mode == "full":
        assert tuple(bk.shape) == (dims[0] * dims[1], S, S)
        assert fa._bias_row_map(tdims, NH) == jfa._bias_row_map(dims, NH)


def _jax_grads(q, k, v, bs, cot, **kw):
    args = [jnp.asarray(x) for x in (q, k, v)] + (
        [] if bs is None else [jnp.asarray(bs)])

    def f(*a):
        return jfa.flash_attention(*a[:3], a[3] if len(a) > 3 else None,
                                   **kw)

    o, vjp = jax.vjp(f, *args)
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_grads(q, k, v, bs, cot, **kw):
    ts = [_t(x, True) for x in (q, k, v)] + (
        [] if bs is None else [_t(bs, True)])
    o = fa.flash_attention(*ts[:3], ts[3] if len(ts) > 3 else None, **kw)
    gs = torch.autograd.grad(o, ts, torch.as_tensor(cot), allow_unused=True)
    return o.detach().numpy(), [None if g is None else g.numpy()
                                for g in gs]


@pytest.mark.parametrize("want_dbias", [False, True],
                         ids=["zero_dbias", "dbias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("bias", sorted(BIASES))
def test_plain_grads_match_jax_vjp(bias, causal, want_dbias):
    (q, k, v), rng = _qkv(2)
    bs = _bias(rng, bias)
    cot = rng.standard_normal((B, NH, S, D)).astype(np.float32)
    kw = dict(causal=causal, bias_requires_grad=want_dbias)
    o_j, g_j = _jax_grads(q, k, v, bs, cot, **kw)
    o_t, g_t = _torch_grads(q, k, v, bs, cot, **kw)
    _close(o_t, o_j, O_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        _close(a, b, GRAD_TOL, name)
    if bs is None:
        return
    if want_dbias:
        assert g_t[3].shape == bs.shape and np.abs(g_t[3]).max() > 0
        _close(g_t[3], g_j[3], DBIAS_TOL, "dbias")
    else:
        # the zero cotangent: JAX returns zeros, the port none
        assert not np.any(g_j[3]) and g_t[3] is None


@pytest.fixture
def jax_block_128(monkeypatch):
    """JAX's BHSD kernels on 128-row blocks at S = 256, so a q block can
    see no key (its default at S = 256 is one 256-row block)."""
    monkeypatch.setenv("PADDLE_FLASH_BLOCK", "128")


OFFSETS = {"q_after": (128, 0), "k_after": (0, 128),
           "k_after_shifted": (128, 256), "aligned": (256, 256)}


@pytest.mark.parametrize("key_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_block_with_lse_offsets_and_lse_cotangent(offsets, key_bias,
                                                  jax_block_128):
    """Causal at runtime offsets, with (o, lse) both carrying a
    cotangent; ``k_after`` and ``k_after_shifted`` leave the first q
    block of 128 rows seeing no key at all (o 0, lse NEG_INF, zero
    gradients, no NaN)."""
    s = 256
    (q, k, v), rng = _qkv(3, s)
    kb = (np.where(rng.random((B, s)) > 0.2, 0.0, -1e4).astype(np.float32)
          if key_bias else None)
    q_off, k_off = OFFSETS[offsets]
    cot_o = rng.standard_normal((B, NH, s, D)).astype(np.float32)
    cot_l = rng.standard_normal((B, NH, s)).astype(np.float32)
    kw = dict(causal=True, q_offset=q_off, k_offset=k_off)

    args = [jnp.asarray(x) for x in (q, k, v)] + (
        [jnp.asarray(kb)] if key_bias else [])
    (o_j, lse_j), vjp = jax.vjp(
        lambda *a: jfa.flash_block_with_lse(
            *a[:3], a[3] if key_bias else None, **kw), *args)
    g_j = vjp((jnp.asarray(cot_o), jnp.asarray(cot_l)))

    ts = [_t(x, True) for x in (q, k, v)] + ([_t(kb, True)] if key_bias
                                             else [])
    o_t, lse_t = fa.flash_block_with_lse(
        *ts[:3], ts[3] if key_bias else None, **kw)
    g_t = torch.autograd.grad((o_t, lse_t), ts, (torch.as_tensor(cot_o),
                                                 torch.as_tensor(cot_l)))
    _close(o_t.detach(), o_j, O_TOL, "o")
    _close(lse_t.detach(), lse_j, LSE_TOL, "lse")
    for name, a, b in zip(("dq", "dk", "dv", "dkey_bias"), g_t, g_j):
        assert torch.isfinite(a).all(), name
        _close(a, b, DBIAS_TOL if name == "dkey_bias" else GRAD_TOL, name)
    if offsets.startswith("k_after"):
        assert not o_t[:, :, :128].detach().any()
        assert (lse_t[:, :, :128] <= jfa.NEG_INF).all()
        assert not g_t[0][:, :, :128].any()


def test_rows_that_see_no_key_in_a_visited_tile():
    """Offsets 96 apart: rows 0-95 of the first q tile see no key while
    its other rows do.  The port gives such a row o = 0, lse = NEG_INF
    and zero gradients in every tiling (the TPU kernel does so only when
    its whole q block sees no key); the rows that see keys are the masked
    softmax of a plain composition."""
    (q, k, v), rng = _qkv(9, 256)
    ts = [_t(x, True) for x in (q, k, v)]
    o, lse = fa.flash_block_with_lse(*ts, causal=True, q_offset=32,
                                     k_offset=128)
    (o.sum() + lse.clamp_min(-1e4).sum()).backward()
    assert not o[:, :, :96].detach().any()
    assert (lse[:, :, :96] <= fa.NEG_INF).all()
    assert not ts[0].grad[:, :, :96].any()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    i = torch.arange(256)[:, None] + 32
    j = torch.arange(256)[None, :] + 128
    sc = torch.matmul(ts[0], ts[1].transpose(-1, -2)) / math.sqrt(D)
    probs = torch.softmax(sc[:, :, 96:].masked_fill((i < j)[96:], -1e30), -1)
    _close(o[:, :, 96:].detach(), torch.matmul(probs, ts[2])[...].detach(),
           O_TOL)


@pytest.mark.parametrize("bias", ["none", "key_shared", "full_b1"])
def test_dropout_from_one_shared_mask_matches_jax(bias):
    """Numerator-only dropout with the same uint8 keep mask on both
    sides, forward and every gradient (the mask rides the custom VJP)."""
    p = 0.2
    (q, k, v), rng = _qkv(4)
    bs = _bias(rng, bias)
    mask = (rng.random((B, NH, S, S)) > p).astype(np.uint8)
    cot = rng.standard_normal((B, NH, S, D)).astype(np.float32)
    seed = jnp.zeros((1,), jnp.int32)  # unused: the mask is given

    def f(*a):
        return jfa._flash_local(
            *a[:3], a[3] if bs is not None else None, jnp.asarray(mask),
            seed, sm_scale=1.0 / math.sqrt(D), causal=False,
            dropout_prob=p, bias_requires_grad=True)

    args = [jnp.asarray(x) for x in (q, k, v)] + (
        [] if bs is None else [jnp.asarray(bs)])
    o_j, vjp = jax.vjp(f, *args)
    g_j = vjp(jnp.asarray(cot))
    ts = [_t(x, True) for x in (q, k, v)] + (
        [] if bs is None else [_t(bs, True)])
    o_t = fa.flash_attention(*ts[:3], ts[3] if bs is not None else None,
                             dropout_prob=p, bias_requires_grad=True,
                             mask=torch.as_tensor(mask))
    g_t = torch.autograd.grad(o_t, ts, torch.as_tensor(cot))
    _close(o_t.detach(), o_j, O_TOL)
    for a, b in zip(g_t, g_j):
        _close(a, b, DBIAS_TOL)
    # the plain backward refuses dropout without the forward's mask
    o, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), dropout_prob=p,
                                    mask=torch.as_tensor(mask))
    with pytest.raises(ValueError, match="keep mask"):
        fa.flash_attention_bwd(_t(q), _t(k), _t(v), None, o, lse,
                               torch.as_tensor(cot), dropout_prob=p)


def test_cpu_dropout_draws_from_the_generator_or_seed():
    (q, k, v), _ = _qkv(5)
    q, k, v = _t(q), _t(k), _t(v)

    def gen(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    a = fa.flash_attention(q, k, v, dropout_prob=0.3,
                           dropout_generator=gen(1))
    b = fa.flash_attention(q, k, v, dropout_prob=0.3,
                           dropout_generator=gen(1))
    c = fa.flash_attention(q, k, v, dropout_prob=0.3,
                           dropout_generator=gen(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, fa.flash_attention(q, k, v))
    o1, _ = fa.flash_block_with_lse(q, k, v, dropout_prob=0.3,
                                    dropout_seed=9)
    o2, _ = fa.flash_block_with_lse(q, k, v, dropout_prob=0.3,
                                    dropout_seed=9)
    assert torch.equal(o1, o2)
    with pytest.raises(ValueError, match="dropout needs"):
        fa.flash_block_with_lse(q, k, v, dropout_prob=0.3)
    with pytest.raises(ValueError, match="dropout needs"):
        fa.flash_attention(q, k, v, dropout_prob=0.3)


# ---------------------------------------------------------------------------
# bf16 with a full bias: the rounding of rows 8 and 9
# ---------------------------------------------------------------------------

BF16_FULL = {
    # bias broadcast, bias dtype, causal, dropout p (from a shared mask)
    "f32_bias": ("full", torch.float32, False, 0.0),
    "bf16_bias": ("full", torch.bfloat16, False, 0.0),
    "bf16_bias_causal": ("full", torch.bfloat16, True, 0.0),
    "f32_bias_causal_mask": ("full", torch.float32, True, 0.2),
    "bf16_b1_bias_mask": ("full_b1", torch.bfloat16, False, 0.2),
}


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setattr(jax_attention, "FORCE_PALLAS", True)


def _grid(rng, shape, step, top):
    """Random multiples of ``step`` in [-top, top]: bf16-exact values
    whose products and sums here are exact in f32 in any order."""
    n = int(round(top / step))
    return torch.as_tensor(rng.integers(-n, n + 1, shape) * step,
                           dtype=torch.float32)


@pytest.mark.parametrize("case", sorted(BF16_FULL))
def test_bf16_full_bias_plain_backward_rounds_as_the_tpu_kernels(
        case, force_pallas):
    """bf16 dq/dk/dv (and dbias) of the port's plain backward with a full
    bias against the JAX custom VJP's backward ``_flash_bwd`` (rows 8 and
    9 in interpret mode), both fed the same bf16 q, k, v, dO, o, f32 lse
    and keep mask: both round p c to bf16 and ds0 sm_scale to bf16 before
    the dv, dk and dq products and sum in f32; dbias is the unrounded
    ds0 (cast to the bias's dtype).

    The residuals are the port's forward's (JAX's own forward rounds p
    before P.V, row 6's recorded difference, so its o moves delta).  The
    values lie on coarse grids (o rounded to 1/64) so that S, dP and delta
    are exact in any summation order: what is left to differ is the two
    libraries' exp, an f32 ulp apart for some arguments, which where it
    straddles a bf16 rounding boundary rounds one p c or ds term to the
    neighbouring value: that moves one row of dq and one of dk or dv.  So
    every element is held within one bf16 ulp (rtol 2^-7) plus 1e-5, save
    those of at most 2 of each gradient's 512 rows (0 or 1 in these
    cases); the products of the unrounded intermediates are shown to miss
    that limit in more than half the rows."""
    bias_name, bias_dtype, causal, p = BF16_FULL[case]
    rng = np.random.default_rng(12)
    q, k, v, do = (_grid(rng, (B, NH, S, D), 1 / 8, 2).to(torch.bfloat16)
                   for _ in range(4))
    shape = BIASES[bias_name]
    bias = _grid(rng, shape, 1 / 16, 2).to(bias_dtype)
    mask = (torch.as_tensor(rng.random((B, NH, S, S)) > p).to(torch.uint8)
            if p else None)
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal=causal,
                                    dropout_prob=p, mask=mask)
    o = (o.float() * 64).round().div(64).to(torch.bfloat16)
    got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal,
                                 dropout_prob=p, mask=mask, want_dbias=True)

    def j(t, n=D):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(t.float().numpy().reshape(B * NH, S, n), dt)

    bias_j, mode, dims = jfa._classify_bias(
        jnp.asarray(bias.float().numpy(), jnp.bfloat16
                    if bias_dtype == torch.bfloat16 else jnp.float32),
        B, NH, S)
    assert mode == "full" and fa.bhsd_bwd_route(q.dtype, mode) == "tc"
    res = (j(q), j(k), j(v), bias_j, None if mask is None else
           jnp.asarray(mask.numpy().reshape(B * NH, S, S)),
           jnp.zeros((1,), jnp.int32), None, j(o),
           jnp.asarray(lse.numpy().reshape(B * NH, 1, S)))
    sm = 1.0 / math.sqrt(D)
    want = jfa._flash_bwd(res, j(do), sm_scale=sm, num_heads=NH,
                          causal=causal, dropout_prob=p, bias_mode=mode,
                          bias_dims=dims, want_dbias=True)

    def rows_past(a, w):
        a = a.float().numpy().reshape(-1, a.shape[-1])
        w = np.asarray(w.astype(jnp.float32)).reshape(a.shape)
        past = np.abs(a - w) > 1e-5 + 2.0 ** -7 * np.abs(w)
        return int(past.any(axis=1).sum())

    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == (bias_dtype if name == "dbias" else torch.bfloat16)
        assert rows_past(a, w) <= 2, name
    # the limit tells the rounding from its absence: the same products of
    # unrounded p c and ds0 sm_scale miss it in most rows
    p_num, ds0 = fa.bhsd_bwd_probs_reference(q, k, v, bias, o, lse, do, sm,
                                             causal, mask, 1.0 - p)
    unrounded = fa.bhsd_bwd_products_reference(q, k, v, do, p_num, ds0, sm)
    for name, a, w in zip(("dq", "dk", "dv"), unrounded, want):
        assert rows_past(a, w) > 256, name


@pytest.mark.parametrize("dtype,bias,route", [
    (torch.bfloat16, "full", "tc"), (torch.bfloat16, "full_11", "tc"),
    (torch.float32, "full", "simt"), (torch.bfloat16, "key", "fused_tc"),
    (torch.bfloat16, "key_shared", "fused_tc"),
    (torch.bfloat16, "none", "fused_tc"), (torch.float32, "none", "simt")])
def test_backward_route_takes_tensor_cores_for_bf16(dtype, bias, route):
    """Rows 8 and 9 on their wgmma kernels for bf16 with a full bias, row
    7 on its wgmma kernel for bf16 with no bias or a key bias; f32 (which
    tensor cores would round to TF32) stays SIMT in every mode."""
    shape = BIASES[bias]
    bt = None if shape is None else torch.zeros(shape)
    _, mode, _ = fa._classify_bias(bt, B, NH, S)
    assert fa.bhsd_bwd_route(dtype, mode) == route


@pytest.mark.parametrize("dtype,bias", [(torch.float32, "full"),
                                        (torch.bfloat16, "full_1h"),
                                        (torch.bfloat16, "key")])
def test_plain_backward_is_its_intermediates_through_the_products(dtype,
                                                                  bias):
    """The split the card's check uses, bit for bit: the intermediates of
    ``bhsd_bwd_probs_reference`` (rounded by ``bhsd_bwd_rounded`` in bf16,
    every bias mode, as the TPU's kernels round them) through
    ``bhsd_bwd_products_reference`` are the plain backward; dbias is the
    unrounded ds0."""
    (q, k, v), rng = _qkv(13)
    q, k, v = (torch.as_tensor(x).to(dtype) for x in (q, k, v))
    bs = _t(_bias(rng, bias))
    do = torch.as_tensor(rng.standard_normal(q.shape),
                         dtype=torch.float32).to(dtype)
    mask = torch.as_tensor(rng.random((B, NH, S, S)) > 0.1).to(torch.uint8)
    o, lse = fa.flash_attention_fwd(q, k, v, bs, dropout_prob=0.1, mask=mask)
    sm = 1.0 / math.sqrt(D)
    kw = dict(causal=True, mask=mask, keep_div=0.9)
    p_num, ds0 = fa.bhsd_bwd_probs_reference(q, k, v, bs, o, lse, do, sm,
                                             **kw)
    assert p_num.shape == ds0.shape == (B, NH, S, S)
    if dtype == torch.bfloat16:
        p_r, ds_r = fa.bhsd_bwd_rounded(p_num, ds0, sm, dtype, dtype)
        for t in (p_r, ds_r):
            assert torch.equal(t, t.to(dtype).float())
        got = fa.bhsd_bwd_products_reference(q, k, v, do, p_r, ds_r)
    else:
        got = fa.bhsd_bwd_products_reference(q, k, v, do, p_num, ds0, sm)
    want = fa.flash_attention_bwd_reference(q, k, v, bs, o, lse, do, sm,
                                            want_dbias=True, **kw)
    for a, b in zip(got, want[:3]):
        assert a.dtype == dtype and torch.equal(a, b)
    assert torch.equal(want[3], fa._sum_to(ds0, bs.shape).to(bs.dtype))


# ---------------------------------------------------------------------------
# bf16 forward (row 6) and single-pass backward (row 7): the TPU kernels'
# rounding
# ---------------------------------------------------------------------------


def _grid_qkv(rng, n=3):
    return [_grid(rng, (B, NH, S, D), 1 / 8, 2).to(torch.bfloat16)
            for _ in range(n)]


def _grid_bias(rng, name):
    shape = BIASES[name]
    if shape is None:
        return None
    if name.startswith("key"):  # a padding mask on the grid
        pad = torch.as_tensor(rng.random(shape) > 0.8)
        return torch.where(pad, -1e4, _grid(rng, shape, 1 / 16, 2))
    return _grid(rng, shape, 1 / 16, 2).to(torch.bfloat16)


def _rows_past(a, w, n):
    """Rows of ``a`` (last dim n) with an element past 1e-5 + 2^-7 |w|."""
    a = np.asarray(a, np.float32).reshape(-1, n)
    w = np.asarray(w, np.float32).reshape(a.shape)
    return int((np.abs(a - w) > 1e-5 + 2.0 ** -7 * np.abs(w)).any(1).sum())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("bias", sorted(BIASES))
def test_bf16_plain_forward_rounds_as_the_tpu_kernel(bias, causal):
    """bf16 o and lse of the port's plain forward against ``_flash_fwd``
    (``_make_fwd_kernel`` in interpret mode) on the same bf16 inputs: both
    round p c to bf16 before P.V.  S = 128 is one JAX key block, so JAX's
    running max is the row's max and both round the same p.  The inputs
    lie on coarse grids, so S is exact in any summation order; what is
    left is the two libraries' exp, an f32 ulp apart for some arguments,
    which where it straddles a bf16 boundary rounds one p to its
    neighbour.  So o is held within one bf16 ulp (rtol 2^-7) plus 1e-5
    save at most 2 of its 512 rows, the lse within 2e-5; P.V of the
    unrounded p is shown to miss that limit in more than half the
    rows."""
    rng = np.random.default_rng(14)
    q, k, v = _grid_qkv(rng)
    bs = _grid_bias(rng, bias)
    sm = 1.0 / math.sqrt(D)
    assert jfa._pick_block(S) == S
    bj = None if bs is None else jnp.asarray(
        bs.float().numpy(), jnp.float32 if bs.dtype == torch.float32
        else jnp.bfloat16)
    biask, mode, dims = jfa._classify_bias(bj, B, NH, S)
    o_j, lse_j = jfa._flash_fwd(
        *(jnp.asarray(t.float().numpy().reshape(B * NH, S, D), jnp.bfloat16)
          for t in (q, k, v)), biask, None, None, None, sm_scale=sm,
        num_heads=NH, causal=causal, dropout_prob=0.0, bias_mode=mode,
        bias_dims=dims)
    o_t, lse_t = fa.flash_attention_fwd(q, k, v, bs, causal=causal)
    assert o_t.dtype == torch.bfloat16 and fa.bhsd_fwd_route(
        q.dtype) == "tc"
    o_j = np.asarray(o_j.astype(jnp.float32))
    assert _rows_past(o_t.float().numpy(), o_j, D) <= 2
    _close(lse_t.numpy().reshape(B * NH, 1, S), lse_j, LSE_TOL)
    # the limit tells the rounding from its absence
    p_num, m, l_safe = fa.bhsd_fwd_probs_reference(q, k, bs, sm, causal)
    sc, masked = fa._bhsd_scores(q, k, bs, sm, causal, 0, 0)
    p = torch.exp(sc - m)
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    assert torch.equal(p_num, p.to(torch.bfloat16).float())
    unrounded = torch.matmul(p, v.float()) / l_safe
    assert _rows_past(unrounded.numpy(), o_j, D) > 256


def test_plain_forward_products_of_tiles_are_the_plain_forward():
    """o from a tiled forward's intermediates
    (``bhsd_fwd_products_reference``: p c rounded relative to the running
    max of each 64-key tile, scaled by exp(m_t - lse)) equals the plain
    forward's within f32 rounding when the p c are the plain version's
    own (the tiles' running max then the row's max)."""
    (q, k, v), rng = _qkv(15)
    bs = _t(_bias(rng, "full"))
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    sm = 1.0 / math.sqrt(D)
    p_num, m, l_safe = fa.bhsd_fwd_probs_reference(q, k, bs, sm)
    o, lse = fa.flash_attention_reference(q, k, v, bs, sm)
    m_tiles = m.expand(B, NH, S, S // fa.KERNEL_ROWS)
    got = fa.bhsd_fwd_products_reference(v, p_num, m_tiles, lse)
    _close(got.numpy(), o.numpy(), O_TOL)


BF16_FUSED = {
    # bias, causal, dropout p (from a shared mask)
    "none": ("none", False, 0.0),
    "none_causal": ("none", True, 0.0),
    "key": ("key", False, 0.0),
    "key_causal": ("key", True, 0.0),
    "key_shared_mask": ("key_shared", False, 0.2),
}


@pytest.mark.parametrize("case", sorted(BF16_FUSED))
def test_bf16_plain_backward_rounds_as_the_fused_tpu_kernel(case,
                                                             force_pallas):
    """bf16 dq/dk/dv (and the key dbias) of the port's plain backward
    without a full bias (row 7's) against the JAX custom VJP's backward
    ``_flash_bwd``, which takes ``_bwd_fused`` (``_make_bwd_fused_kernel``
    in interpret mode) there, both fed the same bf16 q, k, v, dO, o, f32
    lse and keep mask: both round p c and ds0 sm_scale to bf16 before the
    dv, dk and dq products and sum in f32; dbias sums the unrounded ds0.
    Grid-valued inputs as in the full-bias test above, and its limit:
    within one bf16 ulp (rtol 2^-7) plus 1e-5 save at most 2 of each
    gradient's 512 rows, dbias within 2e-5; the products of the
    unrounded intermediates miss that limit in more than half the
    rows."""
    bias_name, causal, p = BF16_FUSED[case]
    rng = np.random.default_rng(16)
    q, k, v, do = _grid_qkv(rng, 4)
    bias = _grid_bias(rng, bias_name)
    mask = (torch.as_tensor(rng.random((B, NH, S, S)) > p).to(torch.uint8)
            if p else None)
    o, lse = fa.flash_attention_fwd(q, k, v, bias, causal=causal,
                                    dropout_prob=p, mask=mask)
    o = (o.float() * 64).round().div(64).to(torch.bfloat16)
    want_dbias = bias is not None
    got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal=causal,
                                 dropout_prob=p, mask=mask,
                                 want_dbias=want_dbias)

    def j(t, n=D):
        return jnp.asarray(t.float().numpy().reshape(B * NH, S, n),
                           jnp.bfloat16)

    bias_j, mode, dims = jfa._classify_bias(
        None if bias is None else jnp.asarray(bias.numpy()), B, NH, S)
    assert mode != "full" and fa.bhsd_bwd_route(q.dtype, mode) == "fused_tc"
    res = (j(q), j(k), j(v), bias_j, None if mask is None else
           jnp.asarray(mask.numpy().reshape(B * NH, S, S)),
           jnp.zeros((1,), jnp.int32), None, j(o),
           jnp.asarray(lse.numpy().reshape(B * NH, 1, S)))
    sm = 1.0 / math.sqrt(D)
    want = jfa._flash_bwd(res, j(do), sm_scale=sm, num_heads=NH,
                          causal=causal, dropout_prob=p, bias_mode=mode,
                          bias_dims=dims, want_dbias=want_dbias)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert _rows_past(a.float().numpy(),
                          np.asarray(w.astype(jnp.float32)), D) <= 2, name
    if want_dbias:
        db = np.asarray(want[3]).reshape(B, NH, S).sum(axis=1)
        if bias.shape[0] == 1:
            db = db.sum(axis=0, keepdims=True)
        _close(got[3].numpy().reshape(db.shape), db, DBIAS_TOL, "dbias")
    p_num, ds0 = fa.bhsd_bwd_probs_reference(q, k, v, bias, o, lse, do, sm,
                                             causal, mask, 1.0 - p)
    unrounded = fa.bhsd_bwd_products_reference(q, k, v, do, p_num, ds0, sm)
    for name, a, w in zip(("dq", "dk", "dv"), unrounded, want):
        assert _rows_past(a.float().numpy(),
                          np.asarray(w.astype(jnp.float32)), D) > 256, name


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt"),
                                         (torch.float16, "simt")])
def test_forward_route_takes_tensor_cores_for_bf16(dtype, route):
    """Row 6 on the wgmma kernel for bf16 in every bias mode; f32 (which
    tensor cores would round to TF32) stays SIMT."""
    assert fa.bhsd_fwd_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_a_cpu_forward_counts_no_launch_on_either_route(dtype):
    (q, k, v), rng = _qkv(17)
    q, k, v = (torch.as_tensor(x).to(dtype) for x in (q, k, v))
    n0 = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    for bias in ("none", "key", "full"):
        o, lse, bits, checks = fa.flash_attention_fwd(
            q, k, v, _t(_bias(rng, bias)), return_bits=True,
            return_probs=True)
        assert o.dtype == dtype and bits is None and checks is None
    assert (fa.flash_attention.launches, fa.flash_attention.launches_tc) == n0


@pytest.mark.parametrize("dtype,bias", [(torch.bfloat16, "full_b1"),
                                        (torch.bfloat16, "key"),
                                        (torch.bfloat16, "none"),
                                        (torch.float32, "full")])
def test_forward_launches_by_route_and_never_falls_back(dtype, bias,
                                                        monkeypatch):
    """On the card row 6 goes through ``flash_bhsd_fwd_launch`` with the
    dtype saying the route (bf16: the wgmma kernel, ``launches_tc``); the
    check outputs (p c bf16 [B, nh, S, S] and the running max [B, nh, S,
    S / 64], NEG_INF where a tile is skipped) are passed only on the
    tensor-core route.  A launch that fails raises and counts nothing:
    nothing retries it on the SIMT kernel or the plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    rng = np.random.default_rng(18)
    q, k, v = (torch.zeros(B, NH, S, D, dtype=dtype) for _ in range(3))
    bk, mode, dims = fa._classify_bias(_t(_bias(rng, bias)), B, NH, S)
    n0 = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    tc = dtype == torch.bfloat16
    o, lse, bits, checks = fa._cuda_flash_fwd(
        q, k, v, bk, mode, dims, 0.125, False, 0, 0, 0.0, None, None, 0,
        True, return_probs=True)
    (name, args), = calls
    assert name == "fwd" and len(args) == 28
    assert args[17] == fa._DTYPE_CODES[dtype] and bits is None
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_tc) == (n0[0] + 1, n0[1] + tc)
    if tc:
        p_out, m_out = checks
        assert p_out.shape == (B, NH, S, S) and p_out.dtype == dtype
        assert m_out.shape == (B, NH, S, S // 64) and bool(
            (m_out == fa.NEG_INF).all())
        assert args[25:27] == (p_out.data_ptr(), m_out.data_ptr())
    else:
        assert checks is None and args[25:27] == (None, None)

    calls.clear()
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append(name) or 700))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa._cuda_flash_fwd(q, k, v, bk, mode, dims, 0.125, False, 0, 0, 0.0,
                           None, None, 0, False)
    assert calls == ["fwd"]
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_tc) == (n0[0] + 1, n0[1] + tc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_fused_backward_check_outputs_in_bf16_only(dtype, monkeypatch):
    """Row 7 goes through its route's library entry: bf16 the wgmma
    kernel's (``flash_bhsd_bwd_tc_launch``, three check outputs: its
    rounded p c and ds, bf16 [B, nh, S, S], passed with ``return_probs``,
    and a null third, its dq taking its ds), f32 the SIMT kernel's
    (``flash_bhsd_bwd_launch``, none); the checks come back as (p c, ds,
    ds) in bf16 only."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    q, k, v = (torch.zeros(B, NH, S, D, dtype=dtype) for _ in range(3))
    lse = torch.zeros(B, NH, S)
    bk, mode, dims = fa._classify_bias(torch.zeros(1, 1, 1, S), B, NH, S)
    n0 = fa.flash_attention_bwd_fused.launches
    tc = dtype == torch.bfloat16
    for probs in (True, False):
        out = fa._cuda_flash_bwd(q, k, v, bk, mode, dims, q, lse, q, 0.125,
                                 False, 0, 0, 0.0, None, None, 0, None,
                                 True, return_probs=probs)
        name, args = calls[-1]
        assert args[0] == fa._FUSED
        assert (name, len(args)) == (("bwd_tc", 35) if tc else ("bwd", 32))
        if probs and tc:
            p_k, ds_k, dsq_k = out[4]
            assert p_k.shape == ds_k.shape == (B, NH, S, S)
            assert dsq_k.data_ptr() == ds_k.data_ptr() and p_k.dtype == dtype
            assert args[31:34] == (p_k.data_ptr(), ds_k.data_ptr(), None)
        else:
            if tc:
                assert args[31:34] == (None, None, None)
            assert len(out) == 4 or out[4] is None
    assert fa.flash_attention_bwd_fused.launches == n0 + 2


@pytest.mark.parametrize("bias", ["none", "key", "key_shared"])
def test_fused_backward_launches_the_wgmma_kernel_and_never_falls_back(
        bias, monkeypatch):
    """bf16 row 7 on the card: one call of the tensor-core entry with the
    dq_part scratch (f32 [S / 64, BH, S, D]: 64-row key tiles at every D)
    and the key bias as its [bb, S] rows; ``launches_tc`` counts it.  A
    launch that fails raises and counts nothing."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    q, k, v = (torch.zeros(B, NH, S, 256, dtype=torch.bfloat16)
               for _ in range(3))
    lse = torch.zeros(B, NH, S)
    shape = BIASES[bias]
    bk, mode, dims = fa._classify_bias(
        None if shape is None else torch.zeros(shape), B, NH, S)
    f = fa.flash_attention_bwd_fused
    n0 = (f.launches, f.launches_tc)
    args = (q, k, v, bk, mode, dims, lse, lse, q, 0.0625, True, 0, 64, 0.0,
            None, None, 0, mode is not None)
    dq, dk, dv, db = f(*args)
    (name, a), = calls
    assert name == "bwd_tc" and a[0] == fa._FUSED and a[5] == fa._BIAS_CODES[
        mode]
    assert a[15] is not None and a[19] == 256
    assert (db is None) == (mode is None) and dq.dtype == torch.bfloat16
    assert (f.launches, f.launches_tc) == (n0[0] + 1, n0[1] + 1)
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        f(*args)
    assert (f.launches, f.launches_tc) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_a_cpu_backward_counts_no_launch_on_either_route(dtype):
    (q, k, v), rng = _qkv(19)
    f = fa.flash_attention_bwd_fused
    n0 = (f.launches, f.launches_tc)
    for bias in ("none", "key_shared"):
        ts = [torch.as_tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*ts, _t(_bias(rng, bias)))
        o.float().sum().backward()
        assert ts[0].grad.dtype == dtype
    assert (f.launches, f.launches_tc) == n0


# ---------------------------------------------------------------------------
# the attention op's BHSD branch against the JAX op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force_pallas", [False, True],
                         ids=["jax_composition", "jax_pallas"])
@pytest.mark.parametrize("bias", ["full", "full_1h", "key_shared"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_op_bhsd_branch_matches_jax(bias, causal, force_pallas,
                                              monkeypatch):
    """``fused_multihead_attention`` with a bias the BSH kernel refuses:
    the port takes its BHSD branch (the autograd Function runs once), the
    JAX op its BHSD Pallas kernel (FORCE_PALLAS) or its composition; the
    output and dQ/dK/dV agree and BiasQK's cotangent is zero on both."""
    rng = np.random.default_rng(6)
    h = NH * D
    q, k, v = (rng.standard_normal((B, S, h)).astype(np.float32) * 0.5
               for _ in range(3))
    bs = _bias(rng, bias)
    cot = rng.standard_normal((B, S, h)).astype(np.float32)
    attrs = {"num_heads": NH, "dropout_prob": 0.0, "is_test": False,
             "causal": causal, "rng_salt": 1}

    def jfn(q_, k_, v_, b_):
        return jreg.get("fused_multihead_attention").emit(
            jreg.EmitContext(rng_key=jax.random.PRNGKey(0)),
            {"Q": [q_], "K": [k_], "V": [v_], "BiasQK": [b_]},
            dict(attrs))["Out"][0]

    jax_attention.FORCE_PALLAS = force_pallas
    try:
        o_j, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v, bs)))
        g_j = vjp(jnp.asarray(cot))
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = []
    real = fa._FlashBHSD.apply
    monkeypatch.setattr(fa._FlashBHSD, "apply",
                        lambda *a: calls.append(1) or real(*a))
    ts = [_t(x, True) for x in (q, k, v, bs)]
    o_t = treg.get("fused_multihead_attention").emit(
        treg.EmitContext(seed=0),
        {"Q": [ts[0]], "K": [ts[1]], "V": [ts[2]], "BiasQK": [ts[3]]},
        dict(attrs))["Out"][0]
    g_t = torch.autograd.grad(o_t, ts, torch.as_tensor(cot),
                              allow_unused=True)
    assert len(calls) == 1
    _close(o_t.detach(), o_j, O_TOL)
    for name, a, b in zip(("dQ", "dK", "dV"), g_t, g_j):
        _close(a, b, GRAD_TOL, name)
    assert not np.any(np.asarray(g_j[3])) and g_t[3] is None


def test_attention_op_takes_bsh_for_a_per_key_batch_bias(monkeypatch):
    """A [B, 1, 1, S] bias stays on the BSH kernels; a [1, 1, 1, S] one
    fails BSH's batch test and takes the BHSD branch, as in the JAX op."""
    rng = np.random.default_rng(7)
    h = NH * D
    q = torch.as_tensor(rng.standard_normal((B, S, h)), dtype=torch.float32)
    seen = []
    for name in ("_FlashBSH", "_FlashBHSD"):
        cls = getattr(fa, name)
        real = cls.apply
        monkeypatch.setattr(cls, "apply",
                            lambda *a, _r=real, _n=name: seen.append(_n)
                            or _r(*a))
    attrs = {"num_heads": NH, "causal": False, "rng_salt": 1}
    for bias in ("key", "key_shared"):
        treg.get("fused_multihead_attention").emit(
            treg.EmitContext(seed=0),
            {"Q": [q], "K": [q], "V": [q],
             "BiasQK": [_t(_bias(rng, bias))]}, attrs)
    assert seen == ["_FlashBSH", "_FlashBHSD"]


# ---------------------------------------------------------------------------
# CUDA wrappers: input checks, bounds, counters
# ---------------------------------------------------------------------------


def _good(dtype=torch.float32, bias="full", d=D, s=S):
    q, k, v = (torch.zeros(B, NH, s, d, dtype=dtype) for _ in range(3))
    shape = BIASES[bias]
    b = None if shape is None else torch.zeros(
        tuple(s if n == S else n for n in shape))
    return q, k, v, b


@pytest.mark.parametrize("case", ["f32_full", "bf16_full_bf16_bias",
                                  "key_shared", "none_d128", "d256_s64",
                                  "mask"])
def test_kernel_check_accepts_supported_inputs(case):
    if case == "f32_full":
        fa.check_bhsd_inputs(*_good())
    elif case == "bf16_full_bf16_bias":
        q, k, v, b = _good(torch.bfloat16)
        fa.check_bhsd_inputs(q, k, v, b.to(torch.bfloat16))
    elif case == "key_shared":
        fa.check_bhsd_inputs(*_good(bias="key_shared"))
    elif case == "none_d128":
        fa.check_bhsd_inputs(*_good(bias="none", d=128))
    elif case == "d256_s64":
        fa.check_bhsd_inputs(*_good(d=256, s=64))
    else:
        fa.check_bhsd_inputs(*_good(), dropout_prob=0.1,
                             mask=torch.ones(B, NH, S, S, dtype=torch.uint8))


REFUSED = {
    "f16": lambda: _good(torch.float16),
    "mixed_dtype": lambda: (lambda q, k, v, b: (q, k.double(), v, b))(
        *_good()),
    "three_d": lambda: (lambda q, k, v, b: (q[0], k[0], v[0], None))(
        *_good()),
    "kv_mismatch": lambda: (lambda q, k, v, b: (q, k[:1], v, b))(*_good()),
    "d96": lambda: _good(d=96),
    "s96": lambda: _good(s=96),
    "bias_3d": lambda: (lambda q, k, v, b: (q, k, v, b[0]))(*_good()),
    "bias_heads": lambda: (lambda q, k, v, b: (
        q, k, v, torch.zeros(B, 3, S, S)))(*_good()),
    "bias_rows": lambda: (lambda q, k, v, b: (
        q, k, v, torch.zeros(B, NH, 64, S)))(*_good()),
    "bias_f16": lambda: (lambda q, k, v, b: (q, k, v, b.half()))(*_good()),
    "non_contiguous": lambda: (lambda q, k, v, b: (
        q.transpose(2, 3).contiguous().transpose(2, 3), k, v, b))(*_good()),
}


@pytest.mark.parametrize("name", sorted(REFUSED) + ["mask_shape",
                                                    "dropout_one"])
def test_kernel_check_refuses(name):
    if name == "mask_shape":
        with pytest.raises(ValueError, match="mask"):
            fa.check_bhsd_inputs(*_good(), dropout_prob=0.1,
                                 mask=torch.ones(B, NH, S, dtype=torch.uint8))
        return
    if name == "dropout_one":
        with pytest.raises(ValueError, match="dropout_prob"):
            fa.check_bhsd_inputs(*_good(), dropout_prob=1.0)
        return
    with pytest.raises(ValueError):
        fa.check_bhsd_inputs(*REFUSED[name]())


def test_flash_attention_wants_lengths_of_128():
    q = torch.zeros(1, 1, 64, 64)
    with pytest.raises(ValueError, match="seq"):
        fa.flash_attention(q, q, q)


def test_bounds_at_the_nmt_shapes():
    """The bytes and flops bounds at the encoder's shapes (B 64, nh 8,
    S 256, D 64, bf16 with the bf16 [B, nh, S, S] bias) and row 7's at
    the hapi MultiHeadAttention's ([1, 1, 1, S] bias)."""
    q = torch.empty(64, 8, 256, 64, dtype=torch.bfloat16, device="meta")
    full = torch.empty(64, 8, 256, 256, dtype=torch.bfloat16, device="meta")
    key = torch.empty(1, 1, 1, 256, dtype=torch.bfloat16, device="meta")
    act, stat, bias = 2 * 64 * 8 * 256 * 64, 4 * 64 * 8 * 256, 2 * 64 * 8 * 256 ** 2
    assert fa.bound_bytes_bhsd(q, full) == 4 * act + stat + bias
    assert fa.bound_bytes_bhsd(q, full, "dq") == 5 * act + 2 * stat + bias
    assert fa.bound_bytes_bhsd(q, full, "dkv") == 6 * act + 2 * stat + bias
    assert fa.bound_bytes_bhsd(q, full, "dkv", want_dbias=True) == (
        6 * act + 2 * stat + bias + 4 * 64 * 8 * 256 ** 2)
    assert fa.bound_bytes_bhsd(q, key, "fused") == 7 * act + 2 * stat + 4 * 256
    # in MB: 134.7, 152.0, 168.8 and ~118.5
    assert round(fa.bound_bytes_bhsd(q, full) / 1e6, 1) == 134.7
    assert round(fa.bound_bytes_bhsd(q, full, "dq") / 1e6, 1) == 152.0
    assert round(fa.bound_bytes_bhsd(q, full, "dkv") / 1e6, 1) == 168.8
    pairs = 256 * 256
    assert fa.bound_flops_bhsd(q) == 4 * 64 * 8 * pairs * 64 == 8589934592
    assert fa.bound_flops_bhsd(q, "fused") == 10 * 64 * 8 * pairs * 64
    assert fa.bound_flops_bhsd(q, "dq") == 6 * 64 * 8 * pairs * 64
    assert fa.bound_flops_bhsd(q, "dkv") == 8 * 64 * 8 * pairs * 64
    assert fa.bound_flops_bhsd(q, causal=True) == 4 * 64 * 8 * (
        256 * 257 // 2) * 64
    # offsets count the pairs this run's data needs
    assert fa._visible_pairs(4, True, 0, 2) == 0 + 0 + 1 + 2
    assert fa._visible_pairs(4, True, 8, 0) == 16


class _Dev:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


def test_counters_count_kernel_launches_only(monkeypatch):
    """CPU calls launch nothing and count nothing; on the card the
    backward dispatches like ``_flash_bwd``: a full bias to rows 8 and 9
    (one launch each), any other bias to row 7; a launch that CUDA
    refuses raises and does not count."""
    counters = (fa.flash_attention, fa.flash_attention_bwd_fused,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    (q, k, v), rng = _qkv(8)
    for bias in ("none", "key", "full"):
        ts = [_t(x, True) for x in (q, k, v)]
        o = fa.flash_attention(*ts, _t(_bias(rng, bias)))
        o.sum().backward()
    assert [c.launches for c in counters] == before

    parts = []
    monkeypatch.setattr(fa, "_cuda_flash_bwd_part",
                        lambda part, *a: parts.append(part) or (
                            None, None, None, None))
    qt, kt, vt = (torch.zeros(B, NH, S, D) for _ in range(3))
    lse = torch.zeros(B, NH, S)
    for bias in ("full_b1", "key_shared", "none"):
        bk, mode, dims = fa._classify_bias(_t(_bias(rng, bias)), B, NH, S)
        fa._cuda_flash_bwd(qt, kt, vt, bk, mode, dims, qt, lse, qt, 0.125,
                           False, 0, 0, 0.0, None, None, 0, None, False)
    assert parts == [fa._DQ, fa._DKV, fa._FUSED, fa._FUSED]
    assert [c.launches for c in counters] == [
        before[0], before[1] + 2, before[2] + 1, before[3] + 1]

    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa._cuda_flash_fwd(qt, kt, vt, None, None, None, 0.125, False, 0, 0,
                           0.0, None, None, 0, False)
    assert fa.flash_attention.launches == before[0]




@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "bwd_tc"),
                                         (torch.float32, "bwd")])
def test_full_bias_backward_launches_by_route_and_never_falls_back(
        dtype, entry, monkeypatch):
    """On the card a full bias sends the backward to rows 8 and 9 through
    its route's library entry: ``flash_bhsd_bwd_tc_launch`` for bf16 (the
    wgmma kernels, three check outputs), ``flash_bhsd_bwd_launch`` for f32
    (no check outputs); ``launches_tc``
    counts the tensor-core launches, and the check outputs come back only
    from them.  A launch that fails raises:
    nothing retries it on the other route or the plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append((name, len(a))) or 0))
    counters = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    n0 = [(c.launches, c.launches_tc) for c in counters]
    q, k, v = (torch.zeros(B, NH, S, D, dtype=dtype) for _ in range(3))
    lse = torch.zeros(B, NH, S)
    bk, mode, dims = fa._classify_bias(torch.zeros(B, 1, S, S, dtype=dtype),
                                       B, NH, S)
    args = (q, k, v, bk, mode, dims, q, lse, q, 0.125, False, 0, 0, 0.0,
            None, None, 0, None, True)
    out = fa._cuda_flash_bwd(*args, return_probs=True)
    tc = entry == "bwd_tc"
    assert calls == [(entry, 35 if tc else 32)] * 2
    assert [(c.launches, c.launches_tc) for c in counters] == [
        (a + 1, b + tc) for a, b in n0]
    assert out[3].shape == (B, S, S)  # dbias summed over the heads
    if tc:
        assert all(t.shape == (B, NH, S, S) and t.dtype == dtype
                   for t in out[4])
    else:
        assert out[4] is None

    calls.clear()
    monkeypatch.setattr(fa, "_bhsd_launcher", lambda name: lambda *a: (
        calls.append(name) or 700))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa._cuda_flash_bwd(*args)
    assert calls == [entry]
    assert [(c.launches, c.launches_tc) for c in counters] == [
        (a + 1, b + tc) for a, b in n0]
