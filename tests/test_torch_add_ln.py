"""The port's residual-add + LayerNorm (the plain PyTorch version, the one
CPU tensors take) against the JAX package's ``fused_add_ln`` — its Pallas
forward in interpret mode — with and without the residual, and the
``layer_norm`` op emitter's Y / Mean / Variance against the JAX
package's emitter, on the same numpy inputs; the backward (dx = dy,
dscale, dshift) of the port's autograd Function against ``jax.vjp`` of
the JAX package's custom VJP (its Pallas backward in interpret mode),
with and without the residual, in f32, bf16 and f16, and the f16 forward
(out, mean, rstd) against the Pallas forward on f16 inputs.  Also the
CUDA wrappers' input checks, which take f16 (float16 AMP's form).

Tolerances (f32): out 2e-6 and the stats 1e-6 (the same math; XLA and
torch sum the row in other orders).  Variance: the port's emitter forms
it from the kernel's rstd as 1/rstd**2 - eps, a few f32 ulps of
var + eps from the direct variance: rtol 2e-6 on var + eps.  Backward:
dx 2e-6 in f32, one bf16 ulp (2^-7 relative, atol 1e-2 near zero) in
bf16 and one f16 ulp (2^-10 relative, atol 2e-3) in f16; dscale and
dshift 2e-6 relative (sums over up to 128 rows of products near 1) in
all three.
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


@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
def test_f16_matches_the_pallas_forward(with_y):
    """float16 out, mean and rstd of the port's plain forward against the
    JAX package's ``_ln_fwd`` (its Pallas kernel in interpret mode) on the
    same f16 inputs: f32 statistics (within STAT_TOL), out rounded once
    to f16 (within one f16 ulp, 2^-10 relative, plus 2^-11 near zero)."""
    x = _inputs(9, (64, 768))
    y = x["y"] if with_y else None
    out_j, mean_j, rstd_j = jax_add_ln._ln_fwd(
        jnp.asarray(x["x"], jnp.float16),
        None if y is None else jnp.asarray(y, jnp.float16),
        jnp.asarray(x["scale"]), jnp.asarray(x["shift"]), eps=1e-5)
    out_t, mean_t, rstd_t = add_ln.fused_add_ln_fwd(
        torch.as_tensor(x["x"]).half(),
        None if y is None else torch.as_tensor(y).half(),
        torch.as_tensor(x["scale"]), torch.as_tensor(x["shift"]), eps=1e-5)
    assert out_t.dtype == torch.float16 and mean_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=2.0 ** -11, rtol=2.0 ** -10)
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
    real = add_ln.add_ln
    monkeypatch.setattr(add_ln, "add_ln",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
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
                                dict(h=4096), dict(dtype=torch.bfloat16),
                                dict(dtype=torch.float16)],
                         ids=["y", "no_y", "h4", "h4096", "bf16", "f16"])
def test_kernel_check_accepts_supported_inputs(kw):
    add_ln.check_kernel_inputs(**_good(**kw))


BAD = {
    "x_float64": lambda x: x.update(x=x["x"].double(), y=x["y"].double()),
    # float16 is a kernel dtype (float16 AMP): f16 x beside an f32 y is not
    "x_float16": lambda x: x.update(x=x["x"].half()),
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


def _jax_bwd(x, y, scale, shift, g):
    import jax

    def fn(*a):
        return jax_add_ln.fused_add_ln(a[0], a[1] if y is not None else None,
                                       a[-2], a[-1], eps=1e-5)

    args = [x] + ([y] if y is not None else []) + [scale, shift]
    _, vjp = jax.vjp(fn, *args)
    out = [np.asarray(v, np.float32) for v in vjp(g)]
    return (out[0], out[1] if y is not None else None, out[-2], out[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
def test_backward_matches_jax_vjp(with_y, dtype):
    x = _inputs(6, (2, 64, 128))
    g = np.random.default_rng(7).standard_normal((2, 64, 128)).astype(
        np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = _jax_bwd(jnp.asarray(x["x"], jdt),
                    jnp.asarray(x["y"], jdt) if with_y else None,
                    jnp.asarray(x["scale"]), jnp.asarray(x["shift"]),
                    jnp.asarray(g, jdt))
    leaves = [torch.as_tensor(x["x"]).to(tdt).requires_grad_(),
              torch.as_tensor(x["y"]).to(tdt).requires_grad_(),
              torch.as_tensor(x["scale"]).requires_grad_(),
              torch.as_tensor(x["shift"]).requires_grad_()]
    if not with_y:
        leaves[1] = None
    out = add_ln.fused_add_ln(*leaves, eps=1e-5)
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(out, live, torch.as_tensor(g).to(tdt))
    got = list(got) if with_y else [got[0], None, got[1], got[2]]
    assert got[0].dtype == tdt and got[2].dtype == torch.float32
    # dx within one ulp of the dtype (2^-7 bf16, 2^-10 f16), with an
    # atol for values near zero
    atol, rtol = {"float32": (OUT_TOL, 0), "bfloat16": (1e-2, 2.0 ** -7),
                  "float16": (2e-3, 2.0 ** -10)}[dtype]
    for name, a, b in zip(("dx", "dy", "dscale", "dshift"), want, got):
        if a is None:
            assert b is None
            continue
        b = b.float().numpy()
        if name in ("dx", "dy"):
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=2e-6,
                                       err_msg=name)
    if with_y:
        assert torch.equal(got[0], got[1])  # dx serves as dy


def test_stats_are_not_differentiable():
    x = _inputs(8, (4, 128))
    xt = torch.as_tensor(x["x"]).requires_grad_()
    out, mean, rstd = add_ln.add_ln(xt, None, torch.as_tensor(x["scale"]),
                                    torch.as_tensor(x["shift"]))
    assert out.requires_grad and not mean.requires_grad \
        and not rstd.requires_grad


def test_backward_kernel_check():
    x = _good()
    mean = torch.zeros(8)
    add_ln.check_bwd_inputs(x["x"], x["y"], x["scale"], mean, mean, x["x"])
    for bad in (dict(g=x["x"].bfloat16()), dict(g=x["x"][:4]),
                dict(mean=mean.double()), dict(rstd=mean[:4])):
        kw = dict(x=x["x"], y=x["y"], scale=x["scale"], mean=mean,
                  rstd=mean, g=x["x"])
        kw.update(bad)
        with pytest.raises(ValueError):
            add_ln.check_bwd_inputs(**kw)


def test_backward_bounds_count_the_bytes():
    x = torch.zeros(4096, 768)
    act = 4096 * 768 * 4
    # about 37.7 MB in f32 without a residual at [4096, 768]
    assert add_ln.bound_bytes_bwd(x, None) == (3 * act + 3 * 4 * 768
                                               + 2 * 4 * 4096)
    assert add_ln.bound_bytes_bwd(x, x) == (4 * act + 3 * 4 * 768
                                            + 2 * 4 * 4096)


def test_backward_launch_counter_counts_only_kernel_launches():
    x = _good()
    n0 = add_ln.fused_add_ln_bwd.launches
    xt = x["x"].requires_grad_()
    add_ln.fused_add_ln(xt, None, x["scale"], x["shift"]).sum().backward()
    assert add_ln.fused_add_ln_bwd.launches == n0  # CPU: the plain version


@pytest.mark.parametrize("rows,h,sms,want", [
    (4096, 768, 132, (512, 32, 128, 8)),       # BERT-base's training rows
    (16384, 512, 132, (512, 128, 128, 8)),     # the NMT step's rows
    (8, 768, 132, (512, 16, 1, 1)),
    (100, 2048, 132, (128, 4, 25, 2)),         # wide rows: four warps
    (4097, 1024, 4, (512, 1040, 4, 1)),
    (40000, 768, 132, (512, 304, 132, 9)),
], ids=["bert", "nmt", "tiny", "wide", "ragged", "many"])
def test_bwd_geometry(rows, h, sms, want):
    """Sixteen warps a block, one block an SM, up to H = 1024; four warps,
    two blocks an SM, beyond; rows a block a multiple of the warps; every
    row in exactly one block; at most one wave; blocks in groups of 16
    for the final sums."""
    threads, per_block, nblocks, ngroups = got = add_ln.bwd_geometry(
        rows, h, sms)
    assert got == want
    assert per_block % (threads // 32) == 0
    assert (nblocks - 1) * per_block < rows <= nblocks * per_block
    assert nblocks <= sms * (1 if threads == 512 else 2)
    assert ngroups == -(-nblocks // add_ln.BWD_GROUP)


def test_bwd_workspace_is_cached_per_device_stream_and_width(monkeypatch):
    monkeypatch.setattr(add_ln, "_workspaces", {})
    part, ticket = add_ln.bwd_workspace("cpu", 7, 768, 256, 16)
    assert part.shape == (272, 2, 768) and part.dtype == torch.float32
    assert ticket.shape == (17,) and ticket.dtype == torch.int32
    assert not ticket.any()  # zero before the first call
    again = add_ln.bwd_workspace(torch.device("cpu"), 7, 768, 200, 13)
    assert again[0] is part and again[1] is ticket  # fewer rows: reused
    assert add_ln.bwd_workspace("cpu", 8, 768, 256, 16)[0] is not part
    assert add_ln.bwd_workspace("cpu", 7, 512, 256, 16)[0].shape == (
        272, 2, 512)
    grown = add_ln.bwd_workspace("cpu", 7, 768, 512, 32)
    assert grown[0].shape == (544, 2, 768) and grown[1].shape == (33,)
    assert add_ln.bwd_workspace("cpu", 7, 768, 256, 16)[0] is grown[0]


class _Dev:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
def test_bwd_launch_passes_the_geometry_and_never_falls_back(
        dtype, with_y, monkeypatch):
    """On the card the backward is one call of ``add_ln_bwd_launch`` with
    the geometry of ``bwd_geometry`` and the cached workspace: no second
    kernel sums the partials (dscale and dshift are views of one [2, H]
    output the kernel writes).  A failed launch raises and counts
    nothing: nothing retries it on the plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(add_ln, "_sm_count", lambda device: 132)
    monkeypatch.setattr(add_ln, "_workspaces", {})
    calls = []
    monkeypatch.setattr(add_ln, "_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    x = _good(r=4096, dtype=dtype, y=with_y)
    g = torch.zeros_like(x["x"])
    stats = torch.zeros(4096)
    n0 = add_ln.fused_add_ln_bwd.launches
    dx, dscale, dshift = add_ln._cuda_add_ln_bwd(
        x["x"], x["y"], x["scale"], stats, stats, g)
    (name, args), = calls
    assert name == "bwd" and len(args) == 18
    part, ticket = add_ln._workspaces[(torch.device("cpu"), 5, 768)]
    assert args[1] == (x["y"].data_ptr() if with_y else None)
    assert args[6] == dx.data_ptr()
    assert args[7:11] == (dscale.data_ptr(), dshift.data_ptr(),
                          part.data_ptr(), ticket.data_ptr())
    assert args[11:17] == (4096, 768, 32, 128, 512,
                           add_ln._DTYPE_CODES[dtype])
    assert args[17] == 5
    assert dx.dtype == dtype and dscale.shape == dshift.shape == (768,)
    assert dshift.data_ptr() - dscale.data_ptr() == 768 * 4
    assert add_ln.fused_add_ln_bwd.launches == n0 + 1

    monkeypatch.setattr(add_ln, "_launcher", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        add_ln._cuda_add_ln_bwd(x["x"], x["y"], x["scale"], stats, stats, g)
    assert add_ln.fused_add_ln_bwd.launches == n0 + 1


def test_bwd_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(add_ln, "_launcher", lambda name: pytest.fail(
        "launched"))
    x = _good()
    stats = torch.zeros(8)
    with pytest.raises(ValueError):
        add_ln._cuda_add_ln_bwd(x["x"], x["y"], x["scale"], stats, stats,
                                x["x"].bfloat16())
    with pytest.raises(ValueError):
        add_ln._cuda_add_ln_bwd(x["x"], x["y"], x["scale"], stats[:4],
                                stats, x["x"])


@pytest.mark.parametrize("rows,h,sms,want", [
    (4096, 768, 132, (256, 264)),      # BERT-base's rows: ~2 rows a warp
    (16384, 512, 132, (256, 264)),     # the NMT step's rows: ~8 a warp
    (8, 768, 132, (256, 1)),
    (1000, 768, 132, (256, 125)),      # a ragged last wave
    (100, 2048, 132, (128, 25)),       # wide rows: four warps a block
    (4097, 4096, 4, (128, 8)),
    (40000, 1024, 132, (256, 264)),
], ids=["bert", "nmt", "tiny", "ragged", "wide", "widest", "many"])
def test_fwd_geometry(rows, h, sms, want):
    """Eight warps a block up to H = 1024, four beyond; at most two blocks
    an SM (one wave), and no block without a row; the grid's warps cover
    every row once with the stride nblocks * warps."""
    threads, nblocks = got = add_ln.fwd_geometry(rows, h, sms)
    assert got == want
    warps = threads // 32
    assert nblocks <= add_ln.FWD_BLOCKS_PER_SM * sms
    assert (nblocks - 1) * warps < rows
    stride = nblocks * warps
    walked = sorted(r for w in range(stride) for r in range(w, rows, stride))
    assert walked == list(range(rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_y", [False, True], ids=["no_y", "y"])
def test_fwd_launch_passes_the_geometry_and_never_falls_back(
        dtype, with_y, monkeypatch):
    """On the card the forward is one call of ``add_ln_fwd_launch`` with
    the geometry of ``fwd_geometry``; scale and shift go over as f32.  A
    failed launch raises and counts nothing: nothing retries it on the
    plain version."""
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(add_ln, "_sm_count", lambda device: 132)
    calls = []
    monkeypatch.setattr(add_ln, "_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    x = _good(r=4096, dtype=dtype, y=with_y)
    x["scale"], x["shift"] = x["scale"].to(dtype), x["shift"].to(dtype)
    n0 = add_ln.fused_add_ln.launches
    out, mean, rstd = add_ln._cuda_add_ln(x["x"], x["y"], x["scale"],
                                          x["shift"], 1e-5)
    (name, args), = calls
    assert name == "fwd" and len(args) == 14
    assert args[0] == x["x"].data_ptr()
    assert args[1] == (x["y"].data_ptr() if with_y else None)
    assert args[4:7] == (out.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    assert args[7:9] == (4096, 768) and args[9] == 1e-5
    assert args[10:13] == (264, 256, add_ln._DTYPE_CODES[dtype])
    assert args[13] == 5
    assert out.dtype == dtype and mean.shape == rstd.shape == (4096,)
    assert mean.dtype == rstd.dtype == torch.float32
    assert add_ln.fused_add_ln.launches == n0 + 1

    monkeypatch.setattr(add_ln, "_launcher", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        add_ln._cuda_add_ln(x["x"], x["y"], x["scale"], x["shift"], 1e-5)
    assert add_ln.fused_add_ln.launches == n0 + 1


@pytest.mark.parametrize("name", ["x_float64", "h_not_multiple_of_4",
                                  "h_too_wide", "y_shape_differs",
                                  "x_misaligned"])
def test_fwd_launch_refuses_what_the_kernel_does_not_take(name,
                                                          monkeypatch):
    monkeypatch.setattr(add_ln, "_launcher", lambda name: pytest.fail(
        "launched"))
    x = _good()
    BAD[name](x)
    with pytest.raises(ValueError):
        add_ln._cuda_add_ln(x["x"], x["y"], x["scale"], x["shift"], 1e-5)
