"""The conv+BN kernels' module (``ops/kernels/conv_bn.py``) against the
JAX package's ``ops/pallas/conv_bn.py``, on the CPU, where every wrapper
takes its plain version.

* ``fused_conv_bn`` (the dispatcher) against JAX's ``conv_bn_reference``
  and against JAX's Pallas path in interpret mode (FORCE_PALLAS, as the
  JAX package's own test runs it), at the five cases of that test: y,
  mean and var within 2e-5 and the gradients dx, dw, dscale and dbias of
  ``sum(y * cos y)`` within 5e-4 in f32 (that test's own limits).
* The five plain per-kernel functions against the JAX kernels: rows 10
  and 11 against ``_conv_fwd`` / ``_mm_fwd`` (the Pallas kernels in
  interpret mode), rows 12-14 against the kernel bodies ``_apply_kernel``,
  ``_bwd_reduce_kernel`` and ``_bwd_dz_kernel`` run on array-backed refs,
  f32 within 1e-5 and bf16 within one bf16 ulp; the whole forward and
  backward against ``_pallas_fwd`` / ``_pallas_bwd``.
* The gate ``conv_bn_shapes_ok`` against the structural part of JAX's.
* The kernel wrappers' input checks, and the route counter.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattention
from paddle_tpu.ops.pallas import conv_bn as jcb
from paddle_tpu_torch.ops.kernels import conv_bn as tcb

CASES = [
    ((2, 8, 8, 8), (16, 8, 3, 3), (1, 1), "SAME", True),   # ResNet 3x3
    ((2, 8, 8, 8), (16, 8, 1, 1), (1, 1), "VALID", False),  # bottleneck 1x1
    ((2, 8, 8, 8), (16, 8, 1, 1), (2, 2), "VALID", True),   # projection
    ((2, 9, 9, 5), (7, 5, 3, 3), (1, 1), "VALID", False),   # odd channels
    ((1, 6, 6, 4), (8, 4, 7, 7), (1, 1), "SAME", True),     # stem-class
]
IDS = ["3x3_same_relu", "1x1", "1x1_s2_relu", "odd_5to7_valid", "7x7_same"]
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _inputs(xs, ws, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(*ws) * 0.1).astype(np.float32)
    o = ws[0]
    scale = (rng.rand(o) + 0.5).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    return x, w, scale, bias


def _jax_loss(fn, strides, pads, with_relu):
    def f(x_, w_, s_, b_):
        y, _, _ = fn(x_, w_, s_, b_, strides=strides, pads=pads,
                     with_relu=with_relu)
        return jnp.sum(y * jnp.cos(y))
    return f


def _port(x, w, scale, bias, strides, pads, with_relu):
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, scale, bias)]
    y, m, v = tcb.fused_conv_bn(*leaves, strides=strides, pads=pads,
                                with_relu=with_relu)
    grads = torch.autograd.grad((y * torch.cos(y)).sum(), leaves)
    return (y, m, v), grads


@pytest.mark.parametrize("xs,ws,strides,pads,with_relu", CASES, ids=IDS)
def test_fused_conv_bn_matches_jax(xs, ws, strides, pads, with_relu):
    x, w, scale, bias = _inputs(xs, ws)
    jargs = [jnp.asarray(a) for a in (x, w, scale, bias)]
    pr = jcb._resolve_pads(pads, xs[1], xs[2], ws[2], ws[3], strides)
    assert tcb._resolve_pads(pads, xs[1], xs[2], ws[2], ws[3],
                             strides) == pr
    ref = jcb.conv_bn_reference(*jargs, strides=strides, pads=pr,
                                with_relu=with_relu)
    g_ref = jax.grad(_jax_loss(jcb.conv_bn_reference, strides, pr,
                               with_relu), argnums=(0, 1, 2, 3))(*jargs)
    jattention.FORCE_PALLAS = True
    try:
        pallas = jcb.fused_conv_bn(*jargs, strides=strides, pads=pads,
                                   with_relu=with_relu)
        g_pallas = jax.grad(_jax_loss(jcb.fused_conv_bn, strides, pads,
                                      with_relu),
                            argnums=(0, 1, 2, 3))(*jargs)
    finally:
        jattention.FORCE_PALLAS = False
    routes = tcb.fused_conv_bn.reference_routes
    outs, grads = _port(x, w, scale, bias, strides, pads, with_relu)
    assert tcb.fused_conv_bn.reference_routes == routes  # the kernel route
    for want in (ref, pallas):
        for got, exp, nm in zip(outs, want, ("y", "mean", "var")):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=nm)
    for want in (g_ref, g_pallas):
        for got, exp, nm in zip(grads, want,
                                ("dx", "dw", "dscale", "dbias")):
            np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=nm)


def test_strided_kxk_takes_the_reference_route():
    """A 3 x 3 stride-2 conv (ResNet's downsampling c2) fails the gate:
    the reference composition, counted, differentiated by autograd."""
    x, w, scale, bias = _inputs((2, 8, 8, 8), (16, 8, 3, 3), seed=1)
    pr = jcb._resolve_pads("SAME", 8, 8, 3, 3, (2, 2))
    jargs = [jnp.asarray(a) for a in (x, w, scale, bias)]
    ref = jcb.conv_bn_reference(*jargs, strides=(2, 2), pads=pr,
                                with_relu=True)
    g_ref = jax.grad(_jax_loss(jcb.conv_bn_reference, (2, 2), pr, True),
                     argnums=(0, 1, 2, 3))(*jargs)
    routes = tcb.fused_conv_bn.reference_routes
    outs, grads = _port(x, w, scale, bias, (2, 2), "SAME", True)
    assert tcb.fused_conv_bn.reference_routes == routes + 1
    for got, exp in zip(outs, ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    for got, exp in zip(grads, g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


class _Ref:
    """A Pallas ref over a mutable array, for running a kernel body
    outside pallas_call."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, value):
        self.a = self.a.at[idx].set(value)

    @property
    def dtype(self):
        return self.a.dtype


DTYPES = [("f32", torch.float32, jnp.float32, 1e-5, 0.0),
          ("bf16", torch.bfloat16, jnp.bfloat16, 1e-6, 2.0 ** -7)]


def _sweep_inputs(dtype_t, dtype_j, r=96, o=12, seed=2):
    rng = np.random.RandomState(seed)
    z = rng.randn(r, o).astype(np.float32)
    g = rng.randn(r, o).astype(np.float32)
    stat = np.stack([rng.randn(o) * 0.1, rng.rand(o) + 0.5,
                     rng.rand(o) + 0.5, rng.randn(o) * 0.2]).astype(np.float32)
    tot = rng.randn(2, o).astype(np.float32) * 3
    zt = torch.tensor(z).to(dtype_t)
    gt = torch.tensor(g).to(dtype_t)
    return (zt, gt, torch.tensor(stat), torch.tensor(tot),
            jnp.asarray(zt.float().numpy()).astype(dtype_j),
            jnp.asarray(gt.float().numpy()).astype(dtype_j),
            jnp.asarray(stat), jnp.asarray(tot))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("name,dt,dj,atol,rtol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_row12_apply_matches_the_kernel_body(name, dt, dj, atol, rtol, relu):
    zt, _, st, _, zj, _, sj, _ = _sweep_inputs(dt, dj)
    out = _Ref(jnp.zeros(zj.shape, dj))
    jcb._apply_kernel(_Ref(zj), _Ref(sj), out, with_relu=relu)
    got = tcb.bn_apply(zt, st, relu)
    assert got.dtype == dt
    _close(got, out.a, atol, rtol)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("name,dt,dj,atol,rtol", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_rows13_14_backward_match_the_kernel_bodies(name, dt, dj, atol, rtol,
                                                    relu):
    zt, gt, st, tt, zj, gj, sj, tj = _sweep_inputs(dt, dj)
    r, o = zt.shape
    dg, db = _Ref(jnp.zeros((1, 1, o))), _Ref(jnp.zeros((1, 1, o)))
    jcb._bwd_reduce_kernel(_Ref(zj), _Ref(gj), _Ref(sj), dg, db,
                           with_relu=relu)
    got_g, got_b = tcb.bn_bwd_reduce(zt, gt, st, relu)
    _close(got_g, dg.a[0, 0], 1e-4, 1e-6)   # f32 sums over 96 rows
    _close(got_b, db.a[0, 0], 1e-4, 1e-6)
    dz = _Ref(jnp.zeros(zj.shape, dj))
    jcb._bwd_dz_kernel(_Ref(zj), _Ref(gj), _Ref(sj), _Ref(tj), dz,
                       with_relu=relu, rcount=1.0 / r)
    got = tcb.bn_bwd_dz(zt, gt, st, tt, relu)
    assert got.dtype == dt
    _close(got, dz.a, atol, rtol)


@pytest.mark.parametrize("xs,ws,strides,pads,with_relu", CASES, ids=IDS)
def test_rows10_11_match_the_pallas_kernels(xs, ws, strides, pads,
                                            with_relu):
    x, w, _, _ = _inputs(xs, ws, seed=4)
    pr = jcb._resolve_pads(pads, xs[1], xs[2], ws[2], ws[3], strides)
    o, c, kh, kw = ws
    w2d = jnp.transpose(jnp.asarray(w), (2, 3, 1, 0)).reshape(kh * kw * c, o)
    xt, wt = torch.tensor(x), torch.tensor(w)
    if (kh, kw) == (1, 1):
        zj, _, sj, ssj = jcb._mm_fwd(jnp.asarray(x), w2d, jnp.float32,
                                     strides)
        got = tcb.mm_stats(xt, wt, strides)
    else:
        zj, _, sj, ssj = jcb._conv_fwd(jnp.asarray(x), w2d, jnp.float32, kh,
                                       kw, pr)
        got = tcb.conv_stats(xt, wt, pr)
    for a, b in zip(got, (zj, sj[0], ssj[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("xs,ws,strides,pads,with_relu", CASES, ids=IDS)
def test_forward_and_backward_match_pallas_fwd_bwd(xs, ws, strides, pads,
                                                   with_relu):
    x, w, scale, bias = _inputs(xs, ws, seed=5)
    pr = jcb._resolve_pads(pads, xs[1], xs[2], ws[2], ws[3], strides)
    jargs = [jnp.asarray(a) for a in (x, w, scale, bias)]
    want = jcb._pallas_fwd(*jargs, strides=strides, pads=pr, eps=1e-5,
                           with_relu=with_relu)
    targs = [torch.tensor(a) for a in (x, w, scale, bias)]
    got = tcb.fused_forward(*targs, strides, pr, 1e-5, with_relu)
    for a, b, nm in zip(got, want, ("y", "z", "stat", "mean", "var")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=nm)
    g = np.random.RandomState(6).randn(*got[0].shape).astype(np.float32)
    jb = jcb._pallas_bwd(jargs[0], jargs[1], want[1], want[2], jnp.asarray(g),
                         strides=strides, pads=pr, with_relu=with_relu)
    tb = tcb.fused_backward(targs[0], targs[1], got[1], got[2],
                            torch.tensor(g), strides, pr, with_relu)
    for a, b, nm in zip(tb, jb, ("dx", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=nm)


P0, P1 = ((0, 0), (0, 0)), ((1, 1), (1, 1))
GATE = [
    ((2, 8, 8, 8), (16, 8, 3, 3), (1, 1), P1, (1, 1), 1),
    ((2, 8, 8, 8), (16, 8, 1, 1), (2, 2), P0, (1, 1), 1),
    ((2, 8, 8, 8), (16, 8, 1, 1), (1, 1), P0, (1, 1), 1),
    ((2, 8, 8, 8), (16, 4, 3, 3), (1, 1), P1, (1, 1), 2),    # grouped
    ((2, 8, 8, 8), (16, 8, 3, 3), (1, 1), P1, (2, 2), 1),    # dilated
    ((2, 8, 8, 8), (16, 8, 3, 3), (2, 2), P1, (1, 1), 1),    # k>1 strided
    ((2, 8, 8, 8), (16, 8, 1, 1), (1, 1), P1, (1, 1), 1),    # padded 1x1
    ((1, 6, 6, 4), (8, 4, 7, 7), (1, 1), ((3, 3), (3, 3)), (1, 1), 1),
    ((1, 3, 3, 4), (8, 4, 5, 5), (1, 1), P0, (1, 1), 1),     # empty output
    ((2, 8, 8, 12), (8, 12, 4, 4), (1, 1), ((2, 1), (2, 1)), (1, 1), 1),
    ((2, 7, 7, 8), (16, 8, 7, 7), (2, 2), ((3, 3), (3, 3)), (1, 1), 1),
]


@pytest.mark.parametrize("xs,ws,strides,pads,dil,groups", GATE)
def test_gate_matches_the_structural_part_of_jax(xs, ws, strides, pads, dil,
                                                 groups):
    # at these sizes JAX's VMEM term always passes: the gates agree
    assert tcb.conv_bn_shapes_ok(xs, ws, strides, pads, dil, groups) == \
        jcb.conv_bn_shapes_ok(xs, ws, strides, pads, dil, groups)


def test_kernel_input_checks():
    x = torch.zeros(2, 8, 8, 8)
    w = torch.zeros(16, 8, 3, 3)
    tcb.check_kernel_inputs(x, w, (1, 1), P1)
    tcb.check_kernel_inputs(x.bfloat16(), w.bfloat16(), (1, 1), P1)
    with pytest.raises(ValueError, match="one dtype"):
        tcb.check_kernel_inputs(x, w.bfloat16(), (1, 1), P1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcb.check_kernel_inputs(x.half(), w.half(), (1, 1), P1)
    with pytest.raises(ValueError, match="conv_bn_shapes_ok"):
        tcb.check_kernel_inputs(x, w, (2, 2), P1)
    with pytest.raises(ValueError, match="contiguous"):
        tcb.check_kernel_inputs(x.transpose(1, 2), w, (1, 1), P1)
    z = torch.zeros(64, 8)
    stat = torch.zeros(4, 8)
    tcb.check_sweep_inputs(z, stat, z.clone())
    with pytest.raises(ValueError, match="stat"):
        tcb.check_sweep_inputs(z, torch.zeros(4, 7))
    with pytest.raises(ValueError, match="must match z"):
        tcb.check_sweep_inputs(z, stat, z.bfloat16())
    # CPU and meta tensors take the plain versions; no other device
    assert tcb._device_check(z) is False
    assert tcb._device_check(z.to("meta")) is False

    class OnXpu:
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="no conv_bn kernel"):
        tcb._device_check(OnXpu())


def test_sweep_rows_fill_the_card():
    # [401408, 256] (ResNet-50 stage 0 at batch 128): 1568 blocks of 256
    # rows, 64 threads of 4 channels by 4 rows
    assert tcb.sweep_layout(401408, 256) == (256, 4, 64, 4)
    # [6272, 2048] (stage 3): two channel blocks, 16 rows a block
    assert tcb.sweep_layout(6272, 2048) == (16, 4, 256, 1)
    # odd channels: one a thread; every layout fits one block's threads
    rb, vec, tx, ty = tcb.sweep_layout(7, 7)
    assert (vec, tx) == (1, 7) and rb >= 1
    for rows, o in ((7, 7), (401408, 256), (6272, 2048), (100, 1030)):
        rb, vec, tx, ty = tcb.sweep_layout(rows, o)
        assert o % vec == 0 and tx * ty <= tcb.SWEEP_THREADS
        assert -(-(o // vec) // tx) * tx * vec >= o


# ---------------------------------------------------------------------------
# row 10's two routes (the wgmma kernel for bf16, the SIMT one for f32),
# decided by dtype and shape alone
# ---------------------------------------------------------------------------

# ResNet-50's four 3 x 3 stage shapes at batch 128: (rows, C, O)
STAGES = {"s0": (401408, 64, 64), "s1": (100352, 128, 128),
          "s2": (25088, 256, 256), "s3": (6272, 512, 512)}


@pytest.mark.parametrize("dtype,c,o,route", [
    (torch.bfloat16, 64, 64, "tc"), (torch.bfloat16, 512, 512, "tc"),
    (torch.bfloat16, 8, 40, "tc"), (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 3, 64, "simt"), (torch.bfloat16, 64, 12, "simt"),
    (torch.float16, 64, 64, "simt")])
def test_conv_route_by_dtype_and_shape(dtype, c, o, route):
    assert tcb.conv_route(dtype, c, o) == route


def test_every_resnet50_stage_takes_the_wgmma_kernel_at_its_tile():
    want = {"s0": (128, 64), "s1": (128, 128), "s2": (128, 128),
            "s3": (128, 128)}
    for name, (rows, c, o) in STAGES.items():
        assert tcb.conv_route(torch.bfloat16, c, o) == "tc"
        assert tcb.conv_tc_tile(rows, o) == want[name]
    assert tcb.conv_tc_tile(640, 40) == (128, 64)


@pytest.mark.parametrize("name,dtype,c,rows,o,tile", [
    ("conv_stats", torch.bfloat16, 64, 401408, 64, 128),
    ("conv_stats", torch.bfloat16, 256, 25088, 256, 128),
    ("conv_stats", torch.float32, 64, 401408, 64, tcb.TILE_ROWS),
    ("conv_stats", torch.bfloat16, 3, 32768, 64, tcb.TILE_ROWS),
    ("mm_stats", torch.bfloat16, 64, 401408, 256, 128),
    ("mm_stats", torch.bfloat16, 256, 401408, 64, 64),
    ("mm_stats", torch.float32, 64, 401408, 256, tcb.TILE_ROWS),
    ("mm_stats", torch.bfloat16, 3, 32768, 64, tcb.TILE_ROWS)])
def test_partials_follow_each_kernels_own_tile_rows(name, dtype, c, rows, o,
                                                    tile):
    assert tcb.conv_tile_rows(name, dtype, c, rows, o) == tile
    t = tcb.stat_tiles(rows, tile)
    assert (t - 1) * tile < rows <= t * tile


def test_a_cpu_call_counts_no_launch_on_either_route():
    x = torch.randn(2, 8, 8, 8).to(torch.bfloat16)
    w = (torch.randn(16, 8, 3, 3) * 0.1).to(torch.bfloat16)
    n0 = (tcb.conv_stats.launches, tcb.conv_stats.launches_tc)
    z, s, ss = tcb.conv_stats(x, w, ((1, 1), (1, 1)))
    assert z.shape == (128, 16) and z.dtype == torch.bfloat16
    assert (tcb.conv_stats.launches, tcb.conv_stats.launches_tc) == n0


# ---------------------------------------------------------------------------
# row 11's two routes: the wgmma kernel for bf16, the SIMT one otherwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,c,o,route,tile", [
    (torch.bfloat16, 64, 256, "tc", (128, 128, 2)),
    (torch.bfloat16, 256, 64, "tc", (64, 64, 2)),
    (torch.bfloat16, 1024, 256, "tc", (128, 128, 2)),
    (torch.bfloat16, 128, 512, "tc", (128, 128, 2)),
    (torch.bfloat16, 8, 40, "tc", (64, 64, 2)),
    (torch.float32, 64, 256, "simt", None),
    (torch.bfloat16, 3, 64, "simt", None),
    (torch.bfloat16, 64, 12, "simt", None)])
def test_mm_route_and_tile_by_dtype_and_shape(dtype, c, o, route, tile):
    """Row 11 routes as row 10 (``conv_route``: bf16 with C and O
    multiples of 8 on the wgmma kernel); its tile and ring come from
    ``mm_tc_tile``, and its partials follow the tile's rows."""
    assert tcb.conv_route(dtype, c, o) == route
    rows = 401408
    if tile is None:
        assert tcb.conv_tile_rows("mm_stats", dtype, c, rows, o) == \
            tcb.TILE_ROWS
        return
    assert tcb.mm_tc_tile(rows, c, o) == tile
    assert tcb.conv_tile_rows("mm_stats", dtype, c, rows, o) == tile[0]


def _resnet50_1x1_shapes():
    """(rows, C, O, stride) of every 1 x 1 fused_conv_bn of the port's
    ResNet-50 training program at batch 128, 224 x 224."""
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch.fluid import flags as tflags
    from paddle_tpu_torch.models import resnet as tresnet

    tflags.set_flags({"FLAGS_conv_bn_fusion": True})
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard():
            m, st, _, loss = tresnet.build_resnet_train_program(
                tresnet.ResNetConfig.resnet50(), 128, 224, main, startup)
            with tfluid.program_guard(m, st):   # the pass runs here
                tfluid.optimizer.MomentumOptimizer(
                    0.1, momentum=0.9).minimize(loss)
    finally:
        tflags.set_flags({"FLAGS_conv_bn_fusion": False})
    blk = m.global_block()
    out = []
    for op in blk.ops:
        if op.type != "fused_conv_bn":
            continue
        xs = blk.var(op.input("Input")[0]).shape
        ws = blk.var(op.input("Filter")[0]).shape
        if tuple(ws[2:]) != (1, 1):
            continue
        st = tuple(op.attr("strides"))
        ho, wo = -(-xs[1] // st[0]), -(-xs[2] // st[1])
        out.append((xs[0] * ho * wo, xs[3], ws[0], st[0]))
    return out


def test_every_resnet50_1x1_conv_takes_the_wgmma_kernel():
    """All 36 1 x 1 convs of a ResNet-50 step (the five shapes
    chip_smoke.py times among them) take the wgmma route in bf16, each at
    the tile and ring ``mm_tc_tile`` gives, and size their partials by
    its rows."""
    shapes = _resnet50_1x1_shapes()
    assert len(shapes) == 36
    assert {(401408, 64, 256, 1), (401408, 256, 64, 1),
            (100352, 256, 512, 2), (25088, 1024, 256, 1),
            (6272, 512, 2048, 1)} <= set(shapes)
    for rows, c, o, _ in shapes:
        assert tcb.conv_route(torch.bfloat16, c, o) == "tc"
        bm, bn, stages = tcb.mm_tc_tile(rows, c, o)
        assert bm == bn == (128 if o % 128 == 0 else 64) and stages == 2
        assert tcb.conv_tile_rows("mm_stats", torch.bfloat16, c, rows,
                                  o) == bm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_a_cpu_mm_call_counts_no_launch_on_either_route(dtype):
    x = torch.randn(2, 8, 8, 16).to(dtype)
    w = (torch.randn(32, 16, 1, 1) * 0.1).to(dtype)
    n0 = (tcb.mm_stats.launches, tcb.mm_stats.launches_tc)
    z, s, ss = tcb.mm_stats(x, w, (2, 2))
    assert z.shape == (32, 32) and z.dtype == dtype
    assert (tcb.mm_stats.launches, tcb.mm_stats.launches_tc) == n0


class _Dev:
    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "mm_stats_tc"),
                                         (torch.float32, "mm_stats")])
def test_mm_stats_launches_its_route_and_never_falls_back(dtype, entry,
                                                          monkeypatch):
    """On the card (here a stand-in launcher) row 11 calls its route's
    library entry once: ``conv_bn_mm_stats_tc_launch`` for bf16 with the
    K-major [O, C] weights, the stride and ``mm_tc_tile``'s tile and
    ring, or the SIMT ``conv_bn_mm_stats_launch``; ``launches`` counts
    both, ``launches_tc`` the first.  A launch that fails raises and
    counts nothing: nothing retries it on the other route."""
    monkeypatch.setattr(tcb, "_device_check", lambda x: True)
    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    calls = []
    monkeypatch.setattr(tcb, "_launcher", lambda name: lambda *a: (
        calls.append((name, a)) or 0))
    x = torch.zeros(2, 9, 9, 16, dtype=dtype)
    w = torch.zeros(24, 16, 1, 1, dtype=dtype)
    n0 = (tcb.mm_stats.launches, tcb.mm_stats.launches_tc)
    tc = dtype == torch.bfloat16
    z, s, ss = tcb.mm_stats(x, w, (2, 2))
    (name, args), = calls
    assert name == entry and z.shape == (2 * 5 * 5, 24)
    assert s.shape == ss.shape == (24,)
    if tc:
        assert args[4:] == (2, 9, 9, 16, 24, 2, 2, 5, 5, 64, 64, 2, 0)
    else:
        assert args[4:] == (2, 9, 9, 16, 24, 2, 2, 5, 5, 0, 0)
    assert (tcb.mm_stats.launches, tcb.mm_stats.launches_tc) == (
        n0[0] + 1, n0[1] + tc)

    calls.clear()
    monkeypatch.setattr(tcb, "_launcher", lambda name: lambda *a: (
        calls.append(name) or 700))
    monkeypatch.setattr(tcb, "_fns", {})
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tcb.mm_stats(x, w, (2, 2))
    assert calls == [entry]
    assert (tcb.mm_stats.launches, tcb.mm_stats.launches_tc) == (
        n0[0] + 1, n0[1] + tc)


def test_bound_bytes_count_what_the_conv_reads():
    """A 1 x 1 conv at stride 2 reads only the pixels it samples (the
    stage-1 projection: x [128, 56, 56, 256] at stride 2 into 512
    channels); a k x k conv at stride 1 all of x."""
    x = torch.empty(128, 56, 56, 256, dtype=torch.bfloat16, device="meta")
    w = torch.empty(512, 256, 1, 1, dtype=torch.bfloat16, device="meta")
    rows = 128 * 28 * 28
    assert tcb.bound_bytes_conv(x, w, (2, 2), ((0, 0), (0, 0))) == (
        (rows * 256 + 512 * 256 + rows * 512) * 2 + 8 * 512)
    w3 = torch.empty(256, 256, 3, 3, dtype=torch.bfloat16, device="meta")
    assert tcb.bound_bytes_conv(x, w3, (1, 1), ((1, 1), (1, 1))) == (
        (x.numel() + w3.numel() + 128 * 56 * 56 * 256) * 2 + 8 * 256)
