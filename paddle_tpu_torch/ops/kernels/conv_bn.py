"""Fused NHWC conv -> batch_norm (training statistics) -> optional ReLU.

Same semantics as the JAX package's ``ops/pallas/conv_bn.py``
``fused_conv_bn`` and its custom VJP:

    z        = conv(x, w)                 NHWC x, OIHW w, rounded to x's dtype
    m, v     = one-pass f32 moments of z  (v = max(E[z^2] - m^2, 0))
    y        = (z - m) * rsqrt(v + eps) * scale + shift  [ReLU], x's dtype
    returns (y, m, v)

and its backward, which rebuilds the ReLU mask from the statistics,
reduces dgamma = sum g * xhat and dbeta = sum g, forms the BN input
cotangent dz = rstd * scale * (g - dbeta / R - xhat * dgamma / R), and
leaves dX and dW to the library convolution (as the JAX package leaves
them to XLA).  The batch statistics get no cotangent.

Five kernels (``csrc/conv_bn.cu``, sm_90a, built by nvcc at first use and
bound with ctypes), each behind a wrapper that launches it for CUDA
tensors, takes its plain PyTorch version for CPU and meta tensors, and
counts its launches in ``<wrapper>.launches``:

| wrapper         | replaces (paddle_tpu/ops/pallas/conv_bn.py)          |
| --------------- | ---------------------------------------------------- |
| ``conv_stats``  | ``_conv_stats_kernel`` (``_conv_fwd``, :354), row 10 |
| ``mm_stats``    | ``_mm_stats_kernel`` (``_mm_fwd``, :387), row 11     |
| ``bn_apply``    | ``_apply_kernel`` (``_pallas_fwd``, :478), row 12    |
| ``bn_bwd_reduce`` | ``_bwd_reduce_kernel`` (``_pallas_bwd``, :496), row 13 |
| ``bn_bwd_dz``   | ``_bwd_dz_kernel`` (``_pallas_bwd``, :510), row 14   |

Bounds on the H100 (``bound_*`` below): ``conv_stats`` / ``mm_stats``
the larger of x, w and z moved once at 3.35 TB/s and 2 * M * O * K
operations at the dtype's peak (989 TFLOP/s bf16, 67 TFLOP/s f32);
the three sweeps bytes alone.  Design: the source's header note (an
implicit GEMM with the halo zero-filled in the kernel and per-tile
statistics partials; sweeps that hold the statistic rows in registers;
one shared ReLU predicate).  Rows 10 and 11 each have two kernels, chosen
by dtype and shape alone (``conv_route``): bf16 with C and O multiples of
8 runs the wgmma kernel (``conv_stats_tc`` in the source; row 10's tile
from ``conv_tc_tile``, row 11's tile and ring from ``mm_tc_tile``),
everything else the SIMT one; ``conv_stats.launches`` and
``mm_stats.launches`` count both, ``.launches_tc`` the wgmma kernel's.

``fused_conv_bn`` is the dispatcher: shapes that pass
``conv_bn_shapes_ok`` (groups 1, dilation 1; a 1 x 1 conv with no padding
at any stride, or a k x k conv at stride 1) run the autograd Function
over the five wrappers; other shapes (the k x k stride-2 convs) take
``conv_bn_reference``, as the JAX package does, and count
``fused_conv_bn.reference_routes``.  The route is decided by shape before
anything launches; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 64          # rows of z a SIMT conv block computes (one partial row)
SWEEP_THREADS = 256     # threads of an apply / bwd_reduce / bwd_dz block


def _resolve_pads(pad, h, w, kh, kw, strides):
    """Normalize a lax-style padding spec ("SAME", "VALID" or
    [(lo, hi), (lo, hi)]) to explicit ((lo, hi), (lo, hi)); SAME gives
    the low side total // 2."""
    if pad == "VALID":
        return ((0, 0), (0, 0))
    if pad == "SAME":
        out = []
        for size, k, s in ((h, kh, strides[0]), (w, kw, strides[1])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple((int(lo), int(hi)) for lo, hi in pad)


def conv_bn_shapes_ok(x_shape, w_shape, strides, pads, dilations=(1, 1),
                      groups=1) -> bool:
    """Structural gate of the kernel path (pads explicit): the JAX
    package's ``conv_bn_shapes_ok`` without its TPU VMEM term."""
    n, h, w, c = x_shape
    o, cg, kh, kw = w_shape
    if groups != 1 or tuple(dilations) != (1, 1) or cg != c:
        return False
    if (kh, kw) == (1, 1):
        return all(tuple(p) == (0, 0) for p in pads)
    if tuple(strides) != (1, 1):
        return False
    ho = h + pads[0][0] + pads[0][1] - kh + 1
    wo = w + pads[1][0] + pads[1][1] - kw + 1
    return ho > 0 and wo > 0


# ---------------------------------------------------------------------------
# the library convolution over NHWC tensors (reference route, dX / dW)
# ---------------------------------------------------------------------------


def _symmetric(pads) -> bool:
    return pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]


def _pad_nhwc(x, pads):
    (t, b), (l, r) = pads
    return F.pad(x, (0, 0, l, r, t, b))


def conv2d_nhwc(x, w, strides, pads, dilations=(1, 1), groups=1):
    """conv over NHWC ``x`` and OIHW ``w`` with explicit (lo, hi) pads:
    the library convolution on the channels_last view of x, whose result
    permuted back is NHWC without a copy.  Asymmetric pads go through
    F.pad first.  An x that is an NHWC view of NCHW memory (the stem's
    image after transpose2) is made contiguous first: handed over as it
    is, it would reach cuDNN as NCHW and the conv would convert x, its
    output and, in the backward, the output's gradient between
    layouts."""
    x = x.contiguous()
    if _symmetric(pads):
        padding = (pads[0][0], pads[1][0])
    else:
        x, padding = _pad_nhwc(x, pads), (0, 0)
    z = F.conv2d(x.permute(0, 3, 1, 2), w, None, tuple(strides), padding,
                 tuple(dilations), groups)
    return z.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc_backward(x, w, dz, strides, pads):
    """(dx, dw) of ``conv2d_nhwc`` (groups 1, dilation 1) for the output
    cotangent ``dz`` [N, Ho, Wo, O]: one library call,
    ``aten.convolution_backward``, on channels_last views."""
    sym = _symmetric(pads)
    xp = x if sym else _pad_nhwc(x, pads)
    padding = [pads[0][0], pads[1][0]] if sym else [0, 0]
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        dz.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), w, None,
        list(strides), padding, [1, 1], False, [0, 0], 1,
        [True, True, False])
    dx = dxp.permute(0, 2, 3, 1)
    if not sym:
        h, wd = x.shape[1], x.shape[2]
        dx = dx[:, pads[0][0]:pads[0][0] + h, pads[1][0]:pads[1][0] + wd]
    return dx.contiguous(), dw


def conv_bn_reference(x, w, scale, bias, *, strides, pads, eps=1e-5,
                      with_relu=False):
    """The plain composition (JAX package ``conv_bn_reference``): returns
    (y, batch_mean, batch_var), f32 one-pass moments; differentiable by
    autograd."""
    z = conv2d_nhwc(x, w, strides, pads)
    zf = z.float()
    m = zf.mean(dim=(0, 1, 2))
    v = torch.clamp_min((zf * zf).mean(dim=(0, 1, 2)) - m * m, 0.0)
    inv = torch.rsqrt(v + eps)
    y = (zf - m) * inv * scale.float() + bias.float()
    if with_relu:
        y = torch.relu(y)
    return y.to(x.dtype), m, v


# ---------------------------------------------------------------------------
# plain versions of the five kernels (the CPU's path; the card's yardstick)
# ---------------------------------------------------------------------------


def conv_stats_reference(x, w, strides, pads):
    """Rows 10 and 11: z [N*Ho*Wo, O] in x's dtype and the f32 sum and
    sum of squares over rows of the rounded z."""
    z = conv2d_nhwc(x, w, strides, pads).reshape(-1, w.shape[0])
    zf = z.float()
    return z, zf.sum(0), (zf * zf).sum(0)


def bn_apply_reference(z, stat, with_relu):
    """Row 12: (z - mean) * rstd * scale + shift [ReLU] in z's dtype;
    stat rows (mean, rstd, scale, shift)."""
    y = (z.float() - stat[0]) * stat[1] * stat[2] + stat[3]
    if with_relu:
        y = torch.relu(y)
    return y.to(z.dtype)


def _masked_grad(z, g, stat, with_relu):
    xhat = (z.float() - stat[0]) * stat[1]
    g = g.float()
    if with_relu:
        g = torch.where(xhat * stat[2] + stat[3] > 0.0, g, 0.0)
    return xhat, g


def bn_bwd_reduce_reference(z, g, stat, with_relu):
    """Row 13: (dgamma, dbeta) f32 over rows, with the ReLU mask rebuilt
    from ``stat``."""
    xhat, g = _masked_grad(z, g, stat, with_relu)
    return (g * xhat).sum(0), g.sum(0)


def bn_bwd_dz_reference(z, g, stat, tot, with_relu):
    """Row 14: dz = rstd * scale * (g - dbeta / R - xhat * dgamma / R) in
    z's dtype; tot rows (dgamma, dbeta)."""
    rcount = 1.0 / z.shape[0]
    xhat, g = _masked_grad(z, g, stat, with_relu)
    dz = stat[1] * stat[2] * (g - tot[1] * rcount - xhat * tot[0] * rcount)
    return dz.to(z.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _out_hw(x_shape, w_shape, strides, pads):
    h, w = x_shape[1], x_shape[2]
    kh, kw = w_shape[2], w_shape[3]
    return ((h + pads[0][0] + pads[0][1] - kh) // strides[0] + 1,
            (w + pads[1][0] + pads[1][1] - kw) // strides[1] + 1)


def check_kernel_inputs(x, w, strides, pads) -> None:
    """What the conv kernels take; raises ValueError on anything else.
    Device-independent, so the CPU tests call it directly."""
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"conv_bn kernels take float32 or bfloat16 x and w "
                         f"of one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be NHWC and w OIHW")
    if not conv_bn_shapes_ok(tuple(x.shape), tuple(w.shape), strides, pads):
        raise ValueError(f"conv_bn kernels do not take x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, strides {strides}, pads "
                         f"{pads} (conv_bn_shapes_ok)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def check_sweep_inputs(z, stat, *others) -> None:
    """What the apply / backward sweeps take: z [R, O] contiguous f32 or
    bf16, stat [4, O] f32, g like z."""
    if z.dim() != 2 or z.dtype not in _DTYPE_CODES:
        raise ValueError(f"z must be [R, O] float32 or bfloat16, got "
                         f"{tuple(z.shape)} {z.dtype}")
    o = z.shape[1]
    if stat.dtype != torch.float32 or tuple(stat.shape) != (4, o):
        raise ValueError(f"stat must be float32 [4, {o}], got {stat.dtype} "
                         f"{tuple(stat.shape)}")
    for t in (z, stat, *others):
        if not t.is_contiguous():
            raise ValueError("z, g and the statistics must be contiguous")
        if t.device != z.device:
            raise ValueError(f"a tensor is on {t.device}, z on {z.device}")
        if t.data_ptr() % 16:
            raise ValueError("z, g and the statistics must be 16-byte "
                             "aligned")
    for g in others:
        if g.dtype != z.dtype or g.shape != z.shape:
            raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match z "
                             f"{tuple(z.shape)} {z.dtype}")


_fns = {}
_ARGTYPES = {
    "conv_stats": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
    "conv_stats_tc": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
    + [ctypes.c_void_p],
    "mm_stats": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "mm_stats_tc": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
    "apply": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "bwd_reduce": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "bwd_dz": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _launcher(name: str):
    """The ctypes function ``conv_bn_<name>_launch`` of the built library."""
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("conv_bn"), f"conv_bn_{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name, x, *args):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher(name)(*args, _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"conv_bn {name} kernel launch failed: CUDA "
                           f"error {err}")


def _device_check(x) -> bool:
    """True for a CUDA tensor (launch), False for CPU / meta (plain)."""
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no conv_bn kernel for device {x.device}")
    return True


def conv_route(dtype, c: int, o: int) -> str:
    """Which kernel rows 10 and 11 launch, by dtype and shape alone: "tc"
    (the wgmma kernel) for bf16 with C and O multiples of 8 (16-byte rows
    of x, w and z); "simt" (f32 FMA) for float32, which tensor cores
    would round to TF32, and for any other bf16 shape."""
    if dtype == torch.bfloat16 and c % 8 == 0 and o % 8 == 0:
        return "tc"
    return "simt"


def conv_tc_tile(rows: int, o: int) -> tuple:
    """(bm, bn) of row 10's wgmma kernel: rows and output channels a
    block.  128 rows, and 128 channels where O allows it, else 64.  Timed
    on the H100 at ResNet-50's four 3 x 3 stage shapes (chip_smoke.py's
    tile sweep, PERF.md row 10), the largest tile was the fastest of the
    four or within 3% of it at every stage, the deep stages' part-empty
    last wave included: fewer, larger blocks re-read fewer A and B tiles
    through L2."""
    return 128, 128 if o % 128 == 0 else 64


def mm_tc_tile(rows: int, c: int, o: int) -> tuple:
    """(bm, bn, stages) of row 11's wgmma kernel: rows and output channels
    a block, and the k-blocks (64 input channels each) its ring holds.
    The 1 x 1 convs have C / 64 k-blocks, one at C = 64, so a deep ring
    overlaps nothing there and only keeps blocks off the SM: 2 stages,
    and a 128 x 128 tile where O allows it, else 64 x 64.  Timed on an
    H100 (chip_smoke.py's sweep of 4 tiles x 2 ring depths, PERF.md row
    11) at ResNet-50's five 1 x 1 shapes, this was the fastest of the
    eight or within 2% of it at every shape; the same sweep in another
    call moved single timings by up to 10%."""
    if o % 128 == 0:
        return 128, 128, 2
    return 64, 64, 2


def conv_tile_rows(name: str, dtype, c: int, rows: int, o: int) -> int:
    """Rows of z one block of the kernel ``name`` ("conv_stats" or
    "mm_stats") launches for these shapes computes: the wgmma tile's bm
    on that route (``conv_tc_tile``, ``mm_tc_tile``), TILE_ROWS on the
    SIMT kernel."""
    if conv_route(dtype, c, o) != "tc":
        return TILE_ROWS
    if name == "conv_stats":
        return conv_tc_tile(rows, o)[0]
    return mm_tc_tile(rows, c, o)[0]


def stat_tiles(rows: int, tile_rows: int) -> int:
    """Rows T of the [2, T, O] statistics partials: one a tile of
    ``tile_rows`` rows of z, the launching kernel's own."""
    return -(-rows // tile_rows)


def _cuda_conv(name, x, w, strides, pads):
    check_kernel_inputs(x, w, strides, pads)
    n, h, wd, c = x.shape
    o, _, kh, kw = w.shape
    ho, wo = _out_hw(x.shape, w.shape, strides, pads)
    rows = n * ho * wo
    tc = conv_route(x.dtype, c, o) == "tc"
    bm = conv_tile_rows(name, x.dtype, c, rows, o)
    if tc:
        wk = w.permute(2, 3, 0, 1).contiguous()   # [kh, kw, O, C]
    else:
        wk = w.permute(2, 3, 1, 0).contiguous()   # [kh, kw, C, O]
    z = torch.empty((rows, o), dtype=x.dtype, device=x.device)
    part = torch.empty((2, stat_tiles(rows, bm), o), dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), wk.data_ptr(), z.data_ptr(), part.data_ptr(), n, h,
            wd, c, o)
    if not tc:
        geom = ((kh, kw, pads[0][0], pads[1][0]) if name == "conv_stats"
                else tuple(strides))
        _launch(name, x, *ptrs, *geom, ho, wo)
    else:
        if name == "conv_stats":
            tail = (kh, kw, pads[0][0], pads[1][0], ho, wo,
                    *conv_tc_tile(rows, o))
        else:
            tail = (*strides, ho, wo, *mm_tc_tile(rows, c, o))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _launcher(f"{name}_tc")(*ptrs, *tail, stream)
        if err:
            raise RuntimeError(f"conv_bn {name}_tc kernel launch failed: "
                               f"CUDA error {err}")
    s, ss = part.sum(dim=1)
    return z, s, ss


def _count(fn, x, c, o):
    fn.launches += 1
    if conv_route(x.dtype, c, o) == "tc":
        fn.launches_tc += 1


def conv_stats(x, w, pads):
    """Row 10: k x k stride-1 conv of NHWC x by OIHW w with explicit pads
    -> (z [N*Ho*Wo, O] in x's dtype, sum, sum of squares of z, f32).
    CUDA tensors take the route ``conv_route`` names; ``launches`` counts
    every launch, ``launches_tc`` those of the wgmma kernel."""
    if not _device_check(x):
        return conv_stats_reference(x, w, (1, 1), pads)
    out = _cuda_conv("conv_stats", x, w, (1, 1), pads)
    _count(conv_stats, x, x.shape[3], w.shape[0])
    return out


def mm_stats(x, w, strides):
    """Row 11: 1 x 1 conv of NHWC x by OIHW w at ``strides`` -> (z, sum,
    sum of squares), as ``conv_stats``: the route ``conv_route`` names,
    ``launches`` and ``launches_tc`` likewise."""
    pads = ((0, 0), (0, 0))
    if not _device_check(x):
        return conv_stats_reference(x, w, strides, pads)
    out = _cuda_conv("mm_stats", x, w, tuple(strides), pads)
    _count(mm_stats, x, x.shape[3], w.shape[0])
    return out


conv_stats.launches = 0
conv_stats.launches_tc = 0
mm_stats.launches = 0
mm_stats.launches_tc = 0


def sweep_layout(rows: int, o: int) -> tuple:
    """The apply / backward sweeps' launch layout over z [rows, o], which
    the kernels take as given: (rb, vec, tx, ty) = rows a block, channels
    a thread (4 when o % 4 == 0, else 1), and a block of tx threads along
    the channel groups by ty along rows (tx * ty <= SWEEP_THREADS).  rb is
    halved from 256 until the grid has 4 blocks an SM of an H100 (528), at
    least one row a thread row."""
    vec = 4 if o % 4 == 0 else 1
    cg = o // vec
    tx = min(cg, SWEEP_THREADS)
    ty = SWEEP_THREADS // tx
    gy = -(-cg // tx)
    rb = 256
    while rb > ty and -(-rows // rb) * gy < 528:
        rb //= 2
    return max(rb, 1), vec, tx, ty


def bn_apply(z, stat, with_relu):
    """Row 12: normalise z [R, O] with stat [4, O] (mean, rstd, scale,
    shift) and apply the ReLU; y in z's dtype."""
    if not _device_check(z):
        return bn_apply_reference(z, stat, with_relu)
    check_sweep_inputs(z, stat)
    rows, o = z.shape
    y = torch.empty_like(z)
    _launch("apply", z, z.data_ptr(), stat.data_ptr(), y.data_ptr(), rows, o,
            int(with_relu), *sweep_layout(rows, o))
    bn_apply.launches += 1
    return y


def bn_bwd_reduce(z, g, stat, with_relu):
    """Row 13: (dgamma, dbeta) f32 [O] of the cotangent g [R, O], with the
    ReLU mask rebuilt from stat; the kernel's per-block partials are
    summed here in a fixed order."""
    if not _device_check(z):
        return bn_bwd_reduce_reference(z, g, stat, with_relu)
    check_sweep_inputs(z, stat, g)
    rows, o = z.shape
    layout = sweep_layout(rows, o)
    part = torch.empty((2, -(-rows // layout[0]), o), dtype=torch.float32,
                       device=z.device)
    _launch("bwd_reduce", z, z.data_ptr(), g.data_ptr(), stat.data_ptr(),
            part.data_ptr(), rows, o, int(with_relu), *layout)
    bn_bwd_reduce.launches += 1
    dgamma, dbeta = part.sum(dim=1)
    return dgamma, dbeta


def bn_bwd_dz(z, g, stat, tot, with_relu):
    """Row 14: the BN input cotangent dz [R, O] in z's dtype; tot [2, O]
    f32 rows (dgamma, dbeta)."""
    if not _device_check(z):
        return bn_bwd_dz_reference(z, g, stat, tot, with_relu)
    check_sweep_inputs(z, stat, g)
    rows, o = z.shape
    if tot.dtype != torch.float32 or tuple(tot.shape) != (2, o) \
            or not tot.is_contiguous():
        raise ValueError(f"tot must be contiguous float32 [2, {o}]")
    dz = torch.empty_like(z)
    _launch("bwd_dz", z, z.data_ptr(), g.data_ptr(), stat.data_ptr(),
            tot.data_ptr(), dz.data_ptr(), rows, o, int(with_relu),
            *sweep_layout(rows, o), 1.0 / rows)
    bn_bwd_dz.launches += 1
    return dz


bn_apply.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_dz.launches = 0


# ---------------------------------------------------------------------------
# the differentiable fused op and the dispatcher
# ---------------------------------------------------------------------------


def fused_forward(x, w, scale, bias, strides, pads, eps, with_relu):
    """Rows 10/11 then 12: (y NHWC, z [R, O], stat [4, O], mean, var)."""
    n = x.shape[0]
    o = w.shape[0]
    if tuple(w.shape[2:]) == (1, 1):
        z, s, ss = mm_stats(x, w, strides)
    else:
        z, s, ss = conv_stats(x, w, pads)
    r = z.shape[0]
    m = s / r
    v = torch.clamp_min(ss / r - m * m, 0.0)
    inv = torch.rsqrt(v + eps)
    stat = torch.stack([m, inv, scale.float(), bias.float()])
    y = bn_apply(z, stat, with_relu)
    ho, wo = _out_hw(x.shape, w.shape, strides, pads)
    return y.reshape(n, ho, wo, o), z, stat, m, v


def fused_backward(x, w, z, stat, g, strides, pads, with_relu):
    """Rows 13 then 14, then the library dX / dW: (dx, dw, dgamma,
    dbeta)."""
    rows, o = z.shape
    g2d = g.reshape(rows, o).to(z.dtype).contiguous()
    if g2d.data_ptr() % 16:  # a view autograd handed over unaligned
        g2d = g2d.clone()
    dgamma, dbeta = bn_bwd_reduce(z, g2d, stat, with_relu)
    dz = bn_bwd_dz(z, g2d, stat, torch.stack([dgamma, dbeta]), with_relu)
    dx, dw = conv2d_nhwc_backward(x, w, dz.reshape(g.shape), strides, pads)
    return dx, dw, dgamma, dbeta


class _FusedConvBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, strides, pads, eps, with_relu):
        y, z, stat, m, v = fused_forward(x, w, scale, bias, strides, pads,
                                         eps, with_relu)
        # (x, w, z, stat) as the JAX package's core_fwd keeps them: not y
        ctx.save_for_backward(x, w, z, stat)
        ctx.cfg = (strides, pads, with_relu, scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(m, v)
        return y, m, v

    @staticmethod
    def backward(ctx, g, _dm, _dv):
        # the batch statistics are state: their cotangents are ignored
        x, w, z, stat = ctx.saved_tensors
        strides, pads, with_relu, sdt, bdt = ctx.cfg
        dx, dw, dgamma, dbeta = fused_backward(x, w, z, stat, g, strides,
                                               pads, with_relu)
        return dx, dw, dgamma.to(sdt), dbeta.to(bdt), None, None, None, None


def fused_conv_bn(x, w, scale, bias, *, strides=(1, 1), pads="SAME",
                  eps=1e-5, with_relu=False):
    """Training-mode conv + BN (+ ReLU) over NHWC x and OIHW w: returns
    (y, batch_mean, batch_var), the moments f32.  Shapes that pass
    ``conv_bn_shapes_ok`` run the kernels (their plain versions on the
    CPU) through a differentiable Function; the rest take
    ``conv_bn_reference``."""
    strides = tuple(int(s) for s in strides)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    pads = _resolve_pads(pads, x.shape[1], x.shape[2], kh, kw, strides)
    if conv_bn_shapes_ok(tuple(x.shape), tuple(w.shape), strides, pads):
        return _FusedConvBN.apply(x.contiguous(), w, scale, bias, strides,
                                  pads, float(eps), bool(with_relu))
    fused_conv_bn.reference_routes += 1
    return conv_bn_reference(x, w, scale, bias, strides=strides, pads=pads,
                             eps=eps, with_relu=with_relu)


fused_conv_bn.reference_routes = 0


# ---------------------------------------------------------------------------
# bounds (bytes each input read once and each output written once; flops)
# ---------------------------------------------------------------------------


def bound_bytes_conv(x, w, strides, pads) -> int:
    """The x elements the conv reads, w and z moved once, plus the f32
    sum and sum of squares.  A k x k conv at stride 1 reads all of x; a
    1 x 1 conv at stride (sh, sw) only the N * Ho * Wo pixels it
    samples."""
    ho, wo = _out_hw(x.shape, w.shape, strides, pads)
    rows = x.shape[0] * ho * wo
    o, c = w.shape[0], w.shape[1]
    x_read = rows * c if tuple(w.shape[2:]) == (1, 1) else x.numel()
    return (x_read + w.numel() + rows * o) * x.element_size() + 2 * 4 * o


def bound_flops_conv(x, w, strides, pads) -> int:
    """2 * M * O * K multiply-adds of the GEMM (taps in the padding
    included, as the product is defined), plus 3 a z element for the
    statistics."""
    ho, wo = _out_hw(x.shape, w.shape, strides, pads)
    rows = x.shape[0] * ho * wo
    o, c, kh, kw = w.shape
    return 2 * rows * o * kh * kw * c + 3 * rows * o


def bound_bytes_sweep(z, n_in: int, n_out: int, stat_rows: int) -> int:
    """n_in [R, O] tensors read and n_out written in z's dtype, plus
    ``stat_rows`` f32 rows of O."""
    return ((n_in + n_out) * z.numel() * z.element_size()
            + stat_rows * 4 * z.shape[1])


def bound_flops_sweep(z, per_element: int) -> int:
    return per_element * z.numel()
