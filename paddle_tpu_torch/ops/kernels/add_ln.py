"""Residual add + LayerNorm over the last axis, with f32 statistics.

    s    = x + y            (y optional)
    out  = (s - mean(s)) * rsqrt(var(s) + eps) * scale + shift

computed in f32 whatever the input dtype (biased variance), cast back to
x's dtype, plus the per-row ``mean`` and ``rstd`` (f32), and its
backward

    dx = dy = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
    gs = g * scale,  xhat = (s - mean) * rstd
    dscale = sum over rows of g * xhat,  dshift = sum over rows of g

Same semantics as the JAX package's ``ops/pallas/add_ln.py``
``fused_add_ln`` and its custom VJP (whose Pallas kernels ``_ln_fwd`` /
``_fwd_kernel`` and ``_ln_bwd`` / ``_bwd_kernel`` this module's kernels
replace) and ``ops/encoder_stack._ln_f32``.

Two implementations of each direction:

* ``fused_add_ln_reference`` / ``fused_add_ln_bwd_reference`` — the
  plain PyTorch versions.  CPU and ``meta`` tensors take them (shape
  inference goes through them).
* the CUDA kernels of ``csrc/add_ln.cu`` (sm_90a, built by nvcc at first
  use, bound with ctypes): one warp a row, held in registers and read
  with 16-byte loads, two shuffle reductions a row.  The forward's grid
  is one wave (``fwd_geometry``); each warp walks several rows and, up to
  H = 1024, issues the next row's loads and this row's scale and shift
  before this row's reductions.  The backward is one launch: each block writes a
  partial row of dscale/dshift, and the blocks that finish last (an
  atomic ticket) sum them in a fixed order, so it is deterministic.  Its
  grid comes from ``bwd_geometry`` and its workspace from
  ``bwd_workspace`` (cached per device, stream and H).  The source's
  header note has the design.

``add_ln`` is the differentiable entry (a ``torch.autograd.Function``
whose forward and backward are the above): ``mean`` and ``rstd`` are
non-differentiable outputs, and dx serves as dy.

The TPU gate (``ln_shapes_ok``: H % 128, VMEM row blocks) is TPU
machinery and is not ported.  On the card the caller's flag
(FLAGS_use_fused_ln, read by the ``layer_norm`` emitter) and
``check_kernel_inputs`` decide: a CUDA tensor the kernel does not take
raises ``ValueError``; nothing falls back.

Bound: memory.  ``bound_bytes`` counts x and y read once, out written
once, scale and shift read once (as f32) and the two f32 stats a row;
``bound_bytes_bwd`` x, y, g, scale and the stats read once, dx, dscale
and dshift written once; both against 3.35 TB/s on an H100 SXM.
``fused_add_ln.launches`` and ``fused_add_ln_bwd.launches`` count kernel
launches (one a call each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_H = 4096  # 32 four-element chunks a lane


def fused_add_ln_reference(x, y, scale, shift, eps: float = 1e-5):
    """Plain version, any device: (out [.., H] in x.dtype, mean [..] f32,
    rstd [..] f32)."""
    s = x.float()
    if y is not None:
        s = s + y.float()
    mu = s.mean(dim=-1, keepdim=True)
    var = (s - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (s - mu) * rstd * scale.float() + shift.float()
    return out.to(x.dtype), mu[..., 0], rstd[..., 0]


def fused_add_ln_bwd_reference(x, y, scale, mean, rstd, g):
    """Plain backward, any device: (dx in x.dtype, dscale f32, dshift
    f32); dx is also dy."""
    h = x.shape[-1]
    s = x.float()
    if y is not None:
        s = s + y.float()
    xhat = (s - mean[..., None]) * rstd[..., None]
    gf = g.float()
    dscale = (gf * xhat).reshape(-1, h).sum(0)
    dshift = gf.reshape(-1, h).sum(0)
    gs = gf * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[..., None] * (gs - m1 - xhat * m2)
    return dx.to(x.dtype), dscale, dshift


def check_kernel_inputs(x, y, scale, shift) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else.
    Device-independent, so the CPU tests call it directly."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"add_ln kernel takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if x.dim() < 1:
        raise ValueError("x must have a last (normalised) axis")
    h = x.shape[-1]
    if h % 4 or not 0 < h <= MAX_H:
        raise ValueError(f"add_ln kernel needs H % 4 == 0 and H <= {MAX_H}, "
                         f"got H={h}")
    if y is not None:
        if y.dtype != x.dtype or y.shape != x.shape:
            raise ValueError(f"y {tuple(y.shape)} {y.dtype} must match x "
                             f"{tuple(x.shape)} {x.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (h,):
            raise ValueError(f"{name} must be [{h}], got {tuple(t.shape)}")
        if t.dtype not in (torch.float32, x.dtype):
            raise ValueError(f"{name} dtype {t.dtype} is neither float32 nor "
                             f"x's {x.dtype}")
    for name, t in (("x", x), ("y", y), ("scale", scale), ("shift", shift)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_bwd_inputs(x, y, scale, mean, rstd, g) -> None:
    """What the backward kernel takes; raises ValueError on anything
    else.  Device-independent, so the CPU tests call it directly."""
    check_kernel_inputs(x, y, scale, scale)
    lead = tuple(x.shape[:-1])
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or tuple(t.shape) != lead:
            raise ValueError(f"{name} must be float32 {lead}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("g", g), ("mean", mean), ("rstd", rstd)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")


_fns = {}


def _launcher(name: str):
    """The ctypes function ``add_ln_<name>_launch`` of the built library."""
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("add_ln"), f"add_ln_{name}_launch")
        if name == "fwd":
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                           + [ctypes.c_float] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


FWD_BLOCKS_PER_SM = 2


def fwd_geometry(rows: int, h: int, sms: int) -> tuple:
    """The forward kernel's launch: (threads, nblocks).  Eight warps a
    block up to H = 1024 (rows pipelined), four beyond; at most
    ``FWD_BLOCKS_PER_SM`` blocks an SM, so the grid is one wave, and no
    more blocks than rows need.  Warp w of the grid walks rows w, w +
    nblocks * warps, ..."""
    warps = 8 if h <= 1024 else 4
    return warps * 32, min(-(-rows // warps), FWD_BLOCKS_PER_SM * sms)


def _cuda_add_ln(x, y, scale, shift, eps: float):
    check_kernel_inputs(x, y, scale, shift)
    h = x.shape[-1]
    rows = x.numel() // h
    lead = tuple(x.shape[:-1])
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    threads, nblocks = fwd_geometry(rows, h, _sm_count(x.device))
    fn = _launcher("fwd")
    out = torch.empty_like(x)
    mean = torch.empty(lead, dtype=torch.float32, device=x.device)
    rstd = torch.empty(lead, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), None if y is None else y.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), rows, h, float(eps),
                 nblocks, threads, _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"add_ln kernel launch failed: CUDA error {err}")
    fused_add_ln.launches += 1
    return out, mean, rstd


def fused_add_ln_fwd(x, y, scale, shift, eps: float = 1e-5):
    """LayerNorm(x + y) over the last axis: (out, mean, rstd).

    x/y: [..., H]; scale/shift: [H]; y may be None.  CPU and meta tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type in ("cpu", "meta"):
        return fused_add_ln_reference(x, y, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no add_ln kernel for device {x.device}")
    return _cuda_add_ln(x, y, scale, shift, eps)


def fused_add_ln(x, y, scale, shift, eps: float = 1e-5):
    """LayerNorm(x + y) over the last axis with f32 stats; y may be None.
    The JAX package's signature: returns out only, differentiable."""
    return add_ln(x, y, scale, shift, eps)[0]


fused_add_ln.launches = 0

BWD_GROUP = 16  # block partial rows that one group sum takes


def bwd_geometry(rows: int, h: int, sms: int) -> tuple:
    """The backward kernel's launch: (threads, rows_per_block, nblocks,
    ngroups).  Sixteen warps a block, one block an SM, up to H = 1024;
    four warps, two blocks an SM, beyond.  Rows a block are a multiple of
    the warps, sized so that the grid is one wave with every SM holding
    rows in flight; blocks go in groups of ``BWD_GROUP`` for the
    two-level final sum."""
    warps, per_sm = (16, 1) if h <= 1024 else (4, 2)
    per_block = warps * max(1, -(-rows // (warps * per_sm * sms)))
    nblocks = -(-rows // per_block)
    return warps * 32, per_block, nblocks, -(-nblocks // BWD_GROUP)


_workspaces = {}


def bwd_workspace(device, stream: int, h: int, nblocks: int,
                  ngroups: int) -> tuple:
    """(part, ticket) of the backward kernel on ``device`` and ``stream``:
    f32 partial rows [>= nblocks + ngroups, 2, H] (the blocks', then the
    groups') and int32 tickets [>= 1 + ngroups], zero between calls (each
    call leaves them at zero).  Cached per (device, stream, H); a call
    that needs more rows gets a larger pair."""
    key = (torch.device(device), int(stream), int(h))
    ws = _workspaces.get(key)
    if (ws is None or ws[0].shape[0] < nblocks + ngroups
            or ws[1].numel() < 1 + ngroups):
        ws = (torch.empty((nblocks + ngroups, 2, h), dtype=torch.float32,
                          device=device),
              torch.zeros(1 + ngroups, dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def _cuda_add_ln_bwd(x, y, scale, mean, rstd, g):
    check_bwd_inputs(x, y, scale, mean, rstd, g)
    h = x.shape[-1]
    rows = x.numel() // h
    scale = scale.float().contiguous()
    threads, per_block, nblocks, ngroups = bwd_geometry(
        rows, h, _sm_count(x.device))
    fn = _launcher("bwd")
    dx = torch.empty_like(x)
    dparams = torch.empty((2, h), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part, ticket = bwd_workspace(x.device, stream, h, nblocks, ngroups)
        err = fn(x.data_ptr(), None if y is None else y.data_ptr(),
                 scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), dparams[0].data_ptr(),
                 dparams[1].data_ptr(), part.data_ptr(), ticket.data_ptr(),
                 rows, h, per_block, nblocks, threads,
                 _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"add_ln backward kernel launch failed: CUDA "
                           f"error {err}")
    fused_add_ln_bwd.launches += 1
    return dx, dparams[0], dparams[1]


def fused_add_ln_bwd(x, y, scale, mean, rstd, g):
    """The backward of ``fused_add_ln_fwd``: (dx, dscale, dshift), dx in
    x's dtype (it is dy too), dscale and dshift f32.  CPU and meta
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type in ("cpu", "meta"):
        return fused_add_ln_bwd_reference(x, y, scale, mean, rstd, g)
    if x.device.type != "cuda":
        raise ValueError(f"no add_ln kernel for device {x.device}")
    return _cuda_add_ln_bwd(x, y, scale, mean, rstd, g)


fused_add_ln_bwd.launches = 0


class _AddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, scale, shift, eps):
        out, mean, rstd = fused_add_ln_fwd(x, y, scale, shift, eps)
        ctx.save_for_backward(x, y, scale, mean, rstd)
        ctx.shift_dtype = shift.dtype
        ctx.mark_non_differentiable(mean, rstd)
        return out, mean, rstd

    @staticmethod
    def backward(ctx, g, _gm, _gr):
        x, y, scale, mean, rstd = ctx.saved_tensors
        g = g.contiguous()
        if g.data_ptr() % 16:  # a view autograd handed over unaligned
            g = g.clone()
        dx, dscale, dshift = fused_add_ln_bwd(x, y, scale, mean, rstd, g)
        return (dx, None if y is None else dx, dscale.to(scale.dtype),
                dshift.to(ctx.shift_dtype), None)


def add_ln(x, y, scale, shift, eps: float = 1e-5):
    """Differentiable LayerNorm(x + y): (out, mean, rstd), the stats
    non-differentiable.  Forward and backward each run the kernel on CUDA
    tensors and the plain version on CPU and meta tensors."""
    return _AddLN.apply(x, y, scale, shift, float(eps))


def bound_bytes(x, y) -> int:
    """Bytes the function must move: x (and y) read and out written once,
    scale and shift read once as f32, mean and rstd (f32) written."""
    h = x.shape[-1]
    rows = x.numel() // h
    act = x.numel() * x.element_size()
    return act * (3 if y is not None else 2) + 2 * 4 * h + 2 * 4 * rows


def bound_bytes_bwd(x, y) -> int:
    """Bytes the backward must move: x (and y) and g read and dx written
    once, scale (f32) and the two f32 stats a row read once, dscale and
    dshift (f32) written once."""
    h = x.shape[-1]
    rows = x.numel() // h
    act = x.numel() * x.element_size()
    return act * (4 if y is not None else 3) + 3 * 4 * h + 2 * 4 * rows


def bound_flops_bwd(x, y) -> int:
    """About 13 flops an element (the add of y one more): xhat, g*scale,
    the two row sums, the dscale/dshift partials and dx."""
    return (14 if y is not None else 13) * x.numel()


def bound_flops(x, y) -> int:
    """About 8 flops an element (the add of y one more): the sums for
    mean and variance, the centring, the scaling and the affine."""
    return (9 if y is not None else 8) * x.numel()
