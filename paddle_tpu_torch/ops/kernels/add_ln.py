"""Residual add + LayerNorm over the last axis, with f32 statistics.

    s    = x + y            (y optional)
    out  = (s - mean(s)) * rsqrt(var(s) + eps) * scale + shift

computed in f32 whatever the input dtype (biased variance), cast back to
x's dtype, plus the per-row ``mean`` and ``rstd`` (f32).  Same semantics
as the JAX package's ``ops/pallas/add_ln.py`` ``fused_add_ln`` (whose
Pallas forward ``_ln_fwd`` / ``_fwd_kernel`` this module's kernel
replaces) and ``ops/encoder_stack._ln_f32``.

Two implementations:

* ``fused_add_ln_reference`` — the plain PyTorch version.  CPU and
  ``meta`` tensors take it (shape inference goes through it).
* the CUDA kernel ``csrc/add_ln.cu`` (sm_90a, built by nvcc at first use,
  bound with ctypes): one warp a row, the row held in registers, two
  shuffle reductions.  Its header note has the design.

The TPU gate (``ln_shapes_ok``: H % 128, VMEM row blocks) is TPU
machinery and is not ported.  On the card the caller's flag
(FLAGS_use_fused_ln, read by the ``layer_norm`` emitter) and
``check_kernel_inputs`` decide: a CUDA tensor the kernel does not take
raises ``ValueError``; nothing falls back.

Bound: memory.  ``bound_bytes`` counts x and y read once, out written
once, scale and shift read once (as f32) and the two f32 stats a row,
against 3.35 TB/s on an H100 SXM.  ``fused_add_ln.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

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


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("add_ln").add_ln_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _cuda_add_ln(x, y, scale, shift, eps: float):
    check_kernel_inputs(x, y, scale, shift)
    h = x.shape[-1]
    rows = x.numel() // h
    lead = tuple(x.shape[:-1])
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    fn = _launcher()
    out = torch.empty_like(x)
    mean = torch.empty(lead, dtype=torch.float32, device=x.device)
    rstd = torch.empty(lead, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), None if y is None else y.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), rows, h, float(eps),
                 _DTYPE_CODES[x.dtype], stream)
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
    The JAX package's signature: returns out only."""
    return fused_add_ln_fwd(x, y, scale, shift, eps)[0]


fused_add_ln.launches = 0


def bound_bytes(x, y) -> int:
    """Bytes the function must move: x (and y) read and out written once,
    scale and shift read once as f32, mean and rstd (f32) written."""
    h = x.shape[-1]
    rows = x.numel() // h
    act = x.numel() * x.element_size()
    return act * (3 if y is not None else 2) + 2 * 4 * h + 2 * 4 * rows


def bound_flops(x, y) -> int:
    """About 8 flops an element (the add of y one more): the sums for
    mean and variance, the centring, the scaling and the affine."""
    return (9 if y is not None else 8) * x.numel()
