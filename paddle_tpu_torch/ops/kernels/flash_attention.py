"""Flash attention (online softmax) over head-interleaved [B, S, H]
tensors — the forward of the JAX package's BSH path.

    o[b, :, h]    = softmax(q_h k_h^T * sm_scale + bias[b]) v_h
    lse[b, h, :]  = log-sum-exp of those scores

with q [B, Sq, H], k/v [B, Skv, H], H = num_heads * D and head h owning
columns [h*D, (h+1)*D); bias is per key ([B, 1, 1, Skv] or [B, 1, Skv],
the BERT padding mask); causal masks keys above the diagonal (Sq == Skv
only).  Same semantics and shape rules as the JAX package's
``ops/pallas/flash_attention.py`` ``flash_attention_bsh``.

Two implementations:

* ``flash_attention_bsh_reference`` — the plain PyTorch version, the
  reference's ``_reference_attention`` with a per-key bias plus the lse,
  in f32.  CPU and ``meta`` tensors take it.
* the CUDA kernel ``csrc/flash_attention_bsh.cu`` (sm_90a, built by nvcc
  at first use, bound with ctypes).  It replaces the TPU kernel
  ``_make_fwd_bsh_kernel`` launched by ``_flash_fwd_bsh``: one block per
  (64-row query tile, head, batch) streams its head's K/V tiles through
  shared memory with the online softmax in f32 registers; the source's
  header note has the design.

Dropout: the plain version draws its keep mask from the generator it is
given; on the card a nonzero ``dropout_prob`` raises until the training
slice adds in-kernel Philox dropout with the backward kernel.  The
inference path always passes 0.

Bound: ``bound_flops`` (4*B*nh*Sq*Skv*D, or the causal triangle's share)
against the dtype's peak and ``bound_bytes`` (q, k, v, bias, o, lse)
against 3.35 TB/s; the larger time bounds.  CUDA tensors reach the kernel
or raise; ``flash_attention_bsh.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

MIN_BLOCK = 128
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
KERNEL_ROWS = 64  # the kernel's query tile and largest key tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def prescale_ok(sm_scale) -> bool:
    """Fold sm_scale into q before the q.k product only when it is a
    power of two (the reference's ``_prescale_ok``): then q * sm_scale is
    exact, in bf16 as in f32."""
    return math.frexp(float(sm_scale))[0] == 0.5


def flash_shapes_ok(s, d) -> bool:
    """The reference's shape/flag gate (``flash_shapes_ok``), without its
    backend test: the port takes the same branch on every device, and a
    CPU tensor then runs the plain version."""
    from ...fluid.flags import flag

    if not flag("FLAGS_use_flash_attention"):
        return False
    return d in HEAD_DIMS and s % MIN_BLOCK == 0


def bsh_dispatch_ok(sq, skv, h, num_heads, bias=None, batch=None,
                    causal=False) -> bool:
    """The reference's fitness test for the BSH path: the flag, D and
    both lengths (``flash_shapes_ok``), per-key-only bias holdable as
    [B, 1, Skv], no rectangular causal.  The TPU's VMEM-residency test is
    not ported: the kernel streams K/V through shared memory."""
    d = h // num_heads
    if not (flash_shapes_ok(sq, d) and flash_shapes_ok(skv, d)):
        return False
    if causal and sq != skv:
        return False
    if bias is None:
        return True
    if bias.dim() == 4:
        bb, bn, bq_, bk_ = bias.shape
    elif bias.dim() == 3:
        bb, bn, bk_ = bias.shape
        bq_ = 1
    else:
        return False
    return (bn == 1 and bq_ == 1 and bk_ == skv
            and (batch is None or bb == batch))


def flash_attention_bsh_reference(q, k, v, bias=None, num_heads=None,
                                  sm_scale=None, causal=False,
                                  dropout_prob=0.0, generator=None):
    """Plain version, any device: (o [B, Sq, H] in q.dtype, lse [B, nh,
    Sq] f32).  Scores, softmax and the P.V product are f32."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    nh = int(num_heads)
    d = hdim // nh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)

    def heads(t, s):
        return t.float().reshape(b, s, nh, d).transpose(1, 2)

    s = torch.matmul(heads(q, sq), heads(k, skv).transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.reshape(b, 1, 1, skv).float()
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / l
    if dropout_prob > 0.0 and q.device.type != "meta":
        keep = torch.rand(probs.shape, generator=generator,
                          device=q.device) < 1.0 - dropout_prob
        probs = torch.where(keep, probs / (1.0 - dropout_prob), 0.0)
    o = torch.matmul(probs, heads(v, skv))
    o = o.transpose(1, 2).reshape(b, sq, hdim).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return o, lse


def check_kernel_inputs(q, k, v, bias, num_heads, causal=False,
                        dropout_prob=0.0) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else and
    NotImplementedError for dropout.  Device-independent, so the CPU
    tests call it directly."""
    if dropout_prob:
        raise NotImplementedError(
            "flash_attention_bsh on the card has no dropout yet: in-kernel "
            "Philox dropout comes with the backward kernel in the training "
            "slice (ROADMAP B1/B2); pass dropout_prob=0 (is_test)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, got "
                         f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, H] and k, v [B, Skv, H], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hdim = q.shape
    _, skv, hk = k.shape
    if k.shape[0] != b or hk != hdim:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if num_heads is None or num_heads < 1 or hdim % num_heads:
        raise ValueError(f"H={hdim} is not a multiple of num_heads="
                         f"{num_heads}")
    d = hdim // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if sq % KERNEL_ROWS or skv % KERNEL_ROWS:
        raise ValueError(f"lengths Sq={sq}, Skv={skv} must be multiples of "
                         f"{KERNEL_ROWS}")
    if causal and sq != skv:
        raise ValueError("causal needs Sq == Skv (the mask is top-left "
                         "aligned)")
    if bias is not None and (bias.numel() != b * skv
                             or bias.shape[0] != b or bias.shape[-1] != skv):
        raise ValueError(f"bias must be per key, [B, 1, 1, Skv] or "
                         f"[B, 1, Skv], got {tuple(bias.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("flash_attention_bsh").flash_attention_bsh_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _cuda_flash_bsh(q, k, v, bias, num_heads, sm_scale, causal,
                    dropout_prob):
    check_kernel_inputs(q, k, v, bias, num_heads, causal, dropout_prob)
    b, sq, hdim = q.shape
    skv = k.shape[1]
    if bias is not None:
        bias = bias.reshape(b, skv).float().contiguous()
    fn = _launcher()
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, skv, num_heads, hdim // num_heads,
                 float(sm_scale), int(prescale_ok(sm_scale)), int(causal),
                 _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bsh kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bsh.launches += 1
    return o, lse


def flash_attention_bsh_fwd(q, k, v, bias=None, num_heads=None,
                            sm_scale: Optional[float] = None, causal=False,
                            dropout_prob=0.0, dropout_generator=None):
    """(o [B, Sq, H], lse [B, nh, Sq] f32).  CPU and meta tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if num_heads is None:
        raise ValueError("flash_attention_bsh needs num_heads")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention_bsh: causal with sq != skv would be top-left "
            "aligned (use equal lengths)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bsh_reference(
            q, k, v, bias, num_heads, sm_scale, causal, dropout_prob,
            dropout_generator)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return _cuda_flash_bsh(q, k, v, bias, num_heads, sm_scale, causal,
                           dropout_prob)


def flash_attention_bsh(q, k, v, bias=None, num_heads=None, sm_scale=None,
                        causal=False, dropout_prob=0.0,
                        dropout_generator=None):
    """Transpose-free attention on projection-layout tensors; returns o
    [B, Sq, H] (the JAX package's signature, without its mesh)."""
    return flash_attention_bsh_fwd(q, k, v, bias, num_heads, sm_scale,
                                   causal, dropout_prob,
                                   dropout_generator)[0]


flash_attention_bsh.launches = 0


def bound_flops(q, k, num_heads, causal=False) -> int:
    """Multiply-adds of the two products, 2 flops each: 4*D per visible
    (query, key) pair; causal sees Sq*(Sq+1)/2 pairs a head."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    return 4 * b * num_heads * pairs * (hdim // num_heads)


def bound_bytes(q, k, v, bias, num_heads) -> int:
    """q, k, v and the bias read once; o and lse (f32) written once."""
    b, sq, _ = q.shape
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    if bias is not None:
        nbytes += bias.numel() * 4
    return nbytes + q.numel() * q.element_size() + b * num_heads * sq * 4
