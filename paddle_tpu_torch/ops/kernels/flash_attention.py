"""Flash attention (online softmax) over head-interleaved [B, S, H]
tensors — the forward and backward of the JAX package's BSH path.

    o[b, :, h]    = softmax(q_h k_h^T * sm_scale + bias[b]) v_h
    lse[b, h, :]  = log-sum-exp of those scores

with q [B, Sq, H], k/v [B, Skv, H], H = num_heads * D and head h owning
columns [h*D, (h+1)*D); bias is per key ([B, 1, 1, Skv] or [B, 1, Skv],
the BERT padding mask) and gets a zero cotangent; causal masks keys above
the diagonal (Sq == Skv only).  Same semantics and shape rules as the JAX
package's ``ops/pallas/flash_attention.py`` ``flash_attention_bsh`` and
its custom VJP.

Dropout acts on the probabilities' numerator (the row sum l and the lse
stay undropped, as in the TPU kernels).  The keep bits come from

* an explicit uint8 keep mask [B, nh, Sq, Skv] (the JAX package's
  ``has_mask`` path), kept values divided by 1 - p; the CPU draws one
  from the op's generator (the JAX package materializes one in interpret
  mode);
* on the card, without a mask, an in-kernel Philox keyed by (seed,
  offset, b, h, q, k), the threshold quantized to 1/256 as
  ``_dropout_quantized_thresh`` does and kept values divided by the
  quantized keep probability.  The seed is the op's salted generator's
  (``Generator.initial_seed()``: a host integer, no device sync); the
  backward regenerates the same bits.

Two implementations of each direction:

* ``flash_attention_bsh_reference`` / ``flash_attention_bsh_bwd_reference``
  — the plain PyTorch versions (the reference's ``_reference_attention``
  with a per-key bias plus the lse, and its backward from the lse), in
  f32.  CPU and ``meta`` tensors take them.
* the CUDA kernels of ``csrc/flash_attention_bsh.cu`` (sm_90a, built by
  nvcc at first use, bound with ctypes).  They replace the TPU kernels
  ``_make_fwd_bsh_kernel`` (launched by ``_flash_fwd_bsh``) and
  ``_make_bwd_bsh_kernel`` (``_flash_bwd_bsh``): one block per (64-row
  tile, head, batch) streams the other operand's tiles through shared
  memory in f32; the backward is a dk/dv kernel and a dq kernel, both
  deterministic.  The source's header note has the design.

``flash_attention_bsh`` is differentiable: a ``torch.autograd.Function``
whose forward and backward are the above.

Bounds: ``bound_flops`` (4*B*nh*Sq*Skv*D forward, ``bound_flops_bwd``
10*B*nh*Sq*Skv*D backward, the causal triangle's share when causal)
against the dtype's peak and ``bound_bytes`` / ``bound_bytes_bwd``
against 3.35 TB/s; the larger time bounds.  CUDA tensors reach the
kernels or raise; ``flash_attention_bsh.launches`` counts forward kernel
launches and ``flash_attention_bsh_bwd.launches`` backward ones (two a
call).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

MIN_BLOCK = 128
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
KERNEL_ROWS = 64  # the kernels' tile rows (32 at D = 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_DROP, _MASK_DROP, _PHILOX_DROP = 0, 1, 2


def prescale_ok(sm_scale) -> bool:
    """Fold sm_scale into q before the q.k product only when it is a
    power of two (the reference's ``_prescale_ok``): then q * sm_scale is
    exact, in bf16 as in f32."""
    return math.frexp(float(sm_scale))[0] == 0.5


def dropout_quantized_thresh(keep_prob) -> int:
    """The reference's ``_dropout_quantized_thresh``: keep a byte iff it
    is below t, t in [1, 256]; the kept values divide by t / 256."""
    return max(1, min(256, round(keep_prob * 256)))


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
    not ported: the kernels stream K/V through shared memory."""
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


def _heads(t, b, s, nh):
    return t.float().reshape(b, s, nh, t.shape[-1] // nh).transpose(1, 2)


def _scores(q, k, bias, nh, sm_scale, causal):
    """f32 scores [B, nh, Sq, Skv] with the bias and the causal mask."""
    b, sq, _ = q.shape
    skv = k.shape[1]
    s = torch.matmul(_heads(q, b, sq, nh),
                     _heads(k, b, skv, nh).transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.reshape(b, 1, 1, skv).float()
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_attention_bsh_reference(q, k, v, bias=None, num_heads=None,
                                  sm_scale=None, causal=False,
                                  dropout_prob=0.0, generator=None,
                                  mask=None, keep_div=None):
    """Plain version, any device: (o [B, Sq, H] in q.dtype, lse [B, nh,
    Sq] f32).  Scores, softmax and the P.V product are f32.  Dropout keeps
    where ``mask`` (uint8 [B, nh, Sq, Skv]) is nonzero, or draws the mask
    from ``generator``; kept values divide by ``keep_div`` (default
    1 - dropout_prob)."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    nh = int(num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hdim // nh)
    s = _scores(q, k, bias, nh, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    probs = p / l
    if dropout_prob > 0.0 and q.device.type != "meta":
        if mask is None:
            mask = draw_keep_mask(q, k, nh, dropout_prob, generator)
        div = (1.0 - dropout_prob) if keep_div is None else keep_div
        probs = torch.where(mask != 0, probs / div, 0.0)
    o = torch.matmul(probs, _heads(v, b, skv, nh))
    o = o.transpose(1, 2).reshape(b, sq, hdim).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return o, lse


def flash_attention_bsh_bwd_reference(q, k, v, bias, o, lse, do,
                                      num_heads, sm_scale=None,
                                      causal=False, mask=None,
                                      keep_div=1.0):
    """Plain backward, any device: (dq, dk, dv) in the inputs' dtypes,
    from the forward's o and lse, as ``_make_bwd_bsh_kernel`` computes
    them: p = exp(s - lse), ds = p (dp c - delta) sm_scale with c = keep /
    keep_div (1 without ``mask``)."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    nh = int(num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hdim // nh)
    p = torch.exp(_scores(q, k, bias, nh, sm_scale, causal)
                  - lse[..., None].float())
    dof = _heads(do, b, sq, nh)
    delta = (dof * _heads(o, b, sq, nh)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, _heads(v, b, skv, nh).transpose(-1, -2))
    if mask is not None:
        c = torch.where(mask != 0, 1.0 / keep_div, 0.0)
        p_num, dp = p * c, dp * c
    else:
        p_num = p
    ds = p * (dp - delta) * sm_scale
    dv = torch.matmul(p_num.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, b, sq, nh))
    dq = torch.matmul(ds, _heads(k, b, skv, nh))

    def merge(t, s, like):
        return t.transpose(1, 2).reshape(b, s, hdim).to(like.dtype)

    return merge(dq, sq, q), merge(dk, skv, k), merge(dv, skv, v)


def draw_keep_mask(q, k, num_heads, dropout_prob, generator):
    """A uint8 keep mask [B, nh, Sq, Skv] drawn from ``generator``: each
    entry kept with probability 1 - dropout_prob."""
    shape = (q.shape[0], int(num_heads), q.shape[1], k.shape[1])
    u = torch.rand(shape, generator=generator, device=q.device)
    return (u < 1.0 - dropout_prob).to(torch.uint8)


def check_kernel_inputs(q, k, v, bias, num_heads, causal=False,
                        dropout_prob=0.0, mask=None) -> None:
    """What the CUDA kernels take; raises ValueError on anything else.
    Device-independent, so the CPU tests call it directly."""
    if not 0.0 <= dropout_prob < 1.0:
        raise ValueError(f"dropout_prob {dropout_prob} is not in [0, 1)")
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
    if mask is not None and (mask.dtype != torch.uint8 or tuple(mask.shape)
                             != (b, num_heads, sq, skv)):
        raise ValueError(f"mask must be uint8 [B, nh, Sq, Skv] = "
                         f"{(b, num_heads, sq, skv)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias),
                    ("mask", mask)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


_fns = {}


def _launcher(name: str):
    """The ctypes function ``flash_attention_bsh_<name>`` of the library."""
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("flash_attention_bsh"),
                     f"flash_attention_bsh_{name}")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "launch":
            fn.argtypes = ([p] * 6 + [i] * 5 + [f] + [i] * 4 + [p, p]
                           + [ctypes.c_ulonglong, i, i, f, p])
        else:
            fn.argtypes = ([p] * 10 + [i] * 5 + [f] + [i] * 4 + [p]
                           + [ctypes.c_ulonglong, i, i, f, p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _drop_args(dropout_prob, mask, seed):
    """(mode, mask, thresh, keep_div) of the kernels' dropout."""
    if dropout_prob <= 0.0:
        return _NO_DROP, None, 0, 1.0
    if mask is not None:
        return _MASK_DROP, mask, 0, 1.0 - dropout_prob
    if seed is None:
        raise ValueError("dropout on the card needs a mask or a seed")
    thresh = dropout_quantized_thresh(1.0 - dropout_prob)
    return _PHILOX_DROP, None, thresh, thresh / 256.0


def _key_bias(bias, b, skv):
    return None if bias is None else bias.reshape(b, skv).float().contiguous()


def _cuda_flash_bsh(q, k, v, bias, num_heads, sm_scale, causal,
                    dropout_prob, mask, seed, offset, return_bits):
    check_kernel_inputs(q, k, v, bias, num_heads, causal, dropout_prob, mask)
    b, sq, hdim = q.shape
    skv = k.shape[1]
    bias = _key_bias(bias, b, skv)
    mode, mask, thresh, keep_div = _drop_args(dropout_prob, mask, seed)
    bits = None
    if return_bits and mode == _PHILOX_DROP:
        bits = torch.zeros((b, num_heads, sq, skv), dtype=torch.uint8,
                           device=q.device)
    fn = _launcher("launch")
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, skv, num_heads, hdim // num_heads,
                 float(sm_scale), int(prescale_ok(sm_scale)), int(causal),
                 _DTYPE_CODES[q.dtype], mode,
                 None if mask is None else mask.data_ptr(),
                 None if bits is None else bits.data_ptr(),
                 int(seed or 0) & ((1 << 64) - 1), int(offset), thresh,
                 float(keep_div), stream)
    if err:
        raise RuntimeError(f"flash_attention_bsh kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bsh.launches += 1
    return (o, lse, bits) if return_bits else (o, lse)


def flash_attention_bsh_fwd(q, k, v, bias=None, num_heads=None,
                            sm_scale: Optional[float] = None, causal=False,
                            dropout_prob=0.0, dropout_generator=None, *,
                            mask=None, dropout_seed=None, dropout_offset=0,
                            return_bits=False):
    """(o [B, Sq, H], lse [B, nh, Sq] f32), not differentiable.  CPU and
    meta tensors take the plain version (dropout from ``mask`` or drawn
    from ``dropout_generator``); CUDA tensors launch the kernel or raise
    (dropout from ``mask``, else Philox from ``dropout_seed``).
    ``return_bits`` adds the uint8 keep bits the Philox drew (None
    without Philox)."""
    if num_heads is None:
        raise ValueError("flash_attention_bsh needs num_heads")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention_bsh: causal with sq != skv would be top-left "
            "aligned (use equal lengths)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    if q.device.type in ("cpu", "meta"):
        out = flash_attention_bsh_reference(
            q, k, v, bias, num_heads, sm_scale, causal, dropout_prob,
            dropout_generator, mask)
        return out + (None,) if return_bits else out
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return _cuda_flash_bsh(q, k, v, bias, num_heads, sm_scale, causal,
                           dropout_prob, mask, dropout_seed, dropout_offset,
                           return_bits)


def _cuda_flash_bsh_bwd(q, k, v, bias, o, lse, do, num_heads, sm_scale,
                        causal, dropout_prob, mask, seed, offset):
    check_kernel_inputs(q, k, v, bias, num_heads, causal, dropout_prob, mask)
    b, sq, hdim = q.shape
    skv = k.shape[1]
    d = hdim // num_heads
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} "
                             f"{q.dtype} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if lse.shape != (b, num_heads, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, num_heads, sq)}")
    bias = _key_bias(bias, b, skv)
    mode, mask, thresh, keep_div = _drop_args(dropout_prob, mask, seed)
    # delta = rowsum(dO * O) per head, outside the kernels as in the
    # reference's _flash_bwd_bsh
    delta = (o.float() * do.float()).reshape(b, sq, num_heads, d).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    lse = lse.contiguous()
    fn = _launcher("bwd_launch")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, skv, num_heads, d,
                 float(sm_scale), int(prescale_ok(sm_scale)), int(causal),
                 _DTYPE_CODES[q.dtype], mode,
                 None if mask is None else mask.data_ptr(),
                 int(seed or 0) & ((1 << 64) - 1), int(offset), thresh,
                 float(keep_div), stream)
    if err:
        raise RuntimeError(f"flash_attention_bsh backward kernel launch "
                           f"failed: CUDA error {err}")
    flash_attention_bsh_bwd.launches += 2  # the dk/dv and the dq kernel
    return dq, dk, dv


def flash_attention_bsh_bwd(q, k, v, bias, o, lse, do, num_heads,
                            sm_scale=None, causal=False, dropout_prob=0.0,
                            *, mask=None, dropout_seed=None,
                            dropout_offset=0):
    """(dq, dk, dv) of the forward that gave o and lse (bias: zero
    cotangent).  CPU and meta tensors take the plain version, which
    needs the forward's ``mask`` for dropout; CUDA tensors launch the two
    backward kernels or raise (Philox regenerated from ``dropout_seed``
    when no mask is given)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    if q.device.type in ("cpu", "meta"):
        if dropout_prob > 0.0 and mask is None and q.device.type == "cpu":
            raise ValueError("the plain backward needs the forward's keep "
                             "mask for dropout")
        return flash_attention_bsh_bwd_reference(
            q, k, v, bias, o, lse, do, num_heads, sm_scale, causal,
            mask if dropout_prob > 0.0 else None, 1.0 - dropout_prob)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return _cuda_flash_bsh_bwd(q, k, v, bias, o, lse, do.contiguous(),
                               num_heads, sm_scale, causal, dropout_prob,
                               mask, dropout_seed, dropout_offset)


flash_attention_bsh_bwd.launches = 0


class _FlashBSH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads, sm_scale, causal,
                dropout_prob, seed, offset):
        o, lse = flash_attention_bsh_fwd(
            q, k, v, bias, num_heads, sm_scale, causal, dropout_prob,
            mask=mask, dropout_seed=seed, dropout_offset=offset)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.args = (num_heads, sm_scale, causal, dropout_prob, seed, offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        nh, sm_scale, causal, p, seed, offset = ctx.args
        dq, dk, dv = flash_attention_bsh_bwd(
            q, k, v, bias, o, lse, do, nh, sm_scale, causal, p, mask=mask,
            dropout_seed=seed, dropout_offset=offset)
        # BiasQK: a zero cotangent on every path, as in the reference
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention_bsh(q, k, v, bias=None, num_heads=None, sm_scale=None,
                        causal=False, dropout_prob=0.0,
                        dropout_generator=None, *, mask=None,
                        dropout_offset=0):
    """Transpose-free attention on projection-layout tensors; returns o
    [B, Sq, H] (the JAX package's signature, without its mesh),
    differentiable in q, k and v.  Dropout keeps where ``mask`` says, else
    draws: a mask from ``dropout_generator`` on the CPU, the Philox bits
    of its seed on the card."""
    if num_heads is None:
        raise ValueError("flash_attention_bsh needs num_heads")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    seed = None
    if dropout_prob > 0.0 and mask is None:
        if q.device.type == "cuda":
            if dropout_generator is None:
                raise ValueError("dropout needs a mask or a generator")
            seed = dropout_generator.initial_seed()
        elif q.device.type == "cpu":
            mask = draw_keep_mask(q, k, num_heads, dropout_prob,
                                  dropout_generator)
    return _FlashBSH.apply(q, k, v, bias, mask, int(num_heads),
                           float(sm_scale), bool(causal), float(dropout_prob),
                           seed, int(dropout_offset))[0]


flash_attention_bsh.launches = 0


def _pairs(q, k, causal):
    sq, skv = q.shape[1], k.shape[1]
    return sq * (sq + 1) // 2 if causal else sq * skv


def bound_flops(q, k, num_heads, causal=False) -> int:
    """Multiply-adds of the two products, 2 flops each: 4*D per visible
    (query, key) pair; causal sees Sq*(Sq+1)/2 pairs a head."""
    return 4 * q.shape[0] * num_heads * _pairs(q, k, causal) * (
        q.shape[-1] // num_heads)


def bound_flops_bwd(q, k, num_heads, causal=False) -> int:
    """The backward's five products (s, dp, dv, dk, dq), 2 flops a
    multiply-add: 10*D per visible (query, key) pair."""
    return 10 * q.shape[0] * num_heads * _pairs(q, k, causal) * (
        q.shape[-1] // num_heads)


def bound_bytes(q, k, v, bias, num_heads) -> int:
    """q, k, v and the bias read once; o and lse (f32) written once."""
    b, sq, _ = q.shape
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v))
    if bias is not None:
        nbytes += bias.numel() * 4
    return nbytes + q.numel() * q.element_size() + b * num_heads * sq * 4


def bound_bytes_bwd(q, k, v, bias, num_heads) -> int:
    """q, k, v, o, dO, the bias and lse read once; dq, dk, dv written once
    (delta, formed from o and dO, is not counted twice)."""
    b, sq, _ = q.shape
    act = sum(t.numel() * t.element_size() for t in (q, k, v))
    nbytes = 2 * act + 2 * q.numel() * q.element_size()
    if bias is not None:
        nbytes += bias.numel() * 4
    return nbytes + b * num_heads * sq * 4
