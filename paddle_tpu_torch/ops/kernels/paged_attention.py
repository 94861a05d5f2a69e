"""Paged decode-step attention — one query token per sequence attending
over a paged KV cache.

    o[b] = softmax(q[b] . K[b]^T * sm_scale) V[b]

where K[b]/V[b] are the first ``lengths[b]`` logical positions gathered
through ``page_table[b]``.  Same signature and layout as the JAX
package's ``ops/pallas/paged_attention.py`` ``paged_attention``.

Two implementations:

* ``paged_attention_reference`` — dense gather + f32 softmax, the plain
  PyTorch mirror of the JAX ``_ref_paged_attention``.  CPU tensors take
  it; ``impl="torch"`` forces it (tests and the kernel comparison only).
* the CUDA kernel ``csrc/paged_attention.cu`` (sm_90a, built by nvcc at
  first use, bound with ctypes).  It replaces the TPU kernel
  ``ops/pallas/paged_attention.py`` ``_paged_kernel`` /
  ``_pallas_paged_attention``.  One block per (slot, head) loops over
  only the live pages, ceil(len/page), with its online-softmax state in
  registers; the source's header note has the design.

Bound: memory.  The function has to read each slot's K and V rows at
positions t < len_b once, one int32 table entry per live page, the
lengths and q, and write out: bytes = sum_b min(len_b, maxp*page)*KH*D*
2*itemsize + 4*sum_b ceil(len_b/page) + 4*B + q + out, against 3.35 TB/s
on an H100 SXM (``bound_bytes`` computes it).

CUDA tensors reach the kernel or raise (bad dtype, shape, contiguity,
alignment, device, a failed build or launch): there is no fallback.
``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_NEG_INF = float("-inf")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              sm_scale: Optional[float] = None):
    """Dense-gather reference, any device.  A slot with length 0 gives
    NaN here (softmax over nothing) and 0 from the kernel; callers never
    pass it (the decode step's lengths are position + 1)."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    maxp = page_table.shape[1]
    t = maxp * page
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    idx = page_table.long()
    k = k_pages[idx].reshape(b, t, kh, d)     # [B, T, KH, D]
    v = v_pages[idx].reshape(b, t, kh, d)
    if kh != h:  # grouped-query: repeat shared KV heads
        rep = h // kh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * sm_scale
    pos = torch.arange(t, device=q.device)[None, None, :]
    s = torch.where(pos < lengths.long()[:, None, None], s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bht,bthd->bhd", p / l, v.float())
    return o.to(q.dtype)


def check_kernel_inputs(q, k_pages, v_pages, page_table, lengths) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else.
    Device-independent, so the CPU tests call it directly."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel takes float32 or "
                         f"bfloat16 q, got {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    b, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages/v_pages must both be [P, page, KH, D], "
                         f"got {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    _, page, kh, dk = k_pages.shape
    if dk != d or kh < 1 or h % kh:
        raise ValueError(f"pages [.., {page}, {kh}, {dk}] do not fit q "
                         f"[{b}, {h}, {d}] (need D equal, H % KH == 0)")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] < 1:
        raise ValueError(f"page_table must be [B={b}, maxp>=1], got "
                         f"{tuple(page_table.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B={b}], got "
                         f"{tuple(lengths.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("paged_attention").paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _cuda_paged_attention(q, k_pages, v_pages, page_table, lengths,
                          sm_scale: float):
    check_kernel_inputs(q, k_pages, v_pages, page_table, lengths)
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    fn = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 b, h, kh, d, page, page_table.shape[1], float(sm_scale),
                 _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, lengths,
                    sm_scale: Optional[float] = None,
                    impl: Optional[str] = None):
    """Decode-step attention over a paged KV pool.

    Args:
      q:          [B, H, D] one query token per slot.
      k_pages:    [P, page, KH, D] physical key pages (whole pool).
      v_pages:    [P, page, KH, D] physical value pages.
      page_table: [B, maxp] int32 physical page id per logical page.
      lengths:    [B] int32 live KV length per slot (0 => undefined
                  output for that slot; callers mask dead slots).
      sm_scale:   softmax scale; default 1/sqrt(D).
      impl:       None (CPU tensors: the plain version; CUDA tensors: the
                  kernel) or ``"torch"`` (the plain version, for tests
                  and comparisons).
    Returns [B, H, D] in q.dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if impl not in (None, "torch"):
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if impl == "torch" or q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {q.device}")
    return _cuda_paged_attention(q, k_pages, v_pages, page_table, lengths,
                                 sm_scale)


paged_attention.launches = 0


def bound_bytes(q, k_pages, page_table, lengths) -> int:
    """Bytes the function must move for these inputs: each slot's K and V
    rows at positions t < len (len clamped to the table's reach) once,
    one int32 table entry per live page, the lengths, q read and out
    written once."""
    _, page, kh, d = k_pages.shape
    reach = page_table.shape[1] * page
    lens = [min(int(x), reach) for x in lengths.tolist()]
    rows = sum(lens)
    pages = sum(-(-n // page) for n in lens)
    return (rows * kh * d * 2 * k_pages.element_size() + 4 * pages
            + 4 * len(lens) + 2 * q.numel() * q.element_size())
