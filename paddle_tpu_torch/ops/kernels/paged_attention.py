"""Paged decode-step attention — one query token per sequence attending
over a paged KV cache.

    o[b] = softmax(q[b] . K[b]^T * sm_scale) V[b]

where K[b]/V[b] are the first ``lengths[b]`` logical positions gathered
through ``page_table[b]``.  Same signature and layout as the JAX
package's ``ops/pallas/paged_attention.py`` ``paged_attention``.

Implementations:

* ``paged_attention_reference`` — dense gather + f32 softmax, the plain
  PyTorch mirror of the JAX ``_ref_paged_attention``.  CPU tensors take
  it; ``impl="torch"`` forces it (tests and the kernel comparison only).
* ``paged_attention_split_reference`` — the kernel's algorithm in plain
  PyTorch: per-chunk softmax partials (m, l, acc) merged in chunk order.
  Tests hold it against the JAX reference; nothing on the main path
  calls it.
* the CUDA kernel ``csrc/paged_attention.cu`` (sm_90a, built by nvcc at
  first use, bound with ctypes).  It replaces the TPU kernel
  ``ops/pallas/paged_attention.py`` ``_paged_kernel`` /
  ``_pallas_paged_attention``.  The sequence is split across blocks
  (flash-decoding): a block takes one chunk of ``split_geometry``'s
  pages of one slot for every query head of one kv head, streams its K
  and V rows through a cp.async ring in shared memory, and the last
  chunk block of a slot to finish (an atomic ticket) merges the chunks'
  f32 partials in chunk order, so the result is bit-for-bit repeatable.
  The grid comes from the table's width, never from ``lengths``: the
  wrapper never reads ``lengths`` on the host, so a decode step does not
  synchronise.  The partials and tickets are a workspace cached per
  device and stream (``split_workspace``).  The merge runs inside the
  one kernel: one launch a call.  The source's header note has the
  design.

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


CHUNK_POSITIONS = 64  # positions a kernel block takes, in whole pages
HEADS_PER_BLOCK = (1, 2, 4, 8, 16, 32)  # the kernel's warp splits


def split_geometry(h: int, kh: int, maxp: int, page: int) -> tuple:
    """The kernel's split, from the shapes alone (never from lengths):
    (chunk_pages, nchunks, heads_per_block, hgroups).  A chunk is the
    whole pages that fit in ``CHUNK_POSITIONS`` (one page if a page is
    longer); a block serves the narrowest ``HEADS_PER_BLOCK`` that holds
    the H / KH query heads of a kv head, at most 32, and ``hgroups``
    blocks of heads cover them."""
    chunk_pages = max(1, CHUNK_POSITIONS // page)
    group = h // kh
    hpb = next(n for n in HEADS_PER_BLOCK if n >= min(group, 32))
    return chunk_pages, -(-maxp // chunk_pages), hpb, -(-group // hpb)


def paged_attention_split_reference(q, k_pages, v_pages, page_table,
                                    lengths, sm_scale: Optional[float] = None,
                                    chunk: Optional[int] = None):
    """The kernel's algorithm in plain PyTorch, any device: the table's
    positions cut into chunks of ``chunk`` pages (default
    ``split_geometry``'s), each chunk's f32 partial (m_c, l_c, acc_c) over
    its positions < len (len clamped to the table's reach), and the
    partials merged in chunk order: M = max m_c, L = sum l_c exp(m_c - M),
    o = sum acc_c exp(m_c - M) / max(L, 1e-30).  A chunk at or past len
    adds nothing, and length 0 gives 0."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    maxp = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if chunk is None:
        chunk = split_geometry(h, kh, maxp, page)[0]
    nchunks = -(-maxp // chunk)
    idx = page_table.long()
    k = k_pages[idx].reshape(b, maxp * page, kh, d).float()
    v = v_pages[idx].reshape(b, maxp * page, kh, d).float()
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * sm_scale
    pos = torch.arange(maxp * page, device=q.device)
    live = pos[None, :] < lengths.long().clamp(max=maxp * page)[:, None]
    s = torch.where(live[:, None, :], s, _NEG_INF)
    pad = nchunks * chunk * page - maxp * page   # the last chunk's tail
    s = torch.nn.functional.pad(s, (0, pad), value=_NEG_INF)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(b, h, nchunks, chunk * page)
    v = v.reshape(b, nchunks, chunk * page, h, d)
    m = s.amax(dim=-1)                                       # [B, H, C]
    dead = m == _NEG_INF
    p = torch.exp(s - torch.where(dead, 0.0, m)[..., None])  # 0 where masked
    l = p.sum(dim=-1)
    acc = torch.einsum("bhct,bcthd->bhcd", p, v)
    mx = m.amax(dim=-1)
    mx = torch.where(mx == _NEG_INF, 0.0, mx)
    out_l = torch.zeros_like(mx)
    out_a = torch.zeros(b, h, d, dtype=torch.float32, device=q.device)
    for c in range(nchunks):   # chunk order, as the kernel's merge
        w = torch.where(dead[..., c], 0.0, torch.exp(m[..., c] - mx))
        out_l = out_l + l[..., c] * w
        out_a = out_a + acc[:, :, c] * w[..., None]
    return (out_a / out_l.clamp(min=1e-30)[..., None]).to(q.dtype)


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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


_workspaces = {}


def split_workspace(device, stream: int, n_part: int, n_tickets: int):
    """(part, ticket) of the kernel on ``device`` and ``stream``: f32
    partials [>= n_part] (every chunk's acc[D], then its (m, l)) and int32
    tickets [>= n_tickets], zero between calls (each call leaves them at
    zero).  Cached per (device, stream); a call that needs more gets a
    larger pair."""
    key = (torch.device(device), int(stream))
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_tickets:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(n_part, old[0]), dtype=torch.float32,
                          device=device),
              torch.zeros(max(n_tickets, old[1]), dtype=torch.int32,
                          device=device))
        _workspaces[key] = ws
    return ws


def _cuda_paged_attention(q, k_pages, v_pages, page_table, lengths,
                          sm_scale: float):
    check_kernel_inputs(q, k_pages, v_pages, page_table, lengths)
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    maxp = page_table.shape[1]
    chunk_pages, nchunks, hpb, hgroups = split_geometry(h, kh, maxp, page)
    fn = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, ticket = split_workspace(q.device, stream,
                                       b * h * nchunks * (d + 2),
                                       b * kh * hgroups)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 part.data_ptr(), ticket.data_ptr(), b, h, kh, d, page, maxp,
                 chunk_pages, hpb, float(sm_scale), _DTYPE_CODES[q.dtype],
                 stream)
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
      lengths:    [B] int32 live KV length per slot, a device tensor
                  the kernel reads itself (0 gives 0 from the kernel and
                  NaN from the dense plain version; callers mask dead
                  slots).
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
