"""Flash attention (online softmax): the forward and backward of the JAX
package's ``ops/pallas/flash_attention.py`` in both of its layouts.

BSH — head-interleaved [B, S, H] tensors (``flash_attention_bsh``):

    o[b, :, h]    = softmax(q_h k_h^T * sm_scale + bias[b]) v_h
    lse[b, h, :]  = log-sum-exp of those scores

with q [B, Sq, H], k/v [B, Skv, H], H = num_heads * D and head h owning
columns [h*D, (h+1)*D); bias is per key ([B, 1, 1, Skv] or [B, 1, Skv],
the BERT padding mask) and gets a zero cotangent; causal masks keys above
the diagonal (Sq == Skv only).  Same semantics and shape rules as the JAX
package's ``flash_attention_bsh`` and its custom VJP.

BHSD — [B, nh, S, D] tensors, Sq = Skv = S (``flash_attention`` and
``flash_block_with_lse``, rows 6-9 of PERF.md's kernel table): what BSH
does not take — a full [B|1, nh|1, S, S] bias (held as its [R, S, S]
rows, read through the row map (bh // div) % mod, never broadcast), a
per-key [B|1, 1, 1, S] bias (its [bb, S] rows), dbias when
``bias_requires_grad``, the lse as an output with a cotangent (folded into
delta), and causal masking at runtime (q_offset, k_offset).  Scores are
multiplied by sm_scale (no q prescale).  A row that sees no key gets o =
0 and lse = NEG_INF, and zero gradients.  The backward dispatches as the
JAX package's ``_flash_bwd``: a full bias takes the split kernels (dq,
then dk/dv and the [BH, S, S] dbias), every other bias the single pass
(dq, dk, dv and the key dbias).

Dropout acts on the probabilities' numerator (the row sum l and the lse
stay undropped, as in the TPU kernels).  The keep bits come from

* an explicit uint8 keep mask [B, nh, Sq, Skv] (the JAX package's
  ``has_mask`` path), kept values divided by 1 - p; the CPU draws one
  from the op's generator (the JAX package materializes one in interpret
  mode);
* on the card, without a mask, an in-kernel Philox keyed by (seed,
  offset, b * nh + h, q, k), the threshold quantized to 1/256 as
  ``_dropout_quantized_thresh`` does and kept values divided by the
  quantized keep probability.  The seed is the op's salted generator's
  (``Generator.initial_seed()``: a host integer, no device sync); the
  backward regenerates the same bits, and both layouts draw the same bits
  for the same (seed, offset, head, q, k).

Two implementations of each direction:

* the plain PyTorch versions — ``flash_attention_bsh_reference`` /
  ``flash_attention_bsh_bwd_reference`` (the reference's
  ``_reference_attention`` with a per-key bias plus the lse, and its
  backward from the lse) and ``flash_attention_reference`` /
  ``flash_attention_bwd_reference`` (the BHSD kernels' math), in f32;
  each is a probs part and a products part (``bsh_fwd_probs_reference``
  / ``bsh_fwd_products_reference``, ``bwd_probs_reference`` /
  ``bwd_products_reference``, their ``bhsd_`` twins), so a check on the
  card can hold each bf16 rounding on its own.  CPU and ``meta`` tensors
  take them.
* the CUDA kernels of ``csrc/flash_attention_bsh.cu`` and
  ``csrc/flash_attention_bhsd.cu`` (sm_90a, built by nvcc at first use,
  bound with ctypes; their shared dropout helpers in
  ``csrc/flash_common.cuh``).  They replace the TPU kernels
  ``_make_fwd_bsh_kernel`` / ``_make_bwd_bsh_kernel`` and
  ``_make_fwd_kernel`` (row 6), ``_make_bwd_fused_kernel`` (row 7),
  ``_make_bwd_dq_kernel`` (row 8) and ``_make_bwd_dkv_kernel`` (row 9):
  in f32 one block per (query or key tile, head) streams the other
  operand's tiles through shared memory on the SIMT cores (the BSH
  forward with 8 x 8 register tiles and a cp.async ring,
  ``simt_fwd_grid``); in bf16 every one runs
  on the tensor cores (wgmma: ``bsh_fwd_route``, ``bsh_bwd_route``,
  ``bhsd_fwd_route``, ``bhsd_bwd_route``), rounding p c (and ds) to bf16
  before its products as the TPU kernels do, and the plain versions
  round them the same way.  Every backward is deterministic (no
  atomics).  The sources' header notes have the designs.

``flash_attention_bsh``, ``flash_attention`` and ``flash_block_with_lse``
are differentiable: ``torch.autograd.Function``s whose forward and
backward are the above.

The mesh form (the JAX package's ``flash_attention(mesh=, batch_axis=,
head_axis=)`` and ``flash_attention_bsh``'s mesh branch, a shard_map with
batch on dp and heads on tp): one process per rank already holds its
block, so ``flash_attention_bsh`` / ``flash_attention`` with a ``mesh``
whose ``head_axis`` has n > 1 ranks take q, k, v of this rank's heads
[i nh/n, (i+1) nh/n) of ``num_heads`` and salt the dropout seed with the
head shard (``head_shard``: the JAX package adds 0x1B873593 x i to its
seed; the bits differ from the TPU's PRNG by design).  The batch shard
is already in the executor's step seed, so ``batch_axis`` is accepted
for parity.

Bounds: ``bound_flops`` / ``bound_flops_bwd`` and ``bound_bytes`` /
``bound_bytes_bwd`` for BSH, ``bound_flops_bhsd`` / ``bound_bytes_bhsd``
per BHSD kernel (flops against the dtype's peak, bytes against 3.35
TB/s; the larger time bounds).  CUDA tensors reach the kernels or raise.
Launch counters: ``flash_attention_bsh.launches`` (BSH forward),
``flash_attention_bsh_bwd.launches`` (BSH backward, two a call),
``flash_attention.launches`` (row 6), ``flash_attention_bwd_fused``
(row 7), ``flash_attention_bwd_dq`` (row 8) and
``flash_attention_bwd_dkv`` (row 9) ``.launches``; each also counts
``.launches_tc``, the launches of its wgmma kernels, and the BSH pair
``.launches_f16``, those of the wgmma kernels' f16 form.

float16 (float16 AMP): the BSH kernels (rows 4 and 5) take it on their
wgmma route (``_BSH_DTYPE_CODES``), rounding p c and ds to f16 where the
bf16 form rounds to bf16; the plain versions round by dtype alike.  The
BHSD kernels (rows 6-9) still refuse an f16 CUDA tensor with
ValueError; their plain versions take it.
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
# the BSH kernels (rows 4 and 5) also take float16, on their wgmma route;
# the BHSD kernels (rows 6-9) refuse it
_BSH_DTYPE_CODES = {**_DTYPE_CODES, torch.float16: 2}
_TC_DTYPES = (torch.bfloat16, torch.float16)
_NO_DROP, _MASK_DROP, _PHILOX_DROP = 0, 1, 2


HEAD_SALT = 0x1B873593   # the JAX package's head-shard seed multiplier


def head_shard(num_heads, dropout_generator, mesh, head_axis="tp"):
    """(local heads, generator) of this rank under ``mesh``: with n > 1
    ranks on ``head_axis`` it holds nh / n of ``num_heads`` heads, and its
    dropout generator (when there is one) is re-seeded with the head
    shard mixed in, so the ranks of one data shard draw different masks
    for their heads.  Without such an axis both come back unchanged."""
    from ..registry import mix_seed

    n = 1 if mesh is None else mesh.shape.get(head_axis, 1)
    if n <= 1:
        return num_heads, dropout_generator
    if num_heads % n:
        raise ValueError(f"{num_heads} heads do not divide over mesh axis "
                         f"{head_axis!r} of size {n}")
    gen = dropout_generator
    if gen is not None:
        seed = mix_seed(gen.initial_seed(),
                        HEAD_SALT * (1 + mesh.coords[head_axis]))
        gen = torch.Generator(device=gen.device)
        gen.manual_seed(seed)
    return num_heads // n, gen


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


flash_block_ok = flash_shapes_ok  # the ring's gate (the reference's alias)


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


def bsh_fwd_probs_reference(q, k, bias=None, num_heads=None,
                            sm_scale=None, causal=False, mask=None,
                            keep_div=1.0):
    """The plain forward's intermediates: (p c [B, nh, Sq, Skv] rounded
    to q's dtype as ``_make_fwd_bsh_kernel`` rounds p_num to v's before
    P.V, relative to each row's max, returned as f32; m and l_safe =
    max(l, 1e-30), [B, nh, Sq, 1] f32).  p = exp(s - m); l sums the
    undropped p; c = keep / keep_div where ``mask`` (uint8 [B, nh, Sq,
    Skv]) is given, else 1.  In f32 the rounding is a no-op."""
    nh = int(num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // nh)
    s = _scores(q, k, bias, nh, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    num = p if mask is None else torch.where(mask != 0, p / keep_div, 0.0)
    return num.to(q.dtype).float(), m, l_safe


def bsh_fwd_products_reference(v, p_num, m_tiles, lse, num_heads,
                               tile=64):
    """o [B, Sq, H] f32 from a tiled forward's intermediates: p c rounded
    relative to the running max ``m_tiles`` [B, nh, Sq, Skv / tile] (the
    max after each key tile), as ``bhsd_fwd_products_reference`` on the
    heads of ``v``."""
    b, skv, hdim = v.shape
    nh = int(num_heads)
    o = bhsd_fwd_products_reference(_heads(v, b, skv, nh), p_num, m_tiles,
                                    lse, tile)
    return o.transpose(1, 2).reshape(b, o.shape[2], hdim)


def flash_attention_bsh_reference(q, k, v, bias=None, num_heads=None,
                                  sm_scale=None, causal=False,
                                  dropout_prob=0.0, generator=None,
                                  mask=None, keep_div=None):
    """Plain version, any device: (o [B, Sq, H] in q.dtype, lse [B, nh,
    Sq] f32).  f32 scores and softmax; p c rounded to v's dtype before
    the P.V product, as ``_make_fwd_bsh_kernel`` rounds it
    (``bsh_fwd_probs_reference``; in f32 a no-op), o = (p c) V / l.
    Dropout keeps where ``mask`` (uint8 [B, nh, Sq, Skv]) is nonzero, or
    draws the mask from ``generator``; kept values divide by ``keep_div``
    (default 1 - dropout_prob)."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    nh = int(num_heads)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hdim // nh)
    drop = dropout_prob > 0.0 and q.device.type != "meta"
    if drop and mask is None:
        mask = draw_keep_mask(q, k, nh, dropout_prob, generator)
    div = (1.0 - dropout_prob) if keep_div is None else keep_div
    p_num, m, l_safe = bsh_fwd_probs_reference(
        q, k, bias, nh, sm_scale, causal, mask if drop else None, div)
    o = torch.matmul(p_num, _heads(v, b, skv, nh)) / l_safe
    o = o.transpose(1, 2).reshape(b, sq, hdim).to(q.dtype)
    return o, (m + torch.log(l_safe))[..., 0]


def bwd_probs_reference(q, k, v, bias, o, lse, do, num_heads,
                        sm_scale=None, causal=False, mask=None,
                        keep_div=1.0):
    """The plain backward's intermediates, f32 [B, nh, Sq, Skv]: p c and
    ds = p (dp c - delta) sm_scale, each rounded to the inputs' dtype as
    ``_make_bwd_bsh_kernel`` rounds them before its products (a no-op in
    f32); p = exp(s - lse), c = keep / keep_div (1 without ``mask``)."""
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
    return p_num.to(q.dtype).float(), ds.to(q.dtype).float()


def bwd_products_reference(q, k, v, do, p_num, ds, num_heads, ds_q=None):
    """(dq, dk, dv) in the inputs' dtypes from the intermediates: dv =
    (p c)^T dO, dk = ds^T q, dq = ds_q k (ds_q defaults to ds), summed in
    f32."""
    b, sq, hdim = q.shape
    skv = k.shape[1]
    nh = int(num_heads)
    dof = _heads(do, b, sq, nh)
    ds_q = ds if ds_q is None else ds_q
    dv = torch.matmul(p_num.float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.float().transpose(-1, -2), _heads(q, b, sq, nh))
    dq = torch.matmul(ds_q.float(), _heads(k, b, skv, nh))

    def merge(t, s, like):
        return t.transpose(1, 2).reshape(b, s, hdim).to(like.dtype)

    return merge(dq, sq, q), merge(dk, skv, k), merge(dv, skv, v)


def flash_attention_bsh_bwd_reference(q, k, v, bias, o, lse, do,
                                      num_heads, sm_scale=None,
                                      causal=False, mask=None,
                                      keep_div=1.0):
    """Plain backward, any device: (dq, dk, dv) in the inputs' dtypes,
    from the forward's o and lse, as ``_make_bwd_bsh_kernel`` computes
    them: the intermediates of ``bwd_probs_reference`` (rounded to the
    inputs' dtype) through the products of ``bwd_products_reference``."""
    p_num, ds = bwd_probs_reference(q, k, v, bias, o, lse, do, num_heads,
                                    sm_scale, causal, mask, keep_div)
    return bwd_products_reference(q, k, v, do, p_num, ds, num_heads)


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
    if q.dtype not in _BSH_DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32, bfloat16 or float16 "
                         f"q, got {q.dtype}")
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
        if name in ("launch", "fwd_tc_launch"):
            # fwd_tc_launch: two check outputs before the stream
            fn.argtypes = ([p] * 6 + [i] * 5 + [f] + [i] * 4 + [p, p]
                           + [ctypes.c_ulonglong, i, i, f]
                           + [p] * (3 if name == "fwd_tc_launch" else 1))
        else:
            # bwd_tc_launch: three check outputs before the stream
            fn.argtypes = ([p] * 10 + [i] * 5 + [f] + [i] * 4 + [p]
                           + [ctypes.c_ulonglong, i, i, f]
                           + [p] * (4 if name == "bwd_tc_launch" else 1))
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


# the f32 SIMT forward's (query rows, keys) a block by head dim
SIMT_FWD_TILES = {64: (128, 128), 128: (64, 128), 256: (32, 64)}


def simt_fwd_grid(b, sq, num_heads, head_dim) -> tuple:
    """The f32 SIMT forward's grid (query tiles, heads, batch): one block
    of 256 threads a ``SIMT_FWD_TILES`` query tile, one block an SM."""
    return (-(-sq // SIMT_FWD_TILES[head_dim][0]), num_heads, b)


def bsh_fwd_route(dtype) -> str:
    """Which forward kernel row 4 launches, by dtype alone: "tc" (the
    wgmma kernel, its bf16 or its f16 form) for bf16 and float16; "simt"
    (f32 FMA) for float32, which tensor cores would round to TF32."""
    return "tc" if dtype in _TC_DTYPES else "simt"


def _cuda_flash_bsh(q, k, v, bias, num_heads, sm_scale, causal,
                    dropout_prob, mask, seed, offset, return_bits,
                    return_probs=False):
    """Launch row 4 on the route ``bsh_fwd_route`` names.  Returns (o,
    lse, bits, checks): bits the Philox keep bits when ``return_bits``,
    checks on the tensor-core route with ``return_probs`` (p c as the
    kernel rounds it for P.V, q's dtype [B, nh, Sq, Skv], and its running max
    after each 64-key tile, f32 [B, nh, Sq, Skv / 64]), else None."""
    check_kernel_inputs(q, k, v, bias, num_heads, causal, dropout_prob, mask)
    b, sq, hdim = q.shape
    skv = k.shape[1]
    bias = _key_bias(bias, b, skv)
    tc = bsh_fwd_route(q.dtype) == "tc"
    # both routes cp.async 16-byte rows of k, v and the bias
    q, k, v = (_aligned(t) for t in (q, k, v))
    bias = None if bias is None else _aligned(bias)
    mode, mask, thresh, keep_div = _drop_args(dropout_prob, mask, seed)
    bits = None
    if return_bits and mode == _PHILOX_DROP:
        bits = torch.zeros((b, num_heads, sq, skv), dtype=torch.uint8,
                           device=q.device)
    checks = None
    if tc and return_probs:
        checks = (torch.zeros((b, num_heads, sq, skv), dtype=q.dtype,
                              device=q.device),
                  torch.full((b, num_heads, sq, skv // KERNEL_ROWS), NEG_INF,
                             dtype=torch.float32, device=q.device))
    fn = _launcher("fwd_tc_launch" if tc else "launch")
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, sq, skv, num_heads, hdim // num_heads,
                 float(sm_scale), int(prescale_ok(sm_scale)), int(causal),
                 _BSH_DTYPE_CODES[q.dtype], mode,
                 None if mask is None else mask.data_ptr(),
                 None if bits is None else bits.data_ptr(),
                 int(seed or 0) & ((1 << 64) - 1), int(offset), thresh,
                 float(keep_div),
                 *(() if not tc else (None, None) if checks is None
                   else map(_ptr, checks)),
                 stream)
    if err:
        raise RuntimeError(f"flash_attention_bsh kernel"
                           f"{' (tensor cores)' if tc else ''} launch "
                           f"failed: CUDA error {err}")
    flash_attention_bsh.launches += 1
    if tc:
        flash_attention_bsh.launches_tc += 1
    if q.dtype == torch.float16:
        flash_attention_bsh.launches_f16 += 1
    return o, lse, bits, checks


def flash_attention_bsh_fwd(q, k, v, bias=None, num_heads=None,
                            sm_scale: Optional[float] = None, causal=False,
                            dropout_prob=0.0, dropout_generator=None, *,
                            mask=None, dropout_seed=None, dropout_offset=0,
                            return_bits=False, return_probs=False):
    """(o [B, Sq, H], lse [B, nh, Sq] f32), not differentiable.  CPU and
    meta tensors take the plain version (dropout from ``mask`` or drawn
    from ``dropout_generator``); CUDA tensors launch the kernel
    ``bsh_fwd_route`` names (``launches_tc`` counts the wgmma kernel's
    launches) or raise (dropout from ``mask``, else Philox from
    ``dropout_seed``).  ``return_bits`` adds the uint8 keep bits the
    Philox drew (None without Philox); ``return_probs`` (CUDA only, a
    check's output) then the wgmma kernel's (p c, running max), None on
    the SIMT route (``_cuda_flash_bsh``)."""
    if num_heads is None:
        raise ValueError("flash_attention_bsh needs num_heads")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention_bsh: causal with sq != skv would be top-left "
            "aligned (use equal lengths)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    extra = (return_bits, return_probs)
    if q.device.type in ("cpu", "meta"):
        out = flash_attention_bsh_reference(
            q, k, v, bias, num_heads, sm_scale, causal, dropout_prob,
            dropout_generator, mask)
        return out + tuple(None for want in extra if want)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    o, lse, bits, checks = _cuda_flash_bsh(
        q, k, v, bias, num_heads, sm_scale, causal, dropout_prob, mask,
        dropout_seed, dropout_offset, return_bits, return_probs)
    return (o, lse) + tuple(t for t, want in zip((bits, checks), extra)
                            if want)


def bsh_bwd_route(dtype) -> str:
    """Which backward kernels row 5 launches, by dtype alone: "tc" (the
    wgmma kernels, their bf16 or their f16 form) for bf16 and float16,
    "simt" (f32 FMA) for float32, which tensor cores would round to
    TF32."""
    return "tc" if dtype in _TC_DTYPES else "simt"


def _aligned(t):
    """t itself when its data is 16-byte aligned (the kernels' cp.async
    rows), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cuda_flash_bsh_bwd(q, k, v, bias, o, lse, do, num_heads, sm_scale,
                        causal, dropout_prob, mask, seed, offset,
                        return_probs=False):
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
    tc = bsh_bwd_route(q.dtype) == "tc"
    if tc:
        q, k, v, do, lse = (_aligned(t) for t in (q, k, v, do, lse))
    fn = _launcher("bwd_tc_launch" if tc else "bwd_launch")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    probs = ()
    if tc:
        probs = tuple(
            torch.zeros((b, num_heads, sq, skv), dtype=q.dtype,
                        device=q.device) if return_probs else None
            for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, sq, skv, num_heads, d,
                 float(sm_scale), int(prescale_ok(sm_scale)), int(causal),
                 _BSH_DTYPE_CODES[q.dtype], mode,
                 None if mask is None else mask.data_ptr(),
                 int(seed or 0) & ((1 << 64) - 1), int(offset), thresh,
                 float(keep_div),
                 *(None if t is None else t.data_ptr() for t in probs),
                 stream)
    if err:
        raise RuntimeError(f"flash_attention_bsh backward kernel launch "
                           f"failed: CUDA error {err}")
    flash_attention_bsh_bwd.launches += 2  # the dk/dv and the dq kernel
    if tc:
        flash_attention_bsh_bwd.launches_tc += 2
    if q.dtype == torch.float16:
        flash_attention_bsh_bwd.launches_f16 += 2
    if return_probs:
        return dq, dk, dv, probs if tc else None
    return dq, dk, dv


def flash_attention_bsh_bwd(q, k, v, bias, o, lse, do, num_heads,
                            sm_scale=None, causal=False, dropout_prob=0.0,
                            *, mask=None, dropout_seed=None,
                            dropout_offset=0, return_probs=False):
    """(dq, dk, dv) of the forward that gave o and lse (bias: zero
    cotangent).  CPU and meta tensors take the plain version, which
    needs the forward's ``mask`` for dropout; CUDA tensors launch the two
    backward kernels or raise (Philox regenerated from ``dropout_seed``
    when no mask is given): the wgmma pair for bf16, the SIMT pair for
    f32 (``bsh_bwd_route``); ``launches`` counts both, ``launches_tc``
    the wgmma pair's.  ``return_probs`` (CUDA only, a check's output)
    appends the wgmma kernels' rounded intermediates (p c and ds of the
    dk/dv kernel, ds of the dq kernel, each [B, nh, Sq, Skv]), or None on
    the SIMT route."""
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
                               mask, dropout_seed, dropout_offset,
                               return_probs)


flash_attention_bsh_bwd.launches = 0
flash_attention_bsh_bwd.launches_tc = 0
flash_attention_bsh_bwd.launches_f16 = 0


def _bsh_backward(ctx, do):
    q, k, v, bias, mask, o, lse = ctx.saved_tensors
    nh, sm_scale, causal, p, seed, offset = ctx.args
    return flash_attention_bsh_bwd(
        q, k, v, bias, o, lse, do, nh, sm_scale, causal, p, mask=mask,
        dropout_seed=seed, dropout_offset=offset)


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
        # BiasQK: a zero cotangent on every path, as in the reference
        return _bsh_backward(ctx, do) + (None,) * 8


class _FlashBSHSaved(torch.autograd.Function):
    """``_FlashBSH`` with the forward's (o, lse) handed in: launches
    nothing, saves what ``_FlashBSH`` saves, in the same order (a
    checkpointed layer's recompute under ``remat_policy="flash"``, whose
    saved tensors stand in for the first pass's), and has its backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, o, lse, num_heads, sm_scale,
                causal, dropout_prob, seed, offset):
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.args = (num_heads, sm_scale, causal, dropout_prob, seed, offset)
        o, lse = o.view_as(o), lse.view_as(lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        return _bsh_backward(ctx, do) + (None,) * 10


def flash_attention_bsh(q, k, v, bias=None, num_heads=None, sm_scale=None,
                        causal=False, dropout_prob=0.0,
                        dropout_generator=None, *, mask=None,
                        dropout_offset=0, return_lse=False, saved=None,
                        mesh=None, batch_axis="dp", head_axis="tp"):
    """Transpose-free attention on projection-layout tensors; returns o
    [B, Sq, H] (the JAX package's signature; ``mesh``: this rank's heads,
    see the module note), differentiable in q, k and v.  Dropout keeps where ``mask`` says, else
    draws: a mask from ``dropout_generator`` on the CPU, the Philox bits
    of its seed on the card.  ``return_lse`` returns (o, lse [B, nh, Sq]
    f32, not differentiable).  ``saved`` = (o, lse) of an earlier call on
    the same inputs launches no forward: the result is that o, with this
    call's backward (``_FlashBSHSaved``)."""
    if num_heads is None:
        raise ValueError("flash_attention_bsh needs num_heads")
    num_heads, dropout_generator = head_shard(num_heads, dropout_generator,
                                              mesh, head_axis)
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
    args = (int(num_heads), float(sm_scale), bool(causal),
            float(dropout_prob), seed, int(dropout_offset))
    if saved is None:
        o, lse = _FlashBSH.apply(q, k, v, bias, mask, *args)
    else:
        o, lse = _FlashBSHSaved.apply(q, k, v, bias, mask, *saved, *args)
    return (o, lse) if return_lse else o


flash_attention_bsh.launches = 0
flash_attention_bsh.launches_tc = 0
flash_attention_bsh.launches_f16 = 0


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


# ---------------------------------------------------------------------------
# [B, nh, S, D]: the BHSD half (the JAX package's flash_attention and
# flash_block_with_lse, rows 6-9 of PERF.md's kernel table)
# ---------------------------------------------------------------------------

_BIAS_CODES = {None: 0, "key": 1, "full": 2}
_FUSED, _DQ, _DKV = 0, 1, 2


def _classify_bias(bias, b, nh, s):
    """(kernel bias, mode, (bb, bn)) as the JAX package's
    ``_classify_bias``: no bias; 'key' for [B|1, 1, 1, S], held as its
    [bb, S] f32 rows (a reshape, never broadcast to [B * nh, S]); 'full'
    for [B|1, nh|1, S, S], held as [bb * bn, S, S] in its dtype."""
    if bias is None:
        return None, None, None
    if bias.dim() != 4:
        raise ValueError(f"flash_attention bias must be 4-D, got "
                         f"{tuple(bias.shape)}")
    bb, bn, bq, bk = bias.shape
    if bb not in (1, b) or bn not in (1, nh):
        raise ValueError(f"bias dims {tuple(bias.shape)} not broadcastable "
                         f"to batch={b}, heads={nh}")
    if bk != s:
        raise ValueError(f"bias key dim {bk} != seq {s}")
    if bn == 1 and bq == 1:
        return bias.reshape(bb, s).float(), "key", (bb, 1)
    if bq != s:
        raise ValueError(f"bias query dim {bq} != seq {s}")
    return bias.reshape(bb * bn, s, s), "full", (bb, bn)


def _bias_row_map(bias_dims, num_heads):
    """(div, mod): the kernel bias row of bh = b * nh + h is (bh // div)
    % mod, for the key rows and the full [R, S, S] rows alike."""
    bb, bn = bias_dims
    return (num_heads if bn == 1 else 1), bb * bn


def _causal_masked(s, q_off, k_off, device):
    """[S, S] True where key k_off + j lies above query q_off + i
    (``_causal_mask``)."""
    i = torch.arange(s, device=device)[:, None] + int(q_off)
    j = torch.arange(s, device=device)[None, :] + int(k_off)
    return i < j


def _bhsd_scores(q, k, bias, sm_scale, causal, q_off, k_off):
    """f32 scores [B, nh, S, S] (q . k times sm_scale, no prescale, plus
    the bias) and the causal mask (None without causal)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    masked = None
    if causal:
        masked = _causal_masked(q.shape[2], q_off, k_off, q.device)
        s = s.masked_fill(masked, NEG_INF)
    return s, masked


def bhsd_fwd_route(dtype) -> str:
    """Which kernel row 6 launches, by dtype alone: "tc" (the wgmma
    kernel) for bf16, in every bias mode; "simt" (f32 FMA) for float32,
    which tensor cores would round to TF32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


def bhsd_fwd_probs_reference(q, k, bias=None, sm_scale=None, causal=False,
                             mask=None, keep_div=1.0, q_offset=0,
                             k_offset=0):
    """The plain forward's intermediates: (p c [B, nh, S, S] rounded to
    q's dtype as ``_make_fwd_kernel`` rounds p_num before P.V, relative to
    each row's max, returned as f32; m and l_safe = max(l, 1e-30), [B, nh,
    S, 1] f32).  p = exp(s - m), 0 at a masked score; l sums the
    undropped p; c = keep / keep_div where ``mask`` (uint8 [B, nh, S, S])
    is given, else 1."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sc, masked = _bhsd_scores(q, k, bias, sm_scale, causal, q_offset,
                              k_offset)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    num = p if mask is None else torch.where(mask != 0, p / keep_div, 0.0)
    return num.to(q.dtype).float(), m, l_safe


def bhsd_fwd_products_reference(v, p_num, m_tiles, lse, tile=64):
    """o [B, nh, S, D] f32 from a tiled forward's intermediates: p c
    rounded relative to the running max ``m_tiles`` [B, nh, S, S / tile]
    (the max after each key tile), so o = sum over key tiles t of
    exp(m_t - lse) (p c)_t v_t."""
    scale = torch.exp(m_tiles - lse[..., None].float())
    scale = scale.repeat_interleave(tile, dim=-1)
    return torch.matmul(p_num.float() * scale, v.float())


def flash_attention_reference(q, k, v, bias=None, sm_scale=None,
                              causal=False, dropout_prob=0.0, mask=None,
                              keep_div=None, q_offset=0, k_offset=0):
    """Plain version of rows 6's kernel, any device: (o [B, nh, S, D] in
    q.dtype, lse [B, nh, S] f32).  f32 scores, a masked score's p is 0 (a
    row that sees no key gets o = 0 and lse = NEG_INF), l_safe = max(l,
    1e-30), numerator-only dropout where ``mask`` (uint8 [B, nh, S, S])
    is 0, kept values divided by ``keep_div`` (default 1 - p); p c rounded
    to v's dtype before P.V, as ``_make_fwd_kernel`` rounds it (in f32 a
    no-op): ``bhsd_fwd_probs_reference``."""
    b, nh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    _classify_bias(bias, b, nh, s)  # the same shape errors as the kernel
    drop = dropout_prob > 0.0 and mask is not None
    div = (1.0 - dropout_prob) if keep_div is None else keep_div
    p_num, m, l_safe = bhsd_fwd_probs_reference(
        q, k, bias, sm_scale, causal, mask if drop else None, div, q_offset,
        k_offset)
    o = torch.matmul(p_num, v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _sum_to(t, shape):
    """Sum a [B, nh, S, S] cotangent over the dims ``shape`` broadcasts."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


def bhsd_bwd_route(dtype, mode) -> str:
    """Which kernels the BHSD backward launches: "tc" (rows 8 and 9 on the
    wgmma kernels) for bf16 with a full bias; "fused_tc" (row 7 on its
    wgmma kernel) for bf16 with no bias or a key bias; "simt" (f32 FMA,
    rows 7-9) for float32, which tensor cores would round to TF32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "tc" if mode == "full" else "fused_tc"


def bhsd_bwd_probs_reference(q, k, v, bias, o, lse, do, sm_scale=None,
                             causal=False, mask=None, keep_div=1.0,
                             q_offset=0, k_offset=0, g_lse=None):
    """The plain backward's intermediates, f32 [B, nh, S, S], unrounded:
    (p c, ds0).  p = exp(s - lse), 0 where masked; delta = rowsum(o * dO)
    - g_lse in f32; ds0 = p (dp c - delta) with c = keep / keep_div (1
    without ``mask``)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sc, masked = _bhsd_scores(q, k, bias, sm_scale, causal, q_offset,
                              k_offset)
    p = torch.exp(sc - lse[..., None].float())
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse[..., None].float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    if mask is not None:
        c = torch.where(mask != 0, 1.0 / keep_div, 0.0)
        p_num, dp = p * c, dp * c
    else:
        p_num = p
    return p_num, p * (dp - delta)


def bhsd_bwd_rounded(p_num, ds0, sm_scale, do_dtype, q_dtype):
    """The intermediates as ``_make_bwd_dkv_kernel``,
    ``_make_bwd_dq_kernel`` and ``_make_bwd_fused_kernel`` round them
    before their products: p c in dO's dtype, ds = ds0 sm_scale in q's;
    returned as f32."""
    return (p_num.to(do_dtype).float(),
            (ds0 * sm_scale).to(q_dtype).float())


def bhsd_bwd_products_reference(q, k, v, do, p_num, ds, sm_scale=1.0,
                                ds_q=None):
    """(dq, dk, dv) in the inputs' dtypes from the intermediates: dv =
    (p c)^T dO, dk = (ds^T q) sm_scale, dq = (ds_q k) sm_scale (ds_q
    defaults to ds), summed in f32.  f32 passes ds0 and sm_scale, bf16
    the rounded ds (sm_scale in it)."""
    ds_q = ds if ds_q is None else ds_q
    dq = torch.matmul(ds_q.float(), k.float()) * sm_scale
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * sm_scale
    dv = torch.matmul(p_num.float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, bias, o, lse, do, sm_scale=None,
                                  causal=False, mask=None, keep_div=1.0,
                                  q_offset=0, k_offset=0, g_lse=None,
                                  want_dbias=False):
    """Plain backward of rows 7-9, any device: (dq, dk, dv in the inputs'
    dtypes, dbias in the bias's shape and dtype, or None) from the
    forward's o and lse: the intermediates of ``bhsd_bwd_probs_reference``
    through ``bhsd_bwd_products_reference``: dq = ds0 k sm_scale, dk =
    ds0^T q sm_scale, dv = (p c)^T dO.  In bf16 and f16, every bias mode,
    p c and ds0 sm_scale are rounded first (``bhsd_bwd_rounded``), as the
    TPU's kernels (rows 7, 8 and 9) round them: the rule goes by dtype, and
    in f32 the rounding would be a no-op.  dbias = the unrounded ds0 without
    sm_scale, summed back to the bias's shape (key: over heads and rows,
    and the batch when the bias has one row; full: over the broadcast
    batch and heads)."""
    b, nh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    _classify_bias(bias, b, nh, s)  # the same shape errors as the kernels
    p_num, ds0 = bhsd_bwd_probs_reference(
        q, k, v, bias, o, lse, do, sm_scale, causal, mask, keep_div,
        q_offset, k_offset, g_lse)
    if q.dtype in _TC_DTYPES:
        p_r, ds_r = bhsd_bwd_rounded(p_num, ds0, sm_scale, do.dtype, q.dtype)
        dq, dk, dv = bhsd_bwd_products_reference(q, k, v, do, p_r, ds_r)
    else:
        dq, dk, dv = bhsd_bwd_products_reference(q, k, v, do, p_num, ds0,
                                                 sm_scale)
    dbias = None
    if want_dbias and bias is not None:
        dbias = _sum_to(ds0, bias.shape).to(bias.dtype)
    return dq, dk, dv, dbias


def draw_keep_mask_bhsd(q, dropout_prob, generator):
    """A uint8 keep mask [B, nh, S, S] drawn from ``generator``: each
    entry kept with probability 1 - dropout_prob."""
    shape = tuple(q.shape[:3]) + (q.shape[2],)
    u = torch.rand(shape, generator=generator, device=q.device)
    return (u < 1.0 - dropout_prob).to(torch.uint8)


def check_bhsd_inputs(q, k, v, bias, dropout_prob=0.0, mask=None) -> None:
    """What the BHSD kernels take; raises ValueError on anything else.
    Device-independent, so the CPU tests call it directly."""
    if not 0.0 <= dropout_prob < 1.0:
        raise ValueError(f"dropout_prob {dropout_prob} is not in [0, 1)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, got "
                         f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q, k, v must be one [B, nh, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, nh, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if s % KERNEL_ROWS:
        raise ValueError(f"length S={s} must be a multiple of {KERNEL_ROWS}")
    if b * nh > 65535:
        raise ValueError(f"B * nh = {b * nh} blocks exceed the grid's 65535")
    _, mode, _ = _classify_bias(bias, b, nh, s)
    if mode == "full" and bias.dtype not in _DTYPE_CODES:
        raise ValueError(f"full bias must be float32 or bfloat16, got "
                         f"{bias.dtype}")
    if mask is not None and (mask.dtype != torch.uint8
                             or tuple(mask.shape) != (b, nh, s, s)):
        raise ValueError(f"mask must be uint8 [B, nh, S, S] = "
                         f"{(b, nh, s, s)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias),
                    ("mask", mask)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _bhsd_launcher(name: str):
    """The ctypes function ``flash_bhsd_<name>_launch`` of the library."""
    key = f"bhsd_{name}"
    fn = _fns.get(key)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("flash_attention_bhsd"),
                     f"flash_bhsd_{name}_launch")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "fwd":
            # two check outputs before the stream
            fn.argtypes = ([p] * 4 + [i] * 4 + [p, p] + [i] * 3 + [f]
                           + [i] * 5 + [p, p, ctypes.c_ulonglong, i, i, f]
                           + [p] * 3)
        else:
            # bwd_tc: three check outputs before the stream
            fn.argtypes = ([i] + [p] * 4 + [i] * 4 + [p] * 8 + [i] * 3
                           + [f] + [i] * 5 + [p, ctypes.c_ulonglong, i, i,
                                              f]
                           + [p] * (4 if name == "bwd_tc" else 1))
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bias_args(bias_k, mode, dims, nh):
    """(pointer, mode code, bf16 flag, row div, row mod) of the kernel
    bias."""
    if mode is None:
        return None, 0, 0, 1, 1
    div, mod = _bias_row_map(dims, nh)
    return (bias_k.data_ptr(), _BIAS_CODES[mode],
            int(bias_k.dtype == torch.bfloat16), div, mod)


def _drop_tail(mode, mask, seed, offset, thresh, keep_div):
    return (mode, _ptr(mask), int(seed or 0) & ((1 << 64) - 1), int(offset),
            thresh, float(keep_div))


def _cuda_flash_fwd(q, k, v, bias_k, mode, dims, sm_scale, causal, q_off,
                    k_off, dropout_prob, mask, seed, offset, return_bits,
                    return_probs=False):
    """Launch row 6 on the route ``bhsd_fwd_route`` names.  Returns (o,
    lse, bits, checks): bits the Philox keep bits when ``return_bits``,
    checks on the tensor-core route with ``return_probs`` (p c as the
    kernel rounds it for P.V, bf16 [B, nh, S, S], and its running max
    after each 64-key tile, f32 [B, nh, S, S / 64]), else None."""
    b, nh, s, d = q.shape
    tc = bhsd_fwd_route(q.dtype) == "tc"
    if tc:
        q, k, v = (_aligned(t) for t in (q, k, v))
        bias_k = None if bias_k is None else _aligned(bias_k)
    dmode, mask, thresh, keep_div = _drop_args(dropout_prob, mask, seed)
    bits = None
    if return_bits and dmode == _PHILOX_DROP:
        bits = torch.zeros((b, nh, s, s), dtype=torch.uint8, device=q.device)
    checks = None
    if tc and return_probs:
        checks = (torch.zeros((b, nh, s, s), dtype=q.dtype, device=q.device),
                  torch.full((b, nh, s, s // KERNEL_ROWS), NEG_INF,
                             dtype=torch.float32, device=q.device))
    o = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    fn = _bhsd_launcher("fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        dm, mptr, sd, off, th, kd = _drop_tail(dmode, mask, seed, offset,
                                               thresh, keep_div)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *_bias_args(bias_k, mode, dims, nh), o.data_ptr(),
                 lse.data_ptr(), b * nh, s, d, float(sm_scale), int(causal),
                 int(q_off), int(k_off), _DTYPE_CODES[q.dtype], dm, mptr,
                 _ptr(bits), sd, off, th, kd,
                 *((None, None) if checks is None else map(_ptr, checks)),
                 stream)
    if err:
        raise RuntimeError(f"flash_attention (BHSD) kernel"
                           f"{' (tensor cores)' if tc else ''} launch "
                           f"failed: CUDA error {err}")
    flash_attention.launches += 1
    if tc:
        flash_attention.launches_tc += 1
    return o, lse, bits, checks


def _cuda_flash_bwd_part(part, q, k, v, bias_k, mode, dims, lse, delta, do,
                         sm_scale, causal, q_off, k_off, dropout_prob, mask,
                         seed, offset, want_dbias, return_probs=False):
    """Launch one backward kernel: row 7 (``_FUSED``: dq, dk, dv and the
    key dbias [BH, S]), row 8 (``_DQ``: dq) or row 9 (``_DKV``: dk, dv
    and the full dbias [BH, S, S]), on the route ``bhsd_bwd_route``
    names (bf16: the wgmma kernels).  Row 7 writes its key tiles' shares
    of dq to f32 partials [S / 64, BH, S, D] (S / 32 on the SIMT route at
    D 256) that a second kernel sums in key-tile order.  Returns (dq, dk,
    dv, dbias, checks): with ``return_probs`` on the tensor-core route,
    ``checks`` holds the kernel's rounded intermediates (p c, ds, ds_dq:
    row 9 sets p c and ds, row 8 ds_dq, row 7 all three, its dq taking
    its ds; bf16 [B, nh, S, S]), else None."""
    b, nh, s, d = q.shape
    tc = bhsd_bwd_route(q.dtype, mode) != "simt"
    if tc:
        q, k, v, lse, delta, do = (
            _aligned(t) for t in (q, k, v, lse, delta, do))
        bias_k = None if bias_k is None else _aligned(bias_k)
    dmode, mask, thresh, keep_div = _drop_args(dropout_prob, mask, seed)
    dq = torch.empty_like(q) if part != _DKV else None
    dk, dv = ((torch.empty_like(k), torch.empty_like(v)) if part != _DQ
              else (None, None))
    dq_part = dbias = None
    if part == _FUSED:
        rows = KERNEL_ROWS if d < 256 or tc else KERNEL_ROWS // 2
        dq_part = torch.empty((s // rows, b * nh, s, d), dtype=torch.float32,
                              device=q.device)
        if want_dbias:
            dbias = torch.empty((b * nh, s), dtype=torch.float32,
                                device=q.device)
    elif part == _DKV and want_dbias:
        dbias = torch.empty((b * nh, s, s), dtype=torch.float32,
                            device=q.device)
    probs = (None,) * 3
    if tc and return_probs:
        probs = tuple(
            torch.zeros((b * nh, s, s), dtype=q.dtype, device=q.device)
            if use else None
            for use in (part != _DQ, part != _DQ, part == _DQ))
    fn = _bhsd_launcher("bwd_tc" if tc else "bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(part, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *_bias_args(bias_k, mode, dims, nh), lse.data_ptr(),
                 delta.data_ptr(), do.data_ptr(), _ptr(dq), _ptr(dk),
                 _ptr(dv), _ptr(dq_part), _ptr(dbias), b * nh, s, d,
                 float(sm_scale), int(causal), int(q_off), int(k_off),
                 _DTYPE_CODES[q.dtype],
                 *_drop_tail(dmode, mask, seed, offset, thresh, keep_div),
                 *(map(_ptr, probs) if tc else ()), stream)
    if err:
        raise RuntimeError(f"flash_attention (BHSD) backward kernel "
                           f"{('fused', 'dq', 'dkv')[part]}"
                           f"{' (tensor cores)' if tc else ''} launch "
                           f"failed: CUDA error {err}")
    if tc:
        (flash_attention_bwd_fused, flash_attention_bwd_dq,
         flash_attention_bwd_dkv)[part].launches_tc += 1
    checks = None
    if tc and return_probs:
        if part == _FUSED:
            probs = probs[:2] + probs[1:2]
        checks = tuple(None if t is None else t.reshape(b, nh, s, s)
                       for t in probs)
    return dq, dk, dv, dbias, checks


def flash_attention_bwd_fused(*args, **kwargs):
    """Row 7 on the card: (dq, dk, dv, key dbias [BH, S] or None);
    arguments as ``_cuda_flash_bwd_part``'s after ``part``.
    ``launches_tc`` counts the wgmma kernel's launches (bf16).
    ``return_probs=True`` adds its check outputs in bf16 (p c, ds, ds_dq,
    the last two one tensor), None in f32."""
    out = _cuda_flash_bwd_part(_FUSED, *args, **kwargs)
    flash_attention_bwd_fused.launches += 1
    return out if kwargs.get("return_probs") else out[:4]


def flash_attention_bwd_dq(*args, **kwargs):
    """Row 8 on the card: dq; ``launches_tc`` counts the wgmma kernel's
    launches (bf16).  ``return_probs=True`` adds its check outputs (p c,
    ds, ds_dq: ds_dq set) or None on the SIMT route."""
    out = _cuda_flash_bwd_part(_DQ, *args, **kwargs)
    flash_attention_bwd_dq.launches += 1
    return (out[0], out[4]) if kwargs.get("return_probs") else out[0]


def flash_attention_bwd_dkv(*args, **kwargs):
    """Row 9 on the card: (dk, dv, full dbias [BH, S, S] or None);
    ``launches_tc`` counts the wgmma kernel's launches (bf16).
    ``return_probs=True`` adds its check outputs (p c, ds, ds_dq: p c and
    ds set) or None on the SIMT route."""
    out = _cuda_flash_bwd_part(_DKV, *args, **kwargs)
    flash_attention_bwd_dkv.launches += 1
    return (out[1:4], out[4]) if kwargs.get("return_probs") else out[1:4]


flash_attention_bwd_fused.launches = 0
flash_attention_bwd_fused.launches_tc = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_tc = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_tc = 0


def _fold_dbias(db, mode, dims, nh):
    """The kernels' per-bh dbias summed to the kernel bias's rows: key
    [BH, S] -> [bb, S]; full [BH, S, S] -> [bb * bn, S, S] (the
    reduction of ``_flash_bwd``)."""
    bb, bn = dims
    s = db.shape[-1]
    db = db.reshape(-1, nh, *db.shape[1:])
    if bn == 1:
        db = db.sum(dim=1, keepdim=True)
    if bb == 1:
        db = db.sum(dim=0, keepdim=True)
    return db.reshape(bb, s) if mode == "key" else db.reshape(bb * bn, s, s)


def _cuda_flash_bwd(q, k, v, bias_k, mode, dims, o, lse, do, sm_scale,
                    causal, q_off, k_off, dropout_prob, mask, seed, offset,
                    g_lse, want_dbias, return_probs=False):
    """The backward's dispatch (``_flash_bwd``): the full bias takes the
    split path (rows 8 and 9), everything else the single pass (row 7).
    Returns (dq, dk, dv, f32 dbias in the kernel bias's form or None), and
    with ``return_probs`` the kernels' check outputs in bf16 (p c, ds,
    ds_dq), None in f32."""
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} "
                             f"{q.dtype} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}")
    # delta = rowsum(dO * O) - g_lse, outside the kernels as in _flash_bwd
    delta = (o.float() * do.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta, lse = delta.contiguous(), lse.contiguous()
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, sm_scale, causal,
            q_off, k_off, dropout_prob, mask, seed, offset, want_dbias)
    nh = q.shape[1]
    checks = None
    if mode == "full" and return_probs:
        dq, c_dq = flash_attention_bwd_dq(*args, return_probs=True)
        (dk, dv, db), c_dkv = flash_attention_bwd_dkv(*args,
                                                      return_probs=True)
        if c_dq is not None:  # the tensor-core route
            checks = c_dkv[:2] + c_dq[2:]
    elif mode == "full":
        dq = flash_attention_bwd_dq(*args)
        dk, dv, db = flash_attention_bwd_dkv(*args)
    elif return_probs:
        dq, dk, dv, db, checks = flash_attention_bwd_fused(
            *args, return_probs=True)
    else:
        dq, dk, dv, db = flash_attention_bwd_fused(*args)
    if db is not None:
        db = _fold_dbias(db, mode, dims, nh)
    return (dq, dk, dv, db, checks) if return_probs else (dq, dk, dv, db)


def _device_check(q):
    if q.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")


class _FlashBHSD(torch.autograd.Function):
    """(o, lse) of the BHSD kernels with their backward: the lse
    cotangent folds into delta; the bias gets dbias when ``want_dbias``,
    else a zero cotangent (None, which autograd and the generic grad ops
    read as zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, sm_scale, causal,
                dropout_prob, offset, q_off, k_off, want_dbias):
        ctx.set_materialize_grads(False)
        o, lse = flash_attention_fwd(
            q, k, v, bias, sm_scale, causal, dropout_prob, mask=mask,
            dropout_seed=seed, dropout_offset=offset, q_offset=q_off,
            k_offset=k_off)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.args = (sm_scale, causal, dropout_prob, seed, offset, q_off,
                    k_off, want_dbias)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        sm_scale, causal, p, seed, offset, q_off, k_off, want = ctx.args
        dq, dk, dv, db = flash_attention_bwd(
            q, k, v, bias, o, lse, torch.zeros_like(o) if do is None else do,
            sm_scale, causal, p, mask=mask, dropout_seed=seed,
            dropout_offset=offset, q_offset=q_off, k_offset=k_off,
            g_lse=g_lse, want_dbias=want)
        return (dq, dk, dv, db) + (None,) * 9


def flash_attention_fwd(q, k, v, bias=None, sm_scale=None, causal=False,
                        dropout_prob=0.0, dropout_generator=None, *,
                        mask=None, dropout_seed=None, dropout_offset=0,
                        q_offset=0, k_offset=0, return_bits=False,
                        return_probs=False):
    """Row 6, not differentiable: (o [B, nh, S, D], lse [B, nh, S] f32).
    CPU and meta tensors take the plain version (dropout from ``mask`` or
    drawn from ``dropout_generator``); CUDA tensors launch the kernel
    ``bhsd_fwd_route`` names (``launches_tc`` counts the wgmma kernel's
    launches) or raise (dropout from ``mask``, else Philox from
    ``dropout_seed``).  ``return_bits`` adds the uint8 keep bits the
    Philox drew (None without Philox); ``return_probs`` (CUDA only, a
    check's output) then the wgmma kernel's (p c, running max), None on
    the SIMT route (``_cuda_flash_fwd``)."""
    _device_check(q)
    b, nh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    extra = (return_bits, return_probs)
    if q.device.type != "cuda":
        if dropout_prob > 0.0 and mask is None and q.device.type == "cpu":
            mask = draw_keep_mask_bhsd(q, dropout_prob, dropout_generator)
        out = flash_attention_reference(q, k, v, bias, sm_scale, causal,
                                        dropout_prob, mask, None, q_offset,
                                        k_offset)
        return out + tuple(None for want in extra if want)
    check_bhsd_inputs(q, k, v, bias, dropout_prob, mask)
    bias_k, mode, dims = _classify_bias(bias, b, nh, s)
    o, lse, bits, checks = _cuda_flash_fwd(
        q, k, v, bias_k, mode, dims, sm_scale, causal, q_offset, k_offset,
        dropout_prob, mask, dropout_seed, dropout_offset, return_bits,
        return_probs)
    return (o, lse) + tuple(t for t, want in zip((bits, checks), extra)
                            if want)


def flash_attention_bwd(q, k, v, bias, o, lse, do, sm_scale=None,
                        causal=False, dropout_prob=0.0, *, mask=None,
                        dropout_seed=None, dropout_offset=0, q_offset=0,
                        k_offset=0, g_lse=None, want_dbias=False,
                        return_probs=False):
    """(dq, dk, dv, dbias in the bias's shape or None) of the forward that
    gave o and lse, with the lse cotangent ``g_lse``.  CPU and meta
    tensors take the plain version, which needs the forward's ``mask``
    for dropout; CUDA tensors launch rows 8 and 9 (a full bias) or row 7
    (any other), on the wgmma kernels for bf16 (``bhsd_bwd_route``), or
    raise.  ``return_probs`` (CUDA only, a check's output) appends the
    kernels' rounded intermediates in bf16 (p c and ds of row 9, ds of
    row 8; row 7's p c and its ds twice; each bf16 [B, nh, S, S]), or None
    in f32."""
    _device_check(q)
    b, nh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type != "cuda":
        if dropout_prob > 0.0 and mask is None and q.device.type == "cpu":
            raise ValueError("the plain backward needs the forward's keep "
                             "mask for dropout")
        return flash_attention_bwd_reference(
            q, k, v, bias, o, lse, do, sm_scale, causal,
            mask if dropout_prob > 0.0 else None, 1.0 - dropout_prob,
            q_offset, k_offset, g_lse, want_dbias)
    check_bhsd_inputs(q, k, v, bias, dropout_prob, mask)
    bias_k, mode, dims = _classify_bias(bias, b, nh, s)
    out = _cuda_flash_bwd(
        q, k, v, bias_k, mode, dims, o, lse, do.contiguous(), sm_scale,
        causal, q_offset, k_offset, dropout_prob, mask, dropout_seed,
        dropout_offset, g_lse, want_dbias and mode is not None, return_probs)
    dq, dk, dv, db = out[:4]
    if db is not None:
        db = db.reshape(bias.shape).to(bias.dtype)
    return (dq, dk, dv, db) + out[4:]


def _flash_bhsd(q, k, v, bias, sm_scale, causal, dropout_prob, mask, seed,
                offset, q_off, k_off, want_dbias):
    if q.shape[2] % MIN_BLOCK:
        raise ValueError(f"flash_attention needs seq % {MIN_BLOCK} == 0, "
                         f"got {q.shape[2]}")
    return _FlashBHSD.apply(q, k, v, bias, mask, seed, float(sm_scale),
                            bool(causal), float(dropout_prob), int(offset),
                            int(q_off), int(k_off), bool(want_dbias))


def _dropout_source(q, dropout_prob, generator, seed, mask):
    """(mask, seed) of a training call: the card draws Philox bits from
    the seed (the generator's, when given one); the CPU a keep mask from
    the generator (or from a generator made from the seed)."""
    if dropout_prob <= 0.0 or mask is not None:
        return mask, None
    if q.device.type == "cuda":
        if seed is None:
            if generator is None:
                raise ValueError("dropout needs a mask, a seed or a "
                                 "generator")
            seed = generator.initial_seed()
        return None, int(seed)
    if q.device.type == "cpu":
        if generator is None:
            if seed is None:
                raise ValueError("dropout needs a mask, a seed or a "
                                 "generator")
            generator = torch.Generator(device="cpu")
            generator.manual_seed(int(seed))
        return draw_keep_mask_bhsd(q, dropout_prob, generator), None
    return None, None


def flash_attention(q, k, v, bias=None, sm_scale=None, causal=False,
                    dropout_prob=0.0, dropout_generator=None,
                    bias_requires_grad=False, *, dropout_seed=None,
                    mask=None, dropout_offset=0, mesh=None,
                    batch_axis="dp", head_axis="tp"):
    """Flash attention on [B, nh, S, D] (the JAX package's
    ``flash_attention``; ``mesh``: q, k, v hold this rank's heads, see the
    module note): bias additive, [B|1, 1, 1, S]
    per key or [B|1, nh|1, S, S] full; returns o [B, nh, S, D],
    differentiable in q, k, v, and in the bias when
    ``bias_requires_grad`` (else its cotangent is zero).  Dropout keeps
    where ``mask`` says, else draws: a keep mask from
    ``dropout_generator`` (or ``dropout_seed``) on the CPU, Philox bits
    of its seed on the card."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = 1 if mesh is None else mesh.shape.get(head_axis, 1)
    _, dropout_generator = head_shard(q.shape[1] * n, dropout_generator,
                                      mesh, head_axis)
    mask, seed = _dropout_source(q, dropout_prob, dropout_generator,
                                 dropout_seed, mask)
    return _flash_bhsd(q, k, v, bias, sm_scale, causal, dropout_prob, mask,
                       seed, dropout_offset, 0, 0, bias_requires_grad)[0]


flash_attention.launches = 0
flash_attention.launches_tc = 0


def flash_block_with_lse(q, k, v, key_bias=None, sm_scale=None,
                         bias_requires_grad=True, causal=False,
                         q_offset=None, k_offset=None, dropout_prob=0.0,
                         dropout_seed=None, dropout_mask=None):
    """One attention block of ring attention (the JAX package's
    ``flash_block_with_lse``): q, k, v [B, nh, S, D], key_bias [B, S]
    additive per key.  Returns (o [B, nh, S, D], lse [B, nh, S]), both
    differentiable (the lse cotangent folds into delta).  causal with
    (q_offset, k_offset): the global positions of the q rows and of the k
    block.  Dropout from ``dropout_mask`` [B, nh, S, S] uint8, else from
    ``dropout_seed`` (Philox on the card, a keep mask drawn from it on
    the CPU).  dbias is computed by default."""
    b, nh, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bias = None if key_bias is None else key_bias.reshape(b, 1, 1, s)
    q_off = int(q_offset or 0) if causal else 0
    k_off = int(k_offset or 0) if causal else 0
    if dropout_prob > 0.0 and dropout_mask is None and dropout_seed is None:
        raise ValueError("dropout needs dropout_seed or dropout_mask")
    mask, seed = _dropout_source(q, dropout_prob, None, dropout_seed,
                                 dropout_mask)
    return _flash_bhsd(q, k, v, bias, sm_scale, causal, dropout_prob, mask,
                       seed, 0, q_off, k_off, bias_requires_grad)


def _visible_pairs(s, causal, q_off=0, k_off=0) -> int:
    """(query, key) pairs a head computes: S * S, or under causal those
    with k_off + j <= q_off + i."""
    if not causal:
        return s * s
    return sum(min(max(q_off + i - k_off + 1, 0), s) for i in range(s))


_BWD_FLOPS = {"fwd": 4, "fused": 10, "dq": 6, "dkv": 8}


def bound_flops_bhsd(q, part="fwd", causal=False, q_offset=0,
                     k_offset=0) -> int:
    """Flops of one kernel, 2 a multiply-add over D per visible pair and
    product: the forward's two products (4 D), row 7's five (10 D), row
    8's three (s, dp, dq: 6 D), row 9's four (s, dp, dv, dk: 8 D)."""
    b, nh, s, d = q.shape
    return (_BWD_FLOPS[part] * b * nh * d
            * _visible_pairs(s, causal, q_offset, k_offset))


def _bias_bytes(q, bias):
    if bias is None:
        return 0
    b, nh, s, _ = q.shape
    bias_k, mode, _ = _classify_bias(bias, b, nh, s)
    return bias_k.numel() * (4 if mode == "key" else bias.element_size())


def bound_bytes_bhsd(q, bias=None, part="fwd", mask=None,
                     want_dbias=False) -> int:
    """Bytes one kernel must move, each input read once and each output
    written once: the forward reads q, k, v, the bias (as the kernel
    holds it: [bb, S] f32 or [R, S, S]) and the mask, and writes o and
    the f32 lse; each backward kernel reads q, k, v, dO, lse, delta, the
    bias and the mask, and writes its outputs (row 7 dq, dk, dv and the
    key dbias [BH, S] f32; row 8 dq; row 9 dk, dv and the full dbias
    [BH, S, S] f32).  Row 7's f32 dq partials are scratch, not counted."""
    b, nh, s, _ = q.shape
    act = q.numel() * q.element_size()
    stat = b * nh * s * 4
    extra = _bias_bytes(q, bias) + (0 if mask is None else mask.numel())
    if part == "fwd":
        return 4 * act + stat + extra
    reads = 4 * act + 2 * stat + extra
    if part == "fused":
        return reads + 3 * act + (stat if want_dbias else 0)
    if part == "dq":
        return reads + act
    return reads + 2 * act + (b * nh * s * s * 4 if want_dbias else 0)
