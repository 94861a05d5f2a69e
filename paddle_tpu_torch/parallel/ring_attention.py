"""Ring attention: sequence parallelism over a mesh axis.

Ported from the JAX package's ``parallel/ring_attention.py``.  Each rank
of the "sp" axis holds a contiguous sequence block of Q, K and V and
passes its K/V block (and the per-key bias block) around the ring with
``distributed.send_recv`` (the lax.ppermute of the JAX file), merging
the partial results as it goes; peak memory a rank is O(S_local * D).

Two block computations, chosen by ``flash_block_ok(S_local, D)`` as the
JAX package chooses them:

* the flash block (``_ring_flash``): each visiting block is
  ``flash_block_with_lse`` (rows 6 and 7 of PERF.md's kernel table on the
  card: one forward launch a ring step, one backward launch a step in the
  backward), merged by log-sum-exp.  A row that sees no key of a block
  (causal, a block wholly in its future) comes back with lse = NEG_INF
  (-1e30, not -inf) and o = 0, so the merge stays finite;
* the online softmax in torch (f32 scores, the running max, row sum and
  accumulator), for every other shape.

Causal masking uses global positions: this rank's queries start at
idx * S_local and the visiting block's keys at src * S_local.  Dropout
acts on the numerator only (post-softmax dropout); each (rank, source
block) pair draws from its own seed, ``block_seed``, as the JAX file
folds (shard, source) into its key.

Autograd: the loop is plain torch ops over differentiable collectives,
so the backward is derived as JAX derives its scan's: each K/V rotation's
cotangent travels the inverse permutation, and the flash block's
backward folds the lse cotangent into delta.  Every rank runs the same
graph, so the backward's sends and receives pair up in the same order.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
_MASK63 = (1 << 63) - 1


def block_seed(seed: int, idx: int, src: int) -> int:
    """The dropout seed of (this rank ``idx``, source block ``src``): the
    JAX file's seed_base + idx * 0x632BE59B + src * 0x1B873593."""
    return (int(seed) + idx * 0x632BE59B + src * 0x1B873593) & _MASK63


def _rotate(ts, ax, perm):
    from .. import distributed as dist_api

    return tuple(None if t is None else
                 dist_api._PPermute.apply(t, perm, ax) for t in ts)


def ring_attention(q, k, v, axis_name: str = "sp", bias=None, sm_scale=None,
                   causal: bool = False, dropout_prob: float = 0.0,
                   dropout_seed: Optional[int] = None, *, mesh=None):
    """The per-rank ring body.

    q, k, v: [B, nh, S_local, D], this rank's sequence block.
    bias: optional per-key additive bias [B, S_local] (the padding mask's
        block), rotated with K/V.
    dropout_prob / dropout_seed: attention-probs dropout, the numerator
        masked, the normalizer not.
    mesh: the Mesh whose ``axis_name`` is the ring (default: the bound
        one).  Returns [B, nh, S_local, D]."""
    from .. import distributed as dist_api
    from ..ops.kernels.flash_attention import flash_block_ok

    ax = dist_api._axis(axis_name, mesh)
    n, idx = ax.size, ax.index
    b, nh, s_loc, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    use_dropout = dropout_prob > 0.0 and dropout_seed is not None
    p = dropout_prob if use_dropout else 0.0
    perm = [(i, (i + 1) % n) for i in range(n)]
    if flash_block_ok(s_loc, d):
        return _ring_flash(q, k, v, ax, bias, sm_scale, n, idx, perm,
                           causal, p, dropout_seed)

    dev = q.device
    qf = q.float() * sm_scale
    kb, vb, bb = k, v, bias
    m = torch.full((b, nh, s_loc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, nh, s_loc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nh, s_loc, d), dtype=torch.float32, device=dev)
    for t in range(n):
        src = (idx - t) % n              # whose block this rank holds
        s = torch.matmul(qf, kb.float().transpose(-1, -2))
        if bb is not None:
            s = s + bb.float()[:, None, None, :]
        if causal:
            qpos = idx * s_loc + torch.arange(s_loc, device=dev)
            kpos = src * s_loc + torch.arange(s_loc, device=dev)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # a fully masked row keeps m_new = NEG_INF and exp(s - m_new) = 1:
        # the re-mask zeroes it
        pr = torch.exp(s - m_new)
        if causal:
            pr = torch.where(mask, pr, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + pr.sum(dim=-1, keepdim=True)
        p_num = pr
        if p > 0.0 and dev.type != "meta":
            g = torch.Generator(device=dev)
            g.manual_seed(block_seed(dropout_seed, idx, src))
            keep = torch.rand(pr.shape, generator=g, device=dev) < 1.0 - p
            p_num = torch.where(keep, pr / (1.0 - p), 0.0)
        acc = acc * alpha + torch.matmul(p_num, vb.float())
        m = m_new
        if t < n - 1:
            kb, vb, bb = _rotate((kb, vb, bb), ax, perm)
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def _ring_flash(q, k, v, ax, bias, sm_scale, n, idx, perm, causal, p,
                seed):
    """Each visiting block through ``flash_block_with_lse``, the (o, lse)
    partials merged by log-sum-exp; the key bias gets its gradient."""
    from ..ops.kernels.flash_attention import flash_block_with_lse

    b, nh, s_loc, d = q.shape
    dev = q.device
    q = q.contiguous()
    kb, vb = k.contiguous(), v.contiguous()
    bb = None if bias is None else bias.contiguous()
    m = torch.full((b, nh, s_loc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, nh, s_loc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nh, s_loc, d), dtype=torch.float32, device=dev)
    for t in range(n):
        src = (idx - t) % n
        kw = {}
        if causal:
            kw = dict(causal=True, q_offset=idx * s_loc,
                      k_offset=src * s_loc)
        if p > 0.0:
            kw.update(dropout_prob=p,
                      dropout_seed=block_seed(seed, idx, src))
        o_b, lse_b = flash_block_with_lse(q, kb, vb, bb, sm_scale, **kw)
        lse_b = lse_b.unsqueeze(-1)
        m_new = torch.maximum(m, lse_b)
        scale_old = torch.exp(m - m_new)
        scale_new = torch.exp(lse_b - m_new)
        acc = acc * scale_old + o_b.float() * scale_new
        l = l * scale_old + scale_new
        m = m_new
        if t < n - 1:
            kb, vb, bb = _rotate((kb, vb, bb), ax, perm)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention_global(q, k, v, mesh, axis: str = "sp", bias=None,
                          sm_scale=None, causal: bool = False,
                          batch_axis: Optional[str] = "dp",
                          dropout_prob: float = 0.0,
                          dropout_seed: Optional[int] = None):
    """Global-tensor entry: q, k, v [B, nh, S, D] and bias [B, S] whole on
    every rank; each rank takes its block of the sequence over ``axis``
    (and of the batch over ``batch_axis`` when the mesh has it), runs the
    ring body, and the result is gathered back to [B, nh, S, D]."""
    from ..distributed import collective
    from . import PartitionSpec as P

    ba = batch_axis if (batch_axis and batch_axis in mesh.axis_names) \
        else None
    qkv_spec = P(ba, None, axis, None)
    bias_spec = P(ba, axis)

    def body(ql, kl, vl, bl=None):
        return ring_attention(ql, kl, vl, axis, bl, sm_scale, causal,
                              dropout_prob, dropout_seed, mesh=mesh)

    if bias is None:
        return collective(body, mesh, (qkv_spec,) * 3, qkv_spec)(q, k, v)
    return collective(body, mesh, (qkv_spec,) * 3 + (bias_spec,),
                      qkv_spec)(q, k, v, bias)


def use_ring(ctx, attrs) -> bool:
    """The op asked for sequence parallelism AND the emit mesh has an
    "sp" axis of more than one rank."""
    mesh = getattr(ctx, "mesh", None)
    return (
        bool(attrs.get("sequence_parallel", False))
        and mesh is not None
        and "sp" in mesh.axis_names
        and mesh.shape["sp"] > 1
    )


def key_bias_from_attn_bias(bias, batch):
    """An additive attention bias as the per-key [B, S] rows the ring
    rotates.  Only [B, 1, 1, S] (a padding mask) qualifies."""
    if bias is None:
        return None
    if bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
        return bias.reshape(batch, bias.shape[-1])
    raise ValueError(
        "sequence-parallel ring attention supports per-key bias [B,1,1,S] "
        f"(padding mask); got bias shape {tuple(bias.shape)}")
