"""Fused multi-head attention op.

Ported from the JAX package's ``ops/attention.py``: attention is a
first-class op (the reference reaches it through its
multihead_matmul_fuse_pass).  Q, K, V are [B, S, H] (head-interleaved);
BiasQK is an additive mask broadcastable to [B, nh, S, S]; Out is
[B, S, H].

Branches, taken on every device alike (the gates read shapes and flags,
never the device):

* BSH — ``bsh_dispatch_ok``: no bias or a per-key [B, 1, 1, Skv] bias,
  D in {64, 128, 256}, lengths multiples of 128.  The flash-attention
  kernels ``ops/kernels/flash_attention.py`` (their plain versions on the
  CPU), differentiable, with the dropout drawn from the op's salted
  generator (Philox in the kernel on the card).
* BHSD — any other bias (a square full [B|1, nh|1, S, S] one, a per-key
  bias shared over the batch) or other flag/shape cases where
  ``flash_shapes_ok`` holds and Sq == Skv: ``flash_attention`` of the
  same module on head-split [B, nh, S, D] tensors (the BHSD kernels, rows
  6-9; their plain versions on the CPU).
* composition — every shape the flash gates reject (and
  FLAGS_use_flash_attention off): ``_reference_attention`` in torch, as
  the reference does.

* ring — ``sequence_parallel`` under a mesh whose "sp" axis has more
  than one rank (``parallel.ring_attention.use_ring``): Q, K and V arrive
  whole on every sp rank (one process per rank; the JAX package's GSPMD
  holds them as global arrays); the op takes this rank's sequence block
  of each (``distributed.shard_slice``), runs ``ring_attention`` over
  "sp" with the [B, 1, 1, S] bias as per-key rows, and all-gathers the
  result.  The probs dropout runs inside the ring.

* head — under a ``tp_region`` attr (``fleet.apply_tensor_parallel_rules``)
  and a mesh whose "tp" axis has n > 1 ranks, Q, K and V are this
  rank's column blocks from column-parallel projections, nh / n heads:
  every branch above runs on those local heads through the flash
  kernels' mesh form (``flash_attention_bsh(mesh=)``,
  ``flash_attention(mesh=)``, ``head_shard``), whose dropout seed is
  salted by the head shard, and Out is the rank's column block.

BiasQK gets a zero cotangent on every branch but the ring, as in the
reference: the kernels return none, and the composition detaches the
bias.  The ring differentiates its key bias, as the JAX package's does.
"""
from __future__ import annotations

import math

import torch

from .kernels.flash_attention import (bsh_dispatch_ok, flash_attention,
                                      flash_attention_bsh, flash_shapes_ok,
                                      head_shard)
from .. import distributed as dist
from ..parallel import tp_mesh
from ..parallel.ring_attention import (key_bias_from_attn_bias,
                                       ring_attention, use_ring)
from .registry import register


def _split_heads(x, num_heads):
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, nh, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * dh)


def _reference_attention(q, k, v, bias, dropout_prob, deterministic,
                         generator):
    """torch composition: [B, nh, S, dh] in, [B, nh, S, dh] out."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(dh))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if not deterministic and dropout_prob > 0.0 and q.device.type != "meta":
        keep = torch.rand(probs.shape, generator=generator,
                          device=q.device) < 1.0 - dropout_prob
        probs = torch.where(keep, probs / (1.0 - dropout_prob), 0.0).to(
            q.dtype)
    return torch.matmul(probs, v)


def _head_block(bias, nh, mesh):
    """This rank's heads of a bias with a head dim of nh (a full
    [B, nh, S, S] one); a bias shared over the heads as it is."""
    if bias is None or bias.dim() != 4 or bias.shape[1] != nh:
        return bias
    n, i = mesh.shape["tp"], mesh.coords["tp"]
    return bias[:, i * (nh // n):(i + 1) * (nh // n)]


@register("fused_multihead_attention")
def fused_multihead_attention(ctx, ins, attrs):
    q3, k3, v3 = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins.get("BiasQK", [None])[0]
    nh = int(attrs["num_heads"])
    dropout_prob = float(attrs.get("dropout_prob", 0.0))
    is_test = bool(attrs.get("is_test", False))
    causal = bool(attrs.get("causal", False))
    train_dropout = not is_test and dropout_prob > 0.0

    if use_ring(ctx, attrs):
        mesh = ctx.mesh
        key_bias = key_bias_from_attn_bias(bias, q3.shape[0])
        ql, kl, vl = (dist.shard_slice(_split_heads(t, nh), "sp", 2, mesh)
                      for t in (q3, k3, v3))
        bl = (None if key_bias is None
              else dist.shard_slice(key_bias, "sp", 1, mesh))
        seed = (ctx.salted_seed(int(attrs.get("rng_salt", 0)))
                if train_dropout and q3.device.type != "meta" else None)
        out = ring_attention(ql, kl, vl, "sp", bl, None, causal,
                             dropout_prob if train_dropout else 0.0, seed,
                             mesh=mesh)
        return {"Out": [_merge_heads(dist.all_gather(out, "sp", 2, mesh))]}

    sq, skv, h = q3.shape[1], k3.shape[1], q3.shape[2]
    gen = (ctx.salted_rng(int(attrs.get("rng_salt", 0)))
           if train_dropout else None)
    mesh = tp_mesh(ctx, attrs)      # the head region: this rank's heads
    if mesh is not None:
        bias = _head_block(bias, nh, mesh)
    heads, local_gen = head_shard(nh, gen, mesh)
    if bsh_dispatch_ok(sq, skv, h, heads, bias=bias, batch=q3.shape[0],
                       causal=causal):
        out = flash_attention_bsh(
            q3, k3, v3, bias, num_heads=nh, causal=causal,
            dropout_prob=dropout_prob if train_dropout else 0.0,
            dropout_generator=gen, mesh=mesh)
        return {"Out": [out]}

    q, k, v = (_split_heads(t, heads) for t in (q3, k3, v3))
    if flash_shapes_ok(sq, h // heads) and sq == skv:
        # full [.., S, S] biases (and per-key ones shared over the batch)
        # on square lengths ride the BHSD kernels; BiasQK keeps its zero
        # cotangent (bias_requires_grad=False)
        out = flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            None if bias is None else bias.contiguous(),
            causal=causal, dropout_prob=dropout_prob if train_dropout
            else 0.0, dropout_generator=gen, mesh=mesh)
        return {"Out": [_merge_heads(out)]}
    gen = local_gen
    if causal:
        s = q.shape[2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        cmask = torch.where(keep, 0.0, -1e30)[None, None]
        bias = cmask if bias is None else bias + cmask
    if bias is not None:
        bias = bias.detach()  # the zero-cotangent BiasQK contract
    out = _reference_attention(q, k, v, bias, dropout_prob, is_test, gen)
    return {"Out": [_merge_heads(out)]}
