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
  kernel ``ops/kernels/flash_attention.py`` (its plain version on the
  CPU).
* BHSD — a square full bias ([B, nh, S, S] and the like) the BSH kernel
  cannot hold: the JAX package runs its BHSD Pallas kernel there, which
  is not ported yet (ROADMAP §B row 6).  On the card it raises
  NotImplementedError; on the CPU the plain composition computes it.
* composition — every shape the flash gates reject (and
  FLAGS_use_flash_attention off): ``_reference_attention`` in torch, as
  the reference does.

The ring-attention branch (sequence parallel over a mesh) waits for the
distributed slice.
"""
from __future__ import annotations

import math

import torch

from .kernels.flash_attention import (bsh_dispatch_ok, flash_attention_bsh,
                                      flash_shapes_ok)
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


@register("fused_multihead_attention")
def fused_multihead_attention(ctx, ins, attrs):
    q3, k3, v3 = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins.get("BiasQK", [None])[0]
    nh = int(attrs["num_heads"])
    dropout_prob = float(attrs.get("dropout_prob", 0.0))
    is_test = bool(attrs.get("is_test", False))
    causal = bool(attrs.get("causal", False))
    train_dropout = not is_test and dropout_prob > 0.0

    sq, skv, h = q3.shape[1], k3.shape[1], q3.shape[2]
    if bsh_dispatch_ok(sq, skv, h, nh, bias=bias, batch=q3.shape[0],
                       causal=causal):
        gen = (ctx.salted_rng(int(attrs.get("rng_salt", 0)))
               if train_dropout else None)
        out = flash_attention_bsh(
            q3, k3, v3, bias, num_heads=nh, causal=causal,
            dropout_prob=dropout_prob if train_dropout else 0.0,
            dropout_generator=gen)
        return {"Out": [out]}

    if flash_shapes_ok(sq, h // nh) and sq == skv \
            and q3.device.type == "cuda":
        raise NotImplementedError(
            "fused_multihead_attention: this bias shape "
            f"{None if bias is None else tuple(bias.shape)} needs the BHSD "
            "flash kernel, which the port does not have yet (ROADMAP §B "
            "row 6, ops/pallas/flash_attention.py:392)")

    q, k, v = (_split_heads(t, nh) for t in (q3, k3, v3))
    if causal:
        s = q.shape[2]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        cmask = torch.where(keep, 0.0, -1e30)[None, None]
        bias = cmask if bias is None else bias + cmask
    gen = (ctx.salted_rng(int(attrs.get("rng_salt", 0)))
           if train_dropout else None)
    out = _reference_attention(q, k, v, bias, dropout_prob, is_test, gen)
    return {"Out": [_merge_heads(out)]}
