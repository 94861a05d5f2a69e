"""Fused transformer encoder stack over stacked [L, ...] layer params.

Ported from the JAX package's ``ops/encoder_stack.py``
(``fused_encoder_stack``): one op holds every encoder layer, its
parameters stacked on a leading layer axis.  The JAX package scans one
compiled layer body over that axis; PyTorch runs eagerly, so here the
body is a Python loop over the L slices (``unbind``), and autograd flows
back into the stacked [L, ...] tensors.

Per layer (post-LN, as the reference's BERT):

    q, k, v  = split(hid @ QKVW + QKVB)
    ctx      = attention(q, k, v, AttnBias)     (dropout attn_dropout_prob)
    hid      = add_ln(hid, dropout(ctx @ OutW + OutB), Ln1S, Ln1B)
    hid      = add_ln(hid, dropout(act(hid @ FfnW1 + FfnB1) @ FfnW2 + FfnB2),
                      Ln2S, Ln2B)

Attention branches, as in the JAX package: BSH (``bsh_dispatch_ok``: the
flash kernels of ``ops/kernels/flash_attention.py`` on the [B, S, H]
projections, no head transposes); BHSD (flash-able lengths with a bias
the BSH kernel cannot hold, such as the reference Transformer's full
[B, nh, S, S] self-attention bias: ``flash_attention`` of the same
module on head-split q, k, v, the BHSD kernels); and the composition
(f32 scores, softmax, ``_cheap_dropout``).  ``add_ln`` is the fused
LayerNorm kernel (``ops/kernels/add_ln.py``, differentiable) under
FLAGS_use_fused_ln, else ``_ln_f32(x + y)``.

``fused_decoder_stack`` (the JAX package's, in this module too) is the
NMT decoder over stacked [L, ...] parameters, one Python loop: causal
self-attention, cross-attention over the encoder output (rectangular,
St x Ss) and the FFN, post-LN.  Both attentions take the BSH kernels
when ``bsh_dispatch_ok`` holds (causal self-attention with no bias; the
cross-attention with a per-key [B, 1, 1, Ss] source bias), else the
composition, a full cross bias included: the JAX decoder stack has no
BHSD branch, nor does this one.

Randomness: the op's salted seed (``EmitContext.salted_seed``) mixed
with the layer index gives each layer its seed, and each dropout site of
the layer its own generator created from that seed where it draws, so a
checkpointed layer, FFN or projection draws the same bits when it is
recomputed.  The attention's dropout draws through the flash path
(Philox in the kernel on the card, a keep mask on the CPU).

Remat: ``remat_ffn``, ``remat_qkv`` and ``remat_layer`` wrap the FFN, the
q/k/v projection or the whole layer in ``torch.utils.checkpoint``
(non-reentrant).  ``remat_policy`` is the JAX package's checkpoint-name
policy: comma-separated tags (``_policy_names``; "flash" is shorthand for
``flash_o`` and ``flash_lse``).  A policy switches the three flags off and
checkpoints each whole layer, keeping only what it names.  The flash
kernels launch outside torch's dispatcher, where selective-checkpoint
contexts cannot see them, so the policy lives in the layer body: on the
BSH branch, with both ``flash_o`` and ``flash_lse`` named, the layer's
first pass stashes the forward's o and lse (``_FlashStash``), and the
recompute hands them to ``flash_attention_bsh(saved=...)``, which launches
no forward and saves the same tensors as the first pass did, so the
checkpoint's saved-tensor check holds.  The attention forward then runs
once a layer, its backward gets q, k and v recomputed.  ``attn_out``,
``ln1_out`` and ``ffn_inter`` are accepted and keep nothing: their
producers run in the recompute anyway, to rebuild the autograd nodes that
the backward needs.  The BHSD and composition branches recompute their
attention too.  The decoder stack takes ``remat_ffn`` (the JAX package's
only remat there).  Not ported: the GPipe pipeline (``pipeline``), which
raises NotImplementedError (ROADMAP A4, the next slice: GPipe and
pp x sp).

Sequence parallelism (``sequence_parallel`` under a mesh whose "sp" axis
has more than one rank, ``parallel.ring_attention.use_ring``).  The JAX
package runs the ring inside a shard_map per layer and lets GSPMD keep
the activations sequence-sharded between; the port runs one process per
rank, and the region is the whole stack: the hidden state and the
per-key bias enter whole on every sp rank and are sliced to this rank's
token block once (``distributed.shard_slice``: the backward all-gathers
their cotangents), every layer runs on the local tokens with
``ring_attention`` over "sp" for its attention, and the output is
all-gathered once at exit (its backward keeps this rank's block).  Every
other op of a layer is token-local, so the values are the JAX package's.
Each weight (and the decoder's encoder output and source bias, read
whole by every rank) passes through ``distributed.sp_identity``, whose
backward sums its cotangent over "sp": every parameter gradient is whole
on each sp rank.  The decoder's causal self-attention is the causal ring
over trg shards (global positions as q/k offsets); its cross-attention is
the composition of the local queries over the whole encoder output, as
the JAX package keeps jnp there.  Dropout inside the region mixes the sp
index into the layer seeds, and the ring seeds each (rank, source block)
pair (``ring_attention.block_seed``).

Encoder slots (all stacked on dim 0 = layer):
  Hidden [B,S,H], AttnBias [B,1,1,S],
  QKVW [L,H,3H], QKVB [L,3H], OutW [L,H,H], OutB [L,H],
  Ln1S/Ln1B [L,H], FfnW1 [L,H,F], FfnB1 [L,F], FfnW2 [L,F,H], FfnB2 [L,H],
  Ln2S/Ln2B [L,H]
Decoder slots: ``_DEC_PARAM_KEYS``; inputs Hidden [B,St,H], EncOut
[B,Ss,H], SrcBias [B,1,1,Ss].
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import distributed as dist
from ..parallel.ring_attention import (key_bias_from_attn_bias,
                                       ring_attention, use_ring)
from .kernels import add_ln as _add_ln_kernel
from .kernels.flash_attention import (bsh_dispatch_ok, flash_attention,
                                      flash_attention_bsh, flash_shapes_ok)
from .registry import mix_seed, register

_PARAM_KEYS = (
    "QKVW", "QKVB", "OutW", "OutB", "Ln1S", "Ln1B",
    "FfnW1", "FfnB1", "FfnW2", "FfnB2", "Ln2S", "Ln2B",
)

# the three dropout sites of a layer (the JAX package's k1, k2, k3)
_ATTN, _ATTN_OUT, _FFN = 1, 2, 3


def _act(name):
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
        "relu": F.relu,
        "tanh": torch.tanh,
        "silu": F.silu,
    }[name]


def _ln_f32(x, scale, shift, eps):
    """LayerNorm with f32 statistics regardless of compute dtype (bf16
    under AMP)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + shift.float()
    return y.to(x.dtype)


def _add_ln(x, y, scale, shift, eps):
    """LayerNorm(x + y): the fused kernel (its plain version on the CPU)
    under FLAGS_use_fused_ln, else the f32-statistics composition."""
    from ..fluid.flags import flag

    if flag("FLAGS_use_fused_ln"):
        return _add_ln_kernel.fused_add_ln(x, y, scale, shift, eps)
    return _ln_f32(x + y, scale, shift, eps)


def _generator(seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _cheap_dropout(x, prob, seed):
    """uint8 random bits (the JAX package's: 4x less generator traffic
    than 32-bit uniforms).  The threshold is quantized to 1/256, so kept
    values divide by the EFFECTIVE keep probability to stay unbiased."""
    thresh = max(1, min(255, round((1.0 - prob) * 256)))
    keep_eff = thresh / 256.0
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                         generator=_generator(seed, x.device),
                         device=x.device)
    return torch.where(bits < thresh, x / keep_eff, 0.0)


def _ckpt(fn, *args):
    # the generators are made inside fn from integer seeds, so the
    # recompute draws the same bits without the global RNG state
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _composition(q, k, v, bias, causal, dropout):
    """Attention on head-split [B, nh, S, dh] tensors as the JAX
    package's composition: f32 scores / sqrt(dh) plus the bias, the causal
    mask (-1e30 above the diagonal, top-left aligned), softmax in the
    dtype, ``dropout`` on the probabilities."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        qlen, klen = scores.shape[-2:]
        keep = (torch.arange(qlen, device=q.device)[:, None]
                >= torch.arange(klen, device=q.device)[None, :])
        scores = torch.where(keep, scores, -1e30)
    probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype))
    return torch.matmul(probs, v)


def _policy_names(spec):
    """Parse a remat_policy attr: comma-separated checkpoint-name tags,
    with the shorthand 'flash' -> the kernel's saved residuals (o, lse).
    Tags of the layer body: flash_o, flash_lse, attn_out, ln1_out,
    ffn_inter."""
    names = []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "flash":
            names += ["flash_o", "flash_lse"]
        else:
            names.append(tok)
    return tuple(dict.fromkeys(names))


class _FlashStash:
    """A policy-checkpointed layer's (o, lse) of the BSH flash forward:
    filled by the layer's first pass, read by its recompute."""

    def __init__(self):
        self.saved = None


def _refuse_unported(attrs):
    if attrs.get("pipeline", False):
        raise NotImplementedError(
            "fused_encoder_stack pipeline: the GPipe branch (and pp x sp) "
            "is not ported yet (ROADMAP A4, the next slice: GPipe and "
            "pp x sp)")


def _sp_region(ctx, what, length):
    """(mesh, sp size, sp index) of a stack's sequence-parallel region,
    refusing a length the ring cannot split."""
    mesh = ctx.mesh
    n = mesh.shape["sp"]
    if length % n:
        raise ValueError(f"{what} sequence_parallel: the ring needs the "
                         f"length {length} divisible by sp = {n}")
    return mesh, n, mesh.coords["sp"]


@register("fused_encoder_stack")
def fused_encoder_stack(ctx, ins, attrs):
    _refuse_unported(attrs)
    hidden = ins["Hidden"][0]
    bias = ins.get("AttnBias", [None])[0]
    nh = int(attrs["num_heads"])
    act = _act(attrs.get("act", "gelu"))
    dropout_prob = float(attrs.get("dropout_prob", 0.0))
    attn_dropout_prob = float(attrs.get("attn_dropout_prob", 0.0))
    is_test = bool(attrs.get("is_test", False))
    eps = float(attrs.get("epsilon", 1e-5))
    use_flash = bool(attrs.get("use_flash_attention", True))
    base_seed = ctx.salted_seed(int(attrs.get("rng_salt", 0)))
    shape_only = hidden.device.type == "meta"
    stacked = [ins[k][0] for k in _PARAM_KEYS]
    ring = use_ring(ctx, attrs)
    if ring:
        # the sp region: this rank's token block in, the whole sequence out
        mesh, _, sp_idx = _sp_region(ctx, "fused_encoder_stack",
                                     hidden.shape[1])
        key_bias = key_bias_from_attn_bias(bias, hidden.shape[0])
        hidden = dist.shard_slice(hidden, "sp", 1, mesh)
        bias = (None if key_bias is None
                else dist.shard_slice(key_bias, "sp", 1, mesh))
        stacked = [dist.sp_identity(t, "sp", mesh) for t in stacked]
        base_seed = mix_seed(base_seed, sp_idx)
    remat_policy = _policy_names(attrs.get("remat_policy", ""))
    if remat_policy:
        # the policy checkpoints the whole layer; the blanket flags would
        # recompute what it keeps, so they are mutually exclusive
        attrs = dict(attrs, remat_ffn=False, remat_qkv=False,
                     remat_layer=False)
    keep_flash = {"flash_o", "flash_lse"} <= set(remat_policy)

    def dropout(x, prob, seed):
        if is_test or prob <= 0.0 or shape_only:
            return x
        return _cheap_dropout(x, prob, seed)

    def layer(hid, idx, *params, stash=None):
        p = dict(zip(_PARAM_KEYS, params))
        b, s, h = hid.shape
        dh = h // nh
        lseed = mix_seed(base_seed, idx)

        def seed_of(site):
            return mix_seed(lseed, site)

        use_bsh = (not ring and use_flash
                   and bsh_dispatch_ok(s, s, h, nh, bias=bias, batch=b))

        def project_qkv_flat(hid_, w, bias_):
            qkv = torch.matmul(hid_, w) + bias_
            return tuple(t.contiguous() for t in qkv.split(h, dim=-1))

        def project_qkv(hid_, w, bias_):
            return tuple(t.reshape(b, s, nh, dh).transpose(1, 2)
                         for t in project_qkv_flat(hid_, w, bias_))

        qkv_flat, qkv_heads = project_qkv_flat, project_qkv
        if attrs.get("remat_qkv", False):
            # recompute the q/k/v projections in the backward instead of
            # keeping three [B, S, H] tensors a layer
            qkv_flat = functools.partial(_ckpt, project_qkv_flat)
            qkv_heads = functools.partial(_ckpt, project_qkv)

        attn_p = 0.0 if is_test else attn_dropout_prob
        if ring:
            # the ring over "sp" on this rank's tokens; bias is the key
            # bias block [B, S_local]
            q, k, v = qkv_heads(hid, p["QKVW"], p["QKVB"])
            ctx_l = ring_attention(
                q, k, v, "sp", bias, None, False, attn_p,
                seed_of(_ATTN) if attn_p > 0.0 and not shape_only else None,
                mesh=mesh)
            ctx_l = ctx_l.transpose(1, 2).reshape(b, s, h)
        elif use_bsh:
            q, k, v = qkv_flat(hid, p["QKVW"], p["QKVB"])
            gen = (_generator(seed_of(_ATTN), hid.device)
                   if attn_p > 0.0 and not shape_only else None)
            attend = functools.partial(
                flash_attention_bsh, q, k, v, bias, num_heads=nh,
                dropout_prob=attn_p, dropout_generator=gen)
            if stash is None:
                ctx_l = attend()
            elif stash.saved is None:           # the policy's first pass
                ctx_l, lse = attend(return_lse=True)
                stash.saved = (ctx_l.detach(), lse)
            else:                               # its recompute
                ctx_l = attend(saved=stash.saved)
        elif use_flash and flash_shapes_ok(s, dh):
            # streamed BHSD kernels: the biases BSH cannot hold, such as
            # a full [B, nh, S, S] one
            q, k, v = (t.contiguous()
                       for t in qkv_heads(hid, p["QKVW"], p["QKVB"]))
            gen = (_generator(seed_of(_ATTN), hid.device)
                   if attn_p > 0.0 and not shape_only else None)
            ctx_l = flash_attention(
                q, k, v, None if bias is None else bias.contiguous(),
                dropout_prob=attn_p, dropout_generator=gen)
            ctx_l = ctx_l.transpose(1, 2).reshape(b, s, h)
        else:
            q, k, v = qkv_heads(hid, p["QKVW"], p["QKVB"])
            ctx_l = _composition(
                q, k, v, bias, False,
                lambda pr: dropout(pr, attn_p, seed_of(_ATTN)))
            ctx_l = ctx_l.transpose(1, 2).reshape(b, s, h)

        attn_out = torch.matmul(ctx_l, p["OutW"]) + p["OutB"]
        attn_out = dropout(attn_out, dropout_prob, seed_of(_ATTN_OUT))
        hid = _add_ln(hid, attn_out, p["Ln1S"], p["Ln1B"], eps)

        def ffn(h_, w1, b1, w2, b2):
            inter = act(torch.matmul(h_, w1) + b1)
            out_ = torch.matmul(inter, w2) + b2
            return dropout(out_, dropout_prob, seed_of(_FFN))

        ffn_args = (hid, p["FfnW1"], p["FfnB1"], p["FfnW2"], p["FfnB2"])
        if attrs.get("remat_ffn", False):
            # recompute `inter` ([B, S, F], the largest activation) in the
            # backward instead of keeping it
            ffn_out = _ckpt(ffn, *ffn_args)
        else:
            ffn_out = ffn(*ffn_args)
        return _add_ln(hid, ffn_out, p["Ln2S"], p["Ln2B"], eps)

    per_layer = zip(*(t.unbind(0) for t in stacked))
    remat_layer = bool(attrs.get("remat_layer", False))
    out = hidden
    for idx, params in enumerate(per_layer):
        if remat_policy:
            # keep what the policy names, recompute the rest
            stash = _FlashStash() if keep_flash else None
            out = _ckpt(functools.partial(layer, stash=stash), out, idx,
                        *params)
        elif remat_layer:
            # full-layer remat: keep only the hidden between layers
            out = _ckpt(layer, out, idx, *params)
        else:
            out = layer(out, idx, *params)
    if ring:
        out = dist.all_gather(out, "sp", 1, mesh)
    return {"Out": [out]}


_DEC_PARAM_KEYS = (
    "SelfQKVW", "SelfQKVB", "SelfOutW", "SelfOutB", "Ln1S", "Ln1B",
    "CrossQW", "CrossQB", "CrossKW", "CrossKB", "CrossVW", "CrossVB",
    "CrossOutW", "CrossOutB", "Ln2S", "Ln2B",
    "FfnW1", "FfnB1", "FfnW2", "FfnB2", "Ln3S", "Ln3B",
)

# the five dropout sites of a decoder layer (the JAX package's k1 .. k5)
_SELF_ATTN, _SELF_OUT, _CROSS_ATTN, _CROSS_OUT, _DEC_FFN = 1, 2, 3, 4, 5


@register("fused_decoder_stack")
def fused_decoder_stack(ctx, ins, attrs):
    """The transformer decoder stack (causal self-attention, then
    cross-attention over the encoder output, then the FFN, post-LN) over
    stacked [L, ...] parameters: the NMT counterpart of
    ``fused_encoder_stack``."""
    hidden = ins["Hidden"][0]
    enc_out = ins["EncOut"][0]
    src_bias = ins.get("SrcBias", [None])[0]
    nh = int(attrs["num_heads"])
    act = _act(attrs.get("act", "relu"))
    dropout_prob = float(attrs.get("dropout_prob", 0.0))
    attn_dropout_prob = float(attrs.get("attn_dropout_prob", 0.0))
    is_test = bool(attrs.get("is_test", False))
    eps = float(attrs.get("epsilon", 1e-5))
    use_flash = bool(attrs.get("use_flash_attention", True))
    base_seed = ctx.salted_seed(int(attrs.get("rng_salt", 0)))
    shape_only = hidden.device.type == "meta"
    stacked = [ins[k][0] for k in _DEC_PARAM_KEYS]
    ring = use_ring(ctx, attrs)
    if ring:
        # the sp region: trg tokens sharded; the encoder output and the
        # source bias are read whole by every rank
        mesh, _, sp_idx = _sp_region(ctx, "fused_decoder_stack",
                                     hidden.shape[1])
        hidden = dist.shard_slice(hidden, "sp", 1, mesh)
        enc_out = dist.sp_identity(enc_out, "sp", mesh)
        if src_bias is not None:
            src_bias = dist.sp_identity(src_bias, "sp", mesh)
        stacked = [dist.sp_identity(t, "sp", mesh) for t in stacked]
        base_seed = mix_seed(base_seed, sp_idx)
    b, st, h = hidden.shape
    dh = h // nh
    attn_p = 0.0 if is_test else attn_dropout_prob

    def dropout(x, prob, seed):
        if is_test or prob <= 0.0 or shape_only:
            return x
        return _cheap_dropout(x, prob, seed)

    def attend(q3, k3, v3, bias4, causal, seed):
        """q3 [B, Sq, H], k3/v3 [B, Skv, H] -> [B, Sq, H]: the BSH kernels
        when the shapes allow (rectangular cross-attention included),
        else the composition."""
        sq, skv = q3.shape[1], k3.shape[1]
        if ring and causal:
            # trg-sharded causal self-attention over the ring
            q, k, v = (t.reshape(b, t.shape[1], nh, dh).transpose(1, 2)
                       for t in (q3, k3, v3))
            out = ring_attention(
                q, k, v, "sp", None, None, True, attn_p,
                seed if attn_p > 0.0 and not shape_only else None,
                mesh=mesh)
            return out.transpose(1, 2).reshape(b, sq, h)
        if not ring and use_flash and bsh_dispatch_ok(
                sq, skv, h, nh, bias=bias4, batch=b, causal=causal):
            gen = (_generator(seed, hidden.device)
                   if attn_p > 0.0 and not shape_only else None)
            return flash_attention_bsh(q3, k3, v3, bias4, num_heads=nh,
                                       causal=causal, dropout_prob=attn_p,
                                       dropout_generator=gen)
        q, k, v = (t.reshape(b, t.shape[1], nh, dh).transpose(1, 2)
                   for t in (q3, k3, v3))
        out = _composition(q, k, v, bias4, causal,
                           lambda pr: dropout(pr, attn_dropout_prob, seed))
        return out.transpose(1, 2).reshape(b, sq, h)

    def layer(hid, idx, *params):
        p = dict(zip(_DEC_PARAM_KEYS, params))
        lseed = mix_seed(base_seed, idx)

        def seed_of(site):
            return mix_seed(lseed, site)

        # causal self-attention
        qkv = torch.matmul(hid, p["SelfQKVW"]) + p["SelfQKVB"]
        q, k, v = (t.contiguous() for t in qkv.split(h, dim=-1))
        ctx_s = attend(q, k, v, None, True, seed_of(_SELF_ATTN))
        self_out = torch.matmul(ctx_s, p["SelfOutW"]) + p["SelfOutB"]
        hid = _add_ln(hid, dropout(self_out, dropout_prob,
                                   seed_of(_SELF_OUT)),
                      p["Ln1S"], p["Ln1B"], eps)

        # cross-attention over the encoder output (St queries, Ss keys)
        qc = torch.matmul(hid, p["CrossQW"]) + p["CrossQB"]
        kc = torch.matmul(enc_out, p["CrossKW"]) + p["CrossKB"]
        vc = torch.matmul(enc_out, p["CrossVW"]) + p["CrossVB"]
        ctx_c = attend(qc, kc, vc, src_bias, False, seed_of(_CROSS_ATTN))
        cross_out = torch.matmul(ctx_c, p["CrossOutW"]) + p["CrossOutB"]
        hid = _add_ln(hid, dropout(cross_out, dropout_prob,
                                   seed_of(_CROSS_OUT)),
                      p["Ln2S"], p["Ln2B"], eps)

        def ffn(h_, w1, b1, w2, b2):
            inter = act(torch.matmul(h_, w1) + b1)
            out_ = torch.matmul(inter, w2) + b2
            return dropout(out_, dropout_prob, seed_of(_DEC_FFN))

        ffn_args = (hid, p["FfnW1"], p["FfnB1"], p["FfnW2"], p["FfnB2"])
        ffn_out = (_ckpt(ffn, *ffn_args) if attrs.get("remat_ffn", False)
                   else ffn(*ffn_args))
        return _add_ln(hid, ffn_out, p["Ln3S"], p["Ln3B"], eps)

    out = hidden
    per_layer = zip(*(t.unbind(0) for t in stacked))
    for idx, params in enumerate(per_layer):
        out = layer(out, idx, *params)
    if ring:
        out = dist.all_gather(out, "sp", 1, mesh)
    return {"Out": [out]}
