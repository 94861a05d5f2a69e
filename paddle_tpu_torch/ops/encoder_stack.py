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
only remat there).

Pipeline parallelism (``pipeline`` under a mesh whose "pp" axis has more
than one rank; ``fluid.optimizer.PipelineOptimizer`` sets it and
``num_microbatches``): the JAX package's GPipe schedule, ``_gpipe_stack``.
Each rank is one stage and holds its block of the stacked parameters,
layers [s L/pp, (s+1) L/pp) (``fleet._shard_pipeline_params``); the
batch is split into M microbatches, microbatch m enters stage 0 at tick
m, activations move stage to stage with ``_raw_ppermute`` (cotangents by
the inverse permutation), and the last stage's output reaches every pp
rank (``distributed.broadcast_from_last``).  The schedule is one
``torch.autograd.Function`` (``_GPipe``) that keeps each microbatch's
stage graph and walks the ticks backwards in its backward, so the
gradients are the sequential stack's.  Dropout seeds mix in the
microbatch index, and ``remat_*`` / ``remat_policy`` wrap each
stage-local layer.  With ``sequence_parallel`` the stage's attention is
the ring over "sp" on the rank's token block (pp x sp).

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


def _use_gpipe(ctx, attrs):
    mesh = ctx.mesh
    return (bool(attrs.get("pipeline", False)) and mesh is not None
            and mesh.shape.get("pp", 1) > 1)


# mixed into a layer's seed with the GPipe microbatch index (the JAX
# package's fold_in of mb_salt)
_MB_SALT = 0x4D420000


def _microbatches(t, batch, M):
    """``t`` split into M microbatches on dim 0, or M times itself where
    it does not carry the batch (None stays None)."""
    if t is None or t.shape[0] != batch:
        return [t] * M
    return list(t.chunk(M, dim=0))


def _stage_perm(npp, M, t, forward):
    """The ppermute pairs of GPipe tick ``t``: stage i hands microbatch
    t - i on (forward: i -> i + 1; backward: i + 1 -> i, its cotangent)
    while that microbatch exists.  Every rank computes the same list."""
    return [(i, i + 1) if forward else (i + 1, i) for i in range(npp - 1)
            if 0 <= t - i < M]


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one rank's stage, forward and backward.

    forward(sched, hidden, bias, *params): tick t = 0 .. M + pp - 2; at
    tick t stage s runs microbatch m = t - s (if 0 <= m < M) on what
    stage s - 1 handed it at tick t - 1 (stage 0: microbatch m of
    ``hidden``) and hands the result on with ``_raw_ppermute``; stages
    outside their M ticks idle.  Each microbatch's stage graph is kept.
    The output is the last stage's microbatches in order (zeros on the
    other stages; ``broadcast_from_last`` follows).

    backward walks the ticks in reverse: stage s pulls microbatch m's
    cotangent (the last stage: its block of the output's; the others:
    what stage s + 1 handed back) through its graph, accumulates the
    parameter gradients, and hands the input's cotangent to stage s - 1
    by the inverse permutation.  The schedule drives the collectives
    explicitly: under autograd a stage whose received tensor goes unused
    (stage 0 reads ``hidden``) would never run its ppermute's backward,
    and its peer would wait for it.  ``hidden``'s gradient is stage 0's;
    the bias gets none (it is data)."""

    @staticmethod
    def forward(ctx, sched, hidden, bias, *params):
        with torch.no_grad():
            leaves = [p.detach().requires_grad_(p.requires_grad)
                      for p in params]
        out, graphs = sched.forward(hidden, bias, leaves, True)
        ctx.sched, ctx.graphs, ctx.leaves = sched, graphs, leaves
        ctx.hidden_like = (hidden.shape, hidden.dtype, hidden.device)
        return out

    @staticmethod
    def backward(ctx, g_out):
        dx, dparams = ctx.sched.backward(g_out, ctx.graphs, ctx.leaves,
                                         ctx.hidden_like)
        ctx.graphs = ctx.leaves = None
        return (None, dx, None) + tuple(dparams)


class _Schedule:
    """One rank's GPipe stage: ``run_stage(x, bias, mb)`` over its
    layers, M microbatches, the "pp" axis."""

    def __init__(self, run_stage, mesh, M):
        self.run_stage = run_stage
        self.ax = dist._axis("pp", mesh)
        self.npp, self.s, self.M = mesh.shape["pp"], mesh.coords["pp"], M

    def forward(self, hidden, bias, params, keep_graph):
        npp, s, M = self.npp, self.s, self.M
        xs = _microbatches(hidden, hidden.shape[0], M)
        bs = _microbatches(bias, hidden.shape[0], M)
        recv = torch.zeros_like(xs[0])
        outs, graphs = [None] * M, [None] * M
        for t in range(M + npp - 1):
            m = t - s
            send = recv
            if 0 <= m < M:
                x = xs[m] if s == 0 else recv
                if keep_graph:
                    x = x.detach().requires_grad_(s > 0
                                                  or hidden.requires_grad)
                    with torch.enable_grad():
                        y = self.run_stage(x, params, bs[m], m)
                    graphs[m] = (x, y)
                else:
                    y = self.run_stage(x, params, bs[m], m)
                send = outs[m] = y.detach()
            perm = _stage_perm(npp, M, t, True)
            if perm:
                recv = dist._raw_ppermute(send, perm, self.ax)
        if s != npp - 1:
            return torch.zeros_like(hidden), graphs
        return torch.cat(outs, dim=0), graphs

    def backward(self, g_out, graphs, params, hidden_like):
        npp, s, M = self.npp, self.s, self.M
        gs = list(g_out.chunk(M, dim=0))
        recv = torch.zeros_like(gs[0])
        dx = [None] * M
        dparams = [None] * len(params)
        wrt = [p for p in params if p.requires_grad]
        for t in reversed(range(M + npp - 1)):
            m = t - s
            send = recv
            if 0 <= m < M:
                x, y = graphs[m]
                g = gs[m] if s == npp - 1 else recv
                inputs = ([x] if x.requires_grad else []) + wrt
                with torch.enable_grad():
                    got = torch.autograd.grad(y, inputs, g.to(y.dtype),
                                              allow_unused=True)
                graphs[m] = None
                if x.requires_grad:
                    send = dx[m] = (got[0] if got[0] is not None
                                    else torch.zeros_like(x))
                    got = got[1:]
                k = 0
                for i, p in enumerate(params):
                    if not p.requires_grad:
                        continue
                    if got[k] is not None:
                        dparams[i] = (got[k] if dparams[i] is None
                                      else dparams[i] + got[k])
                    k += 1
            perm = _stage_perm(npp, M, t - 1, False)
            if perm and t > 0:
                recv = dist._raw_ppermute(send, perm, self.ax)
        shape, dtype, device = hidden_like
        d_hidden = (torch.cat(dx, dim=0) if s == 0 and dx[0] is not None
                    else torch.zeros(shape, dtype=dtype, device=device))
        dparams = [torch.zeros_like(p) if d is None and p.requires_grad
                   else d for p, d in zip(params, dparams)]
        return d_hidden, dparams


def _gpipe_stack(hidden, stacked, bias, mesh, M, run_layers):
    """The GPipe schedule over the "pp" axis (the JAX package's
    ``_gpipe_stack``): stage s holds layers [s L/pp, (s+1) L/pp) as
    ``stacked`` (its block of the [L, ...] parameters); microbatch m
    enters stage 0 at tick m and leaves stage pp-1 at tick m + pp - 1;
    the last stage's output reaches every pp rank through
    ``broadcast_from_last``.  ``hidden`` enters through f over "pp", so
    stage 0's gradient of it (the only one) reaches the embeddings of
    every pp rank.  Under ring attention ``hidden`` and the bias are this
    sp rank's token block already, and each stage's attention is the
    ring over "sp" (pp x sp)."""
    npp = mesh.shape["pp"]
    dp_size = mesh.shape.get("dp", 1)
    l_loc = stacked[0].shape[0]
    batch = hidden.shape[0]
    if batch % M:
        raise ValueError(
            f"per-dp-shard batch {batch * dp_size}//{dp_size} must divide "
            f"by num_microbatches={M}")
    first = mesh.coords["pp"] * l_loc

    def run_stage(x, params, bias_mb, mb):
        return run_layers(x, params, bias_mb, mb, first)

    sched = _Schedule(run_stage, mesh, M)
    hidden = dist.copy_to_region(hidden, "pp", mesh)
    if torch.is_grad_enabled() and (hidden.requires_grad or any(
            t.requires_grad for t in stacked)):
        out = _GPipe.apply(sched, hidden, bias, *stacked)
    else:
        out, _ = sched.forward(hidden, bias, stacked, False)
    return dist.broadcast_from_last(out, "pp", mesh)


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

    def make_layer(bias, mb=None):
        """The layer body over this (micro)batch's attention bias;
        ``mb`` (the GPipe microbatch) salts its dropout seeds."""

        def layer(hid, idx, *params, stash=None):
            p = dict(zip(_PARAM_KEYS, params))
            b, s, h = hid.shape
            dh = h // nh
            lseed = mix_seed(base_seed, idx)
            if mb is not None:
                lseed = mix_seed(lseed, _MB_SALT + mb)

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

        return layer

    remat_layer = bool(attrs.get("remat_layer", False))

    def run_layers(x, params_stacked, bias_x, mb=None, first=0):
        """Layers first, first + 1, ... of ``params_stacked`` on ``x``."""
        layer = make_layer(bias_x, mb)
        out = x
        per_layer = zip(*(t.unbind(0) for t in params_stacked))
        for j, params in enumerate(per_layer):
            idx = first + j
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
        return out

    if _use_gpipe(ctx, attrs):
        out = _gpipe_stack(hidden, stacked, bias, ctx.mesh,
                           int(attrs.get("num_microbatches", 0))
                           or ctx.mesh.shape["pp"], run_layers)
    else:
        out = run_layers(hidden, stacked, bias)
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
