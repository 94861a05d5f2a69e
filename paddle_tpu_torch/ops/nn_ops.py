"""Neural-net ops of the BERT and ResNet paths: conv2d, pool2d,
batch_norm, fused_conv_bn, layer_norm, lookup_table(_v2), dropout (+
dropout_grad), softmax_with_cross_entropy, and square_error_cost (the
hapi ``Model`` tests' regression loss).

Parity surface: reference conv_op.cc, pool_op.cc, batch_norm_op.cc,
layer_norm_op.cc, lookup_table_v2_op.cc, dropout_op.cc,
softmax_with_cross_entropy_op.cc; ported from the JAX package's
``ops/nn_ops.py``.  Convolutions keep OIHW weights and run the library
convolution (cuDNN on the card) on channels_last views of NHWC tensors.
``fused_conv_bn`` in training mode runs the conv+BN kernels
(``ops/kernels/conv_bn.py``); with ``is_test`` it folds the BN into the
conv weights.  A last-axis affine ``layer_norm`` runs the
fused add+LN kernels (``ops/kernels/add_ln.py``, forward and backward
through ``add_ln``) when FLAGS_use_fused_ln is on; every other layer_norm
is the plain f32-statistics composition.  ``dropout`` takes no generic
grad: its grad maker emits ``dropout_grad``, which reads the saved Mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels import add_ln as _add_ln
from .kernels import conv_bn as _cb
from .. import distributed as dist
from ..parallel import tp_mesh
from .manipulation import _fill_value, take
from .registry import register, set_grad_maker


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


def _conv_padding(paddings, algo, ndim_spatial):
    if algo == "SAME":
        return "SAME"
    if algo == "VALID":
        return "VALID"
    p = list(paddings)
    if len(p) == ndim_spatial:
        return [(pi, pi) for pi in p]
    if len(p) == 2 * ndim_spatial:
        return [(p[2 * i], p[2 * i + 1]) for i in range(ndim_spatial)]
    raise ValueError(f"bad paddings {paddings}")


def _conv2d_impl(x, w, attrs):
    """conv2d with OIHW weights over NCHW or NHWC x.  "SAME" and explicit
    (possibly asymmetric) pads resolve to explicit (lo, hi) pads, SAME
    putting total // 2 on the low side as JAX does."""
    strides = tuple(attrs.get("strides", [1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    pad = _conv_padding(attrs.get("paddings", [0, 0]),
                        attrs.get("padding_algorithm", "EXPLICIT"), 2)
    nhwc = attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout")
    h, wd = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    # SAME pads by the dilated kernel's extent
    kh = (w.shape[2] - 1) * dil[0] + 1
    kw = (w.shape[3] - 1) * dil[1] + 1
    pads = _cb._resolve_pads(pad, h, wd, kh, kw, strides)
    if nhwc:
        return _cb.conv2d_nhwc(x, w, strides, pads, dil, groups)
    (t, b), (l, r) = pads
    if t == b and l == r:
        return F.conv2d(x, w, None, strides, (t, l), dil, groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, None, strides, 0, dil, groups)


def _use_im2col_dw(attrs, w_shape):
    from ..fluid.flags import flag

    if not flag("FLAGS_conv_dw_im2col"):
        return False
    return (attrs.get("data_format", "NCHW") == "NHWC"
            and int(attrs.get("groups", 1)) == 1
            and (int(w_shape[2]), int(w_shape[3])) != (1, 1))


@register("conv2d")
def conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    if _use_im2col_dw(attrs, w.shape):
        raise NotImplementedError(
            "FLAGS_conv_dw_im2col (the im2col weight-gradient formulation) "
            "is not ported yet; turn the flag off")
    return {"Output": [_conv2d_impl(x, w, attrs)]}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def _pool_pads(attrs, ksize, strides, h, w):
    """Explicit ((lo, hi), (lo, hi)) pads of a windowed pool, with the
    ceil_mode extension on the high side (the JAX emitter's rule)."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    paddings = list(attrs.get("paddings", [0, 0]))
    if algo == "SAME":
        return _cb._resolve_pads("SAME", h, w, ksize[0], ksize[1], strides)
    if algo == "VALID":
        pad = [(0, 0), (0, 0)]
    elif len(paddings) == 2:
        pad = [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    else:
        pad = [(paddings[0], paddings[1]), (paddings[2], paddings[3])]
    if attrs.get("ceil_mode", False):
        def extra(dim, k, s, p):
            out = math.ceil((dim + p[0] + p[1] - k) / s) + 1
            need = (out - 1) * s + k - dim - p[0]
            return max(need - p[1], 0)

        pad = [(pad[0][0], pad[0][1] + extra(h, ksize[0], strides[0], pad[0])),
               (pad[1][0], pad[1][1] + extra(w, ksize[1], strides[1], pad[1]))]
    return tuple(tuple(p) for p in pad)


@register("pool2d")
def pool2d(ctx, ins, attrs):
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [1, 1]))
    strides = list(attrs.get("strides", ksize))
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    hax, wax = (1, 2) if nhwc else (2, 3)
    h, w = x.shape[hax], x.shape[wax]

    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and ksize == [1, 1]):
        if ptype == "max":
            return {"Out": [x.amax(dim=(hax, wax), keepdim=True)]}
        return {"Out": [x.mean(dim=(hax, wax), keepdim=True)]}
    if attrs.get("adaptive", False):
        oh, ow = ksize
        if h % oh or w % ow:
            raise NotImplementedError(
                "adaptive pool2d with non-divisible bins is not ported yet")
        if nhwc:
            xr = x.reshape(x.shape[0], oh, h // oh, ow, w // ow, x.shape[3])
            red = (2, 4)
        else:
            xr = x.reshape(x.shape[0], x.shape[1], oh, h // oh, ow, w // ow)
            red = (3, 5)
        return {"Out": [xr.amax(dim=red) if ptype == "max"
                        else xr.mean(dim=red)]}

    pads = _pool_pads(attrs, ksize, strides, h, w)
    xc = x.permute(0, 3, 1, 2) if nhwc else x   # NCHW view
    (t, b), (l, r) = pads
    native = (t == b and l == r and 2 * t <= ksize[0] and 2 * l <= ksize[1])
    if ptype == "max":
        if native:   # torch pads max pools with -inf implicitly
            out = F.max_pool2d(xc, ksize, strides, (t, l))
        else:
            out = F.max_pool2d(F.pad(xc, (l, r, t, b), value=-math.inf),
                               ksize, strides)
    elif attrs.get("exclusive", True):
        if native:   # divides each window by its non-padding count
            out = F.avg_pool2d(xc, ksize, strides, (t, l),
                               count_include_pad=False)
        else:
            s = F.avg_pool2d(F.pad(xc, (l, r, t, b)), ksize, strides,
                             divisor_override=1)
            ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
            cnt = F.avg_pool2d(F.pad(ones, (l, r, t, b)), ksize, strides,
                               divisor_override=1)
            out = s / cnt
    else:
        out = F.avg_pool2d(F.pad(xc, (l, r, t, b)), ksize, strides,
                           divisor_override=1) / (ksize[0] * ksize[1])
    return {"Out": [out.permute(0, 2, 3, 1).contiguous() if nhwc else out]}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@register("batch_norm")
def batch_norm(ctx, ins, attrs):
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_global = (attrs.get("use_global_stats", False)
                  or attrs.get("is_test", False))
    ch_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    bshape = tuple(x.shape[ch_axis] if i == ch_axis else 1
                   for i in range(x.dim()))

    # statistics always in f32 (the op sits on AMP's low-precision list;
    # bf16 in/out, f32 mean/variance math)
    xf = x.float()
    if use_global:
        m, v = mean, var
        mean_out, var_out = mean, var
        saved_mean = torch.zeros_like(mean)
        saved_var = torch.zeros_like(var)
    else:
        # one-pass moments, as the JAX package takes them
        m = xf.mean(dim=axes)
        v = torch.clamp_min((xf * xf).mean(dim=axes) - m * m, 0.0)
        mean_out = momentum * mean + (1 - momentum) * m
        var_out = momentum * var + (1 - momentum) * v
        saved_mean = m
        saved_var = 1.0 / torch.sqrt(v + eps)
    inv = 1.0 / torch.sqrt(v + eps)
    y = ((xf - m.reshape(bshape)) * inv.reshape(bshape)
         * scale.float().reshape(bshape)
         + bias.float().reshape(bshape)).to(x.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var]}


@register("fused_conv_bn")
def fused_conv_bn(ctx, ins, attrs):
    """conv2d -> batch_norm [-> relu] as one op (fluid/fusion_pass.py).

    Training mode runs the conv+BN kernels of ``ops/kernels/conv_bn.py``
    for NHWC (the reference composition for the shapes they do not
    take, and for NCHW, transposed); ``is_test`` / ``use_global_stats``
    folds the BN into the conv weights: one conv and one bias add.  The
    outputs are batch_norm's five."""
    x, w = ins["Input"][0], ins["Filter"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    with_relu = bool(attrs.get("with_relu", False))
    strides = tuple(attrs.get("strides", [1, 1]))
    pads = _conv_padding(attrs.get("paddings", [0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"), 2)
    use_global = (attrs.get("use_global_stats", False)
                  or attrs.get("is_test", False))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"

    if use_global:
        # weight folding: y = conv(x, w * (s * inv)) + (b - m * s * inv)
        inv = 1.0 / torch.sqrt(var.float() + eps)
        gain = scale.float() * inv
        wf = (w.float() * gain.reshape(-1, 1, 1, 1)).to(w.dtype)
        shift = bias.float() - mean.float() * gain
        z = _conv2d_impl(x, wf, attrs)
        bshape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
        y = z.float() + shift.reshape(bshape)
        if with_relu:
            y = torch.relu(y)
        return {"Y": [y.to(x.dtype)], "MeanOut": [mean],
                "VarianceOut": [var], "SavedMean": [torch.zeros_like(mean)],
                "SavedVariance": [torch.zeros_like(var)]}

    if nhwc:
        y, m, v = _cb.fused_conv_bn(x, w, scale, bias, strides=strides,
                                    pads=pads, eps=eps, with_relu=with_relu)
    else:
        # NCHW never reaches the kernels; compose channel-last
        xt = x.permute(0, 2, 3, 1)
        pads_r = _cb._resolve_pads(pads, xt.shape[1], xt.shape[2],
                                   int(w.shape[2]), int(w.shape[3]), strides)
        y, m, v = _cb.conv_bn_reference(xt, w, scale, bias, strides=strides,
                                        pads=pads_r, eps=eps,
                                        with_relu=with_relu)
        y = y.permute(0, 3, 1, 2)
    mean_out = momentum * mean + (1 - momentum) * m.to(mean.dtype)
    var_out = momentum * var + (1 - momentum) * v.to(var.dtype)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [m.to(mean.dtype)],
            "SavedVariance": [(1.0 / torch.sqrt(v + eps)).to(var.dtype)]}


@register("layer_norm")
def layer_norm(ctx, ins, attrs):
    # statistics always in f32 (the fused-stack ln() convention)
    from ..fluid.flags import flag

    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:axis])
    if (axis == x.dim() - 1 and ins.get("Scale") and ins.get("Bias")
            and flag("FLAGS_use_fused_ln")):
        # the kernel returns Y, the row mean and rstd = 1/sqrt(var + eps);
        # the op's Variance output is recovered as 1/rstd^2 - eps (about
        # 3 f32 ulps of var + eps off the direct variance)
        y, m, rstd = _add_ln.add_ln(x, None, ins["Scale"][0],
                                    ins["Bias"][0], eps=eps)
        v = rstd.reciprocal().square() - eps
        return {"Y": [y], "Mean": [m.reshape(lead)],
                "Variance": [v.reshape(lead)]}
    xf = x.float()
    red = tuple(range(axis, x.dim()))
    m = xf.mean(dim=red, keepdim=True)
    v = (xf - m).square().mean(dim=red, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + eps)
    tail_shape = (1,) * axis + tuple(x.shape[axis:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].float().reshape(tail_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].float().reshape(tail_shape)
    return {"Y": [y.to(x.dtype)], "Mean": [m.reshape(lead)],
            "Variance": [v.reshape(lead)]}


@register("dropout", no_vjp_grad=True)
def dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out],
                "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    keep = torch.rand(x.shape, generator=ctx.rng(), device=x.device) < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / max(1.0 - p, 1e-12), 0.0).to(x.dtype)
    else:
        out = torch.where(keep, x, 0.0).to(x.dtype)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


@register("dropout_grad", no_vjp_grad=True)
def dropout_grad(ctx, ins, attrs):
    dout = ins["Out@GRAD"][0]
    mask = ins["Mask"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        # forward was out = x*(1-p) (downgrade) or out = x (upscale)
        return {"X@GRAD": [dout * (1.0 - p) if impl == "downgrade_in_infer"
                           else dout]}
    dx = dout * mask.to(dout.dtype)
    if impl == "upscale_in_train":
        dx = dx / max(1.0 - p, 1e-12)
    return {"X@GRAD": [dx]}


def _dropout_grad_maker(op, out_grads, block):
    og = out_grads.get("Out")
    if og is None:
        return [], {}
    xname = op.input("X")[0]
    gname = xname + "@GRAD"
    desc = {
        "type": "dropout_grad",
        "inputs": {"Mask": [op.output("Mask")[0]], "Out@GRAD": [og[0]]},
        "outputs": {"X@GRAD": [gname]},
        "attrs": dict(op.attrs),
    }
    return [desc], {xname: gname}


set_grad_maker("dropout", _dropout_grad_maker)


def _lookup(w, ids, padding_idx):
    out = take(w, ids)  # negative ids wrap, ids past the table give NaN rows
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def _vocab_lookup(w, ids, padding_idx, mesh):
    """The vocabulary-parallel lookup (tp_region "vocab"): this rank
    holds rows [i V/tp, (i+1) V/tp) of the [V, H] table; it looks up the
    ids among them, zeros elsewhere, and g sums the ranks' rows over
    "tp".  The global rules hold: a negative id wraps, one past the table
    gives the fill row (on tp rank 0 only, so the sum keeps it), the
    padding index gives zeros."""
    n, i = mesh.shape["tp"], mesh.coords["tp"]
    rows = w.shape[0]
    vocab = rows * n
    glob = torch.where(ids < 0, ids + vocab, ids)
    ok = (glob >= 0) & (glob < vocab)
    local = glob - i * rows
    mine = ok & (local >= 0) & (local < rows)
    out = take(w, torch.where(mine, local, 0))
    out = torch.where(mine[..., None], out, 0.0)
    if i == 0:
        out = torch.where(ok[..., None], out, _fill_value(w.dtype))
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return dist.reduce_from_region(out, "tp", mesh)


def _lookup_op(ctx, attrs, w, ids):
    mesh = tp_mesh(ctx, attrs)
    if mesh is not None:
        return _vocab_lookup(w, ids, attrs.get("padding_idx", -1), mesh)
    return _lookup(w, ids, attrs.get("padding_idx", -1))


@register("lookup_table")
def lookup_table(ctx, ins, attrs):
    # v1 ids carry a trailing [, 1] dim (LoD heritage)
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [_lookup_op(ctx, attrs, w, ids.reshape(ids.shape[:-1]))]}


@register("lookup_table_v2")
def lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [_lookup_op(ctx, attrs, w, ids)]}


@register("square_error_cost")
def square_error_cost(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.square(x - y)]}


@register("softmax_with_cross_entropy")
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.dim()
    ignore_index = attrs.get("ignore_index", -100)
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        # hard labels: the label has the logits' shape with the class
        # axis of size 1, or lacks that axis
        if label.dim() == logits.dim() and label.shape[axis] == 1:
            idx = label.long()
        else:
            idx = label.long().unsqueeze(axis)
        picked = logp.gather(axis, idx.clamp(0, logp.shape[axis] - 1))
        # kIgnoreIndex (-100) is itself a valid ignore value: mask always
        loss = torch.where(idx == ignore_index, 0.0, -picked)
    return {"Softmax": [softmax], "Loss": [loss]}
