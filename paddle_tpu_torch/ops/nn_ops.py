"""Neural-net ops: conv2d (with FLAGS_conv_dw_im2col's weight
gradient), depthwise_conv2d, conv2d_transpose, conv3d, pool2d (with
adaptive bins that do not divide the input), batch_norm, fused_conv_bn,
layer_norm, group_norm, instance_norm, norm, lookup_table(_v2),
embedding_with_scaled_gradient, one_hot(_v2), dropout (+ dropout_grad),
the losses (softmax_with_cross_entropy, cross_entropy(2),
sigmoid_cross_entropy_with_logits, bce_loss, square_error_cost,
smooth_l1_loss, huber_loss, log_loss, kldiv_loss, label_smooth,
mse_loss, margin_rank_loss) and the metrics (accuracy, auc).

Parity surface: reference conv_op.cc, conv_transpose_op.cc, pool_op.cc,
batch_norm_op.cc, layer_norm_op.cc, group_norm_op.cc,
instance_norm_op.cc, norm_op.cc, lookup_table_v2_op.cc,
one_hot_v2_op.cc, dropout_op.cc, the loss ops and metrics/; ported from
the JAX package's ``ops/nn_ops.py``, every op type of it.  Convolutions
keep OIHW weights and run the library convolution (cuDNN on the card) on
channels_last views of NHWC tensors.  ``fused_conv_bn`` in training mode
runs the conv+BN kernels (``ops/kernels/conv_bn.py``); with ``is_test``
it folds the BN into the conv weights.  A last-axis affine
``layer_norm`` runs the fused add+LN kernels (``ops/kernels/add_ln.py``,
forward and backward through ``add_ln``) when FLAGS_use_fused_ln is on;
every other layer_norm is the plain f32-statistics composition.  No
other op here has a ``pallas_call`` in the JAX package: each is plain
torch (and cuDNN) on every device, and computes what the JAX emitter
computes, with its dtypes and its derivatives where they differ from
torch's (lax.max's tie and NaN rule, the take fill's dropped gradient,
jnp.max's shared ties).  ``dropout`` takes no generic grad: its grad
maker emits ``dropout_grad``, which reads the saved Mask.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels import add_ln as _add_ln
from .kernels import conv_bn as _cb
from .. import distributed as dist
from ..parallel import tp_mesh
from .manipulation import _fill_value, _xshape, take, take_along
from .math_ops import _abs, _maximum0, _min_max
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


def _spatial_pads(pad, sizes, ks, strides):
    """A lax padding spec ("SAME", "VALID" or (lo, hi) pairs) over any
    number of spatial dims as explicit (lo, hi) pairs; SAME puts
    total // 2 on the low side, as lax.padtype_to_pads does."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        out = []
        for n, k, s in zip(sizes, ks, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    return [(int(lo), int(hi)) for lo, hi in pad]


def _pad_spatial(x, pads):
    """x [N, C, *spatial] padded with zeros by explicit (lo, hi) pairs; a
    negative amount crops."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat)


def _dilated(w, dil):
    """The extent of each spatial dim of the OI... kernel ``w`` under
    ``dil``."""
    return [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dil)]


def _conv2d_geometry(x, w, attrs):
    """(strides, dilations, groups, NHWC?, explicit pads) of a conv2d;
    SAME pads by the dilated kernel's extent, total // 2 low, as JAX."""
    strides = tuple(attrs.get("strides", [1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1]))
    pad = _conv_padding(attrs.get("paddings", [0, 0]),
                        attrs.get("padding_algorithm", "EXPLICIT"), 2)
    nhwc = attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout")
    h, wd = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    kh, kw = _dilated(w, dil)
    pads = _cb._resolve_pads(pad, h, wd, kh, kw, strides)
    return strides, dil, int(attrs.get("groups", 1)), nhwc, pads


def _conv2d_impl(x, w, attrs):
    """conv2d with OIHW weights over NCHW or NHWC x.  "SAME" and explicit
    (possibly asymmetric) pads resolve to explicit (lo, hi) pads, SAME
    putting total // 2 on the low side as JAX does."""
    strides, dil, groups, nhwc, pads = _conv2d_geometry(x, w, attrs)
    if nhwc:
        return _cb.conv2d_nhwc(x, w, strides, pads, dil, groups)
    (t, b), (l, r) = pads
    if t == b and l == r:
        return F.conv2d(x, w, None, strides, (t, l), dil, groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), w, None, strides, 0, dil, groups)


class _Im2colDW(torch.autograd.Function):
    """conv2d over NHWC ``x`` (groups 1) whose weight gradient is the JAX
    package's FLAGS_conv_dw_im2col formulation: the kernel-window patches
    of x (``F.unfold``'s order, feature c * kh * kw + ki * kw + kj)
    against dy in ONE product over N * Ho * Wo, accumulated in f32 and
    cast to the weight's dtype.  The input gradient is the library's
    standard one."""

    @staticmethod
    def forward(ctx, x, w, strides, pads, dil):
        ctx.save_for_backward(x, w)
        ctx.cfg = (strides, pads, dil)
        return _cb.conv2d_nhwc(x, w, strides, pads, dil)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        strides, pads, dil = ctx.cfg
        xp = _cb._pad_nhwc(x, pads).permute(0, 3, 1, 2)    # NCHW view
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), xp, w, None, list(strides), [0, 0],
                list(dil), False, [0, 0], 1, [True, False, False])[0]
            (t, b), (l, r) = pads
            dx = F.pad(dxp.permute(0, 2, 3, 1), (0, 0, -l, -r, -t, -b))
        if ctx.needs_input_grad[1]:
            o, _, kh, kw = w.shape
            patches = F.unfold(xp.float(), (kh, kw), dilation=dil,
                               stride=strides)          # [N, C kh kw, L]
            dw = torch.einsum("npl,nlo->op", patches,
                              dy.float().reshape(dy.shape[0], -1, o))
            dw = dw.reshape(w.shape).to(w.dtype)
        return dx, dw, None, None, None


def _use_im2col_dw(attrs, w_shape):
    from ..fluid.flags import flag

    if not flag("FLAGS_conv_dw_im2col"):
        return False
    # NHWC only (the patches' layout), grouped convs excluded, and 1 x 1
    # kernels gain nothing (their dW is already one product)
    return (attrs.get("data_format", "NCHW") == "NHWC"
            and int(attrs.get("groups", 1)) == 1
            and (int(w_shape[2]), int(w_shape[3])) != (1, 1))


@register("conv2d")
def conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    if _use_im2col_dw(attrs, w.shape):
        strides, dil, _, _, pads = _conv2d_geometry(x, w, attrs)
        return {"Output": [_Im2colDW.apply(x, w, strides, pads, dil)]}
    return {"Output": [_conv2d_impl(x, w, attrs)]}


@register("depthwise_conv2d")
def depthwise_conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    a = dict(attrs)
    # as the JAX emitter: any layout but "NCHW" takes its channels last
    a["groups"] = (x.shape[1] if a.get("data_format", "NCHW") == "NCHW"
                   else x.shape[-1])
    return {"Output": [_conv2d_impl(x, w, a)]}


@register("conv2d_transpose")
def conv2d_transpose(ctx, ins, attrs):
    """The JAX emitter's transposed convolution: lax's convolution of the
    stride-dilated x with the flipped kernel, padded kd - 1 - p on each
    side (kd the dilated kernel's extent).  That is the library's
    transposed convolution without padding, cropped by p on each side (or
    padded with zeros where p is negative).  Filter [Cin, Cout / groups,
    kh, kw], NCHW whatever ``data_format``.  A string padding at stride 1
    takes lax's pads of the undilated x; at any other stride it raises, as
    lax does.  ``output_padding`` appends zeros after the last row and
    column, as the JAX emitter does (the reference's conv-transpose
    computes values there)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = tuple(attrs.get("strides", [1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1]))
    pad = _conv_padding(attrs.get("paddings", [0, 0]),
                        attrs.get("padding_algorithm", "EXPLICIT"), 2)
    kd = _dilated(w, dil)
    if isinstance(pad, str):
        if strides != (1, 1):
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        lax_pads = _spatial_pads(pad, x.shape[2:], kd, (1, 1))
        crop = [(k - 1 - lo, k - 1 - hi) for (lo, hi), k in zip(lax_pads,
                                                                 kd)]
    else:
        crop = pad
    full = F.conv_transpose2d(x, w, None, strides, 0, 0,
                              int(attrs.get("groups", 1)), dil)
    out = _pad_spatial(full, [(-lo, -hi) for lo, hi in crop])
    op_ = attrs.get("output_padding")
    if op_ and any(op_):
        out = F.pad(out, (0, op_[1], 0, op_[0]))
    return {"Output": [out]}


@register("conv3d")
def conv3d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = tuple(attrs.get("strides", [1, 1, 1]))
    dil = tuple(attrs.get("dilations", [1, 1, 1]))
    groups = int(attrs.get("groups", 1))
    pad = _conv_padding(attrs.get("paddings", [0, 0, 0]),
                        attrs.get("padding_algorithm", "EXPLICIT"), 3)
    pads = _spatial_pads(pad, x.shape[2:], _dilated(w, dil), strides)
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        return {"Output": [F.conv3d(x, w, None, strides,
                                    [lo for lo, _ in pads], dil, groups)]}
    return {"Output": [F.conv3d(_pad_spatial(x, pads), w, None, strides, 0,
                                dil, groups)]}


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def adaptive_pool_nd(x, out_sizes, red):
    """Adaptive pooling with bins that need not divide the input (the JAX
    package's ``adaptive_pool_nd``, reference pool_op.h
    AdaptStartIndex / AdaptEndIndex): bin i of a spatial dim ``n -> out``
    spans [floor(i n / out), ceil((i + 1) n / out)); each bin is a slice
    reduced by ``red`` and the bins concatenated, one spatial dim after
    the other (so a max's tie shares multiply across the dims)."""
    out = x
    for d, (n, o) in enumerate(zip(x.shape[2:], out_sizes)):
        ax = 2 + d
        bins = [(math.floor(i * n / o), math.ceil((i + 1) * n / o))
                for i in range(o)]
        out = torch.cat([red(out.narrow(ax, s, e - s), ax)
                         for s, e in bins], dim=ax)
    return out


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
            if nhwc:
                raise NotImplementedError(
                    "adaptive pool with non-divisible bins supports NCHW "
                    "only")
            # amax / mean share a tie's gradient evenly, as jnp.max
            red = ((lambda t, ax: t.amax(dim=ax, keepdim=True))
                   if ptype == "max"
                   else (lambda t, ax: t.mean(dim=ax, keepdim=True)))
            return {"Out": [adaptive_pool_nd(x, (oh, ow), red)]}
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


def _mean_var(x, axes):
    """jnp.mean and jnp.var over ``axes`` (kept): the variance two-pass,
    the mean of the squared deviations from its own mean (not E[x^2] -
    E[x]^2); a bf16 or f16 x computed in f32 and each result rounded
    back, as jnp upcasts them."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    m = xf.mean(dim=axes, keepdim=True)
    v = (xf - m).square().mean(dim=axes, keepdim=True)
    return m.to(x.dtype), v.to(x.dtype)


def _affine(y, ins, c, rank):
    bshape = (1, c) + (1,) * (rank - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return y


@register("group_norm")
def group_norm(ctx, ins, attrs):
    """NCHW; statistics in X's dtype (unlike batch_norm's f32), the
    variance two-pass as jnp.var."""
    x = ins["X"][0]
    groups = attrs["groups"]
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    m, v = _mean_var(xg, tuple(range(2, xg.dim())))
    y = ((xg - m) / torch.sqrt(v + eps)).reshape(x.shape)
    return {"Y": [_affine(y, ins, c, x.dim())],
            "Mean": [m.reshape(n, groups)],
            "Variance": [v.reshape(n, groups)]}


@register("instance_norm")
def instance_norm(ctx, ins, attrs):
    """NCHW; SavedVariance is 1 / sqrt(var + eps), as the JAX emitter's."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    m, v = _mean_var(x, tuple(range(2, x.dim())))
    y = (x - m) / torch.sqrt(v + eps)
    n, c = x.shape[0], x.shape[1]
    return {"Y": [_affine(y, ins, c, x.dim())],
            "SavedMean": [m.reshape(n * c)],
            "SavedVariance": [(1.0 / torch.sqrt(v + eps)).reshape(n * c)]}


@register("norm")
def norm(ctx, ins, attrs):
    """x / sqrt(sum(x^2) + eps) over ``axis`` (F.normalize divides by
    max(||x||, eps) instead)."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-10)
    nrm = torch.sqrt(x.square().sum(dim=attrs.get("axis", -1), keepdim=True)
                     + eps)
    return {"Out": [x / nrm], "Norm": [nrm]}


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


@register("embedding_with_scaled_gradient")
def embedding_with_scaled_gradient(ctx, ins, attrs):
    # the JAX emitter's plain lookup (its gradient unscaled)
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [_lookup(w, ids, attrs.get("padding_idx", -1))]}


def _one_hot(x, depth):
    """jax.nn.one_hot in float32: an id outside [0, depth) (negative, past
    the end, NaN) gives a zero row, on every device."""
    iota = torch.arange(depth, device=x.device)
    return (x.unsqueeze(-1) == iota).to(torch.float32)


@register("one_hot_v2", stop_gradient=True, no_vjp_grad=True)
def one_hot_v2(ctx, ins, attrs):
    return {"Out": [_one_hot(ins["X"][0], attrs["depth"])]}


@register("one_hot", stop_gradient=True, no_vjp_grad=True)
def one_hot(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [_one_hot(x.reshape(x.shape[:-1]), attrs["depth"])]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _max_eps(x, eps):
    """jnp.maximum(x, eps) in x's dtype, under lax.max's derivative."""
    return _min_max(torch.maximum)(
        x, torch.tensor(eps, dtype=x.dtype, device=x.device))


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


@register("cross_entropy")
def cross_entropy(ctx, ins, attrs):
    """-log(max(p, 1e-12)) of the label's probability (soft labels: the
    label-weighted sum).  The hard label is read as jnp.take_along_axis
    reads it: a negative one wraps once, one still out of range reads NaN
    and takes no gradient; ``ignore_index`` (-100 by default) gives 0."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore_index = attrs.get("ignore_index", -100)
    if attrs.get("soft_label", False):
        return {"Y": [-(label * torch.log(_max_eps(x, 1e-12))).sum(
            dim=-1, keepdim=True)]}
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    p = take_along(x, lbl.unsqueeze(-1).to(torch.int32), x.dim() - 1)
    loss = -torch.log(_max_eps(p, 1e-12))
    return {"Y": [torch.where(lbl.unsqueeze(-1) == ignore_index, 0.0,
                              loss)]}


@register("cross_entropy2")
def cross_entropy2(ctx, ins, attrs):
    y = cross_entropy(ctx, ins, attrs)["Y"][0]
    return {"Y": [y], "XShape": [_xshape(ins["X"][0])],
            "MatchX": [torch.exp(-y)]}


@register("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """max(x, 0) - x z + log1p(exp(-|x|)) (lax's derivatives of max and
    |x| at 0); 0 where the label is ``ignore_index``; with ``normalize``
    divided by the count of the other labels (at least 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    loss = (_maximum0(x) - x * label
            + torch.log1p(torch.exp(-_abs(x))))
    mask = label != attrs.get("ignore_index", -100)
    loss = torch.where(mask, loss, 0.0)
    if attrs.get("normalize", False):
        loss = loss / mask.to(loss.dtype).sum().clamp_min(1.0)
    return {"Out": [loss]}


@register("bce_loss")
def bce_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": [-(label * torch.log(_max_eps(x, 1e-12))
                      + (1 - label) * torch.log(_max_eps(1 - x, 1e-12)))]}


@register("smooth_l1_loss")
def smooth_l1_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = x - y
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    ad = _abs(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": [loss.reshape(loss.shape[0], -1).sum(dim=1,
                                                        keepdim=True)],
            "Diff": [diff]}


@register("huber_loss")
def huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = _abs(r)
    return {"Out": [torch.where(ar <= delta, 0.5 * r * r,
                                delta * (ar - 0.5 * delta))],
            "Residual": [r]}


@register("log_loss")
def log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register("kldiv_loss")
def kldiv_loss(ctx, ins, attrs):
    """t (log t - x) where the target t > 0, else 0; where t is 0 the
    gradient to x is -0.0 and to a t that takes one NaN, as JAX's (its
    zero cotangent passes through log(0))."""
    x, tgt = ins["X"][0], ins["Target"][0]
    red = attrs.get("reduction", "mean")
    loss = torch.where(tgt > 0, tgt * (torch.log(tgt) - x), 0.0)
    if red == "mean":
        loss = loss.mean().reshape(1)
    elif red == "sum":
        loss = loss.sum().reshape(1)
    elif red == "batchmean":
        loss = (loss.sum() / x.shape[0]).reshape(1)
    return {"Loss": [loss]}


@register("label_smooth")
def label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register("mse_loss")
def mse_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.square(x - y).mean().reshape(1)]}


@register("margin_rank_loss")
def margin_rank_loss(ctx, ins, attrs):
    x1, x2, label = ins["X1"][0], ins["X2"][0], ins["Label"][0]
    act = _maximum0(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return {"Out": [act], "Activated": [(act > 0).to(x1.dtype)]}


# ---------------------------------------------------------------------------
# metrics (reference operators/metrics/)
# ---------------------------------------------------------------------------


@register("accuracy", stop_gradient=True, no_vjp_grad=True)
def accuracy(ctx, ins, attrs):
    """The share of rows whose label is among their top-k Indices:
    Accuracy f32, Correct and Total int32, each of shape [1]."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    correct = (idx == label.reshape(-1, 1)).any(dim=1)
    total = torch.tensor([idx.shape[0]], dtype=torch.int32,
                         device=idx.device)
    num_correct = correct.sum().to(torch.int32).reshape(1)
    return {"Accuracy": [num_correct.float() / total.clamp_min(1)],
            "Correct": [num_correct], "Total": [total]}


def _auc_buckets(score, num_t):
    """(score * num_t) to int32 clipped to [0, num_t], as the JAX emitter
    buckets it: XLA's convert saturates (NaN to 0, a huge score to
    INT_MAX), so NaN lands in bucket 0 and +inf in num_t.  Here the clamp
    comes first, in floating point, and the cast after: torch's cast is
    undefined out of range."""
    v = torch.nan_to_num(score * num_t, nan=0.0, posinf=float(num_t),
                         neginf=0.0)
    return v.clamp(0, num_t).to(torch.int32).long()


def _sum64(t):
    """A sum in float64 rounded once to float32: the same on every device
    (a float32 sum's value depends on its order), and the f32 sum's own
    value wherever that one is exact (integer counts below 2**24)."""
    return t.double().sum().float()


@register("auc", stop_gradient=True, no_vjp_grad=True)
def auc(ctx, ins, attrs):
    """Streaming ROC or PR AUC (reference operators/metrics/auc_op.cc):
    the positive-class scores bucketed into ``num_thresholds`` + 1 bins,
    the batch's counts added to the stat buffers (StatPosOut /
    StatNegOut, the same vars as StatPos / StatNeg in a program, so the
    executor updates them in place), then the curve integrated by
    trapezoid from the high threshold down.  Counts are whole numbers, so
    the adds are exact in any order."""
    pred = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos = ins["StatPos"][0].reshape(-1)
    stat_neg = ins["StatNeg"][0].reshape(-1)
    num_t = int(attrs.get("num_thresholds", 4095))
    score = pred[:, -1] if pred.dim() == 2 else pred.reshape(-1)
    idx = _auc_buckets(score, num_t)
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, idx, is_pos)
    stat_neg = stat_neg.index_add(0, idx, 1 - is_pos)
    pos_rev = torch.cumsum(stat_pos.flip(0), 0)
    neg_rev = torch.cumsum(stat_neg.flip(0), 0)
    tot_pos, tot_neg = pos_rev[-1], neg_rev[-1]
    outs = {"StatPosOut": [stat_pos.reshape(ins["StatPos"][0].shape)],
            "StatNegOut": [stat_neg.reshape(ins["StatNeg"][0].shape)]}
    one = torch.ones(1, dtype=torch.float32, device=pred.device)
    if str(attrs.get("curve", "ROC")) == "PR":
        tp, fp = pos_rev.float(), neg_rev.float()
        # a vacuous precision (nothing above the threshold) counts as 1
        prec = torch.where(tp + fp > 0, tp / (tp + fp).clamp_min(1.0), 1.0)
        rec = tp / tot_pos.float().clamp_min(1.0)
        p_pts = torch.cat([one, prec])
        r_pts = torch.cat([torch.zeros_like(one), rec])
        area = _sum64((r_pts[1:] - r_pts[:-1]) * (p_pts[1:] + p_pts[:-1])
                      / 2.0)
        outs["AUC"] = [torch.where(tot_pos > 0, area, 0.0).reshape(1)]
        return outs
    x = torch.cat([torch.zeros_like(one, dtype=neg_rev.dtype), neg_rev])
    y = torch.cat([torch.zeros_like(one, dtype=pos_rev.dtype), pos_rev])
    area = _sum64((x[1:] - x[:-1]).float() * (y[1:] + y[:-1]).float()) / 2.0
    denom = (tot_pos * tot_neg).clamp_min(1).float()
    outs["AUC"] = [torch.where(tot_pos * tot_neg > 0, area / denom,
                               0.0).reshape(1)]
    return outs
