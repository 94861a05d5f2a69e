"""Neural-net ops of the BERT path: layer_norm, lookup_table(_v2),
dropout, softmax_with_cross_entropy.

Parity surface: reference layer_norm_op.cc, lookup_table_v2_op.cc,
dropout_op.cc, softmax_with_cross_entropy_op.cc; ported from the JAX
package's ``ops/nn_ops.py``.  A last-axis affine ``layer_norm`` runs the
fused add+LN kernel (``ops/kernels/add_ln.py``) when FLAGS_use_fused_ln
is on; every other layer_norm is the plain f32-statistics composition.
"""
from __future__ import annotations

import torch

from .kernels.add_ln import fused_add_ln_fwd
from .registry import register


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
        y, m, rstd = fused_add_ln_fwd(x, None, ins["Scale"][0],
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


@register("dropout")
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


def _lookup(w, ids, padding_idx):
    out = w[ids]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


@register("lookup_table")
def lookup_table(ctx, ins, attrs):
    # v1 ids carry a trailing [, 1] dim (LoD heritage)
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [_lookup(w, ids.reshape(ids.shape[:-1]),
                            attrs.get("padding_idx", -1))]}


@register("lookup_table_v2")
def lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [_lookup(w, ids, attrs.get("padding_idx", -1))]}


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
