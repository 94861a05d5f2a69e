"""Graph-level operator fusion over a Program: conv+BN(+ReLU).

Ported from the JAX package's ``fluid/fusion_pass.py``.  The pass walks a
block's op list and rewrites

    conv2d -> batch_norm [-> relu]

into one ``fused_conv_bn`` op when the intermediate activations have no
other consumer, BEFORE append_backward runs, so the synthesized grad op
differentiates the fused op (its emitter runs the conv+BN kernels,
``ops/kernels/conv_bn.py``, whose autograd Function holds the fused
backward).  The fused emitter reproduces the unfused chain's math (f32
one-pass moments, running-statistic update, ReLU).  Grouped or dilated
convs, mismatched layouts and shared intermediates are left alone;
``is_test`` BNs are rewritten too, and the emitter folds them into the
conv weights.

Under FLAGS_program_verify the rewrite runs pass-sandwiched
(``fluid/analysis``): the program is verified before and after, and an
error finding the pass introduced raises attributed to it.
"""
from __future__ import annotations

from typing import List

from . import framework
from .flags import flag


def _consumer_indices(block, name: str) -> List[int]:
    return [idx for idx, op in enumerate(block.ops)
            if name in op.input_names()]


def _fusable_conv(op) -> bool:
    return (op.type == "conv2d" and int(op.attr("groups", 1)) == 1
            and tuple(op.attr("dilations", [1, 1])) == (1, 1))


def _exclusive_intermediate(block, name: str, consumer_idx: int) -> bool:
    """True when ``name`` is a plain temporary read only by
    ops[consumer_idx]."""
    v = block._find_var_recursive(name)
    if v is None or v.persistable or v.is_data:
        return False
    return _consumer_indices(block, name) == [consumer_idx]


def _try_fuse_at(block, i) -> bool:
    conv = block.ops[i]
    if not _fusable_conv(conv):
        return False
    conv_out = conv.output("Output")
    if len(conv_out) != 1:
        return False
    conv_out = conv_out[0]
    users = _consumer_indices(block, conv_out)
    if len(users) != 1:
        return False
    j = users[0]
    bn = block.ops[j]
    if bn.type != "batch_norm" or bn.input("X") != [conv_out]:
        return False
    if not _exclusive_intermediate(block, conv_out, j):
        return False
    if bn.attr("data_layout", "NCHW") != conv.attr("data_format", "NCHW"):
        return False

    y = bn.output("Y")[0]
    relu_idx = None
    out_name = y
    yusers = _consumer_indices(block, y)
    if (len(yusers) == 1 and block.ops[yusers[0]].type == "relu"
            and block.ops[yusers[0]].input("X") == [y]
            and _exclusive_intermediate(block, y, yusers[0])):
        relu_idx = yusers[0]
        out_name = block.ops[relu_idx].output("Out")[0]

    attrs = {
        "strides": list(conv.attr("strides", [1, 1])),
        "paddings": list(conv.attr("paddings", [0, 0])),
        "dilations": list(conv.attr("dilations", [1, 1])),
        "groups": int(conv.attr("groups", 1)),
        "padding_algorithm": conv.attr("padding_algorithm", "EXPLICIT"),
        "data_format": conv.attr("data_format", "NCHW"),
        "epsilon": bn.attr("epsilon", 1e-5),
        "momentum": bn.attr("momentum", 0.9),
        "is_test": bn.attr("is_test", False),
        "use_global_stats": bn.attr("use_global_stats", False),
        "with_relu": relu_idx is not None,
    }
    dev = conv.attr("op_device")
    if dev is not None:
        attrs["op_device"] = dev

    fused = framework.Operator(
        block, "fused_conv_bn",
        inputs={"Input": list(conv.input("Input")),
                "Filter": list(conv.input("Filter")),
                "Scale": list(bn.input("Scale")),
                "Bias": list(bn.input("Bias")),
                "Mean": list(bn.input("Mean")),
                "Variance": list(bn.input("Variance"))},
        outputs={"Y": [out_name],
                 "MeanOut": list(bn.output("MeanOut")),
                 "VarianceOut": list(bn.output("VarianceOut")),
                 "SavedMean": list(bn.output("SavedMean")),
                 "SavedVariance": list(bn.output("SavedVariance"))},
        attrs=attrs,
    )
    for idx in sorted((k for k in (i, j, relu_idx) if k is not None),
                      reverse=True):
        del block.ops[idx]
    block.ops.insert(i, fused)
    for n in fused.output_names():
        v = block._find_var_recursive(n)
        if v is not None:
            v.op = fused
    # the exclusive intermediates the deleted ops produced (the conv
    # output, and the BN's Y when the ReLU folded in) have neither
    # producer nor consumer now
    block.vars.pop(conv_out, None)
    if relu_idx is not None:
        block.vars.pop(y, None)
    block.program._bump_version()
    return True


def apply_conv_bn_fusion(program) -> int:
    """Fuse every conv2d -> batch_norm [-> relu] triple in ``program``;
    returns the number of fusions.  Unconditional (an explicit call
    states intent); training goes through ``maybe_apply_conv_bn_fusion``,
    which honours FLAGS_conv_bn_fusion."""
    from .analysis import pass_sandwich

    fused = 0
    with pass_sandwich(program, "conv_bn_fusion"):
        for block in program.blocks:
            i = 0
            while i < len(block.ops):
                if _try_fuse_at(block, i):
                    fused += 1
                i += 1
    return fused


def maybe_apply_conv_bn_fusion(program) -> int:
    """The flag-gated entry of Optimizer.backward and the AMP decorator: no
    rewrite unless FLAGS_conv_bn_fusion is set."""
    if not flag("FLAGS_conv_bn_fusion"):
        return 0
    return apply_conv_bn_fusion(program)
