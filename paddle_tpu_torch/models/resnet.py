"""ResNet family (reference pattern: the fluid image_classification models).

Ported from the JAX package's ``models/resnet.py``: the same functions
emit the same Program (op types, attrs, parameter names) through the
port's ``fluid.layers``.  The public API takes NCHW images; the network
computes in ``cfg.layout`` (NHWC by default: one transpose at the stem,
then channels last, which the library convolution and the conv+BN
kernels take as channels_last views without copies).  Under
FLAGS_conv_bn_fusion the optimizer rewrites each conv2d -> batch_norm
[-> relu] into ``fused_conv_bn`` (``fluid/fusion_pass.py``), which runs
the conv+BN kernels of ``ops/kernels/conv_bn.py`` in training.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..fluid import layers
from ..fluid.param_attr import ParamAttr


@dataclass
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    # block counts per stage (depth 50 by default)
    blocks: List[int] = field(default_factory=lambda: [3, 4, 6, 3])
    base_filters: int = 64
    # internal compute layout; "NHWC" = channels last
    layout: str = "NHWC"
    # fold 2 x 2 input blocks into channels and train a 4 x 4 / s1 stem on
    # 12 channels instead of 7 x 7 / s2 on 3; NHWC only
    stem_space_to_depth: bool = False

    @staticmethod
    def resnet50(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(50, num_classes, [3, 4, 6, 3])

    @staticmethod
    def resnet18(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(18, num_classes, [2, 2, 2, 2])

    @staticmethod
    def resnet34(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(34, num_classes, [3, 4, 6, 3])

    @staticmethod
    def resnet101(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(101, num_classes, [3, 4, 23, 3])

    @staticmethod
    def resnet152(num_classes: int = 1000) -> "ResNetConfig":
        return ResNetConfig(152, num_classes, [3, 8, 36, 3])

    @staticmethod
    def tiny(num_classes: int = 10) -> "ResNetConfig":
        """For tests: 2 stages, 1 basic block each, 8 base filters."""
        return ResNetConfig(8, num_classes, [1, 1], base_filters=8)


def _conv_bn(x, filters, ksize, stride=1, act=None, name="", layout="NCHW",
             padding=None):
    conv = layers.conv2d(
        x, filters, ksize, stride=stride,
        padding=(ksize - 1) // 2 if padding is None else padding,
        param_attr=ParamAttr(name=f"{name}.w"), bias_attr=False,
        data_format=layout)
    return layers.batch_norm(conv, act=act,
                             param_attr=ParamAttr(name=f"{name}.bn_s"),
                             bias_attr=ParamAttr(name=f"{name}.bn_b"),
                             data_layout=layout)


def _channels(x, layout):
    return x.shape[1] if layout == "NCHW" else x.shape[-1]


def _bottleneck(x, filters, stride, name, layout):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut when needed."""
    out = _conv_bn(x, filters, 1, act="relu", name=f"{name}.c1",
                   layout=layout)
    out = _conv_bn(out, filters, 3, stride=stride, act="relu",
                   name=f"{name}.c2", layout=layout)
    out = _conv_bn(out, filters * 4, 1, name=f"{name}.c3", layout=layout)
    if stride != 1 or _channels(x, layout) != filters * 4:
        short = _conv_bn(x, filters * 4, 1, stride=stride,
                         name=f"{name}.proj", layout=layout)
    else:
        short = x
    return layers.relu(layers.elementwise_add(out, short))


def _basic_block(x, filters, stride, name, layout):
    """3x3 -> 3x3 (resnet18/34)."""
    out = _conv_bn(x, filters, 3, stride=stride, act="relu",
                   name=f"{name}.c1", layout=layout)
    out = _conv_bn(out, filters, 3, name=f"{name}.c2", layout=layout)
    if stride != 1 or _channels(x, layout) != filters:
        short = _conv_bn(x, filters, 1, stride=stride, name=f"{name}.proj",
                         layout=layout)
    else:
        short = x
    return layers.relu(layers.elementwise_add(out, short))


def resnet(cfg: ResNetConfig, images):
    """images [N, 3, H, W] -> logits [N, num_classes], computed in
    ``cfg.layout``."""
    bottleneck = cfg.depth >= 50
    layout = cfg.layout
    x = images
    if layout == "NHWC":
        x = layers.transpose(x, [0, 2, 3, 1])
    s2d = (cfg.stem_space_to_depth and layout == "NHWC"
           and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)
    if s2d:
        b, h, w, c = x.shape
        x = layers.reshape(x, [b, h // 2, 2, w // 2, 2, c])
        x = layers.transpose(x, [0, 1, 3, 2, 4, 5])
        x = layers.reshape(x, [b, h // 2, w // 2, 4 * c])
        # 4x4/s1 on the folded grid = 8x8/s2 on the original; pads (2, 1)
        # keep the output aligned with the 7x7/s2 pad-3 stem
        x = _conv_bn(x, cfg.base_filters, 4, stride=1, act="relu",
                     name="stem", layout=layout, padding=[2, 1, 2, 1])
    else:
        x = _conv_bn(x, cfg.base_filters, 7, stride=2, act="relu",
                     name="stem", layout=layout)
    x = layers.pool2d(x, 3, pool_type="max", pool_stride=2, pool_padding=1,
                      data_format=layout)
    filters = cfg.base_filters
    for stage, n_blocks in enumerate(cfg.blocks):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            block = _bottleneck if bottleneck else _basic_block
            x = block(x, filters, stride, f"s{stage}.b{b}", layout)
        filters *= 2
    x = layers.pool2d(x, 1, pool_type="avg", global_pooling=True,
                      data_format=layout)
    return layers.fc(x, cfg.num_classes, param_attr=ParamAttr(name="head.w"))


def build_resnet_train_program(cfg, batch, image_size, main_program,
                               startup_program):
    """Classification train program; returns (main, startup, feeds, loss)."""
    from ..fluid import framework

    with framework.program_guard(main_program, startup_program):
        img = layers.data("image", [batch, 3, image_size, image_size],
                          append_batch_size=False)
        label = layers.data("label", [batch, 1], dtype="int64",
                            append_batch_size=False)
        logits = resnet(cfg, img)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return main_program, startup_program, ["image", "label"], loss


def resnet_step_flops(cfg: ResNetConfig, batch: int, image_size: int) -> float:
    """fwd+bwd FLOPs (3 x the forward's conv/fc multiply-adds x 2), the
    standard accounting."""
    flops = 0.0
    h = image_size
    h = h // 2                                          # stem
    flops += 2 * (7 * 7 * 3) * cfg.base_filters * h * h
    h = h // 2                                          # max pool
    cin = cfg.base_filters
    filters = cfg.base_filters
    bottleneck = cfg.depth >= 50
    for stage, n_blocks in enumerate(cfg.blocks):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            h_out = h // stride
            if bottleneck:
                flops += 2 * cin * filters * h * h                  # 1x1
                flops += 2 * 9 * filters * filters * h_out * h_out  # 3x3
                flops += 2 * filters * filters * 4 * h_out * h_out  # 1x1
                if stride != 1 or cin != filters * 4:
                    flops += 2 * cin * filters * 4 * h_out * h_out
                cin = filters * 4
            else:
                flops += 2 * 9 * cin * filters * h_out * h_out
                flops += 2 * 9 * filters * filters * h_out * h_out
                if stride != 1 or cin != filters:
                    flops += 2 * cin * filters * h_out * h_out
                cin = filters
            h = h_out
        filters *= 2
    flops += 2 * cin * cfg.num_classes
    return 3.0 * flops * batch  # fwd (1x) + bwd (2x)

