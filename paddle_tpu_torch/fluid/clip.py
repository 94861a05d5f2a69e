"""Gradient clipping. Parity: python/paddle/fluid/clip.py
(GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm);
ported from the JAX package's ``fluid/clip.py`` without its
FLAGS_tensor_stats global-norm stat (the numerics hooks, ROADMAP §C)."""
from __future__ import annotations

import numpy as np

from . import framework


class GradientClipBase:
    def _process(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._process(params_grads)


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            block = g.block
            c = block.create_var(name=g.name + "@CLIP", dtype=g.dtype, shape=g.shape)
            block.append_op(
                type="clip",
                inputs={"X": [g]},
                outputs={"Out": [c]},
                attrs={"min": self.min, "max": self.max},
            )
            out.append((p, c))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            block = g.block
            # clip_by_norm derives the norm internally (ops/math_ops.py)
            c = block.create_var(name=g.name + "@CLIP", dtype=g.dtype, shape=g.shape)
            block.append_op(
                type="clip_by_norm",
                inputs={"X": [g]},
                outputs={"Out": [c]},
                attrs={"max_norm": self.clip_norm},
            )
            out.append((p, c))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        block = None
        sq_norms = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                continue
            block = g.block
            n = block.create_var(name=g.name + "@SQN", dtype=g.dtype, shape=(1,))
            block.append_op(
                type="squared_l2_norm", inputs={"X": [g]}, outputs={"Out": [n]}
            )
            sq_norms.append(n)
        if not sq_norms:
            return params_grads
        total = block.create_var(name=f"@GLOBAL_NORM@{self.group_name}", shape=(1,))
        block.append_op(
            type="sum", inputs={"X": sq_norms}, outputs={"Out": [total]}
        )
        gnorm = block.create_var(name=f"@GLOBAL_NORM_SQRT@{self.group_name}", shape=(1,))
        block.append_op(type="sqrt", inputs={"X": [total]}, outputs={"Out": [gnorm]})
        # scale = clip_norm / max(global_norm, clip_norm)
        denom = block.create_var(name=f"@GN_DENOM@{self.group_name}", shape=(1,))
        block.append_op(
            type="clip",
            inputs={"X": [gnorm]},
            outputs={"Out": [denom]},
            attrs={"min": self.clip_norm, "max": float(np.finfo(np.float32).max)},
        )
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            scaled_num = g.block.create_var(name=g.name + "@GCLIP_NUM", dtype=g.dtype, shape=g.shape)
            g.block.append_op(
                type="scale",
                inputs={"X": [g]},
                outputs={"Out": [scaled_num]},
                attrs={"scale": self.clip_norm},
            )
            c = g.block.create_var(name=g.name + "@GCLIP", dtype=g.dtype, shape=g.shape)
            g.block.append_op(
                type="elementwise_div",
                inputs={"X": [scaled_num], "Y": [denom]},
                outputs={"Out": [c]},
            )
            out.append((p, c))
        return out


# paddle 1.x aliases
ErrorClipByValue = GradientClipByValue


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or framework.default_main_program()
    program._grad_clip = clip
