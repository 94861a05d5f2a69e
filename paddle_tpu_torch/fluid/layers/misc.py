"""Miscellaneous layers: add_position_encoding (the hapi Transformer
NMT's), sum, shard_index, the random tensors, the static rank / size /
emptiness constants, scatter_nd, the step counter and the streaming
``auc`` metric.

Parity surface: python/paddle/fluid/layers/nn.py + tensor.py entries in
the reference; ported from the JAX package's ``fluid/layers/misc.py``.
The rest of that file waits on op types the port does not register yet
(selu, brelu, multiplex, unique, hash, sampling_id, chunk_eval, ...:
ROADMAP A10).
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from . import nn as _nn
from . import tensor as _tensor

__all__ = [
    "add_position_encoding", "sum", "shard_index", "gaussian_random",
    "uniform_random", "gaussian_random_batch_size_like",
    "uniform_random_batch_size_like", "rank", "size", "is_empty",
    "scatter_nd", "autoincreased_step_counter", "auc",
]


def add_position_encoding(input, alpha, beta, name=None):
    """x * alpha + beta * the sinusoid position encoding of [T, d]
    (reference add_position_encoding_op.cc), emitted as a constant table
    (``assign``), a broadcast (``expand_as``) and elementwise ops."""
    b, t, d = input.shape
    half = d // 2
    pos = np.arange(t, dtype=np.float32)[:, None]
    inv = 1.0 / np.power(10000.0, np.arange(half, dtype=np.float32) / half)
    table = np.zeros((t, d), np.float32)
    table[:, :half] = np.sin(pos * inv[None, :])
    table[:, half:2 * half] = np.cos(pos * inv[None, :])
    enc = _tensor.assign(table)
    enc3 = _nn.reshape(enc, [1, t, d])
    return _nn.elementwise_add(
        _nn.scale(input, scale=float(alpha)),
        _nn.scale(_nn.expand_as(enc3, input), scale=float(beta)),
    )


def rank(input):
    """The static rank as a constant tensor (reference rank)."""
    return _tensor.fill_constant([1], "int32", len(input.shape))


def size(input):
    """The static element count as a constant tensor (reference size)."""
    return _tensor.fill_constant([1], "int64", int(np.prod(input.shape)))


def sum(x):
    """Elementwise sum of a tensor list (reference sum op layer)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum")
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(xs)},
                     outputs={"Out": [out]})
    return out


def scatter_nd(index, updates, shape, name=None):
    """scatter_nd_add onto zeros (the reference defines it so)."""
    zeros = _tensor.fill_constant(list(shape), updates.dtype, 0.0)
    return _nn.scatter_nd_add(zeros, index, updates)


def is_empty(x, cond=None):
    """Static emptiness as a constant bool (shapes are static)."""
    out = _tensor.fill_constant([1], "bool", int(np.prod(x.shape)) == 0)
    if cond is not None:
        _tensor.assign(out, output=cond)
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="shard_index", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"index_num": index_num, "nshards": nshards,
                            "shard_id": shard_id,
                            "ignore_value": ignore_value})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": seed, "dtype": dtype})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "seed": seed, "dtype": dtype})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return gaussian_random(shape, mean, std, seed, dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return uniform_random(shape, dtype, min, max, seed)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int32 step counter incremented every run (reference
    layers/nn.py autoincreased_step_counter)."""
    from ..framework import default_main_program
    from ..optimizer import _create_persistable_var

    name = counter_name or "@STEP_COUNTER@"
    mb = default_main_program().global_block()
    if name in mb.vars:
        counter = mb.var(name)
    else:
        counter = _create_persistable_var(name, (1,), "int32",
                                          float(begin - 1))
    helper = LayerHelper("increment")
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]}, attrs={"step": float(step)})
    return counter


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Streaming ROC or PR AUC (reference layers/metric_op.py auc over
    metrics/auc_op.cc): two persistable [num_thresholds + 1] f32 stat
    buffers, the op's StatPosOut / StatNegOut written back into them, so
    the counts accumulate across runs.  Returns (auc, [stat_pos,
    stat_neg])."""
    from ..optimizer import _create_persistable_var

    nt = int(num_thresholds)
    stat_pos = _create_persistable_var(
        f"auc_stat_pos_{unique_suffix()}", (nt + 1,), "float32", 0.0)
    stat_neg = _create_persistable_var(
        f"auc_stat_neg_{unique_suffix()}", (nt + 1,), "float32", 0.0)
    helper = LayerHelper("auc")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": nt, "curve": curve},
    )
    return out, [stat_pos, stat_neg]


# the stat buffers' name suffixes, one process-wide counter (as the JAX
# package's: not reset by unique_name.guard)
_suffix_counter = [0]


def unique_suffix():
    _suffix_counter[0] += 1
    return _suffix_counter[0]
