"""Allreduced scalar metric helpers on the fleet namespace.

Ported from the JAX package's ``fleet/metrics/__init__.py`` (parity
surface: reference python/paddle/fleet/metrics/metric.py): each helper
resolves a host value (numpy array, program Variable, or scope var name),
allreduces it across the trainer processes, and returns the global
metric.  The transport is ``torch.distributed``'s object all-gather over
the job's process group (gloo or NCCL, as ``init_parallel_env`` chose it);
a process without a process group is the identity, so the same training
script works launched or not.

Accumulator convention (identical to the reference examples): the model
keeps float32 running stats in persistable vars (correct/total counts,
AUC bucket stats from layers.auc); after train/infer the training script calls
these helpers on the fetched numpy values.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]

_py_sum, _py_max, _py_min = sum, max, min


def _resolve(value, scope):
    """numpy array | fluid Variable | scope var name -> numpy array."""
    from ...fluid import executor, framework

    if isinstance(value, framework.Variable):
        value = value.name
    if isinstance(value, str):
        scope = scope if scope is not None else executor.global_scope()
        found = scope.find_var(value)
        if found is None:
            raise KeyError(f"fleet.metrics: no var {value!r} in scope")
        value = found
    if hasattr(value, "detach"):  # a torch tensor from the scope
        value = value.detach().cpu().float().numpy()
    return np.asarray(value, np.float64)


def _all_reduce(arr: np.ndarray, mode: str = "sum") -> np.ndarray:
    """Cross-process host allreduce (reference _role_maker._all_reduce).
    Single process: identity. Multi process: gather every rank's array,
    reduce in numpy in rank order (float64 — metric counters must not
    lose integer precision the way an f32 sum would)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return arr.copy()
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, arr.astype(np.float64))
    stacked = np.stack(parts)
    if mode == "sum":
        return stacked.sum(axis=0)
    if mode == "max":
        return stacked.max(axis=0)
    if mode == "min":
        return stacked.min(axis=0)
    raise ValueError(f"unknown allreduce mode {mode!r}")


def sum(input, scope=None):  # noqa: A001 — reference name
    """Distributed elementwise sum (reference metric.py:23)."""
    return _all_reduce(_resolve(input, scope), "sum")


def max(input, scope=None):  # noqa: A001
    """Distributed elementwise max (reference metric.py:62)."""
    return _all_reduce(_resolve(input, scope), "max")


def min(input, scope=None):  # noqa: A001
    """Distributed elementwise min (reference metric.py:101)."""
    return _all_reduce(_resolve(input, scope), "min")


def auc(stat_pos, stat_neg, scope=None):
    """Distributed AUC from per-trainer threshold-bucket stats
    (reference metric.py:140): allreduce-sum the positive/negative
    bucket counters produced by layers.auc, then integrate the ROC
    trapezoids over the global buckets, high threshold to low."""
    pos = _all_reduce(_resolve(stat_pos, scope).reshape(-1), "sum")
    neg = _all_reduce(_resolve(stat_neg, scope).reshape(-1), "sum")
    # integrate from the top bucket down (descending threshold)
    pos_cum = np.cumsum(pos[::-1])
    neg_cum = np.cumsum(neg[::-1])
    tot_pos, tot_neg = pos_cum[-1], neg_cum[-1]
    if tot_pos * tot_neg == 0 or (tot_pos + tot_neg) == 0:
        return 0.5
    new_neg = neg_cum
    old_neg = np.concatenate([[0.0], neg_cum[:-1]])
    new_pos = pos_cum
    old_pos = np.concatenate([[0.0], pos_cum[:-1]])
    area = np.sum((new_neg - old_neg) * (old_pos + new_pos) / 2.0)
    return float(area / (tot_pos * tot_neg))


def mae(abserr, total_ins_num, scope=None):
    """Distributed mean absolute error (reference metric.py:223)."""
    g = _all_reduce(_resolve(abserr, scope).reshape(-1), "sum")
    return float(g[0] / total_ins_num)


def rmse(sqrerr, total_ins_num, scope=None):
    """Distributed root mean squared error (reference metric.py:261)."""
    g = _all_reduce(_resolve(sqrerr, scope).reshape(-1), "sum")
    return float(math.sqrt(g[0] / total_ins_num))


def mse(sqrerr, total_ins_num, scope=None):
    """Distributed mean squared error (reference metric.py:299)."""
    g = _all_reduce(_resolve(sqrerr, scope).reshape(-1), "sum")
    return float(g[0] / total_ins_num)


def acc(correct, total, scope=None):
    """Distributed accuracy: sum(correct)/sum(total) over trainers
    (reference metric.py:337)."""
    c = _all_reduce(_resolve(correct, scope).reshape(-1), "sum")
    t = _all_reduce(_resolve(total, scope).reshape(-1), "sum")
    return float(c[0] / t[0])
