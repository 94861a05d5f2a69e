"""Serving predictor over a FrozenModel.

Ported from the JAX package's ``inference/predictor.py``.  Every
Predictor on one device shares one module-level Executor per device, so
the block plan of a (program, feed signature, fetch list) is computed
once for all predictors and replica threads.

Weight adoption (``adopt_weights``) replaces parameter VALUES in the
predictor's scope between runs; the next run serves the new weights.
The epoch fence around it belongs to the server's micro-batch scheduler
(``server.MicroBatcher``); a bare Predictor is single-threaded by
contract.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..fluid.executor import Executor, Scope, _to_tensor, scope_guard
from .freeze import FrozenModel

# one process-wide executor per device => one plan cache across
# predictors and replica worker threads
_shared_executors: Dict[torch.device, Executor] = {}
_shared_lock = threading.Lock()


def shared_executor(device=None) -> Executor:
    """The process-wide executor of ``device`` (None: the CUDA card)."""
    from .. import resolve_device

    dev = resolve_device(device)
    with _shared_lock:
        exe = _shared_executors.get(dev)
        if exe is None:
            exe = _shared_executors[dev] = Executor(device=dev)
        return exe


class Predictor:
    """Run a FrozenModel: feed dict in, fetch arrays out.

    device: where it runs (None: the CUDA card, or the executor's).
    Weights already on that device are shared with the FrozenModel when
    ``share_weights`` (replicas of one model); others are copied to it.
    Each predictor holds its own scope of them, and ``adopt_weights``
    replaces entries there, so an adoption never reaches the
    FrozenModel or another predictor of it."""

    def __init__(self, frozen: FrozenModel, executor: Optional[Executor] = None,
                 share_weights: bool = True, device=None):
        self.frozen = frozen
        self._exe = executor or shared_executor(device)
        dev = self._exe.device
        on_dev = all(isinstance(frozen.scope.find_var(n), torch.Tensor)
                     and frozen.scope.find_var(n).device == dev
                     for n in frozen.param_names)
        # a scope of its own either way: adopt_weights replaces entries
        # here, never in the FrozenModel's scope that other replicas read
        self._scope = Scope()
        for n in frozen.param_names:
            v = frozen.scope.find_var(n)
            self._scope.set_var(
                n, v if share_weights and on_dev else _to_tensor(v, dev))
        self.weight_epoch = 0

    @property
    def device(self) -> torch.device:
        return self._exe.device

    @property
    def feed_names(self) -> List[str]:
        return list(self.frozen.feed_names)

    @property
    def fetch_names(self) -> List[str]:
        return list(self.frozen.fetch_names)

    def run(self, feed: Dict[str, np.ndarray],
            return_numpy: bool = True) -> List[np.ndarray]:
        missing = [n for n in self.frozen.feed_names if n not in feed]
        if missing:
            raise ValueError(f"predictor feed missing inputs: {missing}")
        extra = [n for n in feed if n not in self.frozen.feed_names]
        if extra:
            raise ValueError(f"predictor feed has unknown inputs: {extra}")
        with scope_guard(self._scope):
            return self._exe.run(self.frozen.program, feed=dict(feed),
                                 fetch_list=self.frozen.fetch_names,
                                 return_numpy=return_numpy)

    def adopt_weights(self, weights: Dict[str, np.ndarray],
                      epoch: Optional[int] = None) -> int:
        """Install fresh parameter values (a weight_sync delivery).
        Unknown names are rejected loudly — a manifest drift between
        trainer and replica must never half-apply.  Returns the new
        weight epoch.  NOT thread-safe against a concurrent run()."""
        unknown = [n for n in weights if n not in self.frozen.param_names]
        if unknown:
            raise KeyError(
                f"adopt_weights: {len(unknown)} names not in the frozen "
                f"model: {unknown[:5]}")
        for n, v in weights.items():
            cur = self._scope.find_var(n)
            if cur is not None and tuple(cur.shape) != tuple(np.shape(v)):
                raise ValueError(
                    f"adopt_weights: shape mismatch for {n!r}: "
                    f"{tuple(cur.shape)} vs {np.shape(v)}")
        for n, v in weights.items():
            t = _to_tensor(v, self.device)
            cur = self._scope.find_var(n)
            if isinstance(cur, torch.Tensor) and t.dtype != cur.dtype:
                t = t.to(cur.dtype)  # e.g. a bf16 weight unpacked as f32
            self._scope.set_var(n, t)
        self.weight_epoch = (self.weight_epoch + 1 if epoch is None
                             else int(epoch))
        return self.weight_epoch
