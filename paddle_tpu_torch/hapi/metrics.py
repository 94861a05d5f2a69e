"""hapi metrics (reference python/paddle/incubate/hapi/metrics.py:
Metric base + Accuracy); the JAX package's ``hapi/metrics.py`` as it is
(numpy only)."""
from __future__ import annotations

import numpy as np


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError


class Accuracy(Metric):
    """Top-k accuracy over (pred_logits, label) batches."""

    def __init__(self, topk=1, name="acc"):
        self.topk = topk
        self._name = name
        self.reset()

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, pred, label, *rest):
        pred = np.asarray(pred)
        label = np.asarray(label).reshape(-1)
        idx = np.argsort(-pred, axis=-1)[:, : self.topk]
        self.correct += int((idx == label[:, None]).any(axis=1).sum())
        self.total += label.shape[0]

    def accumulate(self):
        return self.correct / max(self.total, 1)

    def name(self):
        return self._name
