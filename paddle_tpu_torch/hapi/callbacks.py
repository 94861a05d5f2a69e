"""hapi callbacks (reference python/paddle/incubate/hapi/callbacks.py:
Callback, ProgBarLogger, ModelCheckpoint; EarlyStopping is the one
post-1.8 addition users expect from a Keras-like API).  Ported from the
JAX package's ``hapi/callbacks.py`` (numpy only); ``ModelCheckpoint``
saves through the port's ``fluid/checkpoint.py``."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, logs: Optional[Dict] = None):
        """Return True to stop training."""
        return False

    def on_batch_begin(self, mode, step):
        pass

    def on_batch_end(self, mode, step, logs: Optional[Dict] = None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_train_begin(self):
        for c in self.callbacks:
            c.on_train_begin()

    def on_train_end(self):
        for c in self.callbacks:
            c.on_train_end()

    def on_epoch_begin(self, epoch):
        for c in self.callbacks:
            c.on_epoch_begin(epoch)

    def on_epoch_end(self, epoch, logs=None) -> bool:
        stop = False
        for c in self.callbacks:
            stop = bool(c.on_epoch_end(epoch, logs)) or stop
        return stop

    def on_batch_begin(self, mode, step):
        for c in self.callbacks:
            c.on_batch_begin(mode, step)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    """Epoch/step logging (reference callbacks.ProgBarLogger)."""

    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch):
        self._epoch = epoch
        self._steps = 0

    def on_batch_end(self, mode, step, logs=None):
        self._steps += 1
        if self.verbose > 1 and mode == "train" and step % self.log_freq == 0:
            msg = ", ".join(f"{k}: {v:.6f}" for k, v in (logs or {}).items())
            print(f"epoch {self._epoch} step {step}: {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            msg = ", ".join(
                f"{k}: {v:.6f}" for k, v in (logs or {}).items() if v is not None
            )
            print(f"epoch {epoch}: {msg}")
        return False


class ModelCheckpoint(Callback):
    """Save every `save_freq` epochs (reference callbacks.ModelCheckpoint)
    or — save_freq_unit="step" — every `save_freq` train STEPS, so a
    preemption mid-epoch costs minutes of work, not the epoch.

    keep_last_n switches the save path to the model's CheckpointManager
    (fluid/checkpoint.py): step-numbered atomic checkpoint dirs under
    save_dir with only the newest N retained, loadable with
    Model.fit(resume=...). keep_last_n=None keeps the legacy behavior
    for epoch saves (Model.save to save_dir/epoch_<n>, unbounded).

    async_save: hand serialization + commit to the manager's background
    writer so the step loop only pays the snapshot cost (None = the
    manager's default, i.e. PADDLE_CKPT_ASYNC). on_train_end drains any
    queued/in-flight write, so a finished fit leaves its checkpoints on
    disk either way."""

    def __init__(self, save_freq=1, save_dir="checkpoints",
                 save_freq_unit="epoch", keep_last_n=None,
                 async_save=None):
        if save_freq_unit not in ("epoch", "step"):
            raise ValueError(
                f"save_freq_unit must be 'epoch' or 'step', got "
                f"{save_freq_unit!r}")
        if save_freq_unit == "step" and keep_last_n is None:
            keep_last_n = 3  # unbounded step snapshots would fill disk
        self.save_freq = int(save_freq)
        self.save_dir = save_dir
        self.save_freq_unit = save_freq_unit
        self.keep_last_n = keep_last_n
        self.async_save = async_save
        self._gstep = 0
        self._epoch = 0

    def _manager(self):
        return self.model._checkpoint_manager(
            self.save_dir, keep_last_n=self.keep_last_n or 3)

    def on_epoch_begin(self, epoch):
        self._epoch = epoch

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train":
            return
        self._gstep += 1
        if (self.save_freq_unit == "step"
                and self._gstep % self.save_freq == 0):
            self._manager().save(
                self._gstep,
                extra_state={"epoch": self._epoch,
                             "global_step": self._gstep},
                async_=self.async_save)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_freq_unit == "epoch" and (epoch + 1) % self.save_freq == 0:
            if self.keep_last_n is not None:
                self._manager().save(
                    self._gstep,
                    extra_state={"epoch": epoch + 1,
                                 "global_step": self._gstep},
                    async_=self.async_save)
            else:
                import os

                self.model.save(os.path.join(self.save_dir, f"epoch_{epoch}"))
        return False

    def on_train_end(self):
        if self.keep_last_n is not None and getattr(self, "model", None):
            # a finished fit leaves its checkpoints ON DISK: drain any
            # queued/in-flight async write (and surface its failure)
            self._manager().drain()


class MetricsLogger(Callback):
    """Emit hapi training metrics through the port's telemetry layer
    (paddle_tpu_torch.telemetry): one registry / JSONL code path.

    Registry series (always cheap, scrapeable via
    telemetry.to_prometheus()):
      hapi_train_batches_total   counter
      hapi_train_loss            gauge (last batch loss)
      hapi_batch_ms              histogram (on_batch_begin..end wall)
      hapi_epochs_total          counter
    JSONL (only when PADDLE_METRICS_PATH is set): one kind="train_epoch"
    record per epoch with the epoch logs (loss, val_* ...).

    Model.fit appends one automatically when the telemetry sink is
    active and the callback list doesn't already carry one."""

    def __init__(self):
        self._t0 = None

    def on_batch_begin(self, mode, step):
        if mode == "train":
            import time

            self._t0 = time.perf_counter()

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train":
            return
        import time

        from .. import telemetry

        reg = telemetry.get_registry()
        reg.counter("hapi_train_batches_total").inc()
        if self._t0 is not None:
            reg.histogram("hapi_batch_ms",
                          help="fit() train batch wall time").observe(
                (time.perf_counter() - self._t0) * 1e3)
            self._t0 = None
        loss = (logs or {}).get("loss")
        if loss is not None:
            reg.gauge("hapi_train_loss").set(float(loss))

    def on_epoch_end(self, epoch, logs=None):
        from .. import telemetry

        telemetry.get_registry().counter("hapi_epochs_total").inc()
        rec = {"kind": "train_epoch", "epoch": int(epoch)}
        for k, v in (logs or {}).items():
            if v is not None:
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    pass
        telemetry.emit(rec)
        return False


class EarlyStopping(Callback):
    def __init__(self, monitor="val_loss", patience=3, min_delta=0.0,
                 mode="min"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return False
        score = self.sign * float(val)
        if score < self.best - self.min_delta:
            self.best = score
            self.wait = 0
            return False
        self.wait += 1
        return self.wait > self.patience
