"""hapi: the Keras-like high-level API (`Model.fit/evaluate/predict`) and
the NLP building blocks of ``hapi.text``.

Parity surface: reference python/paddle/incubate/hapi/model.py
(Model:664, prepare:1062, fit:1119, evaluate:1320, predict:1417,
Input:50, StaticGraphAdapter:84); ported from the JAX package's
``hapi``.  One static Program per mode (train/eval/test) is built from a
user network callable over symbolic inputs and run by the port's
Executor on the model's device (the CUDA card unless ``device="cpu"``).
``fit(checkpoint_dir=..., resume=...)`` checkpoints through
``fluid/checkpoint.py`` and resumes with a bit-identical loss trace;
``fit(reshard=...)`` (or PADDLE_ELASTIC_RESHARD) resumes a checkpoint
written at another world size, as the launcher's elastic resize asks.

``hapi.text`` holds the text-CNN encoder (``Conv1dPoolLayer``,
``CNNEncoder``) and the transformer blocks (``MultiHeadAttention``,
``FFN``, ``PrePostProcessLayer``, ``TransformerEncoder``,
``TransformerDecoder``).  Not ported yet: ``hapi.datasets`` and
``hapi.vision`` (ROADMAP A9); the RNN cells and runners,
``TransformerCell``, beam search and ``DynamicDecode``, which wait on
the control-flow ops (ROADMAP A10, then A9); the CRF (ROADMAP A9); the
numerics guards (FLAGS_check_numerics, ROADMAP A8) raise where they are
asked for.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import fluid
from ..fluid import layers
from . import callbacks as callbacks_mod
from .callbacks import Callback, EarlyStopping, ModelCheckpoint, ProgBarLogger  # noqa: F401
from .metrics import Accuracy, Metric  # noqa: F401
from . import text  # noqa: F401

__all__ = [
    "Input", "Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
    "EarlyStopping", "Metric", "Accuracy",
]


class Input:
    """Symbolic input spec (reference hapi Input:50)."""

    def __init__(self, name, shape=None, dtype="float32"):
        self.name = name
        self.shape = list(shape or [])
        self.dtype = dtype


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


# op types whose semantics switch on the is_test attr (the set the
# reference's Program.clone(for_test=True) _inference_optimize flips)
_TEST_MODE_OPS = {
    "dropout", "batch_norm", "fused_multihead_attention",
    "fused_encoder_stack", "fused_decoder_stack", "instance_norm",
}


def _flip_to_test_mode(program):
    """Eval/test programs run inference semantics: dropout off, batch_norm
    on the running statistics (reference StaticGraphAdapter builds eval
    programs via clone(for_test=True))."""
    for block in program.blocks:
        for op in block.ops:
            if op.type in _TEST_MODE_OPS:
                op._set_attr("is_test", True)


def _feed_value(v):
    """A batch column as the executor takes it: a tensor stays as it is
    (one already on the card makes no host round trip)."""
    return v if isinstance(v, torch.Tensor) else np.asarray(v)


class Model:
    """Static-graph Model (reference hapi Model:664).

    network: callable taking the input Variables (not labels) and
    returning the output Variable(s). inputs/labels: Input specs.
    device: where the programs run (None: the CUDA card).
    """

    def __init__(self, network: Callable, inputs, labels=None, device=None):
        self._network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        if not self._inputs:
            raise ValueError("Model needs at least one Input spec")
        self._optimizer = None
        self._loss_function = None
        self._metrics: List[Metric] = []
        self._progs: Dict[str, tuple] = {}
        self._exe = fluid.Executor(device=device)
        self._scope = fluid.executor.Scope()
        self._prepared = False

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss_function=None, metrics=None):
        self._optimizer = optimizer
        self._loss_function = loss_function
        self._metrics = _to_list(metrics)
        startup = fluid.Program()
        for mode in ("train", "eval", "test"):
            if mode == "train" and (optimizer is None or loss_function is None):
                continue
            if mode == "eval" and loss_function is None:
                continue
            self._progs[mode] = self._build_program(mode, startup)
        self._startup = startup
        from ..fluid.flags import flag

        if flag("FLAGS_program_verify"):
            # cross-program lint of the clone family (fluid/analysis/
            # crosscheck.py): startup must initialize every persistable
            # the train program reads, and the eval/test clones must
            # share Parameters by name, run is_test semantics, and carry
            # no optimizer/@GRAD ops. A violated clone contract raises
            # HERE, naming the layer, not as a wrong number mid-fit.
            from ..fluid.analysis import assert_pair_valid

            train = self._progs.get("train")
            for mode in ("eval", "test"):
                if mode not in self._progs:
                    continue
                clone, feed_names = self._progs[mode][0], self._progs[mode][1]
                assert_pair_valid(
                    clone, startup=startup,
                    feed_names=feed_names,
                    where=f"Model.prepare {mode} clone "
                          f"(FLAGS_program_verify)")
                if train is not None:
                    assert_pair_valid(
                        train[0], eval_program=clone,
                        where=f"Model.prepare train/{mode} pair "
                              f"(FLAGS_program_verify)")
            if train is not None:
                assert_pair_valid(
                    train[0], startup=startup, feed_names=train[1],
                    where="Model.prepare train (FLAGS_program_verify)")
        with fluid.scope_guard(self._scope):
            self._exe.run(startup)
        self._prepared = True
        return self

    def _build_program(self, mode, startup):
        from ..fluid import unique_name

        main = fluid.Program()
        # every mode rebuilds the same network: reset the name generator so
        # parameters share names (and therefore scope storage) across the
        # train/eval/test programs — reference StaticGraphAdapter._make_program
        with unique_name.guard(), fluid.program_guard(main, startup):
            in_vars = [
                layers.data(i.name, i.shape, dtype=i.dtype, append_batch_size=False)
                for i in self._inputs
            ]
            lbl_vars = [
                layers.data(l.name, l.shape, dtype=l.dtype, append_batch_size=False)
                for l in self._labels
            ] if mode != "test" else []
            outs = _to_list(self._network(*in_vars))
            fetches = list(outs)
            loss_var = None
            if mode in ("train", "eval") and self._loss_function is not None:
                loss_var = self._loss_function(*(outs + lbl_vars))
                if isinstance(loss_var, (list, tuple)):
                    loss_var = loss_var[0]
                if tuple(loss_var.shape or ()) not in ((), (1,)):
                    loss_var = layers.mean(loss_var)
                fetches = [loss_var] + fetches
            if mode == "train":
                self._optimizer.minimize(loss_var)
        if mode != "train":
            _flip_to_test_mode(main)
        feed_names = [i.name for i in self._inputs] + (
            [l.name for l in self._labels] if mode != "test" else []
        )
        return main, feed_names, fetches, loss_var

    # ------------------------------------------------------------------
    def _run_batch(self, mode, inputs, labels=None):
        if not self._prepared:
            raise RuntimeError("call prepare() first")
        main, feed_names, fetches, loss_var = self._progs[mode]
        vals = _to_list(inputs) + _to_list(labels)
        feed = {n: _feed_value(v) for n, v in zip(feed_names, vals)}
        with fluid.scope_guard(self._scope):
            return self._exe.run(main, feed=feed, fetch_list=fetches)

    def train_batch(self, inputs, labels=None):
        return self._run_batch("train", inputs, labels)

    def eval_batch(self, inputs, labels=None):
        return self._run_batch("eval", inputs, labels)

    def test_batch(self, inputs):
        return self._run_batch("test", inputs)

    # ------------------------------------------------------------------
    @staticmethod
    def _materialize(data):
        """Resolve data ONCE per fit/evaluate/predict call: a reader
        creator (callable returning a sample generator) or a one-shot
        iterator of prepared batches is consumed a single time, so
        multi-epoch fit never re-iterates or exhausts it."""
        if callable(data):
            samples = list(data())
            if not samples:
                raise ValueError("empty dataset")
            return [
                np.asarray([s[i] for s in samples]) for i in range(len(samples[0]))
            ]
        data = list(data)
        if not data:
            raise ValueError("empty dataset")
        return data

    @staticmethod
    def _batches(data, batch_size, shuffle, seed):
        """data: output of _materialize — full column arrays or a list of
        prepared batches. Returns a list of per-batch array lists."""
        if all(isinstance(a, np.ndarray) for a in data):
            n = data[0].shape[0]
            idx = np.arange(n)
            if shuffle:
                np.random.RandomState(seed).shuffle(idx)
            out = []
            for s in range(0, n - n % batch_size or n, batch_size):
                sel = idx[s: s + batch_size]
                if len(sel) < batch_size:
                    break
                out.append([a[sel] for a in data])
            return out
        return data  # already a list of batches

    def _checkpoint_manager(self, dirname, keep_last_n=3):
        """One CheckpointManager per checkpoint root, bound to the train
        program, this model's scope and its device (shared by
        fit(resume=...) and the step-frequency ModelCheckpoint
        callback)."""
        from ..fluid import checkpoint as ckpt_mod

        if not self._prepared:
            raise RuntimeError("call prepare() first")
        key = os.path.abspath(dirname)
        mgrs = getattr(self, "_ckpt_mgrs", None)
        if mgrs is None:
            mgrs = self._ckpt_mgrs = {}
        if key not in mgrs:
            mode = "train" if "train" in self._progs else \
                next(iter(self._progs))
            mgrs[key] = ckpt_mod.CheckpointManager(
                dirname, keep_last_n=keep_last_n,
                program=self._progs[mode][0], scope=self._scope,
                device=self._exe.device)
        return mgrs[key]

    def fit(
        self,
        train_data,
        eval_data=None,
        batch_size=32,
        epochs=1,
        eval_freq=1,
        log_freq=10,
        save_dir=None,
        save_freq=1,
        verbose=2,
        shuffle=True,
        callbacks=None,
        checkpoint_dir=None,
        checkpoint_freq=0,
        checkpoint_keep=3,
        resume=False,
        reshard=None,
    ):
        """reference hapi fit:1119, plus the preemption-safe layer
        (fluid/checkpoint.py):

        checkpoint_dir   arm a CheckpointManager there; every
                         `checkpoint_freq` train steps (0 = only on
                         preemption) the FULL training state — params,
                         optimizer moments, AMP state, the step seed,
                         (epoch, step) position, loss history — is
                         committed atomically with checkpoint_keep
                         retained.
        resume           True: restore the newest VALID checkpoint from
                         checkpoint_dir and continue mid-epoch with a
                         bit-identical loss trace (a torn latest
                         checkpoint falls back to the previous one). A
                         path string doubles as checkpoint_dir. Empty
                         dir = fresh start.
        SIGTERM          (or checkpoint.request_preemption()) is honored
                         at the next step boundary: final checkpoint,
                         then checkpoint.Preempted is raised — exit with
                         checkpoint.PREEMPTED_EXIT_CODE so a supervisor
                         respawns + auto-resumes.
        reshard          elastic resume across a world-size change
                         (launcher resize): None defaults to
                         PADDLE_ELASTIC_RESHARD. False (and env unset):
                         a checkpoint from a different world size is
                         REFUSED (checkpoint.WorldSizeMismatchError).
                         True: resume proceeds and the mid-epoch
                         position is re-split — the per-rank step is
                         scaled by old_world/new_world so the global
                         sample offset carries over (exact when the
                         global batch divides both world sizes).

        FLAGS_check_numerics (the JAX package's bad-step skip and
        rollback) raises: the port's executor has no numerics guard yet
        (ROADMAP A8).
        """
        from ..fluid import checkpoint as ckpt_mod
        from ..fluid.flags import flag

        if flag("FLAGS_check_numerics"):
            raise NotImplementedError(
                "Model.fit under FLAGS_check_numerics: the bad-step guard "
                "waits for the executor's numerics guards (ROADMAP A8)")
        if isinstance(resume, str):
            checkpoint_dir = checkpoint_dir or resume
        mgr = (self._checkpoint_manager(checkpoint_dir, checkpoint_keep)
               if checkpoint_dir else None)
        if mgr is not None:
            ckpt_mod.install_preemption_handler()

        cb_list = (_to_list(callbacks)
                   or ([ProgBarLogger(log_freq, verbose=verbose)]
                       if verbose else []))
        from .. import telemetry

        if telemetry.enabled() and not any(
                isinstance(c, callbacks_mod.MetricsLogger) for c in cb_list):
            # PADDLE_METRICS_PATH armed the sink: fit reports through the
            # same registry/JSONL path as the executor
            cb_list = list(cb_list) + [callbacks_mod.MetricsLogger()]
        cbks = callbacks_mod.CallbackList(cb_list)
        cbks.set_model(self)
        cbks.on_train_begin()
        history = {"loss": []}
        train_data = self._materialize(train_data)
        if eval_data is not None:
            eval_data = self._materialize(eval_data)

        epoch, resume_step, pending_losses, global_step = 0, 0, [], 0
        if mgr is not None and resume:
            st = mgr.restore(allow_reshard=reshard)
            if st is not None:
                ex = st["extra"]
                epoch = int(ex.get("epoch", 0))
                resume_step = int(ex.get("step", 0))
                pending_losses = list(ex.get("epoch_losses", []))
                history = {k: list(v)
                           for k, v in ex.get("history", history).items()}
                global_step = int(ex.get("global_step", 0))
                ckpt_ws = st.get("world_size")
                if (ckpt_ws and mgr.world_size
                        and int(ckpt_ws) != int(mgr.world_size)):
                    # elastic resize: preserve the GLOBAL sample offset
                    # by scaling the per-rank position; the per-rank
                    # loss history from the old split is not comparable
                    # to the new shard, so the epoch restarts its
                    # running-mean bookkeeping at the re-split point
                    import warnings as _warnings

                    scaled = (resume_step * int(ckpt_ws)) // int(
                        mgr.world_size)
                    if (resume_step * int(ckpt_ws)) % int(mgr.world_size):
                        _warnings.warn(
                            f"elastic resume: per-rank step "
                            f"{resume_step}x{ckpt_ws} does not divide "
                            f"the new world {mgr.world_size}; rounding "
                            f"the resume position down", RuntimeWarning,
                            stacklevel=2)
                    _warnings.warn(
                        f"elastic resume: checkpoint world size "
                        f"{ckpt_ws} -> {mgr.world_size}; resuming epoch "
                        f"{epoch} at re-split step {scaled} (was "
                        f"{resume_step})", RuntimeWarning, stacklevel=2)
                    resume_step = scaled
                    pending_losses = []

        def _position(step, losses):
            return {"epoch": epoch, "step": step,
                    "epoch_losses": list(losses),
                    "history": {k: list(v) for k, v in history.items()},
                    "global_step": global_step}

        n_in = len(self._inputs)
        stop = False
        while epoch < epochs and not stop:
            cbks.on_epoch_begin(epoch)
            batches = self._batches(train_data, batch_size, shuffle,
                                    seed=epoch)
            losses = pending_losses if resume_step else []
            step = resume_step
            pending_losses, resume_step = [], 0
            while step < len(batches):
                if mgr is not None:
                    # a failed background (async) checkpoint write
                    # latched in the writer — surface it at the step
                    # boundary, not from a silent gap in the chain
                    mgr.raise_if_async_failed()
                if mgr is not None and ckpt_mod.preemption_requested():
                    # final checkpoint is SYNCHRONOUS: it supersedes any
                    # queued async snapshot, waits out an in-flight
                    # write, and commits before the process exits
                    mgr.save(global_step,
                             extra_state=_position(step, losses),
                             async_=False)
                    raise ckpt_mod.Preempted(
                        f"preemption requested: checkpointed at global "
                        f"step {global_step} in {checkpoint_dir!r}")
                batch = batches[step]
                cbks.on_batch_begin("train", step)
                outs = self.train_batch(batch[:n_in], batch[n_in:])
                loss = float(np.asarray(outs[0]).reshape(()))
                losses.append(loss)
                cbks.on_batch_end("train", step, {"loss": loss})
                step += 1
                global_step += 1
                if (mgr is not None and checkpoint_freq
                        and global_step % checkpoint_freq == 0):
                    mgr.save(global_step,
                             extra_state=_position(step, losses))
            logs = {"loss": float(np.mean(losses))}
            history["loss"].append(logs["loss"])
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size, verbose=0)
                logs.update({f"val_{k}": v for k, v in eval_logs.items()})
                history.setdefault("val_loss", []).append(eval_logs.get("loss"))
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, f"epoch_{epoch}"))
            if cbks.on_epoch_end(epoch, logs):
                stop = True
            epoch += 1
        cbks.on_train_end()
        if mgr is not None:
            # fit returns with its checkpoints ON DISK: wait out any
            # queued/in-flight async write (and surface its failure)
            mgr.drain()
        return history

    def evaluate(self, eval_data, batch_size=32, log_freq=10, verbose=2,
                 callbacks=None):
        """reference hapi evaluate:1320 — returns {loss, metric values}."""
        for m in self._metrics:
            m.reset()
        losses = []
        n_in = len(self._inputs)
        eval_data = self._materialize(eval_data)
        for batch in self._batches(eval_data, batch_size, False, 0):
            outs = self.eval_batch(batch[:n_in], batch[n_in:])
            losses.append(float(np.asarray(outs[0]).reshape(())))
            preds = outs[1:]
            for m in self._metrics:
                # Keras-style binding: (first output, first label). Metrics
                # over multi-output networks should subclass and override.
                m.update(np.asarray(preds[0]), np.asarray(batch[n_in]))
        logs = {"loss": float(np.mean(losses)) if losses else float("nan")}
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=32, stack_outputs=True,
                callbacks=None):
        """reference hapi predict:1417."""
        outs_all: List[List[np.ndarray]] = []
        n_in = len(self._inputs)
        test_data = self._materialize(test_data)
        for batch in self._batches(test_data, batch_size, False, 0):
            outs = self.test_batch(batch[:n_in])
            outs_all.append([np.asarray(o) for o in outs])
        n_out = len(outs_all[0])
        cols = [[b[i] for b in outs_all] for i in range(n_out)]
        if stack_outputs:
            cols = [np.concatenate(c, axis=0) for c in cols]
        return cols

    # ------------------------------------------------------------------
    def save(self, path):
        """Persistables of the train (or first) program -> '<path>.pdparams'
        (reference hapi save:892 writes the same split)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        main = next(iter(self._progs.values()))[0]
        with fluid.scope_guard(self._scope):
            fluid.io.save_persistables(self._exe, path + ".pdparams", main)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        main = next(iter(self._progs.values()))[0]
        with fluid.scope_guard(self._scope):
            fluid.io.load_persistables(self._exe, path + ".pdparams", main)

    def parameters(self):
        """{name: host array} of the parameters (a bf16 one as the
        checkpoint's ``BF16Array``)."""
        from ..fluid.checkpoint import _host_array

        main = next(iter(self._progs.values()))[0]
        return {
            v.name: _host_array(self._scope.find_var(v.name), deep=True)
            for v in main.list_vars()
            if isinstance(v, fluid.framework.Parameter)
            and self._scope.find_var(v.name) is not None
        }
