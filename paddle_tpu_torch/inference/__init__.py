"""Inference stack: the file-based Config + Predictor with zero-copy
tensor handles, the frozen-Program serving predictor, the
continuous-batching generation engine, and the RPC serving replica.

Parity surface: reference paddle/fluid/inference/api/
(AnalysisPredictor: analysis_predictor.h:82, AnalysisConfig:
analysis_config.cc, ZeroCopyTensor) and paddle_infer's
create_predictor / get_input_handle surface, ported from the JAX
package's ``inference/__init__.py``.

A saved model (``fluid.io.save_inference_model``, either package's) on
the card:

    from paddle_tpu_torch import inference
    pred = inference.create_predictor(inference.Config(model_dir))
    outs = pred.run([x])                 # numpy in, numpy out

``Config.disable_gpu()`` is how a caller asks for the CPU; the default,
and ``enable_use_gpu()``, is the CUDA card (raising where there is
none).  Input handles hold device tensors; ``share_external_data``
adopts a torch tensor already on the predictor's device without a copy;
outputs stay on the device until ``copy_to_cpu``.

The frozen-Program ``infer`` path and the engine in-process:

    frozen = inference.load_frozen(model_dir)      # or freeze_program
    seq, pooled = inference.ServingPredictor(frozen).run(feed)
    eng = inference.GenerationEngine(
        inference.TinyDecoderLM(inference.DecoderConfig(), device="cuda"))

and behind the RPC server (``python -m paddle_tpu_torch.inference.server
--model_dir D``) with ``InferenceClient([endpoint])``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import fluid


class Config:
    """AnalysisConfig parity."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._memory_optim = True
        self._glog_info = False
        self._use_gpu = True
        self._device_id = 0

    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag  # the executor frees each var; accepted

    def disable_glog_info(self):
        self._glog_info = False

    def switch_ir_optim(self, flag=True):
        pass  # the program runs as saved; accepted for parity

    def switch_use_feed_fetch_ops(self, flag):
        pass  # feed/fetch glue is host-side here

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "TensorRT subgraphs are not part of the port: the program runs "
            "op by op on the card, its hot spots on hand-written CUDA "
            "kernels — no engine delegation exists"
        )

    def _device(self) -> torch.device:
        from .. import resolve_device

        if not self._use_gpu:
            return torch.device("cpu")
        dev = resolve_device(None)  # raises where CUDA is absent
        return torch.device(dev.type, self._device_id)


def _numpy(value) -> np.ndarray:
    """A fetch as numpy; a bf16 tensor comes out as float32 (numpy has
    no bf16), value for value."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


class Tensor:
    """Zero-copy tensor handle (reference ZeroCopyTensor)."""

    def __init__(self, predictor: "Predictor", name: str, is_input: bool):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    # -- input side ------------------------------------------------------
    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise RuntimeError(f"{self.name!r} is an output handle")
        self._p._feed[self.name] = torch.from_numpy(
            np.array(arr, copy=True, order="C")).to(self._p.device)

    def share_external_data(self, arr):
        """Adopt an existing tensor on the predictor's device without
        copying."""
        if not self._is_input:
            raise RuntimeError(f"{self.name!r} is an output handle")
        if isinstance(arr, torch.Tensor) and arr.device != self._p.device:
            raise ValueError(
                f"share_external_data: the tensor lives on {arr.device}, "
                f"the predictor runs on {self._p.device}")
        self._p._feed[self.name] = arr

    def reshape(self, shape):
        pass  # shapes come from the array in copy_from_cpu

    # -- output side -----------------------------------------------------
    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            val = self._p._feed.get(self.name)
        else:
            val = self._p._outputs.get(self.name)
        if val is None:
            raise RuntimeError(f"tensor {self.name!r} has no value yet")
        return _numpy(val)

    def shape(self):
        return list(np.shape(self.copy_to_cpu()))


class Predictor:
    """AnalysisPredictor parity: load once, run many, on the card unless
    the config disabled the GPU."""

    def __init__(self, config: Config, _clone_from: Optional["Predictor"] = None):
        self._config = config
        if _clone_from is not None:
            # share the executor and the scope (weights) without
            # re-reading from disk — the reference clone's multi-instance
            # scope sharing
            self._exe = _clone_from._exe
            self._scope = _clone_from._scope
            self._program = _clone_from._program
            self._feed_names = list(_clone_from._feed_names)
            self._fetch_vars = _clone_from._fetch_vars
            self._fetch_names = list(_clone_from._fetch_names)
        else:
            import os

            self._exe = fluid.Executor(device=config._device())
            dirname = config.model_dir()
            model_filename = None
            if config._prog_file:
                if dirname is None:
                    dirname = os.path.dirname(config._prog_file) or "."
                model_filename = os.path.basename(config._prog_file)
            if dirname is None:
                raise ValueError(
                    "Config needs model_dir or prog_file to locate the model"
                )
            self._scope = fluid.executor.Scope()
            with fluid.scope_guard(self._scope):
                prog, feeds, fetches = fluid.io.load_inference_model(
                    dirname, self._exe, model_filename=model_filename,
                    params_filename=config._params_file,
                )
            self._program = prog
            self._feed_names = list(feeds)
            self._fetch_vars = fetches
            self._fetch_names = [
                v.name if hasattr(v, "name") else str(v) for v in fetches
            ]
        self._feed: Dict[str, object] = {}
        self._outputs: Dict[str, object] = {}

    @property
    def device(self) -> torch.device:
        return self._exe.device

    # -- reference surface ----------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name) -> Tensor:
        if name not in self._feed_names:
            raise KeyError(f"unknown input {name!r}")
        return Tensor(self, name, is_input=True)

    def get_output_handle(self, name) -> Tensor:
        if name not in self._fetch_names:
            raise KeyError(f"unknown output {name!r}")
        return Tensor(self, name, is_input=False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """paddle_infer style: either set inputs via handles then run(),
        or pass a positional list (old PaddlePredictor::Run)."""
        if inputs is not None:
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    f"run() got {len(inputs)} inputs, model has "
                    f"{len(self._feed_names)}: {self._feed_names}"
                )
            for n, a in zip(self._feed_names, inputs):
                self._feed[n] = np.ascontiguousarray(a)
        missing = [n for n in self._feed_names if n not in self._feed]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        with fluid.scope_guard(self._scope):
            outs = self._exe.run(
                self._program, feed=dict(self._feed),
                fetch_list=self._fetch_names, return_numpy=False,
            )
        self._outputs = dict(zip(self._fetch_names, outs))
        return [_numpy(o) for o in outs] if inputs is not None else True

    def clone(self) -> "Predictor":
        """Share weights (scope), separate feed/fetch state — the
        reference's multi-instance scope sharing (no disk reload)."""
        return Predictor(self._config, _clone_from=self)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


# legacy fluid.core-style aliases
AnalysisConfig = Config
AnalysisPredictor = Predictor


def create_paddle_predictor(config: Config) -> Predictor:
    return Predictor(config)


# ---------------------------------------------------------------------------
# serving: program freezing and the frozen-model predictor; the engine,
# the RPC replica and its client load on first use (``python -m
# paddle_tpu_torch.inference.server`` then runs the one server module)
# ---------------------------------------------------------------------------
from .freeze import FrozenModel, freeze_program, load_frozen  # noqa: F401,E402
from .predictor import Predictor as ServingPredictor  # noqa: F401,E402
from .predictor import shared_executor  # noqa: F401,E402
from . import weight_sync  # noqa: F401,E402

_LAZY = {
    "InferenceServer": "server", "MicroBatcher": "server", "serve": "server",
    "Overloaded": "server", "DeadlineExceeded": "server",
    "ResumedOnNewWeights": "server",
    "InferenceClient": "client", "InferResult": "client",
    "OverloadedError": "client", "DeadlineExceededError": "client",
    "ResumedOnNewWeightsError": "client",
    "GenerationEngine": "engine", "GenRequest": "engine",
    "kv_cache_enabled": "engine",
    "PagedKVPool": "kv_cache",
    "TinyDecoderLM": "decode_model", "DecoderConfig": "decode_model",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
