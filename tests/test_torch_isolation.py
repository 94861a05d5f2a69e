"""The port stands alone: no module of paddle_tpu_torch, and not
chip_smoke.py, imports jax or anything of paddle_tpu; entry points run
on the card unless the caller asks for the CPU; the CUDA wrapper's input
checks refuse what the kernel does not take."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference.kv_cache import PagedKVPool
from paddle_tpu_torch import fluid
from paddle_tpu_torch.inference import shared_executor
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import paged_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import pkgutil, sys, importlib
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "paddle_tpu"
             or m.startswith("paddle_tpu."))
print(len(names), bad)
assert not bad, bad
for n in ("fluid", "fluid.layers", "fluid.executor", "fluid.framework",
          "inference.freeze", "inference.predictor", "models.bert",
          "ops.attention", "ops.nn_ops", "ops.kernels.flash_attention",
          "ops.kernels.add_ln", "ops.kernels._build"):
    assert "paddle_tpu_torch." + n in names, n
"""


def test_port_imports_no_jax_and_no_paddle_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 40  # every module of the port was imported


def test_resolve_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dm.TinyDecoderLM(dm.DecoderConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVPool(n_pages=2, page_size=2, n_layers=1, kv_heads=1,
                    head_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.Scope.from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shared_executor()
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert fluid.Executor(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert paddle_tpu_torch.resolve_device(None) == torch.device("cuda")


def test_every_kernel_source_builds_into_its_own_library(monkeypatch,
                                                         tmp_path):
    srcs = _build.sources()
    assert sorted(srcs) == ["add_ln", "flash_attention_bsh",
                            "paged_attention"]
    libs = {_build.lib_path(n) for n in srcs}
    assert len(libs) == 3 and all(os.path.basename(p).startswith("lib")
                                  for p in libs)
    # a compiler that refuses every source: one error naming each source,
    # with its log, after all of them ran
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: sys.executable)
    with pytest.raises(_build.KernelBuildError) as err:
        _build.build_all()
    for path in srcs.values():
        assert path in str(err.value)
    assert "Unknown option" in str(err.value)  # the compiler's own output
    with pytest.raises(_build.KernelBuildError, match="no kernel source"):
        _build.build("no_such_kernel")


def _good(b=2, h=4, kh=4, d=64, page=4, n_pages=6, maxp=3):
    return dict(q=torch.zeros(b, h, d), k=torch.zeros(n_pages, page, kh, d),
                v=torch.zeros(n_pages, page, kh, d),
                table=torch.zeros(b, maxp, dtype=torch.int32),
                lens=torch.ones(b, dtype=torch.int32))


def _check(x):
    pa.check_kernel_inputs(x["q"], x["k"], x["v"], x["table"], x["lens"])


@pytest.mark.parametrize("kw", [dict(), dict(d=128), dict(d=256),
                                dict(h=8, kh=2)],
                         ids=["d64", "d128", "d256", "gqa"])
def test_kernel_check_accepts_supported_inputs(kw):
    _check(_good(**kw))
    x = _good(**kw)
    x.update(q=x["q"].bfloat16(), k=x["k"].bfloat16(), v=x["v"].bfloat16())
    _check(x)


BAD = {
    "q_float64": lambda x: x.update(q=x["q"].double()),
    "q_float16": lambda x: x.update(q=x["q"].half()),
    "k_dtype_differs": lambda x: x.update(k=x["k"].bfloat16()),
    "table_int64": lambda x: x.update(table=x["table"].long()),
    "lengths_int64": lambda x: x.update(lens=x["lens"].long()),
    "q_2d": lambda x: x.update(q=x["q"][0]),
    "head_dim_32": lambda x: x.update(q=x["q"][..., :32],
                                      k=x["k"][..., :32].contiguous(),
                                      v=x["v"][..., :32].contiguous()),
    "k_v_shapes_differ": lambda x: x.update(v=x["v"][:-1]),
    "heads_not_grouped": lambda x: x.update(k=torch.zeros(6, 4, 3, 64),
                                            v=torch.zeros(6, 4, 3, 64)),
    "table_rows": lambda x: x.update(table=x["table"][:1]),
    "lengths_shape": lambda x: x.update(lens=x["lens"][:1]),
    "q_not_contiguous": lambda x: x.update(
        q=torch.zeros(2, 64, 4).transpose(1, 2)),
    "k_not_contiguous": lambda x: x.update(
        k=torch.zeros(6, 4, 64, 4).transpose(2, 3)),
    "table_not_contiguous": lambda x: x.update(
        table=torch.zeros(3, 2, dtype=torch.int32).t()),
    "q_misaligned": lambda x: x.update(q=torch.zeros(2 * 4 * 64 + 1)[1:]
                                       .view(2, 4, 64)),
    "k_other_device": lambda x: x.update(
        k=torch.zeros(6, 4, 4, 64, device="meta")),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_kernel_check_refuses(name):
    x = _good()
    BAD[name](x)
    with pytest.raises(ValueError):
        _check(x)
