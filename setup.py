"""Package build for paddle_tpu (reference: the root CMakeLists.txt +
python/setup.py.in pipeline, SURVEY.md §2.7).

The native pieces (native/datafeed.cc, native/capi.cc) are compiled
lazily at import time into a per-user cache with hash-keyed rebuilds
(native/__init__.py), so the wheel itself is pure Python — no compiler
is needed at install time, only at first use of the native feed/C API.
"""
from setuptools import find_packages, setup

setup(
    name="paddle-tpu",
    version="0.1.0",
    description=(
        "TPU-native deep-learning framework with the capabilities of "
        "PaddlePaddle Fluid 1.8: Program IR, whole-block XLA compilation, "
        "GSPMD dp/tp/pp/sp/ep parallelism, Pallas flash attention"
    ),
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={
        "paddle_tpu.native": ["*.cc", "*.h"],
        # the PyTorch port's CUDA sources, compiled by nvcc at first use
        "paddle_tpu_torch.ops.kernels": ["csrc/*.cu"],
        # checked-in per-chip autotune winners (tuning/cache.py layer 1)
        "paddle_tpu.tuning": ["defaults/*.json"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "checkpoint": ["orbax-checkpoint"],
        "test": ["pytest"],
    },
)
