"""Build and load the port's CUDA kernel library.

``csrc/paged_attention.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library goes to
``ops/kernels/build/`` (listed in ``.gitignore``), named by a hash of the
source and the compiler flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is compiled at import time: the
first call that needs the kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "paged_attention.cu")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the source."""


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernel is compiled at first use")


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpaged_attention-{h.hexdigest()[:16]}.so")


def build() -> Tuple[str, Optional[str]]:
    """Compile the library unless it is already built.  Returns (library
    path, compiler output, None when the library was cached); raises
    KernelBuildError with the compiler's output on failure."""
    path = _lib_path()
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path, proc.stdout


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build()[0])
        return _lib
