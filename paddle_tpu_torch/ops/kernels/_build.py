"""Build and load the port's CUDA kernel libraries.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  A library goes
to ``ops/kernels/build/`` (listed in ``.gitignore``), named by a hash of
its source and the compiler flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is compiled at import time: the
first call that needs a kernel builds its library; ``build_all`` starts
one ``nvcc`` per source at once and waits for them together.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> Dict[str, str]:
    """Kernel name (the source's file stem) -> path of its ``.cu``."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled at first use")


def _source(name: str) -> str:
    path = sources().get(name)
    if path is None:
        raise KernelBuildError(f"no kernel source csrc/{name}.cu")
    return path


def lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists.  Returns
    (library path, running process or None)."""
    path = lib_path(name)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                             _source(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return path, proc


def _finish(name: str, path: str, proc) -> Tuple[str, Optional[str]]:
    if proc is None:
        return path, None
    log, _ = proc.communicate()
    tmp = f"{path}.tmp.{os.getpid()}"
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {_source(name)} (exit "
                               f"{proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, log


def build(name: str) -> Tuple[str, Optional[str]]:
    """Compile one kernel's library unless it is already built.  Returns
    (library path, compiler output, None when the library was cached);
    raises KernelBuildError with the compiler's output on failure."""
    return _finish(name, *_start(name))


def build_all() -> Dict[str, Tuple[str, Optional[str]]]:
    """Build every ``csrc/*.cu`` in parallel: name -> (path, log).  The
    processes all run to their end before the first failure raises."""
    started = {name: _start(name) for name in sources()}
    out, errors = {}, []
    for name, (path, proc) in started.items():
        try:
            out[name] = _finish(name, path, proc)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name)[0])
        return lib
