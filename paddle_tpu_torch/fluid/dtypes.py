"""Dtype utilities: paddle-style dtype strings <-> numpy dtypes, and the
torch dtypes the emitters compute in.

As in the JAX package's ``fluid/dtypes.py``, the Program IR keeps numpy
dtypes (``Variable.dtype``), so a program built by either package holds
the same metadata.  Emitters create tensors through
:func:`to_torch_dtype` of :func:`runtime_dtype`.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
not depend on; a bf16 *Variable* waits for the AMP rewriter's slice.  The
kernels themselves take bf16 torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

_STR2NP = {
    "bool": np.dtype("bool"),
    "int8": np.dtype("int8"),
    "uint8": np.dtype("uint8"),
    "int16": np.dtype("int16"),
    "int32": np.dtype("int32"),
    "int64": np.dtype("int64"),
    "float16": np.dtype("float16"),
    "float32": np.dtype("float32"),
    "float64": np.dtype("float64"),
    "complex64": np.dtype("complex64"),
    "complex128": np.dtype("complex128"),
}

_NP2TORCH = {
    np.dtype("bool"): torch.bool,
    np.dtype("int8"): torch.int8,
    np.dtype("uint8"): torch.uint8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("float16"): torch.float16,
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("complex64"): torch.complex64,
    np.dtype("complex128"): torch.complex128,
}
_TORCH2NP = {t: n for n, t in _NP2TORCH.items()}


def convert_dtype(dtype) -> np.dtype:
    """Canonicalize any dtype spec (str, np.dtype, torch.dtype) to np.dtype."""
    if dtype is None:
        return np.dtype("float32")
    if isinstance(dtype, torch.dtype):
        return from_torch_dtype(dtype)
    if isinstance(dtype, str):
        key = dtype.lower()
        if key == "bfloat16":
            raise TypeError(
                "bfloat16 Variables are not supported by the port's IR yet "
                "(numpy has no bfloat16; the AMP slice brings them)")
        if key in _STR2NP:
            return _STR2NP[key]
        return np.dtype(dtype)
    try:
        return np.dtype(dtype)
    except TypeError:  # an array or scalar: its dtype
        return np.dtype(dtype.dtype)


def dtype_name(dtype) -> str:
    return convert_dtype(dtype).name


def is_floating(dtype) -> bool:
    return np.issubdtype(convert_dtype(dtype), np.floating)


def runtime_dtype(dtype) -> np.dtype:
    """Device-side dtype for tensor CREATION.  The JAX package runs with
    64-bit types off, so a 64-bit int or float lives on the device as its
    32-bit kind while the Variable keeps its declared dtype; the port
    narrows the same way, so both packages infer the same metadata for
    every op output and compute in the same widths."""
    d = convert_dtype(dtype)
    if d.kind in "iuf" and d.itemsize == 8:
        return np.dtype(d.kind + "4")
    return d


def to_torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a (runtime) numpy dtype."""
    d = convert_dtype(dtype)
    try:
        return _NP2TORCH[d]
    except KeyError:
        raise TypeError(f"no torch dtype for {d}") from None


def from_torch_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return _TORCH2NP[dtype]
    except KeyError:
        raise TypeError(f"torch dtype {dtype} has no numpy dtype in the "
                        f"port's IR") from None
