"""Dtype utilities: paddle-style dtype strings <-> numpy dtypes, and the
torch dtypes the emitters compute in.

As in the JAX package's ``fluid/dtypes.py``, the Program IR keeps numpy
dtypes (``Variable.dtype``), so a program built by either package holds
the same metadata.  Emitters create tensors through
:func:`to_torch_dtype` of :func:`runtime_dtype`.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
not depend on (the card's installation lacks it).  The IR names it with
its own singleton, :data:`bfloat16`, which the helpers here understand:
``convert_dtype("bfloat16")`` returns it, ``dtype_name`` says
"bfloat16", ``is_floating`` is true, and ``to_torch_dtype`` /
``from_torch_dtype`` map it to and from ``torch.bfloat16``.  Code that
reads a Variable's dtype goes through these helpers, never
``np.dtype(v.dtype)``.
"""
from __future__ import annotations

import numpy as np
import torch


class _BFloat16:
    """The IR's bfloat16 dtype (numpy has none): a singleton with the
    attributes the port reads off a numpy dtype."""

    name = "bfloat16"
    kind = "f"
    itemsize = 2

    def __repr__(self):
        return "dtype('bfloat16')"

    def __reduce__(self):  # pickles (Program clones) keep the singleton
        return "bfloat16"

    def __setstate__(self, state):
        """A numpy dtype's pickle state, met where an unpickler reads
        ml_dtypes' bfloat16 as this singleton (``fluid/io.py``)."""


bfloat16 = _BFloat16()

_STR2NP = {
    "bool": np.dtype("bool"),
    "int8": np.dtype("int8"),
    "uint8": np.dtype("uint8"),
    "int16": np.dtype("int16"),
    "uint32": np.dtype("uint32"),
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
    # jnp.sum of uint8 gives uint32; torch keeps few ops for it (casts,
    # views, copies), so a uint32 result is for reading, not arithmetic
    np.dtype("uint32"): torch.uint32,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("float16"): torch.float16,
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("complex64"): torch.complex64,
    np.dtype("complex128"): torch.complex128,
}
_TORCH2NP = {t: n for n, t in _NP2TORCH.items()}
_NP2TORCH[bfloat16] = torch.bfloat16
_TORCH2NP[torch.bfloat16] = bfloat16


def convert_dtype(dtype):
    """Canonicalize any dtype spec (str, np.dtype, torch.dtype) to a numpy
    dtype, or to :data:`bfloat16`."""
    if dtype is None:
        return np.dtype("float32")
    if dtype is bfloat16:
        return bfloat16
    if isinstance(dtype, torch.dtype):
        return from_torch_dtype(dtype)
    if isinstance(dtype, str):
        key = dtype.lower()
        if key == "bfloat16":
            return bfloat16
        if key in _STR2NP:
            return _STR2NP[key]
        return np.dtype(dtype)
    if getattr(dtype, "name", None) == "bfloat16":  # e.g. ml_dtypes' dtype
        return bfloat16
    try:
        return np.dtype(dtype)
    except TypeError:  # an array or scalar: its dtype
        return np.dtype(dtype.dtype)


def dtype_name(dtype) -> str:
    return convert_dtype(dtype).name


def is_floating(dtype) -> bool:
    d = convert_dtype(dtype)
    return d is bfloat16 or np.issubdtype(d, np.floating)


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d is not bfloat16 and np.issubdtype(d, np.integer)


def runtime_dtype(dtype):
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
    """The torch dtype of a (runtime) numpy dtype or :data:`bfloat16`."""
    d = convert_dtype(dtype)
    try:
        return _NP2TORCH[d]
    except KeyError:
        raise TypeError(f"no torch dtype for {d}") from None


def from_torch_dtype(dtype: torch.dtype):
    try:
        return _TORCH2NP[dtype]
    except KeyError:
        raise TypeError(f"torch dtype {dtype} has no numpy dtype in the "
                        f"port's IR") from None
