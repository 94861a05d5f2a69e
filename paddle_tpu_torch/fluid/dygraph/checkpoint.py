"""save_dygraph / load_dygraph.

Parity: python/paddle/fluid/dygraph/checkpoint.py in the reference —
state_dict pickling with the .pdparams/.pdopt extension convention.
"""
from __future__ import annotations

import os
import pickle

import numpy as np


def save_dygraph(state_dict, model_path: str) -> None:
    suffix = ".pdparams"
    if state_dict and all(
        isinstance(v, dict) for v in state_dict.values() if v is not None
    ):
        # optimizer state dicts nest per-param dicts
        suffix = ".pdopt"
    arrays = {}
    for k, v in state_dict.items():
        arrays[k] = np.asarray(v) if not isinstance(v, dict) else {
            kk: np.asarray(vv) for kk, vv in v.items()
        }
    os.makedirs(os.path.dirname(os.path.abspath(model_path)) or ".", exist_ok=True)
    # tmp + os.replace, same contract as every fluid/io.py save path: a
    # crash mid-save can never leave a torn .pdparams/.pdopt for the
    # next load_dygraph to choke on — it sees the complete old file or
    # the complete new one
    from ..io import _atomic_write_bytes

    _atomic_write_bytes(model_path + suffix, pickle.dumps(arrays))


def load_dygraph(model_path: str):
    params, opt = None, None
    if os.path.exists(model_path + ".pdparams"):
        with open(model_path + ".pdparams", "rb") as f:
            params = pickle.load(f)
    if os.path.exists(model_path + ".pdopt"):
        with open(model_path + ".pdopt", "rb") as f:
            opt = pickle.load(f)
    if params is None and opt is None:
        raise ValueError(f"no checkpoint found at {model_path!r}")
    return params, opt
