"""Checkpoint / model IO, ported from the JAX package's ``fluid/io.py``.

Parity surface: the reference's python/paddle/fluid/io.py —
save_params:373, save_persistables:598, load_persistables:966,
save_inference_model:1164, load_inference_model:1374.

The formats are the JAX package's, byte for byte where the bytes are
deterministic, so a directory written by either package loads in the
other:

* ``__model__`` (or ``model_filename``): a pickle of plain Python values
  (``_serialize_program``): per block its vars' metas (dtype by name,
  "bfloat16" included) and its ops' types, input/output names and attrs;
* ``__meta__.json``: the feed and fetch names;
* the arrays: one ``.npy`` per variable (``/`` written as
  ``__slash__``), or one ``.npz`` when ``params_filename`` is given;
  every file optionally AES-GCM encrypted (``crypto.py``).

bfloat16 arrays.  The JAX package writes a bf16 array through
``ml_dtypes``, which ``.npy`` records as a 2-byte void (``'<V2'``).  The
port has no numpy bf16: it writes the same header and the same bytes,
and reads a 2-byte void back as bf16 where the IR var says bfloat16.

Loaded arrays become torch tensors in the scope, as
``Executor``'s ``Scope.from_numpy`` makes them (64-bit types narrowed
to 32 bits), on the device of the executor passed in (a Predictor moves
them to its own).

Not ported (they raise NotImplementedError): the Orbax-backed
whole-state ``save``/``load`` (ROADMAP A5, checkpoints) and the PS-table
riders that save and restore ``distributed_lookup_table`` tables beside
the persistables (A6, the parameter server); ``save_persistables`` and
``load_persistables`` refuse a program that carries such a table rather
than skip it.
"""
from __future__ import annotations

import io as _io
import json
import os
import pickle
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import framework
from .dtypes import bfloat16, convert_dtype, dtype_name
from .executor import _to_tensor, global_scope


def _fsync_enabled() -> bool:
    """PADDLE_CKPT_FSYNC gates the durability fsyncs (file contents AND
    their parent directory) across every save path. Default ON: tmp +
    os.replace alone is atomic against a process kill but NOT against
    power loss — the rename can hit stable storage before the contents
    it points at. Tests that hammer checkpoints may opt out with
    PADDLE_CKPT_FSYNC=0."""
    return os.environ.get("PADDLE_CKPT_FSYNC", "1").lower() not in (
        "0", "false", "off", "no")


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-created/renamed entry in it is
    durable (no-op on platforms without dir fsync, and when the
    PADDLE_CKPT_FSYNC opt-out is set)."""
    if not _fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _atomic_write_bytes(path: str, blob: bytes,
                        crash_phase: Optional[str] = None) -> None:
    """Write-to-temp + os.replace: a crash mid-save can never leave a
    torn file at `path` — the reader sees either the complete old file
    or the complete new one. The file is fsynced before the rename and
    the parent directory after it (PADDLE_CKPT_FSYNC=0 opts out).
    `crash_phase` names a deterministic kill site between the tmp write
    and the rename (faults `crash:<phase>:<nth>` rules)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            if _fsync_enabled():
                os.fsync(f.fileno())
        if crash_phase is not None:
            from ..distributed import faults

            faults.crash_point(crash_phase)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")


def _persistable_names(program) -> List[str]:
    return [v.name for v in program.list_vars() if v.persistable]


def _param_names(program) -> List[str]:
    return [p.name for p in program.all_parameters()]


def _var_dtypes(program) -> Dict[str, object]:
    return {v.name: v.dtype for v in program.list_vars()}


# ---------------------------------------------------------------------------
# arrays on disk
# ---------------------------------------------------------------------------

_BF16_DISK = np.dtype("V2")  # how a bf16 array reads back from .npy


def _host_array(value) -> np.ndarray:
    """A scope value as the numpy array written to disk: a bf16 tensor
    becomes its raw 2-byte words (``V2``), as ml_dtypes' bf16 is saved."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_BF16_DISK)
        return t.numpy()
    return np.asarray(value)


def _write_npy(fp, arr: np.ndarray) -> None:
    """``np.save``; a bf16 (2-byte void) array gets the ``'<V2'`` header
    that ml_dtypes' bf16 gets, so the file is the JAX package's."""
    if arr.dtype == _BF16_DISK:
        arr = np.ascontiguousarray(arr)
        np.lib.format.write_array_header_1_0(
            fp, {"descr": "<V2", "fortran_order": False,
                 "shape": arr.shape})
        fp.write(arr.tobytes())
    else:
        np.save(fp, arr)


def _write_npz(fp, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` (stored entries ``<name>.npy``) through _write_npy."""
    with zipfile.ZipFile(fp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, arr)


def _to_scope(arr: np.ndarray, ir_dtype, device) -> torch.Tensor:
    """A loaded array as a scope tensor on ``device``; a 2-byte void is
    the bf16 of an IR var that says bfloat16."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or convert_dtype(ir_dtype) is not bfloat16:
            raise TypeError(
                f"a {arr.dtype} array on disk is read as bfloat16, but its "
                f"variable is {dtype_name(ir_dtype)}")
        words = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy())
        return words.view(torch.bfloat16).to(device)
    return _to_tensor(arr, device)


def _save_arrays(dirname: str, names: List[str], scope,
                 filename: Optional[str] = None, encrypt_key=None):
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for n in names:
        v = scope.find_var(n)
        if v is None:
            raise RuntimeError(f"variable {n!r} not found in scope; nothing to save")
        arrays[n] = _host_array(v)

    def _write(path, dump):
        buf = _io.BytesIO()
        dump(buf)
        blob = buf.getvalue()
        if encrypt_key is not None:
            from . import crypto

            blob = crypto.encrypt_bytes(blob, encrypt_key)
        _atomic_write_bytes(path, blob)

    if filename is not None:
        _write(os.path.join(dirname, filename),
               lambda b: _write_npz(b, arrays))
    else:
        for n, a in arrays.items():
            _write(os.path.join(dirname, n.replace("/", "__slash__") + ".npy"),
                   lambda b, _a=a: _write_npy(b, _a))


def _load_arrays(dirname: str, names: List[str], scope,
                 filename: Optional[str] = None, decrypt_key=None,
                 dtypes: Optional[Dict[str, object]] = None, device=None):
    """Read ``names`` into ``scope`` as tensors on ``device`` (None: the
    CUDA card); ``dtypes`` holds each name's IR dtype."""
    from .. import resolve_device

    dev = resolve_device(device)
    dtypes = dtypes or {}

    def _read(path):
        with open(path, "rb") as f:
            blob = f.read()
        if decrypt_key is not None:
            from . import crypto

            blob = crypto.decrypt_bytes(blob, decrypt_key)
        return _io.BytesIO(blob)

    if filename is not None:
        with np.load(_read(os.path.join(dirname, filename))) as z:
            found = {n: z[n] for n in names if n in z.files}
            missing = [n for n in names if n not in z.files]
    else:
        found, missing = {}, []
        for n in names:
            p = os.path.join(dirname, n.replace("/", "__slash__") + ".npy")
            if os.path.exists(p):
                found[n] = np.load(_read(p))
            else:
                missing.append(n)
    if missing:
        raise RuntimeError(f"checkpoint at {dirname!r} is missing variables: {missing}")
    for n, a in found.items():
        scope.set_var(n, _to_scope(a, dtypes.get(n), dev))


def _executor_device(executor):
    """Where loaded arrays go: the executor's device (None: the card)."""
    return getattr(executor, "device", None)


def _ps_table_names(program) -> List[str]:
    names = []
    for block in program.blocks:
        for op in block.ops:
            if op.type == "distributed_lookup_table":
                # mirror the JAX emitter's attr fallback (its ops/ps_ops.py)
                got = op.attr("table_names", []) or (
                    [op.attr("table_name")] if op.attr("table_name")
                    else [])
                names.extend(got)
    return sorted(set(names))


def _save_ps_tables(dirname: str, program) -> None:
    raise NotImplementedError(
        "saving parameter-server tables beside the persistables waits "
        "for the port of the parameter server (the PS half of ROADMAP A6)")


def _load_ps_tables(dirname: str, program) -> None:
    raise NotImplementedError(
        "restoring parameter-server tables waits for the port of the "
        "parameter server (the PS half of ROADMAP A6)")


def _refuse_ps_tables(program, what: str) -> None:
    tables = _ps_table_names(program)
    if tables:
        raise NotImplementedError(
            f"{what}: the program reads parameter-server tables {tables} "
            f"(distributed_lookup_table); the port cannot "
            f"{'save' if what.startswith('save') else 'restore'} them "
            f"until the parameter server is ported (the PS half of ROADMAP A6), and "
            f"will not leave them out")


def save_params(executor, dirname, main_program=None, filename=None):
    """reference io.py:373 — trainable parameters only."""
    program = main_program or framework.default_main_program()
    _save_arrays(dirname, _param_names(program), global_scope(), filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """reference io.py:598 — params + optimizer moments + LR etc."""
    program = main_program or framework.default_main_program()
    _refuse_ps_tables(program, "save_persistables")
    _save_arrays(dirname, _persistable_names(program), global_scope(), filename)


def load_params(executor, dirname, main_program=None, filename=None):
    program = main_program or framework.default_main_program()
    _load_arrays(dirname, _param_names(program), global_scope(), filename,
                 dtypes=_var_dtypes(program),
                 device=_executor_device(executor))


def load_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or framework.default_main_program()
    _refuse_ps_tables(program, "load_persistables")
    _load_arrays(dirname, _persistable_names(program), global_scope(),
                 filename, dtypes=_var_dtypes(program),
                 device=_executor_device(executor))


# ---------------------------------------------------------------------------
# inference model export: prune program to feed->fetch subgraph + params
# ---------------------------------------------------------------------------


def _prune_for_inference(program, feed_names: List[str], fetch_vars,
                         state_vars: Sequence[str] = ()) -> "framework.Program":
    """Backward slice from fetch vars, like the reference's prune
    (io.py:1164 save_inference_model -> Program._prune_with_input), of a
    ``clone(for_test=True)`` of ``program``.

    state_vars: extra slice roots for state-carrying vars (decode-step
    caches read at an earlier op and written back at a later one), so
    their writer chain stays live."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = {v.name if isinstance(v, framework.Variable) else str(v)
              for v in fetch_vars} | {str(n) for n in state_vars}
    keep = set()
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if any(n in needed for n in op.output_names()):
            keep.add(i)
            needed.update(op.input_names())
    block.ops = [op for i, op in enumerate(block.ops) if i in keep]
    return pruned


def _plain_attr(v):
    """An op attr as a plain value both packages unpickle: the port's
    bfloat16 dtype becomes the name "bfloat16" (every emitter reads a
    dtype attr through ``convert_dtype``)."""
    if v is bfloat16:
        return "bfloat16"
    if isinstance(v, list):
        return [_plain_attr(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_plain_attr(x) for x in v)
    if isinstance(v, dict):
        return {k: _plain_attr(x) for k, x in v.items()}
    return v


def _serialize_program(program) -> bytes:
    """Pickle the op list + var metas (the ProgramDesc analog)."""
    blocks = []
    for b in program.blocks:
        blocks.append(
            {
                "idx": b.idx,
                "parent_idx": b.parent_idx,
                "vars": {
                    name: {
                        "shape": v.shape,
                        "dtype": dtype_name(v.dtype) if v.dtype is not None else None,
                        "persistable": v.persistable,
                        "stop_gradient": v.stop_gradient,
                        "is_data": v.is_data,
                        "is_parameter": isinstance(v, framework.Parameter),
                        "trainable": getattr(v, "trainable", False),
                    }
                    for name, v in b.vars.items()
                },
                "ops": [
                    {
                        "type": op.type,
                        "inputs": op.inputs,
                        "outputs": op.outputs,
                        "attrs": {
                            k: (("__block__", v.idx) if isinstance(v, framework.Block)
                                else _plain_attr(v))
                            for k, v in op.attrs.items()
                        },
                    }
                    for op in b.ops
                ],
            }
        )
    return pickle.dumps({"version": 1, "blocks": blocks})


def _np_dtype(obj, align=False, copy=False):
    """``numpy.dtype`` for the unpickler: ml_dtypes' bfloat16 (what a
    JAX-side bf16 dtype attr pickles as) becomes the port's."""
    if obj is _MLBFloat16:
        return bfloat16
    return np.dtype(obj, align, copy)


class _MLBFloat16:
    """Stands in for ``ml_dtypes.bfloat16`` while unpickling."""


class _ProgramUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if module.split(".")[0] == "ml_dtypes" and name == "bfloat16":
            return _MLBFloat16
        return super().find_class(module, name)


def _deserialize_program(data: bytes) -> "framework.Program":
    """The Program a ``_serialize_program`` pickle (either package's)
    describes.  Vars are built by their constructors, so they carry all
    of the port's state; ops are appended without shape inference (the
    saved metas are the inferred ones)."""
    payload = _ProgramUnpickler(_io.BytesIO(data)).load()
    program = framework.Program()
    program.blocks = []
    for bd in payload["blocks"]:
        blk = framework.Block(program, bd["idx"], bd["parent_idx"])
        program.blocks.append(blk)
    for bd, blk in zip(payload["blocks"], program.blocks):
        for name, meta in bd["vars"].items():
            kw = dict(shape=meta["shape"],
                      dtype=meta["dtype"] or "float32",
                      persistable=meta["persistable"],
                      stop_gradient=meta["stop_gradient"],
                      is_data=meta["is_data"],
                      trainable=meta.get("trainable", False))
            if meta["is_parameter"]:
                blk.vars[name] = framework.Parameter(blk, name, **kw)
            else:
                blk.vars[name] = framework.Variable(blk, name, **kw)
        for od in bd["ops"]:
            attrs = {
                k: (program.blocks[v[1]] if isinstance(v, tuple) and len(v) == 2 and v[0] == "__block__" else v)
                for k, v in od["attrs"].items()
            }
            op = framework.Operator(blk, od["type"], inputs=od["inputs"], outputs=od["outputs"], attrs=attrs)
            blk.ops.append(op)
            for n in op.output_names():
                fv = blk._find_var_recursive(n)
                if fv is not None:
                    fv.op = op
    program._bump_version()
    return program


def _used_persistables(program) -> List[str]:
    """Every persistable the program's global block reads: Parameters
    AND buffers (BatchNorm running stats, traced constants)."""
    used = {n for op in program.global_block().ops for n in op.input_names()}
    return [v.name for v in program.list_vars()
            if v.persistable and v.name in used]


def save_inference_model(
    dirname,
    feeded_var_names: List[str],
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    encrypt_key=None,
):
    """reference io.py:1164 — prune to the inference subgraph + save params.
    encrypt_key: AES-encrypt the serialized program and every array file
    (reference framework/io/crypto cipher applied at save time)."""
    program = main_program or framework.default_main_program()
    pruned = _prune_for_inference(program, feeded_var_names, target_vars)
    os.makedirs(dirname, exist_ok=True)
    model_filename = model_filename or "__model__"
    blob = _serialize_program(pruned)
    if encrypt_key is not None:
        from . import crypto

        blob = crypto.encrypt_bytes(blob, encrypt_key)
    _atomic_write_bytes(os.path.join(dirname, model_filename), blob)
    fetch_names = [
        v.name if isinstance(v, framework.Variable) else str(v) for v in target_vars
    ]
    _atomic_write_bytes(
        os.path.join(dirname, "__meta__.json"),
        json.dumps({"feed_names": list(feeded_var_names),
                    "fetch_names": fetch_names}).encode())
    # a Parameters-only filter would silently drop buffers and make the
    # model unloadable
    _save_arrays(dirname, _used_persistables(pruned), global_scope(),
                 params_filename, encrypt_key=encrypt_key)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, decrypt_key=None):
    """reference io.py:1374 — returns (program, feed_names, fetch_vars);
    the arrays go into the global scope on ``executor``'s device."""
    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename), "rb") as f:
        blob = f.read()
    if decrypt_key is not None:
        from . import crypto

        blob = crypto.decrypt_bytes(blob, decrypt_key)
    program = _deserialize_program(blob)
    with open(os.path.join(dirname, "__meta__.json")) as f:
        meta = json.load(f)
    _load_arrays(dirname, _used_persistables(program), global_scope(),
                 params_filename, decrypt_key=decrypt_key,
                 dtypes=_var_dtypes(program),
                 device=_executor_device(executor))
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


# ---------------------------------------------------------------------------
# whole-state save/load (reference io.py:1669/1733): Orbax in the JAX
# package, which the card's installation lacks; the port's whole-state
# checkpointer is fluid.CheckpointManager (fluid/checkpoint.py)
# ---------------------------------------------------------------------------


def save(program, model_path: str):
    raise NotImplementedError(
        "fluid.io.save (the JAX package's Orbax checkpoint) is not ported: "
        "the port's whole-state checkpointer is fluid.CheckpointManager "
        "(atomic, verified, resumable; save_persistables writes the "
        "persistables as .npy files; its sharded layout, ROADMAP A6, "
        "under PADDLE_CKPT_SHARDED)")


def load(program, model_path: str, executor=None):
    raise NotImplementedError(
        "fluid.io.load (the JAX package's Orbax checkpoint) is not ported: "
        "fluid.CheckpointManager.restore reads the port's whole-state "
        "checkpoints, and either package's (load_persistables reads "
        "save_persistables' files; its sharded layout, ROADMAP A6, "
        "under PADDLE_CKPT_SHARDED)")


# ---------------------------------------------------------------------------
# train-model export/import: the C++ training-driver story (reference
# fluid/train/demo — train a saved program WITHOUT Python on the driver
# side)
# ---------------------------------------------------------------------------


def save_train_model(executor, dirname, feed_names, loss, main_program=None,
                     startup_program=None):
    """Serialize the FULL training program (forward+backward+optimizer),
    its startup program, the feed/loss names, and current persistables."""
    main_program = main_program or framework.default_main_program()
    startup_program = startup_program or framework.default_startup_program()
    os.makedirs(dirname, exist_ok=True)
    _atomic_write_bytes(os.path.join(dirname, "__train_model__"),
                        pickle.dumps({
                            "version": 1,
                            "main": _serialize_program(main_program),
                            "startup": _serialize_program(startup_program),
                            "feed_names": list(feed_names),
                            "loss_name": loss if isinstance(loss, str)
                            else loss.name,
                        }))
    save_persistables(executor, dirname, main_program=main_program)


def load_train_model(executor, dirname):
    """Returns (main_program, startup_program, feed_names, loss_name);
    runs the startup program and restores saved persistables."""
    with open(os.path.join(dirname, "__train_model__"), "rb") as f:
        meta = pickle.load(f)
    main = _deserialize_program(meta["main"])
    startup = _deserialize_program(meta["startup"])
    executor.run(startup)
    load_persistables(executor, dirname, main_program=main)
    return main, startup, meta["feed_names"], meta["loss_name"]
