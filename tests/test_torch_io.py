"""Saving and loading models, ported in ``paddle_tpu_torch/fluid/io.py``,
held against the JAX package's ``fluid/io.py`` on the CPU.

Every format crosses both ways: a directory written by one package is
loaded by the other and run there, and the fetches (or the losses of
the next training steps) agree with the writer's own within 1e-4, the
tolerance ``test_torch_bert_infer.py`` holds (the same f32 math in
another summation order).  Cases: inference models (an fc + relu MLP
and a tiny BERT, with and without ``params_filename``), params and
persistables (Adam's moments included), train models, an encrypted
model, a bf16 persistable (bit for bit), a program with bf16 vars and
dtype attrs, the buffers of a batch norm, a crash mid-write, and the
refusals (the Orbax ``save``/``load``, parameter-server tables).  Then
the file-based ``Config``/``Predictor`` over a model the JAX package
saved.
"""
from __future__ import annotations

import io
import os
import pickle

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid.dtypes import bfloat16
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.models import bert as tbert

TOL = 1e-4
KEY = "paddle-tpu test key"


class _Pkg:
    """One package's entry points, so a case reads the same either way."""

    def __init__(self, name, fluid, nn, bert, inference):
        self.name, self.fluid, self.nn, self.bert = name, fluid, nn, bert
        self.inference = inference

    def executor(self):
        if self.name == "jax":
            return self.fluid.Executor()
        return self.fluid.Executor(device="cpu")

    def scope(self):
        return self.fluid.executor.Scope()

    def load_frozen(self, d, params_filename=None):
        if self.name == "jax":
            return self.inference.load_frozen(
                d, params_filename=params_filename)
        return self.inference.load_frozen(
            d, params_filename=params_filename, device="cpu")

    def predictor(self, frozen):
        if self.name == "jax":
            return self.inference.ServingPredictor(frozen)
        return self.inference.ServingPredictor(frozen, device="cpu")


JAX = _Pkg("jax", jfluid, jnn, jbert, jinference)
TORCH = _Pkg("torch", tfluid, tnn, tbert, tinference)
DIRECTIONS = {"jax_to_torch": (JAX, TORCH), "torch_to_jax": (TORCH, JAX)}
FILENAMES = {"npy": None, "npz": "__params__"}


def _mlp(pkg, optimizer=True):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 8], dtype="float32",
                              append_batch_size=False)
        y = fluid.layers.data("y", [4, 1], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 1)
        d = fluid.layers.elementwise_sub(pred, y)
        loss = fluid.layers.reduce_mean(fluid.layers.elementwise_mul(d, d))
        if optimizer:
            fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return main, startup, pred, loss


def _feed(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.standard_normal((4, 1)).astype(np.float32)}


def _run(pkg, exe, program, feed, fetch):
    return [np.asarray(o) for o in exe.run(program, feed=feed,
                                           fetch_list=fetch)]


# ---------------------------------------------------------------------------
# inference models
# ---------------------------------------------------------------------------


def _bert_program(pkg):
    cfg = pkg.bert.BertConfig.tiny()
    pkg.nn._rng_salt_counter[0] = 0
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        def data(name, dtype):
            return fluid.layers.data(name, [2, 16], dtype,
                                     append_batch_size=False)

        ids, types, pos = (data(n, "int32") for n in
                           ("input_ids", "token_type_ids", "position_ids"))
        seq = pkg.bert.bert_encoder(cfg, ids, types, pos,
                                    data("input_mask", "float32"),
                                    is_test=False)
        pooled = pkg.bert.bert_pooler(cfg, seq)
    feeds = ["input_ids", "token_type_ids", "position_ids", "input_mask"]
    return main, startup, feeds, [seq, pooled]


def _bert_feed():
    rng = np.random.default_rng(3)
    live = np.arange(16)[None, :] < np.array([16, 9])[:, None]
    return {"input_ids": np.where(live, rng.integers(1, 100, (2, 16)),
                                  0).astype(np.int32),
            "token_type_ids": (rng.random((2, 16)) > 0.5).astype(np.int32),
            "position_ids": np.tile(np.arange(16, dtype=np.int32), (2, 1)),
            "input_mask": live.astype(np.float32)}


def _mlp_infer(pkg):
    main, startup, pred, _ = _mlp(pkg, optimizer=False)
    return main, startup, ["x"], [pred]


MODELS = {"mlp": (_mlp_infer, lambda: {"x": _feed()["x"]}),
          "tiny_bert": (_bert_program, _bert_feed)}


@pytest.mark.parametrize("filename", sorted(FILENAMES))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_inference_model_crosses(tmp_path, direction, model, filename):
    """A model saved by one package is frozen and served by the other
    (``load_frozen`` + the serving predictor), with the writer's
    fetches; the loaded program also runs as loaded."""
    src, dst = DIRECTIONS[direction]
    build, make_feed = MODELS[model]
    main, startup, feeds, fetch = build(src)
    exe, scope = src.executor(), src.scope()
    d = str(tmp_path / "model")
    with src.fluid.scope_guard(scope):
        exe.run(startup)
        names = src.fluid.io.save_inference_model(
            d, feeds, fetch, exe, main_program=main,
            params_filename=FILENAMES[filename])
    feed = make_feed()
    fn = FILENAMES[filename]
    want = src.predictor(src.load_frozen(d, fn)).run(feed)
    frozen = dst.load_frozen(d, fn)
    assert frozen.feed_names == feeds and frozen.fetch_names == names
    got = dst.predictor(frozen).run(feed)
    dexe = dst.executor()
    with dst.fluid.scope_guard(dst.scope()):
        prog, fnames, fvars = dst.fluid.io.load_inference_model(
            d, dexe, params_filename=FILENAMES[filename])
        ran = _run(dst, dexe, prog, feed, fvars)
    assert fnames == feeds
    for w, g, r in zip(want, got, ran):
        assert np.shape(g) == np.shape(w) and np.shape(r) == np.shape(w)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(r, np.asarray(w), atol=TOL, rtol=0)


def test_saved_program_bytes_hold_plain_values(tmp_path):
    """The port's ``__model__`` unpickles with the standard unpickler
    into plain values only (no class of the port), and its var metas
    and op list equal those of the JAX package's save of the same
    program (but for the op-callstack attrs, which hold call stacks)."""
    dirs = {}
    for pkg in (JAX, TORCH):
        main, startup, feeds, fetch = _mlp_infer(pkg)
        exe = pkg.executor()
        with pkg.fluid.scope_guard(pkg.scope()):
            exe.run(startup)
            d = str(tmp_path / pkg.name)
            pkg.fluid.io.save_inference_model(d, feeds, fetch, exe,
                                              main_program=main)
        dirs[pkg.name] = d

    class Plain(pickle.Unpickler):
        def find_class(self, module, name):
            assert module.split(".")[0] in ("numpy", "builtins"), module
            return super().find_class(module, name)

    payloads = {}
    for name, d in dirs.items():
        with open(os.path.join(d, "__model__"), "rb") as f:
            payloads[name] = Plain(io.BytesIO(f.read())).load()
        for op in payloads[name]["blocks"][0]["ops"]:
            # the op-callstack diagnostics: each package's own call stacks
            op["attrs"].pop("__op_callstack__", None)
        with open(os.path.join(d, "__meta__.json")) as f:
            payloads[name]["meta"] = f.read()
    assert payloads["torch"] == payloads["jax"]


# ---------------------------------------------------------------------------
# params, persistables, train models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filename", sorted(FILENAMES))
@pytest.mark.parametrize("kind", ["params", "persistables"])
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_params_and_persistables_cross(tmp_path, direction, kind,
                                       filename):
    """Two Adam steps in the writer, save, two more there; the reader
    builds the same program, runs its startup, loads, and takes the same
    two steps: the losses agree (persistables carry Adam's moments and
    beta powers, so the second step agrees too; params carry the
    weights only, so the first loss does)."""
    src, dst = DIRECTIONS[direction]
    fn = FILENAMES[filename]
    feeds = [_feed(1), _feed(2)]
    main, startup, _, loss = _mlp(src)
    exe, scope = src.executor(), src.scope()
    d = str(tmp_path / "ckpt")
    with src.fluid.scope_guard(scope):
        exe.run(startup)
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss])
        getattr(src.fluid.io, f"save_{kind}")(exe, d, main_program=main,
                                              filename=fn)
        want = [_run(src, exe, main, f, [loss])[0] for f in feeds]
    tmain, tstartup, _, tloss = _mlp(dst)
    texe = dst.executor()
    with dst.fluid.scope_guard(dst.scope()):
        texe.run(tstartup)
        getattr(dst.fluid.io, f"load_{kind}")(texe, d, main_program=tmain,
                                              filename=fn)
        got = [_run(dst, texe, tmain, f, [tloss])[0] for f in feeds]
    n = 2 if kind == "persistables" else 1
    np.testing.assert_allclose(np.asarray(got[:n]), np.asarray(want[:n]),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_train_model_crosses(tmp_path, direction):
    """``save_train_model`` in one package; ``load_train_model`` in the
    other rebuilds main and startup from the bytes, runs the startup,
    restores the persistables, and trains on with the writer's losses."""
    src, dst = DIRECTIONS[direction]
    main, startup, _, loss = _mlp(src)
    exe, scope = src.executor(), src.scope()
    d = str(tmp_path / "train")
    feeds = [_feed(4), _feed(5), _feed(6)]
    with src.fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        src.fluid.io.save_train_model(exe, d, ["x", "y"], loss,
                                      main_program=main,
                                      startup_program=startup)
        want = [_run(src, exe, main, f, [loss])[0] for f in feeds[1:]]
    texe = dst.executor()
    with dst.fluid.scope_guard(dst.scope()):
        tmain, tstartup, feed_names, loss_name = \
            dst.fluid.io.load_train_model(texe, d)
        got = [_run(dst, texe, tmain, f, [loss_name])[0]
               for f in feeds[1:]]
    assert feed_names == ["x", "y"] and loss_name == loss.name
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in main.global_block().ops]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_encrypted_model_crosses(tmp_path, direction):
    """An encrypted model (program and every array file AES-GCM) saved by
    one package decrypts, loads and runs in the other; without the key
    the bytes are not a pickle."""
    src, dst = DIRECTIONS[direction]
    main, startup, feeds, fetch = _mlp_infer(src)
    exe = src.executor()
    d = str(tmp_path / "enc")
    feed = _feed(7)
    with src.fluid.scope_guard(src.scope()):
        exe.run(startup)
        src.fluid.io.save_inference_model(d, feeds, fetch, exe,
                                          main_program=main,
                                          encrypt_key=KEY)
        want = _run(src, exe, main, feed, fetch)
    feed = {"x": feed["x"]}   # the saved program is pruned to x -> pred
    with open(os.path.join(d, "__model__"), "rb") as f:
        with pytest.raises(Exception):
            pickle.loads(f.read())
    texe = dst.executor()
    with dst.fluid.scope_guard(dst.scope()):
        prog, fnames, fvars = dst.fluid.io.load_inference_model(
            d, texe, decrypt_key=KEY)
        got = _run(dst, texe, prog, feed, fvars)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# bfloat16: arrays bit for bit, dtypes in the program
# ---------------------------------------------------------------------------


def _bf16_program(fluid):
    prog = fluid.Program()
    prog.global_block().create_var(name="w_bf16", shape=(3, 5),
                                   dtype="bfloat16", persistable=True)
    return prog


@pytest.mark.parametrize("filename", sorted(FILENAMES))
def test_bf16_persistable_jax_to_torch_bit_identical(tmp_path, filename):
    words = np.random.default_rng(8).integers(
        0, 2 ** 16, (3, 5)).astype(np.uint16)
    words[0, :3] = [0x7FC0, 0xFF80, 0x0001]   # NaN, -inf, a subnormal
    import jax.numpy as jnp

    scope = jfluid.Scope()
    scope.set_var("w_bf16", jnp.asarray(words.view(ml_dtypes.bfloat16)))
    d = str(tmp_path / "bf16")
    with jfluid.scope_guard(scope):
        jfluid.io.save_persistables(None, d, main_program=_bf16_program(
            jfluid), filename=FILENAMES[filename])
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        tfluid.io.load_persistables(tfluid.Executor(device="cpu"), d,
                                    main_program=_bf16_program(tfluid),
                                    filename=FILENAMES[filename])
    t = tscope.find_var("w_bf16")
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), words)


@pytest.mark.parametrize("filename", sorted(FILENAMES))
def test_bf16_persistable_torch_to_jax_bit_identical(tmp_path, filename):
    """The port writes the bytes the JAX package writes for the same bf16
    array (the ``.npy`` file byte for byte; the ``.npz`` entry), and
    ml_dtypes reads them back bit for bit."""
    words = np.random.default_rng(9).integers(
        0, 2 ** 16, (3, 5)).astype(np.uint16)
    fn = FILENAMES[filename]
    tscope = tfluid.Scope()
    tscope.set_var("w_bf16",
                   torch.from_numpy(words.view(np.int16)).view(torch.bfloat16))
    td, jd = str(tmp_path / "torch"), str(tmp_path / "jax")
    with tfluid.scope_guard(tscope):
        tfluid.io.save_persistables(None, td, main_program=_bf16_program(
            tfluid), filename=fn)
    import jax.numpy as jnp

    jscope = jfluid.Scope()
    jscope.set_var("w_bf16", jnp.asarray(words.view(ml_dtypes.bfloat16)))
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(None, jd, main_program=_bf16_program(
            jfluid), filename=fn)
    if fn is None:
        with open(os.path.join(td, "w_bf16.npy"), "rb") as a, \
                open(os.path.join(jd, "w_bf16.npy"), "rb") as b:
            assert a.read() == b.read()
        arr = np.load(os.path.join(td, "w_bf16.npy"))
    else:
        arr = np.load(os.path.join(td, fn))["w_bf16"]
        with np.load(os.path.join(jd, fn)) as z:
            assert z["w_bf16"].dtype == arr.dtype
            assert z["w_bf16"].tobytes() == arr.tobytes()
    back = arr.view(ml_dtypes.bfloat16)
    assert np.array_equal(back.view(np.uint16), words)


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_bf16_program_crosses(tmp_path, direction):
    """A program with bf16 vars and bf16 dtype attrs (a cast to bf16, a
    relu, a cast back) pickles in one package and runs in the other: the
    var dtype reads as that package's bfloat16, the output equals the
    writer's bit for bit (each step is exact on bf16 values)."""
    src, dst = DIRECTIONS[direction]
    fluid = src.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [2, 6], dtype="float32",
                              append_batch_size=False)
        h = fluid.layers.cast(x, "bfloat16")
        out = fluid.layers.cast(fluid.layers.relu(h), "float32")
    exe = src.executor()
    d = str(tmp_path / "cast")
    feed = {"x": np.random.default_rng(10).standard_normal(
        (2, 6)).astype(np.float32)}
    with src.fluid.scope_guard(src.scope()):
        src.fluid.io.save_inference_model(d, ["x"], [out], exe,
                                          main_program=main)
        want = _run(src, exe, main, feed, [out])
    texe = dst.executor()
    with dst.fluid.scope_guard(dst.scope()):
        prog, _, fvars = dst.fluid.io.load_inference_model(d, texe)
        got = _run(dst, texe, prog, feed, fvars)
    bvar = prog.global_block().var(h.name)
    if dst is TORCH:
        assert bvar.dtype is bfloat16
    else:
        assert np.dtype(bvar.dtype) == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got[0], want[0])


def test_bf16_void_array_needs_a_bf16_var(tmp_path):
    """A 2-byte void on disk is read as bf16 only for a bf16 var."""
    scope = tfluid.Scope()
    scope.set_var("w_bf16", torch.zeros(2, 2, dtype=torch.bfloat16))
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(None, str(tmp_path),
                                    main_program=_bf16_program(tfluid))
    prog = tfluid.Program()
    prog.global_block().create_var(name="w_bf16", shape=(2, 2),
                                   dtype="float32", persistable=True)
    with pytest.raises(TypeError, match="read as bfloat16"):
        tfluid.io.load_persistables(tfluid.Executor(device="cpu"),
                                    str(tmp_path), main_program=prog)


# ---------------------------------------------------------------------------
# buffers, crash safety, refusals
# ---------------------------------------------------------------------------


def test_inference_model_saves_buffers(tmp_path):
    """Non-trainable persistables (a batch norm's running mean and
    variance) are saved with the model and restored: the loaded model
    normalizes with the trained statistics, not the initial ones."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4, 3, 2, 2], dtype="float32",
                               append_batch_size=False)
        y = tfluid.layers.batch_norm(x)
        loss = tfluid.layers.reduce_mean(y)
    exe = tfluid.Executor(device="cpu")
    feed = {"x": np.random.default_rng(11).standard_normal(
        (4, 3, 2, 2)).astype(np.float32) * 3 + 1}
    d = str(tmp_path / "bn")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(3):   # training mode: moves the running stats
            exe.run(main, feed=feed, fetch_list=[loss])
        test = main.clone(for_test=True)
        want = _run(TORCH, exe, test, feed, [y])
        tfluid.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
    buffers = [v.name for v in main.list_vars()
               if v.persistable and not v.trainable]
    assert len(buffers) == 2
    for n in buffers:
        assert os.path.exists(os.path.join(d, n + ".npy"))
    got = TORCH.predictor(TORCH.load_frozen(d)).run(feed)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


def test_atomic_saves_survive_crash_mid_write(tmp_path, monkeypatch):
    """Every save writes tmp + os.replace: a crash before the replace
    leaves the previous checkpoint intact and loadable, and no temp
    file behind."""
    main, startup, _, loss = _mlp(TORCH)
    exe = TORCH.executor()
    feed = _feed(12)
    d = str(tmp_path / "train_model")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        tfluid.io.save_train_model(exe, d, ["x", "y"], loss,
                                   main_program=main,
                                   startup_program=startup)
        (ref,) = _run(TORCH, exe, main, feed, [loss])
        real_replace = os.replace

        def boom(src, dst):
            raise OSError("simulated crash before rename")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError, match="simulated crash"):
            tfluid.io.save_train_model(exe, d, ["x", "y"], loss,
                                       main_program=main,
                                       startup_program=startup)
        monkeypatch.setattr(os, "replace", real_replace)
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    with tfluid.scope_guard(tfluid.Scope()):
        lmain, _, _, loss_name = tfluid.io.load_train_model(exe, d)
        (lv,) = _run(TORCH, exe, lmain, feed, [loss_name])
    np.testing.assert_allclose(lv, ref, rtol=1e-6)


def _ps_program():
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name="ids", shape=(4, 1), dtype="int64")
    blk.create_var(name="emb", shape=(4, 8), dtype="float32")
    blk.append_op(type="distributed_lookup_table", inputs={"Ids": ["ids"]},
                  outputs={"Outputs": ["emb"]},
                  attrs={"table_names": ["emb_table"]}, infer=False)
    return prog


REFUSED = {
    "save": lambda d: tio.save(tfluid.Program(), d),
    "load": lambda d: tio.load(tfluid.Program(), d),
    "save_persistables_ps": lambda d: tio.save_persistables(
        None, d, main_program=_ps_program()),
    "load_persistables_ps": lambda d: tio.load_persistables(
        None, d, main_program=_ps_program()),
    "save_ps_tables": lambda d: tio._save_ps_tables(d, _ps_program()),
    "load_ps_tables": lambda d: tio._load_ps_tables(d, _ps_program()),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_save_paths_raise(tmp_path, name):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A[56]"):
        REFUSED[name](str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")


# ---------------------------------------------------------------------------
# the file-based Config / Predictor
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_saved(tmp_path):
    main, startup, feeds, fetch = _mlp_infer(JAX)
    exe = JAX.executor()
    d = str(tmp_path / "model")
    with jfluid.scope_guard(JAX.scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(d, feeds, fetch, exe,
                                       main_program=main)
    x = _feed(13)["x"]
    want = np.asarray(jinference.create_predictor(
        jinference.Config(d)).run([x])[0])
    return d, x, want


def test_config_predictor_runs_a_jax_saved_model(jax_saved):
    d, x, want = jax_saved
    cfg = tinference.Config(d)
    cfg.disable_gpu()
    pred = tinference.create_predictor(cfg)
    assert pred.device == torch.device("cpu")
    (got,) = pred.run([x])
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the handle surface: copy in, run, copy out
    name_in, = pred.get_input_names()
    h = pred.get_input_handle(name_in)
    h.copy_from_cpu(x)
    assert pred.run() is True
    out = pred.get_output_handle(pred.get_output_names()[0])
    np.testing.assert_allclose(out.copy_to_cpu(), want, atol=TOL, rtol=0)
    assert out.shape() == list(want.shape)
    # a clone shares the weights and keeps its own feeds
    twin = pred.clone()
    assert twin._scope is pred._scope
    np.testing.assert_allclose(twin.run([x])[0], want, atol=TOL, rtol=0)
    # the legacy aliases, and prog_file naming the model file
    legacy = tinference.Config(prog_file=os.path.join(d, "__model__"))
    legacy.disable_gpu()
    np.testing.assert_allclose(
        tinference.create_paddle_predictor(legacy).run([x])[0], want,
        atol=TOL, rtol=0)


def test_share_external_data_adopts_a_tensor_without_a_copy(jax_saved):
    d, x, want = jax_saved
    cfg = tinference.Config(d)
    cfg.disable_gpu()
    pred = tinference.create_predictor(cfg)
    t = torch.from_numpy(x.copy())
    h = pred.get_input_handle("x")
    h.share_external_data(t)
    assert pred._feed["x"] is t
    pred.run()
    np.testing.assert_allclose(
        pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu(),
        want, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="lives on meta"):
        h.share_external_data(torch.empty(4, 8, device="meta"))
    with pytest.raises(RuntimeError, match="output handle"):
        pred.get_output_handle(pred.get_output_names()[0]).copy_from_cpu(x)


def test_config_refusals_and_device_default(jax_saved, monkeypatch):
    d, _, _ = jax_saved
    with pytest.raises(NotImplementedError, match="TensorRT"):
        tinference.Config(d).enable_tensorrt_engine()
    with pytest.raises(ValueError, match="model_dir or prog_file"):
        cfg = tinference.Config()
        cfg.disable_gpu()
        tinference.create_predictor(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinference.create_predictor(tinference.Config(d))
    cfg = tinference.Config(d)
    cfg.disable_gpu()
    cfg.enable_use_gpu(device_id=0)   # back to the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinference.create_predictor(cfg)
