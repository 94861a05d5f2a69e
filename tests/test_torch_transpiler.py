"""The port's ``DistributeTranspiler`` (``paddle_tpu_torch/fluid/
transpiler.py``) against the JAX package's, on the CPU.

Mirrors ``tests/test_transpiler.py`` case for case: each program is
built with plain ``layers.embedding`` in both packages under
``unique_name.guard()`` and transpiled the same way; the rewritten
programs hold the same ops, the JAX startup scope is copied into the
port's, and the loss traces and the host table's rows agree within 1e-5
(f32) over the same steps — in process, on a hosted pserver (the port's
client against the JAX package's server) and in geo mode.  The refusals
(transpile after minimize, padding_idx) and the initializer hand-over
are the JAX package's.
"""
from __future__ import annotations

import threading
import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed import ps_server as jps_server
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.fluid import analysis as tan

ROWS, DIM, NCLS, B = 3000, 16, 5, 16
TOL = 1e-5
PKG = {"jax": (jfluid, jps), "torch": (tfluid, tps)}


def _build(fluid, emb_name):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = L.data("ids", [B], dtype="int64", append_batch_size=False)
        y = L.data("y", [B, 1], dtype="int64", append_batch_size=False)
        emb = L.embedding(ids, size=[ROWS, DIM],
                          param_attr=fluid.ParamAttr(name=emb_name))
        logits = L.fc(emb, NCLS, param_attr=fluid.ParamAttr(name="cls_w"))
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    return main, startup, loss


def _transpiled(pkg, name, cfg_kw=None, opt=True, **transpile_kw):
    fluid, ps = PKG[pkg]
    ps.drop_table(name)
    with fluid.unique_name.guard():
        main, startup, loss = _build(fluid, name)
        cfg = fluid.DistributeTranspilerConfig()
        for k, v in (cfg_kw or {}).items():
            setattr(cfg, k, v)
        with fluid.program_guard(main, startup):
            tables = fluid.DistributeTranspiler(cfg).transpile(
                trainer_id=0, program=main, startup_program=startup,
                **transpile_kw)
            if opt:
                fluid.optimizer.AdamOptimizer(
                    learning_rate=5e-3).minimize(loss)
    return main, startup, loss, tables


def _train_both(progs, steps=80):
    """JAX startup, its scope copied into the port's, ``steps`` steps of
    each on one fixed batch: (jax losses, torch losses)."""
    (jm, js, jl), (tm, ts, tl) = progs
    rng = np.random.RandomState(0)
    ids = rng.randint(0, ROWS, (B,)).astype(np.int64)
    feed = {"ids": ids, "y": (ids % NCLS).astype(np.int64)[:, None]}
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    texe = tfluid.Executor(device="cpu")
    out = ([], [])
    for _ in range(steps):
        out[0].append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl], scope=jscope)[0]).reshape(())))
        out[1].append(float(np.asarray(texe.run(
            tm, feed=feed, fetch_list=[tl], scope=tscope)[0]).reshape(())))
    return out


def _ops(prog):
    return [(op.type, sorted(op.inputs), sorted(op.outputs))
            for op in prog.global_block().ops]


def test_transpile_rewrites_lookup_and_trains():
    name = "tp_emb1"
    got = {k: _transpiled(k, name, {"server_learning_rate": 0.5})
           for k in PKG}
    try:
        main, startup, loss, tables = got["torch"]
        assert tables == got["jax"][3] == [name]
        assert _ops(main) == _ops(got["jax"][0])
        assert _ops(startup) == _ops(got["jax"][1])
        block = main.global_block()
        assert not any(op.type.startswith("lookup_table")
                       for op in block.ops)
        dl = [op for op in block.ops
              if op.type == "distributed_lookup_table"]
        assert len(dl) == 1 and dl[0].attr("table_names") == [name]
        # W left the device program entirely
        assert block._find_var_recursive(name) is None
        assert not any(name in [n for ns in op.outputs.values() for n in ns]
                       for op in startup.global_block().ops)
        jl, tl = _train_both([got["jax"][:3], got["torch"][:3]])
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
        assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
        table = tps.get_table(name)
        assert table.rows == ROWS and table.dim == DIM
        assert table.push_calls == jps.get_table(name).push_calls == 80
        np.testing.assert_allclose(table.to_dense(),
                                   jps.get_table(name).to_dense(),
                                   rtol=TOL, atol=1e-6)
    finally:
        for _, ps in PKG.values():
            ps.drop_table(name)


def test_transpile_after_minimize_raises():
    name = "tp_emb2"
    tps.drop_table(name)
    with tfluid.unique_name.guard():
        main, startup, loss = _build(tfluid, name)
        with tfluid.program_guard(main, startup):
            tfluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
            with pytest.raises(RuntimeError, match="BEFORE minimize"):
                tfluid.DistributeTranspiler().transpile(
                    trainer_id=0, program=main, startup_program=startup)
    with pytest.raises(KeyError):
        tps.get_table(name)


def test_transpile_min_rows_threshold_keeps_small_tables_on_device():
    name = "tp_emb3"
    main, _, _, tables = _transpiled(
        "torch", name, {"min_rows_for_ps": ROWS + 1}, opt=False)
    assert tables == []
    assert any(op.type.startswith("lookup_table")
               for op in main.global_block().ops)
    tps.drop_table(name)


def test_transpile_to_hosted_pserver():
    """pservers="host:port" routes the transpiled table through the
    networked data plane: the port's RemoteTable against the JAX
    package's pserver, trained beside an in-process JAX table."""
    addr, ready = {}, threading.Event()

    def cb(a):
        addr["ep"] = f"127.0.0.1:{a[1]}"
        ready.set()

    th = threading.Thread(target=jps_server.serve,
                          args=(0, "127.0.0.1", cb), daemon=True)
    th.start()
    assert ready.wait(10)
    name = "tp_emb4"
    try:
        got = {"jax": _transpiled("jax", name,
                                  {"server_learning_rate": 0.5}),
               "torch": _transpiled("torch", name,
                                    {"server_learning_rate": 0.5},
                                    pservers=addr["ep"], trainers=1)}
        table = tps.get_table(name)
        assert type(table).__name__ == "RemoteTable"
        jl, tl = _train_both([got["jax"][:3], got["torch"][:3]])
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
        assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
        assert table.stats()["push_calls"] == 80
    finally:
        for _, ps in PKG.values():
            ps.drop_table(name)
        try:
            jps_server._Conn(addr["ep"]).call("shutdown")
        except Exception:
            pass


def test_transpile_geo_mode():
    name = "tp_emb5"
    cfg = {"mode": "geo", "geo_sgd_need_push_nums": 5,
           "server_learning_rate": 0.5}
    got = {k: _transpiled(k, name, cfg) for k in PKG}
    try:
        table = tps.get_table(name)
        assert type(table).__name__ == "GeoSGDClient"
        jl, tl = _train_both([got["jax"][:3], got["torch"][:3]])
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
        assert tl[-1] < tl[0] * 0.6, (tl[0], tl[-1])
        assert table.server.push_calls == jps.get_table(
            name).server.push_calls == 80 // 5
    finally:
        for _, ps in PKG.values():
            ps.drop_table(name)


def _tied(fluid, name):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        a = L.data("a", [B], dtype="int64", append_batch_size=False)
        b = L.data("b", [B], dtype="int64", append_batch_size=False)
        ea = L.embedding(a, size=[ROWS, DIM],
                         param_attr=fluid.ParamAttr(name=name))
        eb = L.embedding(b, size=[ROWS, DIM],
                         param_attr=fluid.ParamAttr(name=name))
        loss = L.mean(L.square(L.elementwise_sub(ea, eb)))
        tables = fluid.DistributeTranspiler().transpile(
            trainer_id=0, program=main, startup_program=startup)
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss, tables


def test_transpile_tied_embeddings_one_table():
    """Two lookup ops sharing one W (tied embeddings) get ONE table and
    both ops rewritten; one step's loss and table are the JAX
    package's."""
    name = "tp_emb_tied"
    for _, ps in PKG.values():
        ps.drop_table(name)
    got = {k: _tied(PKG[k][0], name) for k in PKG}
    try:
        main, startup, loss, tables = got["torch"]
        assert tables == [name]
        assert _ops(main) == _ops(got["jax"][0])
        dl = [op for op in main.global_block().ops
              if op.type == "distributed_lookup_table"]
        assert len(dl) == 2
        rng = np.random.RandomState(1)
        feed = {"a": rng.randint(0, ROWS, (B,)).astype(np.int64),
                "b": rng.randint(0, ROWS, (B,)).astype(np.int64)}
        lv = {}
        for k in PKG:
            fluid = PKG[k][0]
            m, s, loss_k, _ = got[k]
            kw = {"device": "cpu"} if k == "torch" else {}
            exe = fluid.Executor(**kw)
            scope = fluid.Scope()
            exe.run(s, scope=scope)
            lv[k] = float(np.asarray(exe.run(
                m, feed=feed, fetch_list=[loss_k],
                scope=scope)[0]).reshape(()))
        assert np.isfinite(lv["torch"])
        np.testing.assert_allclose(lv["torch"], lv["jax"], rtol=TOL)
        np.testing.assert_allclose(tps.get_table(name).to_dense(),
                                   jps.get_table(name).to_dense(),
                                   rtol=TOL, atol=1e-6)
    finally:
        for _, ps in PKG.values():
            ps.drop_table(name)


def test_transpile_rejects_padding_idx():
    name = "tp_emb_pad"
    tps.drop_table(name)
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        ids = L.data("ids", [B], dtype="int64", append_batch_size=False)
        L.embedding(ids, size=[ROWS, DIM], padding_idx=0,
                    param_attr=tfluid.ParamAttr(name=name))
        with pytest.raises(NotImplementedError, match="padding_idx"):
            tfluid.DistributeTranspiler().transpile(
                trainer_id=0, program=main, startup_program=startup)
    tps.drop_table(name)


def test_transpile_carries_gaussian_init_and_warns_on_others():
    from paddle_tpu_torch.fluid.initializer import NormalInitializer

    name = "tp_emb_init"
    L = tfluid.layers
    for init, warns in ((NormalInitializer(0.0, 0.33), False),
                        (tfluid.initializer.ConstantInitializer(0.5), True)):
        tps.drop_table(name)
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            ids = L.data("ids", [B], dtype="int64", append_batch_size=False)
            L.embedding(ids, size=[ROWS, DIM],
                        param_attr=tfluid.ParamAttr(name=name,
                                                    initializer=init))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tfluid.DistributeTranspiler().transpile(
                    trainer_id=0, program=main, startup_program=startup)
        got = [str(w.message) for w in caught
               if "cannot reproduce" in str(w.message)]
        assert bool(got) == warns, got
        table = tps.get_table(name)
        if not warns:
            # std carried into the host table's init
            assert abs(float(table.to_dense().std()) - 0.33) < 0.02
    tps.drop_table(name)


def test_transpile_under_program_verify_checks_the_table_geometry():
    """FLAGS_program_verify runs the cross-program lint on the transpile
    result; a stale table of another dim is an ERROR naming it, as in the
    JAX package."""
    name = "tp_emb_verify"
    main, _, _, _ = _transpiled("torch", name, opt=False)
    assert tan.check_ps_geometry(main) == []
    tps.drop_table(name)
    tps.create_table(name, shape=(ROWS, DIM + 1))
    try:
        got = tan.check_ps_geometry(main)
        assert [f.check for f in got] == ["ps-table-geometry"]
        tfluid.set_flags({"FLAGS_program_verify": True})
        try:
            with pytest.raises(tan.ProgramVerifyError,
                               match="ps-table-missing"):
                tps.drop_table("tp_emb_verify2")
                with tfluid.unique_name.guard():
                    m2, s2, _ = _build(tfluid, "tp_emb_verify2")
                    with tfluid.program_guard(m2, s2):
                        m2.global_block().append_op(
                            type="distributed_lookup_table",
                            inputs={"Ids": ["ids"]},
                            outputs={"Outputs": [m2.global_block().ops[
                                0].output("Out")[0]]},
                            attrs={"table_names": ["no_such_table"]},
                            infer=False)
                        tfluid.DistributeTranspiler().transpile(
                            trainer_id=0, program=m2, startup_program=s2)
        finally:
            tfluid.set_flags({"FLAGS_program_verify": False})
    finally:
        for n in (name, "tp_emb_verify2"):
            tps.drop_table(n)
