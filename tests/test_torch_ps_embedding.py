"""The port's host-resident PS embedding (``paddle_tpu_torch/distributed/
ps.py`` and the ``distributed_lookup_table`` op, ``ops/ps_ops.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_ps_embedding.py`` case for case.  Tables: the same
gathers and pushes on both packages' tables leave states equal bit for
bit (same seed, same shard layout, the same float32 numpy updates), and
a ``state_dict`` one package writes loads in the other.  The lookup op:
the same program (``distributed_embedding`` + fc + Adam) built in both
packages under ``unique_name.guard()``, the JAX startup scope copied
across, gives loss traces and touched rows within 1e-5 (f32) over the
same steps; the table never enters the port's scope, untouched rows do
not move, and the op pushes exactly once a step.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.ops import ps_ops

TOL = 1e-5
PS = {"jax": jps, "torch": tps}


def _both(name, **kw):
    out = {}
    for k, mod in PS.items():
        mod.drop_table(name)
        out[k] = mod.create_table(name, **kw)
    return out


@pytest.fixture
def tables():
    name = "test_table"
    t = _both(name, shape=(10_000, 16), num_shards=4, optimizer="sgd",
              learning_rate=0.5, seed=0)
    yield t
    for mod in PS.values():
        mod.drop_table(name)


def _equal(tabs):
    np.testing.assert_array_equal(tabs["torch"].to_dense(),
                                  tabs["jax"].to_dense())


def test_gather_and_push_semantics(tables):
    ids = np.asarray([3, 9_999, 3, 42], np.int64)
    _equal(tables)
    table = tables["torch"]
    rows = table.gather(ids)
    np.testing.assert_array_equal(rows, tables["jax"].gather(ids))
    dense = table.to_dense()
    np.testing.assert_allclose(rows, dense[ids], rtol=1e-6)
    # duplicate ids accumulate before the update (SelectedRows merge-add)
    g = np.ones((4, 16), np.float32)
    before = dense[3].copy()
    for t in tables.values():
        t.push_gradients(ids, g)
    np.testing.assert_allclose(table.to_dense()[3], before - 0.5 * 2.0,
                               rtol=1e-5)
    _equal(tables)
    assert table.push_calls == tables["jax"].push_calls == 1
    assert table.pushed_bytes == tables["jax"].pushed_bytes
    assert table.memory_stats() == tables["jax"].memory_stats()


def _lookup_program(fluid, b, ncls, table_name, opt=None):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        w = L.data("ids", [b], dtype="int64", append_batch_size=False)
        y = L.data("y", [b, 1], dtype="int64", append_batch_size=False)
        emb = L.distributed_embedding(w, table_name)
        logits = L.fc(emb, ncls)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        (opt or (lambda f: f.optimizer.AdamOptimizer(
            learning_rate=5e-3)))(fluid).minimize(loss)
    return main, startup, loss


def _run_both(progs, feed, steps):
    """Startup in the JAX package, its scope copied into the port's, then
    ``steps`` steps of each: (jax losses, torch losses, torch scope)."""
    (jm, js, jl), (tm, ts, tl) = progs
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    texe = tfluid.Executor(device="cpu")
    jl_, tl_ = [], []
    for _ in range(steps):
        jl_.append(float(np.asarray(jexe.run(
            jm, feed=feed, fetch_list=[jl], scope=jscope)[0]).reshape(())))
        tl_.append(float(np.asarray(texe.run(
            tm, feed=feed, fetch_list=[tl], scope=tscope)[0]).reshape(())))
    return jl_, tl_, tscope


def test_lookup_op_trains_and_table_stays_off_device(tables):
    """End to end: embedding classification whose table updates land on
    the HOST, in both packages; the port's scope never holds the table."""
    B, NCLS = 32, 7
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 10_000, (B,)).astype(np.int64)
    label = (ids % NCLS).astype(np.int64)[:, None]
    progs = [_lookup_program(f, B, NCLS, "test_table")
             for f in (jfluid, tfluid)]
    assert [op.type for op in progs[1][0].global_block().ops] == \
        [op.type for op in progs[0][0].global_block().ops]
    dense_before = tables["torch"].to_dense().copy()
    ps_ops.reset_stats()
    jl, tl, tscope = _run_both(progs, {"ids": ids, "y": label}, 60)
    # one lookup and one push a step, never more
    assert ps_ops.stats["lookups"] == ps_ops.stats["pushes"] == 60
    assert all(tuple(v.shape) != (10_000, 16) for v in tscope.vars.values()
               if v is not None)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
    assert tl[-1] < tl[0] * 0.35, (tl[0], tl[-1])
    dense_after = tables["torch"].to_dense()
    touched = np.unique(ids)
    np.testing.assert_allclose(dense_after[touched],
                               tables["jax"].to_dense()[touched],
                               rtol=TOL, atol=1e-6)
    assert not np.allclose(dense_after[touched], dense_before[touched])
    untouched = np.setdiff1d(np.arange(10_000), touched)[:100]
    np.testing.assert_array_equal(dense_after[untouched],
                                  dense_before[untouched])


def test_lookup_trains_on_virtual_mesh(tables):
    """A fleet-minimized step with the host table: the JAX package's dp 4
    on its virtual mesh against the port's group-less dp 1 in one
    process (the dp mean of 4 quarter batches is the full-batch mean, and
    the push happens once a step either way)."""
    import paddle_tpu.fleet as jfleet
    import paddle_tpu_torch.fleet as tfleet

    B, NCLS = 32, 5
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 10_000, (B,)).astype(np.int64)
    label = (ids % NCLS).astype(np.int64)[:, None]

    def fleet_opt(fleet, dp):
        def make(f):
            fleet.init()
            s = fleet.DistributedStrategy()
            s.mesh_axes = {"dp": dp}
            return fleet.distributed_optimizer(
                f.optimizer.AdamOptimizer(learning_rate=5e-3), s)
        return make

    progs = [_lookup_program(jfluid, B, NCLS, "test_table",
                             fleet_opt(jfleet, 4)),
             _lookup_program(tfluid, B, NCLS, "test_table",
                             fleet_opt(tfleet, 1))]
    jl, tl, _ = _run_both(progs, {"ids": ids, "y": label}, 40)
    assert all(np.isfinite(v) for v in tl)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
    assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
    touched = np.unique(ids)
    np.testing.assert_allclose(tables["torch"].to_dense()[touched],
                               tables["jax"].to_dense()[touched],
                               rtol=TOL, atol=1e-6)


def test_adagrad_server_optimizer():
    tabs = _both("ada_t", shape=(100, 4), num_shards=2,
                 optimizer="adagrad", learning_rate=1.0, seed=1)
    try:
        t = tabs["torch"]
        ids = np.asarray([5, 7], np.int64)
        g = np.full((2, 4), 2.0, np.float32)
        before = t.to_dense()[ids].copy()
        for tab in tabs.values():
            tab.push_gradients(ids, g)
        # adagrad: x -= lr * g / (sqrt(g^2) + eps) ~= lr * sign(g)
        after = t.to_dense()[ids]
        np.testing.assert_allclose(after, before - 1.0, rtol=1e-4)
        for tab in tabs.values():
            tab.push_gradients(ids, g)
        step2 = np.abs(after - t.to_dense()[ids])
        assert (step2 < 0.9).all()
        _equal(tabs)
        for a, b in zip(t.state_dict()["accum"],
                        tabs["jax"].state_dict()["accum"]):
            np.testing.assert_array_equal(a, b)
    finally:
        for mod in PS.values():
            mod.drop_table("ada_t")


def test_checkpoint_roundtrip(tables):
    table = tables["torch"]
    ids = np.asarray([1, 2, 3], np.int64)
    table.push_gradients(ids, np.ones((3, 16), np.float32))
    state = table.state_dict()
    snapshot = table.to_dense().copy()
    # a checkpoint is a snapshot: further training must not change it
    table.push_gradients(ids, np.ones((3, 16), np.float32))
    restored = _both("resume_t", shape=(10_000, 16), num_shards=4)
    try:
        # the port's state_dict loads in either package's table
        for t2 in restored.values():
            t2.load_state_dict(state)
            np.testing.assert_array_equal(t2.to_dense(), snapshot)
            assert not np.allclose(t2.to_dense()[ids],
                                   table.to_dense()[ids])
        t2 = restored["torch"]
        # restored tables are independent of the source
        t2.push_gradients(ids, np.ones((3, 16), np.float32))
        assert not np.allclose(t2.to_dense()[ids], snapshot[ids])
        np.testing.assert_array_equal(table.to_dense()[4:100],
                                      snapshot[4:100])
        # and the JAX package's state_dict loads in the port's table
        t2.load_state_dict(tables["jax"].state_dict())
        np.testing.assert_array_equal(t2.to_dense(),
                                      tables["jax"].to_dense())
    finally:
        for mod in PS.values():
            mod.drop_table("resume_t")


def test_out_of_range_ids_raise(tables):
    table = tables["torch"]
    with pytest.raises(IndexError, match="out of range"):
        table.gather(np.asarray([-1], np.int64))
    with pytest.raises(IndexError, match="out of range"):
        table.push_gradients(np.asarray([10_000], np.int64),
                             np.ones((1, 16), np.float32))
    # through the op: the lookup raises, nothing is clamped
    import torch

    anchor = torch.zeros(1, requires_grad=True)
    with pytest.raises(IndexError, match="out of range"):
        ps_ops.lookup(torch.tensor([0, 10_000]), anchor, "test_table")
    with pytest.raises(TypeError, match="integers"):
        ps_ops.lookup(torch.tensor([0.0]), anchor, "test_table")


def test_lookup_op_int64_ids_table_dtype_and_one_push_per_backward():
    """int64 ids past 2^31 reach the host untruncated (the JAX side
    narrows ids to int32, so this case is the port's own); the output
    keeps the table's dtype; a backward pushes once and the anchor's
    gradient is zero."""
    import torch

    tps.drop_table("wide_t")
    t = tps.create_table("wide_t", shape=(64, 4), num_shards=2,
                         optimizer="sgd", learning_rate=1.0, seed=0,
                         dtype="float16")
    try:
        ids = torch.tensor([[3, 5], [3, 63]], dtype=torch.int64)
        assert ps_ops._host_ids(ids + 2 ** 33).tolist() == [
            v + 2 ** 33 for v in (3, 5, 3, 63)]
        anchor = torch.zeros(1, requires_grad=True)
        ps_ops.reset_stats()
        out = ps_ops.lookup(ids, anchor, "wide_t")
        assert out.dtype == torch.float16 and out.shape == (2, 2, 4)
        np.testing.assert_array_equal(
            out.detach().numpy(), t.gather(ids.numpy()).reshape(2, 2, 4))
        before = t.to_dense().astype(np.float32)
        (ga,) = torch.autograd.grad(out.float().sum(), [anchor])
        assert ga.tolist() == [0.0]
        assert ps_ops.stats["pushes"] == 1 and t.push_calls == 1
        after = t.to_dense().astype(np.float32)
        np.testing.assert_allclose(after[3], before[3] - 2.0, atol=1e-2)
        np.testing.assert_allclose(after[5], before[5] - 1.0, atol=1e-2)
        # TIMING adds each copy's and host call's wall ms; off, only the
        # counts move
        assert ps_ops.stats["gather_ms"] == ps_ops.stats["push_ms"] == 0
        ps_ops.TIMING = True
        try:
            out = ps_ops.lookup(ids, anchor, "wide_t")
            torch.autograd.grad(out.float().sum(), [anchor])
        finally:
            ps_ops.TIMING = False
        assert ps_ops.stats["pushes"] == 2
        assert all(ps_ops.stats[k] > 0 for k in (
            "d2h_ids_ms", "gather_ms", "h2d_ms", "d2h_grad_ms", "push_ms"))
    finally:
        tps.drop_table("wide_t")


def _geo_train(mod, mode, K, STEPS, N, DIM):
    rng = np.random.RandomState(3)
    target = rng.randn(N, DIM).astype(np.float32)
    name = f"geo_cmp_{mode}"
    mod.drop_table(name)
    t = mod.create_table(name, shape=(N, DIM), num_shards=2,
                         optimizer="sgd", learning_rate=0.5, mode=mode,
                         geo_sync_steps=K, seed=1)
    server = t.server if mode == "geo" else t
    losses = []
    for _ in range(STEPS):
        ids = rng.randint(0, N, (32,)).astype(np.int64)
        rows = t.gather(ids).astype(np.float32)
        # L2 regression toward the target rows: grad = (w - target)
        g = rows - target[ids]
        losses.append(float(np.mean(g * g)))
        t.push_gradients(ids, g)
    if mode == "geo":
        t.flush()
    final = t.to_dense()
    err = float(np.mean((final - target) ** 2))
    mod.drop_table(name)
    return losses, err, server.push_calls, final


def test_geo_sgd_converges_and_saves_traffic():
    """Geo mode: K-step parameter-delta push converges while sending ~1/K
    the server pushes of per-step sync mode — in the port exactly as in
    the JAX package (same losses, same final table, bit for bit)."""
    K, STEPS, N, DIM = 5, 30, 200, 8
    got = {(k, m): _geo_train(mod, m, K, STEPS, N, DIM)
           for k, mod in PS.items() for m in ("sync", "geo")}
    for m in ("sync", "geo"):
        assert got[("torch", m)][:3] == got[("jax", m)][:3]
        np.testing.assert_array_equal(got[("torch", m)][3],
                                      got[("jax", m)][3])
    l_sync, _, calls_sync, _ = got[("torch", "sync")]
    l_geo, err_geo, calls_geo, _ = got[("torch", "geo")]
    assert l_sync[-1] < l_sync[0] / 5
    assert l_geo[-1] < l_geo[0] / 5
    assert err_geo < 0.1
    assert calls_sync == STEPS
    assert calls_geo <= STEPS // K + 1


def test_geo_sgd_matches_local_sgd_between_syncs():
    """Between syncs the geo client is EXACTLY local SGD; after a sync
    the server holds the accumulated delta (both packages equal)."""
    tabs = _both("geo_exact", shape=(50, 4), num_shards=2, optimizer="sgd",
                 learning_rate=0.1, mode="geo", geo_sync_steps=3, seed=2)
    try:
        t = tabs["torch"]
        ids = np.asarray([7, 7, 11], np.int64)
        w0 = t.gather(np.asarray([7, 11], np.int64)).astype(np.float32)
        server_before = t.server.to_dense()[[7, 11]].copy()
        g = np.ones((3, 4), np.float32)
        for tab in tabs.values():
            tab.push_gradients(ids, g)
        got = t.gather(np.asarray([7, 11], np.int64)).astype(np.float32)
        np.testing.assert_allclose(got[0], w0[0] - 0.2, rtol=1e-6)
        np.testing.assert_allclose(got[1], w0[1] - 0.1, rtol=1e-6)
        np.testing.assert_allclose(t.server.to_dense()[[7, 11]],
                                   server_before, rtol=1e-6)
        for _ in range(2):  # the 3rd push syncs
            for tab in tabs.values():
                tab.push_gradients(ids, g)
        np.testing.assert_allclose(t.server.to_dense()[7], w0[0] - 3 * 0.2,
                                   rtol=1e-5)
        np.testing.assert_allclose(t.server.to_dense()[11],
                                   w0[1] - 3 * 0.1, rtol=1e-5)
        np.testing.assert_array_equal(t.server.to_dense(),
                                      tabs["jax"].server.to_dense())
    finally:
        for mod in PS.values():
            mod.drop_table("geo_exact")
