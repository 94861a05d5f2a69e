"""The port's meta-optimizers against the JAX package's, on the CPU: the
counterparts of the JAX package's tests/test_meta_optimizers.py, each
also held against the JAX run.

Both packages build the reference's small MLP (``_mlp``: fc 8 -> 32 ->
32 -> 4, softmax cross-entropy) under ``unique_name.guard()``; the JAX
startup scope is copied across, so both train from the same weights on
the same numpy batches.  Tolerances: 2e-5 against the JAX run (f32, the
same math in another order), and the JAX tests' own limits against the
numpy forms of each rule.

* Recompute (``RecomputeOptimizer``, checkpoints h1 and h2): the loss
  trace and weights equal the run without it and the JAX package's
  recompute run; the program fuses the same segments into
  ``recompute_segment`` ops as the JAX package's.
* Recompute over batch norm and dropout 0.3: the run with recompute
  equals the run without it from the same weights and seed (the replay
  in the backward draws the forward's masks, and both draw what the
  unfused program draws), the running statistics included; a segment
  run twice in one step context gives the same outputs and draws once;
  ``clone(for_test=True)`` sets ``is_test`` inside the fused segments,
  and its forward equals the JAX package's eval clone's.
* Gradient merge (k_steps 2, avg): the weights equal plain SGD on the
  concatenated batches and the JAX package's merged run; over LAMB the
  parameters, moments and beta powers are bit for bit unchanged after
  each non-boundary step and all move on the boundary.
* Lookahead (k 2, alpha 0.5): the rule w0 + alpha (fast - w0) at the
  boundary, and the JAX package's run.
* ExponentialMovingAverage (with ``thres_steps`` too) and
  ``ModelAverage``: ``apply()`` against numpy forms and the JAX
  package's applied values; ``restore()`` puts back the very tensors.
* fleet's ``strategy.recompute`` with ``strategy.gradient_merge``: the
  loss trace against the JAX package's fleet run.
"""
from __future__ import annotations

import numpy as np
import torch

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fleet as tfleet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

TOL = 2e-5


def _mlp(L, x, label, hidden=32):
    h1 = L.fc(x, size=hidden, act="relu")
    h2 = L.fc(h1, size=hidden, act="relu")
    logits = L.fc(h2, size=4)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return loss, (h1, h2)


def _batches(n, bs=16, dim=8, seed0=0):
    out = []
    for s in range(n):
        rng = np.random.RandomState(seed0 + s)
        out.append((rng.randn(bs, dim).astype(np.float32),
                    rng.randint(0, 4, size=(bs, 1)).astype(np.int64)))
    return out


def _build(fluid, wrap, net=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[8])
        label = L.data("label", shape=[1], dtype="int64")
        loss, hs = (net or _mlp)(L, x, label)
        extra = wrap(fluid, loss, *hs) if wrap is not None else None
    return main, startup, loss, hs, extra


def _both(wrap, data, net=None, after=None):
    """Train ``wrap``'s program in both packages from the JAX package's
    startup weights over ``data``: the loss traces, the final scopes
    (name -> numpy) and ``after(fluid, scope, extra, main)``'s result."""
    out = {}
    state = None
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup, loss, hs, extra = _build(fluid, wrap, net)
        if name == "jax":
            scope, exe = jfluid.executor.Scope(), jfluid.Executor()
            with jfluid.scope_guard(scope):
                exe.run(startup)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
        else:
            scope = tfluid.Scope.from_numpy(state, device="cpu")
            exe = tfluid.Executor(device="cpu")
        losses = []
        with fluid.scope_guard(scope):
            for bx, by in data:
                lv = exe.run(main, feed={"x": bx, "label": by},
                             fetch_list=[loss])[0]
                losses.append(float(np.asarray(lv).reshape(-1)[0]))
            res = after(fluid, scope, extra, main) if after else None
        final = {n: (v.numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v)) for n, v in scope.vars.items()
                 if v is not None}
        out[name] = (losses, final, res, main)
    return out, state


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _recompute(sgd_lr=0.1):
    def wrap(fluid, loss, h1, h2):
        opt = fluid.optimizer.RecomputeOptimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=sgd_lr))
        opt._set_checkpoints([h1, h2])
        opt.minimize(loss)
    return wrap


def _sgd(fluid, loss, h1, h2):
    fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)


def test_recompute_matches_baseline_and_jax():
    data = _batches(6)
    rc, _ = _both(_recompute(), data)
    base, _ = _both(_sgd, data)
    _close(rc["port"][0], rc["jax"][0])
    _close(rc["port"][0], base["port"][0])
    for n, v in base["port"][1].items():
        _close(rc["port"][1][n], v)
        _close(rc["port"][1][n], rc["jax"][1][n])


def test_recompute_fuses_the_same_segments_as_jax():
    programs = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, *_ = _build(fluid, _recompute())
        programs[name] = main.global_block().ops
    types = [op.type for op in programs["port"]]
    assert types == [op.type for op in programs["jax"]]
    assert types.count("recompute_segment") >= 2
    for t, j in zip(programs["port"], programs["jax"]):
        if t.type == "recompute_segment":
            assert t.inputs == j.inputs and t.outputs == j.outputs
            assert [s.type for s in t.attr("recompute_sub_ops")] == [
                s.type for s in j.attr("recompute_sub_ops")]
            assert t.attr("recompute_seg_salt") == j.attr(
                "recompute_seg_salt")


def _bn_dropout_net(L, x, label):
    h1 = L.fc(x, size=16)
    h1 = L.batch_norm(h1, act="relu")
    h1 = L.dropout(h1, dropout_prob=0.3)
    h2 = L.fc(h1, size=16, act="relu")
    logits = L.fc(h2, size=4)
    return L.mean(L.softmax_with_cross_entropy(logits, label)), (h1, h2)


def _bn_program(fluid, recompute):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", shape=[8])
        label = L.data("label", shape=[1], dtype="int64")
        loss, (h1, h2) = _bn_dropout_net(L, x, label)
        test_prog = main.clone(for_test=True)
        opt = fluid.optimizer.SGDOptimizer(learning_rate=0.05)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h1, h2])
        opt.minimize(loss)
    return main, startup, loss, test_prog


def test_recompute_segment_with_batch_norm_and_dropout():
    data = _batches(4)
    jm, js, jl, jtest = _bn_program(jfluid, True)
    jscope, jexe = jfluid.executor.Scope(), jfluid.Executor()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        j_eval = np.asarray(jexe.run(jtest, feed={"x": data[0][0],
                                                  "label": data[0][1]},
                                     fetch_list=[jl.name])[0])
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    runs = {}
    for recompute in (False, True):
        main, startup, loss, test_prog = _bn_program(tfluid, recompute)
        scope = tfluid.Scope.from_numpy(state, device="cpu")
        exe = tfluid.Executor(device="cpu")
        ev = exe.run(test_prog, feed={"x": data[0][0], "label": data[0][1]},
                     fetch_list=[loss.name], scope=scope)[0]
        _close(ev, j_eval)
        losses = [float(exe.run(main, feed={"x": bx, "label": by},
                                fetch_list=[loss], scope=scope)[0][0])
                  for bx, by in data]
        # the eval clone: dropout off, the same loss twice
        e1, e2 = (exe.run(test_prog, feed={"x": data[0][0],
                                           "label": data[0][1]},
                          fetch_list=[loss.name], scope=scope)[0]
                  for _ in range(2))
        np.testing.assert_array_equal(e1, e2)
        runs[recompute] = (losses, {n: v.numpy() for n, v in
                                    scope.vars.items()}, main, test_prog)
    assert np.isfinite(runs[True][0]).all()
    # the same masks as the unfused run: the same losses and state
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6,
                               atol=1e-6)
    assert sorted(runs[True][1]) == sorted(runs[False][1])
    for n, v in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][n], v, rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # the running statistics, written inside a segment, moved
    stats = [n for n in state if "batch_norm" in n and
             not np.array_equal(runs[True][1][n], state[n])]
    assert len(stats) >= 2
    main = runs[True][2]
    segs = [op for op in main.global_block().ops
            if op.type == "recompute_segment"]
    assert segs and any(s.type == "dropout" for op in segs
                        for s in op.attr("recompute_sub_ops"))
    # a segment's sub-ops are copied into the eval clone, is_test set
    clone = main.clone(for_test=True)
    for op, orig in zip([op for op in clone.global_block().ops
                         if op.type == "recompute_segment"], segs):
        for s, o in zip(op.attr("recompute_sub_ops"),
                        orig.attr("recompute_sub_ops")):
            assert s is not o
            if "is_test" in o.attrs:
                assert s.attr("is_test") is True
                assert o.attr("is_test") is False
    # the segment holding dropout, run twice in one step context: the
    # second run (the backward's replay) draws the first run's mask
    seg = next(op for op in segs if any(
        s.type == "dropout" for s in op.attr("recompute_sub_ops")))
    spec = treg.get("recompute_segment")
    rng = np.random.default_rng(1)
    ins = {"X": []}
    for n in seg.input("X"):
        v = main.global_block().var(n)
        shape = [16 if d == -1 else d for d in v.shape]
        ins["X"].append(torch.as_tensor(
            rng.standard_normal(shape).astype(np.float32)
            if str(v.dtype) == "float32" else
            rng.integers(0, 4, shape).astype(np.int64)))
    ctx = treg.EmitContext(seed=5)
    first = spec.emit(ctx, ins, dict(seg.attrs))["Out"]
    drawn = ctx._draws
    again = spec.emit(ctx, ins, dict(seg.attrs))["Out"]
    assert drawn >= 1 and ctx._draws == drawn
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _merged(fluid, loss, h1, h2):
    fluid.optimizer.GradientMergeOptimizer(
        fluid.optimizer.SGDOptimizer(learning_rate=0.1), k_steps=2,
        avg=True).minimize(loss)


def test_gradient_merge_equals_large_batch_and_jax():
    data = _batches(6)
    merged, state = _both(_merged, data)
    big = [(np.concatenate([data[i][0], data[i + 1][0]]),
            np.concatenate([data[i][1], data[i + 1][1]]))
           for i in range(0, 6, 2)]
    large, _ = _both(_sgd, big)
    params = [p.name for p in merged["port"][3].all_parameters()]
    for n in params:
        np.testing.assert_allclose(merged["port"][1][n], large["port"][1][n],
                                   rtol=1e-4, atol=1e-5)
        _close(merged["port"][1][n], merged["jax"][1][n])
    _close(merged["port"][0], merged["jax"][0])
    # step by step, over LAMB (moments and beta powers too): the
    # non-boundary steps leave the parameters and the optimizer's state
    # as they were, bit for bit; the boundary steps move them all
    def merged_lamb(fluid, loss, h1, h2):
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.LambOptimizer(0.01), k_steps=2).minimize(loss)

    main, startup, loss, _, _ = _build(tfluid, merged_lamb)
    scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
    exe.run(startup, scope=scope)
    held = [n for n in scope.vars if "@GradientMerge" not in n
            and "gradient_merge_step" not in n
            and not n.startswith("learning_rate")]
    assert any("moment1" in n for n in held)
    for i, (bx, by) in enumerate(data, start=1):
        before = {n: scope.find_var(n).clone() for n in held}
        exe.run(main, feed={"x": bx, "label": by}, fetch_list=[loss],
                scope=scope)
        same = [torch.equal(before[n], scope.find_var(n)) for n in held]
        assert all(same) if i % 2 else not any(same), i


def test_lookahead_update_rule_and_jax():
    data = _batches(4)
    k, alpha, lr = 2, 0.5, 0.1

    def look(fluid, loss, h1, h2):
        fluid.optimizer.LookaheadOptimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=lr), alpha=alpha,
            k=k).minimize(loss)

    def sgd(fluid, loss, h1, h2):
        fluid.optimizer.SGDOptimizer(learning_rate=lr).minimize(loss)

    la, state = _both(look, data[:2])
    base, _ = _both(sgd, data[:2])
    np.testing.assert_allclose(la["port"][0][0], base["port"][0][0],
                               rtol=1e-5)
    for p in la["port"][3].all_parameters():
        w0 = state[p.name]
        expected = w0 + alpha * (base["port"][1][p.name] - w0)
        np.testing.assert_allclose(la["port"][1][p.name], expected,
                                   rtol=1e-4, atol=1e-5)
        _close(la["port"][1][p.name], la["jax"][1][p.name])
        _close(la["port"][1][p.name + "@SLOW"], la["jax"][1][p.name +
                                                             "@SLOW"])


def _applied(fluid, scope, avg, main):
    """The first parameter inside ``avg.apply()``; restore() must put
    back the very tensor it took out."""
    pname = main.global_block().all_parameters()[0].name
    raw = scope.find_var(pname)
    with avg.apply():
        applied = scope.find_var(pname)
        applied = (applied.numpy() if isinstance(applied, torch.Tensor)
                   else np.asarray(applied)).copy()
    assert scope.find_var(pname) is raw
    return applied


def test_ema_apply_restore_and_jax():
    decay = 0.9
    data = _batches(3)

    def wrap(fluid, loss, h1, h2):
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(decay)
        ema.update()
        return ema

    runs, state = _both(wrap, data, after=_applied)
    # the numpy EMA over the post-update snapshots of the plain run
    snaps = _sgd_snapshots(state, data)
    ema_np = np.zeros_like(snaps[0])
    for s in snaps:
        ema_np = decay * ema_np + (1 - decay) * s
    want = ema_np / (1 - decay ** len(snaps))
    np.testing.assert_allclose(runs["port"][2], want, rtol=1e-5, atol=1e-6)
    _close(runs["port"][2], runs["jax"][2])


def _sgd_snapshots(state, data):
    """The first parameter after each step of plain SGD from ``state``
    (the EMA and ModelAverage ops leave the update as it is)."""
    main, startup, loss, _, _ = _build(tfluid, _sgd)
    scope = tfluid.Scope.from_numpy(state, device="cpu")
    exe = tfluid.Executor(device="cpu")
    pname = main.global_block().all_parameters()[0].name
    out = []
    for bx, by in data:
        exe.run(main, feed={"x": bx, "label": by}, fetch_list=[loss],
                scope=scope)
        out.append(scope.find_var(pname).numpy().copy())
    return out


def test_ema_thres_steps_ramp_and_jax():
    """Scheduled decay min(decay, (1 + t) / (10 + t)), debiased by
    1 - prod(decay_t)."""
    decay = 0.999
    data = _batches(3)

    def wrap(fluid, loss, h1, h2):
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        main = fluid.default_main_program()
        gstep = main.global_block().create_var(
            name="gstep", shape=(1,), dtype="int64", persistable=True)
        sb = fluid.default_startup_program().global_block()
        sv = sb.create_var(name="gstep", shape=(1,), dtype="int64",
                           persistable=True)
        fluid.initializer.ConstantInitializer(0.0)(sv, sb)
        main.global_block().append_op(
            type="increment", inputs={"X": ["gstep"]},
            outputs={"Out": ["gstep"]}, attrs={"step": 1.0})
        ema = fluid.optimizer.ExponentialMovingAverage(decay,
                                                       thres_steps=gstep)
        ema.update()
        return ema

    runs, state = _both(wrap, data, after=_applied)
    snaps = _sgd_snapshots(state, data)
    ema_np, prod = np.zeros_like(snaps[0]), 1.0
    for t, s in enumerate(snaps, start=1):
        d = min(decay, (1.0 + t) / (10.0 + t))
        ema_np = d * ema_np + (1 - d) * s
        prod *= d
    np.testing.assert_allclose(runs["port"][2], ema_np / (1 - prod),
                               rtol=1e-5, atol=1e-6)
    _close(runs["port"][2], runs["jax"][2])


def test_model_average_apply_restore_and_jax():
    data = _batches(4)

    def wrap(fluid, loss, h1, h2):
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        # min_average_window 10 > the steps: no restart, the average
        # covers every post-update snapshot
        return fluid.optimizer.ModelAverage(0.15, min_average_window=10,
                                            max_average_window=100)

    runs, state = _both(wrap, data, after=_applied)
    snaps = _sgd_snapshots(state, data)
    np.testing.assert_allclose(runs["port"][2], np.mean(snaps, axis=0),
                               rtol=1e-5, atol=1e-6)
    _close(runs["port"][2], runs["jax"][2])
    pname = runs["port"][3].global_block().all_parameters()[0].name
    assert float(runs["port"][1][pname + "@MA_NUM"][0]) == 4.0

    # a window that restarts: min 2, max 3 -> the sums restart from the
    # current parameter, as in the JAX package
    def restarting(fluid, loss, h1, h2):
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
        return fluid.optimizer.ModelAverage(1.0, min_average_window=2,
                                            max_average_window=3)

    runs, _ = _both(restarting, _batches(7), after=_applied)
    _close(runs["port"][2], runs["jax"][2])
    for n, v in runs["jax"][1].items():
        if "@MA_" in n:
            _close(runs["port"][1][n], v)


def test_fleet_recompute_and_gradient_merge_match_jax():
    data = _batches(4)
    out = {}
    state = None
    for name, fluid, fleet in (("jax", jfluid, jfleet),
                               ("port", tfluid, tfleet)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            x = L.data("x", shape=[8])
            label = L.data("label", shape=[1], dtype="int64")
            loss, (h1, h2) = _mlp(L, x, label)
            strategy = fleet.DistributedStrategy()
            strategy.mesh_axes = {"dp": 1}
            strategy.recompute = True
            strategy.recompute_configs = {"checkpoints": [h1.name, h2.name]}
            strategy.gradient_merge = True
            strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
            fleet.init()
            fleet.distributed_optimizer(
                fluid.optimizer.SGDOptimizer(learning_rate=0.1),
                strategy).minimize(loss)
        types = [op.type for op in main.global_block().ops]
        assert "recompute_segment" in types and "where" in types
        if name == "jax":
            scope, exe = jfluid.executor.Scope(), jfluid.Executor()
            exe.run(startup, scope=scope)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
        else:
            scope = tfluid.Scope.from_numpy(state, device="cpu")
            exe = tfluid.Executor(device="cpu")
        out[name] = [float(np.asarray(exe.run(
            main, feed={"x": bx, "label": by}, fetch_list=[loss],
            scope=scope)[0]).reshape(-1)[0]) for bx, by in data]
    assert np.isfinite(out["port"]).all()
    _close(out["port"], out["jax"])
