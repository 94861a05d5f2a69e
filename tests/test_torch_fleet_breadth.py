"""fleet's training-breadth strategies in the port against the JAX
package's fleet, on the CPU, in this process (a dp 1 mesh has no
process group: every collective the identity).

* ``strategy.lamb`` and ``strategy.lars`` (the JAX package's
  tests/test_strategy_flags.py:30-60): the inner SGD is swapped for the
  lamb / lars_momentum update, a schedule's Variable learning rate
  carried over; 5 steps of the regression model: the loss falls and the
  trace and the weights match the JAX package's fleet run within 1e-5.
* Tiny BERT (2 layers, unfused, dropout off, f32) through fleet with
  LAMB, linear_lr_warmup(polynomial_decay) and recompute at every
  encoder layer's output: 5 steps, the loss trace within 1e-4 of the JAX
  package's fleet run (measured ~5e-7), the fetched learning rates
  within 1e-6.
* The same recipe under bf16 AMP with dropout 0.1, at 2 heads of 64 (the
  flash branch, its kernels' plain versions here): the run with
  recompute equals the run without it bit for bit (the AMP casts land
  inside the fused segments, the replay draws the forward's masks), and
  its program runs the flash forward twice a layer a step (the
  autograd Function's calls counted).
* A parameter that tp or ep splits reaches a lamb / lars_momentum op as
  a block: fleet refuses it by name (NotImplementedError) rather than
  take a norm over the block; gradient merge with tp or ep (whole
  accumulators against a rank's gradient blocks) is refused too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fleet as tfleet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.parallel import Mesh

TOL, BERT_TOL = 1e-5, 1e-4
TINY = (dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64), 2, 16, 3)
FLASH = (dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=128), 2, 128, 5)


def _regression(fluid, fleet, flag, configs):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [8, 4], append_batch_size=False)
        y = L.data("y", [8, 1], append_batch_size=False)
        loss = L.mean(L.square_error_cost(L.fc(x, 1), y))
        lr = L.exponential_decay(0.05, 2, 0.9)
        s = fleet.DistributedStrategy()
        s.mesh_axes = {"dp": 1}
        setattr(s, flag, True)
        setattr(s, flag + "_configs", dict(configs))
        fleet.init()
        fleet.distributed_optimizer(
            fluid.optimizer.SGDOptimizer(learning_rate=lr), s).minimize(loss)
    return main, startup, loss, lr


@pytest.mark.parametrize("flag,op,configs", [
    ("lamb", "lamb", {"lamb_weight_decay": 0.02}),
    ("lars", "lars_momentum", {"lars_coeff": 0.01, "momentum": 0.8})])
def test_lamb_and_lars_flags_swap_the_optimizer_as_jax(flag, op, configs):
    runs, state = {}, None
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = (x @ np.ones((4, 1))).astype(np.float32)
    for name, fluid, fleet in (("jax", jfluid, jfleet),
                               ("port", tfluid, tfleet)):
        main, startup, loss, lr = _regression(fluid, fleet, flag, configs)
        types = [o.type for o in main.global_block().ops]
        assert op in types and "sgd" not in types
        # the schedule's Variable is the swapped optimizer's rate
        upd = next(o for o in main.global_block().ops if o.type == op)
        assert upd.input("LearningRate") == [lr.name]
        if name == "jax":
            scope, exe = jfluid.executor.Scope(), jfluid.Executor()
            exe.run(startup, scope=scope)
            state = {n: np.asarray(v) for n, v in scope.vars.items()
                     if v is not None}
        else:
            scope = tfluid.Scope.from_numpy(state, device="cpu")
            exe = tfluid.Executor(device="cpu")
        losses = [float(np.asarray(exe.run(
            main, feed={"x": x, "y": y}, fetch_list=[loss],
            scope=scope)[0]).reshape(())) for _ in range(5)]
        runs[name] = (losses, {n: np.asarray(scope.find_var(n))
                               if name == "jax" else
                               scope.find_var(n).numpy() for n in state})
    assert runs["port"][0][-1] < runs["port"][0][0]
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], atol=TOL,
                               rtol=0)
    for n, v in runs["jax"][1].items():
        np.testing.assert_allclose(runs["port"][1][n], v, atol=TOL, rtol=0,
                                   err_msg=n)


def _checkpoints(main):
    return [op.output("Y")[0] for op in main.global_block().ops
            if op.type == "layer_norm"
            and op.input("Scale")[0].endswith("_post_ffn_ln_scale")]


def _bert_recipe(fluid, fleet, nn, bert, width, *, recompute, amp=False,
                 dropout=0.0):
    kw, b, s, mpn = width
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(**kw, hidden_dropout_prob=dropout,
                          attention_probs_dropout_prob=dropout,
                          fuse_stack=False)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, b, s, mpn, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            L = fluid.layers
            lr = L.linear_lr_warmup(
                L.polynomial_decay(1e-3, decay_steps=8,
                                   end_learning_rate=0.0),
                warmup_steps=3, start_lr=0.0, end_lr=1e-3)
            strategy = fleet.DistributedStrategy()
            strategy.mesh_axes = {"dp": 1}
            strategy.lamb = True
            strategy.amp = amp
            if recompute:
                strategy.recompute = True
                strategy.recompute_configs = {"checkpoints":
                                              _checkpoints(m)}
            fleet.init()
            fleet.distributed_optimizer(fluid.optimizer.AdamOptimizer(lr),
                                        strategy).minimize(loss)
    return cfg, m, st, loss, lr


def _port_trace(main, startup, loss, lr, state, feed, steps=5):
    """Run the port's startup (the AMP loss scale and the like), then
    the given state over it, then ``steps`` steps."""
    scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
    exe.run(startup, scope=scope)
    for n, v in state.items():
        scope.set_var(n, torch.tensor(v))
    out = [exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
           for _ in range(steps)]
    return ([float(a.reshape(-1)[0]) for a, _ in out],
            [float(b.reshape(-1)[0]) for _, b in out])


def test_tiny_bert_lamb_warmup_recompute_matches_jax():
    jc, jm, js, jl, jlr = _bert_recipe(jfluid, jfleet, jnn, jbert, TINY,
                                       recompute=True)
    tc, tm, ts, tl, tlr = _bert_recipe(tfluid, tfleet, tnn, tbert, TINY,
                                       recompute=True)
    types = [op.type for op in tm.global_block().ops]
    assert types == [op.type for op in jm.global_block().ops]
    assert types.count("recompute_segment") == 3
    assert types.count("lamb") == len(tm.all_parameters())
    scope, exe = jfluid.executor.Scope(), jfluid.Executor()
    exe.run(js, scope=scope)
    state = {n: np.asarray(v) for n, v in scope.vars.items()
             if v is not None}
    _, b, s, mpn = TINY
    feed = jbert.random_pretrain_batch(jc, b, s, mpn, seed=1)
    want = [exe.run(jm, feed=feed, fetch_list=[jl, jlr], scope=scope)
            for _ in range(5)]
    losses, lrs = _port_trace(tm, ts, tl, tlr, state, feed)
    np.testing.assert_allclose(
        losses, [float(np.asarray(a).reshape(-1)[0]) for a, _ in want],
        atol=BERT_TOL, rtol=0)
    np.testing.assert_allclose(
        lrs, [float(np.asarray(r).reshape(-1)[0]) for _, r in want],
        rtol=1e-6, atol=0)
    assert lrs[0] == 0.0 and max(lrs) > 0


def test_bf16_recompute_equals_the_run_without_it(monkeypatch):
    calls = []
    real = fa._FlashBSH.apply
    monkeypatch.setattr(fa._FlashBSH, "apply",
                        lambda *a: calls.append(1) or real(*a))
    runs = {}
    state = None
    for recompute in (False, True):
        cfg, m, st, loss, lr = _bert_recipe(
            tfluid, tfleet, tnn, tbert, FLASH, recompute=recompute,
            amp=True, dropout=0.1)
        if state is None:
            scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
            exe.run(st, scope=scope)
            state = {n: v.numpy() for n, v in scope.vars.items()}
        if recompute:
            segs = [op for op in m.global_block().ops
                    if op.type == "recompute_segment"]
            # the AMP casts are among the segments' own ops
            assert any(s.type == "cast" for op in segs
                       for s in op.attr("recompute_sub_ops"))
        _, b, s, mpn = FLASH
        feed = tbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
        del calls[:]
        runs[recompute] = _port_trace(m, st, loss, lr, state, feed, steps=3)
        runs[recompute] += (len(calls),)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    layers = FLASH[0]["num_hidden_layers"]
    assert runs[False][2] == 3 * layers and runs[True][2] == 6 * layers


def _two_fc(fluid, L):
    x = fluid.data("x", [16, 8], "float32")
    y = fluid.data("y", [16, 1], "float32")
    return L.reduce_mean(L.square_error_cost(L.fc(L.fc(x, 32, act="relu"),
                                                  1), y))


def _moe(fluid, L):
    x = fluid.data("x", [4, 8, 16], "float32")
    out, aux = L.moe_ffn(x, num_experts=4, expert_hidden=32, top_k=2)
    return L.elementwise_add(L.reduce_mean(out), aux)


@pytest.mark.parametrize("flag,match", [
    ("lamb", "op 'lamb' takes norms of the whole"),
    ("lars", "op 'lars_momentum' takes norms of the whole"),
    ("gradient_merge", "gradient_merge with tp, pp or ep")])
@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_a_split_parameter_is_refused_for_norm_updates(flag, match, axis):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        L = tfluid.layers
        loss = (_two_fc if axis == "tp" else _moe)(tfluid, L)
        s = tfleet.DistributedStrategy()
        s.mesh = Mesh({"dp": 1, axis: 2})          # no process group
        if axis == "tp":
            s.tensor_parallel = True
            s.tensor_parallel_rules = [(r"^fc_0\.w_0$", (None, "tp")),
                                       (r"^fc_0\.b_0$", ("tp",)),
                                       (r"^fc_1\.w_0$", ("tp", None))]
        else:
            s.expert_parallel = True
        setattr(s, flag, True)
        with pytest.raises(NotImplementedError, match=match):
            tfleet.distributed_optimizer(
                tfluid.optimizer.SGDOptimizer(0.1), s).minimize(loss)
