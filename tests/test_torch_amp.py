"""The port's AMP (bf16 and float16) against the JAX package's.

* ``rewrite_program`` inserts the same cast ops on the same vars, to
  bfloat16 and to float16: the op lists (types, slots, var names, attrs
  with dtypes by name) and every variable's dtype name agree, on BERT's
  pretraining program (fused stack and per-layer) and on a small fc net.
* ``decorate(use_bf16=True).minimize`` appends the same backward and
  update ops (grads of f32 params stay f32: no extra casts).
* A tiny bf16 train runs 5 Adam steps on the CPU with finite, falling
  losses that stay within 2e-2 of the JAX package's (bf16 rounds at
  other places in the two frameworks: one bf16 ulp of a loss near 5 is
  3e-2).
* float16 (``use_bf16=False``, dynamic loss scaling): the same ops and
  vars as the JAX program, except the ``SkipUpdate`` input the port adds
  to each update op (the reference's skip of an overflowed step: the
  JAX package's update runs on zeroed gradients instead, which still
  decays Adam's moments); 5 Adam steps from the JAX package's scope with
  every fetched scale equal to the JAX package's and every loss within
  ``F16_LOSS_TOL``; the JAX package's own scaling test
  (``tests/test_amp.py``) on the port; overflowed steps (a start scale
  that overflows, and a bad batch after the moments have grown) that
  leave every persistable bit for bit while the scale and both counters
  follow the JAX package's through shrink and growth; a fixed scale
  without dynamic scaling; FLAGS_check_numerics refused (ROADMAP A8); a
  checkpoint at step 2 whose resumed run continues the scale, the
  counters and the losses bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.contrib.mixed_precision import fp16_utils as jfu
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.contrib.mixed_precision import fp16_utils as tfu
from paddle_tpu_torch.fluid.dtypes import dtype_name
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.optimizer_ops import UPDATE_OPS

LOSS_TOL = 2e-2
# float16 losses: both packages take the loss in f32 from f16 logits and
# round activations to f16 at the same casts; they differ only where an
# f16 intermediate rounds the other way (XLA and torch sum and fuse in
# other orders), a few f16 ulps of an activation, which move a loss near
# 5 by 1e-4 to 2e-4 over 5 steps (measured).  One f16 ulp of the loss
# itself is 3.9e-3: half of it is the limit
F16_LOSS_TOL = 2e-3


def _attr(v):
    return dtype_name(v) if hasattr(v, "itemsize") and hasattr(v, "kind") \
        else v


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: _attr(v) for k, v in op.attrs.items()
              if not k.startswith("__")})
            for op in program.global_block().ops]


def _vars(program):
    return {n: (v.shape, dtype_name(v.dtype))
            for n, v in program.global_block().vars.items()}


def _bert(fluid, nn, bert, fuse):
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fuse_stack=fuse)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        bert.build_bert_pretrain_program(cfg, 2, 16, 3, main_program=main,
                                         startup_program=startup)
    return main


def _fc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [8], "float32")
        h = L.layer_norm(L.fc(x, 16, act="gelu"), begin_norm_axis=1)
        L.reduce_mean(L.softmax(L.fc(h, 4)))
    return main


PROGRAMS = {
    "bert_fused": lambda f, nn, b: _bert(f, nn, b, True),
    "bert_layers": lambda f, nn, b: _bert(f, nn, b, False),
    "fc_ln_softmax": lambda f, nn, b: _fc(f),
}


# bf16 keeps the cases' first ids; float16 adds three
CAST_CASES = ([(n, "bfloat16") for n in sorted(PROGRAMS)]
              + [(n, "float16") for n in sorted(PROGRAMS)])


@pytest.mark.parametrize(
    "name,dest", CAST_CASES,
    ids=[n if d == "bfloat16" else f"{n}-float16" for n, d in CAST_CASES])
def test_rewrite_inserts_the_same_casts(name, dest):
    jm = PROGRAMS[name](jfluid, jnn, jbert)
    tm = PROGRAMS[name](tfluid, tnn, tbert)
    with jfluid.unique_name.guard():
        jfu.rewrite_program(jm, jmp.AutoMixedPrecisionLists(), dest)
    with tfluid.unique_name.guard():
        tfu.rewrite_program(tm, tmp.AutoMixedPrecisionLists(), dest)
    casts = [op for op in tm.global_block().ops if op.type == "cast"]
    assert casts and any(dtype_name(op.attrs["out_dtype"]) == dest
                         for op in casts)
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)


def _train(fluid, nn, bert, mp, fuse):
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fuse_stack=fuse)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, 2, 16, 3, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = mp.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                              use_bf16=True)
            opt.minimize(loss)
    return cfg, m, st, loss


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "layers"])
def test_bf16_train_matches_jax(fuse):
    jc, jm, js, jl = _train(jfluid, jnn, jbert, jmp, fuse)
    tc, tm, ts, tl = _train(tfluid, tnn, tbert, tmp, fuse)
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)
    grads = [n for n in tm.global_block().vars if n.endswith("@GRAD")
             and tm.global_block().var(n[:-5]).persistable]
    assert grads and all(
        dtype_name(tm.global_block().var(g).dtype) == "float32"
        for g in grads)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    texe = tfluid.Executor(device="cpu")
    feed = jbert.random_pretrain_batch(jc, 2, 16, 3, seed=1)
    got = []
    for _ in range(5):
        want = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0]
        got.append(texe.run(tm, feed=feed, fetch_list=[tl],
                            scope=tscope)[0][0])
        np.testing.assert_allclose(got[-1], want[0], atol=LOSS_TOL, rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]


def test_lists_match_jax():
    j, t = jmp.AutoMixedPrecisionLists(), tmp.AutoMixedPrecisionLists()
    assert (t.white_list, t.black_list) == (j.white_list, j.black_list)
    j = jmp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                    custom_black_list={"mul"})
    t = tmp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                    custom_black_list={"mul"})
    assert (t.white_list, t.black_list) == (j.white_list, j.black_list)
    assert tfu._KEEP_F32_SLOTS == jfu._KEEP_F32_SLOTS



# ---------------------------------------------------------------------------
# float16: dynamic loss scaling
# ---------------------------------------------------------------------------


def _ops_no_skip(program):
    """``_ops`` without the SkipUpdate input the port adds to each update
    op (the decorator's found_inf), which it checks is there."""
    for op in program.global_block().ops:
        if op.type in UPDATE_OPS:
            assert op.inputs.get("SkipUpdate")
    return [(t, {k: v for k, v in ins.items() if k != "SkipUpdate"}, outs,
             attrs) for t, ins, outs, attrs in _ops(program)]


def _f16_bert(fluid, nn, bert, mp, fuse, **amp):
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fuse_stack=fuse)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, 2, 16, 3, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = mp.decorate(fluid.optimizer.AdamOptimizer(1e-3),
                              use_bf16=False, **amp)
            opt.minimize(loss)
    return cfg, m, st, loss, opt


def _scopes(js):
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    return jexe, jscope, tfluid.Executor(device="cpu"), tscope


def _scale_state(opt):
    return [opt.get_loss_scaling(), opt._good_steps, opt._bad_steps]


def _f(v):
    return float(np.asarray(v).reshape(-1)[0])


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "layers"])
def test_fp16_train_matches_jax(fuse):
    amp = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2)
    jc, jm, js, jl, jo = _f16_bert(jfluid, jnn, jbert, jmp, fuse, **amp)
    tc, tm, ts, tl, to = _f16_bert(tfluid, tnn, tbert, tmp, fuse, **amp)
    assert _ops_no_skip(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)
    assert any(v == "float16" for _, v in _vars(tm).values())
    jexe, jscope, texe, tscope = _scopes(js)
    feed = jbert.random_pretrain_batch(jc, 2, 16, 3, seed=1)
    losses, scales = [], []
    for _ in range(5):
        want = jexe.run(jm, feed=feed, fetch_list=[jl] + _scale_state(jo),
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tl] + _scale_state(to),
                       scope=tscope)
        assert [_f(v) for v in got[1:]] == [_f(v) for v in want[1:]]
        np.testing.assert_allclose(_f(got[0]), _f(want[0]),
                                   atol=F16_LOSS_TOL, rtol=0)
        losses.append(_f(got[0]))
        scales.append(_f(got[1]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert scales == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16, 2.0 ** 17, 2.0 ** 17]


def _fc_model(fluid):
    x = fluid.data("x", [8, 16], "float32")
    y = fluid.data("y", [8, 1], "float32")
    h = fluid.layers.fc(x, 32, act="relu")
    pred = fluid.layers.fc(h, 1)
    return fluid.layers.reduce_mean(
        fluid.layers.square_error_cost(pred, y))


def _fc_run(fluid, mp, make_opt, **amp):
    """The JAX package's tests/test_amp.py model under float16 AMP:
    (main, startup, loss, decorated optimizer)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = _fc_model(fluid)
        opt = mp.decorate(make_opt(fluid), use_bf16=False, **amp)
        opt.minimize(loss)
    return main, startup, loss, opt


def test_fp16_dynamic_loss_scaling_state():
    """tests/test_amp.py's test of the JAX package, on the port: finite
    gradients double the scale every incr_every_n_steps = 2 steps, and
    the fetched value is the one after the step's update."""
    main, startup, loss, opt = _fc_run(
        tfluid, tmp, lambda f: f.optimizer.SGDOptimizer(1e-2),
        init_loss_scaling=1024.0, incr_every_n_steps=2)
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(1).randn(8, 16).astype("float32"),
            "y": np.ones((8, 1), "float32")}
    vals = []
    for _ in range(4):
        _, sv = exe.run(main, feed=feed,
                        fetch_list=[loss, opt.get_loss_scaling()],
                        scope=scope)
        vals.append(_f(sv))
    assert vals == [1024.0, 2048.0, 2048.0, 4096.0], vals


def _persistables(program, scope):
    """Every var an update op writes (parameters, moments, beta powers),
    as numpy copies."""
    names = {n for op in program.global_block().ops if op.type in UPDATE_OPS
             for n in op.output_names()}
    return {n: np.array(scope.find_var(n).detach().cpu().numpy(), copy=True)
            for n in sorted(names)}


def _fc_feed(seed, mult=1.0):
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(8, 16) * mult).astype("float32"),
            "y": np.ones((8, 1), "float32")}


def test_fp16_overflow_skips_the_step():
    """A bad batch (x times 1e4: x . W fits f16, its gradient at scale
    1024 does not) arrives at steps 3 and 4, after two normal steps have
    grown Adam's moments.  Each overflowed step leaves every parameter,
    moment and beta power bit for bit; the scale halves twice
    (decr_every_n_nan_or_inf 1, decr_ratio 0.5) and then grows after two
    good steps, and the scale and both counters equal the JAX package's
    on the same program and scope at every step."""
    amp = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=1, decr_ratio=0.5)
    mk = lambda f: f.optimizer.AdamOptimizer(1e-2)  # noqa: E731
    jm, js, jl, jo = _fc_run(jfluid, jmp, mk, **amp)
    tm, ts, tl, to = _fc_run(tfluid, tmp, mk, **amp)
    assert _ops_no_skip(tm) == _ops(jm)
    jexe, jscope, texe, tscope = _scopes(js)
    bad = {3, 4}
    seen = []
    for step in range(1, 8):
        feed = _fc_feed(step, 1e4 if step in bad else 1.0)
        before = _persistables(tm, tscope)
        want = jexe.run(jm, feed=feed, fetch_list=[jl] + _scale_state(jo),
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tl] + _scale_state(to),
                       scope=tscope)
        state = [_f(v) for v in got[1:]]
        assert state == [_f(v) for v in want[1:]], step
        seen.append(state)
        after = _persistables(tm, tscope)
        assert sorted(after) == sorted(before)
        moved = [n for n in before
                 if before[n].tobytes() != after[n].tobytes()]
        if step in bad:
            assert moved == [], (step, moved)
        else:
            assert len(moved) == len(before), (step, set(before) - set(moved))
    assert seen == [[1024.0, 1.0, 0.0], [2048.0, 0.0, 0.0],
                    [1024.0, 0.0, 0.0], [512.0, 0.0, 0.0],
                    [512.0, 1.0, 0.0], [1024.0, 0.0, 0.0],
                    [1024.0, 1.0, 0.0]]


def test_fp16_overflowing_start_scale_matches_jax():
    """Tiny BERT from a start scale of 2^40 (its f16 gradients overflow)
    with decr_ratio 0.01: each step whose scale shrinks leaves every
    parameter, Adam moment and beta power bit for bit, every other step
    moves them; the scale and both counters equal the JAX package's at
    every step.  The losses agree within F16_LOSS_TOL up to the first
    step that updates: after it the JAX package's Adam has advanced its
    beta powers over the skipped steps (its update ran on zeroed
    gradients) and the port's has not, so their bias corrections part."""
    amp = dict(init_loss_scaling=2.0 ** 40, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=1, decr_ratio=0.01)
    jc, jm, js, jl, jo = _f16_bert(jfluid, jnn, jbert, jmp, False, **amp)
    tc, tm, ts, tl, to = _f16_bert(tfluid, tnn, tbert, tmp, False, **amp)
    jexe, jscope, texe, tscope = _scopes(js)
    feed = jbert.random_pretrain_batch(jc, 2, 16, 3, seed=1)
    scale, skipped, losses = 2.0 ** 40, [], []
    for _ in range(6):
        before = _persistables(tm, tscope)
        want = jexe.run(jm, feed=feed, fetch_list=[jl] + _scale_state(jo),
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tl] + _scale_state(to),
                       scope=tscope)
        assert [_f(v) for v in got[1:]] == [_f(v) for v in want[1:]]
        if all(skipped):
            np.testing.assert_allclose(_f(got[0]), _f(want[0]),
                                       atol=F16_LOSS_TOL, rtol=0)
        after = _persistables(tm, tscope)
        moved = [n for n in before
                 if before[n].tobytes() != after[n].tobytes()]
        shrank = _f(got[1]) < scale
        assert moved == [] if shrank else len(moved) == len(before)
        skipped.append(shrank)
        losses.append(_f(got[0]))
        scale = _f(got[1])
    assert skipped == [True] * 4 + [False] * 2, skipped
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_fp16_fixed_scale_without_dynamic_scaling():
    """use_dynamic_loss_scaling=False: no counters, the scale stays at its
    start through good and overflowed steps, and an overflowed step is
    still skipped."""
    main, startup, loss, opt = _fc_run(
        tfluid, tmp, lambda f: f.optimizer.AdamOptimizer(1e-2),
        init_loss_scaling=512.0, use_dynamic_loss_scaling=False)
    assert not any(n.startswith(("good_steps", "bad_steps"))
                   for n in main.global_block().vars)
    exe = tfluid.Executor(device="cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for step, mult in enumerate((1.0, 1e4, 1.0)):
        before = _persistables(main, scope)
        _, sv = exe.run(main, feed=_fc_feed(step, mult),
                        fetch_list=[loss, opt.get_loss_scaling()],
                        scope=scope)
        assert _f(sv) == 512.0
        after = _persistables(main, scope)
        same = all(before[n].tobytes() == after[n].tobytes() for n in before)
        assert same == (mult > 1.0)


def test_fp16_refuses_check_numerics():
    """The JAX branch adds a check_numerics_bad_amp_* guard under
    FLAGS_check_numerics, which the port's executor cannot read yet."""
    tfluid.set_flags({"FLAGS_check_numerics": True})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            _fc_run(tfluid, tmp, lambda f: f.optimizer.SGDOptimizer(1e-2))
    finally:
        tfluid.set_flags({"FLAGS_check_numerics": False})


def test_fp16_checkpoint_resumes_the_scale_trajectory(tmp_path):
    """A float16 run saved at step 2 (CheckpointManager) and resumed in a
    fresh program and scope continues the scale, both counters and the
    losses of the run that did not stop, bit for bit; a bad batch at step
    4 makes the trajectory shrink after the resume."""
    amp = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
               decr_every_n_nan_or_inf=1, decr_ratio=0.5)
    mk = lambda f: f.optimizer.AdamOptimizer(1e-2)  # noqa: E731
    feeds = [_fc_feed(s, 1e4 if s == 4 else 1.0) for s in range(1, 7)]

    def build():
        main, startup, loss, opt = _fc_run(tfluid, tmp, mk, **amp)
        return main, startup, [loss] + _scale_state(opt)

    def run(main, scope, fetch, feeds_):
        exe = tfluid.Executor(device="cpu")
        return [[_f(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                        scope=scope)] for f in feeds_]

    main, startup, fetch = build()
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    whole = run(main, scope, fetch, feeds)

    main, startup, fetch = build()
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    head = run(main, scope, fetch, feeds[:2])
    tfluid.CheckpointManager(str(tmp_path), program=main, scope=scope,
                             device="cpu").save(2)
    main, startup, fetch = build()
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    st = tfluid.CheckpointManager(str(tmp_path), program=main, scope=scope,
                                  device="cpu").restore()
    assert st is not None and st["step"] == 2
    tail = run(main, scope, fetch, feeds[2:])
    assert head + tail == whole
    assert [s[1] for s in whole] == [1024.0, 2048.0, 2048.0, 1024.0, 1024.0,
                                     2048.0]


def _fleet_f16_bert(fluid, fleet, nn, bert, fuse, **fields):
    """Tiny BERT through fleet at dp 1 with float16 AMP and ``fields`` set
    on the strategy (LAMB, recompute, gradient merge)."""
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fuse_stack=fuse)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, 2, 16, 3, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            strategy = fleet.DistributedStrategy()
            strategy.mesh_axes = {"dp": 1}
            strategy.amp = True
            strategy.amp_configs = {"use_bf16": False,
                                    "init_loss_scaling": 2.0 ** 15,
                                    "incr_every_n_steps": 1}
            for k, v in fields.items():
                if callable(v):
                    v = v(m)
                setattr(strategy, k, v)
            fleet.init()
            fleet.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-3),
                                        strategy).minimize(loss)
    return cfg, m, st, loss


def test_fp16_gradient_merge_skips_the_merged_step():
    """GradientMergeOptimizer (k 2) around the float16 decorator, the
    tests/test_amp.py model: the decorator's found_inf and scale update
    run on the merged gradients, inside the region the merge masks, so
    the scale and the counters change on the boundary steps alone; a bad
    batch in the first half of a window makes that window's boundary step
    skip (no update output moves) and halve the scale, and the window
    after it updates again.  (The JAX package's GradientMergeOptimizer
    cannot take the decorator's (scaled loss, params_grads) from its
    backward, so there is no JAX run to hold this to.)"""
    amp = dict(init_loss_scaling=1024.0, incr_every_n_steps=1,
               decr_every_n_nan_or_inf=1, decr_ratio=0.5)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = _fc_model(tfluid)
        opt = tmp.decorate(tfluid.optimizer.AdamOptimizer(1e-2),
                           use_bf16=False, **amp)
        tfluid.optimizer.GradientMergeOptimizer(opt, k_steps=2).minimize(
            loss)
    exe, scope = tfluid.Executor(device="cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    # the windows are steps (1, 2), (3, 4), (5, 6); a bad batch at 3
    seen = []
    for step in range(1, 7):
        before = _persistables(main, scope)
        got = exe.run(main, feed=_fc_feed(step, 1e4 if step == 3 else 1.0),
                      fetch_list=[loss] + _scale_state(opt), scope=scope)
        after = _persistables(main, scope)
        moved = any(before[n].tobytes() != after[n].tobytes()
                    for n in before)
        seen.append((moved, [_f(v) for v in got[1:]]))
    assert seen == [(False, [1024.0, 0.0, 0.0]),
                    (True, [2048.0, 0.0, 0.0]),
                    (False, [2048.0, 0.0, 0.0]),
                    (False, [1024.0, 0.0, 0.0]),
                    (False, [1024.0, 0.0, 0.0]),
                    (True, [2048.0, 0.0, 0.0])], seen


def test_fp16_lamb_recompute_equals_the_run_without_it():
    """LAMB (``strategy.lamb``) and recompute at every layer
    (``strategy.recompute``, fleet's order: AMP, then recompute) around
    the float16 decorator, the unfused encoder: the losses, the scale and
    every parameter equal the run without recompute bit for bit, and the
    AMP casts sit among the segments' own ops."""
    import paddle_tpu_torch.fleet as tfleet

    def checkpoints(m):
        return [op.output("Y")[0] for op in m.global_block().ops
                if op.type == "layer_norm"
                and op.input("Scale")[0].endswith("_post_ffn_ln_scale")]

    runs, state = {}, None
    for recompute in (False, True):
        fields = dict(lamb=True)
        if recompute:
            fields.update(recompute=True, recompute_configs=lambda m: {
                "checkpoints": checkpoints(m)})
        cfg, m, st, loss = _fleet_f16_bert(tfluid, tfleet, tnn, tbert,
                                           False, **fields)
        scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
        exe.run(st, scope=scope)
        if state is None:
            state = {n: v.clone() for n, v in scope.vars.items()}
        for n, v in state.items():
            scope.set_var(n, v.clone())
        if recompute:
            segs = [op for op in m.global_block().ops
                    if op.type == "recompute_segment"]
            assert segs and any(s.type == "cast" for op in segs
                                for s in op.attr("recompute_sub_ops"))
        feed = tbert.random_pretrain_batch(cfg, 2, 16, 3, seed=1)
        trace = [[_f(v) for v in exe.run(m, feed=feed, fetch_list=[
            loss, "loss_scaling_0"], scope=scope)] for _ in range(3)]
        runs[recompute] = (trace, {n: scope.find_var(n).numpy().tobytes()
                                   for n in state})
    assert runs[True][0] == runs[False][0]
    assert [s for _, s in runs[True][0]] == [2.0 ** 16, 2.0 ** 17,
                                             2.0 ** 18]
    assert runs[True][1] == runs[False][1]


def test_f16_cuda_tensors_are_refused_by_rows_1_and_6_to_14():
    """Rows 2-5 have f16 forms; rows 1 (paged decode) and 6-14 (BHSD
    flash, conv+BN) do not yet (ROADMAP section B): their input checks,
    which every CUDA launch runs first, refuse an f16 tensor, so it never
    reaches a plain version on the card.  The same checks take bf16."""
    import torch

    from paddle_tpu_torch.ops.kernels import conv_bn, paged_attention
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    for dt in (torch.float16, torch.bfloat16):
        q = torch.zeros(2, 4, 64, dtype=dt)
        pages = torch.zeros(8, 16, 4, 64, dtype=dt)
        table = torch.zeros(2, 4, dtype=torch.int32)
        lengths = torch.ones(2, dtype=torch.int32)
        x = torch.zeros(2, 8, 8, 16, dtype=dt)
        w = torch.zeros(16, 16, 3, 3, dtype=dt)
        z = torch.zeros(128, 16, dtype=dt)
        stat = torch.zeros(4, 16)
        qb = torch.zeros(2, 2, 128, 64, dtype=dt)
        checks = (
            lambda: paged_attention.check_kernel_inputs(q, pages, pages,
                                                        table, lengths),
            lambda: conv_bn.check_kernel_inputs(x, w, (1, 1),
                                                ((1, 1), (1, 1))),
            lambda: conv_bn.check_sweep_inputs(z, stat),
            lambda: fa.check_bhsd_inputs(qb, qb, qb, None))
        for check in checks:
            if dt == torch.float16:
                with pytest.raises(ValueError, match="float16|dtype"):
                    check()
            else:
                check()


def test_fp16_fit_preempted_and_resumed_continues_the_scale(tmp_path):
    """hapi ``Model.fit`` with a float16-decorated Adam (the scale grows
    every 3 good steps; a bad batch, x times 1e4, in each epoch shrinks
    it), preempted at step 13 with a checkpoint every 5 steps and resumed
    in a new Model: the loss trace, the parameters and the scale with its
    counters equal the run that did not stop, bit for bit."""
    from paddle_tpu_torch.fluid import checkpoint as ckpt
    from paddle_tpu_torch.hapi import Input, Model
    from paddle_tpu_torch.hapi.callbacks import Callback

    class PreemptAt(Callback):
        def __init__(self, at):
            self.at, self.n = at, 0

        def on_batch_end(self, mode, step, logs=None):
            if mode == "train":
                self.n += 1
                if self.n == self.at:
                    ckpt.request_preemption()

    def model():
        def net(x):
            L = tfluid.layers
            return L.fc(L.fc(x, 16, act="relu"), 1)

        m = Model(net, Input("x", [8, 4]), Input("y", [8, 1]), device="cpu")
        m.prepare(tmp.decorate(tfluid.optimizer.AdamOptimizer(1e-2),
                               use_bf16=False, init_loss_scaling=1024.0,
                               incr_every_n_steps=3,
                               decr_every_n_nan_or_inf=1, decr_ratio=0.5),
                  lambda q, y: tfluid.layers.mean(
                      tfluid.layers.square_error_cost(q, y)))
        return m

    def scale_state(m):
        return {n: m._scope.find_var(n).numpy().tobytes()
                for n in ("loss_scaling_0", "good_steps_0", "bad_steps_0")}

    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype(np.float32)
    X[24:32] *= 1e4                 # batch 3 of each epoch overflows
    Y = rng.randn(64, 1).astype(np.float32)
    ref = model()
    h_ref = ref.fit((X, Y), batch_size=8, epochs=3, verbose=0)
    with pytest.raises(ckpt.Preempted):
        model().fit((X, Y), batch_size=8, epochs=3, verbose=0,
                    checkpoint_dir=str(tmp_path), checkpoint_freq=5,
                    callbacks=[PreemptAt(13)])
    ckpt.clear_preemption()
    res = model()
    h_res = res.fit((X, Y), batch_size=8, epochs=3, verbose=0,
                    checkpoint_dir=str(tmp_path), resume=True)
    assert h_ref["loss"] == h_res["loss"]
    assert scale_state(res) == scale_state(ref)
    assert float(ref._scope.find_var("loss_scaling_0")[0]) != 1024.0
    for a, b in zip(ref.parameters(), res.parameters()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
