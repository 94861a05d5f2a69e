"""The port's ``fluid/layers/loss.py`` against the JAX package's, and the
image-classification recipe's training head over a small ResNet.

* Each of the ten loss layers builds the same ops, attributes, shapes and
  dtypes as the JAX layer under ``unique_name.guard()``
  (``sampled_softmax_with_cross_entropy`` draws the same negatives from
  ``RandomState(seed)`` at build time).
* All ten in one program, their sum minimized by SGD from the JAX
  package's initialised scope (``Scope.from_numpy``): every loss's value
  over 3 steps within 1e-5 / 1e-5 (f32; the same math in another
  summation order) and every parameter after the last step within the
  same.
* The recipe's head (PaddleCV image_classification ``build_model.py``):
  ``one_hot`` -> ``label_smooth(0.1)`` -> ``softmax`` ->
  ``cross_entropy(soft_label=True)`` -> ``mean``, with ``accuracy`` at k
  1 and 5, Momentum 0.1 / 0.9 with ``L2Decay(1e-4)``, conv+BN fusion on,
  over ``ResNetConfig.tiny()`` (2 stages of one basic block, 8 filters,
  10 classes), batch 8 at 32 x 32, f32: 3 steps from the JAX scope, the
  loss within 1e-4 (the ResNet loss traces' f32 limit) and acc1 / acc5
  equal.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import resnet as tresnet

B, D, C = 6, 5, 7


def _inputs(L):
    x = L.data("x", [B, D], "float32", append_batch_size=False)
    lbl = L.data("lbl", [B, 1], "int64", append_batch_size=False)
    bin_ = L.data("bin", [B, 1], "float32", append_batch_size=False)
    fg = L.data("fg", [1], "int32", append_batch_size=False)
    return x, lbl, bin_, fg


def _losses(fluid, L):
    """The ten loss layers over fc projections of one input."""
    x, lbl, bin_, fg = _inputs(L)
    logits = L.fc(x, C)
    probs = L.softmax(logits)
    emb = L.fc(x, 4)
    left, right = L.fc(x, 1), L.fc(x, 1)
    loss = fluid.layers.loss
    return {
        "mse_loss": loss.mse_loss(left, bin_),
        "dice_loss": loss.dice_loss(probs, lbl),
        "bpr_loss": loss.bpr_loss(logits, lbl),
        "center_loss": loss.center_loss(emb, lbl, C, 0.5),
        "rank_loss": loss.rank_loss(bin_, left, right),
        "margin_rank_loss": loss.margin_rank_loss(
            L.scale(bin_, 2.0, -1.0), left, right, 0.2),
        "npair_loss": loss.npair_loss(emb, L.fc(x, 4), lbl),
        "sigmoid_focal_loss": loss.sigmoid_focal_loss(
            logits, lbl, fg, gamma=1.5, alpha=0.3),
        "teacher_student_sigmoid_loss": loss.teacher_student_sigmoid_loss(
            L.scale(left, 20.0), bin_, 4.0, -3.0),
        "sampled_softmax_with_cross_entropy":
            loss.sampled_softmax_with_cross_entropy(logits, lbl, 4, seed=7),
    }


def _loss_program(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        losses = _losses(fluid, L)
        means = {k: L.mean(v) for k, v in losses.items()}
        total = L.sums(list(means.values()))
        fluid.optimizer.SGDOptimizer(0.05).minimize(total)
    return main, startup, means


def _ops(prog):
    return [(op.type, op.inputs, op.outputs,
             {k: str(v) for k, v in op.attrs.items()
              if not k.startswith("__")})
            for op in prog.global_block().ops]


LOSSES = ("mse_loss", "dice_loss", "bpr_loss", "center_loss", "rank_loss",
          "margin_rank_loss", "npair_loss", "sigmoid_focal_loss",
          "teacher_student_sigmoid_loss",
          "sampled_softmax_with_cross_entropy")


def _one_loss_program(fluid, name):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fluid.backward.append_backward(L.mean(_losses(fluid, L)[name]))
    return main, startup


@pytest.mark.parametrize("name", LOSSES)
def test_loss_layer_builds_the_same_ops_as_jax(name):
    """The layer's forward and backward ops, the startup program and the
    vars (shapes, dtypes, stop_gradient)."""
    jm, js = _one_loss_program(jfluid, name)
    tm, ts = _one_loss_program(tfluid, name)
    assert _ops(tm) == _ops(jm) and _ops(ts) == _ops(js)
    vs = lambda p: {n: (v.shape, str(v.dtype), v.stop_gradient)  # noqa
                    for n, v in p.global_block().vars.items()}
    assert vs(tm) == vs(jm)
    assert hasattr(tfluid.layers, name)


def _feed():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((B, D)).astype(np.float32),
            "lbl": rng.integers(0, C, (B, 1)).astype(np.int64),
            "bin": (rng.random((B, 1)) > 0.5).astype(np.float32),
            "fg": np.array([3], np.int32)}


def _scopes(jm, js):
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    return jexe, jscope, tfluid.Executor(device="cpu"), \
        tfluid.Scope.from_numpy(state, device="cpu")


def test_loss_values_and_updates_match_jax():
    jm, js, jmeans = _loss_program(jfluid)
    tm, ts, tmeans = _loss_program(tfluid)
    jexe, jscope, texe, tscope = _scopes(jm, js)
    feed = _feed()
    names = sorted(jmeans)
    for _ in range(3):
        want = jexe.run(jm, feed=feed, fetch_list=[jmeans[n] for n in names],
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tmeans[n] for n in names],
                       scope=tscope)
        for n, g, w in zip(names, got, want):
            assert np.isfinite(g).all(), n
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5,
                                       rtol=1e-5, err_msg=n)
    for p in tm.all_parameters():
        np.testing.assert_allclose(
            tscope.find_var(p.name).numpy(),
            np.asarray(jscope.find_var(p.name)), atol=1e-5, rtol=1e-5,
            err_msg=p.name)


def _recipe(fluid, flags, res, cfg, batch, size):
    """ResNet -> the recipe's smoothed-label head; Momentum 0.1 / 0.9 with
    L2Decay(1e-4), conv+BN fusion on."""
    L = fluid.layers
    flags.set_flags({"FLAGS_conv_bn_fusion": True})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = L.data("image", [batch, 3, size, size],
                         append_batch_size=False)
            label = L.data("label", [batch, 1], dtype="int64",
                           append_batch_size=False)
            logits = res.resnet(cfg, img)
            soft = L.label_smooth(L.one_hot(label, cfg.num_classes),
                                  epsilon=0.1)
            probs = L.softmax(logits)
            loss = L.mean(L.cross_entropy(probs, soft, soft_label=True))
            acc1 = L.accuracy(probs, label, k=1)
            acc5 = L.accuracy(probs, label, k=5)
            fluid.optimizer.MomentumOptimizer(
                0.1, momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4)).minimize(
                    loss)
    finally:
        flags.set_flags({"FLAGS_conv_bn_fusion": False})
    return main, startup, [loss, acc1, acc5]


def test_recipe_head_trace_matches_jax():
    def cfg(res):
        return res.ResNetConfig.tiny()

    jm, js, jf = _recipe(jfluid, jflags, jresnet, cfg(jresnet), 8, 32)
    tm, ts, tf = _recipe(tfluid, tflags, tresnet, cfg(tresnet), 8, 32)
    assert _ops(tm) == _ops(jm)
    types = [op.type for op in tm.global_block().ops]
    assert {"one_hot", "label_smooth", "cross_entropy", "accuracy",
            "top_k", "fused_conv_bn"} <= set(types)
    jexe, jscope, texe, tscope = _scopes(jm, js)
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    trace = []
    for _ in range(3):
        w = [float(np.asarray(v)[0]) for v in
             jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)]
        g = [float(v[0]) for v in
             texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)]
        trace.append((g, w))
        assert abs(g[0] - w[0]) <= 1e-4
        assert g[1:] == w[1:]
    losses = [g[0] for g, _ in trace]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
