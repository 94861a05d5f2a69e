"""The slice as a whole: hapi's text-CNN encoder (``hapi.text``
``Conv1dPoolLayer`` / ``CNNEncoder``, the encoder of the reference's
sentiment-classification recipe) in a classifier, built and trained by
the port against the JAX package on the CPU.

Network: ``embedding`` -> ``CNNEncoder(filter_sizes=(3, 4, 5))`` -> ``fc``
to 2 classes -> ``softmax_with_cross_entropy`` -> ``mean``, under
``unique_name.guard()`` with ``SGDOptimizer(0.1).minimize``, in both
pooling branches: the global max-pool over time (``reduce_max``, then
``concat``) and ``pool_size=2`` (``pool2d``, ``squeeze``, ``transpose``,
``concat``).  Both packages build the same program (ops, slots,
attributes, vars, the backward included); the JAX startup scope is
copied across with ``Scope.from_numpy``; then 3 SGD steps on one batch.
Tolerances: the loss trace 1e-5 and every parameter after the steps
1e-5 (f32; the same math in another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.hapi import text as jtext
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.hapi import text as ttext

TOL = 1e-5
STEPS = 3
B, T, VOCAB, EMB, FILTERS = 4, 12, 50, 16, 8


def _build(fluid, text, pool_size):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [B, T], "int64", append_batch_size=False)
        lbl = L.data("lbl", [B, 1], "int64", append_batch_size=False)
        emb = L.embedding(ids, size=[VOCAB, EMB])
        enc = text.CNNEncoder(num_channels=EMB, num_filters=FILTERS,
                              filter_sizes=(3, 4, 5), pool_size=pool_size)
        logits = L.fc(enc(emb), 2)
        loss = L.mean(L.softmax_with_cross_entropy(logits, lbl))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in program.global_block().ops]


def _vars(program):
    return {n: (v.shape, str(v.dtype), v.persistable, v.stop_gradient)
            for n, v in program.global_block().vars.items()}


@pytest.mark.parametrize("pool_size", [None, 2])
def test_text_cnn_loss_trace_matches_jax(pool_size):
    jm, js, jl = _build(jfluid, jtext, pool_size)
    tm, ts, tl = _build(tfluid, ttext, pool_size)
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)
    types = {op.type for op in tm.global_block().ops}
    assert {"concat", "conv2d"} <= types
    if pool_size is None:
        assert "reduce_max" in types
    else:
        assert {"pool2d", "squeeze2", "transpose2"} <= types
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    texe = tfluid.Executor(device="cpu")
    rng = np.random.default_rng(22)
    feed = {"ids": rng.integers(0, VOCAB, (B, T)).astype(np.int64),
            "lbl": rng.integers(0, 2, (B, 1)).astype(np.int64)}
    want, got = [], []
    for _ in range(STEPS):
        want.append(float(jexe.run(jm, feed=feed, fetch_list=[jl],
                                   scope=jscope)[0][0]))
        got.append(float(texe.run(tm, feed=feed, fetch_list=[tl],
                                  scope=tscope)[0][0]))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]
    for n in state:
        np.testing.assert_allclose(
            tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
            atol=TOL, rtol=0, err_msg=n)


def test_conv1d_pool_layer_shapes_match_jax():
    """A lone ``Conv1dPoolLayer`` in each branch gives the JAX layer's
    output shape: [B, F] pooled globally, [B, T'', F] in windows."""
    def out_shape(fluid, text, pool_size):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = L.data("x", [B, T, EMB], "float32", append_batch_size=False)
            return tuple(text.Conv1dPoolLayer(EMB, FILTERS, 4,
                                              pool_size=pool_size)(x).shape)

    for pool in (None, 3):
        assert (out_shape(tfluid, ttext, pool)
                == out_shape(jfluid, jtext, pool))
