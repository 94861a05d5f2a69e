"""The slice as a whole: BERT built, frozen and served by the port against
the JAX package, on the CPU.

Both packages build the same encoder + pooler (dropout on, as a user
builds it for training) under ``unique_name.guard()``; the JAX package's
startup program initialises the weights and its scope is copied across
as numpy arrays (the two packages' random streams differ); both programs
are frozen with the same fetch list and served by their predictors on
the same padded batch.  ``seq_out`` and ``pooled`` agree within 1e-4
(measured about 1e-6: the same f32 math in another summation order).

Two configurations: ``BertConfig.tiny()`` (d = 8: the attention op's
plain composition in both packages) and hidden 128 x 2 heads (d = 64) at
S = 128, where the JAX side runs its Pallas BSH flash and fused
LayerNorm kernels in interpret mode (``FORCE_PALLAS``) and the port
takes the BSH kernel branch, i.e. its kernels' plain versions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import freeze_program as jax_freeze
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import attention as jax_attention
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.inference import ServingPredictor, freeze_program
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.kernels import flash_attention as fa

TOL = 1e-4

CONFIGS = {
    "tiny": (dict(), 2, 16),
    "d64_s128_pallas": (dict(vocab_size=128, hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=256,
                             max_position_embeddings=128), 2, 128),
}


def _cfg(bert, name):
    kw = CONFIGS[name][0]
    return bert.BertConfig(**kw) if kw else bert.BertConfig.tiny()


def _build(fluid, nn, bert, cfg, b, s):
    nn._rng_salt_counter[0] = 0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        def data(name, dtype):
            return fluid.layers.data(name, [b, s], dtype,
                                     append_batch_size=False)

        ids, types, pos = (data(n, "int32") for n in
                           ("input_ids", "token_type_ids", "position_ids"))
        seq = bert.bert_encoder(cfg, ids, types, pos,
                                data("input_mask", "float32"), is_test=False)
        pooled = bert.bert_pooler(cfg, seq)
    return main, startup, seq, pooled


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([s, s // 2 + 3])[:b]
    live = np.arange(s)[None, :] < lens[:, None]
    return {
        "input_ids": np.where(live, rng.integers(1, cfg.vocab_size, (b, s)),
                              0).astype(np.int32),
        "token_type_ids": (rng.random((b, s)) > 0.5).astype(np.int32),
        "position_ids": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
        "input_mask": live.astype(np.float32)}


@pytest.fixture(params=sorted(CONFIGS))
def frozen_pair(request):
    name = request.param
    _, b, s = CONFIGS[name]
    jm, js, jseq, jpool = _build(jfluid, jnn, jbert, _cfg(jbert, name), b, s)
    tm, _, tseq, tpool = _build(tfluid, tnn, tbert, _cfg(tbert, name), b, s)
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    weights = {n: np.asarray(v) for n, v in jscope.vars.items()
               if v is not None}
    tscope = tfluid.Scope.from_numpy(weights, device="cpu")
    jf = jax_freeze(jm, scope=jscope, fetch_list=[jseq, jpool])
    tf = freeze_program(tm, scope=tscope, fetch_list=[tseq, tpool])
    return name, jf, tf


def test_frozen_programs_match(frozen_pair):
    _, jf, tf = frozen_pair
    jops = [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in jf.program.global_block().ops]
    tops = [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in tf.program.global_block().ops]
    assert tops == jops
    assert tf.param_names == jf.param_names
    assert tf.feed_names == jf.feed_names
    assert tf.fetch_names == jf.fetch_names
    assert tf.model_info() == jf.model_info()
    assert sorted(tf.program.global_block().vars) == sorted(
        jf.program.global_block().vars)
    # every op that had a training mode is in test mode now
    test_ops = [op for op in tf.program.global_block().ops
                if "is_test" in op.attrs]
    assert test_ops and all(op.attrs["is_test"] for op in test_ops)


def test_predictors_agree(frozen_pair, monkeypatch):
    name, jf, tf = frozen_pair
    _, b, s = CONFIGS[name]
    feed = _batch(_cfg(tbert, name), b, s)
    jax_attention.FORCE_PALLAS = name.endswith("pallas")
    try:
        want = JaxPredictor(jf).run(feed)
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = []
    real = fa.flash_attention_bsh_fwd

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_bsh_fwd", spy)
    got = ServingPredictor(tf, device="cpu").run(feed)
    # the d=64 model takes the BSH kernel branch in every layer
    assert len(calls) == (2 if name.endswith("pallas") else 0)
    for a, b_ in zip(want, got):
        assert b_.shape == a.shape and b_.dtype == a.dtype
        np.testing.assert_allclose(b_, a, atol=TOL, rtol=0)


def test_predictor_checks_feeds_and_adopts_weights(frozen_pair):
    name, _, tf = frozen_pair
    _, b, s = CONFIGS[name]
    pred = ServingPredictor(tf, device="cpu")
    feed = _batch(_cfg(tbert, name), b, s)
    with pytest.raises(ValueError, match="missing"):
        pred.run({k: v for k, v in feed.items() if k != "input_mask"})
    with pytest.raises(ValueError, match="unknown"):
        pred.run(dict(feed, extra=np.zeros(1)))
    before = pred.run(feed)[1]
    w = tf.scope.find_var("pooled_fc.b_0").numpy()
    assert pred.adopt_weights({"pooled_fc.b_0": w + 0.5}) == 1
    after = pred.run(feed)[1]
    assert not np.allclose(before, after)
    with pytest.raises(KeyError):
        pred.adopt_weights({"no_such_param": w})
    with pytest.raises(ValueError, match="shape"):
        pred.adopt_weights({"pooled_fc.b_0": w[:-1]})


def test_pretrain_loss_matches_jax():
    cfg_j, cfg_t = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    jm, js, _, jloss = jbert.build_bert_pretrain_program(cfg_j, 2, 16, 3,
                                                         is_test=True)
    tm, _, _, tloss = tbert.build_bert_pretrain_program(cfg_t, 2, 16, 3,
                                                        is_test=True)
    assert [op.type for op in tm.global_block().ops] == [
        op.type for op in jm.global_block().ops]
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    feed = jbert.random_pretrain_batch(cfg_j, 2, 16, 3, seed=1)
    for k, v in tbert.random_pretrain_batch(cfg_t, 2, 16, 3, seed=1).items():
        np.testing.assert_array_equal(v, feed[k])
    want = jfluid.Executor().run(jm, feed=feed, fetch_list=[jloss],
                                 scope=jscope)[0]
    got = tfluid.Executor(device="cpu").run(tm, feed=feed,
                                            fetch_list=[tloss],
                                            scope=tscope)[0]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(moe_num_experts=2)], ids=["kw1"])
def test_unported_bert_options_raise(kw):
    """moe_num_experts raised until the MoE slice was ported: the encoder
    now holds a moe_ffn a layer, op for op the JAX package's, and the
    frozen model serves the JAX package's outputs within TOL."""
    b, s = 2, 16
    jcfg = jbert.BertConfig(**dict(CONFIGS["d64_s128_pallas"][0], **kw))
    tcfg = tbert.BertConfig(**dict(CONFIGS["d64_s128_pallas"][0], **kw))
    jm, js, jseq, jpool = _build(jfluid, jnn, jbert, jcfg, b, s)
    tm, _, tseq, tpool = _build(tfluid, tnn, tbert, tcfg, b, s)
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    tscope = tfluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items() if v is not None},
        device="cpu")
    jf = jax_freeze(jm, scope=jscope, fetch_list=[jseq, jpool])
    tf = freeze_program(tm, scope=tscope, fetch_list=[tseq, tpool])
    ops = [(op.type, op.inputs, op.outputs)
           for op in tf.program.global_block().ops]
    assert ops == [(op.type, op.inputs, op.outputs)
                   for op in jf.program.global_block().ops]
    assert [o[0] for o in ops].count("moe_ffn") == 2
    feed = _batch(tcfg, b, s)
    for a, b_ in zip(JaxPredictor(jf).run(feed),
                     ServingPredictor(tf, device="cpu").run(feed)):
        np.testing.assert_allclose(b_, a, atol=TOL, rtol=0)


def test_frozen_weights_are_captured_from_the_scope():
    cfg = tbert.BertConfig.tiny()
    main, startup, seq, pooled = _build(tfluid, tnn, tbert, cfg, 2, 16)
    scope = tfluid.Scope()
    tfluid.Executor(device="cpu").run(startup, scope=scope)
    frozen = freeze_program(main, scope=scope, fetch_list=[seq, pooled])
    for n in frozen.param_names:
        assert frozen.scope.find_var(n) is scope.find_var(n)
    with pytest.raises(RuntimeError, match="startup"):
        freeze_program(main, scope=tfluid.Scope(), fetch_list=[seq])
    with pytest.raises(ValueError, match="fetch_list"):
        freeze_program(main, scope=scope)
    # the pooled-only model drops nothing the pooler needs
    only = freeze_program(main, scope=scope, fetch_list=[pooled])
    assert only.param_names == frozen.param_names
    assert isinstance(frozen.scope.find_var("word_embedding"), torch.Tensor)
