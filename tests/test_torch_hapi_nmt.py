"""The slice as a whole: the hapi Transformer NMT (``hapi.text``
``TransformerEncoder`` + ``TransformerDecoder``, the network of
``examples/hapi_text_nmt.py``: embeddings times sqrt(d),
``add_position_encoding``, an fc to the vocabulary, softmax cross entropy
and mean) built and trained by the port against the JAX package, on the
CPU.  The encoder is fed the reference recipe's full self-attention bias
``src_slf_attn_bias`` [B, n_head, S, S] (-1e4 at padded keys, tiled over
heads and query rows), the decoder the [B, 1, 1, S] cross bias.

Both packages build the same program (the same ops, slots and variables)
under ``unique_name.guard()`` -> ``AdamOptimizer(1e-3)`` ->
(``mixed_precision.decorate(use_bf16=True)``) -> ``minimize``, dropout 0;
the JAX startup scope is copied across with ``Scope.from_numpy``; then 3
Adam steps on one batch.  Configurations: d_model 128 as 2 heads of 64 at
S = T = 128, where the encoder takes the BHSD flash branch and the
decoder the BSH one (the JAX package's Pallas kernels in interpret mode
under ``FORCE_PALLAS``; the port's kernels' plain versions, the BHSD
autograd Function counted once a layer), and d_model 32 as 4 heads of 8
(the composition in both).  The frozen ``is_test`` programs
(``freeze_program`` + ``ServingPredictor``) are held the same way.  The
new emitters (``expand_as``, ``assign`` from numpy, and the
``add_position_encoding`` they build) are held against the JAX ones.

Tolerances: loss traces 1e-5 in f32 (the same math in another summation
order) and 2e-2 under bf16 AMP (bf16 rounds at other places in the two
frameworks; one bf16 ulp of a loss near 4 is 1.6e-2); parameters and
Adam moments after the steps 1e-5 in f32; frozen logits 2e-5 (f32 over
four stacked layers); emitters 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.hapi import text as jtext
from paddle_tpu.inference import ServingPredictor as JaxPredictor
from paddle_tpu.inference import freeze_program as jax_freeze
from paddle_tpu.ops import attention as jax_attention
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.hapi import text as ttext
from paddle_tpu_torch.inference import ServingPredictor, freeze_program
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.kernels import flash_attention as fa

F32_TOL, BF16_TOL, LOGIT_TOL, EMIT_TOL = 1e-5, 2e-2, 2e-5, 1e-6
STEPS = 3
# B, S, T, vocab, d_model, heads, d_inner, layers
WIDTHS = {"d64_s128": (2, 128, 128, 64, 128, 2, 256, 2),
          "tiny": (2, 24, 16, 64, 32, 4, 64, 2)}
JAX = (jfluid, jlayers, jnn, jtext, jmp)
TORCH = (tfluid, tlayers, tnn, ttext, tmp)


def _build(pkg, width, amp=False, is_test=False, train=True):
    fluid, layers, nn, text, mp = pkg
    b, s, t, v, h, nh, f, n = WIDTHS[width]
    nn._rng_salt_counter[0] = 0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        def data(name, shape, dtype="float32"):
            return layers.data(name, shape, dtype, append_batch_size=False)

        src, trg = data("src_ids", [b, s], "int64"), data("trg_ids", [b, t],
                                                          "int64")
        lbl = data("lbl", [b, t, 1], "int64")
        self_bias = data("src_slf_attn_bias", [b, nh, s, s])
        cross_bias = data("trg_src_attn_bias", [b, 1, 1, s])
        drop = dict(prepostprocess_dropout=0.0, attention_dropout=0.0,
                    relu_dropout=0.0)
        enc = text.TransformerEncoder(n, nh, d_model=h, d_inner_hid=f,
                                      name="enc", **drop)
        dec = text.TransformerDecoder(n, nh, d_model=h, d_inner_hid=f,
                                      name="dec", **drop)

        def embed(ids, name):
            return layers.add_position_encoding(layers.scale(
                layers.embedding(ids, size=[v, h],
                                 param_attr=fluid.ParamAttr(name=name)),
                scale=h ** 0.5), alpha=1.0, beta=1.0)

        out = dec(embed(trg, "trg_emb"),
                  enc(embed(src, "src_emb"), self_bias, is_test=is_test),
                  cross_bias, is_test=is_test)
        logits = layers.fc(out, v, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lbl))
        if train:
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3)
            if amp:
                opt = mp.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return main, startup, loss, logits


def _feed(width, seed=1):
    b, s, t, v, _, nh, _, _ = WIDTHS[width]
    rng = np.random.default_rng(seed)
    lens = np.array([s, s // 2 + 3])[:b]
    live = np.arange(s)[None, :] < lens[:, None]
    key = np.where(live, 0.0, -1e4).astype(np.float32)
    return {"src_ids": np.where(live, rng.integers(2, v, (b, s)), 0),
            "trg_ids": rng.integers(2, v, (b, t)),
            "lbl": rng.integers(2, v, (b, t, 1)),
            # the reference recipe's tiling: [B, n_head, S, S]
            "src_slf_attn_bias": np.tile(key[:, None, None, :],
                                         (1, nh, s, 1)),
            "trg_src_attn_bias": key[:, None, None, :]}


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _count_bhsd(monkeypatch):
    calls = []
    real = fa._FlashBHSD.apply
    monkeypatch.setattr(fa._FlashBHSD, "apply",
                        lambda *a: calls.append(1) or real(*a))
    return calls


CASES = [("d64_s128", False), ("d64_s128", True), ("tiny", False),
         ("tiny", True)]


@pytest.mark.parametrize("width,amp", CASES,
                         ids=[f"{w}-{'bf16' if a else 'f32'}"
                              for w, a in CASES])
def test_nmt_loss_trace_matches_jax(width, amp, monkeypatch):
    jm, js, jl, _ = _build(JAX, width, amp)
    tm, ts, tl, _ = _build(TORCH, width, amp)
    assert _ops(tm) == _ops(jm)
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)
    assert [p.name for p in tm.all_parameters()] == [
        p.name for p in jm.all_parameters()]
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    texe = tfluid.Executor(device="cpu")
    feed = _feed(width)
    calls = _count_bhsd(monkeypatch)
    want, got = [], []
    jax_attention.FORCE_PALLAS = width == "d64_s128"
    try:
        for _ in range(STEPS):
            want.append(jexe.run(jm, feed=feed, fetch_list=[jl],
                                 scope=jscope)[0][0])
            got.append(texe.run(tm, feed=feed, fetch_list=[tl],
                                scope=tscope)[0][0])
    finally:
        jax_attention.FORCE_PALLAS = False
    n_layers = WIDTHS[width][-1]
    assert len(calls) == (n_layers * STEPS if width == "d64_s128" else 0)
    np.testing.assert_allclose(got, want, atol=BF16_TOL if amp else F32_TOL,
                               rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]
    if not amp:
        for n in state:
            np.testing.assert_allclose(
                tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                atol=F32_TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_frozen_nmt_fetches_match_jax(width, monkeypatch):
    """The ``is_test`` network frozen in both packages (the same pruned
    ops) and served: the logits agree."""
    jm, js, _, jlog = _build(JAX, width, is_test=True, train=False)
    tm, _, _, tlog = _build(TORCH, width, is_test=True, train=False)
    jscope = jfluid.Scope()
    jfluid.Executor().run(js, scope=jscope)
    weights = {n: np.asarray(v) for n, v in jscope.vars.items()
               if v is not None}
    tscope = tfluid.Scope.from_numpy(weights, device="cpu")
    feeds = ["src_ids", "trg_ids", "src_slf_attn_bias", "trg_src_attn_bias"]
    jf = jax_freeze(jm, scope=jscope, feed_names=feeds, fetch_list=[jlog])
    tf = freeze_program(tm, scope=tscope, feed_names=feeds,
                        fetch_list=[tlog])
    assert [op.type for op in tf.program.global_block().ops] == [
        op.type for op in jf.program.global_block().ops]
    assert tf.feed_names == jf.feed_names
    feed = {k: v for k, v in _feed(width, seed=2).items() if k != "lbl"}
    jax_attention.FORCE_PALLAS = width == "d64_s128"
    try:
        (want,) = JaxPredictor(jf).run(feed)
    finally:
        jax_attention.FORCE_PALLAS = False
    calls = _count_bhsd(monkeypatch)
    (got,) = ServingPredictor(tf, device="cpu").run(feed)
    assert len(calls) == (WIDTHS[width][-1] if width == "d64_s128" else 0)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL,
                               rtol=0)


def test_the_ports_own_startup_trains_the_nmt_with_dropout():
    """The port's own startup; dropout 0.1 everywhere (drawn per step):
    the loss still falls on a fixed batch."""
    tm, ts, tl, _ = _build(TORCH, "d64_s128")
    for op in tm.global_block().ops:
        if op.type in ("fused_encoder_stack", "fused_decoder_stack"):
            op.attrs.update(dropout_prob=0.1, attn_dropout_prob=0.1)
    tm._bump_version()
    scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
    exe.run(ts, scope=scope)
    feed = _feed("d64_s128", seed=3)
    losses = [exe.run(tm, feed=feed, fetch_list=[tl], scope=scope)[0][0]
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the new emitters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", [((1, 8, 6), (3, 8, 6)),
                                    ((2, 1, 4), (2, 5, 4)),
                                    ((5,), (2, 3, 5))],
                         ids=["batch", "middle", "rank"])
def test_expand_as_emitter_matches_jax(shapes):
    """``expand_as`` forward and its vector-Jacobian product (the sum
    over the broadcast dims)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shapes[0]).astype(np.float32)
    tgt = rng.standard_normal(shapes[1]).astype(np.float32)
    cot = rng.standard_normal(shapes[1]).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: jreg.get("expand_as").emit(
        None, {"X": [a], "target_tensor": [jnp.asarray(tgt)]}, {})["Out"][0],
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    out_t = treg.get("expand_as").emit(
        None, {"X": [xt], "target_tensor": [torch.as_tensor(tgt)]},
        {})["Out"][0]
    (g_t,) = torch.autograd.grad(out_t, xt, torch.as_tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=EMIT_TOL, rtol=0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), atol=EMIT_TOL, rtol=0)


def _pos_program(pkg, b, t, d, alpha, beta):
    fluid, layers = pkg[0], pkg[1]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", [b, t, d], append_batch_size=False)
        table = layers.assign(np.arange(6, dtype=np.int64).reshape(2, 3))
        out = layers.add_position_encoding(x, alpha, beta)
    return main, out, table


@pytest.mark.parametrize("dims", [(2, 8, 6), (1, 16, 7)],
                         ids=["even", "odd_width"])
def test_position_encoding_and_assign_match_jax(dims):
    """``add_position_encoding`` (an ``assign_value`` table, ``reshape2``,
    ``expand_as``, two ``scale`` and an add) and ``assign`` of an int64
    numpy array: the same ops and the same fetches."""
    b, t, d = dims
    jm, jout, jtab = _pos_program(JAX, b, t, d, 0.5, 2.0)
    tm, tout, ttab = _pos_program(TORCH, b, t, d, 0.5, 2.0)
    assert _ops(tm) == _ops(jm)
    assert [{k: v for k, v in op.attrs.items() if not k.startswith("__")}
            for op in tm.global_block().ops
            if op.type == "assign_value"] == [
        {k: v for k, v in op.attrs.items() if not k.startswith("__")}
        for op in jm.global_block().ops if op.type == "assign_value"]
    feed = {"x": np.random.default_rng(1).standard_normal(
        (b, t, d)).astype(np.float32)}
    want = jfluid.Executor().run(jm, feed=feed, fetch_list=[jout, jtab],
                                 scope=jfluid.Scope())
    got = tfluid.Executor(device="cpu").run(tm, feed=feed,
                                            fetch_list=[tout, ttab],
                                            scope=tfluid.Scope())
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=EMIT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert tuple(got[1].shape) == (2, 3)
