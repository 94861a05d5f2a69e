"""The Transformer-base NMT of ``models/transformer.py`` built, differentiated
and trained by the port against the JAX package, on the CPU.

Both packages build ``build_transformer_nmt_program`` -> ``AdamOptimizer``
-> (``mixed_precision.decorate(use_bf16=True)``) -> ``minimize`` under
``unique_name.guard()``, with dropout 0 and label smoothing 0.1 (the
analytic logsumexp chain: ``reduce_max``, ``exp``, ``log``); the programs
hold the same ops, slots and variables; the JAX startup scope is copied
across with ``Scope.from_numpy``; then 3 Adam steps on one batch whose
second source row is padded.  The loss traces agree within 1e-5 in f32
and within 2e-2 under bf16 AMP (bf16 rounds at other places in the two
frameworks; one bf16 ulp of a loss near 4 is 1.6e-2), and every parameter
and Adam moment within 1e-5 in f32 (the same math in another summation
order).

Configurations: ``fuse_stack`` True and False; ``TransformerConfig.tiny()``
(head dim 8: the attention's composition branch in both packages), and
d_model 128 as 2 heads of 64 at lengths 128, where the JAX side runs its
Pallas flash and LayerNorm kernels in interpret mode (``FORCE_PALLAS``) and
the port takes the BSH flash branch for all three attentions (its kernels'
plain versions, counted through the autograd Function's calls).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import attention as jax_attention
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import flash_attention as fa

F32_TOL, BF16_TOL = 1e-5, 2e-2
STEPS = 3

# (config overrides, batch, src_len, trg_len)
WIDTHS = {
    "tiny": (dict(), 2, 16, 12),
    "d64_s128": (dict(src_vocab_size=96, trg_vocab_size=96, d_model=128,
                      num_heads=2, d_inner=256), 2, 128, 128),
}
CASES = [("tiny", False, False), ("tiny", True, False), ("tiny", False, True),
         ("tiny", True, True), ("d64_s128", False, False),
         ("d64_s128", True, False), ("d64_s128", False, True)]


def _cfg(tr, width):
    kw = WIDTHS[width][0]
    return dataclasses.replace(tr.TransformerConfig.tiny(), dropout=0.0,
                               label_smooth_eps=0.1, **kw)


def _build(fluid, nn, tr, mp, width, fuse, amp):
    _, b, s, t = WIDTHS[width]
    nn._rng_salt_counter[0] = 0
    cfg = _cfg(tr, width)
    cfg.fuse_stack = fuse
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, feeds, loss = tr.build_transformer_nmt_program(
            cfg, b, s, t, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3)
            if amp:
                opt = mp.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return cfg, m, st, feeds, loss


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _feed(cfg, width):
    _, b, s, t = WIDTHS[width]
    feed = jtr.random_nmt_batch(cfg, b, s, t, seed=1)
    feed["src_mask"][1, s // 2 + 3:] = 0.0      # a padded source row
    feed["label_weights"][1, t - 3:] = 0.0      # and padded targets
    return feed


@pytest.mark.parametrize("width,fuse,amp", CASES,
                         ids=[f"{w}-{'fused' if f else 'layers'}-"
                              f"{'bf16' if a else 'f32'}"
                              for w, f, a in CASES])
def test_train_loss_trace_matches_jax(width, fuse, amp, monkeypatch):
    jc, jm, js, jfeeds, jl = _build(jfluid, jnn, jtr, jmp, width, fuse, amp)
    tc, tm, ts, tfeeds, tl = _build(tfluid, tnn, ttr, tmp, width, fuse, amp)
    assert tfeeds == jfeeds
    assert _ops(tm) == _ops(jm)
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)
    assert sorted(p.name for p in tm.all_parameters()) == sorted(
        p.name for p in jm.all_parameters())
    types = {op.type for op in tm.global_block().ops}
    assert {"reduce_max", "exp", "log"} <= types
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    feed = _feed(jc, width)
    calls = []
    real = fa._FlashBSH.apply
    monkeypatch.setattr(fa._FlashBSH, "apply",
                        lambda *a: calls.append(1) or real(*a))
    texe = tfluid.Executor(device="cpu")
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
    # one BSH call an encoder layer, two a decoder layer (causal
    # self-attention, cross-attention with the source key bias)
    per_step = tc.n_encoder_layers + 2 * tc.n_decoder_layers
    assert len(calls) == (per_step * STEPS if width == "d64_s128" else 0)
    np.testing.assert_allclose(got, want, atol=BF16_TOL if amp else F32_TOL,
                               rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]
    if not amp:
        for n in state:
            np.testing.assert_allclose(
                tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                atol=F32_TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("cfg_name", ["base", "tiny"])
def test_step_flops_and_batch_match_jax(cfg_name):
    jc = getattr(jtr.TransformerConfig, cfg_name)()
    tc = getattr(ttr.TransformerConfig, cfg_name)()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for b, s, t in ((64, 256, 256), (3, 17, 9)):
        assert ttr.transformer_step_flops(tc, b, s, t) == \
            jtr.transformer_step_flops(jc, b, s, t)
        want = jtr.random_nmt_batch(jc, b, s, t, seed=4)
        got = ttr.random_nmt_batch(tc, b, s, t, seed=4)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_ports_own_startup_trains_with_dropout():
    """The port's startup program initialises the weights; with dropout
    0.1 (drawn per step) the loss still falls on a fixed batch, fused and
    per layer."""
    for fuse in (False, True):
        tnn._rng_salt_counter[0] = 0
        cfg = ttr.TransformerConfig.tiny()
        cfg.fuse_stack = fuse
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard():
            m, st, _, loss = ttr.build_transformer_nmt_program(
                cfg, 2, 16, 12, main_program=main, startup_program=startup)
            with tfluid.program_guard(m, st):
                tfluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
        scope, exe = tfluid.Scope(), tfluid.Executor(device="cpu")
        exe.run(st, scope=scope)
        feed = ttr.random_nmt_batch(cfg, 2, 16, 12, seed=2)
        losses = [exe.run(m, feed=feed, fetch_list=[loss],
                          scope=scope)[0][0] for _ in range(8)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], fuse
