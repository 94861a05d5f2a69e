"""The slice as a whole: BERT pretraining (MLM + NSP) built, differentiated
and trained by the port against the JAX package, on the CPU.

Both packages build ``build_bert_pretrain_program`` -> ``AdamOptimizer``
-> (``mixed_precision.decorate(use_bf16=True)``) -> ``minimize`` under
``unique_name.guard()``, with dropout 0; the programs hold the same ops,
slots and variables; the JAX startup scope is copied across with
``Scope.from_numpy``; then 5 Adam steps on one batch.  The loss traces
agree within 1e-5 in f32 (measured about 5e-7: the same math in another
summation order) and within 2e-2 under bf16 AMP (bf16 rounds at other
places in the two frameworks; one bf16 ulp of a loss near 5 is 3e-2),
and every parameter and Adam moment within 1e-5 in f32.

Configurations: ``fuse_stack`` True and False; ``BertConfig.tiny()``
widths (head dim 8: the attention's composition branch in both
packages) and hidden 128 as 2 heads of 64 at S = 128, where the JAX side
runs its Pallas flash and LayerNorm kernels in interpret mode
(``FORCE_PALLAS``) and the port takes the flash branch (its kernels'
plain versions, checked by counting the autograd Function's calls); and
``fuse_stack`` in f32 under ``remat_policy="flash"`` at both widths, the
JAX package's checkpoint-name policy against the port's.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import attention as jax_attention
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid.layers import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.kernels import flash_attention as fa

F32_TOL, BF16_TOL = 1e-5, 2e-2
STEPS = 5

WIDTHS = {
    "tiny": (dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=64), 2, 16, 3),
    "d64_s128": (dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      max_position_embeddings=128), 2, 128, 5),
}
CASES = [("tiny", False, False), ("tiny", True, False), ("tiny", False, True),
         ("tiny", True, True), ("d64_s128", True, False),
         ("d64_s128", False, False), ("d64_s128", True, True)]


def _build(fluid, nn, bert, mp, width, fuse, amp, **extra):
    kw, b, s, mpn = WIDTHS[width]
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(**kw, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0, fuse_stack=fuse,
                          **extra)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, b, s, mpn, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-3)
            if amp:
                opt = mp.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return cfg, m, st, loss


def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("width,fuse,amp", CASES,
                         ids=[f"{w}-{'fused' if f else 'layers'}-"
                              f"{'bf16' if a else 'f32'}"
                              for w, f, a in CASES])
def test_train_loss_trace_matches_jax(width, fuse, amp, monkeypatch):
    _check_trace(width, fuse, amp, monkeypatch)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_remat_policy_loss_trace_matches_jax(width, monkeypatch):
    """``remat_policy="flash"`` on the fused stack: the JAX package's
    checkpoint-name policy against the port's stash of the flash
    forward's o and lse; the flash forward still runs once a layer a
    step."""
    _check_trace(width, True, False, monkeypatch, remat_policy="flash")


def _check_trace(width, fuse, amp, monkeypatch, **extra):
    jc, jm, js, jl = _build(jfluid, jnn, jbert, jmp, width, fuse, amp,
                            **extra)
    tc, tm, ts, tl = _build(tfluid, tnn, tbert, tmp, width, fuse, amp,
                            **extra)
    assert _ops(tm) == _ops(jm)
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)
    if fuse:
        assert sorted(p.name for p in tm.all_parameters()
                      if p.name.startswith("encoder_stack.")) == sorted(
            p.name for p in jm.all_parameters()
            if p.name.startswith("encoder_stack."))
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tscope = tfluid.Scope.from_numpy(state, device="cpu")
    _, b, s, mpn = WIDTHS[width]
    feed = jbert.random_pretrain_batch(jc, b, s, mpn, seed=1)
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
    layers = tc.num_hidden_layers
    assert len(calls) == (layers * STEPS if width == "d64_s128" else 0)
    np.testing.assert_allclose(got, want, atol=BF16_TOL if amp else F32_TOL,
                               rtol=0)
    assert np.isfinite(got).all() and got[-1] < got[0]
    if not amp:
        for n in state:
            np.testing.assert_allclose(
                tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                atol=F32_TOL, rtol=0, err_msg=n)


def test_the_ports_own_startup_trains_with_dropout():
    """The port's startup program initialises the weights; with dropout
    0.1 (drawn per step) the loss still falls on a fixed batch."""
    tc, tm, ts, tl = _build(tfluid, tnn, tbert, tmp, "tiny", True, False)
    for op in tm.global_block().ops:
        if op.type == "fused_encoder_stack":
            op.attrs.update(dropout_prob=0.1, attn_dropout_prob=0.1)
    tm._bump_version()
    scope = tfluid.Scope()
    exe = tfluid.Executor(device="cpu")
    exe.run(ts, scope=scope)
    feed = tbert.random_pretrain_batch(tc, 2, 16, 3, seed=2)
    losses = [exe.run(tm, feed=feed, fetch_list=[tl], scope=scope)[0][0]
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
