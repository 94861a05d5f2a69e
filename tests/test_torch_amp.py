"""The port's AMP (bf16) against the JAX package's.

* ``rewrite_program`` inserts the same cast ops on the same vars: the op
  lists (types, slots, var names, attrs with dtypes by name) and every
  variable's dtype name agree, on BERT's pretraining program (fused stack
  and per-layer) and on a small fc net.
* ``decorate(use_bf16=True).minimize`` appends the same backward and
  update ops (grads of f32 params stay f32: no extra casts).
* A tiny bf16 train runs 5 Adam steps on the CPU with finite, falling
  losses that stay within 2e-2 of the JAX package's (bf16 rounds at
  other places in the two frameworks: one bf16 ulp of a loss near 5 is
  3e-2).
* The float16 branch raises until its emitters are ported.
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

LOSS_TOL = 2e-2


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


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_rewrite_inserts_the_same_casts(name):
    jm = PROGRAMS[name](jfluid, jnn, jbert)
    tm = PROGRAMS[name](tfluid, tnn, tbert)
    with jfluid.unique_name.guard():
        jfu.rewrite_program(jm, jmp.AutoMixedPrecisionLists(), "bfloat16")
    with tfluid.unique_name.guard():
        tfu.rewrite_program(tm, tmp.AutoMixedPrecisionLists(), "bfloat16")
    casts = [op for op in tm.global_block().ops if op.type == "cast"]
    assert casts and any(dtype_name(op.attrs["out_dtype"]) == "bfloat16"
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


def test_float16_branch_raises_until_its_emitters_land():
    with pytest.raises(NotImplementedError, match="isfinite_v2"):
        tmp.decorate(tfluid.optimizer.Adam(1e-3), use_bf16=False)


def test_lists_match_jax():
    j, t = jmp.AutoMixedPrecisionLists(), tmp.AutoMixedPrecisionLists()
    assert (t.white_list, t.black_list) == (j.white_list, j.black_list)
    j = jmp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                    custom_black_list={"mul"})
    t = tmp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                    custom_black_list={"mul"})
    assert (t.white_list, t.black_list) == (j.white_list, j.black_list)
    assert tfu._KEEP_F32_SLOTS == jfu._KEEP_F32_SLOTS
