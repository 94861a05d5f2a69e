"""``Executor.memory_analysis`` of the port on the CPU: the JAX package's
keys, the RuntimeError before the startup program has run, a scope left
bit for bit as it was (the next step's loss equals a run's without the
call), and the remat ladder's peaks in the order the ladder relies on.

The port measures one trial step (the CPU's high-water mark from the
torch profiler's memory records) where the JAX package asks XLA for an
estimate, so only the keys and the relations are compared, not the
numbers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.models import bert as tbert


def _fc_program(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", [8, 16], "float32", append_batch_size=False)
        loss = layers.reduce_mean(layers.fc(x, 32))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def test_keys_match_jax_and_startup_comes_first():
    feed = {"x": np.random.default_rng(0).standard_normal(
        (8, 16)).astype(np.float32)}
    jm, js, jl = _fc_program(jfluid, jlayers)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(js, scope=jscope)
    want = jexe.memory_analysis(jm, feed=feed, fetch_list=[jl],
                                scope=jscope)
    tm, ts, tl = _fc_program(tfluid, tlayers)
    texe, tscope = tfluid.Executor(device="cpu"), tfluid.Scope()
    with pytest.raises(RuntimeError, match="startup"):
        texe.memory_analysis(tm, feed=feed, fetch_list=[tl], scope=tscope)
    texe.run(ts, scope=tscope)
    got = texe.memory_analysis(tm, feed=feed, fetch_list=[tl], scope=tscope)
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, int) and v >= 0 for v in got.values())
    # fc weight [16, 32] and bias [32], the learning rate [1], and the
    # [8, 16] feed, all f32
    assert got["argument_size_in_bytes"] == (16 * 32 + 32 + 1 + 8 * 16) * 4
    # the new weight and bias, and the loss
    assert got["output_size_in_bytes"] == (16 * 32 + 32 + 1) * 4
    assert got["peak_bytes"] >= got["temp_size_in_bytes"]
    assert got["peak_bytes"] == (got["argument_size_in_bytes"]
                                 + got["output_size_in_bytes"]
                                 + got["temp_size_in_bytes"]
                                 - got["alias_size_in_bytes"])


def _bert(**remat):
    cfg = tbert.BertConfig(vocab_size=128, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=512,
                           max_position_embeddings=256, fuse_stack=True,
                           **remat)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        m, st, _, loss = tbert.build_bert_pretrain_program(
            cfg, 8, 256, 20, main_program=main, startup_program=startup)
        with tfluid.program_guard(m, st):
            tfluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return cfg, m, st, loss


def test_scope_is_left_as_it_was():
    """BERT with dropout 0.1 under remat_policy="flash": after the call
    every scope tensor and the step seed are unchanged, and the next
    step's loss equals that of a scope that never saw the call."""
    cfg, main, startup, loss = _bert(remat_policy="flash")
    exe = tfluid.Executor(device="cpu")
    feed = tbert.random_pretrain_batch(cfg, 8, 256, 20, seed=0)
    scopes = []
    for _ in range(2):
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        scopes.append(scope)
    probed, plain = scopes
    before = {n: v.clone() for n, v in probed.vars.items()}
    seed = probed._rng_seed
    ma = exe.memory_analysis(main, feed=feed, fetch_list=[loss],
                             scope=probed)
    assert ma["peak_bytes"] > ma["argument_size_in_bytes"] > 0
    assert probed._rng_seed == seed
    assert sorted(probed.vars) == sorted(before)
    for n, v in before.items():
        assert torch.equal(probed.find_var(n), v), n
    got = exe.run(main, feed=feed, fetch_list=[loss], scope=probed)[0]
    want = exe.run(main, feed=feed, fetch_list=[loss], scope=plain)[0]
    np.testing.assert_array_equal(got, want)


def test_remat_ladder_peaks_order():
    """The rungs of bench.py's ladder, cheapest recompute first, take
    less memory in turn: no remat > remat_ffn > remat_policy "flash"
    (which keeps the flash forward's o and lse a layer) > remat_layer."""
    peaks = {}
    for name, remat in (("none", {}), ("remat_ffn", {"remat_ffn": True}),
                        ("flash", {"remat_policy": "flash"}),
                        ("remat_layer", {"remat_layer": True})):
        cfg, main, startup, loss = _bert(**remat)
        exe, scope = tfluid.Executor(device="cpu"), tfluid.Scope()
        exe.run(startup, scope=scope)
        feed = tbert.random_pretrain_batch(cfg, 8, 256, 20, seed=0)
        peaks[name] = exe.memory_analysis(main, feed=feed, fetch_list=[loss],
                                          scope=scope)["peak_bytes"]
    assert (peaks["none"] > peaks["remat_ffn"] > peaks["flash"]
            > peaks["remat_layer"]), peaks
