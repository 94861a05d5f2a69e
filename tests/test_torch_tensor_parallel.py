"""Tensor parallelism in the port (Megatron regions over "tp": ``fleet``
tensor_parallel_rules, the column- and row-parallel ``mul`` / ``matmul``,
the vocabulary-parallel ``lookup_table`` and tied MLM head, the attention
op on local heads, the executor's parameter blocks) against the JAX
package's GSPMD runs, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices; the
port's side is one set of 4 gloo ranks at {"dp": 2, "tp": 2}
(``torch_dist_ranks.body_tp``), started once for the module, fed the same
numpy batches and the JAX package's global startup scope (each rank
keeps its blocks: ``Scope.from_numpy(..., program=)``).

* The two-fc model of the JAX package's tests/test_fleet.py (fc_0
  column-parallel, fc_1 row-parallel): 5 Adam steps, the loss trace
  within 2e-5 of the JAX package's single-device run and of its
  {"dp": 2, "tp": 2} run; a ``CheckpointManager`` save holds the global
  values and a restore gives each rank its blocks back bit for bit.
* Tiny BERT, unfused, on the fused attention op, with
  ``tensor_parallel_rules()``: 3 Adam steps, the losses and every
  variable (gathered over tp) within 1e-4 of the JAX package's dp x tp
  run; the two ranks of a tp pair hold every replicated variable bit for
  bit; the program equal to the JAX package's op for op once fleet's
  gradient all-reduce pairs are removed.
* The same under bf16 AMP: losses within 2e-2 of the JAX package's bf16
  dp x tp run.
* The vocabulary-parallel lookup (both op versions, padding index, a
  negative id, ids past the table) and the tied head: values and
  gradients within 1e-5 of the JAX emitters' ``jax.vjp``.
* f, g and the last-rank broadcast: the gradient each must give, which
  ``all_reduce``'s convention (the cotangent summed over the axis) would
  multiply by tp.
* Refusals: tp not dividing a sharded dim (BERT-base's vocabulary at
  tp 4) raises ValueError; an op summing over a whole sharded parameter
  (a global-norm clip) and an op with no tensor-parallel region raise
  NotImplementedError.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as jreg

import torch_dist_ranks
from torch_dist_ranks import TWO_FC_RULES, build_bert, two_fc_model

LOSS_TOL, BERT_TOL, OP_TOL = 2e-5, 1e-4, 1e-5
MESH = {"dp": 2, "tp": 2}
BERT = (dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64), 4, 16, 3)
STEPS = 3


def _two_fc_feed(i):
    rng = np.random.RandomState(i)
    return {"x": rng.randn(16, 8).astype("float32"),
            "y": rng.randn(16, 1).astype("float32")}


def _jax_run(main, startup, loss, mesh_axes, feeds, opt, rules=None):
    """minimize under the JAX package's fleet, the startup state and
    the loss trace (and the scope after it)."""
    scope = jfluid.executor.Scope()
    # the optimizer's names (learning_rate_0, ..._moment1_0) as a fresh
    # process, such as a port rank, gives them, whatever this process
    # built before
    with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup):
            strategy = jfleet.DistributedStrategy()
            strategy.mesh_axes = dict(mesh_axes)
            if rules:
                strategy.tensor_parallel = True
                strategy.tensor_parallel_rules = rules
            jfleet.init()
            jfleet.distributed_optimizer(opt, strategy).minimize(loss)
        exe = jfluid.Executor()
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]).reshape(()))
                  for f in feeds]
    return state, losses, scope


def _jax_bert(amp=False):
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *BERT,
                                          fuse_stack=False)
    _, b, s, mpn = BERT
    feed = jbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
    opt = jfluid.optimizer.AdamOptimizer(1e-3)
    if amp:
        from paddle_tpu.contrib import mixed_precision

        opt = mixed_precision.decorate(opt, use_bf16=True)
    state, losses, scope = _jax_run(main, startup, loss, MESH,
                                    [feed] * STEPS, opt,
                                    jbert.tensor_parallel_rules())
    return main, feed, state, losses, scope


def _op_payload():
    rng = np.random.default_rng(4)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    ids = np.array([[3, 0, 11, -2], [12, 7, 5, 0]], np.int32)   # V = 12
    return {"table": f(12, 6), "ids": ids, "padding_idx": 5,
            "ct_lookup": f(2, 4, 6), "trans": f(5, 6), "ct_head": f(5, 12),
            "c": f(3, 4), "c_rank": f(2, 3, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, and the port's ranks for every case."""
    feeds = [_two_fc_feed(i) for i in range(5)]
    main, startup, loss = two_fc_model(jfluid, jlayers, seed=7)
    state, single, _ = _jax_run(main, startup, loss, {"dp": 1}, feeds,
                                jfluid.optimizer.AdamOptimizer(1e-2))
    bert_main, feed, bert_state, bert_losses, bert_scope = _jax_bert()
    _, _, bf16_state, bf16_losses, _ = _jax_bert(amp=True)
    ops = _op_payload()
    started = torch_dist_ranks.Ranks(
        "tp", 4, tmp_path_factory.mktemp("tp"),
        {"two_fc": {"mesh_axes": MESH, "state": state, "feeds": feeds,
                    "ckpt": str(tmp_path_factory.mktemp("ckpt"))},
         "bert": {"bert": BERT, "fuse_stack": False, "mesh_axes": MESH,
                  "tp": True, "state": bert_state, "feed": feed,
                  "steps": STEPS},
         "bert_bf16": {"bert": BERT, "fuse_stack": False, "mesh_axes": MESH,
                       "tp": True, "state": bf16_state, "feed": feed,
                       "steps": STEPS, "amp": True},
         "ops": ops}, timeout=90.0)
    main, startup, loss = two_fc_model(jfluid, jlayers, seed=7)
    _, dptp, _ = _jax_run(main, startup, loss, MESH, feeds,
                          jfluid.optimizer.AdamOptimizer(1e-2), TWO_FC_RULES)
    return {"ranks": started.join(), "single": single, "dptp": dptp,
            "bert": (bert_main, bert_state, bert_losses, bert_scope),
            "bf16": bf16_losses, "ops": ops}


def test_two_fc_dp2_tp2_matches_jax_single_and_dp_tp(runs):
    ranks = runs["ranks"]
    got = ranks[0]["two_fc"]["losses"]
    for r in ranks[1:]:
        assert r["two_fc"]["losses"] == got
    np.testing.assert_allclose(got, runs["single"], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(got, runs["dptp"], atol=LOSS_TOL, rtol=0)
    regions = [r for r in ranks[0]["two_fc"]["regions"] if r]
    assert regions == ["column", "row", "row", "column"]   # fwd, then grads
    # CheckpointManager under tp: the global values saved, the blocks
    # restored bit for bit
    for r in ranks:
        got = r["two_fc"]
        # a fetch of a tp-sharded parameter is gathered to its global value
        assert got["fetched_w"].shape == (8, 32)
        np.testing.assert_array_equal(got["fetched_w"], got["gathered_w"])
        assert got["restored_equal"] == got["state_names"]
        assert got["saved_shapes"]["fc_0.w_0"] == (8, 32)
        assert got["saved_shapes"]["fc_1.w_0_moment1_0"] == (32, 1)


def test_tiny_bert_dp2_tp2_matches_jax(runs):
    main, state, want, scope = runs["bert"]
    ranks = [r["bert"] for r in runs["ranks"]]
    got = [float(np.asarray(v).reshape(())) for v in ranks[0]["losses"]]
    np.testing.assert_allclose(got, want, atol=BERT_TOL, rtol=0)
    assert got[-1] < got[0]
    for n in state:
        np.testing.assert_allclose(
            ranks[0]["state"][n].astype(np.float64),
            np.asarray(scope.find_var(n)).astype(np.float64),
            atol=BERT_TOL, rtol=0, err_msg=n)
    # every rank gathers the same globals; a tp pair (ranks 0, 1 and
    # 2, 3) holds the same bits of every variable tp does not shard
    sharded = {p.name for p in main.all_parameters()
               for pat, _ in jbert.tensor_parallel_rules()
               if re.search(pat, p.name)}
    for r in ranks[1:]:
        for n, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)
    for a, b in ((0, 1), (2, 3)):
        for n, v in ranks[a]["local"].items():
            if not any(n.startswith(s) for s in sharded):
                np.testing.assert_array_equal(ranks[b]["local"][n], v,
                                              err_msg=n)
    assert ranks[0]["local"]["word_embedding"].shape == (64, 32)
    # op for op, once the inserted gradient all-reduce pairs are removed
    ops = ranks[0]["ops"]
    assert [o[:3] for o in ops if not o[3]] == [
        (op.type, op.inputs, op.outputs) for op in main.global_block().ops]
    regions = sorted({o[4] for o in ops if o[4]})
    assert regions == ["column", "head", "row", "vocab", "vocab_head"]


def test_tiny_bert_dp2_tp2_bf16_amp_matches_jax(runs):
    """Under bf16 AMP the casts sit between the sharded parameters and
    their regions: the losses within 2e-2 of the JAX package's bf16
    dp x tp run (bf16 rounds at other places), the ranks' gathered state
    equal bit for bit."""
    ranks = [r["bert_bf16"] for r in runs["ranks"]]
    got = [float(np.asarray(v).reshape(())) for v in ranks[0]["losses"]]
    np.testing.assert_allclose(got, runs["bf16"], atol=2e-2, rtol=0)
    assert got[-1] < got[0]
    for r in ranks[1:]:
        for n, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)


def test_vocab_parallel_lookup_and_tied_head_match_jax(runs):
    p = runs["ops"]
    table, ids = jnp.asarray(p["table"]), jnp.asarray(p["ids"])
    for op, i in (("lookup_table_v2", ids), ("lookup_table", ids[..., None])):
        def f(w, i=i, op=op):
            return jreg.get(op).emit(
                jreg.EmitContext(), {"W": [w], "Ids": [i]},
                {"padding_idx": p["padding_idx"]})["Out"][0]

        out, vjp = jax.vjp(f, table)
        (dw,) = vjp(jnp.nan_to_num(jnp.asarray(p["ct_lookup"])))
        for r in runs["ranks"]:
            got = r["ops"][op]
            np.testing.assert_allclose(got["out"], np.asarray(out),
                                       atol=OP_TOL, rtol=0, err_msg=op)
            np.testing.assert_allclose(got["dw"], np.asarray(dw),
                                       atol=OP_TOL, rtol=0, err_msg=op)
    assert np.isnan(runs["ranks"][0]["ops"]["lookup_table_v2"]["out"][1, 0]
                    ).all()                                   # id 12

    def head(x, w):
        return jreg.get("matmul").emit(
            jreg.EmitContext(), {"X": [x], "Y": [w]},
            {"transpose_X": False, "transpose_Y": True,
             "alpha": 1.0})["Out"][0]

    out, vjp = jax.vjp(head, jnp.asarray(p["trans"]), table)
    dx, dw = vjp(jnp.asarray(p["ct_head"]))
    for r in runs["ranks"]:
        got = r["ops"]["head"]
        for k, want in (("out", out), ("dx", dx), ("dw", dw)):
            np.testing.assert_allclose(got[k], np.asarray(want),
                                       atol=OP_TOL, rtol=0, err_msg=k)


def test_region_collectives_keep_their_cotangent_convention(runs):
    """f sums the cotangent over tp, g and the last-rank broadcast hand
    each rank's own cotangent through once.  Under all_reduce's
    convention g's and the broadcast's gradients would be tp x c."""
    p = runs["ops"]
    c, cr = p["c"], p["c_rank"]
    for r in runs["ranks"]:
        got = r["ops"]
        np.testing.assert_array_equal(got["f"]["y"], c)
        np.testing.assert_allclose(got["f"]["dx"], cr[0] + cr[1],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["g"]["y"], cr[0] + cr[1],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["g"]["dx"], c)
        np.testing.assert_array_equal(got["broadcast"]["y"], cr[1])
        np.testing.assert_array_equal(got["broadcast"]["dx"], c)
        assert not np.array_equal(got["g"]["dx"], 2 * c)


def _tp_minimize(build, mesh_axes, rules, clip=None):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.parallel import Mesh

    main, startup, loss = build(fluid)
    with fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh = Mesh(mesh_axes)       # no process group: no rank
        strategy.tensor_parallel_rules = rules
        fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(1e-3, grad_clip=clip),
            strategy).minimize(loss)
    return main


def _bert_vocab(fluid):
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert

    kw = dict(BERT[0], vocab_size=30522)
    return build_bert(fluid, nn, bert, kw, *BERT[1:], fuse_stack=False)[1:]


def _two_fc(fluid):
    from paddle_tpu_torch.fluid import layers

    return two_fc_model(fluid, layers, seed=7)


def test_tp_refusals():
    from paddle_tpu_torch.fluid.clip import GradientClipByGlobalNorm
    from paddle_tpu_torch.models import bert

    with pytest.raises(ValueError, match="word_embedding.*not divisible"):
        _tp_minimize(_bert_vocab, {"dp": 1, "tp": 4},
                     bert.tensor_parallel_rules())
    with pytest.raises(NotImplementedError, match="squared_l2_norm"):
        _tp_minimize(_two_fc, {"dp": 1, "tp": 2}, TWO_FC_RULES,
                     clip=GradientClipByGlobalNorm(1.0))
    # fc_0's bias left replicated under a column-parallel weight: its add
    # reads a column block and a whole bias
    with pytest.raises(NotImplementedError, match="no tensor-parallel"):
        _tp_minimize(_two_fc, {"dp": 1, "tp": 2},
                     [r for r in TWO_FC_RULES if "b_0" not in r[0]])
    # the rules pass on a mesh tp divides; the JAX package's width
    main = _tp_minimize(_two_fc, {"dp": 1, "tp": 2}, TWO_FC_RULES)
    assert [op.attrs.get("tp_region") for op in main.global_block().ops
            if op.attrs.get("tp_region")][:2] == ["column", "row"]


def test_head_shard_salts_dropout_inside_the_region_only():
    """The two ranks of a tp pair (one data shard) draw different
    attention-dropout masks for their heads, the head shard mixed into
    the seed (the JAX package's 0x1B873593 x tp index); a dropout op
    outside the region draws the same mask on both, and both ranks get
    the same step seed from the executor's data-shard salt.  Meshes
    without a process group stand for the two ranks."""
    import torch

    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import Mesh

    rng = np.random.default_rng(9)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 16, 8)),
                               dtype=torch.float32) for _ in range(3))
    x = torch.ones(64, 64)
    attn, drop = [], []
    for rank in (0, 1):
        mesh = Mesh({"dp": 1, "tp": 2}, rank=rank)
        assert mesh.shard_index(mesh.data_axes) == 0
        ctx = treg.EmitContext(seed=5, device="cpu", mesh=mesh)
        attn.append(treg.get("fused_multihead_attention").emit(
            ctx, {"Q": [q], "K": [k], "V": [v]},
            {"num_heads": 2, "dropout_prob": 0.5, "is_test": False,
             "rng_salt": 1, "tp_region": "head"})["Out"][0])
        drop.append(treg.get("dropout").emit(
            ctx, {"X": [x]}, {"dropout_prob": 0.5, "is_test": False,
                              "dropout_implementation":
                                  "upscale_in_train"})["Out"][0])
    assert not torch.equal(attn[0], attn[1])
    assert torch.equal(drop[0], drop[1])
    # without the region attr both ranks draw alike
    same = [treg.get("fused_multihead_attention").emit(
        treg.EmitContext(seed=5, device="cpu",
                         mesh=Mesh({"dp": 1, "tp": 2}, rank=r)),
        {"Q": [q], "K": [k], "V": [v]},
        {"num_heads": 2, "dropout_prob": 0.5, "is_test": False,
         "rng_salt": 1})["Out"][0] for r in (0, 1)]
    assert torch.equal(same[0], same[1])
    # a full [B, nh, S, S] bias: each rank reads its heads' rows of it
    bias = torch.as_tensor(rng.standard_normal((2, 4, 16, 16)),
                           dtype=torch.float32)
    for rank in (0, 1):
        got = treg.get("fused_multihead_attention").emit(
            treg.EmitContext(device="cpu",
                             mesh=Mesh({"dp": 1, "tp": 2}, rank=rank)),
            {"Q": [q], "K": [k], "V": [v], "BiasQK": [bias]},
            {"num_heads": 4, "is_test": True,
             "tp_region": "head"})["Out"][0]
        want = treg.get("fused_multihead_attention").emit(
            treg.EmitContext(device="cpu"),
            {"Q": [q], "K": [k], "V": [v],
             "BiasQK": [bias[:, 2 * rank:2 * rank + 2]]},
            {"num_heads": 2, "is_test": True})["Out"][0]
        assert torch.equal(got, want)


def test_two_fc_dp2_tp2_after_a_jax_minimize_in_this_process(tmp_path):
    """The JAX side names the optimizer's state as a fresh process does
    even after this process built another optimizer (the xdist worker's
    earlier files): its scope, handed to the port's ranks, holds
    ``learning_rate_0``, and the dp x tp run matches the JAX package's."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.data("x", [4, 3], "float32")
        jfluid.optimizer.AdamOptimizer(1e-3).minimize(
            jlayers.reduce_mean(jlayers.fc(x, 2)))
    feeds = [_two_fc_feed(i) for i in range(5)]
    main, startup, loss = two_fc_model(jfluid, jlayers, seed=7)
    state, want, _ = _jax_run(main, startup, loss, MESH, feeds,
                              jfluid.optimizer.AdamOptimizer(1e-2),
                              TWO_FC_RULES)
    assert "learning_rate_0" in state
    ranks = torch_dist_ranks.spawn(
        "two_fc_tp", 4, tmp_path / "ranks",
        {"mesh_axes": MESH, "state": state, "feeds": feeds,
         "ckpt": str(tmp_path / "ckpt")}, timeout=60.0)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_TOL, rtol=0)
