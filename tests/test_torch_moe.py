"""The Mixture-of-Experts FFN and expert parallelism in the port
(``ops/moe_ops.py``, ``fluid.layers.moe_ffn``, BERT's ``moe_num_experts``,
``fleet.apply_expert_parallel``) against the JAX package, on the CPU.

The JAX side runs in this process on one device: the JAX package's own
dp x ep mesh run is not the oracle (its test is marked slow and "currently
red: EP parity gap"), its one-device run of the same program defines the
op.  The port's multi-rank side is one set of 4 gloo ranks
(``torch_dist_ranks.body_fleet_runs``), started once for the module.

* ``moe_ffn`` top-1 and top-2, f32, bf16 tokens with f32 weights (what
  bf16 AMP hands it) and all bf16: Out, AuxLoss and the gradients of X,
  GateW, W1, B1, W2 and B2 against ``jax.vjp`` (f32 within 1e-5; bf16
  within the bf16 rounding of each output, see ``_TOL``).
* Capacity: one token kept when all go to expert 0 at capacity 1; over
  dp 4 ranks at a global capacity of 6 the ranks' outputs are the
  global op's, rank 1 keeping 2 of its 4 tokens and ranks 2 and 3 none
  because of the lower ranks' tokens (each alone would keep all);
  the gradients of a cotangent of Out summed over the ranks and of
  AuxLoss averaged over them (fleet's mean) are the global op's.  The
  same at dp 2 x ep 2 with each rank's block of the experts.
* Tiny BERT-MoE (unfused, 4 experts, capacity factor 0.5 so that tokens
  drop) in one process, f32 and bf16 AMP: the program the JAX package's
  op for op, the loss trace within 1e-4 (bf16 2e-2) of its.
* The same program at dp 2 x ep 2 and dp 1 x ep 4: 3 Adam steps, the
  losses and every variable gathered to its global value within 1e-4 of
  the JAX one-device run's; each rank holds E/ep experts; the ep ranks
  of a data shard hold the same replicated state bit for bit; a
  ``CheckpointManager`` save holds the global layout, a restore gives the
  blocks back bit for bit.
* Refusals: experts that ep does not divide (ValueError), fuse_stack with
  MoE (ValueError, as the JAX package), an expert block with no "ep" axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as jreg

import torch_dist_ranks
from torch_dist_ranks import build_bert

SLOTS = ("X", "GateW", "W1", "B1", "W2", "B2")
# bf16: Out and dX are bf16 (one rounding of values ~1: 2^-8, twice);
# the f32 weight gradients differ by what the bf16 inputs round
_TOL = {"f32": 1e-5, "bf16_x": 1e-5, "bf16": 2e-2}
_TOL_GRAD = {"f32": 1e-5, "bf16_x": 1e-2, "bf16": 5e-2}
BERT_TOL, BF16_TOL = 1e-4, 2e-2
MOE = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, moe_num_experts=4,
           moe_capacity_factor=0.5)
BERT = (MOE, 4, 16, 3, False)
STEPS = 3


def _op_inputs(seed, b=2, s=8, h=16, e=4, f=32):
    rng = np.random.default_rng(seed)
    return {"X": rng.standard_normal((b, s, h)).astype(np.float32),
            "GateW": rng.standard_normal((h, e)).astype(np.float32),
            "W1": (0.2 * rng.standard_normal((e, h, f))).astype(np.float32),
            "B1": (0.1 * rng.standard_normal((e, f))).astype(np.float32),
            "W2": (0.2 * rng.standard_normal((e, f, h))).astype(np.float32),
            "B2": (0.1 * rng.standard_normal((e, h))).astype(np.float32)}


def _jax_op(ins, attrs, ct, ct_aux, dtypes=None):
    """The JAX package's moe_ffn on ``ins``: Out, AuxLoss and the
    gradients for the cotangents (``jax.vjp``)."""
    dtypes = dtypes or {}

    def f(*args):
        o = jreg.get("moe_ffn").emit(
            jreg.EmitContext(), {k: [v] for k, v in zip(SLOTS, args)}, attrs)
        return o["Out"][0], o["AuxLoss"][0]

    args = [jnp.asarray(ins[k]).astype(dtypes.get(k, jnp.float32))
            for k in SLOTS]
    (out, aux), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(ct).astype(out.dtype), jnp.float32(ct_aux)))
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            {k: np.asarray(g.astype(jnp.float32))
             for k, g in zip(SLOTS, grads)})


def _port_op(ins, attrs, ct, ct_aux, dtypes=None):
    import torch

    from paddle_tpu_torch.ops import registry as treg

    dtypes = dtypes or {}
    leaves = [torch.as_tensor(ins[k]).to(dtypes.get(k, torch.float32))
              .requires_grad_() for k in SLOTS]
    o = treg.get("moe_ffn").emit(treg.EmitContext(device="cpu"),
                                 {k: [v] for k, v in zip(SLOTS, leaves)},
                                 attrs)
    out, aux = o["Out"][0], o["AuxLoss"][0]
    grads = torch.autograd.grad(
        [out, aux], leaves, [torch.as_tensor(ct).to(out.dtype),
                             torch.tensor(ct_aux)])
    return (out.detach().float().numpy(), float(aux.detach()),
            {k: g.float().numpy() for k, g in zip(SLOTS, grads)}, out.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16_x", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_and_its_gradients_match_jax(top_k, dtype):
    import torch

    ins = _op_inputs(top_k)
    attrs = {"top_k": top_k, "capacity_factor": 1.0, "activation": "gelu"}
    ct = np.random.default_rng(9).standard_normal(
        ins["X"].shape).astype(np.float32)
    jd = {"f32": {}, "bf16_x": {"X": jnp.bfloat16},
          "bf16": dict.fromkeys(SLOTS, jnp.bfloat16)}[dtype]
    td = {k: torch.bfloat16 for k in jd}
    j_out, j_aux, j_g = _jax_op(ins, attrs, ct, 0.7, jd)
    t_out, t_aux, t_g, t_dtype = _port_op(ins, attrs, ct, 0.7, td)
    # the JAX promotion: bf16 tokens with f32 weights give an f32 Out
    assert t_dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    tol, gtol = _TOL[dtype], _TOL_GRAD[dtype]
    np.testing.assert_allclose(t_out, j_out, atol=tol, rtol=tol)
    np.testing.assert_allclose(t_aux, j_aux, atol=1e-6, rtol=1e-6)
    for k in SLOTS:
        np.testing.assert_allclose(t_g[k], j_g[k], atol=gtol, rtol=gtol,
                                   err_msg=k)


def test_capacity_overflow_keeps_the_first_token():
    """Every token to expert 0 at capacity 1: one token's row survives,
    the first (slot 0, token order)."""
    ins = _op_inputs(3, b=1, s=8, h=4, e=2, f=8)
    ins["GateW"] = np.zeros((4, 2), np.float32)
    ins["GateW"][:, 0] = 1.0
    ins["X"] = np.abs(ins["X"])
    attrs = {"top_k": 1, "capacity_factor": 2 / 8, "activation": "relu"}
    out, _, _, _ = _port_op(ins, attrs, np.zeros_like(ins["X"]), 0.0)
    rows = np.abs(out.reshape(8, 4)).sum(-1) > 0
    assert rows.tolist() == [True] + [False] * 7
    j_out, _, _ = _jax_op(ins, attrs, np.zeros_like(ins["X"]), 0.0)
    np.testing.assert_allclose(out, j_out, atol=1e-6, rtol=0)


def _op_payload():
    """The global inputs of the ranks' op cases: 4 rows of 4 tokens, all
    routed to expert 0 (E = 2, top-1, capacity ceil(16 / 2 * 0.75) = 6)
    at dp 4; a mixed routing at E = 4, top-2, capacity 4 at dp 2 x ep 2."""
    dp4 = _op_inputs(5, b=4, s=4, h=8, e=2, f=16)
    dp4["GateW"][:, 0] += 4.0
    dp4["X"] = np.abs(dp4["X"]) + 0.5
    mixed = _op_inputs(6, b=4, s=4, h=8, e=4, f=16)
    cot = np.random.default_rng(7).standard_normal((4, 4, 8)).astype(
        np.float32)
    return {"dp4": dp4, "dp2_ep2": mixed, "cot": cot, "cot_aux": 0.9,
            "attrs_dp4": {"top_k": 1, "capacity_factor": 0.75,
                          "activation": "relu"},
            "attrs_dp2_ep2": {"top_k": 2, "capacity_factor": 0.5,
                              "activation": "gelu"}}


def _jax_bert(amp=False, steps=STEPS):
    """The JAX package's one-device run of tiny BERT-MoE: the startup
    state, the loss trace, the scope after it, and the program."""
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *BERT)
    _, b, s, mpn, _ = BERT
    feed = jbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
    scope = jfluid.executor.Scope()
    with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup):
            opt = jfluid.optimizer.AdamOptimizer(1e-3)
            if amp:
                opt = jmp.decorate(opt, use_bf16=True)
            opt.minimize(loss)
        exe = jfluid.Executor()
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(steps)]
    return main, feed, state, losses, scope


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX one-device runs, and the port's ranks for every case."""
    main, feed, state, losses, scope = _jax_bert()
    op = _op_payload()
    common = {"model": ("bert",) + BERT, "opt": ("adam", 1e-3),
              "state": state, "feeds": [feed] * STEPS}
    started = torch_dist_ranks.Ranks(
        "fleet_runs", 4, tmp_path_factory.mktemp("moe"),
        {"moe_op": op,
         "common": common,
         "cases": [{"strategy": {"mesh_axes": {"dp": 2, "ep": 2},
                                 "expert_parallel": True},
                    "ckpt": str(tmp_path_factory.mktemp("ckpt"))},
                   {"strategy": {"mesh_axes": {"dp": 1, "ep": 4},
                                 "expert_parallel": True}}]},
        timeout=120.0)
    jax_op = {}
    for name in ("dp4", "dp2_ep2"):
        attrs = op[f"attrs_{name}"]
        jax_op[name] = {
            "out": _jax_op(op[name], attrs, op["cot"], 0.0),
            "aux": _jax_op(op[name], attrs, np.zeros_like(op["cot"]),
                           op["cot_aux"])}
    return {"ranks": started.join(), "jax_op": jax_op, "op": op,
            "bert": (main, state, losses, scope)}


def test_ranks_route_on_the_global_capacity(runs):
    """dp 4, every token to expert 0, capacity 6: the ranks' rows are
    the global op's; rank 1 keeps its first 2 tokens and ranks 2 and 3
    none, dropped because of the lower ranks' tokens."""
    ranks = [r["moe_op"]["dp4"] for r in runs["ranks"]]
    j_out, j_aux, j_g = runs["jax_op"]["dp4"]["out"]
    got = np.concatenate([r["out"]["out"] for r in ranks])
    np.testing.assert_allclose(got, j_out, atol=1e-5, rtol=1e-5)
    kept = [int((np.abs(r["out"]["out"][0]).sum(-1) > 0).sum())
            for r in ranks]
    assert kept == [4, 2, 0, 0]
    for r in ranks:
        assert r["out"]["aux"] == pytest.approx(j_aux, abs=1e-6)
    _hold_grads(ranks, runs["jax_op"]["dp4"], dp=4, ep=1)


def test_dp2_ep2_op_matches_the_global_op(runs):
    """dp 2 x ep 2, each rank 2 of the 4 experts: Out and AuxLoss the
    global op's on every rank; X and GateW gradients whole and equal on
    the two ranks of an ep pair; the expert blocks' gradients gathered
    over ep."""
    ranks = [r["moe_op"]["dp2_ep2"] for r in runs["ranks"]]
    j_out, j_aux, _ = runs["jax_op"]["dp2_ep2"]["out"]
    for pair in ((0, 1), (2, 3)):
        a, b = (ranks[i]["out"] for i in pair)
        np.testing.assert_array_equal(a["out"], b["out"])
        for k in ("X", "GateW"):
            np.testing.assert_array_equal(a["grads"][k], b["grads"][k])
    got = np.concatenate([ranks[0]["out"]["out"], ranks[2]["out"]["out"]])
    np.testing.assert_allclose(got, j_out, atol=1e-5, rtol=1e-5)
    assert ranks[0]["out"]["aux"] == pytest.approx(j_aux, abs=1e-6)
    _hold_grads(ranks, runs["jax_op"]["dp2_ep2"], dp=2, ep=2)


def _hold_grads(ranks, want, dp, ep):
    """A cotangent of Out: X's gradient rows, the weights' summed over
    the data shards (each its tokens' part); a cotangent of AuxLoss:
    the weights' averaged over the data shards (fleet's mean: the
    all-reduce of P_e's sum hands each rank dp x its tokens' part)."""
    experts = ("W1", "B1", "W2", "B2")
    for what in ("out", "aux"):
        _, _, j_g = want[what]
        by_dp = [ranks[d * ep:(d + 1) * ep] for d in range(dp)]
        dx = np.concatenate([g[0][what]["grads"]["X"] for g in by_dp])
        if what == "aux":
            dx = dx / dp
        np.testing.assert_allclose(dx, j_g["X"], atol=1e-5, rtol=1e-5,
                                   err_msg=what)
        for k in ("GateW",) + experts:
            per_shard = [np.concatenate([r[what]["grads"][k] for r in g])
                         if k in experts and ep > 1 else
                         g[0][what]["grads"][k] for g in by_dp]
            total = np.sum(per_shard, axis=0)
            if what == "aux":
                total = total / dp
            np.testing.assert_allclose(total, j_g[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{what} {k}")


def _port_bert(amp):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert

    cfg, main, startup, loss = build_bert(fluid, nn, bert, *BERT)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        if amp:
            opt = mixed_precision.decorate(opt, use_bf16=True)
        opt.minimize(loss)
    return main, loss


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_tiny_bert_moe_loss_trace_matches_jax(amp):
    from paddle_tpu_torch import fluid

    jmain, feed, state, want, _ = _jax_bert(amp)
    main, loss = _port_bert(amp)
    assert [(o.type, o.inputs, o.outputs) for o in main.global_block().ops] \
        == [(o.type, o.inputs, o.outputs) for o in jmain.global_block().ops]
    assert sum(o.type == "moe_ffn" for o in main.global_block().ops) == 2
    scope = fluid.Scope.from_numpy(state, device="cpu")
    exe = fluid.Executor(device="cpu")
    got = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].reshape(())) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, atol=BF16_TOL if amp else BERT_TOL,
                               rtol=0)
    assert got[-1] < got[0]


@pytest.mark.parametrize("case,mesh", [(0, {"dp": 2, "ep": 2}),
                                       (1, {"dp": 1, "ep": 4})],
                         ids=["dp2_ep2", "dp1_ep4"])
def test_bert_moe_over_dp_ep_matches_jax_one_device(runs, case, mesh):
    main, state, want, scope = runs["bert"]
    ep = mesh["ep"]
    ranks = [r["runs"][case] for r in runs["ranks"]]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, atol=BERT_TOL, rtol=0)
    for n in state:
        np.testing.assert_allclose(
            ranks[0]["state"][n].astype(np.float64),
            np.asarray(scope.find_var(n)).astype(np.float64),
            atol=BERT_TOL, rtol=0, err_msg=n)
    for r in ranks[1:]:
        for n, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)
    # E / ep experts a rank, and their Adam moments with them
    local = ranks[0]["local"]
    assert local["encoder_layer_0_moe_expert.w1"].shape == (4 // ep, 32, 64)
    assert local["encoder_layer_0_moe_expert.b2"].shape == (4 // ep, 32)
    w1_m1 = [n for n in local if n.startswith(
        "encoder_layer_0_moe_expert.w1_moment1")]
    assert local[w1_m1[0]].shape == (4 // ep, 32, 64)
    # the ep ranks of a data shard hold every replicated variable alike
    for i in range(0, 4, ep):
        for j in range(i + 1, i + ep):
            for n, v in ranks[i]["local"].items():
                if "_moe_expert." not in n:
                    np.testing.assert_array_equal(ranks[j]["local"][n], v,
                                                  err_msg=n)
    if "saved" in ranks[0]:
        for r in ranks:
            assert r["restored_equal"] == r["state_names"]
            for n, v in r["saved"].items():
                np.testing.assert_array_equal(v, r["state"][n], err_msg=n)
        assert ranks[0]["saved"]["encoder_layer_1_moe_expert.w2"].shape \
            == (4, 64, 32)


def test_moe_refusals():
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import Mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [2, 4, 8], "float32")
        layers.moe_ffn(x, 3, 16, top_k=1, name="moe0")
    with pytest.raises(ValueError, match="not divisible"):
        fleet.apply_expert_parallel(main, Mesh({"dp": 4, "ep": 2}))
    with pytest.raises(ValueError, match="fuse_stack"):
        build_bert(fluid, nn, bert, *BERT[:4], fuse_stack=True)
    # a block of the experts with no "ep" axis to exchange over
    import torch

    ins = {k: [torch.as_tensor(v)] for k, v in _op_inputs(1).items()}
    ins["W1"] = [ins["W1"][0][:2]]
    with pytest.raises(ValueError, match="no 'ep' axis"):
        treg.get("moe_ffn").emit(treg.EmitContext(device="cpu"), ins,
                                 {"top_k": 2})
