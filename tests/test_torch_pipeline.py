"""Pipeline parallelism in the port (GPipe over "pp" in
``fused_encoder_stack``, pp x sp, ``PipelineOptimizer``, ``device_guard``,
fleet's pipeline wiring) against the JAX package, on the CPU.

The JAX side runs in this process; the port's side is one set of 4 gloo
ranks (``torch_dist_ranks.body_pipeline``), started once for the module.

* ``_gpipe_stack`` (the op under a mesh with ``pipeline``) at pp 4
  and at dp 2 x pp 2, with a per-key bias and without, 2 and 4
  microbatches: Out, the gradient of Hidden and the gradients of all 12
  stacked parameters (each rank's block gathered over pp) within 2e-5
  (+ 2e-5 relative) of ``jax.vjp`` of the JAX package's sequential
  ``lax.scan`` stack, no mesh: the pipeline's gradients are the
  sequential stack's, with no factor of pp.  The JAX package's own test
  checks only that they are nonzero.
* pp 2 x sp 2 (the ring inside each stage) and ``remat_policy`` under
  the pipeline against the same sequential stack.
* Tiny BERT (fuse_stack) at {"dp": 2, "pp": 2} and {"pp": 2, "sp": 2}
  with accumulate_steps 2: 3 Adam steps, losses and every variable
  (gathered over pp) within 1e-4 of the JAX package's dp 1 run; under
  bf16 AMP at {"dp": 2, "pp": 2} the losses within 2e-2 of the JAX
  package's bf16 run.
* ``device_guard`` and ``PipelineOptimizer`` as the JAX package's
  tests/test_pipeline.py:136 holds them, and the refusal without the
  fallback flag.
* The reference's errors: layers that pp does not divide, and a batch
  that dp x M does not divide.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as jreg
from paddle_tpu.parallel import create_mesh

import torch_dist_ranks
from torch_dist_ranks import build_bert

KEYS = ("QKVW", "QKVB", "OutW", "OutB", "Ln1S", "Ln1B", "FfnW1", "FfnB1",
        "FfnW2", "FfnB2", "Ln2S", "Ln2B")
ATOL = RTOL = 2e-5
BERT_TOL = 1e-4
L, B, S, H, F, NH = 4, 4, 8, 16, 32, 4
BASE = {"num_heads": NH, "is_test": True, "use_flash_attention": False}
GPIPE = {  # mesh, microbatches, bias, extra attrs
    "pp4_bias": ({"pp": 4}, 2, True, {}),
    "pp4_nobias": ({"pp": 4}, 4, False, {}),
    "pp2_bias": ({"dp": 2, "pp": 2}, 2, True, {}),
    "pp2_nobias": ({"dp": 2, "pp": 2}, 4, False, {}),
    "pp2_sp2": ({"pp": 2, "sp": 2}, 2, True, {"sequence_parallel": True}),
    "pp4_remat_policy": ({"pp": 4}, 2, True,
                         {"remat_policy": "flash", "remat_layer": True}),
}
BERT = (dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64), 4, 16, 3)
BERT_MESHES = {"dp2_pp2": {"dp": 2, "pp": 2}, "pp2_sp2": {"pp": 2, "sp": 2},
               "dp2_pp2_bf16": {"dp": 2, "pp": 2}}
BF16_TOL = 2e-2   # test_torch_bert_train's: bf16 rounds at other places
STEPS = 3


def _stack_inputs(seed, bias):
    rng = np.random.RandomState(seed)

    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    ins = {"QKVW": r(L, H, 3 * H), "QKVB": r(L, 3 * H), "OutW": r(L, H, H),
           "OutB": r(L, H), "Ln1S": np.ones((L, H), np.float32) + r(L, H),
           "Ln1B": r(L, H), "FfnW1": r(L, H, F), "FfnB1": r(L, F),
           "FfnW2": r(L, F, H), "FfnB2": r(L, H),
           "Ln2S": np.ones((L, H), np.float32) + r(L, H), "Ln2B": r(L, H),
           "Hidden": rng.randn(B, S, H).astype(np.float32)}
    if bias:
        m = np.zeros((B, 1, 1, S), np.float32)
        m[1, ..., -3:] = -1e4
        ins["AttnBias"] = m
    return ins, rng.randn(B, S, H).astype(np.float32)


def _jax_sequential(ins, cot):
    """Out and the gradients of Hidden and the 12 stacked parameters of
    the JAX package's sequential stack (no mesh)."""
    wrt = {k: jnp.asarray(v) for k, v in ins.items() if k != "AttnBias"}
    bias = ins.get("AttnBias")

    def f(p):
        i = {k: [v] for k, v in p.items()}
        if bias is not None:
            i["AttnBias"] = [jnp.asarray(bias)]
        ctx = jreg.EmitContext(rng_key=jax.random.PRNGKey(0))
        return jreg.get("fused_encoder_stack").emit(ctx, i, dict(BASE))[
            "Out"][0]

    out, vjp = jax.vjp(f, wrt)
    (g,) = vjp(jnp.asarray(cot))
    return np.asarray(out), {k: np.asarray(v) for k, v in g.items()}


def _jax_bert(amp=False):
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *BERT)
    _, b, s, mpn = BERT
    feed = jbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
    scope = jfluid.executor.Scope()
    with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup):
            strategy = jfleet.DistributedStrategy()
            strategy.mesh_axes = {"dp": 1}
            jfleet.init()
            opt = jfluid.optimizer.AdamOptimizer(1e-3)
            if amp:
                from paddle_tpu.contrib import mixed_precision

                opt = mixed_precision.decorate(opt, use_bf16=True)
            jfleet.distributed_optimizer(opt, strategy).minimize(loss)
        exe = jfluid.Executor()
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(STEPS)]
    return feed, state, losses, scope


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, want = [], {}
    for i, (name, (mesh, m, bias, extra)) in enumerate(sorted(GPIPE.items())):
        ins, cot = _stack_inputs(i, bias)
        cases.append({"mesh": mesh, "ins": ins, "cot": cot,
                      "attrs": dict(BASE, pipeline=True, num_microbatches=m,
                                    **extra)})
        want[name] = (ins, cot)
    feed, state, losses, scope = _jax_bert()
    _, bf16_state, bf16_losses, _ = _jax_bert(amp=True)
    bert_cases = [{"mesh_axes": mesh, "amp": True, "state": bf16_state}
                  if name.endswith("bf16") else {"mesh_axes": mesh}
                  for name, mesh in sorted(BERT_MESHES.items())]
    started = torch_dist_ranks.Ranks(
        "pipeline", 4, tmp_path_factory.mktemp("pipeline"),
        {"gpipe": {"cases": cases},
         "bert": {"cases": bert_cases, "bert": BERT, "fuse_stack": True,
                  "pipeline": True, "accumulate_steps": 2, "state": state,
                  "feed": feed, "steps": STEPS}}, timeout=90.0)
    want = {k: _jax_sequential(*v) for k, v in want.items()}
    ranks = started.join()
    return {"gpipe": {name: [r["gpipe"][i] for r in ranks]
                      for i, name in enumerate(sorted(GPIPE))},
            "want": want,
            "bert": {name: [r["bert"][i] for r in ranks]
                     for i, name in enumerate(sorted(BERT_MESHES))},
            "bert_want": (state, losses, scope), "bf16_want": bf16_losses}


@pytest.mark.parametrize("case", sorted(GPIPE))
def test_gpipe_matches_the_jax_sequential_stack(runs, case):
    out_j, g_j = runs["want"][case]
    mesh = GPIPE[case][0]
    ranks = runs["gpipe"][case]
    for r in ranks:
        assert r["layers"] == L // mesh["pp"] and r["schedules"] == 1
        np.testing.assert_allclose(r["out"], out_j, atol=ATOL, rtol=0)
        np.testing.assert_allclose(r["dhidden"], g_j["Hidden"], atol=ATOL,
                                   rtol=RTOL)
        for k in KEYS:
            np.testing.assert_allclose(r["grads"][k], g_j[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
    for r in ranks[1:]:   # every stage ends with the same Out and grads
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
        np.testing.assert_array_equal(r["dhidden"], ranks[0]["dhidden"])


@pytest.mark.parametrize("mesh", sorted(BERT_MESHES))
def test_tiny_bert_pipeline_matches_jax_dp1(runs, mesh):
    """f32: losses and every variable within 1e-4; bf16 AMP (the casts
    in front of the stack: each stage must still hold only its layers):
    losses within 2e-2.  Every rank gathers the same state bit for bit."""
    state, want, scope = runs["bert_want"]
    ranks = runs["bert"][mesh]
    got = [float(np.asarray(v).reshape(())) for v in ranks[0]["losses"]]
    bf16 = mesh.endswith("bf16")
    np.testing.assert_allclose(got, runs["bf16_want"] if bf16 else want,
                               atol=BF16_TOL if bf16 else BERT_TOL, rtol=0)
    assert got[-1] < got[0]
    for n in [] if bf16 else state:
        np.testing.assert_allclose(
            ranks[0]["state"][n].astype(np.float64),
            np.asarray(scope.find_var(n)).astype(np.float64),
            atol=BERT_TOL, rtol=0, err_msg=n)
    for r in ranks[1:]:
        for n, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)
    # each stage holds one of the two layers
    assert ranks[0]["local"]["encoder_stack.qkv_w"].shape[0] == 1
    stacks = [o for o in ranks[0]["ops"] if o[0] == "fused_encoder_stack"]
    assert len(stacks) == 1


def test_device_guard_and_pipeline_optimizer():
    """device_guard tags ops (attr op_device); PipelineOptimizer collects
    the stages and, with FLAGS_pipeline_single_program_fallback, warns
    and trains the program in one piece: the loss trace of the JAX
    package's with the same weights.  Without the flag a multi-stage
    program raises."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import flags as fl
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.fluid.optimizer import (PipelineOptimizer,
                                                  SGDOptimizer)

    def build(fluid, layers, PipelineOptimizer, SGDOptimizer, fl):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = layers.data("x", shape=[8])
            y = layers.data("y", shape=[1])
            with fluid.framework.device_guard("gpu:0"):
                h = layers.fc(x, size=16, act="relu")
            with fluid.framework.device_guard("gpu:1"):
                pred = layers.fc(h, size=1)
            loss = layers.mean(layers.square_error_cost(pred, y))
            opt = PipelineOptimizer(SGDOptimizer(0.05), num_microbatches=2)
            fl.set_flags({"FLAGS_pipeline_single_program_fallback": True})
            try:
                with pytest.warns(UserWarning, match="co-scheduled"):
                    opt.minimize(loss)
            finally:
                fl.set_flags(
                    {"FLAGS_pipeline_single_program_fallback": False})
        return main, startup, loss, opt

    from paddle_tpu.fluid import flags as jfl
    from paddle_tpu.fluid import layers as jlayers
    from paddle_tpu.fluid.optimizer import PipelineOptimizer as JPipe
    from paddle_tpu.fluid.optimizer import SGDOptimizer as JSGD

    main, startup, loss, opt = build(fluid, layers, PipelineOptimizer,
                                     SGDOptimizer, fl)
    jmain, jstartup, jloss, _ = build(jfluid, jlayers, JPipe, JSGD, jfl)
    devices = {op.attr("op_device") for op in main.global_block().ops}
    assert {"gpu:0", "gpu:1"} <= devices
    assert set(opt._stage_ops) >= {"gpu:0", "gpu:1"}
    assert [(op.type, op.attr("op_device")) for op in
            main.global_block().ops] == [
        (op.type, op.attr("op_device")) for op in jmain.global_block().ops]

    jscope = jfluid.executor.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstartup, scope=jscope)
    scope = fluid.Scope.from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items()}, device="cpu")
    exe = fluid.Executor(device="cpu")
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    got = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0].reshape(-1)[0]) for _ in range(10)]
    want = [float(np.asarray(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                      scope=jscope)[0]).reshape(-1)[0])
            for _ in range(10)]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[8])
        with fluid.framework.device_guard("gpu:0"):
            h = layers.fc(x, size=4)
        with fluid.framework.device_guard("gpu:1"):
            loss = layers.mean(layers.fc(h, size=1))
        with pytest.raises(RuntimeError, match="device_guard stages"):
            PipelineOptimizer(SGDOptimizer(0.1)).minimize(loss)


def test_pipeline_errors_are_the_references():
    """Layers that pp does not divide raise at minimize (the stacked
    parameters cannot be split into stages), and a batch that dp x M
    does not divide raises in the op; both with the JAX package's
    message."""
    import torch

    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import Mesh

    kw = dict(BERT[0], num_hidden_layers=3)
    _, main, startup, loss = build_bert(fluid, nn, bert, kw, *BERT[1:])
    with fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh = Mesh({"dp": 1, "pp": 2})   # no process group
        strategy.pipeline = True
        with pytest.raises(ValueError,
                           match=r"num layers 3 must divide by pp=2"):
            fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                        strategy).minimize(loss)

    ins, _ = _stack_inputs(0, False)
    ins["Hidden"] = ins["Hidden"][:3]
    attrs = dict(BASE, pipeline=True, num_microbatches=2)
    jmesh = create_mesh({"dp": 1, "pp": 4})
    with pytest.raises(ValueError) as jerr:
        jreg.get("fused_encoder_stack").emit(
            jreg.EmitContext(rng_key=jax.random.PRNGKey(0), mesh=jmesh),
            {k: [jnp.asarray(v)] for k, v in ins.items()}, dict(attrs))
    mesh = Mesh({"dp": 1, "pp": 4})
    local = {k: [torch.as_tensor(v if k == "Hidden" else v[:1])]
             for k, v in ins.items()}
    with pytest.raises(ValueError) as err:
        treg.get("fused_encoder_stack").emit(
            treg.EmitContext(device="cpu", mesh=mesh), local, dict(attrs))
    assert str(err.value) == str(jerr.value)
    assert "num_microbatches=2" in str(err.value)
