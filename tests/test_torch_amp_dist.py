"""float16 AMP across ranks: found_inf agreed by every rank, on the CPU.

Tiny BERT (the fused stack, 4 layers) under float16 AMP with dynamic loss
scaling, Adam, from the JAX package's startup state, on one set of 2 gloo
ranks (``torch_dist_ranks.body_amp_f16``) started once for the module:

* ZeRO-2 at dp 2 (``strategy.sharding``), GPipe at pp 2
  (``strategy.pipeline``) and Megatron tp at tp 2 (the unfused encoder,
  ``bert.tensor_parallel_rules``).  A fault injection makes rank 1's own
  block of one FFN weight's gradient non-finite at steps 2 and 3 (the
  gradient times inf, right after the op that writes it): layer 3's of
  the stacked output weight (ZeRO-2, pp), its columns of layer 3's
  column-parallel input weight (tp).  Under ZeRO-2 the dp all-reduce of
  the gradients carries it to rank 0; under pp and tp rank 0 never sees
  it: its found_inf from its own gradients stays false, and the
  reduction fleet adds over every mesh axis (``c_allreduce_max``) makes
  it true.  (ep is not among the cases: its experts take a MoE model of
  their own.)  On every rank each such
  step is skipped (no update output moves) and the scale and both
  counters follow the same trajectory.
* The same run in one process (the decorator alone, the injection on
  the whole gradient at the same steps) skips the same steps with the
  same scale, and the losses of both ranks agree with it within 1e-4
  (``test_torch_zero.py``'s limit against the JAX package; pp sums its
  microbatches in another order, and f16 rounds the products).
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

import torch_dist_ranks
from torch_dist_ranks import amp_f16_run, build_bert

KW = dict(vocab_size=128, hidden_size=32, num_hidden_layers=4,
          num_attention_heads=4, intermediate_size=64,
          max_position_embeddings=64)
# the fused stack, and the unfused encoder (for tp)
MODELS = {"fused": (KW, 4, 16, 3, True), "layers": (KW, 4, 16, 3, False)}
STEPS = 5
INJECT = (2, 3)        # the steps (0-based) of rank 1's non-finite block
LOSS_TOL = 1e-4
AMP = dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=2,
           decr_every_n_nan_or_inf=1, decr_ratio=0.5)
# (strategy fields, model, the gradient rank 1 poisons)
CASES = {
    "zero_dp2": ({"mesh_axes": {"dp": 2}, "sharding": True}, "fused",
                 "encoder_stack.ffn_w2@GRAD"),
    "pp2": ({"mesh_axes": {"pp": 2}, "pipeline": True,
             "pipeline_configs": {"accumulate_steps": 2}}, "fused",
            "encoder_stack.ffn_w2@GRAD"),
    "tp2": ({"mesh_axes": {"tp": 2},
             "tensor_parallel_rules": tbert.tensor_parallel_rules()},
            "layers", "encoder_layer_3_ffn_fc_0.w_0@GRAD"),
}


def _payload(bert):
    """The JAX package's startup state of the program under float16 AMP
    (parameters, Adam's moments and beta powers, the scale and its
    counters), the feeds, the AMP settings."""
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *bert)
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        jmp.decorate(jfluid.optimizer.AdamOptimizer(1e-3), use_bf16=False,
                     **AMP).minimize(loss)
    scope = jfluid.executor.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor().run(startup)
    state = {n: np.asarray(v) for n, v in scope.vars.items()
             if v is not None}
    _, b, s, mpn, _ = bert
    feeds = [jbert.random_pretrain_batch(cfg, b, s, mpn, seed=10 + i)
             for i in range(STEPS)]
    return {"bert": bert, "state": state, "feeds": feeds, "amp": AMP}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process runs by case, each case's two ranks' runs)."""
    models = {k: _payload(bert) for k, bert in MODELS.items()}
    cases = [dict(models[CASES[n][1]], strategy=CASES[n][0],
                  inject_grad=CASES[n][2], inject={1: INJECT})
             for n in sorted(CASES)]
    started = torch_dist_ranks.Ranks(
        "amp_f16", 2, tmp_path_factory.mktemp("amp_f16"),
        {"common": {}, "cases": cases}, timeout=120.0)
    refs = {}
    for model, grad in sorted({(c[1], c[2]) for c in CASES.values()}):
        refs[model, grad] = amp_f16_run(dict(
            models[model], strategy=None, inject_grad=grad,
            inject={0: INJECT}))
    ranks = started.join()
    return ({n: refs[CASES[n][1], CASES[n][2]] for n in CASES},
            {n: [r[i] for r in ranks] for i, n in enumerate(sorted(CASES))})


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_process_run_skips_the_injected_steps(runs, case):
    st = runs[0][case]["steps"]
    assert [s["found_inf"] for s in st] == [i in INJECT
                                           for i in range(STEPS)]
    assert [s["moved"] for s in st] == [i not in INJECT
                                       for i in range(STEPS)]
    assert [s["scale"] for s in st] == [2.0 ** 15, 2.0 ** 16, 2.0 ** 15,
                                        2.0 ** 14, 2.0 ** 14]
    assert runs[0][case]["reductions"] == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_skips_the_same_steps_with_the_same_scale(runs, case):
    ref, got = runs[0][case], runs[1]
    r0, r1 = (r["steps"] for r in got[case])
    for i in range(STEPS):
        bad = i in INJECT
        assert r1[i]["found_inf_local"] == bad, (i, r1[i])
        # rank 0's own gradients: whole under ZeRO-2 (the dp sum carries
        # rank 1's inf), its stage's (pp) or its columns' (tp) block,
        # which stays finite
        assert r0[i]["found_inf_local"] == (bad and case == "zero_dp2")
        for r in (r0, r1):
            assert r[i]["found_inf"] == bad and r[i]["moved"] != bad
            assert (r[i]["scale"], r[i]["good"], r[i]["bad"]) == (
                ref["steps"][i]["scale"], ref["steps"][i]["good"],
                ref["steps"][i]["bad"])
    # one max over each mesh axis, on every rank
    assert got[case][0]["reductions"] == got[case][1]["reductions"] == [
        ("c_allreduce_max", 0)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_follow_the_one_process_run(runs, case):
    ref, got = runs[0][case], runs[1]
    want = [s["loss"] for s in ref["steps"]]
    for r in got[case]:
        np.testing.assert_allclose([s["loss"] for s in r["steps"]], want,
                                   atol=LOSS_TOL, rtol=0)
