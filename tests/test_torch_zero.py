"""ZeRO-2 optimizer-state sharding in the port (fleet's
``strategy.sharding``: ``_shard_optimizer_states`` and the update ops'
``zero_axis``) against the port's unsharded data parallelism and the JAX
package's GSPMD run, on the CPU.

The JAX side runs in this process on 4 of the 8 virtual CPU devices;
the port's side is one set of 4 gloo ranks at {"dp": 4}
(``torch_dist_ranks.body_fleet_runs``), started once for the module,
fed the JAX package's global startup scope.

* Tiny BERT (the fused stack, 4 layers so that dp 4 divides the stacked
  dims), Adam, 3 steps, f32 and bf16 AMP: with sharding on, every
  parameter after the steps equals the unsharded dp 4 run's bit for bit
  (the update is elementwise: the same floats, computed on a rank's rows
  and all-gathered), the losses too, and every moment gathered to the
  global layout equals the unsharded run's bit for bit; against the JAX
  package's dp 4 run with ``strategy.sharding``, the losses and every
  variable within 1e-4.
* Each rank holds [d0/4, ...] of each moment whose dim 0 dp divides and
  the whole of the others (Adam's [1] beta powers, the [2, ...] ones);
  the update ops of the sharded moments carry ``zero_axis``.
* A ``CheckpointManager`` save of the sharded run holds the moments in
  the global layout, the bytes of the unsharded run's; a restore slices
  each rank's rows back, bit for bit.
* LAMB (``strategy.lamb``, the same ranks and batch): its trust ratio
  takes norms of the whole parameter and update, which each rank holds
  a block of rows of; the lamb op sums the rows' squares over "dp", so
  the sharded run matches the unsharded one within 1e-5 (the squares
  summed in another order) and the JAX package's sharded run within
  1e-4, and every sharded lamb op carries ``zero_axis``.
"""
from __future__ import annotations

import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert

import torch_dist_ranks
from torch_dist_ranks import build_bert

BERT_TOL = 1e-4
KW = dict(vocab_size=128, hidden_size=32, num_hidden_layers=4,
          num_attention_heads=4, intermediate_size=64,
          max_position_embeddings=64)
BERT = (KW, 4, 16, 3, True)
STEPS = 3


def _jax_run(sharding, amp=False, lamb=False):
    """The JAX package's dp 4 run of tiny BERT: its startup state, loss
    trace and the scope after it."""
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *BERT)
    _, b, s, mpn, _ = BERT
    feed = jbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
    scope = jfluid.executor.Scope()
    with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup):
            strategy = jfleet.DistributedStrategy()
            strategy.mesh_axes = {"dp": 4}
            strategy.sharding = sharding
            strategy.amp = amp
            strategy.lamb = lamb
            jfleet.init()
            jfleet.distributed_optimizer(jfluid.optimizer.AdamOptimizer(1e-3),
                                         strategy).minimize(loss)
        exe = jfluid.Executor()
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(STEPS)]
        final = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
    return feed, state, losses, final


CASES = {"zero": (True, False, False), "dp": (False, False, False),
         "zero_bf16": (True, True, False), "dp_bf16": (False, True, False),
         "zero_lamb": (True, False, True), "dp_lamb": (False, False, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    feed, state, f32_losses, f32_final = _jax_run(True)
    _, bf16_state, bf16_losses, _ = _jax_run(True, amp=True)
    _, lamb_state, lamb_losses, lamb_final = _jax_run(True, lamb=True)
    cases = []
    for name, (sharding, amp, lamb) in CASES.items():
        case = {"strategy": {"mesh_axes": {"dp": 4}, "sharding": sharding,
                             "amp": amp, "lamb": lamb},
                "state": (bf16_state if amp else lamb_state if lamb
                          else state)}
        if name == "zero":
            case["ckpt"] = str(tmp_path_factory.mktemp("ckpt"))
        cases.append(case)
    ranks = torch_dist_ranks.spawn(
        "fleet_runs", 4, tmp_path_factory.mktemp("zero"),
        {"common": {"model": ("bert",) + BERT, "opt": ("adam", 1e-3),
                    "feeds": [feed] * STEPS},
         "cases": cases}, timeout=120.0)
    return {"ranks": [dict(zip(CASES, r["runs"])) for r in ranks],
            "jax": {"f32": (f32_losses, f32_final), "bf16": bf16_losses,
                    "lamb": (lamb_losses, lamb_final)},
            "state": state, "lamb_state": lamb_state}


def _moments(state):
    return sorted(n for n in state if "_moment" in n)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_zero_parameters_bit_for_bit_with_unsharded_dp(runs, amp):
    zero, dp = ("zero_bf16", "dp_bf16") if amp else ("zero", "dp")
    for r in runs["ranks"]:
        assert r[zero]["losses"] == r[dp]["losses"]
        assert sorted(r[zero]["state"]) == sorted(r[dp]["state"])
        for n, v in r[dp]["state"].items():
            np.testing.assert_array_equal(r[zero]["state"][n], v, err_msg=n)
    # and every rank gathers the same global state
    for r in runs["ranks"][1:]:
        for n, v in runs["ranks"][0][zero]["state"].items():
            np.testing.assert_array_equal(r[zero]["state"][n], v, err_msg=n)


def test_zero_matches_the_jax_package_and_holds_row_blocks(runs):
    want_losses, want = runs["jax"]["f32"]
    ranks = [r["zero"] for r in runs["ranks"]]
    np.testing.assert_allclose(ranks[0]["losses"], want_losses,
                               atol=BERT_TOL, rtol=0)
    np.testing.assert_allclose(runs["ranks"][0]["zero_bf16"]["losses"],
                               runs["jax"]["bf16"], atol=2e-2, rtol=0)
    for n, v in want.items():
        np.testing.assert_allclose(
            ranks[0]["state"][n].astype(np.float64), v.astype(np.float64),
            atol=BERT_TOL, rtol=0, err_msg=n)
    moments = _moments(runs["state"])
    assert moments
    sharded = 0
    for n in moments:
        whole = runs["state"][n].shape
        for i, r in enumerate(ranks):
            got = r["local"][n]
            if whole[0] % 4 == 0:
                assert got.shape == (whole[0] // 4,) + whole[1:], n
                rows = slice(i * whole[0] // 4, (i + 1) * whole[0] // 4)
                np.testing.assert_array_equal(got, r["state"][n][rows])
            else:
                assert got.shape == whole, n
        sharded += whole[0] % 4 == 0
    # the stacked layer moments (dim 0 = 4 layers), the embeddings', ...
    assert sharded >= len(moments) // 2
    for n in runs["state"]:
        if "beta1_pow" in n:
            assert ranks[0]["local"][n].shape == (1,)
    zero_ops = [o for o in ranks[0]["ops"] if o[0] == "adam"
                and o[3].get("zero_axis") == "dp"]
    assert len(zero_ops) == sum(1 for n in moments if "moment1" in n
                                and runs["state"][n].shape[0] % 4 == 0)


def test_zero_checkpoint_holds_the_global_layout(runs):
    for r in runs["ranks"]:
        z = r["zero"]
        assert z["restored_equal"] == z["state_names"]
        for n in _moments(runs["state"]):
            assert z["saved"][n].shape == runs["state"][n].shape
            # the bytes of the unsharded run's moments
            np.testing.assert_array_equal(z["saved"][n], r["dp"]["state"][n],
                                          err_msg=n)


def test_zero_lamb_takes_the_whole_parameters_norms(runs):
    """LAMB under ZeRO: the trust ratio's norms are the whole
    parameter's, summed over "dp" from each rank's rows, so the sharded
    run stays within 1e-5 of the unsharded one (a norm taken over a
    block would move the update by the block's share of the norm), and
    within 1e-4 of the JAX package's sharded run."""
    want_losses, want = runs["jax"]["lamb"]
    for r in runs["ranks"]:
        z, d = r["zero_lamb"], r["dp_lamb"]
        np.testing.assert_allclose(z["losses"], d["losses"], atol=1e-5,
                                   rtol=0)
        assert sorted(z["state"]) == sorted(d["state"])
        for n, v in d["state"].items():
            np.testing.assert_allclose(z["state"][n], v, atol=1e-5, rtol=0,
                                       err_msg=n)
    z = runs["ranks"][0]["zero_lamb"]
    np.testing.assert_allclose(z["losses"], want_losses, atol=BERT_TOL,
                               rtol=0)
    for n, v in want.items():
        np.testing.assert_allclose(z["state"][n].astype(np.float64),
                                   v.astype(np.float64), atol=BERT_TOL,
                                   rtol=0, err_msg=n)
    moments = [n for n in _moments(runs["lamb_state"]) if "moment1" in n]
    lamb_ops = [o for o in z["ops"] if o[0] == "lamb"]
    assert len(lamb_ops) == len(moments)
    assert sum(o[3].get("zero_axis") == "dp" for o in lamb_ops) == sum(
        runs["lamb_state"][n].shape[0] % 4 == 0 for n in moments) > 0
    # the run moved: the update is not a no-op that would hide a norm
    assert not np.allclose(z["losses"][0], z["losses"][-1])
