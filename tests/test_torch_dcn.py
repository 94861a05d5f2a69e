"""The multi-slice (dcn) modes in the port (fleet's ``hybrid_dcn``: the
executor's manual (dcn, dp) path, ``c_dcn_grad_sync`` dense and DGC,
LocalSGD's ``dcn_expand_param`` and ``c_dcn_localsgd_sync``, the bf16
wire under AMP) against the JAX package's own mesh runs, on the CPU.

The JAX side runs in this process at {"dcn": 2, "dp": 2} on 4 of the 8
virtual CPU devices, the programs of its tests/test_dcn.py; the port's
side is one set of 4 gloo ranks at the same mesh
(``torch_dist_ranks.body_fleet_runs``), started once for the module and
fed the JAX package's global startup scope.

* Dense two-level sync: the loss trace and the parameters within 2e-5 of
  the JAX package's dcn run and of the port's flat dp 4 run.
* DGC at sparsity 0 equals the dense sync bit for bit; at 0.9 (with and
  without AMP), with rampup 3 and rampup 1, the loss trace and the
  parameters within 2e-5 (AMP 5e-3) of the JAX package's, the error
  feedback fetched and saved in the [n_dcn, *shape] layout of its scope
  within 2e-5 of its (its manual path's own fetch hands back the first
  slice's [1, *shape], which the port's first slice matches).  The top-k keeps the lower index where magnitudes tie across
  k, as ``lax.top_k``.
* LocalSGD k 1 and k 2 (SGD) and k 3 (Momentum): loss traces and the
  per-slice parameters, fetched as [n_dcn, *shape], within 2e-5 of the
  JAX package's; a checkpoint holds that layout and restores each
  slice's block bit for bit.
* Under AMP the sync ops carry a bfloat16 wire (the JAX package's
  default), the loss trace within 5e-3 of its; with
  ``bf16_grad_sync`` off too.
* The refusals the JAX package's tests pin: dgc or localsgd without
  hybrid_dcn, hybrid_dcn with pipeline, sharding, tp or sp, a mesh whose
  dcn axis does not match.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers

import torch_dist_ranks
from torch_dist_ranks import linear_model, make_optimizer, set_strategy
from torch_dist_ranks import two_fc_model

TOL, AMP_TOL = 2e-5, 5e-3
MESH = {"dcn": 2, "dp": 2}
DCN = {"hybrid_dcn": 2, "mesh_axes": MESH}


def _feed(step):
    rng = np.random.RandomState(step)
    return {"x": rng.randn(16, 8).astype("f4"),
            "y": rng.randn(16, 1).astype("f4")}


# name: (model, optimizer, strategy fields, steps, feed of step i,
# fetched variables, checkpoint)
CASES = {
    "dense": ("two_fc", ("sgd", 0.1), DCN, 6, None, (), False),
    "flat": ("two_fc", ("sgd", 0.1), {"mesh_axes": {"dp": 4}}, 6, None, (),
             False),
    "dgc_full": ("two_fc", ("sgd", 0.1),
                 dict(DCN, dgc=True, dgc_configs={"sparsity": 0.0}), 6,
                 None, (), False),
    "dgc": ("two_fc", ("sgd", 0.1),
            dict(DCN, dgc=True, dgc_configs={"sparsity": 0.9}), 8, None,
            ("fc_0.w_0@DGCErrorFeedback",), True),
    "dgc_ramp3": ("two_fc", ("sgd", 0.1),
                  dict(DCN, dgc=True, dgc_configs={"sparsity": 0.9,
                                                   "rampup_begin_step": 3}),
                  6, None, (), False),
    "dgc_ramp1": ("two_fc", ("sgd", 0.1),
                  dict(DCN, dgc=True, dgc_configs={"sparsity": 0.9,
                                                   "rampup_begin_step": 1}),
                  4, None, ("fc_1.w_0@DGCErrorFeedback",), False),
    "dgc_amp": ("two_fc", ("sgd", 0.1),
                dict(DCN, dgc=True, dgc_configs={"sparsity": 0.9}, amp=True),
                8, None, (), False),
    "lsgd_k1": ("linear", ("sgd", 0.1),
                dict(DCN, localsgd=True, localsgd_configs={"k_steps": 1}), 6,
                None, (), False),
    "lsgd_dense": ("linear", ("sgd", 0.1), DCN, 6, None, (), False),
    "lsgd_k2": ("linear", ("sgd", 0.1),
                dict(DCN, localsgd=True, localsgd_configs={"k_steps": 2}), 5,
                None, ("lsgd_w",), True),
    "lsgd_momentum": ("linear", ("momentum", 0.05, 0.9),
                      dict(DCN, localsgd=True,
                           localsgd_configs={"k_steps": 3}), 8, 3,
                      ("lsgd_w",), False),
    "amp_wire": ("two_fc", ("sgd", 0.1), dict(DCN, amp=True), 8, None, (),
                 False),
    "amp_f32_wire": ("two_fc", ("sgd", 0.1),
                     dict(DCN, amp=True,
                          amp_configs={"bf16_grad_sync": False}), 6, None,
                     (), False),
}


def _feeds(steps, period):
    return [_feed(i % period if period else i) for i in range(steps)]


def _jax_train(model, opt, fields, steps, period, fetch):
    """The JAX package's mesh run of a case: the startup state, the loss
    trace, the fetched variables at the last step, the final scope."""
    build = two_fc_model if model == "two_fc" else linear_model
    main, startup, loss = build(jfluid, jlayers, 7 if model == "two_fc"
                                else 0)
    scope = jfluid.executor.Scope()
    with jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup):
            strategy = set_strategy(jfleet.DistributedStrategy(), fields)
            jfleet.init()
            jfleet.distributed_optimizer(make_optimizer(jfluid, opt),
                                         strategy).minimize(loss)
        exe = jfluid.Executor()
        exe.run(startup)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        losses, fetched = [], {}
        feeds = _feeds(steps, period)
        for i, f in enumerate(feeds):
            last = i == steps - 1
            out = exe.run(main, feed=f, fetch_list=[loss] + (
                list(fetch) if last else []))
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if last:
                fetched = dict(zip(fetch, (np.asarray(v) for v in out[1:])))
        final = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
    return {"state": state, "losses": losses, "fetched": fetched,
            "final": final, "program": main}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jax.device_count() >= 4
    jax_runs, cases = {}, []
    for name, (model, opt, fields, steps, period, fetch, ckpt) in \
            CASES.items():
        jax_runs[name] = _jax_train(model, opt, fields, steps, period, fetch)
        case = {"model": model, "opt": opt, "strategy": fields,
                "state": jax_runs[name]["state"],
                "feeds": _feeds(steps, period), "fetch": fetch}
        if ckpt:
            case["ckpt"] = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
        cases.append(case)
    ranks = torch_dist_ranks.spawn(
        "fleet_runs", 4, tmp_path_factory.mktemp("dcn"),
        {"common": {}, "cases": cases}, timeout=120.0)
    return {"ranks": [dict(zip(CASES, r["runs"])) for r in ranks],
            "jax": jax_runs}


def _hold(runs, name, tol):
    want = runs["jax"][name]
    for r in runs["ranks"]:
        got = r[name]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=tol,
                                   rtol=tol, err_msg=name)
        for n, v in want["final"].items():
            np.testing.assert_allclose(
                got["state"][n].astype(np.float64), v.astype(np.float64),
                atol=tol, rtol=tol, err_msg=f"{name} {n}")
        for n, v in want["fetched"].items():
            # the port's fetch is the global [n_dcn, *shape]; the JAX
            # package's manual path hands back the first slice's block
            assert got["fetched"][n].shape == want["final"][n].shape
            np.testing.assert_allclose(got["fetched"][n], want["final"][n],
                                       atol=tol, rtol=tol,
                                       err_msg=f"{name} {n}")
            assert v.shape == (1,) + want["final"][n].shape[1:]
            np.testing.assert_allclose(got["fetched"][n][:1], v, atol=tol,
                                       rtol=tol, err_msg=f"{name} {n}")
    # every rank gathers the same global state
    for r in runs["ranks"][1:]:
        for n, v in runs["ranks"][0][name]["state"].items():
            np.testing.assert_array_equal(r[name]["state"][n], v,
                                          err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", ["dense", "dgc", "dgc_ramp3", "dgc_ramp1",
                                  "lsgd_k1", "lsgd_k2", "lsgd_momentum"])
def test_matches_the_jax_package_mesh_run(runs, name):
    _hold(runs, name, TOL)


@pytest.mark.parametrize("name", ["dgc_amp", "amp_wire", "amp_f32_wire"])
def test_amp_matches_the_jax_package_mesh_run(runs, name):
    want = runs["jax"][name]
    got = runs["ranks"][0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=AMP_TOL,
                               rtol=0)
    assert np.isfinite(got["losses"]).all()
    for r in runs["ranks"][1:]:
        assert r[name]["losses"] == got["losses"]
    syncs = [o for o in got["ops"] if o[0] == "c_dcn_grad_sync"]
    assert len(syncs) == 4
    wire = "" if name == "amp_f32_wire" else "bfloat16"
    assert all(o[3]["wire_dtype"] == wire for o in syncs)


def test_dense_two_level_equals_flat_dp_and_dgc_full_density(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["dense"]["losses"], r["flat"]["losses"],
                                   atol=TOL, rtol=TOL)
        for n, v in r["flat"]["state"].items():
            np.testing.assert_allclose(r["dense"]["state"][n], v, atol=TOL,
                                       rtol=TOL, err_msg=n)
        # sparsity 0 sends everything: the dense sync, bit for bit
        assert r["dgc_full"]["losses"] == r["dense"]["losses"]
        for n, v in r["dense"]["state"].items():
            np.testing.assert_array_equal(r["dgc_full"]["state"][n], v)
        # LocalSGD at k 1 with SGD is the dense gradient mean
        np.testing.assert_allclose(r["lsgd_k1"]["losses"],
                                   r["lsgd_dense"]["losses"], atol=TOL,
                                   rtol=TOL)
    ops = runs["ranks"][0]["dense"]["ops"]
    assert [o[0] for o in ops].count("c_dcn_grad_sync") == 4
    assert "c_allreduce_sum" not in [o[0] for o in ops]


def test_dgc_rampup_is_dense_before_the_boundary(runs):
    r = runs["ranks"][0]
    np.testing.assert_allclose(r["dgc_ramp3"]["losses"][:3],
                               r["dense"]["losses"][:3], atol=TOL, rtol=TOL)
    assert not np.allclose(r["dgc_ramp3"]["losses"][3:],
                           r["dense"]["losses"][3:6], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(r["dgc_ramp1"]["losses"][:1],
                               r["dense"]["losses"][:1], atol=TOL, rtol=TOL)
    assert not np.allclose(r["dgc_ramp1"]["losses"][1:],
                           r["dense"]["losses"][1:4], rtol=1e-7, atol=1e-8)


def test_per_slice_state_in_the_global_layout(runs):
    """The error feedback and LocalSGD's parameters: each rank holds its
    slice's [1, *shape], a fetch and a checkpoint the [n_dcn, *shape] of
    the JAX package; a restore gives the blocks back bit for bit."""
    ef = "fc_0.w_0@DGCErrorFeedback"
    for i, r in enumerate(runs["ranks"]):
        dcn = i // 2
        for name, var, shape in (("dgc", ef, (8, 32)),
                                 ("lsgd_k2", "lsgd_w", (8, 1))):
            got = r[name]
            assert got["local"][var].shape == (1,) + shape
            assert got["fetched"][var].shape == (2,) + shape
            np.testing.assert_array_equal(got["local"][var][0],
                                          got["fetched"][var][dcn])
            assert got["saved"][var].shape == (2,) + shape
            np.testing.assert_array_equal(got["saved"][var],
                                          got["state"][var])
            assert got["restored_equal"] == got["state_names"]
    # the two dp ranks of a slice hold the same bits, the slices differ
    # after LocalSGD's off step (5 steps at k 2: the last is off)
    ranks = runs["ranks"]
    w = [r["lsgd_k2"]["local"]["lsgd_w"] for r in ranks]
    np.testing.assert_array_equal(w[0], w[1])
    np.testing.assert_array_equal(w[2], w[3])
    assert not np.array_equal(w[0], w[2])
    e = [r["dgc"]["local"][ef] for r in ranks]
    np.testing.assert_array_equal(e[0], e[1])
    assert not np.array_equal(e[0], e[2])


def test_dgc_top_k_keeps_the_lower_index_on_ties():
    """Magnitudes that tie across k: the op sends the lower indices, as
    ``lax.top_k`` picks them; at one slice (no process group) the synced
    gradient is what was sent and the feedback what was not."""
    import torch

    from paddle_tpu_torch.ops import collective_ops as tco
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import Mesh

    g = np.array([0.5, -3.0, 2.0, -2.0, 2.0, 1.0, -2.0, 0.25, 2.0, -0.5],
                 np.float32)
    e = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                 np.float32)
    acc = g + e
    for k in (2, 3, 5, 7):
        want = np.asarray(jax.lax.top_k(np.abs(acc), k)[1])
        got = tco._top_k_lower_index(torch.as_tensor(acc), k).numpy()
        np.testing.assert_array_equal(got, want)
    # sparsity 0.6 of 10 entries: k = 4 of the five |2|s -> 1, 2, 3, 4
    ctx = treg.EmitContext(device="cpu", mesh=Mesh({"dcn": 1, "dp": 1}),
                           manual_axes=("dcn", "dp"))
    out = treg.get("c_dcn_grad_sync").emit(
        ctx, {"X": [torch.as_tensor(g)],
              "ErrorFeedback": [torch.as_tensor(e)[None]]},
        {"use_dgc": True, "sparsity": 0.6, "dcn_axis": "dcn"})
    sent = np.zeros_like(acc)
    sent[[1, 2, 3, 4]] = acc[[1, 2, 3, 4]]
    np.testing.assert_array_equal(out["Out"][0].numpy(), sent)
    np.testing.assert_array_equal(out["ErrorFeedback"][0].numpy()[0],
                                  acc - sent)
    # outside the manual path the op is the identity
    same = treg.get("c_dcn_grad_sync").emit(
        treg.EmitContext(device="cpu"), {"X": [torch.as_tensor(g)]},
        {"use_dgc": False})
    assert same["Out"][0] is not None
    np.testing.assert_array_equal(same["Out"][0].numpy(), g)


@pytest.mark.parametrize("fields,exc,match", [
    ({"dgc": True}, NotImplementedError, "hybrid_dcn"),
    ({"localsgd": True}, NotImplementedError, "hybrid_dcn"),
    ({"hybrid_dcn": 2, "pipeline": True}, NotImplementedError, "pipeline"),
    ({"hybrid_dcn": 2, "sharding": True}, NotImplementedError, "sharding"),
    ({"hybrid_dcn": 2, "tensor_parallel": True}, NotImplementedError,
     "tensor_parallel"),
    ({"hybrid_dcn": 2, "sequence_parallel": True}, NotImplementedError,
     "sequence_parallel"),
    ({"hybrid_dcn": 2, "localsgd": True, "dgc": True}, NotImplementedError,
     "pick ONE"),
    ({"hybrid_dcn": 2, "mesh": ("dp", 4)}, ValueError, "dcn"),
], ids=["dgc", "localsgd", "pipeline", "sharding", "tp", "sp",
        "localsgd_dgc", "mismatched_mesh"])
def test_refusals_the_jax_package_pins(fields, exc, match):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.parallel import Mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [4, 2], "float32")
        loss = layers.reduce_mean(layers.fc(x, 1))
        fields = dict(fields)
        if "mesh" in fields:
            a, n = fields.pop("mesh")
            fields["mesh"] = Mesh({a: n})
        strategy = set_strategy(fleet.DistributedStrategy(), fields)
        opt = fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                          strategy)
        with pytest.raises(exc, match=match):
            opt.minimize(loss)
