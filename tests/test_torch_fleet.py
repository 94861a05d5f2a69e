"""Data and sequence parallelism in the port (``fleet``, ``parallel``,
the executor's mesh plan, the sp regions of the stacks and the attention
op) against the JAX package's fleet runs, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices (GSPMD
over a mesh of the same axes); the port's ranks run as gloo processes
(``torch_dist_ranks.py``) fed the same global numpy batches, with the
JAX package's startup scope copied in (``Scope.from_numpy``).

* The JAX package's tiny attention model (tests/test_ring_attention.py)
  at {"dp": 2, "sp": 2}, {"dp": 4} and {"dp": 1} (one process, no
  process group): the loss trace within 5e-5, the JAX test's own limit.
* Tiny BERT pretraining (fuse_stack, 2 layers, f32, dropout 0) at
  {"dp": 2, "sp": 2}, 3 Adam steps: losses and every scope variable
  within 1e-4 of the JAX run; the four ranks equal bit for bit; the
  program equal to the JAX package's op for op once the c_allreduce_sum
  / scale pairs fleet inserts are removed.
* fused_decoder_stack's causal ring over trg shards at sp 2, against the
  JAX emitter under an sp mesh: Out and every gradient.
* The mesh plan: a float scalar fetch averaged, a batch fetch gathered,
  an integer scalar fetch refused, ranks started from different seeds
  holding rank 0's parameters; ``fleet.metrics`` at 2 ranks against the
  JAX package's functions on the combined values.
* Refusals: every unported strategy field and mesh axis raises naming
  its queue item; a mesh whose size is not the world size raises.  The
  parameter-server roles, bare, behave as the JAX package's.  (Tensor and pipeline parallelism are held
  in test_torch_tensor_parallel.py and test_torch_pipeline.py; lamb,
  lars, recompute and gradient merge, refused until the training-breadth
  slice, in test_torch_fleet_breadth.py and test_torch_meta_optimizers.py.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fleet as jfleet
import paddle_tpu.fluid as jfluid
from paddle_tpu.fleet import metrics as jmetrics
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid.layers import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as jreg
from paddle_tpu.parallel import create_mesh

import torch_dist_ranks
from torch_dist_ranks import attn_model, build_bert, fleet_attn_run

ATTN_TOL, BERT_TOL = 5e-5, 1e-4
ATTN_DIMS = (8, 32, 16, 4)  # B, S, H, heads
BERT = (dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64), 4, 16, 3)


def _attn_feeds():
    b, s, h, _ = ATTN_DIMS
    feeds = []
    for i in range(4):
        rng = np.random.RandomState(i)
        feeds.append({"x": rng.randn(b, s, h).astype(np.float32),
                      "y": rng.randn(b, s, h).astype(np.float32)})
    return feeds


def _jax_fleet(main, startup, loss, mesh_axes, sp, opt):
    """minimize under the JAX package's fleet (the optimizer's names
    those of a fresh process); the startup scope."""
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        strategy = jfleet.DistributedStrategy()
        strategy.mesh_axes = dict(mesh_axes)
        strategy.sequence_parallel = sp
        jfleet.init()
        jfleet.distributed_optimizer(opt, strategy).minimize(loss)
    scope = jfluid.executor.Scope()
    exe = jfluid.Executor()
    exe.run(startup, scope=scope)
    state = {n: np.asarray(v) for n, v in scope.vars.items()
             if v is not None}
    return exe, scope, state


@pytest.mark.parametrize("mesh_axes", [{"dp": 2, "sp": 2}, {"dp": 4},
                                       {"dp": 1}],
                         ids=["dp2_sp2", "dp4", "dp1"])
def test_attention_model_loss_trace_matches_jax(mesh_axes, tmp_path):
    main, startup, loss = attn_model(jfluid, jlayers, *ATTN_DIMS, seed=11)
    exe, scope, state = _jax_fleet(
        main, startup, loss, mesh_axes, "sp" in mesh_axes,
        jfluid.optimizer.AdamOptimizer(1e-2))
    feeds = _attn_feeds()
    payload = {"dims": ATTN_DIMS, "mesh_axes": mesh_axes, "state": state,
               "feeds": feeds}
    world = int(np.prod(list(mesh_axes.values())))
    started = (torch_dist_ranks.Ranks("fleet_attn", world, tmp_path,
                                      payload) if world > 1 else None)
    want = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0]).reshape(()))
            for f in feeds]
    # one process, no process group, at dp 1
    ranks = started.join() if started else [fleet_attn_run(payload)]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], want, atol=ATTN_TOL,
                               rtol=0)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_tiny_bert_dp2_sp2_matches_jax(tmp_path):
    mesh_axes, steps = {"dp": 2, "sp": 2}, 3
    cfg, main, startup, loss = build_bert(jfluid, jnn, jbert, *BERT)
    exe, scope, state = _jax_fleet(
        main, startup, loss, mesh_axes, True,
        jfluid.optimizer.AdamOptimizer(1e-3))
    _, b, s, mpn = BERT
    feed = jbert.random_pretrain_batch(cfg, b, s, mpn, seed=1)
    started = torch_dist_ranks.Ranks(
        "fleet_bert", 4, tmp_path,
        {"bert": BERT, "mesh_axes": mesh_axes, "state": state,
         "feed": feed, "steps": steps}, timeout=60.0)
    want = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).reshape(()))
            for _ in range(steps)]
    ranks = started.join()
    assert ranks[0]["sp_ops"] == ["fused_encoder_stack",
                                  "fused_encoder_stack_grad"]
    got = [float(np.asarray(v).reshape(())) for v in ranks[0]["losses"]]
    np.testing.assert_allclose(got, want, atol=BERT_TOL, rtol=0)
    assert got[-1] < got[0]
    for n in state:
        np.testing.assert_allclose(
            ranks[0]["state"][n].astype(np.float64),
            np.asarray(scope.find_var(n)).astype(np.float64),
            atol=BERT_TOL, rtol=0, err_msg=n)
    for r in ranks[1:]:
        for a, b_ in zip(r["losses"], ranks[0]["losses"]):
            np.testing.assert_array_equal(a, b_)
        for n, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][n], v, err_msg=n)
    # op for op, once the inserted gradient all-reduce pairs are removed
    ops = ranks[0]["ops"]
    synced = [o for o in ops if o[3]]
    assert [o[0] for o in synced] == ["c_allreduce_sum", "scale"] * (
        len(synced) // 2)
    assert all(o[1]["X"] == o[2]["Out"] and o[1]["X"][0].endswith("@GRAD")
               for o in synced)
    assert len(synced) // 2 == len(main.all_parameters())
    first_update = next(i for i, o in enumerate(ops) if o[0] == "adam")
    assert max(i for i, o in enumerate(ops) if o[3]) < first_update
    assert [o[:3] for o in ops if not o[3]] == [
        (op.type, op.inputs, op.outputs) for op in main.global_block().ops]


def test_decoder_causal_ring_matches_jax(tmp_path):
    """fused_decoder_stack under an sp 2 mesh (hidden 32 as 4 heads of
    8, St 16 over Ss 24, 2 layers): the causal ring over trg shards in
    both packages, cross-attention over the whole encoder output."""
    import test_torch_decoder_stack as dec

    ins, cot, attrs = dec._inputs("composition_h32")
    started = torch_dist_ranks.Ranks("decoder_ring", 2, tmp_path,
                                     {"ins": ins, "cot": cot,
                                      "attrs": attrs})
    mesh = create_mesh({"sp": 2})
    spec = jreg.get("fused_decoder_stack")

    def fn(p):
        ctx = jreg.EmitContext(rng_key=jax.random.PRNGKey(0), mesh=mesh)
        return spec.emit(ctx, {k: [v] for k, v in p.items()},
                         dict(attrs, sequence_parallel=True))["Out"][0]

    out_j, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in ins.items()})
    (g_j,) = vjp(jnp.asarray(cot))
    ranks = started.join()
    got = ranks[0]
    np.testing.assert_allclose(got["out"], np.asarray(out_j),
                               atol=dec.ATOL, rtol=0)
    for k in ins:
        np.testing.assert_allclose(got["grads"][k], np.asarray(g_j[k]),
                                   atol=dec.ATOL, rtol=dec.RTOL, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["grads"][k], got["grads"][k])


def test_fetch_startup_and_metrics_over_two_ranks(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5)).astype(np.float32)

    def m(r):
        g = np.random.default_rng(10 + r)
        return {"a": g.standard_normal(6), "pos": g.integers(0, 9, 16) * 1.0,
                "neg": g.integers(0, 9, 16) * 1.0,
                "abserr": np.array([g.random() * 4]),
                "sqrerr": np.array([g.random() * 9]),
                "correct": np.array([g.integers(20, 40) * 1.0]),
                "count": np.array([50.0])}

    mets = [m(0), m(1)]
    ranks = torch_dist_ranks.spawn(
        "fetch_startup", 2, tmp_path,
        {"x": x, "metrics": mets, "total": 100})
    r0, r1 = ranks
    assert r0["worker"] == (0, 2, True) and r1["worker"] == (1, 2, False)
    # rank 1 started from another seed and holds rank 0's parameters
    assert sorted(r0["params"]) == sorted(r1["params"])
    for n, v in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][n], v)
    w = next(v for n, v in r0["params"].items() if n.endswith(".w_0"))
    bias = next(v for n, v in r0["params"].items() if n.endswith(".b_0"))
    out = x @ w + bias
    for r in ranks:   # the batch fetch gathered, the loss averaged
        np.testing.assert_allclose(r["out"], out, atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["loss"].reshape(()), out.mean(),
                                   atol=1e-6, rtol=0)
        assert "non-float scalar" in r["int_error"]
    want = {"sum": jmetrics.sum(mets[0]["a"] + mets[1]["a"]),
            "max": jmetrics.max(np.maximum(mets[0]["a"], mets[1]["a"])),
            "min": jmetrics.min(np.minimum(mets[0]["a"], mets[1]["a"])),
            "auc": jmetrics.auc(mets[0]["pos"] + mets[1]["pos"],
                                mets[0]["neg"] + mets[1]["neg"]),
            "mae": jmetrics.mae(mets[0]["abserr"] + mets[1]["abserr"], 100),
            "rmse": jmetrics.rmse(mets[0]["sqrerr"] + mets[1]["sqrerr"],
                                  100),
            "mse": jmetrics.mse(mets[0]["sqrerr"] + mets[1]["sqrerr"], 100),
            "acc": jmetrics.acc(mets[0]["correct"] + mets[1]["correct"],
                                mets[0]["count"] + mets[1]["count"])}
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-12,
                                       atol=0, err_msg=k)


# field: (name, value, the refusal's text, other strategy fields).
# tensor_parallel, tensor_parallel_rules and pipeline run since the
# tensor- and pipeline-parallel slice, expert_parallel, sharding,
# hybrid_dcn, dgc and localsgd since the ep / ZeRO / dcn slice: their
# cases hold what stays refused with them (tp together with sp or pp, an
# op with no tensor-parallel region, the combinations the JAX package
# refuses; a Mesh without a process group stands for the ranks)
REFUSED = {"tensor_parallel": ("tensor_parallel", True, "item 6",
                               {"mesh_axes": {"dp": 1, "tp": 1, "sp": 1},
                                "sequence_parallel": True}),
           "tensor_parallel_rules": ("tensor_parallel_rules",
                                     [(r"\.w_0$", (None, "tp"))],
                                     "no tensor-parallel region",
                                     {"mesh": ("dp", 1, "tp", 2)}),
           "pipeline": ("pipeline", True, "item 6",
                        {"mesh_axes": {"dp": 1, "tp": 1, "pp": 1}}),
           "expert_parallel": ("expert_parallel", True,
                               "unset strategy.expert_parallel",
                               {"hybrid_dcn": 2,
                                "mesh": ("dcn", 2, "dp", 1)}),
           "sharding": ("sharding", True, "sharding \\+ hybrid_dcn",
                        {"hybrid_dcn": 2}),
           "hybrid_dcn": ("hybrid_dcn", 2, "the mesh also has",
                          {"mesh_axes": {"dcn": 2, "sp": 1}}),
           "dgc": ("dgc", True, "hybrid_dcn"),
           "localsgd": ("localsgd", True, "hybrid_dcn"),
           "nccl_comm_num": ("nccl_comm_num", 2, "perf_opt"),
           "hierarchical_allreduce": ("hierarchical_allreduce_inter_nranks",
                                      2, "hybrid_dcn"),
           "elastic": ("elastic", True, "dead flag"),
           "auto": ("auto", True, "strategy search")}


def _tiny_loss(fluid, layers):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [4, 3], "float32")
        loss = layers.reduce_mean(layers.fc(x, 2))
    return main, startup, loss


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_unported_strategy_fields_raise(field):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.parallel import Mesh

    name, value, where, *extra = REFUSED[field]
    main, startup, loss = _tiny_loss(fluid, layers)
    strategy = fleet.DistributedStrategy()
    assert hasattr(strategy, name)
    setattr(strategy, name, value)
    for k, v in (extra[0] if extra else {}).items():
        if k == "mesh":
            v = Mesh(dict(zip(v[::2], v[1::2])))
        setattr(strategy, k, v)
    with fluid.program_guard(main, startup), \
            pytest.raises(NotImplementedError, match=where):
        fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                    strategy).minimize(loss)


@pytest.mark.parametrize("axes,where", [
    # tp and pp run since their slice; with them, tp x sp and tp x pp stay
    # refused.  "ep" runs since the ep slice (where None: accepted); a
    # "dcn" axis runs only under strategy.hybrid_dcn
    pytest.param({"tp": 1, "sp": 1}, "item 6", id="tp-item 1"),
    pytest.param({"tp": 1, "pp": 1}, "item 6", id="pp-item 2"),
    pytest.param({"ep": 1}, None, id="ep-item 3"),
    pytest.param({"dcn": 1}, "hybrid_dcn", id="dcn-item 5")])
def test_unported_mesh_axes_raise(axes, where):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers

    main, startup, loss = _tiny_loss(fluid, layers)
    strategy = fleet.DistributedStrategy()
    strategy.mesh_axes = {"dp": 1, **axes}
    opt = fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                      strategy)
    with fluid.program_guard(main, startup):
        if where is None:
            opt.minimize(loss)
            assert main._mesh.shape == {"dp": 1, **axes}
            return
        with pytest.raises(NotImplementedError, match=where):
            opt.minimize(loss)


@pytest.mark.parametrize("name", ["init_worker", "init_server", "run_server",
                                  "stop_worker", "membership",
                                  "ps_snapshot_manifest", "ps_stats"])
def test_ps_roles_raise(name, monkeypatch):
    """The parameter-server roles are ported (their lifecycle is held in
    tests/test_torch_ps_dist.py): called bare in a process with no
    launcher environment, each returns what the JAX package's returns or
    raises the same exception type (run_server without PADDLE_PORT,
    ps_snapshot_manifest without a directory, ps_stats of an unknown
    table)."""
    from paddle_tpu_torch import fleet

    for var in ("PADDLE_PORT", "PADDLE_COORDINATOR_ENDPOINT",
                "PADDLE_TRAINERS_NUM", "PADDLE_HEARTBEAT_DIR"):
        monkeypatch.delenv(var, raising=False)
    args = ("no_such_table",) if name == "ps_stats" else ()

    def outcome(fn):
        try:
            return "value", fn(*args)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return "raises", type(e).__name__

    got = outcome(getattr(fleet, name))
    assert got == outcome(getattr(jfleet, name))
    assert got[0] == ("raises" if name in ("run_server",
                                           "ps_snapshot_manifest",
                                           "ps_stats") else "value")


def test_mesh_must_cover_the_world():
    """The JAX package takes a prefix of the devices; the port's mesh is
    exactly the world (1 here, with no process group)."""
    from paddle_tpu_torch.parallel import create_mesh as tmesh

    with pytest.raises(ValueError, match="world"):
        tmesh({"dp": 2})
    with pytest.raises(ValueError, match="at most one"):
        tmesh({"dp": -1, "sp": -1})
    m = tmesh({"dp": -1})
    assert m.shape == {"dp": 1} and m.group("dp") is None


def _port_bert(b, with_adam=True):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert

    cfg, main, startup, loss = build_bert(fluid, nn, bert, BERT[0], b,
                                          *BERT[2:])
    if with_adam:
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return cfg, main, startup, loss


def _reshapes(main):
    return [(op.type, list(op.attr("shape"))) for op in
            main.global_block().ops if op.type.startswith("reshape")]


def test_dp_plan_localizes_static_reshapes_once():
    """shard_program_data_parallel rewrites each static reshape of a
    batch-major tensor (and its grad op's copy) to the rank's batch block,
    once: rank 1 of a dp 2 mesh (no process group, so no collective
    runs) fed the global batch takes the same step as the program built
    at half the batch fed rows 2-3."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import Mesh, shard_program_data_parallel

    b, s, mpn = 4, BERT[2], BERT[3]
    cfg, main, startup, loss = _port_bert(b)
    _, half, half_startup, half_loss = _port_bert(b // 2)
    before = _reshapes(main)
    mesh = Mesh({"dp": 2}, rank=1)
    shard_program_data_parallel(main, mesh)
    shard_program_data_parallel(main, mesh)     # attached: not again
    after = _reshapes(main)
    assert [t for t, _ in before] == [t for t, _ in after]
    assert any(t.endswith("_grad") for t, _ in after)
    assert after == _reshapes(half)
    assert after != before

    feed = bert.random_pretrain_batch(cfg, b, s, mpn, seed=3)
    rows = {k: v[b // 2:] for k, v in feed.items()}
    for k in ("mask_positions", "mask_labels", "mask_weights"):
        rows[k] = feed[k][(b // 2) * mpn:]
    rows["mask_positions"] = rows["mask_positions"] - (b // 2) * s
    exe = fluid.Executor(device="cpu")
    scope = fluid.Scope()
    exe.run(half_startup, scope=scope)
    state = {n: v.clone() for n, v in scope.vars.items()}
    want = exe.run(half, feed=rows, fetch_list=[half_loss], scope=scope)[0]
    mine = fluid.Scope()
    for n, v in state.items():
        mine.set_var(n, v)
    got = exe.run(main, feed=feed, fetch_list=[loss], scope=mine)[0]
    # the fetch is the mean over the mesh, whose sum (no process group)
    # is this rank's own loss
    np.testing.assert_allclose(got * mesh.size, want, atol=1e-6, rtol=0)
    for p in main.all_parameters():
        np.testing.assert_allclose(mine.find_var(p.name).numpy(),
                                   scope.find_var(p.name).numpy(),
                                   atol=1e-6, rtol=0, err_msg=p.name)


def test_dp_plan_refuses_a_reshape_it_cannot_place():
    """A static reshape of a tensor whose batch is not dim 0 (time-major
    after a transpose) raises, as does a dim 0 that does not divide over
    the data shards; a reshape of replicated data is left alone."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.parallel import Mesh, shard_program_data_parallel

    def program(build):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [4, 6, 8], "float32")
            w = layers.create_parameter([6, 8], "float32", name="w")
            build(x, w)
        return main

    for build, err in (
            (lambda x, w: layers.reshape(layers.transpose(x, [1, 0, 2]),
                                         [6, 32]), NotImplementedError),
            (lambda x, w: layers.reshape(x, [3, 64]), ValueError)):
        with pytest.raises(err, match="reshape"):
            shard_program_data_parallel(program(build), Mesh({"dp": 2}))
    main = program(lambda x, w: layers.reshape(w, [4, 12]))
    shard_program_data_parallel(main, Mesh({"dp": 2}))
    assert _reshapes(main)[-1][1] == [4, 12]
