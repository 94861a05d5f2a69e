"""Rank bodies of the port's multi-rank tests, and the spawner.

The port runs one process per rank over ``torch.distributed``; its CPU
tests start the ranks as child processes on gloo, rendezvous through a
FileStore under the test's ``tmp_path`` (no TCP port, so xdist workers
cannot collide), and read each rank's results back from a pickle.  This
module imports neither ``jax`` nor ``paddle_tpu``: a rank runs the port
alone.  The tests build the inputs with numpy, run the JAX package in
their own process, and compare.

    python tests/torch_dist_ranks.py BODY RANK WORLD WORKDIR

runs ``BODIES[BODY](rank, world, payload)`` with the payload of
``WORKDIR/in.pkl`` and writes ``WORKDIR/out_RANK.pkl``.  ``Ranks``
starts WORLD of them (the test computes the JAX side meanwhile) and its
``join`` gives the whole run one deadline, kills every rank as soon as
one fails or the deadline passes, and raises with the failing rank's
exit code and the tail of its stderr; ``spawn`` is both at once.  Every process group has
the same timeout, so a deadlock fails one test instead of the suite.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PG_TIMEOUT_S = 45.0


class Ranks:
    """``world`` gloo ranks running ``body``, started at once; ``join``
    waits for them (the caller may work meanwhile) and returns their
    results."""

    def __init__(self, body: str, world: int, workdir, payload=None,
                 timeout: float = 60.0):
        self.body, self.world, self.workdir = body, world, str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, "in.pkl"), "wb") as f:
            pickle.dump(payload, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        self.procs, self.logs = [], []
        for r in range(world):
            err = open(os.path.join(self.workdir, f"err_{r}.log"), "w")
            self.logs.append(err)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), body, str(r),
                 str(world), self.workdir], env=env, stdout=err,
                stderr=err, cwd=REPO))
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        failed = None
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [(r, c) for r, c in enumerate(codes)
                       if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    failed = (codes.index(None), "timeout")
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                p.wait()
            for f in self.logs:
                f.close()
        if failed is not None:
            r, code = failed
            with open(os.path.join(self.workdir, f"err_{r}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(
                f"rank {r} of {self.body!r} failed ({code}):\n{tail}")
        out = []
        for r in range(self.world):
            with open(os.path.join(self.workdir, f"out_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def spawn(body: str, world: int, workdir, payload=None,
          timeout: float = 60.0) -> list:
    """Run ``body`` on ``world`` gloo ranks; the list of their results."""
    return Ranks(body, world, workdir, payload, timeout).join()


# ---------------------------------------------------------------------------
# helpers shared by the bodies (also called in-process for one rank)
# ---------------------------------------------------------------------------


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _collective_cases(mesh, p):
    """Every functional collective and c_* emitter on this rank, as the
    global results ``collective`` gathers."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import PartitionSpec as P

    S = P("dp")
    x = torch.as_tensor(p["x"])
    out = {}

    def run(name, fn, ins=(S,), outs=S, args=(x,)):
        out[name] = _np(dist.collective(fn, mesh, ins, outs)(*args))

    for op in ("sum", "max", "min", "prod"):
        run(f"all_reduce_{op}", lambda a, op=op: dist.all_reduce(a, op, "dp"))
    run("all_gather", lambda a: dist.all_gather(a, "dp"), outs=P())
    run("reduce_scatter", lambda a: dist.reduce_scatter(a, "dp"),
        args=(torch.as_tensor(p["xr"]),))
    run("broadcast", lambda a: dist.broadcast(a, 1, "dp"))
    run("reduce", lambda a: dist.reduce(a, 1, "sum", "dp"))
    run("scatter", lambda a: dist.scatter(a, 1, "dp"),
        args=(torch.as_tensor(p["xs"]),))
    n = mesh.shape["dp"]
    perm = [(i, (i + 1) % n) for i in range(n)]
    run("send_recv", lambda a: dist.send_recv(a, perm, "dp"))
    try:
        dist.collective(lambda a: dist.scatter(a, 0, "dp"), mesh, (S,), S)(
            torch.zeros(n * 3))
        out["scatter_indivisible"] = None
    except ValueError as e:
        out["scatter_indivisible"] = str(e)
    dist.barrier("dp", mesh=mesh)

    ctx = treg.EmitContext(device="cpu", mesh=mesh, axis_env=mesh.axis_env)
    for op, kw in (("c_allreduce_sum", {}), ("c_allreduce_max", {}),
                   ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
                   ("c_broadcast", {"root": 1}), ("c_allgather", {}),
                   ("c_reducescatter", {}), ("c_identity", {}),
                   ("c_sync_calc_stream", {}), ("c_sync_comm_stream", {}),
                   ("c_wait_compute", {}), ("c_wait_comm", {})):
        outs = P() if op == "c_allgather" else S
        arg = torch.as_tensor(p["xr"]) if op == "c_reducescatter" else x
        emit = treg.get(op).emit
        run(op, lambda a, emit=emit, kw=kw: emit(
            ctx, {"X": [a]}, dict(kw, ring_id=0))["Out"][0], outs=outs,
            args=(arg,))

    # gradients: the transposes, through collective's slice / gather
    ct = torch.as_tensor(p["ct"])
    for name, fn, ins, outs, arg, cot in (
            ("ppermute", lambda a: dist.send_recv(a, perm, "dp"), S, S,
             x, ct),
            ("all_gather", lambda a: dist.all_gather(a, "dp"), S, P(),
             x, ct),
            ("reduce_scatter", lambda a: dist.reduce_scatter(a, "dp"), S, S,
             torch.as_tensor(p["xr"]), torch.as_tensor(p["ct_rs"])),
            ("all_reduce", lambda a: dist.all_reduce(a, "sum", "dp"), S, S,
             x, ct),
            ("sp_identity", lambda a: dist.sp_identity(a, "dp"), P(), S,
             torch.as_tensor(p["w"]), torch.as_tensor(p["ct_id"]))):
        leaf = arg.clone().requires_grad_()
        y = dist.collective(fn, mesh, (ins,), outs)(leaf)
        (g,) = torch.autograd.grad(y, leaf, cot)
        out[f"grad_{name}"] = _np(g)
    return out


def body_collectives(rank, world, p):
    from paddle_tpu_torch.parallel import create_mesh

    return _collective_cases(create_mesh({"dp": world}), p)


def body_ring(rank, world, p):
    """ring_attention_global over sp = world for each case: o and the
    gradients of q, k, v and the key bias, and how many flash blocks ran."""
    import torch

    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_attention_global)

    mesh = create_mesh({"sp": world})
    calls = []
    real = fa._FlashBHSD.apply
    fa._FlashBHSD.apply = lambda *a: calls.append(1) or real(*a)
    out = []
    for case in p["cases"]:
        leaves = [torch.as_tensor(case[k]).requires_grad_()
                  for k in ("q", "k", "v")]
        bias = (None if case["bias"] is None
                else torch.as_tensor(case["bias"]).requires_grad_())
        n0 = len(calls)
        o = ring_attention_global(*leaves, mesh, axis="sp", bias=bias,
                                  causal=case["causal"], batch_axis=None)
        wrt = leaves + ([bias] if bias is not None else [])
        grads = torch.autograd.grad(o, wrt, torch.as_tensor(case["ct"]))
        res = {"o": _np(o), "dq": _np(grads[0]), "dk": _np(grads[1]),
               "dv": _np(grads[2]), "flash_blocks": len(calls) - n0}
        if bias is not None:
            res["dbias"] = _np(grads[3])
        out.append(res)
    return out


def attn_model(fluid, layers, B, S, H, NH, seed):
    """The JAX package's tiny sequence-parallel attention model
    (tests/test_ring_attention.py): three fc projections, the fused
    attention op, a square-error loss."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [B, S, H], "float32")
        y = fluid.data("y", [B, S, H], "float32")
        q = layers.fc(x, H, num_flatten_dims=2)
        k = layers.fc(x, H, num_flatten_dims=2)
        v = layers.fc(x, H, num_flatten_dims=2)
        helper = fluid.layer_helper.LayerHelper("attn")
        out = helper.create_variable_for_type_inference("float32")
        main.current_block().append_op(
            type="fused_multihead_attention",
            inputs={"Q": [q], "K": [k], "V": [v]},
            outputs={"Out": [out]},
            attrs={"num_heads": NH, "is_test": False})
        loss = layers.reduce_mean(layers.square_error_cost(out, y))
    return main, startup, loss


def fleet_attn_run(p):
    """The tiny attention model under fleet with p["mesh_axes"]: the
    JAX package's startup scope copied in, 4 Adam steps; the loss trace."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers

    main, startup, loss = attn_model(fluid, layers, *p["dims"], seed=11)
    # at dp 1 this runs in the test's process: names as a fresh one's
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh_axes = dict(p["mesh_axes"])
        strategy.sequence_parallel = "sp" in p["mesh_axes"]
        fleet.init()
        opt = fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(1e-2), strategy)
        opt.minimize(loss)
    scope = fluid.Scope.from_numpy(p["state"], device="cpu")
    exe = fluid.Executor(device="cpu")
    return {"losses": [float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0].reshape(()))
                       for f in p["feeds"]]}


def body_fleet_attn(rank, world, p):
    return fleet_attn_run(p)


def build_bert(fluid, nn, bert, kw, b, s, mpn, fuse_stack=True):
    """Tiny BERT pretraining (dropout 0; fuse_stack, or the unfused
    encoder on the fused attention op) and its loss."""
    nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig(**kw, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0,
                          fuse_stack=fuse_stack, use_flash_attention=True)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, b, s, mpn, main_program=main, startup_program=startup)
    return cfg, m, st, loss


def body_fleet_bert(rank, world, p):
    """Tiny BERT at p["mesh_axes"] through fleet: the loss trace, every
    scope variable after the steps, and the program's ops."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert

    cfg, main, startup, loss = build_bert(fluid, nn, bert, *p["bert"])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh_axes = dict(p["mesh_axes"])
        strategy.sequence_parallel = True
        fleet.init()
        fleet.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-3),
                                    strategy).minimize(loss)
    scope = fluid.Scope.from_numpy(p["state"], device="cpu")
    exe = fluid.Executor(device="cpu")
    losses = [exe.run(main, feed=p["feed"], fetch_list=[loss],
                      scope=scope)[0] for _ in range(p["steps"])]
    return {"losses": losses,
            "state": {n: _np(v) for n, v in scope.vars.items()},
            "ops": [(op.type, op.inputs, op.outputs,
                     bool(op.attrs.get("grad_sync")))
                    for op in main.global_block().ops],
            "sp_ops": sorted(op.type for op in main.global_block().ops
                             if op.attrs.get("sequence_parallel"))}


def fleet_bert_parallel(p):
    """Tiny BERT through fleet with p's mesh axes and strategy (tensor
    parallel rules, pipeline, sequence parallel, bf16 AMP): the JAX package's
    global startup state handed in (each rank keeps its blocks), the loss
    trace, and every scope variable gathered back to its global value."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import gather_shard, get_var_sharding

    cfg, main, startup, loss = build_bert(fluid, nn, bert, *p["bert"],
                                          fuse_stack=p["fuse_stack"])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh_axes = dict(p["mesh_axes"])
        strategy.sequence_parallel = "sp" in p["mesh_axes"]
        if p.get("tp"):
            strategy.tensor_parallel_rules = bert.tensor_parallel_rules()
        if p.get("pipeline"):
            strategy.pipeline = True
            strategy.pipeline_configs = {
                "accumulate_steps": p.get("accumulate_steps", 1)}
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        if p.get("amp"):
            from paddle_tpu_torch.contrib import mixed_precision

            opt = mixed_precision.decorate(opt, use_bf16=True)
        fleet.init()
        fleet.distributed_optimizer(opt, strategy).minimize(loss)
    scope = fluid.Scope.from_numpy(p["state"], device="cpu", program=main)
    exe = fluid.Executor(device="cpu")
    losses = [exe.run(main, feed=p["feed"], fetch_list=[loss],
                      scope=scope)[0] for _ in range(p["steps"])]
    block = main.global_block()
    state, local = {}, {}
    for n in sorted(scope.vars):
        v = scope.find_var(n)
        local[n] = _np(v)
        var = block._find_var_recursive(n)
        spec = None if var is None else get_var_sharding(var)
        state[n] = _np(gather_shard(v, spec, main._mesh) if spec else v)
    return {"losses": losses, "state": state, "local": local,
            "ops": [(op.type, op.inputs, op.outputs,
                     bool(op.attrs.get("grad_sync")),
                     op.attrs.get("tp_region"))
                    for op in main.global_block().ops]}


def body_fleet_bert_parallel(rank, world, p):
    return [fleet_bert_parallel(dict(p, **case)) for case in p["cases"]]


def two_fc_model(fluid, layers, seed):
    """The JAX package's two-fc regression model (tests/test_fleet.py):
    fc 8 -> 32 relu, fc 32 -> 1, a square-error loss."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [16, 8], "float32")
        y = fluid.data("y", [16, 1], "float32")
        h = layers.fc(x, 32, act="relu")
        pred = layers.fc(h, 1)
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    return main, startup, loss


TWO_FC_RULES = [(r"^fc_0\.w_0$", (None, "tp")), (r"^fc_0\.b_0$", ("tp",)),
                (r"^fc_1\.w_0$", ("tp", None))]


def _two_fc_tp(p):
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers

    main, startup, loss = two_fc_model(fluid, layers, seed=7)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        strategy = fleet.DistributedStrategy()
        strategy.mesh_axes = dict(p["mesh_axes"])
        strategy.tensor_parallel = True
        strategy.tensor_parallel_rules = TWO_FC_RULES
        fleet.init()
        fleet.distributed_optimizer(fluid.optimizer.AdamOptimizer(1e-2),
                                    strategy).minimize(loss)
    scope = fluid.Scope.from_numpy(p["state"], device="cpu", program=main)
    exe = fluid.Executor(device="cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for f in p["feeds"][:-1]]
    # the last step also fetches a sharded parameter: gathered
    lv, w = exe.run(main, feed=p["feeds"][-1],
                    fetch_list=[loss, "fc_0.w_0"], scope=scope)
    losses.append(float(lv.reshape(())))
    from paddle_tpu_torch.parallel import gather_shard, get_var_sharding

    w_var = main.global_block().var("fc_0.w_0")
    w_gathered = _np(gather_shard(scope.find_var("fc_0.w_0"),
                                  get_var_sharding(w_var), main._mesh))
    # a checkpoint holds the global values; a restore keeps the blocks
    import torch.distributed as dist

    root = os.path.join(p["ckpt"], f"rank{dist.get_rank()}")
    fluid.CheckpointManager(root, program=main, scope=scope,
                            device="cpu").save(5)
    back, whole = fluid.Scope(), fluid.Scope()
    fluid.CheckpointManager(root, program=main, scope=back,
                            device="cpu").restore()
    fluid.CheckpointManager(root, scope=whole, device="cpu").restore()
    return {"losses": losses, "fetched_w": w, "gathered_w": w_gathered,
            "regions": [op.attrs.get("tp_region")
                        for op in main.global_block().ops],
            "restored_equal": sorted(
                n for n, v in scope.vars.items()
                if back.find_var(n) is not None
                and bool((back.find_var(n) == v).all())),
            "state_names": sorted(scope.vars),
            "saved_shapes": {n: tuple(v.shape)
                             for n, v in whole.vars.items()}}


def body_two_fc_tp(rank, world, p):
    return _two_fc_tp(p)


def _tp_op_cases(mesh, p):
    """The vocabulary-parallel lookup and the tied MLM head on this
    rank's block of the table, and the gradients of f, g and the
    last-rank broadcast over "tp"."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import local_shard

    ctx = treg.EmitContext(device="cpu", mesh=mesh, axis_env=mesh.axis_env)
    out = {}
    w = local_shard(torch.as_tensor(p["table"]), ("tp", None), mesh)
    w = w.clone().requires_grad_()
    for op, ids in (("lookup_table_v2", p["ids"]),
                    ("lookup_table", p["ids"][..., None])):
        o = treg.get(op).emit(ctx, {"W": [w], "Ids": [torch.as_tensor(ids)]},
                              {"padding_idx": p["padding_idx"],
                               "tp_region": "vocab"})["Out"][0]
        (g,) = torch.autograd.grad(o, w, torch.as_tensor(p["ct_lookup"]),
                                   allow_unused=True)
        out[op] = {"out": _np(o),
                   "dw": _np(dist.all_gather(g, "tp", 0, mesh))}
    x = torch.as_tensor(p["trans"]).requires_grad_()
    o = treg.get("matmul").emit(
        ctx, {"X": [x], "Y": [w]},
        {"transpose_X": False, "transpose_Y": True, "alpha": 1.0,
         "tp_region": "vocab_head"})["Out"][0]
    dx, dw = torch.autograd.grad(o, [x, w], torch.as_tensor(p["ct_head"]))
    out["head"] = {"out": _np(o), "dx": _np(dx),
                   "dw": _np(dist.all_gather(dw, "tp", 0, mesh))}
    # f, g and the last-rank broadcast: x differs by rank where the
    # region's input does, the loss is sum(y * c) with c on every rank
    i = mesh.coords["tp"]
    for name, fn, xin, cot in (
            ("f", dist.copy_to_region, p["c"], p["c_rank"][i]),
            ("g", dist.reduce_from_region, p["c_rank"][i], p["c"]),
            ("broadcast", dist.broadcast_from_last, p["c_rank"][i],
             p["c"])):
        leaf = torch.as_tensor(xin).clone().requires_grad_()
        y = fn(leaf, "tp", mesh)
        (g,) = torch.autograd.grad((y * torch.as_tensor(cot)).sum(), leaf)
        out[name] = {"y": _np(y), "dx": _np(g)}
    return out


def body_tp(rank, world, p):
    """Every tensor-parallel case of tests/test_torch_tensor_parallel.py
    on one set of dp 2 x tp 2 ranks."""
    from paddle_tpu_torch.parallel import create_mesh

    return {"two_fc": _two_fc_tp(p["two_fc"]),
            "bert": fleet_bert_parallel(p["bert"]),
            "bert_bf16": fleet_bert_parallel(p["bert_bf16"]),
            "ops": _tp_op_cases(create_mesh({"dp": 2, "tp": 2}), p["ops"])}


def body_pipeline(rank, world, p):
    """Every multi-rank case of tests/test_torch_pipeline.py on one set
    of 4 ranks: the GPipe stacks, then tiny BERT through fleet."""
    return {"gpipe": body_gpipe(rank, world, p["gpipe"]),
            "bert": body_fleet_bert_parallel(rank, world, p["bert"])}


def body_decoder_ring(rank, world, p):
    """fused_decoder_stack under an sp mesh: Out and every gradient."""
    import torch

    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"sp": world})
    leaves = {k: torch.as_tensor(v).requires_grad_()
              for k, v in p["ins"].items()}
    ctx = treg.EmitContext(device="cpu", mesh=mesh, axis_env=mesh.axis_env)
    out = treg.get("fused_decoder_stack").emit(
        ctx, {k: [v] for k, v in leaves.items()},
        dict(p["attrs"], sequence_parallel=True))["Out"][0]
    grads = torch.autograd.grad(out, list(leaves.values()),
                                torch.as_tensor(p["cot"]))
    return {"out": _np(out),
            "grads": {k: _np(g) for k, g in zip(leaves, grads)}}


def body_fetch_startup(rank, world, p):
    """A tiny fc program under fleet dp = world, started from a different
    seed on each rank: the parameters after startup, a float scalar
    fetch, a batch-sharded fetch, an integer scalar fetch; then
    fleet.metrics on this rank's arrays."""
    import numpy as np

    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers

    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 100 + rank
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", p["x"].shape, "float32")
        out = layers.fc(x, 3)
        loss = layers.reduce_mean(out)
        count = layers.cast(layers.reduce_sum(x), "int32")
        strategy = fleet.DistributedStrategy()
        strategy.mesh_axes = {"dp": world}
        fleet.init()
        fleet.distributed_optimizer(fluid.optimizer.SGDOptimizer(0.1),
                                    strategy).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(device="cpu")
    exe.run(startup, scope=scope)
    params = {v.name: _np(scope.find_var(v.name))
              for v in main.all_parameters()}
    lv, ov = exe.run(main, feed={"x": p["x"]}, fetch_list=[loss, out],
                     scope=scope)
    try:
        exe.run(main, feed={"x": p["x"]}, fetch_list=[count], scope=scope)
        int_error = None
    except TypeError as e:
        int_error = str(e)
    m = p["metrics"][rank]
    met = {"sum": fleet.metrics.sum(m["a"]), "max": fleet.metrics.max(m["a"]),
           "min": fleet.metrics.min(m["a"]),
           "auc": fleet.metrics.auc(m["pos"], m["neg"]),
           "mae": fleet.metrics.mae(m["abserr"], p["total"]),
           "rmse": fleet.metrics.rmse(m["sqrerr"], p["total"]),
           "mse": fleet.metrics.mse(m["sqrerr"], p["total"]),
           "acc": fleet.metrics.acc(m["correct"], m["count"])}
    return {"params": params, "loss": np.asarray(lv), "out": ov,
            "int_error": int_error, "metrics": met,
            "worker": (fleet.worker_index(), fleet.worker_num(),
                       fleet.is_first_worker())}


def body_gpipe(rank, world, p):
    """fused_encoder_stack under each case's mesh (pipeline, and the ring
    for pp x sp), this rank's block of the stacked [L, ...] parameters:
    Out, the gradient of Hidden, and every parameter gradient gathered
    over "pp" back to [L, ...]; how many layers this stage ran."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.ops import encoder_stack as es
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import create_mesh, local_shard

    out = []
    for case in p["cases"]:
        mesh = create_mesh(case["mesh"])
        hidden = torch.as_tensor(case["ins"]["Hidden"]).requires_grad_()
        ins = {"Hidden": [hidden]}
        if case["ins"].get("AttnBias") is not None:
            ins["AttnBias"] = [torch.as_tensor(case["ins"]["AttnBias"])]
        spec = ("pp", None, None)
        leaves = {k: local_shard(torch.as_tensor(case["ins"][k]), spec, mesh)
                  .clone().requires_grad_() for k in es._PARAM_KEYS}
        ins.update({k: [v] for k, v in leaves.items()})
        ctx = treg.EmitContext(device="cpu", mesh=mesh,
                               axis_env=mesh.axis_env)
        calls = []
        run = es._Schedule.forward

        def counted(self, *a, run=run):
            calls.append(1)
            return run(self, *a)

        es._Schedule.forward = counted
        try:
            o = treg.get("fused_encoder_stack").emit(
                ctx, ins, dict(case["attrs"]))["Out"][0]
            wrt = [hidden] + list(leaves.values())
            grads = torch.autograd.grad(o, wrt, torch.as_tensor(case["cot"]))
        finally:
            es._Schedule.forward = run
        res = {"out": _np(o), "dhidden": _np(grads[0]),
               "layers": int(leaves["QKVW"].shape[0]),
               "schedules": len(calls), "grads": {}}
        for k, g in zip(leaves, grads[1:]):
            res["grads"][k] = _np(dist.all_gather(g, "pp", 0, mesh))
        out.append(res)
    return out


def linear_model(fluid, layers, seed):
    """The JAX package's LocalSGD model (tests/test_dcn.py): one fc 8 -> 1
    without a bias, its weight named lsgd_w, a square-error loss."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [16, 8], "float32")
        y = fluid.data("y", [16, 1], "float32")
        pred = layers.fc(x, 1, bias_attr=False,
                         param_attr=fluid.ParamAttr(name="lsgd_w"))
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    return main, startup, loss


def make_optimizer(fluid, spec):
    """("sgd", lr), ("adam", lr) or ("momentum", lr, mu)."""
    kind = spec[0]
    if kind == "sgd":
        return fluid.optimizer.SGDOptimizer(learning_rate=spec[1])
    if kind == "adam":
        return fluid.optimizer.AdamOptimizer(spec[1])
    return fluid.optimizer.MomentumOptimizer(spec[1], momentum=spec[2])


def build_model(fluid, layers, nn, bert, p):
    """p["model"]: "two_fc", "linear" or ("bert", kw, b, s, mpn,
    fuse_stack) (``build_bert``'s arguments)."""
    model = p["model"]
    if model == "two_fc":
        return two_fc_model(fluid, layers, seed=7)
    if model == "linear":
        return linear_model(fluid, layers, seed=0)
    return build_bert(fluid, nn, bert, *model[1:])[1:]


def set_strategy(strategy, fields):
    for k, v in fields.items():
        setattr(strategy, k, v)
    return strategy


def fleet_run(p):
    """One rank's run of p's model through fleet with p["strategy"]'s
    fields and p["opt"]: the JAX package's global startup state handed
    in (each rank keeps its blocks), the loss trace over p["feeds"], the
    p["fetch"] variables fetched at the last step, every scope variable
    gathered to its global value and as this rank holds it, and with
    p["ckpt"] a CheckpointManager save (its arrays as saved) and restore
    (the blocks back, bit for bit)."""
    import torch.distributed as dist

    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import gather_shard, get_var_sharding

    main, startup, loss = build_model(fluid, layers, nn, bert, p)
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        strategy = set_strategy(fleet.DistributedStrategy(), p["strategy"])
        fleet.init()
        fleet.distributed_optimizer(make_optimizer(fluid, p["opt"]),
                                    strategy).minimize(loss)
    scope = fluid.Scope.from_numpy(p["state"], device="cpu", program=main)
    exe = fluid.Executor(device="cpu")
    fetch = list(p.get("fetch", ()))
    losses, fetched = [], {}
    for i, f in enumerate(p["feeds"]):
        last = i == len(p["feeds"]) - 1
        out = exe.run(main, feed=f, fetch_list=[loss] + (fetch if last
                                                         else []),
                      scope=scope)
        losses.append(float(out[0].reshape(-1)[0]))
        if last:
            fetched = dict(zip(fetch, out[1:]))
    block = main.global_block()
    state, local = {}, {}
    for n in sorted(scope.vars):
        v = scope.find_var(n)
        local[n] = _np(v)
        var = block._find_var_recursive(n)
        spec = None if var is None else get_var_sharding(var)
        state[n] = _np(gather_shard(v, spec, main._mesh) if spec else v)
    res = {"losses": losses, "state": state, "local": local,
           "fetched": fetched,
           "ops": [(op.type, op.inputs, op.outputs, dict(op.attrs))
                   for op in block.ops
                   if op.type.startswith(("c_", "dcn_", "adam", "sgd",
                                          "momentum", "lamb"))]}
    if p.get("ckpt"):
        root = os.path.join(p["ckpt"], f"rank{dist.get_rank()}")
        fluid.CheckpointManager(root, program=main, scope=scope,
                                device="cpu").save(len(p["feeds"]))
        back, whole = fluid.Scope(), fluid.Scope()
        fluid.CheckpointManager(root, program=main, scope=back,
                                device="cpu").restore()
        fluid.CheckpointManager(root, scope=whole, device="cpu").restore()
        res["saved"] = {n: _np(v) for n, v in whole.vars.items()}
        res["restored_equal"] = sorted(
            n for n, v in scope.vars.items()
            if back.find_var(n) is not None
            and back.find_var(n).shape == v.shape
            and bool((back.find_var(n) == v).all()))
        res["state_names"] = sorted(scope.vars)
    return res


def body_fleet_runs(rank, world, p):
    """Each case of p["cases"] (over p["common"]) through ``fleet_run``
    on this rank; with p["moe_op"] the moe_ffn op cases first."""
    out = {}
    if p.get("moe_op"):
        out["moe_op"] = _moe_op_cases(p["moe_op"])
    out["runs"] = [fleet_run(dict(p["common"], **case))
                   for case in p["cases"]]
    return out


def _moe_op_cases(p):
    """moe_ffn on this rank's rows of a global batch: over dp 4 with the
    experts whole, then over dp 2 x ep 2 with this rank's expert block.
    Out, and the gradients of X and of every weight for a cotangent of
    Out alone and one of AuxLoss alone."""
    import torch

    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import create_mesh, local_shard

    out = {}
    spec = {"W1": ("ep", None, None), "B1": ("ep", None),
            "W2": ("ep", None, None), "B2": ("ep", None)}
    for name, axes, weights in (("dp4", {"dp": 4}, p["dp4"]),
                                ("dp2_ep2", {"dp": 2, "ep": 2},
                                 p["dp2_ep2"])):
        mesh = create_mesh(axes)
        dp = mesh.shape["dp"]
        rows = weights["X"].shape[0] // dp
        r0 = mesh.coords["dp"] * rows
        case = {}
        for what, (c_out, c_aux) in (("out", (1.0, 0.0)),
                                     ("aux", (0.0, 1.0))):
            leaves = {}
            for k, v in weights.items():
                t = torch.as_tensor(v)
                if k == "X":
                    t = t[r0:r0 + rows]
                elif k in spec:
                    t = local_shard(t, spec[k], mesh)
                leaves[k] = t.clone().requires_grad_()
            ctx = treg.EmitContext(device="cpu", mesh=mesh,
                                   axis_env=mesh.axis_env)
            res = treg.get("moe_ffn").emit(
                ctx, {k: [v] for k, v in leaves.items()},
                p[f"attrs_{name}"])
            o, aux = res["Out"][0], res["AuxLoss"][0]
            ct = torch.as_tensor(p["cot"][r0:r0 + rows]) * c_out
            grads = torch.autograd.grad(
                [o, aux], list(leaves.values()),
                [ct, torch.tensor(p["cot_aux"] * c_aux)])
            case[what] = {"out": _np(o), "aux": float(aux),
                          "grads": {k: _np(g) for k, g in
                                    zip(leaves, grads)}}
        out[name] = case
    return out


def amp_f16_run(p):
    """Tiny BERT under float16 AMP, through fleet with p["strategy"]'s
    fields (amp on, ``amp_configs`` = p["amp"] with use_bf16 off), or with
    p["strategy"] None the decorator alone in one process.  A fault
    injection makes this rank's own gradient block of p["inject_grad"]
    non-finite at the steps p["inject"][rank] names: the gradient times
    the persistable ``amp_inject`` (inf there, 1 elsewhere), right after
    the op that writes it, so before any reduction of it.  Per step: the
    loss, the scale, both counters, found_inf from this rank's gradients
    and as reduced, and whether any update output moved."""
    import math

    import numpy as np
    import torch.distributed as dist

    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.fluid.layers import nn
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.optimizer_ops import UPDATE_OPS

    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg, main, startup, loss = build_bert(fluid, nn, bert, *p["bert"])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        main.global_block().create_var(name="amp_inject", shape=(1,),
                                       dtype="float32", persistable=True)
        opt = fluid.optimizer.AdamOptimizer(1e-3)
        if p["strategy"] is None:
            dec = mp.decorate(opt, use_bf16=False, **p["amp"])
            dec.minimize(loss)
        else:
            strategy = set_strategy(fleet.DistributedStrategy(), dict(
                p["strategy"], amp=True,
                amp_configs=dict(p["amp"], use_bf16=False)))
            fleet.init()
            fopt = fleet.distributed_optimizer(opt, strategy)
            fopt.minimize(loss)
            dec = fopt._amp_optimizer
    block = main.global_block()
    # this rank's own found_inf flags land in persistables (a fetch under
    # a mesh would be reduced over the ranks)
    flags = {"found_inf_local": dec._found_inf_local,
             "found_inf": dec._found_inf}
    for name, var in flags.items():
        keep = block.create_var(name=f"amp_{name}", shape=(1,),
                                dtype="float32", persistable=True)
        block.append_op(type="cast", inputs={"X": [var]},
                        outputs={"Out": [keep]},
                        attrs={"in_dtype": var.dtype,
                               "out_dtype": keep.dtype})
    at = next(i for i, op in enumerate(block.ops)
              if p["inject_grad"] in op.output_names())
    block._insert_op(at + 1, type="elementwise_mul",
                     inputs={"X": [p["inject_grad"]], "Y": ["amp_inject"]},
                     outputs={"Out": [p["inject_grad"]]})
    main._bump_version()
    state = dict(p["state"], amp_inject=np.ones(1, np.float32),
                 **{f"amp_{n}": np.zeros(1, np.float32) for n in flags})
    scope = fluid.Scope.from_numpy(state, device="cpu", program=main)
    exe = fluid.Executor(device="cpu")
    written = sorted({n for op in block.ops if op.type in UPDATE_OPS
                      for n in op.output_names()})
    fetch = [loss, dec.get_loss_scaling(), dec._good_steps, dec._bad_steps]
    steps = []
    for i, f in enumerate(p["feeds"]):
        scope.find_var("amp_inject").fill_(
            math.inf if i in p["inject"].get(rank, ()) else 1.0)
        before = [_np(scope.find_var(n)).copy() for n in written]
        out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        moved = any(b.tobytes() != _np(scope.find_var(n)).tobytes()
                    for n, b in zip(written, before))
        v = [float(np.asarray(o).reshape(-1)[0]) for o in out]
        steps.append({"loss": v[0], "scale": v[1], "good": v[2],
                      "bad": v[3], "moved": moved, **{
                          n: bool(_np(scope.find_var(f"amp_{n}"))[0])
                          for n in flags}})
    return {"steps": steps,
            "reductions": [(op.type, op.attrs.get("ring_id"))
                           for op in block.ops
                           if op.type == "c_allreduce_max"]}


def body_amp_f16(rank, world, p):
    """Each case of p["cases"] (over p["common"]) through ``amp_f16_run``
    on this rank."""
    return [amp_f16_run(dict(p["common"], **case)) for case in p["cases"]]


BODIES = {"collectives": body_collectives, "ring": body_ring,
          "fleet_attn": body_fleet_attn, "fleet_bert": body_fleet_bert,
          "decoder_ring": body_decoder_ring,
          "fetch_startup": body_fetch_startup, "tp": body_tp,
          "two_fc_tp": body_two_fc_tp, "fleet_runs": body_fleet_runs,
          "pipeline": body_pipeline, "amp_f16": body_amp_f16}


def main(argv) -> int:
    body, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    for k, v in (("RANK", rank), ("WORLD_SIZE", world),
                 ("PADDLE_TRAINER_ID", rank), ("PADDLE_TRAINERS_NUM", world)):
        os.environ[k] = str(v)
    from paddle_tpu_torch.parallel import env

    env.init_parallel_env(device="cpu",
                          init_method=f"file://{workdir}/store",
                          timeout_s=PG_TIMEOUT_S)
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = BODIES[body](rank, world, payload)
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
