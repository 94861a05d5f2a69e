"""The port's collectives (``paddle_tpu_torch.distributed`` and the c_*
emitters of ``ops/collective_ops.py``) against the JAX package's, on
the CPU.

The JAX side runs in this process under ``collective(...)`` (shard_map)
on the first 2 or 4 of the 8 virtual CPU devices; the port's side runs
as 2 or 4 gloo rank processes (``torch_dist_ranks.py``), each wrapping
the same per-rank body in the port's ``collective``.  Same numpy inputs;
every rank's gathered result must equal rank 0's bit for bit and the JAX
package's within 1e-6 (f32).  The gradients of ``send_recv`` (ppermute),
``all_gather`` (replicated output), ``reduce_scatter``, ``all_reduce``
and the sp identity are held against ``jax.vjp`` of the same shard_map'd
functions: a sharded input's gradient is the transpose JAX derives; the
identity's input is replicated (``P()``), so its gradient is the sum
over ranks, the c_identity backward of a model-parallel region.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from paddle_tpu import distributed as jdist
from paddle_tpu.ops import registry as jreg
from paddle_tpu.parallel import create_mesh

import torch_dist_ranks

TOL = 1e-6


def _payload(n):
    rng = np.random.default_rng(n)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": f(n * 2, 3), "xr": f(n * n * 2, 3), "xs": f(n * n * 2),
            "ct": f(n * 2, 3), "ct_rs": f(n * 2, 3), "w": f(2, 3),
            "ct_id": f(n * 2, 3)}


def _jax_cases(n, p):
    mesh = create_mesh({"dp": n})
    S = P("dp")
    x = jnp.asarray(p["x"])
    want = {}

    def run(name, fn, ins=(S,), outs=S, args=(x,)):
        want[name] = np.asarray(
            jax.jit(jdist.collective(fn, mesh, ins, outs))(*args))

    for op in ("sum", "max", "min", "prod"):
        run(f"all_reduce_{op}", lambda a, op=op: jdist.all_reduce(a, op, "dp"))
    run("all_gather", lambda a: jdist.all_gather(a, "dp"), outs=P())
    run("reduce_scatter", lambda a: jdist.reduce_scatter(a, "dp"),
        args=(jnp.asarray(p["xr"]),))
    run("broadcast", lambda a: jdist.broadcast(a, 1, "dp"))
    run("reduce", lambda a: jdist.reduce(a, 1, "sum", "dp"))
    run("scatter", lambda a: jdist.scatter(a, 1, "dp"),
        args=(jnp.asarray(p["xs"]),))
    perm = [(i, (i + 1) % n) for i in range(n)]
    run("send_recv", lambda a: jdist.send_recv(a, perm, "dp"))
    with pytest.raises(ValueError, match="not divisible"):
        jdist.collective(lambda a: jdist.scatter(a, 0, "dp"), mesh, (S,),
                         S)(jnp.zeros(n * 3))

    ctx = jreg.EmitContext(axis_env={0: "dp"})
    for op, kw in (("c_allreduce_sum", {}), ("c_allreduce_max", {}),
                   ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
                   ("c_broadcast", {"root": 1}), ("c_allgather", {}),
                   ("c_reducescatter", {}), ("c_identity", {}),
                   ("c_sync_calc_stream", {}), ("c_sync_comm_stream", {}),
                   ("c_wait_compute", {}), ("c_wait_comm", {})):
        emit = jreg.get(op).emit
        run(op, lambda a, emit=emit, kw=kw: emit(
            ctx, {"X": [a]}, dict(kw, ring_id=0))["Out"][0],
            outs=P() if op == "c_allgather" else S,
            args=(jnp.asarray(p["xr"]) if op == "c_reducescatter" else x,))

    for name, fn, ins, outs, arg, cot in (
            ("ppermute", lambda a: jdist.send_recv(a, perm, "dp"), S, S,
             p["x"], p["ct"]),
            ("all_gather", lambda a: jdist.all_gather(a, "dp"), S, P(),
             p["x"], p["ct"]),
            ("reduce_scatter", lambda a: jdist.reduce_scatter(a, "dp"), S,
             S, p["xr"], p["ct_rs"]),
            ("all_reduce", lambda a: jdist.all_reduce(a, "sum", "dp"), S, S,
             p["x"], p["ct"]),
            ("sp_identity", lambda a: a, P(), S, p["w"], p["ct_id"])):
        f = jdist.collective(fn, mesh, (ins,), outs)
        want[f"grad_{name}"] = np.asarray(jax.jit(
            lambda a, c, f=f: jax.vjp(f, a)[1](c)[0])(jnp.asarray(arg),
                                                      jnp.asarray(cot)))
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_gradients_match_jax(world, tmp_path):
    p = _payload(world)
    started = torch_dist_ranks.Ranks("collectives", world, tmp_path, p)
    want = _jax_cases(world, p)
    ranks = started.join()
    got = ranks[0]
    assert "not divisible" in got.pop("scatter_indivisible")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=TOL, rtol=0,
                                   err_msg=name)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[name], got[name], err_msg=name)
    # prod over ranks with negatives: the inputs hold both signs
    assert (p["x"] < 0).any() and (want["all_reduce_prod"] < 0).any()


def test_collectives_without_a_process_group_are_the_identity():
    """A size-1 mesh in a process that never initialised
    torch.distributed holds no process group: every collective is its
    single-participant self, differentiable."""
    import torch

    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.parallel import create_mesh as tmesh

    mesh = tmesh({"dp": 1})
    assert mesh.group("dp") is None and mesh.axis_env == {0: "dp"}
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    for y in (tdist.all_reduce(x, "sum", "dp", mesh=mesh),
              tdist.all_gather(x, "dp", mesh=mesh),
              tdist.reduce_scatter(x, "dp", mesh=mesh),
              tdist.send_recv(x, [(0, 0)], "dp", mesh=mesh),
              tdist.sp_identity(x, "dp", mesh=mesh)):
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert torch.equal(g, torch.ones_like(x))
    with pytest.raises(RuntimeError, match="no mesh"):
        tdist.all_reduce(x, "sum", "dp")
