"""The port's PS-embedding worker for the launcher tests: the contract of
``tests/dist_ps_worker.py`` (sync / async / geo, the dead-trainer and
crash-once drills, the same trace keys) written against
``paddle_tpu_torch`` on the CPU.  It imports neither jax nor paddle_tpu.

Modes (env):
  PADDLE_PSERVERS_IP_PORT_LIST set  -> hosted table (RemoteTable client)
  unset                             -> in-process table (single-proc ref)
  PS_TEST_KILL_RANK=r               -> rank r exits(3) after KILL_STEP
                                       pushes (the survivor must FAIL FAST
                                       on the server's sync barrier)
  PS_TEST_CRASH_ONCE=1              -> ... on attempt 0 only
  PS_TEST_PROJ_W=path.npy           -> the frozen projection's values
                                       (the JAX worker's, so both
                                       packages train the same model)

Each trainer sees the per-rank half of one fixed global batch; only the
PS table trains (the projection is frozen), so the trace depends on the
table alone.
"""
import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.fluid import layers

GLOBAL_B, DIM, NCLS, ROWS, KILL_STEP = 32, 16, 7, 5_000, 4
STEPS = int(os.environ.get("PS_TEST_STEPS", 12))


def main():
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    mode = os.environ.get("PS_TEST_MODE", "sync")
    kill_rank = int(os.environ.get("PS_TEST_KILL_RANK", -1))
    if (os.environ.get("PS_TEST_CRASH_ONCE") == "1"
            and int(os.environ.get("PADDLE_ELASTIC_RESTART", 0)) > 0):
        kill_rank = -1

    rng = np.random.RandomState(0)
    all_ids = rng.randint(0, ROWS, (GLOBAL_B,)).astype(np.int64)
    all_labels = (all_ids % NCLS).astype(np.int64)[:, None]
    per = GLOBAL_B // world
    ids = all_ids[rank * per:(rank + 1) * per]
    labels = all_labels[rank * per:(rank + 1) * per]

    table = ps.create_table("ps_dist_table", shape=(ROWS, DIM), mode=mode,
                            num_shards=4, optimizer="sgd",
                            learning_rate=0.5, seed=7, geo_sync_steps=3)

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main_prog, startup):
        w = layers.data("ids", [per], dtype="int64",
                        append_batch_size=False)
        y = layers.data("y", [per, 1], dtype="int64",
                        append_batch_size=False)
        emb = layers.distributed_embedding(w, "ps_dist_table")
        proj = layers.fc(
            emb, NCLS,
            param_attr=fluid.ParamAttr(
                name="proj_w", trainable=False,
                initializer=fluid.initializer.UniformInitializer(
                    low=-0.3, high=0.3, seed=11)),
            bias_attr=False)
        loss = layers.mean(layers.softmax_with_cross_entropy(proj, y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)

    exe = fluid.Executor(device="cpu")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    proj_path = os.environ.get("PS_TEST_PROJ_W")
    if proj_path:
        scope.set_var("proj_w", torch.from_numpy(np.load(proj_path)))
    losses = []
    for step in range(STEPS):
        (lv,) = exe.run(main_prog, feed={"ids": ids, "y": labels},
                        fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
        if rank == kill_rank and step + 1 == KILL_STEP:
            os._exit(3)  # simulated hard trainer death (no cleanup)
    if hasattr(table, "flush"):  # geo: drain pending deltas
        table.flush()

    trace_dir = os.environ.get("PADDLE_DIST_TRACE_DIR", ".")
    dense = table.to_dense()
    reg = telemetry.get_registry()
    gather_hist = reg.histogram("ps_client_effective_read_ms",
                                verb="gather")
    if not gather_hist.count:
        gather_hist = reg.histogram("ps_client_rpc_ms", verb="gather")
    with open(os.path.join(trace_dir, f"trace.{rank}.json"), "w") as f:
        json.dump({"losses": losses,
                   "table_sum": float(np.float64(dense.sum())),
                   "table_touched": dense[np.unique(all_ids)][:4].tolist(),
                   "hedges_issued": sum(
                       reg.counter("ps_client_hedges_issued_total",
                                   verb=v).value
                       for v in ("gather", "stats")),
                   "hedges_won": sum(
                       reg.counter("ps_client_hedges_won_total",
                                   verb=v).value
                       for v in ("gather", "stats")),
                   "failovers": reg.counter(
                       "ps_client_failovers_total").value,
                   "gather_p95_ms": gather_hist.quantile(0.95)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
