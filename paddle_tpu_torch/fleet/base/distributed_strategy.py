"""DistributedStrategy: structured distributed-training config.

A copy of the JAX package's ``fleet/base/distributed_strategy.py``, every
field kept (parity: the reference's python/paddle/fleet/base/
distributed_strategy.py wrapping framework/distributed_strategy.proto:
95-130).  In the port, ``mesh`` is a ``paddle_tpu_torch.parallel.Mesh``.
Which fields this slice runs and which raise is ``fleet``'s
``_reject_unsupported``: no field is silently ignored.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class DistributedStrategy:
    def __init__(self):
        # --- parity fields (reference distributed_strategy.proto) ---
        self.amp: bool = False
        self.amp_configs: Dict = {}
        self.recompute: bool = False
        self.recompute_configs: Dict = {"checkpoints": []}
        self.gradient_merge: bool = False
        self.gradient_merge_configs: Dict = {"k_steps": 1, "avg": True}
        self.pipeline: bool = False
        self.pipeline_configs: Dict = {"accumulate_steps": 1}
        # localsgd needs per-worker divergent weights, which the GSPMD
        # executor (replicated params) cannot express yet: setting it makes
        # minimize raise. dgc targets SLOW interconnects: over single-slice
        # TPU ICI it stays rejected, but with hybrid_dcn >= 2 (multi-slice
        # mesh with an outer DCN axis) it compresses the cross-slice
        # gradient exchange (reference details/sparse_all_reduce_op_handle.cc
        # -> top-k + error feedback over the "dcn" axis here). elastic is a
        # dead flag in the reference too. None of these is silently
        # ignored — fleet.minimize rejects unsupported combinations.
        self.localsgd: bool = False
        self.localsgd_configs: Dict = {"k_steps": 1}
        self.dgc: bool = False
        self.dgc_configs: Dict = {"rampup_begin_step": 0, "sparsity": 0.999}
        # multi-slice: number of slices on the outer (DCN) mesh axis; the
        # inner axis stays "dp" over ICI. >= 2 activates the manual
        # two-level gradient sync (dense over dp, dense-or-DGC over dcn)
        self.hybrid_dcn: int = 0
        # lamb/lars swap the inner optimizer (reference meta-optimizer chain)
        self.lars: bool = False
        self.lars_configs: Dict = {}
        self.lamb: bool = False
        self.lamb_configs: Dict = {}
        # ZeRO-2 analog: shard optimizer moments over "dp" (memory / dp)
        self.sharding: bool = False
        self.sharding_configs: Dict = {}
        self.elastic: bool = False
        self.auto: bool = False
        # NCCL knobs: sync_nccl_allreduce and fuse_grad_size_in_MB are
        # inert (one all-reduce a gradient, no buckets yet); more than one
        # communicator or a hierarchical all-reduce raises
        self.nccl_comm_num: int = 1
        self.hierarchical_allreduce_inter_nranks: int = 1
        self.sync_nccl_allreduce: bool = True
        self.fuse_grad_size_in_MB: int = 32
        # --- TPU-era extensions ---
        # ordered mesh axes, e.g. {"dp": -1} or {"dp": 2, "tp": 4}
        self.mesh_axes: Dict[str, int] = {}
        self.mesh = None  # pre-built parallel.Mesh (wins over mesh_axes)
        self.tensor_parallel: bool = False
        # [(param-name regex, PartitionSpec tuple)]
        self.tensor_parallel_rules: List[Tuple[str, tuple]] = []
        self.sequence_parallel: bool = False
        # shard moe_ffn expert weights over the "ep" mesh axis (GSPMD
        # inserts the dispatch/combine all-to-alls); see ops/moe_ops.py
        self.expert_parallel: bool = False

    def __repr__(self):
        on = [
            k for k, v in vars(self).items()
            if isinstance(v, bool) and v
        ]
        return f"DistributedStrategy(enabled={on}, mesh_axes={self.mesh_axes})"
