"""DistributeTranspiler: rewrite a program's embeddings onto the PS,
ported from the JAX package's ``fluid/transpiler.py``.

Parity surface: reference
python/paddle/fluid/transpiler/distribute_transpiler.py:545 (transpile)
and geo_sgd_transpiler.py. The reference slices EVERY parameter onto
pservers and rewrites gradients into send/recv pairs; here data
parallelism (fleet, collective all-reduce) distributes the dense
parameters, so the transpile targets exactly what the card cannot hold
— lookup tables bigger than (or destined for) host memory. Each
selected `lookup_table_v2` op becomes a `distributed_lookup_table` op
backed by a host table (distributed/ps.py): in-process for one trainer,
hosted in pserver processes (distributed/ps_server.py) when endpoints
are given — the same `pservers=`/`trainers=`/`sync_mode=` contract as
the reference's transpile call.

Contract difference (deliberate): transpile runs BEFORE minimize. The
reference transpiles the fully-built program because it must rewrite
the backward's send/recv; here the PS push IS the lookup op's backward,
so the rewrite must happen before append_backward creates dense W
gradients. Transpiling a program that already has gradient or
optimizer ops on a selected table raises with this explanation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from . import framework
from .initializer import ConstantInitializer


@dataclasses.dataclass
class DistributeTranspilerConfig:
    """Reference transpiler config surface (distribute_transpiler.py
    DistributeTranspilerConfig + geo fields). Unused reference knobs
    (slice_var_up/min_block_size — block slicing is the server's
    num_shards here) are accepted for parity."""

    slice_var_up: bool = True
    min_block_size: int = 8192
    # "pserver" (sync/async per transpile arg) or "geo"
    mode: str = "pserver"
    geo_sgd_need_push_nums: int = 100
    # only lookup tables with at least this many rows move to the PS
    # (0 = every lookup table; the reference moves everything)
    min_rows_for_ps: int = 0
    # server-side optimizer for pushed gradients (host PS supports the
    # reference pserver optimizer block equivalents sgd/adagrad)
    server_optimizer: str = "sgd"
    server_learning_rate: float = 0.1


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self.tables: List[str] = []

    def transpile(self, trainer_id, program=None, pservers="",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint=""):
        """Rewrite `program`'s lookup tables onto the parameter server
        (reference transpile:545 signature). pservers: comma-separated
        endpoints ("" = in-process table). Returns the table names."""
        from ..distributed import ps

        program = program or framework.default_main_program()
        startup = startup_program or framework.default_startup_program()
        cfg = self.config
        endpoints = [e.strip() for e in pservers.split(",") if e.strip()]
        mode = "geo" if cfg.mode == "geo" else (
            "sync" if sync_mode else "async")

        # scan EVERY block: lookup ops inside While/cond sub-blocks (the
        # NMT decoder pattern) must move too — a silently-skipped giant
        # table would defeat the feature's purpose. Targets group by
        # parameter: tied embeddings (one W, several lookup ops) get ONE
        # table and every op rewritten.
        by_param = {}
        for blk in program.blocks:
            for op in blk.ops:
                if op.type not in ("lookup_table", "lookup_table_v2"):
                    continue
                w_name = op.input("W")[0]
                w = blk._find_var_recursive(w_name)
                if w is None or not isinstance(w, framework.Parameter):
                    continue
                if int(w.shape[0]) < cfg.min_rows_for_ps:
                    continue
                if op.type == "lookup_table":
                    raise NotImplementedError(
                        f"DistributeTranspiler: {w_name!r} is consumed "
                        f"by a v1 lookup_table op whose ids carry a "
                        f"trailing [,1] dim the op strips internally; "
                        f"distributed_lookup_table returns "
                        f"ids.shape+(dim,), which would change the "
                        f"output rank. Use layers.embedding "
                        f"(lookup_table_v2) or squeeze the ids")
                if int(op.attr("padding_idx", -1)) >= 0:
                    raise NotImplementedError(
                        f"DistributeTranspiler: {w_name!r} uses "
                        f"padding_idx; the host table has no padding-row "
                        f"masking (pad rows would train as normal rows). "
                        f"Remap pad ids out of the lookup instead")
                by_param.setdefault(w.name, (w, []))[1].append((blk, op))

        for w, _ops in by_param.values():
            for blk in program.blocks:
                self._check_untouched(blk, w)

        for w, ops in by_param.values():
            kw = {}
            if cfg.mode == "geo":
                kw["geo_sync_steps"] = cfg.geo_sgd_need_push_nums
            kw.update(self._init_kwargs(startup, w))
            ps.create_table(
                w.name, shape=tuple(w.shape), mode=mode,
                num_trainers=int(trainers) if str(trainers).isdigit()
                else None,
                endpoints=endpoints or None,
                optimizer=cfg.server_optimizer,
                learning_rate=cfg.server_learning_rate,
                **kw,
            )
            anchor = self._make_anchor(program, startup, w)
            for blk, op in ops:
                self._rewrite_lookup(blk, op, w, anchor)
            self._drop_param(program, startup, w)
            self.tables.append(w.name)
        from .flags import flag

        if flag("FLAGS_program_verify"):
            # cross-program lint of the transpile result: every
            # distributed_lookup_table op must name a registered table
            # whose embedding dim matches the program's output var —
            # catches a stale table left by a previous transpile at
            # transpile time instead of as wrongly-sized rows mid-step
            from .analysis import assert_pair_valid

            assert_pair_valid(
                program, where="DistributeTranspiler.transpile "
                               "(FLAGS_program_verify)")
        return list(self.tables)

    # -- surgery ---------------------------------------------------------

    @staticmethod
    def _check_untouched(block, w):
        grad_name = w.name + "@GRAD"
        for op in block.ops:
            names = [n for ns in list(op.inputs.values())
                     + list(op.outputs.values()) for n in ns]
            if grad_name in names or (
                op.type.endswith("_grad") and w.name in names
            ) or (
                "Param" in op.inputs and op.input("Param")[0] == w.name
            ):
                raise RuntimeError(
                    f"DistributeTranspiler: table {w.name!r} already has "
                    f"gradient/optimizer ops ({op.type}); on this stack "
                    f"the PS push is the lookup op's backward, so transpile "
                    f"must run BEFORE minimize/append_backward "
                    f"(reference order differs because it rewrites "
                    f"send/recv into an already-built backward)")

    @staticmethod
    def _init_kwargs(startup, w):
        """Carry W's initializer into the host table where the form maps
        (gaussian std/seed — the embedding norm everywhere in this
        repo); other initializers cannot be reproduced server-side, so
        their loss is SURFACED as a warning rather than silent."""
        import warnings

        for o in startup.global_block().ops:
            if w.name not in [n for ns in o.outputs.values() for n in ns]:
                continue
            if o.type == "gaussian_random":
                return {
                    "initializer_std": float(o.attr("std", 1.0)),
                    "seed": int(o.attr("seed", 0)),
                }
            warnings.warn(
                f"DistributeTranspiler: table {w.name!r} was initialized "
                f"by {o.type!r}, which the host table cannot reproduce — "
                f"it will use its default normal(0, 1/sqrt(dim)) init. "
                f"Load pretrained rows via "
                f"ps.get_table({w.name!r}).load_state_dict(...) if the "
                f"init matters", RuntimeWarning, stacklevel=4)
            return {}
        return {}

    @staticmethod
    def _make_anchor(program, startup, w):
        """(1,) zero Parameter routing autodiff into the lookup op
        (same pattern as layers.distributed_embedding)."""
        from . import unique_name

        anchor_name = unique_name.generate(f"{w.name}_anchor")
        program.global_block().create_parameter(
            name=anchor_name, shape=[1], dtype="float32", trainable=True)
        sblock = startup.global_block()
        sv = sblock.create_var(name=anchor_name, shape=(1,),
                               dtype="float32", persistable=True)
        ConstantInitializer(0.0)(sv, sblock)
        return anchor_name

    @staticmethod
    def _rewrite_lookup(block, op, w, anchor_name):
        """lookup_table_v2(W, Ids) -> distributed_lookup_table(Ids,
        anchor); W leaves the device program entirely (its storage now
        lives in the host/pserver table)."""
        out = op.output("Out")[0]
        op.type = "distributed_lookup_table"
        op.inputs = {"Ids": [op.input("Ids")[0]], "W": [anchor_name]}
        op.outputs = {"Outputs": [out]}
        op.attrs = {"table_names": [w.name]}

    @staticmethod
    def _drop_param(program, startup, w):
        sblock = startup.global_block()
        sops = [o for o in sblock.ops
                if w.name in [n for ns in o.outputs.values() for n in ns]]
        for o in sops:
            sblock.ops.remove(o)
        for blk in list(program.blocks) + [sblock]:
            blk.vars.pop(w.name, None)
        # in-place op mutation bypasses append_op's version bump; the
        # executor's compile cache must see a new program version
        program._bump_version()
        startup._bump_version()


def get_transpiler(config=None):
    return DistributeTranspiler(config)
