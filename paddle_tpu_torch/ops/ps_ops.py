"""distributed_lookup_table: the device <-> host parameter-server bridge,
ported from the JAX package's ``ops/ps_ops.py``.

Parity: reference operators/distributed_ops/distributed_lookup_table
(trainer side) + the pserver optimizer block it pairs with.  The table
never lives on the device (distributed/ps.py): the forward copies the
ids to the host, gathers their rows there and copies the rows to the
ids' device; the backward copies the rows' gradient to the host and
PUSHES it to the table, whose server applies its own optimizer
(``push_gradients``).  The program never materializes or differentiates
the table.

The op is a ``torch.autograd.Function``.  Its ``W`` input is a (1,)
zero anchor Parameter: autograd only reaches an op through a float
input that requires grad, and the ids are integers, so without the
anchor the backward (and with it the push) would never run.  The
anchor's gradient is identically zero.  Under the registry's primal
reuse the grad op pulls the captured forward's graph once, and without
it the generic grad re-runs the forward (a gather, no side effect) and
pulls once: either way one push per backward.

On the card each call costs a device-to-host copy of the ids, a
host-to-device copy of the rows and a device-to-host copy of their
gradient.  ``stats`` counts them; with ``TIMING`` on, each copy and
each host call is timed alone (the device is synchronized before it),
which is what ``chip_smoke.py``'s ``ps_train`` phase reads.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .registry import register

# with TIMING on, every copy and host call below synchronizes the device
# first and adds its wall ms to ``stats``; off, the op only counts calls
TIMING = False
_STAT_KEYS = ("lookups", "pushes", "d2h_ids_ms", "gather_ms", "h2d_ms",
              "d2h_grad_ms", "push_ms")
stats = dict.fromkeys(_STAT_KEYS, 0)


def reset_stats() -> None:
    for k in _STAT_KEYS:
        stats[k] = 0


class _Span:
    """Adds the wall ms of its body to ``stats[key]`` when TIMING is on,
    after synchronizing ``device`` (a CUDA device) so the span holds
    only its own work."""

    def __init__(self, key, device):
        self.key, self.device = key, device

    def __enter__(self):
        if TIMING:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if TIMING:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stats[self.key] += (time.perf_counter() - self.t0) * 1e3


def _host_ids(ids: torch.Tensor) -> np.ndarray:
    with _Span("d2h_ids_ms", ids.device):
        return ids.detach().reshape(-1).to("cpu", torch.int64).numpy()


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, anchor, table_name):
        from ..distributed import ps

        table = ps.get_table(table_name)
        host_ids = _host_ids(ids)
        with _Span("gather_ms", ids.device):
            rows = table.gather(host_ids)
        with _Span("h2d_ms", ids.device):
            out = torch.from_numpy(np.ascontiguousarray(rows)).to(ids.device)
        stats["lookups"] += 1
        ctx.table_name = table_name
        ctx.host_ids = host_ids
        ctx.dim = table.dim
        ctx.anchor_meta = (anchor.shape, anchor.dtype)
        return out.reshape(tuple(ids.shape) + (table.dim,))

    @staticmethod
    def backward(ctx, g):
        from ..distributed import ps

        with _Span("d2h_grad_ms", g.device):
            host_g = g.detach().reshape(-1, ctx.dim).to(
                "cpu", torch.float32).numpy()
        with _Span("push_ms", g.device):
            ps.get_table(ctx.table_name).push_gradients(ctx.host_ids, host_g)
        stats["pushes"] += 1
        shape, dtype = ctx.anchor_meta
        return None, torch.zeros(shape, dtype=dtype, device=g.device), None


def lookup(ids: torch.Tensor, anchor: torch.Tensor,
           table_name: str) -> torch.Tensor:
    """Rows of host table ``table_name`` for ``ids``, on the ids' device:
    [*ids.shape, dim] in the table's dtype.  Its backward pushes the
    rows' gradient to the table."""
    if ids.is_floating_point() or ids.is_complex():
        raise TypeError(f"distributed_lookup_table: ids must be integers, "
                        f"got {ids.dtype}")
    return _Lookup.apply(ids, anchor, table_name)


def _table_name(attrs) -> str:
    return (attrs["table_names"][0] if "table_names" in attrs
            else attrs["table_name"])


def _infer_lookup(in_metas, attrs):
    from ..distributed import ps

    table = ps.get_table(_table_name(attrs))
    shape = tuple(in_metas["Ids"][0][0])
    return {"Outputs": [(shape + (table.dim,), str(np.dtype(table.dtype)))]}


@register("distributed_lookup_table", infer_shape=_infer_lookup)
def distributed_lookup_table(ctx, ins, attrs):
    """Inputs: Ids [B,...] int; W — a (1,) zero anchor Parameter (the
    trainer-side stub: the backward's needs-grad walk seeds from
    Parameters, and the host table is NOT a program Parameter by design,
    so the anchor is what makes backward reach this op)."""
    ids = ins["Ids"][0]
    anchor = (ins["W"][0] if ins.get("W")
              else torch.zeros((1,), dtype=torch.float32, device=ids.device))
    return {"Outputs": [lookup(ids, anchor, _table_name(attrs))]}
