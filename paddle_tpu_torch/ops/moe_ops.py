"""Mixture-of-Experts FFN op (``moe_ffn``) and its expert parallelism.

Ported from the JAX package's ``ops/moe_ops.py``: a top-k router, a
capacity-bounded dispatch and combine in GShard order, a two-layer FFN
per expert, and the Switch load-balancing loss.

  X      [B, S, H]   tokens
  GateW  [H, E]      router weights
  W1     [E, H, F]   expert up-projection;   B1 [E, F]
  W2     [E, F, H]   expert down-projection; B2 [E, H]
  ->
  Out     [B, S, H]  combined expert outputs (a token over capacity gets
                     0 from the expert path; callers keep the residual)
  AuxLoss []         E * sum_e f_e * P_e (1.0 when perfectly balanced)

Routing runs in float32; the expert products in the input dtype,
promoted with the weights' as ``jnp.einsum`` promotes (bf16 tokens and
f32 weights: f32 products of bf16-rounded tokens, a bf16-rounded gate).

The JAX package writes the dispatch and combine as einsums over a dense
[T, E, C] one-hot.  Each (expert, slot) position holds at most one token
and the FFN is row-wise, so the port gathers the kept rows into the
[E, C, H] expert input, runs the experts as two batched products, and
adds each token's k gate-weighted rows back: the einsums' values, with
only the order of a token's k terms free.  A top-2 token's two terms add
in either order to the same float.

The op is defined on the global batch (the JAX package's GSPMD sees it
whole).  A data-parallel rank holds B/dp rows, so under a mesh it
counts the global capacity ``ceil(k * T_global / E * factor)``, places
its tokens behind the lower data shards' (an exclusive prefix over the
data axes of each slot's per-expert counts: one all-gather of [k, E]),
and takes the aux loss's f_e and P_e as global means.  P_e's sum is an
all-reduce whose backward sums the cotangent over the data axes, so the
gradient the data-parallel mean gives is the global loss's.  Inside the
executor's manual (dcn, dp) path the JAX package runs the op per shard,
and so does the port.

Expert parallelism (``fleet.apply_expert_parallel``): a rank holds the
block of E/ep experts its "ep" coordinate names (W1/B1/W2/B2 sharded on
dim 0) while the tokens and the router stay whole on every rank of the
axis (the feeds shard over "dp" only).  The ep ranks of a data shard
route alike; each runs only its own experts.  The tokens and the k
combine weights enter that part through Megatron's f
(``distributed.copy_to_region``: the identity, whose backward sums the
cotangent over "ep") and the partial outputs leave it through g
(``reduce_from_region``: the sum over "ep", whose backward is the
identity).  So every replicated input (X, GateW) gets its whole gradient
on each ep rank, and each expert block its own.  Recognised by the
shapes: W1 holding fewer experts than GateW routes to.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-expert capacity: ceil(top_k * T / E * factor)."""
    return max(1, int(math.ceil(top_k * num_tokens / num_experts
                                * capacity_factor)))


def _activation(name: str):
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu, "silu": F.silu, "swish": F.silu,
            "tanh": torch.tanh}[name]


def _route(probs, top_k: int):
    """Slot by slot: each slot's expert (argmax, first index on a tie, as
    ``jnp.argmax``) with earlier picks masked, and its gate; top-1 keeps
    the raw router probability, top-k > 1 normalises the k gates."""
    e = probs.shape[-1]
    remaining = probs
    idx, gates = [], []
    for _ in range(top_k):
        i = torch.argmax(remaining, dim=-1)
        oh = F.one_hot(i, e).to(probs.dtype)
        idx.append(i)
        gates.append((remaining * oh).sum(-1))
        remaining = remaining * (1.0 - oh)
    if top_k > 1:
        denom = sum(gates)
        gates = [g / torch.clamp_min(denom, 1e-9) for g in gates]
    return idx, gates


def _data_axes(ctx):
    """The mesh axes that split the batch, for the global routing; none
    without a mesh and inside the manual (dcn, dp) path."""
    mesh = ctx.mesh
    if mesh is None or getattr(ctx, "manual_axes", ()):
        return mesh, []
    return mesh, [a for a in mesh.data_axes if mesh.shape[a] > 1]


def _gather_counts(counts, mesh, axes):
    """[n_shards, k, E]: every data shard's per-slot expert counts, in
    shard order (row-major over ``axes``)."""
    from .. import distributed as dist

    out = counts[None]
    for a in reversed(axes):
        out = dist.all_gather(out, a, 0, mesh)
    return out


def _sum_over(x, mesh, axes):
    from .. import distributed as dist

    for a in axes:
        x = dist.all_reduce(x, "sum", a, mesh)
    return x


def _out_dtypes(x, w1, b1, w2, b2):
    dt1 = torch.promote_types(torch.promote_types(x.dtype, w1.dtype),
                              b1.dtype)
    dt2 = torch.promote_types(torch.promote_types(dt1, w2.dtype), b2.dtype)
    return dt1, dt2, torch.promote_types(x.dtype, dt2)


@register("moe_ffn")
def moe_ffn(ctx, ins, attrs):
    from .. import distributed as dist

    x = ins["X"][0]
    gate_w = ins["GateW"][0]
    w1, b1 = ins["W1"][0], ins["B1"][0]
    w2, b2 = ins["W2"][0], ins["B2"][0]
    top_k = int(attrs.get("top_k", 2))
    capacity_factor = float(attrs.get("capacity_factor", 1.25))
    act = _activation(str(attrs.get("activation", "gelu")))

    b, s, h = x.shape
    e = gate_w.shape[-1]
    e_loc = w1.shape[0]
    dt1, dt2, dt_out = _out_dtypes(x, w1, b1, w2, b2)
    if x.device.type == "meta":
        return {"Out": [x.new_empty((b, s, h), dtype=dt_out)],
                "AuxLoss": [x.new_empty((), dtype=torch.float32)]}
    mesh, data_axes = _data_axes(ctx)
    n_data = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1
    ep = e // e_loc
    if ep > 1 and (mesh is None or mesh.shape.get("ep", 1) != ep):
        raise ValueError(
            f"moe_ffn: W1 holds {e_loc} of the {e} experts GateW routes "
            f"to, and the mesh has no 'ep' axis of size {ep}")
    e0 = mesh.coords["ep"] * e_loc if ep > 1 else 0

    t = b * s
    t_global = t * n_data
    cap = moe_capacity(t_global, e, top_k, capacity_factor)
    x2 = x.reshape(t, h)

    # ---- router (float32) ---------------------------------------------
    logits = x2.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    idx, gates = _route(probs, top_k)

    # ---- global positions, slot 0 first (GShard order) ----------------
    with torch.no_grad():
        ohs = [F.one_hot(i, e) for i in idx]               # [T, E] int64
        counts = torch.stack([oh.sum(0) for oh in ohs])    # [k, E]
        if data_axes:
            every = _gather_counts(counts, mesh, data_axes)
            mine = mesh.shard_index(data_axes)
            prefix = every[:mine].sum(0)
            totals = every.sum(0)
        else:
            prefix = torch.zeros_like(counts)
            totals = counts
        before = torch.cumsum(totals, 0) - totals           # earlier slots
        slots = []
        dump = e_loc * cap
        for j, (i, oh) in enumerate(zip(idx, ohs)):
            local = (torch.cumsum(oh, 0) - oh).gather(1, i[:, None])[:, 0]
            pos = local + prefix[j][i] + before[j][i]
            keep = pos < cap
            loc = i - e0
            mine_j = keep & (loc >= 0) & (loc < e_loc)
            slots.append(torch.where(mine_j, loc * cap + pos,
                                     torch.full_like(pos, dump)))
        # the token each (expert, position) holds; t (a zero row) if none
        tok = torch.full((dump + 1,), t, dtype=torch.long, device=x.device)
        ar = torch.arange(t, device=x.device)
        for sl in slots:
            tok.scatter_(0, sl, ar)
        tok = tok[:dump]

    # ---- the local experts (input dtype, promoted with the weights) ----
    gate_k = torch.stack(gates, dim=1)                      # [T, k] f32
    xe, ge = x2, gate_k
    if ep > 1:
        xe = dist.copy_to_region(x2, "ep", mesh)
        ge = dist.copy_to_region(gate_k, "ep", mesh)
    x_pad = torch.cat([xe, xe.new_zeros((1, h))])
    expert_in = x_pad[tok].reshape(e_loc, cap, h)
    h1 = act(torch.bmm(expert_in.to(dt1), w1.to(dt1))
             + b1.to(dt1)[:, None, :])
    eout = (torch.bmm(h1.to(dt2), w2.to(dt2))
            + b2.to(dt2)[:, None, :]).reshape(e_loc * cap, h)
    eout_pad = torch.cat([eout, eout.new_zeros((1, h))])
    out = None
    for j, sl in enumerate(slots):
        g = ge[:, j].to(x.dtype).float()[:, None]
        term = g * eout_pad[sl].float()
        out = term if out is None else out + term
    out = out.to(dt_out)
    if ep > 1:
        out = dist.reduce_from_region(out, "ep", mesh)

    # ---- Switch load-balancing loss (global means) ---------------------
    frac = totals[0].float() / t_global
    mean_prob = probs.sum(0)
    if data_axes:
        mean_prob = _sum_over(mean_prob, mesh, data_axes)
    aux = e * torch.sum(frac * (mean_prob / t_global))

    return {"Out": [out.reshape(b, s, h)], "AuxLoss": [aux.float()]}
