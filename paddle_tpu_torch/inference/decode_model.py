"""An autoregressive decoder LM with a paged KV decode path — the port of
the JAX package's ``inference/decode_model.py``.

Embedding + learned positions + pre-LN transformer blocks + an untied
head, greedy argmax.  Same parameter dict (``init_params`` draws the
same numpy weights for the same seed) and the same entry points:

* ``prefill``       — one request's prompt window attends over its
  (page-gathered) cached context plus itself causally; returns the
  next-token logits and the window's per-layer K/V for scattering into
  pool pages.  The engine pads the window to ``prefill_bucket`` rows.
* ``decode_step``   — the continuous-batching inner loop: [slots] query
  tokens, each attending over its page table through the paged-attention
  kernel.  New K/V are written into the pool *before* attention (dead
  slots write to trash page 0), so lengths = position + 1.
* ``recompute_step`` — the padded baseline: re-run the whole dense
  prefix for every generated token.  The ``PADDLE_SERVE_KV_CACHE=0``
  path and the oracle the cached path is tested against.

Pool writes (``scatter_kv``, ``copy_page``, ``decode_step``) update the
pool tensors IN PLACE and return them, where the JAX package returns new
arrays: a functional copy of a 0.6 GB pool per token would cost more
than the step.  Large products stay ``@`` (cuBLAS), as the JAX package
left them to XLA; prefill attention is dense tensor code.  Only the
decode step's attention is a hand-written kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.kernels.paged_attention import paged_attention

_LN_EPS = 1e-5
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab: int = 64
    d_model: int = 32
    n_layers: int = 2
    n_heads: int = 2
    ffn: int = 64
    max_seq: int = 64

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def init_params(cfg: DecoderConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p: Dict[str, np.ndarray] = {
        "embed": w(cfg.vocab, cfg.d_model, scale=0.1),
        "pos": w(cfg.max_seq, cfg.d_model, scale=0.1),
        "lnf_g": np.ones(cfg.d_model, np.float32),
        "lnf_b": np.zeros(cfg.d_model, np.float32),
        "head": w(cfg.d_model, cfg.vocab, scale=0.1),
    }
    for i in range(cfg.n_layers):
        p[f"l{i}.ln1_g"] = np.ones(cfg.d_model, np.float32)
        p[f"l{i}.ln1_b"] = np.zeros(cfg.d_model, np.float32)
        p[f"l{i}.ln2_g"] = np.ones(cfg.d_model, np.float32)
        p[f"l{i}.ln2_b"] = np.zeros(cfg.d_model, np.float32)
        for nm in ("wq", "wk", "wv", "wo"):
            p[f"l{i}.{nm}"] = w(cfg.d_model, cfg.d_model)
        p[f"l{i}.w1"] = w(cfg.d_model, cfg.ffn)
        p[f"l{i}.b1"] = np.zeros(cfg.ffn, np.float32)
        p[f"l{i}.w2"] = w(cfg.ffn, cfg.d_model)
        p[f"l{i}.b2"] = np.zeros(cfg.d_model, np.float32)
    return p


def params_from_numpy(np_params, device, dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The parameter dict as tensors on ``device``.  Takes numpy arrays
    (the JAX package's params via ``np.asarray``) or tensors, and always
    copies: the model never shares storage with the caller's arrays."""
    def one(v):
        if torch.is_tensor(v):
            return v.to(device=device, dtype=dtype, copy=True)
        return torch.from_numpy(np.array(v)).to(device=device, dtype=dtype)

    return {k: one(v) for k, v in np_params.items()}


def _ln(x, g, b):
    # biased variance, eps inside the rsqrt (as the reference)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def _n_layers(params) -> int:
    i = 0
    while f"l{i}.wq" in params:
        i += 1
    return i


def _qkv(params, i, h, n_heads):
    d = h.shape[-1]
    hd = d // n_heads
    q = (h @ params[f"l{i}.wq"]).reshape(*h.shape[:-1], n_heads, hd)
    k = (h @ params[f"l{i}.wk"]).reshape(*h.shape[:-1], n_heads, hd)
    v = (h @ params[f"l{i}.wv"]).reshape(*h.shape[:-1], n_heads, hd)
    return q, k, v


def _mlp(params, i, x):
    h = _ln(x, params[f"l{i}.ln2_g"], params[f"l{i}.ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h @ params[f"l{i}.w1"] + params[f"l{i}.b1"],
               approximate="tanh")
    return x + h @ params[f"l{i}.w2"] + params[f"l{i}.b2"]


def _embed(params, tokens, pos):
    """Token + clamped learned position embeddings."""
    max_pos = params["pos"].shape[0] - 1
    return (params["embed"][tokens.long()]
            + params["pos"][pos.long().clamp(max=max_pos)])


# ---------------------------------------------------------------------------
# prefill: one request window over gathered context
# ---------------------------------------------------------------------------


def prefill(params, tokens, start, ctx_k, ctx_v, n_valid, *, n_heads):
    """One request's prompt window.

    tokens:  [R] window token ids (padded past n_valid).
    start:   int — absolute position of tokens[0] (== number of context
             positions reused from the prefix cache).
    ctx_k/v: [L, C, H, hd] gathered cached context (only the first
             ``start`` rows are live).
    n_valid: int — live rows in the window (>= 1).

    Returns (next_logits [V], next_token, k_win [L, R, H, hd], v_win).
    """
    start, n_valid = int(start), int(n_valid)
    dev = ctx_k.device
    r = tokens.shape[0]
    c = ctx_k.shape[1]
    hd = ctx_k.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    pos = start + torch.arange(r, device=dev)
    x = _embed(params, tokens, pos)
    ctx_live = (torch.arange(c, device=dev) < start)[None, None, :]
    ar = torch.arange(r, device=dev)
    causal = (ar[:, None] >= ar[None, :])[None]                  # [1,R,R]
    ks, vs = [], []
    for i in range(_n_layers(params)):
        h = _ln(x, params[f"l{i}.ln1_g"], params[f"l{i}.ln1_b"])
        q, k, v = _qkv(params, i, h, n_heads)                # [R, H, hd]
        s_ctx = torch.einsum("rhd,chd->hrc", q, ctx_k[i]) * scale
        s_win = torch.einsum("rhd,shd->hrs", q, k) * scale
        # masked context and causal window under ONE softmax
        s = torch.cat([torch.where(ctx_live, s_ctx, _NEG_INF),
                       torch.where(causal, s_win, _NEG_INF)], dim=-1)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        p = p / p.sum(dim=-1, keepdim=True)
        out = (torch.einsum("hrc,chd->rhd", p[..., :c], ctx_v[i])
               + torch.einsum("hrs,shd->rhd", p[..., c:], v))
        x = x + out.reshape(r, -1) @ params[f"l{i}.wo"]
        x = _mlp(params, i, x)
        ks.append(k)
        vs.append(v)
    hfin = _ln(x[n_valid - 1], params["lnf_g"], params["lnf_b"])
    logits = hfin @ params["head"]
    return (logits, torch.argmax(logits).to(torch.int32),
            torch.stack(ks), torch.stack(vs))


def gather_ctx(k_flat, v_flat, page_table, *, page_size):
    """[L, N, H, hd] pool -> [L, maxp*page, H, hd] per-request context."""
    flat = (page_table.long()[:, None] * page_size
            + torch.arange(page_size, device=page_table.device)[None, :]
            ).reshape(-1)
    return k_flat[:, flat], v_flat[:, flat]


def scatter_kv(k_flat, v_flat, k_win, v_win, flat_idx):
    """Write a prefill window's K/V into pool rows (trash rows = 0), in
    place; returns the pool tensors."""
    idx = flat_idx.long()
    k_flat[:, idx] = k_win
    v_flat[:, idx] = v_win
    return k_flat, v_flat


def copy_page(k_flat, v_flat, src_pid, dst_pid, *, page_size):
    """COW payload copy: duplicate one physical page's rows, in place."""
    s, d = int(src_pid) * page_size, int(dst_pid) * page_size
    k_flat[:, d:d + page_size] = k_flat[:, s:s + page_size]
    v_flat[:, d:d + page_size] = v_flat[:, s:s + page_size]
    return k_flat, v_flat


# ---------------------------------------------------------------------------
# decode step: the continuous-batching inner loop
# ---------------------------------------------------------------------------


def decode_step(params, k_flat, v_flat, tokens, positions, page_table,
                write_flat, *, page_size, n_heads):
    """One token for every batch slot.

    tokens/positions: [B] current token + its absolute position (dead
    slots: token 0, position 0, write_flat 0 -> they read/write trash
    page 0 and their outputs are ignored by the engine).
    page_table: [B, maxp] int32 physical page per logical page.
    write_flat: [B] flat pool row for this step's K/V.

    New K/V are written BEFORE attention, so lengths = position + 1 and
    the token attends to itself through the pool — no cache merge.
    The pool tensors are updated in place and returned.
    """
    b = tokens.shape[0]
    n = k_flat.shape[1]
    hd = k_flat.shape[-1]
    lengths = (positions.to(torch.int32) + 1).contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    rows = write_flat.long()
    x = _embed(params, tokens, positions)
    for i in range(_n_layers(params)):
        h = _ln(x, params[f"l{i}.ln1_g"], params[f"l{i}.ln1_b"])
        q, k, v = _qkv(params, i, h, n_heads)                # [B, H, hd]
        k_flat[i, rows] = k
        v_flat[i, rows] = v
        k_pages = k_flat[i].view(n // page_size, page_size, n_heads, hd)
        v_pages = v_flat[i].view(n // page_size, page_size, n_heads, hd)
        out = paged_attention(q.contiguous(), k_pages, v_pages, page_table,
                              lengths)
        x = x + out.reshape(b, -1) @ params[f"l{i}.wo"]
        x = _mlp(params, i, x)
    hfin = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = hfin @ params["head"]
    return (logits, torch.argmax(logits, dim=-1).to(torch.int32),
            k_flat, v_flat)


# ---------------------------------------------------------------------------
# recompute baseline: dense re-prefill per generated token
# ---------------------------------------------------------------------------


def recompute_step(params, tokens, lengths, *, n_heads):
    """Dense causal forward over fixed [B, S]; logits at lengths-1.
    Dead slots pass lengths=1/zero tokens and ignore the output.  The
    head runs on the B selected rows only (the reference computes all
    [B, S, V] and then selects the same rows)."""
    b, s = tokens.shape
    dev = tokens.device
    scale = None
    pos = torch.arange(s, device=dev)
    x = _embed(params, tokens, pos[None, :])
    causal = (pos[:, None] >= pos[None, :])[None, None]     # [1,1,S,S]
    for i in range(_n_layers(params)):
        h = _ln(x, params[f"l{i}.ln1_g"], params[f"l{i}.ln1_b"])
        q, k, v = _qkv(params, i, h, n_heads)                # [B, S, H, hd]
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        sc = torch.einsum("brhd,bshd->bhrs", q, k) * scale
        sc = torch.where(causal, sc, _NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        p = p / p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhrs,bshd->brhd", p, v)
        x = x + out.reshape(b, s, -1) @ params[f"l{i}.wo"]
        x = _mlp(params, i, x)
    idx = (lengths.long() - 1).clamp(min=0)
    hsel = x[torch.arange(b, device=dev), idx]                # [B, d]
    logits = _ln(hsel, params["lnf_g"], params["lnf_b"]) @ params["head"]
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


def prefill_bucket(n: int, buckets_from: int = 8) -> int:
    """Window lengths are padded to power-of-two buckets."""
    b = buckets_from
    while b < n:
        b *= 2
    return b


class TinyDecoderLM:
    """Config + device params + the device the model runs on."""

    def __init__(self, cfg: DecoderConfig,
                 params: Optional[Dict[str, np.ndarray]] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params_from_numpy(
            params if params is not None else init_params(cfg, seed),
            self.device)

    def adopt(self, params: Dict[str, np.ndarray]) -> None:
        """Swap weights (epoch-fenced by the engine); shapes must match."""
        cur = self.params
        for k, v in params.items():
            if k not in cur:
                raise KeyError(f"unknown param {k!r}")
            shape = tuple(v.shape if torch.is_tensor(v) else np.shape(v))
            if tuple(cur[k].shape) != shape:
                raise ValueError(
                    f"shape mismatch for {k!r}: "
                    f"{shape} vs {tuple(cur[k].shape)}")
        self.params = {**cur, **params_from_numpy(params, self.device)}
