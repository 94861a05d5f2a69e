"""Paged KV cache — a preallocated device-memory block pool for the
serving engine (the port of the JAX package's ``inference/kv_cache.py``).

The pool carves two device tensors (keys and values, all layers) into
fixed-size *pages* of ``page_size`` token positions each and hands out
pages to decode requests:

* layout is flat per layer: ``[n_layers, n_pages * page_size, kv_heads,
  head_dim]`` so a logical position maps to device row
  ``page_id * page_size + offset`` — the decode step gathers/scatters by
  flat row index and the paged-attention kernel chases page ids.
* physical page 0 is reserved as a **trash page**: dead batch slots and
  padded positions write there, so scatter indices never need masking.
* pages are refcounted.  ``free`` drops a reference; a zero-ref page
  returns to the free list unless it is hash-registered as a cached
  prompt prefix, in which case it parks in an LRU side pool and is
  reclaimed lazily when allocation pressure needs it.
* **prefix cache**: full pages of a prompt are registered under a
  page-granular rolling hash (``_page_hash`` chains the parent page's
  hash with the page's token tuple).  ``match_prefix`` walks a new
  prompt page-by-page, verifying both the hash chain and the stored
  token tuple + parent id — a hash collision therefore degrades to a
  miss, never to wrong KV reuse (tests monkeypatch ``_page_hash`` to a
  constant to prove it).
* **copy-on-write**: matched pages may be shared by many requests.  A
  writer that must touch a shared or cached page calls
  ``ensure_private`` first, which hands back a fresh page id and tells
  the caller to copy the payload — the engine issues the device copy.

Sizing: ``from_budget`` takes the page size from its argument, then
``PADDLE_SERVE_KV_PAGE_SIZE``, then 16 (the JAX package's autotuner
lookup picks a TPU VMEM tile and has no counterpart here), and fits the
page count into the ``PADDLE_HBM_BUDGET_BYTES`` envelope when none is
given.  The pool registers a ``kv_pool`` section on /memz so residency
shows up next to the allocator stats.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ENV_KV_PAGES = "PADDLE_SERVE_KV_PAGES"
ENV_KV_PAGE_SIZE = "PADDLE_SERVE_KV_PAGE_SIZE"
ENV_KV_BUDGET_FRAC = "PADDLE_SERVE_KV_BUDGET_FRAC"

_DEFAULT_PAGES = 64
_DEFAULT_PAGE_SIZE = 16


def _page_hash(parent_hash: Optional[int], tokens: Tuple[int, ...]) -> int:
    """Rolling page hash: chain the parent page's hash with this page's
    token tuple.  Module-level so tests can monkeypatch it to force
    collisions; collision *correctness* comes from the token-tuple
    verification in match_prefix, not from hash quality."""
    h = 1469598103934665603 if parent_hash is None else parent_hash
    for t in tokens:
        h = ((h ^ (int(t) & 0xFFFFFFFF)) * 1099511628211) & (2 ** 64 - 1)
    return h


class PagedKVPool:
    """Page accounting + the device-resident KV tensors.

    The engine hands ``self.k`` / ``self.v`` to the decode step, which
    writes the new rows IN PLACE (no functional copy of the pool per
    step), and stores what it gets back via ``set_arrays`` — the pool
    itself launches no device work beyond allocating its tensors.
    """

    def __init__(self, *, n_pages: int, page_size: int, n_layers: int,
                 kv_heads: int, head_dim: int, dtype="float32",
                 allocate: bool = True, device=None):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is reserved)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_layers = int(n_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = np.dtype(dtype)
        self.device = device
        self._lock = threading.RLock()
        # page 0 = trash; ids 1..n_pages-1 allocatable
        self._free: List[int] = list(range(1, self.n_pages))
        self._ref: Dict[int, int] = {}
        # prefix cache: chained hash -> pid; pid -> (parent_pid, tokens)
        self._hash_to_pid: Dict[int, int] = {}
        self._page_meta: Dict[int, Tuple[Optional[int], Tuple[int, ...]]] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, ref==0
        self.prefix_hits = 0          # pages reused from the cache
        self.prefix_misses = 0        # pages walked without a hit
        self.collisions = 0           # hash hit, token verify failed
        self.cow_copies = 0
        self.k = None
        self.v = None
        if allocate:
            self._allocate_arrays()
        self._register_telemetry()

    # -- device arrays ------------------------------------------------

    def _allocate_arrays(self) -> None:
        import torch

        from .. import resolve_device

        self.device = resolve_device(self.device)
        shape = (self.n_layers, self.n_pages * self.page_size,
                 self.kv_heads, self.head_dim)
        dt = getattr(torch, self.dtype.name)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)

    def set_arrays(self, k, v) -> None:
        """Keep the tensors given (the decode step's in-place updates
        usually hand back the pool's own tensors)."""
        self.k, self.v = k, v

    @property
    def bytes_total(self) -> int:
        return (2 * self.n_layers * self.n_pages * self.page_size
                * self.kv_heads * self.head_dim * self.dtype.itemsize)

    @classmethod
    def from_budget(cls, *, n_layers: int, kv_heads: int, head_dim: int,
                    dtype="float32", page_size: Optional[int] = None,
                    n_pages: Optional[int] = None, **kw) -> "PagedKVPool":
        """Size the pool from the serving envs, falling back to a
        fraction of the PADDLE_HBM_BUDGET_BYTES budget when no explicit
        page count is given; /memz carries the pool section.  The page
        size comes from the argument, then the env, then the default."""
        page_size = int(page_size or os.environ.get(
            ENV_KV_PAGE_SIZE, _DEFAULT_PAGE_SIZE))
        if n_pages is None and os.environ.get(ENV_KV_PAGES):
            n_pages = int(os.environ[ENV_KV_PAGES])
        if n_pages is None:
            from ..telemetry.memory import hbm_budget_bytes

            budget = hbm_budget_bytes()
            if budget:
                frac = float(os.environ.get(ENV_KV_BUDGET_FRAC, "0.3"))
                page_bytes = (2 * n_layers * page_size * kv_heads
                              * head_dim * np.dtype(dtype).itemsize)
                n_pages = max(2, int(budget * frac) // max(1, page_bytes))
        n_pages = int(n_pages or _DEFAULT_PAGES)
        return cls(n_pages=n_pages, page_size=page_size,
                   n_layers=n_layers, kv_heads=kv_heads,
                   head_dim=head_dim, dtype=dtype, **kw)

    # -- allocation ---------------------------------------------------

    def available(self) -> int:
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    def _reclaim_one(self) -> bool:
        """Evict the least-recently-parked cached prefix page back to
        the free list (dropping its hash registration)."""
        if not self._cached:
            return False
        pid, _ = self._cached.popitem(last=False)
        self._unregister(pid)
        self._ref.pop(pid, None)
        self._free.append(pid)
        return True

    def _unregister(self, pid: int) -> None:
        meta = self._page_meta.pop(pid, None)
        if meta is not None:
            parent, tokens = meta
            parent_h = (self._chain_hash_of(parent)
                        if parent is not None else None)
            h = _page_hash(parent_h, tokens)
            if self._hash_to_pid.get(h) == pid:
                del self._hash_to_pid[h]

    def _chain_hash_of(self, pid: int) -> Optional[int]:
        meta = self._page_meta.get(pid)
        if meta is None:
            return None
        parent, tokens = meta
        parent_h = self._chain_hash_of(parent) if parent is not None else None
        return _page_hash(parent_h, tokens)

    def alloc(self, n: int) -> List[int]:
        """Take n pages (refcount 1 each); raises MemoryError when the
        pool cannot satisfy the request even after reclaiming cached
        prefix pages."""
        with self._lock:
            while len(self._free) < n and self._reclaim_one():
                pass
            if len(self._free) < n:
                raise MemoryError(
                    f"kv pool exhausted: want {n} pages, "
                    f"{len(self._free)} free of {self.capacity}")
            pids = [self._free.pop() for _ in range(n)]
            for p in pids:
                self._ref[p] = 1
            return pids

    def incref(self, pids: Sequence[int]) -> None:
        with self._lock:
            for p in pids:
                if p in self._cached:
                    del self._cached[p]
                self._ref[p] = self._ref.get(p, 0) + 1

    def free(self, pids: Sequence[int]) -> None:
        with self._lock:
            for p in pids:
                r = self._ref.get(p, 0) - 1
                if r > 0:
                    self._ref[p] = r
                    continue
                self._ref.pop(p, None)
                if p in self._page_meta:   # cached prefix: park in LRU
                    self._cached[p] = None
                    self._cached.move_to_end(p)
                else:
                    self._free.append(p)

    def refcount(self, pid: int) -> int:
        with self._lock:
            return self._ref.get(pid, 0)

    # -- prefix cache -------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page chain matching ``tokens``.  Returns the
        matched physical page ids (each increffed for the caller) and
        the token count they cover.  Only whole pages are shared."""
        psz = self.page_size
        matched: List[int] = []
        with self._lock:
            parent: Optional[int] = None
            parent_h: Optional[int] = None
            for i in range(len(tokens) // psz):
                page_toks = tuple(int(t) for t in tokens[i * psz:(i + 1) * psz])
                h = _page_hash(parent_h, page_toks)
                pid = self._hash_to_pid.get(h)
                if pid is None:
                    self.prefix_misses += 1
                    break
                meta = self._page_meta.get(pid)
                if meta != (parent, page_toks):
                    self.collisions += 1
                    break
                matched.append(pid)
                self.prefix_hits += 1
                parent, parent_h = pid, h
            self.incref(matched)
        return matched, len(matched) * psz

    def register_prefix(self, tokens: Sequence[int],
                        pids: Sequence[int]) -> None:
        """Record every full page of ``tokens`` (held in ``pids``, one
        id per page in order) in the prefix cache.  First writer wins on
        a hash slot; re-registration of an identical chain is a no-op."""
        psz = self.page_size
        with self._lock:
            parent: Optional[int] = None
            parent_h: Optional[int] = None
            for i in range(min(len(pids), len(tokens) // psz)):
                page_toks = tuple(int(t) for t in tokens[i * psz:(i + 1) * psz])
                h = _page_hash(parent_h, page_toks)
                pid = int(pids[i])
                holder = self._hash_to_pid.get(h)
                if holder is None and pid not in self._page_meta:
                    self._hash_to_pid[h] = pid
                    self._page_meta[pid] = (parent, page_toks)
                    holder = pid
                elif holder is None:
                    break  # pid already registered under another chain
                if self._page_meta.get(holder) != (parent, page_toks):
                    break  # occupied slot holds a different chain
                parent, parent_h = holder, h

    def ensure_private(self, pid: int) -> Tuple[int, bool]:
        """Copy-on-write gate: returns (page id to write, needs_copy).
        A page referenced once and not hash-registered is private —
        write in place.  Otherwise allocate a fresh page, drop one ref
        on the shared page, and tell the caller to copy the payload."""
        with self._lock:
            if self._ref.get(pid, 0) <= 1 and pid not in self._page_meta:
                return pid, False
            new = self.alloc(1)[0]
            self.free([pid])
            self.cow_copies += 1
            return new, True

    # -- observability ------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            cached = len(self._cached)
            active = self.capacity - free - cached
            walked = self.prefix_hits + self.prefix_misses + self.collisions
            return {
                "n_pages": self.n_pages,
                "page_size": self.page_size,
                "pages_free": free,
                "pages_cached": cached,
                "pages_active": active,
                "residency": (active + cached) / max(1, self.capacity),
                "bytes_total": self.bytes_total,
                "prefix_hit_pages": self.prefix_hits,
                "prefix_miss_pages": self.prefix_misses,
                "prefix_collisions": self.collisions,
                "prefix_hit_rate": self.prefix_hits / max(1, walked),
                "cow_copies": self.cow_copies,
            }

    def _register_telemetry(self) -> None:
        try:
            from ..telemetry import get_registry
            from ..telemetry.memory import register_memz_section

            reg = get_registry()
            self._g_free = reg.gauge("kv_pool_pages", state="free")
            self._g_active = reg.gauge("kv_pool_pages", state="active")
            self._g_cached = reg.gauge("kv_pool_pages", state="cached")
            self._g_bytes = reg.gauge("kv_pool_bytes")
            self._g_bytes.set(float(self.bytes_total))
            register_memz_section("kv_pool", self.stats)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            self._g_free = self._g_active = self._g_cached = None

    def publish_gauges(self) -> None:
        if getattr(self, "_g_free", None) is None:
            return
        st = self.stats()
        self._g_free.set(float(st["pages_free"]))
        self._g_active.set(float(st["pages_active"]))
        self._g_cached.set(float(st["pages_cached"]))
