"""Continuous-batching generation engine — the port of the JAX
package's ``inference/engine.py``.

Where the RPC server's MicroBatcher coalesces whole requests into padded
micro-batches (every request enters and leaves together), this engine
schedules at *iteration* granularity: a single decode loop runs ONE
compiled step shape — ``max_slots`` batch slots x one token — and
requests join free slots at step boundaries, retire mid-loop the moment
they finish, and never force a retrace (slot occupancy changes the
*data*, not the shape; dead slots read/write the KV pool's trash page).

Modes, selected by ``PADDLE_SERVE_KV_CACHE`` (default on):

* **paged** — prompts prefill once into pool pages (with page-granular
  prefix-cache reuse), then every generated token is one fixed-shape
  ``decode_step`` attending over cached pages: O(1) positions of new
  work per token.
* **recompute** — the padded baseline: the whole prefix is
  re-run densely for every token (O(n) positions per token, O(n^2) per
  sequence).  Kept for the flag-off escape hatch and as the oracle the
  cached path is verified against.

Deterministic work accounting (`prefill_positions` / `decode_positions`
/ `recompute_positions`) lets tests assert the O(n)-per-sequence bound
without relying on wall-clock.  Admission, shedding, deadline and
epoch-fenced weight-swap semantics mirror server.MicroBatcher: the only
legal weight swap point is between decode steps, `Overloaded` /
`DeadlineExceeded` reply strings cross the RPC boundary verbatim, and
shed/expired wall-time is charged to the goodput ledger's serving
badput buckets.

Crash tolerance (gated on ``PADDLE_SERVE_RESUME``, default on):

* **resume admission** — `submit(resume_tokens=...)` re-admits a
  generation whose prefix (prompt + tokens already delivered) was
  computed elsewhere: the prefix prefills as one window (page-granular
  prefix-cache reuse makes the replayed prompt cheap), the SLO clock is
  backdated by ``elapsed_ms`` so failover never resets deadline
  accounting, and ``expect_epoch`` refuses a cross-epoch splice with
  the typed `ResumedOnNewWeights`.  Resumes queue ahead of fresh
  admissions — degrade by shedding new work before abandoning old work.
* **preemption ladder** — when a fresh request cannot be placed, the
  active request with the MOST remaining work is preempted (pages
  freed, tokens kept, same GenRequest requeued through the resume
  path) instead of the queue head deadline-starving.  A victim is only
  taken when it has strictly more remaining work than the incoming
  request, and resumes themselves never preempt — both rules together
  make the ladder livelock-free.  Preempt/resume wall-time latches
  into the goodput ledger's `serve_preempt`/`serve_resume` buckets.
* **sampling** — temperature/top-k/top-p ride the single `_emit` choke
  point (host-side, from the logits every step already returns); the
  per-request seed and the token INDEX feed a counter-mode PRNG, so a
  resumed sampled generation replays bit-identically. Top-p (nucleus)
  composes after top-k and, like top-k, is active only when a
  temperature is set — greedy requests stay on the device argmax.

Host-side scheduling is the JAX package's, line for line; the device
work is the port's ``decode_model`` on the model's torch device, where
each decode step runs the CUDA paged-attention kernel once per layer.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..distributed import faults as _faults
from ..telemetry import sink as _sink
from ..telemetry import tracing as _tracing
from . import decode_model as dm
from .kv_cache import PagedKVPool
from .server import (DeadlineExceeded, Overloaded, ResumedOnNewWeights,
                     resume_enabled)

ENV_KV_CACHE = "PADDLE_SERVE_KV_CACHE"
ENV_MAX_SLOTS = "PADDLE_SERVE_MAX_SLOTS"

_SERVE_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                  5000, 10000)


def kv_cache_enabled() -> bool:
    return os.environ.get(ENV_KV_CACHE, "1") not in ("0", "false", "off")


def _sample_token(logits: np.ndarray, temperature: float,
                  top_k: Optional[int], seed: int, index: int,
                  top_p: Optional[float] = None) -> int:
    """Deterministic temperature/top-k/top-p sampling at token ``index``.

    Counter-mode: the PRNG is keyed on (seed, index), never on call
    order or engine state — the token at index i depends only on the
    prefix (via logits) and the request seed, which is exactly what
    makes a resumed/preempted sampled generation replay the same
    tokens the uninterrupted run produced.

    Top-p (nucleus) filtering composes after top-k: the smallest set of
    highest-probability tokens whose cumulative mass reaches ``top_p``
    survives, the tail is zeroed, and the nucleus is renormalized. The
    sort is stable on descending probability so ties resolve by token
    id — the filter is a pure function of (logits, knobs), keeping the
    resume-replay contract bit-exact."""
    scores = np.asarray(logits, np.float64) / max(float(temperature),
                                                  1e-6)
    if top_k and 0 < int(top_k) < scores.size:
        kth = np.partition(scores, -int(top_k))[-int(top_k)]
        scores = np.where(scores >= kth, scores, -np.inf)
    scores -= scores.max()
    probs = np.exp(scores)
    probs /= probs.sum()
    if top_p is not None and 0.0 < float(top_p) < 1.0:
        order = np.argsort(-probs, kind="stable")
        csum = np.cumsum(probs[order])
        # smallest prefix whose mass >= top_p (always >= 1 token)
        cut = int(np.searchsorted(csum, float(top_p))) + 1
        keep = order[:cut]
        mask = np.zeros_like(probs)
        mask[keep] = probs[keep]
        probs = mask / mask.sum()
    rng = np.random.default_rng(
        [int(seed) & 0xFFFFFFFF, int(index) & 0xFFFFFFFF])
    return int(rng.choice(scores.size, p=probs))


class GenRequest:
    """One admitted generation request."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "deadline_t",
                 "event", "tokens", "error", "weight_epoch", "t_admit",
                 "pages", "reuse", "pos", "cur_token", "slot",
                 "rc_tokens", "rc_len", "t_first_token",
                 "temperature", "top_k", "top_p", "seed", "resumed_from",
                 "expect_epoch", "is_resume", "t_preempt", "preempts",
                 "span", "queue_span", "t_enq", "t_last_token",
                 "queue_ms")

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 eos_id: Optional[int], deadline_t: Optional[float],
                 resume_tokens: Optional[List[int]] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 seed: Optional[int] = None,
                 top_p: Optional[float] = None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline_t = deadline_t
        self.event = threading.Event()
        # generated tokens (appended). A resume pre-seeds the tokens
        # another replica already delivered — they are part of the
        # prefill prefix, never re-counted as new output.
        self.tokens: List[int] = list(resume_tokens or [])
        self.resumed_from = len(self.tokens)
        self.error: Optional[BaseException] = None
        self.weight_epoch = 0
        self.t_admit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.pages: List[int] = []        # paged mode: physical pages
        self.reuse = 0                    # prefix tokens from prefix cache
        self.pos = 0                      # abs position of cur_token
        self.cur_token = 0
        self.slot: Optional[int] = None
        self.rc_tokens: Optional[np.ndarray] = None  # recompute mode
        self.rc_len = 0
        # sampling (None temperature => greedy argmax on device)
        self.temperature = (float(temperature)
                            if temperature else None)
        self.top_k = int(top_k) if top_k else None
        self.top_p = float(top_p) if top_p else None
        self.seed = int(seed) if seed is not None else 0
        self.expect_epoch: Optional[int] = None
        self.is_resume = resume_tokens is not None
        self.t_preempt: Optional[float] = None
        self.preempts = 0
        # request-lifecycle tracing: the umbrella span for the
        # whole engine residency (parented under the propagated RPC
        # context so one trace_id spans client -> replica(s)), the open
        # queue_wait child, and the SLO clocks
        self.span = None
        self.queue_span = None
        self.t_enq = time.monotonic()
        self.t_last_token: Optional[float] = None
        self.queue_ms = 0.0

    def snapshot(self, cursor: int = 0) -> dict:
        """Streaming poll: tokens generated past ``cursor`` + liveness.
        List append is atomic under the GIL; no lock needed."""
        toks = self.tokens[cursor:]
        return {
            "tokens": list(toks),
            "cursor": cursor + len(toks),
            "done": self.event.is_set(),
            "error": (f"{self.error}" if self.error is not None else None),
            "weight_epoch": self.weight_epoch,
        }


class GenerationEngine:
    """Iteration-level scheduler over a TinyDecoderLM + PagedKVPool."""

    def __init__(self, model: dm.TinyDecoderLM, *,
                 max_slots: Optional[int] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 queue_depth: int = 32,
                 kv_cache: Optional[bool] = None,
                 prefix_cache: bool = True,
                 eos_id: Optional[int] = None,
                 step_wait_s: float = 0.02):
        self.model = model
        self.device = model.device
        cfg = model.cfg
        self.max_seq = cfg.max_seq
        self.max_slots = int(max_slots or os.environ.get(
            ENV_MAX_SLOTS, 4))
        self.queue_limit = max(1, int(queue_depth))
        self.kv_cache = (kv_cache_enabled() if kv_cache is None
                         else bool(kv_cache))
        self.prefix_cache = bool(prefix_cache) and self.kv_cache
        self.eos_id = eos_id
        self.step_wait_s = float(step_wait_s)
        self.pool: Optional[PagedKVPool] = None
        if self.kv_cache:
            self.pool = PagedKVPool.from_budget(
                n_layers=cfg.n_layers, kv_heads=cfg.n_heads,
                head_dim=cfg.head_dim, page_size=page_size,
                n_pages=n_pages, device=self.device)
            self.page_size = self.pool.page_size
            self.maxp = -(-self.max_seq // self.page_size)
        self._q: deque = deque()
        # resumes (failover re-admissions + preemption victims) queue
        # separately and admit FIRST: shed new work before abandoning
        # old work
        self._rq: deque = deque()
        self.resume_on = resume_enabled()
        self._slots: List[Optional[GenRequest]] = [None] * self.max_slots
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._pending_weights = None
        self._wlock = threading.Lock()
        self.weight_epoch = 0
        # deterministic work accounting (the O(n) proof in tests)
        self.counters = {
            "prefill_positions": 0,    # positions computed in prefills
            "cached_positions": 0,     # positions reused from prefix cache
            "decode_positions": 0,     # positions computed by decode steps
            "recompute_positions": 0,  # positions re-run by the baseline
            "tokens_out": 0,
            "decode_steps": 0,
            "served": 0, "shed": 0, "deadline_exceeded": 0, "evicted": 0,
            # preemption ladder: positions freed at preemption must be
            # matched 1:1 by positions restored at resume prefill — the
            # exact-token-accounting proof the drills assert
            "preempted": 0, "resumed": 0,
            "preempt_positions": 0, "resume_positions": 0,
        }
        self._t_start = time.monotonic()
        self._step_ewma_s: Optional[float] = None
        # recent completions (newest last) for debugz /servez — kept
        # tracing-on or off; records carry trace ids only when traced
        self._recent: deque = deque(maxlen=64)
        from ..telemetry import get_registry

        self._reg = get_registry()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-genloop")
        self._thread.start()

    # -- admission -------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               eos_id: Optional[int] = None,
               resume_tokens: Optional[Sequence[int]] = None,
               elapsed_ms: Optional[float] = None,
               expect_epoch: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               top_p: Optional[float] = None,
               trace_ctx=None) -> GenRequest:
        prompt = [int(t) for t in prompt]
        if not prompt or len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt must have 1..{self.max_seq - 1} tokens "
                f"(got {len(prompt)})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if resume_tokens is not None and not self.resume_on:
            raise ValueError("generation resume is disabled "
                             "(PADDLE_SERVE_RESUME=0)")
        if expect_epoch is not None and int(expect_epoch) \
                != self.weight_epoch:
            raise ResumedOnNewWeights(
                f"ResumedOnNewWeights: resume expected weight epoch "
                f"{int(expect_epoch)}, this replica serves epoch "
                f"{self.weight_epoch}")
        resume_tokens = ([int(t) for t in resume_tokens]
                         if resume_tokens is not None else None)
        deadline_t = (time.monotonic() + float(deadline_ms) / 1e3
                      if deadline_ms else None)
        req = GenRequest(prompt, int(max_new_tokens),
                         self.eos_id if eos_id is None else int(eos_id),
                         deadline_t, resume_tokens=resume_tokens,
                         temperature=temperature, top_k=top_k, seed=seed,
                         top_p=top_p)
        if elapsed_ms:
            # carry the ORIGINAL arrival time across a failover: SLO
            # accounting (request latency, badput charges) never resets
            req.t_admit -= float(elapsed_ms) / 1e3
        req.expect_epoch = (int(expect_epoch)
                            if expect_epoch is not None else None)
        if _tracing.enabled():
            # umbrella span for the engine residency. The RPC handler
            # thread dispatches inside the propagated `server:generate`
            # scope, so "auto" parenting picks up the client's trace_id
            # with zero extra wire plumbing; a failover resume carries
            # the same trace, so ONE trace spans both replicas.
            req.span = _tracing.begin(
                "gen_request", kind="server",
                parent=(trace_ctx if trace_ctx is not None else "auto"),
                attrs={"prompt_len": len(prompt),
                       "max_new_tokens": int(max_new_tokens),
                       "resume": bool(req.is_resume),
                       "resumed_from": req.resumed_from})
        if req.is_resume and (
                len(req.tokens) >= req.max_new_tokens
                or len(prompt) + len(req.tokens) >= self.max_seq
                or (req.eos_id is not None and req.tokens
                    and req.tokens[-1] == req.eos_id)):
            # everything was already delivered — only the done marker
            # was lost; finish without touching the model
            self._finish(req, outcome="served")
            return req
        q = self._rq if req.is_resume else self._q
        with self._cond:
            if self._draining or self._stopped:
                self._shed(req, "Overloaded: server is draining")
            if len(q) >= self.queue_limit:
                self._shed(req, f"Overloaded: admission queue full "
                                f"({len(q)}/{self.queue_limit})")
            if self.pool is not None:
                need = self._pages_needed(req)
                if need > self.pool.capacity:
                    self._shed(req, f"Overloaded: request needs {need} "
                                    f"KV pages, pool capacity is "
                                    f"{self.pool.capacity}")
                # conservative fit gate (prefix sharing can only help):
                # bounce work the pool cannot start promptly instead of
                # queueing it behind capacity we don't have
                if need > self.pool.available() and not self._will_free(
                        need):
                    self._shed(req, f"Overloaded: kv pool full ({need} "
                                    f"pages needed, "
                                    f"{self.pool.available()} available)")
            req.t_enq = time.monotonic()
            req.queue_span = self._req_span(
                req, "queue_wait", attrs={"resume": req.is_resume})
            q.append(req)
            self._gauge("serve_gen_queue_depth").set(len(self._q))
            self._cond.notify_all()
        return req

    def _will_free(self, need: int) -> bool:
        """Pages active requests will return when they retire."""
        freed = sum(len(r.pages) for r in self._slots if r is not None)
        return self.pool.available() + freed >= need

    def _shed(self, req: GenRequest, msg: str):
        self._count("shed")
        self._badput(req, "shed")
        self._retire_trace(req, "shed", detail=msg)
        raise Overloaded(msg)

    def _pages_needed(self, req: GenRequest) -> int:
        total = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        return -(-total // self.page_size)

    # -- weight fence ----------------------------------------------------

    def stage_weights(self, weights: Dict[str, np.ndarray],
                      version: int) -> None:
        """Same contract as MicroBatcher.stage_weights: the decode LOOP
        installs staged weights between steps — the epoch fence."""
        with self._wlock:
            self._pending_weights = (weights, int(version))
        with self._cond:
            self._cond.notify_all()

    def _maybe_adopt_weights(self) -> None:
        with self._wlock:
            staged, self._pending_weights = self._pending_weights, None
        if staged is None:
            return
        weights, version = staged
        try:
            self.model.adopt(weights)
        except Exception as e:  # noqa: BLE001 — a bad delivery must not
            # kill the loop; serving stays on the current epoch
            self._reg.counter("serve_weight_adopt_errors_total").inc()
            import sys

            print(f"[generation_engine] weight adoption rejected "
                  f"(version {version}): {e}; staying on epoch "
                  f"{self.weight_epoch}", file=sys.stderr, flush=True)
            return
        self.weight_epoch += 1
        self._reg.gauge("serve_weight_epoch").set(self.weight_epoch)
        self._reg.counter("serve_weight_fences_total").inc()
        for r in self._slots:
            if r is not None:
                self._event_span(r, "weight_fence",
                                 attrs={"epoch": self.weight_epoch})
        # every live request's tail now decodes under the new epoch —
        # stream snapshots carry it so a client resuming elsewhere can
        # state which epoch its expectation belongs to
        with self._cond:
            live = ([r for r in self._slots if r is not None]
                    + list(self._q) + list(self._rq))
        for r in live:
            r.weight_epoch = self.weight_epoch

    # -- the decode loop -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stopped and not self._q and not self._rq \
                        and not any(self._slots):
                    return
                if not self._q and not self._rq \
                        and not any(self._slots) \
                        and self._pending_weights is None:
                    self._cond.wait(0.05)
            try:
                self._maybe_adopt_weights()  # fence: between steps only
                self._expire_and_admit()
                if any(s is not None for s in self._slots):
                    self._step()
                elif self._q or self._rq:
                    # queued work that can't start yet (pool/slots):
                    # don't spin
                    time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001 — the loop must
                # never die: fail the implicated requests, keep serving
                for i, r in enumerate(self._slots):
                    if r is not None:
                        self._finish(r, error=e, outcome="error")
                        self._slots[i] = None

    def _expire_and_admit(self) -> None:
        now = time.monotonic()
        # mid-decode deadline eviction: expired requests leave their
        # slot immediately and their pages return to the pool
        for i, r in enumerate(self._slots):
            if r is not None and r.deadline_t is not None \
                    and now >= r.deadline_t:
                self._event_span(r, "evict",
                                 attrs={"reason": "deadline",
                                        "tokens": len(r.tokens),
                                        "pos": r.pos})
                self._finish(r, error=DeadlineExceeded(
                    "DeadlineExceeded: request expired mid-decode"),
                    outcome="deadline_exceeded")
                self._slots[i] = None
                self.counters["evicted"] += 1
        # resumes first (old work beats fresh admissions for pages),
        # and they never preempt — freed pages flow to them by priority
        self._admit_from(self._rq, now, allow_preempt=False)
        self._admit_from(self._q, now,
                         allow_preempt=self.resume_on)
        self._gauge("serve_gen_queue_depth").set(len(self._q))
        self._gauge("serve_gen_resume_queue_depth").set(len(self._rq))

    def _admit_from(self, q: deque, now: float,
                    allow_preempt: bool) -> None:
        for req in list(q):
            if req.deadline_t is not None and now >= req.deadline_t:
                with self._cond:
                    try:
                        q.remove(req)
                    except ValueError:
                        continue
                self._finish(req, error=DeadlineExceeded(
                    "DeadlineExceeded: request expired in the queue"),
                    outcome="deadline_exceeded")
                continue
            slot = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if slot is None:
                break
            if not self._try_admit(req, slot):
                # pool can't fit it: climb the preemption ladder once
                # (fresh queue only), else keep FIFO order and wait
                if not (allow_preempt and self._preempt_for(req)
                        and self._try_admit(req, slot)):
                    break

    # -- preemption ladder (PADDLE_SERVE_RESUME gate) --------------------

    def _preempt_for(self, incoming: GenRequest) -> bool:
        """Free pages for ``incoming`` by preempting the active request
        with the MOST remaining work — but only when it has strictly
        more left than the incoming request (shorter job first), so the
        preempted request can never bounce straight back and evict its
        evictor: remaining work strictly decreases down the ladder."""
        if self.pool is None or not self.resume_on:
            return False
        active = [r for r in self._slots if r is not None]
        if not active:
            return False

        def remaining(r: GenRequest) -> int:
            return r.max_new_tokens - len(r.tokens)

        victim = max(active, key=remaining)
        if remaining(victim) <= remaining(incoming):
            return False
        self._preempt(victim)
        return True

    def _preempt(self, victim: GenRequest) -> None:
        """Evict ``victim`` mid-decode WITHOUT failing it: pages return
        to the pool (prompt pages usually park in the prefix cache, so
        the re-prefill is bounded, not a restart), tokens-so-far stay
        on the request, and the same GenRequest object requeues through
        the resume path — waiters and stream pollers never notice."""
        slot = victim.slot
        self.counters["preempted"] += 1
        self.counters["preempt_positions"] += (
            len(victim.prompt) + len(victim.tokens))
        self._reg.counter(
            "serve_gen_preempted_total",
            help="active generations preempted for KV pressure").inc()
        self._event_span(victim, "preempt",
                         attrs={"pages_freed": len(victim.pages),
                                "tokens": len(victim.tokens),
                                "pos": victim.pos})
        if victim.pages:
            self.pool.free(victim.pages)
            victim.pages = []
        victim.reuse = 0
        victim.slot = None
        victim.is_resume = True
        victim.t_preempt = time.monotonic()
        victim.preempts += 1
        self._slots[slot] = None
        with self._cond:
            victim.t_enq = time.monotonic()
            victim.queue_span = self._req_span(
                victim, "queue_wait", attrs={"resume": True,
                                             "preempted": True})
            self._rq.append(victim)
        _tracing.flight_dump("serve_preempt")

    def _try_admit(self, req: GenRequest, slot: int) -> bool:
        if req.expect_epoch is not None \
                and req.expect_epoch != self.weight_epoch:
            # a weight fence installed between submit and admission:
            # refuse the cross-epoch splice before any prefill runs
            self._dequeue(req)
            self._finish(req, error=ResumedOnNewWeights(
                f"ResumedOnNewWeights: resume expected weight epoch "
                f"{req.expect_epoch}, this replica serves epoch "
                f"{self.weight_epoch}"), outcome="error")
            return True
        req.weight_epoch = self.weight_epoch
        wait_ms = (time.monotonic() - req.t_enq) * 1e3
        req.queue_ms += wait_ms
        if req.queue_span is not None:
            req.queue_span.attrs["wait_ms"] = round(wait_ms, 3)
        _tracing.finish(req.queue_span)
        req.queue_span = None
        self._reg.histogram(
            "serve_queue_wait_ms", buckets=_SERVE_BUCKETS,
            help="generation admission wait (enqueue -> slot+pages)",
        ).observe(wait_ms,
                  trace_id=(req.span.trace_id if req.span is not None
                            else None))
        if req.is_resume:
            self._event_span(req, "resume",
                             attrs={"prefix_len": (len(req.prompt)
                                                   + len(req.tokens)),
                                    "preempts": req.preempts})
        # resume prefix: the prompt plus whatever tokens were already
        # delivered (empty for fresh requests — prefix == prompt)
        prefix = req.prompt + req.tokens
        if self.pool is None:
            if req.is_resume:
                self._note_resume(req, len(prefix))
            self._admit_recompute(req, slot)
        else:
            matched, covered = ([], 0)
            if self.prefix_cache:
                matched, covered = self.pool.match_prefix(prefix)
            # whole-page reuse only, and at least one prefix token must
            # be computed so prefill has logits to sample from
            reuse_pages = min(len(matched),
                              (len(prefix) - 1) // self.page_size)
            if reuse_pages < len(matched):
                self.pool.free(matched[reuse_pages:])
                matched = matched[:reuse_pages]
            reuse = reuse_pages * self.page_size
            try:
                fresh = self.pool.alloc(self._pages_needed(req)
                                        - reuse_pages)
            except MemoryError:
                self.pool.free(matched)
                return False
            req.pages = matched + fresh
            req.reuse = reuse
            if req.is_resume:
                self._note_resume(req, len(prefix))
            self._prefill_paged(req, slot)
        self._dequeue(req)
        req.is_resume = False
        self._slots[slot] = req
        req.slot = slot
        if req.event.is_set():  # finished during prefill (eos/max_new)
            self._slots[slot] = None
        return True

    def _dequeue(self, req: GenRequest) -> None:
        with self._cond:
            for q in (self._q, self._rq):
                try:
                    q.remove(req)
                except ValueError:
                    pass

    def _note_resume(self, req: GenRequest, prefix_len: int) -> None:
        self.counters["resumed"] += 1
        self.counters["resume_positions"] += prefix_len
        self._reg.counter(
            "serve_gen_resumed_total",
            help="generations re-admitted from a supplied prefix "
                 "(failover resumes + preemption victims)").inc()
        if req.t_preempt is not None:
            # off-device wall time between preemption and re-admission
            self._badput_ms((time.monotonic() - req.t_preempt) * 1e3,
                            "preempt")
            req.t_preempt = None

    # -- paged mode ------------------------------------------------------

    def _table_row(self, req: GenRequest) -> np.ndarray:
        row = np.zeros(self.maxp, np.int32)
        row[:len(req.pages)] = req.pages
        return row

    def _prefill_paged(self, req: GenRequest, slot: int) -> None:
        pool, psz = self.pool, self.page_size
        # the prefill prefix is prompt + already-delivered tokens — for
        # fresh requests that's just the prompt; for resumes the
        # delivered tail rides the same window (and the prompt's pages
        # usually come back from the prefix cache)
        prefix = req.prompt + req.tokens
        n_valid = len(prefix) - req.reuse
        psp = self._req_span(req, "prefill",
                             attrs={"positions": n_valid,
                                    "cached": req.reuse,
                                    "prefix_hit": req.reuse > 0,
                                    "pages": len(req.pages)})
        # the decode loop is busy prefilling THIS request — every other
        # active slot stalls for the same wall time. A peer_prefill span
        # per co-batched request makes that bubble attributable ("my p99
        # came from peer prefill"), and closes the coverage gap the
        # >=90%-attribution drill measures.
        peers = [(r, self._req_span(
            r, "peer_prefill",
            attrs={"peer_trace": (req.span.trace_id
                                  if req.span is not None else None),
                   "positions": n_valid}))
            for r in self._slots if r is not None and r is not req]
        r = min(dm.prefill_bucket(n_valid), self.max_seq)
        window = np.zeros(r, np.int32)
        window[:n_valid] = prefix[req.reuse:]
        ctx_k, ctx_v = dm.gather_ctx(pool.k, pool.v,
                                     self._dev(self._table_row(req)),
                                     page_size=psz)
        t0 = time.perf_counter()
        logits, tok, k_win, v_win = dm.prefill(
            self.model.params, self._dev(window),
            req.reuse, ctx_k, ctx_v, n_valid,
            n_heads=self.model.cfg.n_heads)
        flat = np.zeros(r, np.int32)
        for i in range(n_valid):
            p_abs = req.reuse + i
            flat[i] = req.pages[p_abs // psz] * psz + p_abs % psz
        pool.set_arrays(*dm.scatter_kv(pool.k, pool.v, k_win, v_win,
                                       self._dev(flat)))
        ms = (time.perf_counter() - t0) * 1e3
        if psp is not None:
            psp.attrs["prefill_ms"] = round(ms, 3)
        _tracing.finish(psp)
        for _, sp in peers:
            _tracing.finish(sp)
        self._observe_ms("serve_prefill_ms", None, ms=ms)
        if req.is_resume:
            # the bounded extra prefill a preemption/failover costs
            self._badput_ms(ms, "resume")
        if self.prefix_cache:
            pool.register_prefix(prefix, req.pages[:len(prefix) // psz])
        self.counters["prefill_positions"] += n_valid
        self.counters["cached_positions"] += req.reuse
        self._tok_counter("prefill").inc(n_valid)
        req.pos = len(prefix)
        self._emit(req, int(tok), logits_row=(
            logits.cpu().numpy() if req.temperature else None))

    def _step_paged(self, active: List[GenRequest]) -> None:
        pool, psz, b = self.pool, self.page_size, self.max_slots
        tokens = np.zeros(b, np.int32)
        positions = np.zeros(b, np.int32)
        write_flat = np.zeros(b, np.int32)
        table = np.zeros((b, self.maxp), np.int32)
        for r in active:
            pid = r.pages[r.pos // psz]
            # COW safety: never write a shared/cached page in place
            new_pid, needs_copy = pool.ensure_private(pid)
            if needs_copy:
                pool.set_arrays(*dm.copy_page(
                    pool.k, pool.v, pid, new_pid, page_size=psz))
                r.pages[r.pos // psz] = new_pid
                pid = new_pid
            tokens[r.slot] = r.cur_token
            positions[r.slot] = r.pos
            write_flat[r.slot] = pid * psz + r.pos % psz
            table[r.slot, :len(r.pages)] = r.pages
        t0 = time.perf_counter()
        logits, nxt, k, v = dm.decode_step(
            self.model.params, pool.k, pool.v, self._dev(tokens),
            self._dev(positions), self._dev(table),
            self._dev(write_flat), page_size=psz,
            n_heads=self.model.cfg.n_heads)
        pool.set_arrays(k, v)
        nxt = nxt.cpu().numpy()
        logits_np = (logits.cpu().numpy()
                     if any(r.temperature for r in active) else None)
        self._observe_ms("serve_decode_step_ms", t0)
        self.counters["decode_steps"] += 1
        self.counters["decode_positions"] += len(active)
        self._tok_counter("decode").inc(len(active))
        for r in active:
            r.pos += 1
            self._emit(r, int(nxt[r.slot]),
                       logits_row=(None if logits_np is None
                                   else logits_np[r.slot]))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host index/token array on the model's device."""
        return torch.as_tensor(a, device=self.device)

    # -- recompute baseline (PADDLE_SERVE_KV_CACHE=0) --------------------

    def _admit_recompute(self, req: GenRequest, slot: int) -> None:
        # resume prefix rides the dense buffer too: delivered tokens
        # re-enter as context, the next decode step emits token
        # len(req.tokens) — same replay contract as the paged path
        seq = req.prompt + req.tokens
        req.rc_tokens = np.zeros(self.max_seq, np.int32)
        req.rc_tokens[:len(seq)] = seq
        req.rc_len = len(seq)

    def _step_recompute(self, active: List[GenRequest]) -> None:
        b = self.max_slots
        tokens = np.zeros((b, self.max_seq), np.int32)
        lengths = np.ones(b, np.int32)
        for r in active:
            tokens[r.slot] = r.rc_tokens
            lengths[r.slot] = r.rc_len
        t0 = time.perf_counter()
        logits, nxt = dm.recompute_step(
            self.model.params, self._dev(tokens),
            self._dev(lengths), n_heads=self.model.cfg.n_heads)
        nxt = nxt.cpu().numpy()
        logits_np = (logits.cpu().numpy()
                     if any(r.temperature for r in active) else None)
        self._observe_ms("serve_decode_step_ms", t0)
        self.counters["decode_steps"] += 1
        # the whole live prefix was re-run for ONE new token per slot —
        # this counter is the measured O(n^2) the paged path removes
        self.counters["recompute_positions"] += int(
            sum(r.rc_len for r in active))
        self._tok_counter("decode").inc(len(active))
        for r in active:
            tok = self._choose_token(
                r, int(nxt[r.slot]),
                None if logits_np is None else logits_np[r.slot])
            if r.rc_len < self.max_seq:
                r.rc_tokens[r.rc_len] = tok
            r.rc_len += 1
            self._emit(r, tok)

    # -- shared loop pieces ---------------------------------------------

    def _step(self) -> None:
        active = [r for r in self._slots if r is not None]
        if not active:
            return
        # one batched step = one span PER active slot, all sharing the
        # same `step` index. Wall time is charged pro-rata (`charged_ms`
        # = step wall / batch) so co-batching interference is
        # attributable: a victim of a peer's stall carries the stalled
        # step's index and its full `step_ms`. Spans open BEFORE the
        # chaos sites so injected stalls land inside them.
        step_idx = self.counters["decode_steps"]
        spans = [(r, self._req_span(
            r, "decode_step",
            attrs={"step": step_idx, "batch": len(active),
                   "slot": r.slot, "pos": r.pos}))
            for r in active]
        t_wall = time.perf_counter()
        # deterministic chaos sites: `stall:gen_decode_step:N:MS` delays
        # and `crash:gen_decode_step:N` kills this replica mid-decode —
        # the chaos drill's proof that in-flight generations survive a
        # replica death at the worst possible moment
        _faults.stall_point("gen_decode_step")
        _faults.crash_point("gen_decode_step")
        try:
            if self.pool is not None:
                self._step_paged(active)
            else:
                self._step_recompute(active)
        finally:
            ms = (time.perf_counter() - t_wall) * 1e3
            charged = ms / len(active)
            for r, sp in spans:
                if sp is None:
                    continue
                sp.attrs["step_ms"] = round(ms, 3)
                sp.attrs["charged_ms"] = round(charged, 3)
                _tracing.finish(sp)
        for i, r in enumerate(self._slots):
            if r is not None and r.event.is_set():
                self._slots[i] = None
        if self.pool is not None:
            self.pool.publish_gauges()

    def _choose_token(self, req: GenRequest, argmax_tok: int,
                      logits_row) -> int:
        """THE sampling choke point: greedy requests keep the device
        argmax untouched; sampled requests draw
        from the same logits with the (seed, index) counter PRNG."""
        if not req.temperature or logits_row is None:
            return argmax_tok
        return _sample_token(logits_row, req.temperature, req.top_k,
                             req.seed, len(req.tokens),
                             top_p=req.top_p)

    def _emit(self, req: GenRequest, tok: int, logits_row=None) -> None:
        """Append one generated token; retire on eos/max_new/capacity."""
        tok = self._choose_token(req, tok, logits_row)
        now = time.monotonic()
        tid = req.span.trace_id if req.span is not None else None
        if req.t_first_token is None:
            req.t_first_token = now
            self._reg.histogram(
                "serve_ttft_ms", buckets=_SERVE_BUCKETS,
                help="time to first token (admission-backdated across "
                     "failover resumes)",
            ).observe((now - req.t_admit) * 1e3, trace_id=tid)
        elif req.t_last_token is not None:
            self._reg.histogram(
                "serve_tpot_ms", buckets=_SERVE_BUCKETS,
                help="inter-token latency (time per output token)",
            ).observe((now - req.t_last_token) * 1e3, trace_id=tid)
        req.t_last_token = now
        req.tokens.append(tok)
        self.counters["tokens_out"] += 1
        done = (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))
        total = len(req.prompt) + len(req.tokens)
        if not done and total >= self.max_seq:
            done = True  # context capacity reached
        if done:
            self._finish(req, outcome="served")
        else:
            req.cur_token = tok

    def _finish(self, req: GenRequest,
                error: Optional[BaseException] = None,
                outcome: str = "served") -> None:
        if req.event.is_set():
            return
        if self.pool is not None and req.pages:
            self.pool.free(req.pages)
            req.pages = []
        req.error = error
        req.weight_epoch = self.weight_epoch
        self._count(outcome)
        if outcome == "deadline_exceeded":
            self._badput(req, "deadline")
        self._observe_ms("serve_gen_request_ms",
                         None, ms=(time.monotonic() - req.t_admit) * 1e3)
        self._retire_trace(
            req, outcome,
            detail=(f"{error}" if error is not None else None))
        req.event.set()
        with self._cond:
            self._cond.notify_all()

    # -- client side -----------------------------------------------------

    def result(self, req: GenRequest,
               timeout: Optional[float] = None) -> dict:
        grace = 30.0
        if timeout is None and req.deadline_t is not None:
            timeout = max(0.0, req.deadline_t - time.monotonic()) + grace
        if not req.event.wait(timeout):
            raise DeadlineExceeded(
                "DeadlineExceeded: generation did not complete in time")
        if req.error is not None:
            raise req.error
        return {
            "tokens": list(req.tokens),
            "weight_epoch": req.weight_epoch,
            "ttft_ms": (None if req.t_first_token is None else round(
                (req.t_first_token - req.t_admit) * 1e3, 3)),
            "resumed_from": req.resumed_from,
        }

    # -- lifecycle / observability ---------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._q or self._rq
                   or any(s is not None for s in self._slots)) \
                    and time.monotonic() < deadline:
                self._cond.wait(0.1)
            return not self._q and not self._rq and not any(
                s is not None for s in self._slots)

    def stop(self) -> None:
        self.drain(timeout=5.0)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        c = dict(self.counters)
        dt = max(1e-9, time.monotonic() - self._t_start)
        out = {
            "mode": "paged" if self.pool is not None else "recompute",
            "max_slots": self.max_slots,
            "active_slots": sum(1 for s in self._slots if s is not None),
            "queue_depth": len(self._q),
            "draining": self._draining,
            "weight_epoch": self.weight_epoch,
            "tokens_total": c["tokens_out"],
            "tokens_per_s": round(c["tokens_out"] / dt, 3),
            "decode_steps": c["decode_steps"],
            "prefill_positions_total": c["prefill_positions"],
            "cached_positions_total": c["cached_positions"],
            "decode_positions_total": c["decode_positions"],
            "recompute_positions_total": c["recompute_positions"],
            "served_total": c["served"],
            "shed_total": c["shed"],
            "deadline_exceeded_total": c["deadline_exceeded"],
            "evicted_total": c["evicted"],
            "preempted_total": c["preempted"],
            "resumed_total": c["resumed"],
            "preempt_positions_total": c["preempt_positions"],
            "resume_positions_total": c["resume_positions"],
            "resume_queue_depth": len(self._rq),
            "resume_enabled": self.resume_on,
            "step_ewma_ms": (None if self._step_ewma_s is None
                             else round(self._step_ewma_s * 1e3, 3)),
        }
        # SLO quantiles: bucket-boundary estimates from the
        # first-class histograms. servetop renders dashes when a replica
        # predates these keys.
        for hname, pfx in (("serve_ttft_ms", "ttft"),
                           ("serve_tpot_ms", "tpot"),
                           ("serve_queue_wait_ms", "queue_wait")):
            hist = self._reg.histogram(hname, buckets=_SERVE_BUCKETS)
            out[f"{pfx}_p50_ms"] = round(hist.quantile(0.5), 3)
            out[f"{pfx}_p99_ms"] = round(hist.quantile(0.99), 3)
        if self.pool is not None:
            out["kv_pool"] = self.pool.stats()
        return out

    def servez(self) -> dict:
        """debugz /servez payload: active slots, queued requests, recent
        completions slowest-first. Works tracing-on or off (trace ids
        are null when untraced)."""
        now = time.monotonic()

        def _row(r: GenRequest, phase: str, slot=None) -> dict:
            return {
                "slot": slot,
                "trace": (r.span.trace_id if r.span is not None
                          else None),
                "phase": phase,
                "age_s": round(now - r.t_admit, 3),
                "prompt_len": len(r.prompt),
                "tokens": len(r.tokens),
                "max_new_tokens": r.max_new_tokens,
                "pages": len(r.pages),
                "pos": r.pos,
                "preempts": r.preempts,
                "resumed_from": r.resumed_from,
                "deadline_in_s": (None if r.deadline_t is None
                                  else round(r.deadline_t - now, 3)),
            }

        active = [_row(r, "decode", slot=i)
                  for i, r in enumerate(self._slots) if r is not None]
        with self._cond:
            queued = [_row(r, "queued") for r in self._q]
            resumes = [_row(r, "queued_resume") for r in self._rq]
        recent = sorted(self._recent,
                        key=lambda rec: -(rec.get("total_ms") or 0.0))
        return {
            "mode": "paged" if self.pool is not None else "recompute",
            "max_slots": self.max_slots,
            "draining": self._draining,
            "weight_epoch": self.weight_epoch,
            "active": active,
            "queued": queued,
            "resume_queue": resumes,
            "recent_slowest": recent[:32],
        }

    # -- small helpers ---------------------------------------------------

    def _req_span(self, req: GenRequest, name: str,
                  attrs: Optional[dict] = None):
        """Child span under the request's umbrella span (None when the
        request is untraced — every consumer is None-safe)."""
        if req.span is None:
            return None
        return _tracing.begin(name, parent=req.span, attrs=attrs)

    def _event_span(self, req: GenRequest, name: str,
                    attrs: Optional[dict] = None) -> None:
        """Zero-duration lifecycle marker (preempt/resume/evict/
        weight_fence) on the request's trace."""
        _tracing.finish(self._req_span(req, name, attrs=attrs))

    # outcome -> flight-recorder dump reason (the post-mortem path)
    _DUMP_REASONS = {"shed": "serve_shed",
                     "deadline_exceeded": "serve_deadline"}

    def _retire_trace(self, req: GenRequest, outcome: str,
                      detail: Optional[str] = None) -> None:
        """Close the request's open spans, append the /servez completion
        record, note the per-request flight record, and trigger a flight
        dump on bad outcomes."""
        now = time.monotonic()
        if req.queue_span is not None:
            # retired straight out of the queue (queue deadline / epoch
            # refusal): the whole residency was queue wait
            req.queue_ms += (now - req.t_enq) * 1e3
            _tracing.finish(req.queue_span,
                            status=(None if outcome == "served"
                                    else outcome))
            req.queue_span = None
        rec = {
            "trace": req.span.trace_id if req.span is not None else None,
            "outcome": outcome,
            "prompt_len": len(req.prompt),
            "tokens": len(req.tokens),
            "queue_ms": round(req.queue_ms, 3),
            "ttft_ms": (None if req.t_first_token is None else round(
                (req.t_first_token - req.t_admit) * 1e3, 3)),
            "total_ms": round((now - req.t_admit) * 1e3, 3),
            "preempts": req.preempts,
            "resumed_from": req.resumed_from,
            "weight_epoch": req.weight_epoch,
            "ts": round(time.time(), 3),
        }
        if detail:
            rec["detail"] = detail
        self._recent.append(rec)
        _sink.emit({"kind": "serve_request", **rec})
        if req.span is not None:
            req.span.attrs.update(outcome=outcome,
                                  tokens=len(req.tokens),
                                  queue_ms=rec["queue_ms"],
                                  preempts=req.preempts)
            if detail:
                req.span.attrs["detail"] = detail
            _tracing.finish(req.span,
                            status=(None if outcome == "served"
                                    else outcome))
            req.span = None
            _tracing.note_request(rec)
        reason = self._DUMP_REASONS.get(outcome)
        if reason is None and outcome == "error" and detail \
                and "ResumedOnNewWeights" in detail:
            reason = "serve_epoch_refusal"
        if reason is not None:
            _tracing.flight_dump(reason)

    def _count(self, outcome: str) -> None:
        if outcome in self.counters:
            self.counters[outcome] += 1
        self._reg.counter("serve_gen_requests_total",
                          outcome=outcome).inc()

    def _tok_counter(self, phase: str):
        return self._reg.counter(
            "serve_tokens_total",
            help="generated/prefilled token positions by phase",
            phase=phase)

    def _gauge(self, name: str):
        return self._reg.gauge(name)

    def _observe_ms(self, name: str, t0: Optional[float],
                    ms: Optional[float] = None) -> None:
        if ms is None:
            ms = (time.perf_counter() - t0) * 1e3
        if name == "serve_decode_step_ms":
            s = ms / 1e3
            self._step_ewma_s = (s if self._step_ewma_s is None
                                 else 0.8 * self._step_ewma_s + 0.2 * s)
        self._reg.histogram(name, buckets=_SERVE_BUCKETS).observe(ms)

    def _badput(self, req: GenRequest, cause: str) -> None:
        self._badput_ms((time.monotonic() - req.t_admit) * 1e3, cause)

    def _badput_ms(self, ms: float, cause: str) -> None:
        try:
            from ..telemetry import goodput as _goodput

            _goodput.note_serving_badput(ms, cause=cause)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass
