"""The port's generation engine and KV pool, on the CPU.

* the reference engine behaviours (test_kv_serving.py,
  test_gen_resume.py) against the port's GenerationEngine: cached decode
  vs the recompute oracle with exact position counters, prefix-cache
  reuse, explicit Overloaded on pool exhaustion and a full queue,
  mid-decode deadline eviction, PADDLE_SERVE_KV_CACHE=0, the weight
  fence, resume and sampling replay, the preemption ladder;
* the PagedKVPool accounting tests, pointed at the port's pool;
* the whole slice: the same prompts and weights through the JAX
  package's engine and the port's give equal token streams and equal
  work counters.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from paddle_tpu.inference import decode_model as jdm
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu_torch.inference import decode_model as dm
from paddle_tpu_torch.inference import kv_cache as kvmod
from paddle_tpu_torch.inference.engine import GenerationEngine
from paddle_tpu_torch.inference.kv_cache import PagedKVPool
from paddle_tpu_torch.inference.server import (DeadlineExceeded,
                                               Overloaded,
                                               ResumedOnNewWeights)
from paddle_tpu_torch.telemetry import get_registry

_REG = get_registry()

CFG = dm.DecoderConfig()          # vocab 64, d 32, L2 H2, max_seq 64
PAGES, PSZ, SLOTS = 24, 4, 2
PROMPT = [3, 9, 1, 4, 1, 5, 9]
PRESSURE_PAGES = 9                # capacity 8: one 32-position request


def _mk_engine(kv=True, seed=1, **kw):
    kw.setdefault("n_pages", PAGES)
    kw.setdefault("page_size", PSZ)
    kw.setdefault("max_slots", SLOTS)
    if not kv:
        kw.pop("n_pages"), kw.pop("page_size")
    return GenerationEngine(dm.TinyDecoderLM(CFG, seed=seed, device="cpu"),
                            kv_cache=kv, **kw)


def _slow_decode(monkeypatch, delay_s=0.01):
    real_step = dm.decode_step

    def slow_step(*a, **kw):
        time.sleep(delay_s)
        return real_step(*a, **kw)

    monkeypatch.setattr(dm, "decode_step", slow_step)


def _wait_admitted(eng, n_active=1, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["active_slots"] >= n_active and st["queue_depth"] == 0:
            return True
        time.sleep(0.002)
    return False


def _pool(n_pages=8, page_size=4):
    return PagedKVPool(n_pages=n_pages, page_size=page_size, n_layers=2,
                       kv_heads=2, head_dim=8, allocate=False)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------


def test_kv_pool_alloc_free_refcount():
    p = _pool()
    assert p.capacity == 7  # page 0 reserved as the trash page
    pids = p.alloc(3)
    assert 0 not in pids and p.available() == 4
    p.incref(pids)
    p.free(pids)
    assert p.available() == 4  # still referenced once
    p.free(pids)
    assert p.available() == 7
    with pytest.raises(MemoryError):
        p.alloc(8)


def test_kv_pool_prefix_register_match_and_lru_reclaim():
    p = _pool()
    toks = list(range(12))  # 3 full pages @ psz 4
    pids = p.alloc(3)
    p.register_prefix(toks, pids)
    m, n = p.match_prefix(toks + [99])
    assert m == pids and n == 12
    p.free(m)
    p.free(pids)  # refs 0 -> registered pages park in the LRU, not free
    st = p.stats()
    assert st["pages_cached"] == 3 and st["pages_free"] == 4
    m2, n2 = p.match_prefix(toks)
    assert n2 == 12
    p.free(m2)
    big = p.alloc(7)  # allocation pressure reclaims cached pages lazily
    assert len(big) == 7 and p.available() == 0
    m3, n3 = p.match_prefix(toks)  # reclaimed pages lost registration
    assert m3 == [] and n3 == 0


def test_kv_pool_hash_collision_degrades_to_miss(monkeypatch):
    monkeypatch.setattr(kvmod, "_page_hash", lambda ph, t: 42)
    p = _pool()
    a = p.alloc(1)
    p.register_prefix([1, 2, 3, 4], a)
    m, n = p.match_prefix([5, 6, 7, 8])  # same hash, different tokens
    assert m == [] and n == 0
    assert p.stats()["prefix_collisions"] == 1
    m2, n2 = p.match_prefix([1, 2, 3, 4, 9])
    assert m2 == a and n2 == 4


def test_kv_pool_copy_on_write():
    p = _pool()
    pids = p.alloc(1)
    p.incref(pids)
    new, needs_copy = p.ensure_private(pids[0])
    assert needs_copy and new != pids[0]
    assert p.stats()["cow_copies"] == 1
    p.free(pids)
    p.free([new])
    solo = p.alloc(1)
    same, needs_copy = p.ensure_private(solo[0])
    assert same == solo[0] and not needs_copy
    p.register_prefix([1, 2, 3, 4], solo)
    new2, needs_copy = p.ensure_private(solo[0])
    assert needs_copy and new2 != solo[0]


def test_kv_pool_memz_section():
    from paddle_tpu_torch.telemetry import memory as tmem

    pool = PagedKVPool(n_pages=4, page_size=2, n_layers=1, kv_heads=1,
                       head_dim=4, allocate=False)
    try:
        payload = tmem.memz()
        assert payload["kv_pool"]["n_pages"] == 4
        assert "residency" in payload["kv_pool"]
    finally:
        tmem.unregister_memz_section("kv_pool")
    del pool


def test_kv_pool_tensors_on_the_requested_device():
    p = PagedKVPool(n_pages=3, page_size=2, n_layers=2, kv_heads=1,
                    head_dim=4, device="cpu")
    assert tuple(p.k.shape) == (2, 6, 1, 4) and p.k.device.type == "cpu"
    assert float(p.k.abs().sum()) == 0.0
    assert p.bytes_total == 2 * p.k.numel() * 4


def test_kv_pool_page_size_from_env_without_autotuner(monkeypatch):
    monkeypatch.setenv(kvmod.ENV_KV_PAGE_SIZE, "8")
    monkeypatch.setenv(kvmod.ENV_KV_PAGES, "5")
    p = PagedKVPool.from_budget(n_layers=1, kv_heads=1, head_dim=4,
                                allocate=False)
    assert (p.page_size, p.n_pages) == (8, 5)
    monkeypatch.delenv(kvmod.ENV_KV_PAGE_SIZE)
    assert PagedKVPool.from_budget(n_layers=1, kv_heads=1, head_dim=4,
                                   allocate=False).page_size == 16


# ---------------------------------------------------------------------------
# generation engine
# ---------------------------------------------------------------------------


def test_engine_cached_decode_matches_recompute_oracle():
    kv, rc = _mk_engine(kv=True), _mk_engine(kv=False)
    try:
        a = kv.result(kv.submit(PROMPT, max_new_tokens=8), timeout=120)
        b = rc.result(rc.submit(PROMPT, max_new_tokens=8), timeout=120)
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == 8
        n_new = len(a["tokens"])
        assert kv.counters["prefill_positions"] == len(PROMPT)
        assert kv.counters["decode_positions"] == n_new - 1
        assert kv.counters["recompute_positions"] == 0
        expect_rc = sum(len(PROMPT) + t for t in range(n_new))
        assert rc.counters["recompute_positions"] == expect_rc
    finally:
        kv.stop()
        rc.stop()


def test_engine_prefix_cache_pays_prefill_once():
    eng = _mk_engine(kv=True)
    try:
        r1 = eng.result(eng.submit(PROMPT + [2, 7], max_new_tokens=4),
                        timeout=120)
        pre1 = eng.counters["prefill_positions"]
        r2 = eng.result(eng.submit(PROMPT + [2, 7], max_new_tokens=4),
                        timeout=120)
        assert r2["tokens"] == r1["tokens"]  # shared pages, same KV
        assert eng.counters["cached_positions"] == 8
        assert eng.counters["prefill_positions"] == pre1 + 1  # 9 - 8
        assert eng.pool.stats()["prefix_hit_pages"] >= 2
    finally:
        eng.stop()


def test_engine_pool_exhausted_is_explicit_overloaded():
    eng = _mk_engine(kv=True, n_pages=8)  # capacity 7 pages @ psz 4
    try:
        with pytest.raises(Overloaded) as ei:
            eng.submit(list(range(40)), max_new_tokens=24)
        assert "KV pages" in str(ei.value) or "kv pool" in str(ei.value)
        assert eng.counters["shed"] == 1
        assert _REG.counter("serve_gen_requests_total",
                            outcome="shed").value >= 1
    finally:
        eng.stop()


def test_engine_mid_decode_deadline_eviction(monkeypatch):
    _slow_decode(monkeypatch)
    eng = _mk_engine(kv=True)
    try:
        req = eng.submit(PROMPT, max_new_tokens=56, deadline_ms=80.0)
        with pytest.raises(DeadlineExceeded):
            eng.result(req, timeout=120)
        assert 0 < len(req.tokens) < 56
        assert eng.counters["evicted"] == 1
        assert eng.pool.stats()["pages_active"] == 0
        ok = eng.result(eng.submit(PROMPT, max_new_tokens=2), timeout=120)
        assert len(ok["tokens"]) == 2
    finally:
        eng.stop()


def test_engine_queue_full_sheds(monkeypatch):
    _slow_decode(monkeypatch)
    eng = _mk_engine(kv=True, queue_depth=1)
    try:
        reqs = []
        for _ in range(2):
            reqs.append(eng.submit(PROMPT, max_new_tokens=24))
            assert _wait_admitted(eng, n_active=len(reqs))
        reqs.append(eng.submit(PROMPT, max_new_tokens=24))
        with pytest.raises(Overloaded) as ei:
            eng.submit(PROMPT, max_new_tokens=24)
        assert "queue full" in str(ei.value)
        for r in reqs:
            eng.result(r, timeout=120)
    finally:
        eng.stop()


def test_engine_kv_flag_off_uses_recompute_path(monkeypatch):
    monkeypatch.setenv("PADDLE_SERVE_KV_CACHE", "0")
    eng = GenerationEngine(dm.TinyDecoderLM(CFG, seed=1, device="cpu"),
                           max_slots=SLOTS)
    try:
        assert eng.pool is None
        assert eng.stats()["mode"] == "recompute"
        r = eng.result(eng.submit(PROMPT, max_new_tokens=4), timeout=120)
        assert len(r["tokens"]) == 4
        assert eng.counters["recompute_positions"] > 0
        assert eng.counters["decode_positions"] == 0
    finally:
        eng.stop()


def test_engine_weight_fence_and_bad_delivery():
    eng = _mk_engine(kv=True)
    try:
        r1 = eng.result(eng.submit(PROMPT, max_new_tokens=2), timeout=120)
        assert r1["weight_epoch"] == 0
        eng.stage_weights({"nope": np.zeros(3, np.float32)}, version=9)
        time.sleep(0.1)
        assert eng.weight_epoch == 0
        new = {"head": eng.model.params["head"].cpu().numpy() * 0.5}
        eng.stage_weights(new, version=10)
        deadline = time.monotonic() + 5
        while eng.weight_epoch == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.weight_epoch == 1
        np.testing.assert_array_equal(
            eng.model.params["head"].cpu().numpy(), new["head"])
        r2 = eng.result(eng.submit(PROMPT, max_new_tokens=2), timeout=120)
        assert r2["weight_epoch"] == 1
    finally:
        eng.stop()


def test_engine_resume_tail_is_bit_identical():
    eng = _mk_engine(kv=True)
    try:
        full = eng.result(eng.submit(PROMPT, max_new_tokens=10),
                          timeout=120)
        res = eng.result(eng.submit(PROMPT, max_new_tokens=10,
                                    resume_tokens=full["tokens"][:4]),
                         timeout=120)
        assert res["tokens"] == full["tokens"]
        assert res["resumed_from"] == 4
        assert eng.counters["resume_positions"] == len(PROMPT) + 4
        with pytest.raises(ResumedOnNewWeights):
            eng.submit(PROMPT, max_new_tokens=4, resume_tokens=[1, 2],
                       expect_epoch=3)
    finally:
        eng.stop()


def test_engine_sampling_deterministic_and_resume_replays():
    eng = _mk_engine(kv=True)
    try:
        kw = dict(max_new_tokens=6, temperature=0.9, seed=42)
        a = eng.result(eng.submit(PROMPT, **kw), timeout=120)["tokens"]
        b = eng.result(eng.submit(PROMPT, **kw), timeout=120)["tokens"]
        assert a == b and len(a) == 6
        r = eng.result(eng.submit(PROMPT, resume_tokens=a[:3], **kw),
                       timeout=120)
        assert r["tokens"] == a and r["resumed_from"] == 3
        g = eng.result(eng.submit(PROMPT, max_new_tokens=6),
                       timeout=120)["tokens"]
        g1 = eng.result(eng.submit(PROMPT, max_new_tokens=6,
                                   temperature=1.7, top_k=1, seed=9),
                        timeout=120)["tokens"]
        assert g1 == g
    finally:
        eng.stop()


def test_engine_preemption_ladder_resumes_victim(monkeypatch):
    _slow_decode(monkeypatch, 0.008)
    eng = _mk_engine(kv=True, n_pages=PRESSURE_PAGES, queue_depth=8)
    try:
        base = eng.result(eng.submit(PROMPT, max_new_tokens=25),
                          timeout=120)["tokens"]
        victim = eng.submit(PROMPT, max_new_tokens=25)
        assert _wait_admitted(eng)  # victim holds the whole pool
        s = eng.result(eng.submit([11, 22, 33], max_new_tokens=4),
                       timeout=120)
        assert len(s["tokens"]) == 4
        assert eng.result(victim, timeout=120)["tokens"] == base
        c = eng.counters
        assert c["preempted"] >= 1 and c["preempted"] == c["resumed"]
        assert c["preempt_positions"] == c["resume_positions"] > 0
    finally:
        eng.stop()


def test_engine_failure_fails_inflight_requests(monkeypatch):
    """A device step that raises fails the requests in flight; result()
    re-raises the error and the loop keeps serving."""
    real_step = dm.decode_step
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected step failure")
        return real_step(*a, **kw)

    monkeypatch.setattr(dm, "decode_step", flaky)
    eng = _mk_engine(kv=True)
    try:
        with pytest.raises(RuntimeError, match="injected step failure"):
            eng.result(eng.submit(PROMPT, max_new_tokens=6), timeout=120)
        ok = eng.result(eng.submit(PROMPT, max_new_tokens=3), timeout=120)
        assert len(ok["tokens"]) == 3
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# the whole slice: JAX engine vs the port's engine
# ---------------------------------------------------------------------------

# a plain prompt, one sharing its first two pages (prefix-cache hit), a
# longer one, and a sampled request
SLICE_REQS = [
    (PROMPT, dict(max_new_tokens=8)),
    (PROMPT + [2, 7, 30], dict(max_new_tokens=6)),
    (list(range(5, 25)), dict(max_new_tokens=10)),
    (PROMPT, dict(max_new_tokens=7, temperature=0.8, top_k=20, seed=5)),
]


def _run_slice(engine, concurrent: bool):
    try:
        if concurrent:
            reqs = [engine.submit(p, **kw) for p, kw in SLICE_REQS]
            out = [engine.result(r, timeout=120)["tokens"] for r in reqs]
        else:
            out = [engine.result(engine.submit(p, **kw),
                                 timeout=120)["tokens"]
                   for p, kw in SLICE_REQS]
        return out, dict(engine.counters)
    finally:
        engine.stop()


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["sequential", "concurrent"])
@pytest.mark.parametrize("kv", [True, False], ids=["paged", "recompute"])
def test_whole_slice_matches_jax_engine(kv, concurrent):
    np_params = jdm.init_params(jdm.DecoderConfig(), 11)
    kw = dict(kv_cache=kv, max_slots=SLOTS)
    if kv:
        kw.update(page_size=PSZ, n_pages=PAGES)
    ref_tokens, ref_c = _run_slice(
        JaxEngine(jdm.TinyDecoderLM(jdm.DecoderConfig(), params=np_params),
                  **kw), concurrent)
    got_tokens, got_c = _run_slice(
        GenerationEngine(dm.TinyDecoderLM(CFG, params=np_params,
                                          device="cpu"), **kw), concurrent)
    assert got_tokens == ref_tokens
    assert [len(t) for t in got_tokens] == [kw["max_new_tokens"]
                                            for _, kw in SLICE_REQS]
    if concurrent:
        # how many requests share a batched step depends on thread timing
        ref_c.pop("decode_steps"), got_c.pop("decode_steps")
    assert got_c == ref_c
    if kv:
        assert got_c["cached_positions"] > 0
