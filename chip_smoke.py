#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, each printing one JSON line (any failure exits nonzero and
prints no result):

  env      card name and power limit (nvidia-smi), torch/CUDA versions;
           TF32 off for matmuls and cuDNN
  build    nvcc builds the port's kernel library from ``csrc/``
  kernels  each kernel against its plain PyTorch version at the serving
           path's shapes, with its time, bound, plain-version time and
           the time of one library call computing the same function
  engine   GenerationEngine over TinyDecoderLM at GPT-2-small widths
           (d 768, 12 layers x 12 heads, FFN 3072, vocab 50257, 1024
           positions): 8 requests, one sampled, two sharing a prefix;
           checks every reply and that each decode step launched the
           paged-attention kernel once per layer
  parity   teacher-forced prefill + paged decode steps (through the
           kernel) against the dense full forward, TF32 off, then once
           with TF32 on to show the limit would catch it
  profile  torch.profiler over engine decode steps: device busy time
           by kernel and the device's idle share

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; without one it
exits 2.  Weights and inputs are random from fixed seeds.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
ATOL_F32 = 2e-5             # f32 kernel vs plain: sums in another order
ATOL_BF16 = 1e-2            # bf16 output rounding (8-bit mantissa)
PARITY_LIMIT = 5e-4         # paged decode vs dense forward, f32, TF32 off

_lines = []


def emit(obj) -> None:
    line = json.dumps(obj) if not isinstance(obj, str) else obj
    _lines.append(line)
    print(line, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_cold_ms(torch, fn, flush, reps: int = 40, warm: int = 3) -> dict:
    """Device time of ``fn`` with the 50 MB L2 flushed before each call
    (the decode step finds the pool cold: eleven other layers and their
    weights pass through the cache between two calls).

    A spin kernel (``torch.cuda._sleep``) holds the stream before each
    call, so the host queues both events and every op of ``fn`` before
    the device reaches them: the event window holds device work only,
    not the host's launch gaps.  The hold doubles until the host's
    slowest enqueue fits inside it.  Returns the median, min and max over
    ``reps`` calls, the hold and the slowest enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 20
    for _ in range(8):
        hs = torch.cuda.Event(enable_timing=True)
        he = torch.cuda.Event(enable_timing=True)
        hs.record()
        torch.cuda._sleep(cycles)
        he.record()
        torch.cuda.synchronize()
        hold_ms = hs.elapsed_time(he)
        pairs, enqueue_ms = [], 0.0
        for _ in range(warm + reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()   # the hold starts after this
            torch.cuda._sleep(cycles)
            s.record()
            fn()
            e.record()
            enqueue_ms = max(enqueue_ms, (time.perf_counter() - t0) * 1e3)
            pairs.append((s, e))
        torch.cuda.synchronize()
        if enqueue_ms < hold_ms:
            times = [s.elapsed_time(e) for s, e in pairs[warm:]]
            return {"median": statistics.median(times), "min": min(times),
                    "max": max(times), "hold_ms": hold_ms,
                    "enqueue_ms_max": enqueue_ms}
        cycles *= 2
    fail(f"the host needs {enqueue_ms:.3f} ms to queue one call, more "
         f"than a {hold_ms:.3f} ms hold of the stream")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    emit(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = {"phase": "env", "card": card,
           "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit(env)
    return env


def phase_build() -> dict:
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "cached": log is None,
          "library": os.path.basename(path), "ptxas": ptxas})
    return {"log": log}


def _paged_case(torch, rng, *, b, h, kh, d, page, maxp, n_pages, lengths,
                dtype):
    """Pool pages, a page table whose live entries are distinct pages
    and whose trailing dead entries point at trash page 0, and q."""
    dev = "cuda"
    kp = torch.as_tensor(rng.standard_normal((n_pages, page, kh, d)),
                         dtype=torch.float32).to(dev, dtype)
    vp = torch.as_tensor(rng.standard_normal((n_pages, page, kh, d)),
                         dtype=torch.float32).to(dev, dtype)
    q = torch.as_tensor(rng.standard_normal((b, h, d)),
                        dtype=torch.float32).to(dev, dtype)
    table = np.zeros((b, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lengths):
        live = -(-n // page)
        table[i, :live] = [free.pop() for _ in range(live)]
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    # the decode step's shapes: 8 slots x 12 heads of 64, pages of 16,
    # 64 table entries (1024 positions), a 513-page pool; ragged lengths
    # with 1, a partial page, the full 1024 and dead trailing entries
    main_lens = [1, 37, 1024, 300, 513, 64, 777, 129]
    cases = [
        ("f32", dict(b=8, h=12, kh=12, d=64, page=16, maxp=64, n_pages=513,
                     lengths=main_lens, dtype=torch.float32), ATOL_F32),
        ("bf16", dict(b=8, h=12, kh=12, d=64, page=16, maxp=64, n_pages=513,
                      lengths=main_lens, dtype=torch.bfloat16), ATOL_BF16),
        ("gqa_kh4_f32", dict(b=8, h=12, kh=4, d=64, page=16, maxp=64,
                             n_pages=513, lengths=main_lens,
                             dtype=torch.float32), ATOL_F32),
        ("d128_gqa_f32", dict(b=3, h=8, kh=2, d=128, page=16, maxp=8,
                              n_pages=40, lengths=[5, 17, 128],
                              dtype=torch.float32), ATOL_F32),
        ("d256_bf16", dict(b=3, h=4, kh=4, d=256, page=8, maxp=6,
                           n_pages=24, lengths=[1, 9, 48],
                           dtype=torch.bfloat16), ATOL_BF16),
    ]
    results = {}
    main = None
    for name, kw, atol in cases:
        args = _paged_case(torch, rng, **kw)
        ker = pa.paged_attention(*args)
        ref = pa.paged_attention(*args, impl="torch")
        torch.cuda.synchronize()
        err = (ker.float() - ref.float()).abs().max().item()
        results[name] = {"max_abs_err": err, "atol": atol}
        if not math.isfinite(err) or err > atol:
            fail(f"paged_attention {name}: max abs err {err} > {atol}")
        if name == "f32":
            main = args

    q, kp, vp, table, lengths = main
    page = kp.shape[1]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    ker_t = time_cold_ms(torch, lambda: pa.paged_attention(*main), flush)
    plain_t = time_cold_ms(
        torch, lambda: pa.paged_attention(*main, impl="torch"), flush)
    # library yardstick: SDPA on PRE-GATHERED dense K/V with a length
    # mask — the gather is excluded from its time; the port never calls it
    b, h, d = q.shape
    maxp = table.shape[1]
    kd = kp[table.long()].reshape(b, maxp * page, h, d).transpose(1, 2)
    vd = vp[table.long()].reshape(b, maxp * page, h, d).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(maxp * page, device="cuda")[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)[:, :, 0]
    lib_err = (lib - pa.paged_attention(*main, impl="torch")).abs().max()
    lib_t = time_cold_ms(
        torch, lambda: F.scaled_dot_product_attention(q4, kd, vd,
                                                      attn_mask=mask),
        flush)
    ms, plain_ms, library_ms = (ker_t["median"], plain_t["median"],
                                lib_t["median"])
    nbytes = pa.bound_bytes(q, kp, table, lengths)
    reach = maxp * page
    flops = 4 * h * d * sum(min(int(n), reach) for n in lengths.tolist())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    out = {"phase": "kernels", "cases": results,
           "paged_attention": {
               "shape": {"B": b, "H": h, "KH": kp.shape[2], "D": d,
                         "page": page, "maxp": maxp,
                         "pool_pages": kp.shape[0],
                         "lengths": lengths.tolist(), "dtype": "float32"},
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention on pre-gathered "
                          "dense K/V with a length mask (excludes the "
                          "gather)",
               "library_max_abs_err": lib_err.item(),
               "bound_bytes": nbytes, "bound_flops": flops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
               "spread_ms": {"kernel": [ker_t["min"], ker_t["max"]],
                             "plain": [plain_t["min"], plain_t["max"]],
                             "library": [lib_t["min"], lib_t["max"]]},
               "hold_ms": {"kernel": ker_t["hold_ms"],
                           "plain": plain_t["hold_ms"],
                           "library": lib_t["hold_ms"]},
               "enqueue_ms_max": {"kernel": ker_t["enqueue_ms_max"],
                                  "plain": plain_t["enqueue_ms_max"],
                                  "library": lib_t["enqueue_ms_max"]},
               "timing": "CUDA events, median of 40 calls, L2 flushed "
                         "and the stream held by a spin kernel before "
                         "each, so the window is device time"}}
    emit(out)
    del flush
    return out


def _engine_traffic(rng, vocab: int):
    """8 prompts of 16-512 tokens; the first two share a 256-token
    prefix; request 5 is sampled."""
    shared = list(rng.integers(1, vocab, 256))
    lens = [int(n) for n in rng.integers(16, 513, 8)]
    prompts = [shared + list(rng.integers(1, vocab, 40)),
               shared + list(rng.integers(1, vocab, 120))]
    prompts += [list(rng.integers(1, vocab, n)) for n in lens[2:]]
    return [[int(t) for t in p] for p in prompts]


def phase_engine(torch, cfg, model, card: str) -> dict:
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.telemetry import tracing

    rng = np.random.default_rng(1)
    prompts = _engine_traffic(rng, cfg.vocab)
    new_tokens = 64
    # warm cuBLAS and the allocator on a throwaway engine over the same
    # model, so the measured engine's first request is not a cold start
    warm = GenerationEngine(model, max_slots=8, page_size=16, n_pages=64)
    warm.result(warm.submit(prompts[2][:24], max_new_tokens=4),
                timeout=600)
    warm.stop()

    eng = GenerationEngine(model, max_slots=8, page_size=16, n_pages=513)
    _, cursor = tracing.export_batch(0)
    pa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for i, p in enumerate(prompts):
        kw = (dict(temperature=0.8, top_k=50, seed=1234) if i == 5 else {})
        reqs.append(eng.submit(p, max_new_tokens=new_tokens, **kw))
    replies = [eng.result(r, timeout=900) for r in reqs]  # raises on error
    wall_s = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    c = dict(eng.counters)
    eng.stop()
    spans, _ = tracing.export_batch(cursor)

    for i, rep in enumerate(replies):
        if len(rep["tokens"]) != new_tokens:
            fail(f"request {i} returned {len(rep['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab for t in rep["tokens"]):
            fail(f"request {i} returned a token outside the vocabulary")
    if c["served"] != len(prompts):
        fail(f"served {c['served']} of {len(prompts)}")
    if c["cached_positions"] <= 0:
        fail("the shared prefix was not served from the prefix cache")
    if launches != c["decode_steps"] * cfg.n_layers:
        fail(f"paged_attention launched {launches} times for "
             f"{c['decode_steps']} decode steps x {cfg.n_layers} layers")

    step_ms = {}
    prefill_ms = []
    for s in spans:
        a = s.get("attrs", {})
        if s["name"] == "decode_step":
            step_ms[a["step"]] = a["step_ms"]
        elif s["name"] == "prefill":
            prefill_ms.append(a["prefill_ms"])
    if len(step_ms) != c["decode_steps"] or len(prefill_ms) != len(prompts):
        fail(f"trace holds {len(step_ms)} decode steps and "
             f"{len(prefill_ms)} prefills; engine counted "
             f"{c['decode_steps']} and {len(prompts)}")
    decode_s = sum(step_ms.values()) / 1e3
    out = {"phase": "engine", "card": card,
           "config": {"vocab": cfg.vocab, "d_model": cfg.d_model,
                      "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                      "ffn": cfg.ffn, "max_seq": cfg.max_seq,
                      "dtype": "float32", "max_slots": 8, "page_size": 16,
                      "n_pages": 513},
           "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens,
           "counters": c,
           "paged_attention_launches": launches,
           "launches_per_step": launches / max(1, c["decode_steps"]),
           "prefill_ms": prefill_ms,
           "prefill_ms_mean": statistics.mean(prefill_ms),
           "decode_step_ms_median": statistics.median(step_ms.values()),
           "decode_tokens_per_s": c["decode_positions"] / decode_s,
           "tokens_per_s_wall": c["tokens_out"] / wall_s,
           "ttft_ms": [r["ttft_ms"] for r in replies],
           "ttft_ms_median": statistics.median(r["ttft_ms"]
                                               for r in replies),
           "wall_s": wall_s,
           "sampled_tokens_head": replies[5]["tokens"][:8]}
    emit(out)
    return out


def phase_profile(torch, cfg, model) -> dict:
    """Where a decode step's time goes: the engine serves the same
    traffic (16 new tokens) under torch.profiler; device busy time by
    kernel against the decode steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import GenerationEngine

    prompts = _engine_traffic(np.random.default_rng(1), cfg.vocab)
    eng = GenerationEngine(model, max_slots=8, page_size=16, n_pages=513)
    # prefill every request before the profiled window
    reqs = [eng.submit(p, max_new_tokens=1) for p in prompts]
    for r in reqs:
        eng.result(r, timeout=900)
    torch.cuda.synchronize()
    steps0 = eng.counters["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=17) for p in prompts]
        for r in reqs:
            eng.result(r, timeout=900)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.counters["decode_steps"] - steps0
    eng.stop()
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    out = {"phase": "profile", "wall_ms": wall_ms, "decode_steps": steps,
           "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "top_kernels": [{"ms": ms, "calls": n, "name": k[:90]}
                           for ms, n, k in rows[:15]],
           "note": "window = 8 prefills (cache hits) + decode steps of 8 "
                   "requests x 16 new tokens; busy = sum of kernel self "
                   "times"}
    emit(out)
    return out


def _parity_diff(torch, cfg, model, n_steps: int) -> float:
    """Max |logit difference| of prefill + teacher-forced paged decode
    steps (the kernel) against the dense full forward at every step."""
    from paddle_tpu_torch.inference import decode_model as dm
    from paddle_tpu_torch.inference.kv_cache import PagedKVPool

    params, dev = model.params, model.device
    psz, slots = 16, 8
    maxp = -(-cfg.max_seq // psz)
    rng = np.random.default_rng(2)
    prompt_len = 300
    seq = rng.integers(1, cfg.vocab, prompt_len + n_steps).astype(np.int32)
    pool = PagedKVPool(n_pages=maxp + 1, page_size=psz,
                       n_layers=cfg.n_layers, kv_heads=cfg.n_heads,
                       head_dim=cfg.head_dim, device=dev)
    pages = pool.alloc(-(-len(seq) // psz))
    row = np.zeros(maxp, np.int32)
    row[:len(pages)] = pages

    def dense(n):
        return dm.recompute_step(
            params, torch.as_tensor(seq[None, :n], device=dev),
            torch.as_tensor([n], dtype=torch.int32, device=dev),
            n_heads=cfg.n_heads)[0][0]

    r = dm.prefill_bucket(prompt_len)
    window = np.zeros(r, np.int32)
    window[:prompt_len] = seq[:prompt_len]
    ctx_k, ctx_v = dm.gather_ctx(pool.k, pool.v,
                                 torch.as_tensor(row, device=dev),
                                 page_size=psz)
    logits, _, k_win, v_win = dm.prefill(
        params, torch.as_tensor(window, device=dev), 0, ctx_k, ctx_v,
        prompt_len, n_heads=cfg.n_heads)
    flat = np.zeros(r, np.int32)
    flat[:prompt_len] = [pages[i // psz] * psz + i % psz
                         for i in range(prompt_len)]
    dm.scatter_kv(pool.k, pool.v, k_win, v_win,
                  torch.as_tensor(flat, device=dev))
    worst = (logits - dense(prompt_len)).abs().max().item()
    table = np.zeros((slots, maxp), np.int32)
    table[0] = row
    table_t = torch.as_tensor(table, device=dev)
    for j in range(n_steps):
        pos = prompt_len + j
        tokens = np.zeros(slots, np.int32)
        positions = np.zeros(slots, np.int32)
        write = np.zeros(slots, np.int32)
        tokens[0], positions[0] = seq[pos], pos
        write[0] = pages[pos // psz] * psz + pos % psz
        logits, _, _, _ = dm.decode_step(
            params, pool.k, pool.v, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev), table_t,
            torch.as_tensor(write, device=dev), page_size=psz,
            n_heads=cfg.n_heads)
        worst = max(worst, (logits[0] - dense(pos + 1)).abs().max().item())
    return worst


def phase_parity(torch, cfg, model) -> dict:
    n_steps = 40
    diff = _parity_diff(torch, cfg, model, n_steps)
    if not math.isfinite(diff) or diff > PARITY_LIMIT:
        fail(f"paged decode vs dense forward: {diff} > {PARITY_LIMIT}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        diff_tf32 = _parity_diff(torch, cfg, model, 8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "parity", "steps": n_steps, "prompt_len": 300,
           "max_abs_logit_diff": diff, "limit": PARITY_LIMIT,
           "max_abs_logit_diff_tf32": diff_tf32,
           "tf32_exceeds_limit": diff_tf32 > PARITY_LIMIT}
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every JSON line to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    os.environ["PADDLE_TRACING"] = "1"   # engine spans: per-step times
    env = phase_env(torch)
    build = phase_build()
    kern = phase_kernels(torch)

    from paddle_tpu_torch.inference import DecoderConfig, TinyDecoderLM

    # GPT-2 small's published widths (BERT-base's too), 50257-token
    # vocabulary and 1024 positions; random weights from seed 0
    cfg = DecoderConfig(vocab=50257, d_model=768, n_layers=12, n_heads=12,
                        ffn=3072, max_seq=1024)
    model = TinyDecoderLM(cfg, seed=0, device="cuda")
    eng = phase_engine(torch, cfg, model, env["card"])
    phase_parity(torch, cfg, model)
    phase_profile(torch, cfg, model)

    pa = kern["paged_attention"]
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:144",
        "launches": eng["paged_attention_launches"],
        "max_abs_err": kern["cases"]["f32"]["max_abs_err"],
        "ms": pa["ms"], "plain_ms": pa["plain_ms"],
        "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
        "library_ms": pa["library_ms"]}]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(_lines + [json.dumps(
                {"build_log": build["log"]})]) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
