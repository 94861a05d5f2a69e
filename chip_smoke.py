#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, each printing one JSON line (any failure exits nonzero and
prints no result):

  env          card name and power limit (nvidia-smi), torch/CUDA
               versions; TF32 off for matmuls and cuDNN
  build        nvcc builds every kernel library from ``csrc/`` (one nvcc
               per source, all started together): each library's path
               and its ptxas register/spill lines
  kernels      each kernel against its plain PyTorch version at its main
               path's shapes (paged attention; BSH flash attention, o and
               lse; add+LayerNorm, out and stats), with its time, bound,
               plain-version time and the time of one library call
               computing the same function
  engine       GenerationEngine over TinyDecoderLM at GPT-2-small widths
               (d 768, 12 layers x 12 heads, FFN 3072, vocab 50257, 1024
               positions): 8 requests, one sampled, two sharing a prefix;
               checks every reply and that each decode step launched the
               paged-attention kernel once per layer
  parity       teacher-forced prefill + paged decode steps (through the
               kernel) against the dense full forward, TF32 off, then once
               with TF32 on to show the limit would catch it
  profile      torch.profiler over engine decode steps: device busy time
               by kernel and the device's idle share
  bert_infer   BERT-base (vocab 30522, hidden 768, 12 layers x 12 heads
               of 64, FFN 3072, 512 positions) built with dropout, frozen
               by freeze_program and served by the Predictor on the card:
               20 batches of 8 x 512 with padded requests; checks every
               fetch and that each run launched the flash kernel 12 times
               and the LayerNorm kernel 25 times
  bert_parity  the frozen BERT-base on the card (kernels) against the
               same model and weights on the CPU (plain versions) on a
               2 x 128 padded batch, TF32 off, then once with TF32 on
  bert_profile torch.profiler over 5 Predictor runs: device busy time by
               kernel and the device's idle share

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
# bf16 outputs of the flash and LN kernels: both versions compute in f32
# and round once, so they may differ by one bf16 ulp (2**-7 relative)
RTOL_BF16 = 2.0 ** -7
ATOL_LSE = 1e-4             # f32 log-sum-exp over up to 512 keys
PARITY_LIMIT = 5e-4         # paged decode vs dense forward, f32, TF32 off
BERT_PARITY_LIMIT = 5e-4    # BERT-base card vs CPU, f32, TF32 off

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
    built = _build.build_all()
    secs = time.perf_counter() - t0
    libs = {}
    for name, (path, log) in built.items():
        libs[name] = {
            "library": os.path.basename(path), "cached": log is None,
            "ptxas": [ln.strip() for ln in (log or "").splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit({"phase": "build", "seconds": secs, "libraries": libs})
    return {"log": {name: log for name, (_, log) in built.items()}}


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


def _timed(torch, flush, kernel_fn, plain_fn, library_fn, *, nbytes,
           flops, peak_flops) -> dict:
    """Device times (time_cold_ms) of the kernel, its plain version and
    the library call, and the bound: the larger of bytes / HBM rate and
    flops / the dtype's peak."""
    ker_t = time_cold_ms(torch, kernel_fn, flush)
    plain_t = time_cold_ms(torch, plain_fn, flush)
    lib_t = time_cold_ms(torch, library_fn, flush)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    ms = ker_t["median"]
    return {"ms": ms, "plain_ms": plain_t["median"],
            "library_ms": lib_t["median"],
            "bound_bytes": nbytes, "bound_flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
            "achieved_TFLOPs": flops / (ms * 1e-3) / 1e12,
            "spread_ms": {"kernel": [ker_t["min"], ker_t["max"]],
                          "plain": [plain_t["min"], plain_t["max"]],
                          "library": [lib_t["min"], lib_t["max"]]},
            "hold_ms": {"kernel": ker_t["hold_ms"],
                        "plain": plain_t["hold_ms"],
                        "library": lib_t["hold_ms"]},
            "enqueue_ms_max": {"kernel": ker_t["enqueue_ms_max"],
                               "plain": plain_t["enqueue_ms_max"],
                               "library": lib_t["enqueue_ms_max"]},
            "timing": "CUDA events, median of 40 calls, L2 flushed and "
                      "the stream held by a spin kernel before each, so "
                      "the window is device time"}


def _check(name, ker, ref, atol, rtol=0.0) -> dict:
    """Max abs error of ker vs ref; fails unless every element is within
    atol + rtol * |ref|."""
    diff = (ker.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - atol - rtol * ref.float().abs()).max().item()
    if not math.isfinite(err) or excess > 0:
        fail(f"{name}: max abs err {err} beyond atol {atol} + rtol {rtol}")
    return {"max_abs_err": err, "atol": atol, "rtol": rtol}


def _kernels_paged(torch, F, flush) -> tuple:
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
        results[name] = _check(f"paged_attention {name}", ker, ref, atol)
        if name == "f32":
            main = args

    q, kp, vp, table, lengths = main
    page = kp.shape[1]
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
    reach = maxp * page
    out = {"shape": {"B": b, "H": h, "KH": kp.shape[2], "D": d,
                     "page": page, "maxp": maxp, "pool_pages": kp.shape[0],
                     "lengths": lengths.tolist(), "dtype": "float32"},
           "library": "F.scaled_dot_product_attention on pre-gathered "
                      "dense K/V with a length mask (excludes the gather)",
           "library_max_abs_err": lib_err.item()}
    out.update(_timed(
        torch, flush, lambda: pa.paged_attention(*main),
        lambda: pa.paged_attention(*main, impl="torch"),
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask),
        nbytes=pa.bound_bytes(q, kp, table, lengths),
        flops=4 * h * d * sum(min(int(n), reach) for n in lengths.tolist()),
        peak_flops=F32_FLOPS))
    out["max_abs_err"] = results["f32"]["max_abs_err"]
    return results, out


def _key_bias(torch, rng, b, s):
    """BERT's additive padding mask as a per-key bias [B, 1, 1, S]: 0 on
    the first len_b keys, -1e4 on the padding; lengths 128..S."""
    lens = rng.integers(128, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return torch.as_tensor(1e4 * (mask - 1.0))[:, None, None, :].to("cuda")


def _kernels_flash(torch, F, flush) -> tuple:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(3)

    def case(b, s, nh, d, dtype, bias, causal=False):
        h = nh * d
        q, k, v = (torch.as_tensor(rng.standard_normal((b, s, h)),
                                   dtype=torch.float32).to("cuda", dtype)
                   for _ in range(3))
        kb = _key_bias(torch, rng, b, s) if bias else None
        return dict(q=q, k=k, v=v, bias=kb, num_heads=nh, causal=causal)

    # the BERT-base attention of the infer path (B=8, S=512, 12 x 64),
    # padded, in f32 (the main path) and bf16; causal; D=128 and D=256
    cases = [
        ("f32", case(8, 512, 12, 64, torch.float32, True), False),
        ("bf16", case(8, 512, 12, 64, torch.bfloat16, True), True),
        ("causal_f32", case(8, 512, 12, 64, torch.float32, False, True),
         False),
        ("d128_f32", case(8, 512, 12, 128, torch.float32, True), False),
        ("d256_bf16", case(2, 512, 12, 256, torch.bfloat16, True), True),
    ]
    results = {}
    for name, kw, is_bf16 in cases:
        o, lse = fa.flash_attention_bsh_fwd(**kw)
        o_ref, lse_ref = fa.flash_attention_bsh_reference(**kw)
        torch.cuda.synchronize()
        r = _check(f"flash_attention_bsh {name} o", o, o_ref,
                   1e-5 if is_bf16 else ATOL_F32,
                   RTOL_BF16 if is_bf16 else 0.0)
        r["lse"] = _check(f"flash_attention_bsh {name} lse", lse, lse_ref,
                          ATOL_LSE)
        results[name] = r

    kw = cases[0][1]
    q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
    b, s, h = q.shape
    nh = kw["num_heads"]
    # library yardstick: SDPA on PRE-SPLIT heads [B, nh, S, D] with the
    # additive [B, 1, 1, S] mask (the head split is excluded)
    qh, kh, vh = (t.reshape(b, s, nh, h // nh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    lib_err = (lib.transpose(1, 2).reshape(b, s, h)
               - fa.flash_attention_bsh_reference(**kw)[0]).abs().max()
    out = {"shape": {"B": b, "S": s, "H": h, "nh": nh, "D": h // nh,
                     "bias": "per key, lengths 128..512",
                     "dtype": "float32"},
           "library": "F.scaled_dot_product_attention on pre-split heads "
                      "with the additive [B, 1, 1, S] mask",
           "library_max_abs_err": lib_err.item()}
    out.update(_timed(
        torch, flush, lambda: fa.flash_attention_bsh_fwd(**kw),
        lambda: fa.flash_attention_bsh_reference(**kw),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias),
        nbytes=fa.bound_bytes(q, k, v, bias, nh),
        flops=fa.bound_flops(q, k, nh), peak_flops=F32_FLOPS))
    out["max_abs_err"] = results["f32"]["max_abs_err"]
    return results, out


def _kernels_ln(torch, F, flush) -> tuple:
    from paddle_tpu_torch.ops.kernels import add_ln

    rng = np.random.default_rng(4)
    r, h = 4096, 768  # the infer path's rows (8 x 512) and BERT-base width

    def case(dtype, with_y):
        x, y = (torch.as_tensor(rng.standard_normal((r, h)),
                                dtype=torch.float32).to("cuda", dtype)
                for _ in range(2))
        scale = torch.as_tensor(1 + 0.1 * rng.standard_normal(h),
                                dtype=torch.float32).to("cuda")
        shift = torch.as_tensor(0.1 * rng.standard_normal(h),
                                dtype=torch.float32).to("cuda")
        return dict(x=x, y=y if with_y else None, scale=scale, shift=shift,
                    eps=1e-5)

    # layer_norm of the infer path: f32, no residual (the main path);
    # the residual y and bf16 as the encoder stack will use them
    cases = [("f32", case(torch.float32, False), False),
             ("f32_y", case(torch.float32, True), False),
             ("bf16", case(torch.bfloat16, False), True),
             ("bf16_y", case(torch.bfloat16, True), True)]
    results = {}
    for name, kw, is_bf16 in cases:
        out, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
        out_r, mean_r, rstd_r = add_ln.fused_add_ln_reference(**kw)
        torch.cuda.synchronize()
        res = _check(f"add_ln {name} out", out, out_r,
                     1e-5 if is_bf16 else ATOL_F32,
                     RTOL_BF16 if is_bf16 else 0.0)
        res["mean"] = _check(f"add_ln {name} mean", mean, mean_r, ATOL_F32)
        res["rstd"] = _check(f"add_ln {name} rstd", rstd, rstd_r, ATOL_F32)
        results[name] = res

    kw = cases[0][1]
    x, scale, shift = kw["x"], kw["scale"], kw["shift"]
    lib = F.layer_norm(x, (h,), scale, shift, 1e-5)
    lib_err = (lib - add_ln.fused_add_ln_reference(**kw)[0]).abs().max()
    out = {"shape": {"R": r, "H": h, "y": False, "dtype": "float32"},
           "library": "F.layer_norm (no stats returned)",
           "library_max_abs_err": lib_err.item()}
    out.update(_timed(
        torch, flush, lambda: add_ln.fused_add_ln_fwd(**kw),
        lambda: add_ln.fused_add_ln_reference(**kw),
        lambda: F.layer_norm(x, (h,), scale, shift, 1e-5),
        nbytes=add_ln.bound_bytes(x, None),
        flops=add_ln.bound_flops(x, None), peak_flops=F32_FLOPS))
    out["max_abs_err"] = results["f32"]["max_abs_err"]
    return results, out


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version (every case), then timed at
    its main path's shapes."""
    import torch.nn.functional as F

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    out = {"phase": "kernels", "cases": {}}
    for name, fn in (("paged_attention", _kernels_paged),
                     ("flash_attention_bsh", _kernels_flash),
                     ("add_ln", _kernels_ln)):
        out["cases"][name], out[name] = fn(torch, F, flush)
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


def _device_rows(torch, prof) -> list:
    """(ms, calls, name) of every device-side event (kernels, memcpys,
    memsets), largest first.  CPU-side ops are left out: the profiler
    also books a leaf op's kernels as that op's self device time, so
    summing both counts the kernel twice."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == cuda and evt.self_device_time_total > 0]
    return sorted(rows, reverse=True)


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
    rows = _device_rows(torch, prof)
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


def _bert_program(cfg, b: int, s: int):
    """BERT-base encoder + pooler over [b, s] feeds, built in training
    mode (dropout 0.1 present), as a user would before freezing."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        def data(name, dtype):
            return fluid.layers.data(name, [b, s], dtype,
                                     append_batch_size=False)

        ids, types, pos = (data(n, "int32") for n in
                           ("input_ids", "token_type_ids", "position_ids"))
        mask = data("input_mask", "float32")
        seq = bert.bert_encoder(cfg, ids, types, pos, mask, is_test=False)
        pooled = bert.bert_pooler(cfg, seq)
    return main, startup, seq, pooled


def _bert_batch(rng, cfg, b: int, s: int, min_len: int) -> dict:
    """b requests padded to s: lengths min_len..s, random tokens, two
    segments, positions 0..s-1, input_mask 1 on the live tokens."""
    lens = rng.integers(min_len, s + 1, b)
    live = np.arange(s)[None, :] < lens[:, None]
    return {
        "input_ids": np.where(live, rng.integers(1, cfg.vocab_size, (b, s)),
                              0).astype(np.int32),
        "token_type_ids": (np.arange(s)[None, :]
                           >= (lens // 2)[:, None]).astype(np.int32),
        "position_ids": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
        "input_mask": live.astype(np.float32)}


def phase_bert_infer(torch, card: str) -> dict:
    """BERT-base frozen and served on the card: the infer path."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import ServingPredictor, freeze_program
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = bert.BertConfig.base()
    b, s, n_runs = 8, 512, 20
    t0 = time.perf_counter()
    main, startup, seq, pooled = _bert_program(cfg, b, s)
    build_s = time.perf_counter() - t0
    scope = fluid.Scope()
    t0 = time.perf_counter()
    fluid.Executor().run(startup, scope=scope)   # device=None: the card
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    frozen = freeze_program(main, scope=scope, fetch_list=[seq, pooled])
    ops = frozen.program.global_block().ops
    live_dropout = [op for op in ops if op.type in
                    ("dropout", "fused_multihead_attention")
                    and not op.attr("is_test")]
    if live_dropout:
        fail(f"frozen program keeps {len(live_dropout)} ops in training "
             f"mode")
    n_params = sum(frozen.scope.find_var(n).numel()
                   for n in frozen.param_names)
    pred = ServingPredictor(frozen)               # device=None: the card
    if pred.device.type != "cuda":
        fail(f"the predictor runs on {pred.device}, not the card")

    rng = np.random.default_rng(5)
    batches = [_bert_batch(rng, cfg, b, s, 128) for _ in range(n_runs)]
    pred.run(batches[0])                          # warm cuBLAS + allocator
    torch.cuda.synchronize()
    fa.flash_attention_bsh.launches = 0
    add_ln.fused_add_ln.launches = 0
    run_ms, outs = [], None
    for feed in batches:
        t0 = time.perf_counter()
        outs = pred.run(feed)                     # numpy fetch: synchronises
        run_ms.append((time.perf_counter() - t0) * 1e3)
        for name, arr, shape in zip(frozen.fetch_names, outs,
                                    [(b, s, cfg.hidden_size),
                                     (b, cfg.hidden_size)]):
            if arr.shape != shape or not np.isfinite(arr).all():
                fail(f"fetch {name}: shape {arr.shape} (want {shape}) or "
                     f"non-finite values")
    flash_n = fa.flash_attention_bsh.launches
    ln_n = add_ln.fused_add_ln.launches
    layers = cfg.num_hidden_layers
    if flash_n != layers * n_runs:
        fail(f"flash_attention_bsh launched {flash_n} times in {n_runs} "
             f"runs, want {layers} a run")
    if ln_n != (2 * layers + 1) * n_runs:
        fail(f"add_ln launched {ln_n} times in {n_runs} runs, want "
             f"{2 * layers + 1} a run")
    med = statistics.median(run_ms)
    out = {"phase": "bert_infer", "card": card,
           "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                      "layers": layers, "heads": cfg.num_attention_heads,
                      "ffn": cfg.intermediate_size,
                      "positions": cfg.max_position_embeddings,
                      "dtype": "float32", "batch": b, "seq": s},
           "params": n_params, "frozen_ops": len(ops),
           "build_s": build_s, "startup_s": startup_s, "runs": n_runs,
           "run_ms_median": med, "run_ms_min": min(run_ms),
           "run_ms_max": max(run_ms),
           "sequences_per_s": b / (med / 1e3),
           "live_tokens_per_run": [int(f["input_mask"].sum())
                                   for f in batches[:4]],
           "flash_launches": flash_n, "ln_launches": ln_n,
           "pooled_head": outs[1][0, :4].tolist()}
    emit(out)
    return dict(out, frozen=frozen, batches=batches, pred=pred)


def _bert_parity_diff(cfg, weights) -> dict:
    """Max |diff| of seq_out and pooled between the card (kernels) and
    the CPU (plain versions) on one 2 x 128 padded batch."""
    from paddle_tpu_torch.inference import ServingPredictor, freeze_program

    b, s = 2, 128
    main, _, seq, pooled = _bert_program(cfg, b, s)
    frozen = freeze_program(main, scope=weights, fetch_list=[seq, pooled])
    feed = _bert_batch(np.random.default_rng(6), cfg, b, s, 64)
    card = ServingPredictor(frozen).run(feed)
    cpu = ServingPredictor(frozen, device="cpu").run(feed)
    return {name: float(np.abs(a - c).max())
            for name, a, c in zip(("seq_out", "pooled"), card, cpu)}


def phase_bert_parity(torch, infer: dict) -> dict:
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = bert.BertConfig.base()
    weights = infer["frozen"].scope
    n0 = (fa.flash_attention_bsh.launches, add_ln.fused_add_ln.launches)
    diff = _bert_parity_diff(cfg, weights)
    launched = (fa.flash_attention_bsh.launches - n0[0],
                add_ln.fused_add_ln.launches - n0[1])
    if launched != (cfg.num_hidden_layers, 2 * cfg.num_hidden_layers + 1):
        fail(f"the parity run launched flash/LN {launched} times")
    worst = max(diff.values())
    if not math.isfinite(worst) or worst > BERT_PARITY_LIMIT:
        fail(f"BERT-base card vs CPU: {diff} > {BERT_PARITY_LIMIT}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        diff_tf32 = _bert_parity_diff(cfg, weights)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "bert_parity", "batch": 2, "seq": 128,
           "max_abs_diff": diff, "limit": BERT_PARITY_LIMIT,
           "max_abs_diff_tf32": diff_tf32,
           "tf32_exceeds_limit": max(diff_tf32.values()) > BERT_PARITY_LIMIT}
    emit(out)
    return out


def phase_bert_profile(torch, infer: dict) -> dict:
    """Where a BERT-base run's time goes: 5 Predictor runs under
    torch.profiler; device busy time by kernel against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    pred, batches = infer["pred"], infer["batches"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for feed in batches[:5]:
            pred.run(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    out = {"phase": "bert_profile", "runs": 5, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "top_kernels": [{"ms": ms, "calls": n, "name": k[:90]}
                           for ms, n, k in rows[:15]],
           "note": "window = 5 Predictor.run calls of 8 x 512 (feed copy, "
                   "ops, numpy fetch); busy = sum of kernel self times"}
    emit(out)
    return out


def _kernel_entry(name, source, replaces, launches, k) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]}


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
    del model
    torch.cuda.empty_cache()

    infer = phase_bert_infer(torch, env["card"])
    phase_bert_parity(torch, infer)
    phase_bert_profile(torch, infer)

    emit({"kernels": [
        _kernel_entry("paged_attention", "paged_attention.cu",
                      "paddle_tpu/ops/pallas/paged_attention.py:144",
                      eng["paged_attention_launches"],
                      kern["paged_attention"]),
        _kernel_entry("flash_attention_bsh", "flash_attention_bsh.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:1500",
                      infer["flash_launches"],
                      kern["flash_attention_bsh"]),
        _kernel_entry("add_ln", "add_ln.cu",
                      "paddle_tpu/ops/pallas/add_ln.py:145",
                      infer["ln_launches"], kern["add_ln"])]})
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
