#!/usr/bin/env python3
"""Time the port's redesigned kernels and their neighbours at the main
paths' shapes on one CUDA card, for two trees of the repository in one
call: a parent checkout and this one, in turns (A, B, B, A).

    python3 chip_kernel_ab.py --trees PARENT_DIR . [--steps] [--out FILE]

With ``--steps`` a turn times only the gradient of an embedding lookup
(``take``'s backward at BERT's three table sizes, 4096 and 32,768 ids)
and whole training steps of bert_train, bert_long_train and
transformer_train (``_whole_steps``); without it, the cases below.

Each turn is a process of its own that puts its tree first on sys.path,
builds that tree's kernels from its ``csrc/`` and times each kernel
through the public wrappers both trees share (bf16 unless named, the
shapes ``chip_smoke.py`` times): row 11 (``mm_stats``) at five 1 x 1
shapes of ResNet-50 at batch 128, row 10 (``conv_stats``) at the four 3
x 3 stage shapes, rows 12-14 at [401408, 256], row 6 at the NMT
encoder's shape (full bias, with and without Philox dropout) and at
mha_key_train's (key bias), rows 8 and 9 at the encoder's shape, row 7 at
mha_key_train's (causal off and on, with and without Philox), row 5 at
BERT-base's
training shape, row 4 there (with and without Philox, and f32 at the
infer path's shape) and at the NMT decoder's two shapes, row 1 at the
decode step's shape (f32, bf16, and f32 with 4 kv heads) and the device
time of a whole decode step at GPT-2 small's widths around it (the sum
of its ops' times in a torch.profiler window), rows 2 and 3 at BERT-base's (row 3 also in f32
without the residual) and at the NMT step's (16,384 x 512, bf16, the
residual), row 4 in f32 also at nmt_infer's two decoder shapes (8 x
256, 8 heads of 64: causal self-attention, key-bias cross-attention),
and a whole BERT-base training step of chip_smoke's bert_train through
the tree's own Executor (its host wall time and peak device memory).
Yardsticks beside
them (the same in both trees): the clock's floor, a 4-byte ``zero_``,
and torch ops that move rows 1 and 2's bytes (``max`` of 17.5 MB,
``torch.add`` of the BERT and NMT rows, ``copy_`` of the ``infer`` rows).
Device times come
from ``chip_smoke.time_cold_ms`` of the tree that runs this script (CUDA
events, L2 flushed, the stream held), the same clock for both trees.
Prints one JSON line per turn and, last before the card line, a
summary: each case's median per tree, and this tree's time over the
parent's (a case only one tree has gives the other's as null).  Needs
one card; without one it exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (N, H, W, C, O, stride) of ResNet-50 at batch 128
MM_SHAPES = {"s0_64to256": (128, 56, 56, 64, 256, 1),
             "s0_256to64": (128, 56, 56, 256, 64, 1),
             "s1_proj_s2_256to512": (128, 56, 56, 256, 512, 2),
             "s2_1024to256": (128, 14, 14, 1024, 256, 1),
             "s3_512to2048": (128, 7, 7, 512, 2048, 1)}
CONV_SHAPES = {"s0": (128, 56, 56, 64, 64), "s1": (128, 28, 28, 128, 128),
               "s2": (128, 14, 14, 256, 256), "s3": (128, 7, 7, 512, 512)}


def _measure(tree: str, steps_only: bool = False) -> dict:
    """Build ``tree``'s kernels and time every case (``steps_only``: the
    embedding gradients and the whole training steps only); runs in its
    own process with the tree first on sys.path."""
    import importlib.util

    sys.path.insert(0, tree)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_clock", os.path.join(HERE, "chip_smoke.py"))
    clock = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clock)
    time_cold_ms = clock.time_cold_ms
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import conv_bn as cb
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    if not os.path.abspath(cb.__file__).startswith(tree + os.sep):
        raise SystemExit(f"imported {cb.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev, bf16 = "cuda", torch.bfloat16
    rng = np.random.default_rng(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    if steps_only:
        out = _embedding_grads(torch, time_cold_ms, flush)
        out.update(_whole_steps(torch, clock))
        return {"tree": tree, "card": torch.cuda.get_device_name(0),
                "ms": out}

    def randn(*shape, scale=1.0):
        return (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
                * scale).to(dev, bf16)

    def ms(fn):
        return time_cold_ms(torch, fn, flush, reps=30)["median"]

    out = {}
    for name, (n, h, w, c, o, st) in MM_SHAPES.items():
        x = randn(n, h, w, c)
        wt = randn(o, c, 1, 1, scale=math.sqrt(2.0 / c))
        out[f"row11_mm_stats_{name}"] = ms(
            lambda x=x, wt=wt, st=st: cb.mm_stats(x, wt, (st, st)))
        del x, wt
    for name, (n, h, w, c, o) in CONV_SHAPES.items():
        x = randn(n, h, w, c)
        wt = randn(o, c, 3, 3, scale=math.sqrt(2.0 / (9 * c)))
        out[f"row10_conv_stats_{name}"] = ms(
            lambda x=x, wt=wt: cb.conv_stats(x, wt, ((1, 1), (1, 1))))
        del x, wt
    z, g = randn(401408, 256), randn(401408, 256)
    stat = torch.stack([torch.zeros(256), torch.ones(256), torch.ones(256),
                        torch.full((256,), 0.1)]).to(dev)
    tot = torch.ones(2, 256, device=dev)
    out["row12_bn_apply"] = ms(lambda: cb.bn_apply(z, stat, True))
    out["row13_bn_bwd_reduce"] = ms(lambda: cb.bn_bwd_reduce(z, g, stat,
                                                             True))
    out["row14_bn_bwd_dz"] = ms(lambda: cb.bn_bwd_dz(z, g, stat, tot, True))
    del z, g

    # the NMT encoder: B 64, nh 8, S 256, D 64, the [B, nh, S, S] bf16
    # padding bias, Philox p = 0.1
    b, nh, s, d = 64, 8, 256, 64
    q, k, v, do = (randn(b, nh, s, d) for _ in range(4))
    lens = rng.integers(s // 2, s + 1, b)
    key = 1e4 * ((np.arange(s)[None, :] < lens[:, None]) - 1.0)
    full = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        key[:, None, None, :], (b, nh, s, s))), dtype=torch.float32).to(
        dev, bf16)
    seed, p, sm = 12345, 0.1, 1.0 / math.sqrt(d)
    out["row6_fwd_full_philox"] = ms(lambda: fa.flash_attention_fwd(
        q, k, v, full, dropout_prob=p, dropout_seed=seed))
    out["row6_fwd_full_no_dropout"] = ms(lambda: fa.flash_attention_fwd(
        q, k, v, full))
    o, lse = fa.flash_attention_fwd(q, k, v, full, dropout_prob=p,
                                    dropout_seed=seed)
    bias_k, mode, dims = fa._classify_bias(full, b, nh, s)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, sm, False, 0, 0, p,
            None, seed, 0, False)
    out["row8_bwd_dq_full_philox"] = ms(
        lambda: fa.flash_attention_bwd_dq(*args))
    out["row9_bwd_dkv_full_philox"] = ms(
        lambda: fa.flash_attention_bwd_dkv(*args))
    del full, bias_k, args

    # mha_key_train: the same q, k, v with a [1, 1, 1, S] padding bias
    kb = torch.as_tensor(np.where(np.arange(s) < s - 64, 0.0, -1e4)
                         .reshape(1, 1, 1, s), dtype=torch.float32).to(dev)
    out["row6_fwd_key_philox"] = ms(lambda: fa.flash_attention_fwd(
        q, k, v, kb, dropout_prob=p, dropout_seed=seed))
    o, lse = fa.flash_attention_fwd(q, k, v, kb, dropout_prob=p,
                                    dropout_seed=seed)
    bias_k, mode, dims = fa._classify_bias(kb, b, nh, s)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, sm, False, 0, 0, p,
            None, seed, 0, False)
    out["row7_bwd_fused_key_philox"] = ms(
        lambda: fa.flash_attention_bwd_fused(*args))
    for causal in (False, True):
        for drop in (False, True):
            if drop and not causal:
                continue  # timed above
            o, lse = fa.flash_attention_fwd(
                q, k, v, kb, causal=causal, dropout_prob=p if drop else 0.0,
                dropout_seed=seed if drop else None)
            delta = (o.float() * do.float()).sum(-1)
            a = (q, k, v, bias_k, mode, dims, lse, delta, do, sm, causal, 0,
                 0, p if drop else 0.0, None, seed if drop else None, 0,
                 False)
            name = (f"row7_bwd_fused_key_{'philox' if drop else 'no_dropout'}"
                    f"{'_causal' if causal else ''}")
            out[name] = ms(lambda a=a: fa.flash_attention_bwd_fused(*a))
    del q, k, v, do, o, lse, args

    # BERT-base training: B 8, S 512, 12 heads of 64, per-key bias
    b, s, nh, d = 8, 512, 12, 64
    q, k, v, do = (randn(b, s, nh * d) for _ in range(4))
    bias = torch.zeros(b, 1, 1, s, device=dev)
    o, lse = fa.flash_attention_bsh_fwd(q, k, v, bias, nh, dropout_prob=p,
                                        dropout_seed=seed)
    out["row5_bsh_bwd_philox"] = ms(lambda: fa.flash_attention_bsh_bwd(
        q, k, v, bias, o, lse, do, nh, dropout_prob=p, dropout_seed=seed))
    out["row4_bsh_fwd_philox"] = ms(lambda: fa.flash_attention_bsh_fwd(
        q, k, v, bias, nh, dropout_prob=p, dropout_seed=seed))
    out["row4_bsh_fwd_no_dropout"] = ms(lambda: fa.flash_attention_bsh_fwd(
        q, k, v, bias, nh))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    out["row4_bsh_fwd_f32_infer"] = ms(lambda: fa.flash_attention_bsh_fwd(
        q32, k32, v32, bias, nh))
    del q, k, v, do, o, lse, q32, k32, v32

    # the NMT decoder: B 64, S 256, 8 heads of 64, Philox p = 0.1; the
    # causal self-attention and the cross-attention's per-key bias
    b, s, nh = 64, 256, 8
    q, k, v = (randn(b, s, nh * 64) for _ in range(3))
    src = torch.as_tensor(np.where(np.arange(s)[None, :] < rng.integers(
        s // 2, s + 1, b)[:, None], 0.0, -1e4).reshape(b, 1, 1, s),
        dtype=torch.float32).to(dev)
    out["row4_bsh_fwd_nmt_self_causal_philox"] = ms(
        lambda: fa.flash_attention_bsh_fwd(q, k, v, None, nh, causal=True,
                                           dropout_prob=p, dropout_seed=seed))
    out["row4_bsh_fwd_nmt_cross_key_philox"] = ms(
        lambda: fa.flash_attention_bsh_fwd(q, k, v, src, nh, dropout_prob=p,
                                           dropout_seed=seed))
    del q, k, v, src

    # row 1 at the decode step's shape (8 slots x 12 heads of 64, pages of
    # 16, 64 table entries, a 513-page pool), f32
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    lens = [1, 37, 1024, 300, 513, 64, 777, 129]
    kp, vp = (torch.as_tensor(rng.standard_normal((513, 16, 12, 64)),
                              dtype=torch.float32).to(dev) for _ in range(2))
    qd = torch.as_tensor(rng.standard_normal((8, 12, 64)),
                         dtype=torch.float32).to(dev)
    table = np.zeros((8, 64), np.int32)
    free = list(rng.permutation(np.arange(1, 513)))
    for i, n in enumerate(lens):
        table[i, :-(-n // 16)] = [free.pop() for _ in range(-(-n // 16))]
    table = torch.as_tensor(table, device=dev)
    lengths = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    out["row1_paged_f32"] = ms(lambda: pa.paged_attention(
        qd, kp, vp, table, lengths))
    kb, vb, qb = kp.to(bf16), vp.to(bf16), qd.to(bf16)
    out["row1_paged_bf16"] = ms(lambda: pa.paged_attention(
        qb, kb, vb, table, lengths))
    # grouped-query: 4 kv heads for the 12 query heads
    kg, vg = kp[:, :, :4].contiguous(), vp[:, :, :4].contiguous()
    out["row1_paged_gqa_kh4_f32"] = ms(lambda: pa.paged_attention(
        qd, kg, vg, table, lengths))
    del kp, vp, qd, table, lengths, kb, vb, qb, kg, vg

    # rows 2 and 3 at BERT-base's rows (8 x 512 x 768): f32 without the
    # residual (infer), bf16 with it (train)
    x32 = torch.as_tensor(rng.standard_normal((4096, 768)),
                          dtype=torch.float32).to(dev)
    x, y, g = (randn(4096, 768) for _ in range(3))
    sc = torch.ones(768, device=dev)
    sh = torch.zeros(768, device=dev)
    out["row2_ln_fwd_f32"] = ms(lambda: add_ln.fused_add_ln_fwd(
        x32, None, sc, sh))
    out["row2_ln_fwd_bf16_y"] = ms(lambda: add_ln.fused_add_ln_fwd(
        x, y, sc, sh))
    _, mean, rstd = add_ln.fused_add_ln_fwd(x, y, sc, sh)
    out["row3_ln_bwd_bf16_y"] = ms(lambda: add_ln.fused_add_ln_bwd(
        x, y, sc, mean, rstd, g))
    g32 = torch.as_tensor(rng.standard_normal((4096, 768)),
                          dtype=torch.float32).to(dev)
    _, mean32, rstd32 = add_ln.fused_add_ln_fwd(x32, None, sc, sh)
    out["row3_ln_bwd_f32"] = ms(lambda: add_ln.fused_add_ln_bwd(
        x32, None, sc, mean32, rstd32, g32))
    del x32, g32, x, y, g

    # rows 2 and 3 at the NMT step's rows (64 x 256 tokens, d_model 512),
    # bf16 with the residual
    x, y, g = (randn(16384, 512) for _ in range(3))
    sc = torch.ones(512, device=dev)
    sh = torch.zeros(512, device=dev)
    out["row2_ln_fwd_nmt_bf16_y"] = ms(lambda: add_ln.fused_add_ln_fwd(
        x, y, sc, sh))
    _, mean, rstd = add_ln.fused_add_ln_fwd(x, y, sc, sh)
    out["row3_ln_bwd_nmt_bf16_y"] = ms(lambda: add_ln.fused_add_ln_bwd(
        x, y, sc, mean, rstd, g))
    del x, y, g

    # yardsticks: the clock's floor (a 4-byte zero_ between the same
    # events) and torch ops that move rows 1 and 2's bytes
    tiny = torch.empty(1, device=dev)
    out["yard_floor_zero_4B"] = ms(lambda: tiny.zero_())
    big = torch.empty(4_382_398, device=dev)  # 17.5 MB: row 1's bytes
    out["yard_max_17MB_f32"] = ms(lambda: big.max())
    del big
    for name, r, h, dt in (("bert_bf16", 4096, 768, bf16),
                           ("nmt_bf16", 16384, 512, bf16)):
        x, y = (randn(r, h).to(dt) for _ in range(2))
        o = torch.empty_like(x)
        out[f"yard_add_{name}"] = ms(lambda: torch.add(x, y, out=o))
    x32 = torch.as_tensor(rng.standard_normal((4096, 768)),
                          dtype=torch.float32).to(dev)
    o32 = torch.empty_like(x32)
    out["yard_copy_infer_f32"] = ms(lambda: o32.copy_(x32))
    del x, y, o, x32, o32

    # one whole decode step (GPT-2 small widths, 12 layers, f32) at row
    # 1's decode shape: 8 slots at its lengths, pages of 16
    from paddle_tpu_torch.inference import DecoderConfig, TinyDecoderLM
    from paddle_tpu_torch.inference import decode_model as dm

    cfg = DecoderConfig(vocab=50257, d_model=768, n_layers=12, n_heads=12,
                        ffn=3072, max_seq=1024)
    model = TinyDecoderLM(cfg, seed=0, device=dev)
    table = np.zeros((8, 64), np.int32)
    free = list(rng.permutation(np.arange(1, 513)))
    for i, n in enumerate(lens):
        table[i, :-(-n // 16)] = [free.pop() for _ in range(-(-n // 16))]
    pos = np.asarray(lens, np.int32) - 1
    write = np.asarray([table[i, p // 16] * 16 + p % 16
                        for i, p in enumerate(pos)], np.int32)
    shape = (12, 513 * 16, 12, 64)
    kf, vf = torch.randn(shape, device=dev), torch.randn(shape, device=dev)
    step = (model.params, kf, vf,
            torch.as_tensor(rng.integers(1, 50257, 8).astype(np.int32),
                            device=dev),
            torch.as_tensor(pos, device=dev), torch.as_tensor(table,
                                                              device=dev),
            torch.as_tensor(write, device=dev))
    # its device time is the sum of its ~300 ops' times in a profiler
    # window (events around it would also hold the host's launch gaps)
    def decode():
        dm.decode_step(*step, page_size=16, n_heads=12)

    decode()
    torch.cuda.synchronize()
    prof = clock._profile_warm(torch)
    try:
        for _ in range(3):
            decode()
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    out["decode_step_gpt2s_f32_device_busy"] = sum(
        r[0] for r in clock._device_rows(torch, prof)
        if "spin_kernel" not in r[2]) / 3
    del model, kf, vf, step

    # row 4 in f32 at the frozen NMT's decoder shapes (nmt_infer: 8 x 256,
    # 8 heads of 64): the causal self-attention and the key-bias
    # cross-attention
    b, s, nh = 8, 256, 8
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, nh * 64)),
                               dtype=torch.float32).to(dev)
               for _ in range(3))
    src = torch.as_tensor(np.where(np.arange(s)[None, :] < rng.integers(
        s // 2, s + 1, b)[:, None], 0.0, -1e4).reshape(b, 1, 1, s),
        dtype=torch.float32).to(dev)
    out["row4_bsh_fwd_f32_nmt_self_causal"] = ms(
        lambda: fa.flash_attention_bsh_fwd(q, k, v, None, nh, causal=True))
    out["row4_bsh_fwd_f32_nmt_cross_key"] = ms(
        lambda: fa.flash_attention_bsh_fwd(q, k, v, src, nh))
    del q, k, v, src
    out.update(_train_step(torch, dev))
    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "ms": out}


def _train_step(torch, dev) -> dict:
    """A whole BERT-base training step as chip_smoke's bert_train runs it
    (fuse_stack, bf16 AMP, Adam 1e-4, dropout 0.1, 8 x 512, one seed-0
    batch) through the tree's own Executor: the host wall median of 10
    steps after 3 warm ones (the fetch syncs), and the peak device memory
    over them in GB (``bert_train_step_peak_gb``, not a time)."""
    import time

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.fuse_stack = True
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, 8, 512, 76, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            mixed_precision.decorate(fluid.optimizer.AdamOptimizer(1e-4),
                                     use_bf16=True).minimize(loss)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(st, scope=scope)
    feed = {k: torch.as_tensor(v, device=dev) for k, v in
            bert.random_pretrain_batch(cfg, 8, 512, 76, seed=0).items()}

    def step():
        t0 = time.perf_counter()
        exe.run(m, feed=feed, fetch_list=[loss], scope=scope)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = statistics.median(step() for _ in range(10))
    return {"bert_train_step_host_wall": wall,
            "bert_train_step_peak_gb": torch.cuda.max_memory_allocated()
            / 2 ** 30}


EMBED_TABLES = (2, 512, 30522)        # BERT's token-type, position, word
EMBED_IDS = (4096, 32768)             # 8 x 512 and 8 x 4096 tokens


def _embedding_grads(torch, time_cold_ms, flush) -> dict:
    """The gradient of an embedding lookup as the tree's ``take`` gives
    it (``lookup_table_v2``'s read): forward and backward of ``take`` on
    an f32 [rows, 768] table at uniform seed-0 ids, for each of BERT's
    three tables at 8 x 512 and 8 x 4096 tokens; then whether two
    backwards agree to the bit (``*_runs_equal``: 1 or 0, not a time)."""
    from paddle_tpu_torch.ops import manipulation

    out = {}
    for rows in EMBED_TABLES:
        for ids in EMBED_IDS:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            x = torch.randn(rows, 768, device="cuda", generator=gen,
                            requires_grad=True)
            idx = torch.randint(0, rows, (ids,), device="cuda",
                                generator=gen)
            g = torch.randn(ids, 768, device="cuda", generator=gen)

            def grad(x=x, idx=idx, g=g):
                return torch.autograd.grad(manipulation.take(x, idx), x, g)[0]

            name = f"embed_grad_{rows}x{ids}"
            out[f"{name}_runs_equal"] = float(all(
                torch.equal(grad(), grad()) for _ in range(3)))
            out[name] = time_cold_ms(torch, grad, flush, reps=20)["median"]
            del x, idx, g
    return out


def _whole_steps(torch, clock) -> dict:
    """Three of chip_smoke's training paths through the tree's own
    Executor, built by this tree's chip_smoke helpers: bert_train (BERT-
    base, fuse_stack, bf16 AMP, Adam 1e-4, dropout 0.1, 8 x 512),
    bert_long_train (the same at 8 x 4096 under remat_ffn, the rung the
    card chooses) and transformer_train (Transformer-base NMT, 64 x 256
    -> 256).  For each, the host wall median of the timed steps after 2
    warm ones (the numpy fetch syncs) and, over 2 more steps under
    torch.profiler, the wall and the device's busy ms a step (the sum of
    kernel self times)."""
    import dataclasses
    import statistics
    import time

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert, transformer

    def timed(name, main, startup, loss, feed, n):
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = {k: torch.as_tensor(v, device=exe.device)
                for k, v in feed.items()}

        def step():
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            return (time.perf_counter() - t0) * 1e3

        for _ in range(2):
            step()
        wall = statistics.median(step() for _ in range(n))
        prof = clock._step_profile(torch, exe, main, scope, feed, loss, 2,
                                   name)
        del exe, scope
        torch.cuda.empty_cache()
        return {f"{name}_step_host_wall": wall,
                f"{name}_profiled_wall": prof["wall_ms"] / 2,
                f"{name}_device_busy": prof["device_busy_ms"] / 2}

    out = {}
    cfg = bert.BertConfig.base()
    cfg.fuse_stack = True
    main, startup, loss = clock._train_program(cfg, 8, 512, 76, amp=True)
    out.update(timed("bert_train", main, startup, loss,
                     bert.random_pretrain_batch(cfg, 8, 512, 76, seed=0),
                     10))
    cfg = dataclasses.replace(cfg, remat_ffn=True,
                              max_position_embeddings=4096)
    main, startup, loss = clock._train_program(cfg, 8, 4096, 76, amp=True)
    out.update(timed("bert_long_train", main, startup, loss,
                     bert.random_pretrain_batch(cfg, 8, 4096, 76, seed=0),
                     5))
    tcfg = transformer.TransformerConfig.base()
    main, startup, loss = clock._transformer_program(tcfg, 64, 256, 256)
    out.update(timed("transformer_train", main, startup, loss,
                     transformer.random_nmt_batch(tcfg, 64, 256, 256,
                                                  seed=0), 10))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "THIS"))
    ap.add_argument("--measure", metavar="TREE",
                    help="one turn: time TREE's kernels (internal)")
    ap.add_argument("--steps", action="store_true",
                    help="time the embedding gradients and whole "
                         "training steps only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(_measure(args.measure, args.steps)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available() or not args.trees:
        print("chip_kernel_ab: needs a CUDA card and --trees PARENT THIS",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    parent, this = args.trees
    runs = []
    for label, tree in (("parent", parent), ("this", this), ("this", this),
                        ("parent", parent)):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", tree]
                              + (["--steps"] if args.steps else []),
                              capture_output=True,
                              text=True, cwd=tree, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"chip_kernel_ab: the {label} turn failed")
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   label=label)
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    names = dict.fromkeys(n for r in runs for n in r["ms"])
    summary = {}
    for n in names:
        med = {}
        for label in ("parent", "this"):
            got = [r["ms"][n] for r in runs
                   if r["label"] == label and n in r["ms"]]
            med[label] = statistics.median(got) if got else None
        pm, tm = med["parent"], med["this"]
        summary[n] = {"parent_ms": pm, "this_ms": tm, "this_over_parent":
                      tm / pm if pm and tm else None}
    line = {"card": card, "order": [r["label"] for r in runs],
            "summary": summary}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in runs + [line]) + "\n")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
