#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py [--out FILE]

Phases, each printing one JSON line (any failure exits nonzero and
prints no result):

  env          card name and power limit (nvidia-smi), torch/CUDA
               versions; TF32 off for matmuls and cuDNN
  build        nvcc builds every kernel library from ``csrc/`` (one nvcc
               per source, all started together): each library's path
               and its ptxas register/spill lines, the tensor-core
               kernels' and the redesigned SIMT kernels' ptxas lines by
               kernel, and the f32 BSH forward's SASS (cuobjdump): FFMA
               and no tensor-core instruction
  kernels      each kernel against its plain PyTorch version at its main
               path's shapes (paged attention, split across blocks:
               ragged lengths, chunk edges, the table's reach and past it,
               GQA, D 64/128/256, f32 and bf16, against the dense and the
               split plain versions, two calls equal bit for bit, one
               device kernel a call; BSH flash attention, o and
               lse, its backward dq/dk/dv and its dropout, from an explicit
               mask and from the in-kernel Philox, whose drawn bits feed
               the plain version, and whose keep rate is checked; the
               bf16 forward (row 4, the wgmma kernel: key bias, causal,
               rectangular, D 64/128/256) held rounding by rounding: its
               rounded p c / l against the plain version's and its o
               against the plain product of its own p c, its Philox bits
               against the f32 SIMT forward's; the bf16 backward (the
               wgmma kernels) likewise: its rounded p c and ds against
               the plain version's, and its dq, dk, dv against the plain
               products of them; both timed at BERT's shape, with and
               without dropout, at dist_tp's [4, 512, 6 x 64] (checked
               there in f32 and bf16 with Philox dropout) and at the NMT
               decoder's two shapes);
               the f32 forward (the infer path's SIMT kernel) also at
               nmt_infer's two decoder shapes;
               add+LayerNorm, out and stats (the infer and training
               rows, the NMT rows, bf16 H 772, H 2052 and 4096, ragged
               last waves), and its backward dx,
               dscale, dshift, timed at BERT's and the NMT step's rows,
               the backward one launch (a torch.profiler window sees one
               device kernel) and bit-for-bit repeatable; the five
               conv+BN kernels at ResNet-50's
               shapes, f32 and bf16 (row 10 at all four 3 x 3 stage shapes
               and row 11 at five 1 x 1 shapes, each route's launch
               counted, a tile sweep beside each timing (row 11: tile and
               ring depth, and its SIMT kernel on the same inputs), and a
               C = 3 case for the bf16 SIMT route); the BHSD flash
               kernels, rows 6-9, at the NMT's shapes: every bias
               broadcast, dbias, causal at offsets with rows that see no
               key, the lse cotangent, D 64/128/256, dropout from a mask
               and from Philox; every bf16 kernel (row 6, rows 8 and 9
               with a full bias, row 7 with any other, all on the wgmma
               kernels) held rounding by rounding as the BSH backward is,
               the wgmma forward's Philox bits against the f32 SIMT
               forward's; rows 6-9 timed with and without dropout, row 7
               causal too); rows 4 and 5 at BERT s4096's shape (B 8, S
               4096, 12 x 64, bf16, key bias, Philox p 0.1) held rounding
               by rounding against their plain versions at B 1 and timed
               at B 1 and B 8 beside SDPA's forward and backward, and rows
               2 and 3 at its rows (32,768 x 768, bf16, the residual),
               with its time, bound, plain-version
               time and the time of one library call computing the same
               function
  emitters     the emitters repaired against the JAX package (take's
               fill mode in gather and lookup_table_v2, cast's saturation,
               sign, scale, narrow-int sums, the int mean; ROADMAP C1-C5:
               zero divisors of floats, ints and uint8, two bools,
               matmul's alpha in Out's dtype, bool and int8 products) on
               the card against the CPU, bit for bit, ids past the end
               included (NaN rows, no device assert), and the lookup's
               gradient; the eight
               training-breadth update ops, where, the comparisons and
               the elementwise min / max / mod / floordiv, card against
               CPU within 1e-6 of each tensor's largest element; the 83
               core op types of ops/manipulation.py and ops/math_ops.py
               (298 cases over f32 with NaN / inf / -0.0, bf16, int32 and
               bool, with top_k and argsort ties and repeated scatter
               ids), data movement, cumsum and the scatter adds bit for
               bit, the arithmetic within CORE_LIMIT_*; the 33 op types
               of ops/nn_ops.py, reduce_ops.py and creation.py of the
               losses-and-norms slice (72 cases: out-of-range ids, the
               ignored label, a label past the classes, NaN and huge auc
               scores, tied maxima, mean-100 norms) and 6 grad ops
               where JAX's derivative is not torch's, one_hot, shape,
               eye, the fills, range, linspace, accuracy, auc and
               reduce_min / all / any bit for bit, the rest within
               CORE_LIMIT_* and LOSS_OPS_LIMIT_*; FLAGS_conv_dw_im2col's
               conv2d and its grad op in f32 and bf16, adaptive pool2d
               with bins that do not divide (7 -> 3, 5 -> 3)
  text_cnn     hapi's CNNEncoder text classifier (embedding 30,000 x
               128, filters 3 / 4 / 5 x 128, fc 2, Adam 1e-3, f32) at 64
               x 256: 10 steps on the card, 3 from the same scope on the
               CPU, the loss gap within TEXT_CNN_LOSS_LIMIT and TF32 on
               shown to exceed it; the pool_size=2 encoder one step on
               both
  engine       GenerationEngine over TinyDecoderLM at GPT-2-small widths
               (d 768, 12 layers x 12 heads, FFN 3072, vocab 50257, 1024
               positions): 8 requests, one sampled, two sharing a prefix;
               checks every reply and that each decode step launched the
               paged-attention kernel once per layer
  parity       teacher-forced prefill + paged decode steps (through the
               kernel) against the dense full forward, TF32 off, then once
               with TF32 on to show the limit would catch it
  decode_sync  one decode step under torch.profiler: no host sync
               between its 12 paged-attention launches (the wrapper never
               reads lengths), 12 device kernels, the step's device ms
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
  serve        the RPC replica (inference/server.py): BERT-base (f32,
               seed-0 startup) saved by fluid.io.save_inference_model;
               ``python -m paddle_tpu_torch.inference.server --model_dir D``
               as a subprocess answers 8 infer requests of 1-4 x 512,
               health and model_info, then drains and exits 0 on SIGTERM;
               an in-process replica (serve() over load_frozen(D), with a
               GenerationEngine over the GPT-2-small decoder attached) in
               three windows: 32 infer requests (1-4 x 512) from 4 client
               threads alone; the same beside 8 greedy generate requests
               (4 streamed) submitted in order; 8 + 4 under torch.profiler
               (device idle share); every infer reply within 1e-5 of the
               direct predictor on the same rows padded to 8, every
               generation equal token for token to a direct engine run,
               rows 4 / 2 / 1 launched exactly 12 / 25 a batch and 12 a
               decode step, no error or shed reply; client p50/p99, batch
               and request ms, rows a batch, TTFT and decode tokens/s
               through the replica beside the direct runs
  bert_profile torch.profiler over 5 Predictor runs: device busy time by
               kernel and the device's idle share
  bert_train   BERT-base pretraining (MLM + NSP) as the JAX package's bench
               trains it: fuse_stack, Adam 1e-4, bf16 AMP, dropout 0.1,
               8 x 512, 76 masked positions, on one fixed batch: 2 warm
               steps, then 10 timed; every loss finite, the loss falling,
               and every step launching each kernel exactly as often as
               its program needs (flash forward 12, flash backward 24 =
               12 x 2 kernels, all 36 on the wgmma kernels, LN forward and
               backward 26)
  bert_train_profile  torch.profiler over 3 of those steps
  bert_train_parity   the same training program on 2 x 128 with dropout
               0, 3 Adam steps on the card (kernels) against the CPU
               (plain versions) from the same weights: f32 with TF32 off
               (then once on, to show the loss limit catches it), and bf16
               AMP
  resnet_train ResNet-50 training as the JAX package's bench runs it:
               FLAGS_conv_bn_fusion (53 fused_conv_bn ops), Momentum
               0.1/0.9, bf16 AMP, batch 128 at 224 x 224, one fixed seed-0
               batch: 2 warm steps, then 10 timed; every loss finite and
               every step launching the conv+BN kernels exactly as its
               program needs (13 conv_stats and 36 mm_stats, all 49 on
               the wgmma kernel, 49 each of bn_apply, bn_bwd_reduce,
               bn_bwd_dz; 4 reference routes for the stride-2 k x k
               convs)
  resnet_train_profile  torch.profiler over 3 of those steps, rows 10
               and 11 summed by their kernels' names
  resnet_train_parity   ResNet-50 widths at batch 8, 64 x 64, 3 steps of
               Momentum 0.01 on the card (kernels) against the CPU (plain
               versions) from the same weights: the first step's loss,
               gradients and batch statistics held in f32 with TF32 off
               (then once on, to show the limits catch it) and the first
               loss in bf16 AMP; the same without the fusion (the
               library's own card-vs-CPU gap) beside them
  resnet_infer ResNet-50 frozen by freeze_program (all 53 conv+BN pairs
               folded into the conv weights: no conv+BN kernel runs) and
               served by the Predictor, f32, batch 32 at 224 x 224
  resnet_recipe ResNet-50 with the image-classification recipe's head
               (one_hot -> label_smooth 0.1 -> softmax ->
               cross_entropy(soft_label) -> mean; accuracy at k 1 and 5;
               Momentum 0.1 / 0.9 with L2Decay(1e-4), conv+BN fusion,
               bf16 AMP) at 128 x 224 x 224: 2 warm steps, 5 timed, each
               launching rows 10-14 as resnet_train's steps do, its
               fetched accuracies equal to a top-k count (ties to the
               lower index) over its fetched softmax; the same recipe in
               f32 at 8 x 64 x 64, 3 steps card vs CPU from one scope,
               the first loss within RESNET_PARITY_LOSS and TF32 on shown
               to exceed it
  nmt_train    the hapi Transformer NMT (examples/hapi_text_nmt.py's
               network) at Transformer-base widths (6 + 6 layers, d_model
               512, 8 heads, d_inner 2048, vocabulary 30000, dropout 0.1),
               the encoder fed the reference recipe's full [B, 8, S, S]
               self-attention bias: bf16 AMP, Adam 1e-4, 64 x 256 -> 256
               on one seed-0 batch, 2 warm and 10 timed steps; every step
               launching rows 6, 8 and 9 once an encoder layer, the BSH
               kernels for the decoder (12 forward, 24 backward), all on
               their wgmma kernels, and the LN kernels exactly as the
               program needs
  nmt_train_profile  torch.profiler over 3 of those steps
  nmt_train_parity   2 + 2 layers at those widths, 2 x 128, dropout 0, 3
               Adam steps on the card (kernels) against the CPU (plain
               versions): f32 with TF32 off (then on, shown to exceed the
               limits), and bf16 AMP, the losses and each stack op again
               from the card's own inputs
  nmt_infer    the frozen is_test NMT served by the Predictor, f32, 8 x
               256 -> 256, the logits fetched; row 6 once an encoder layer
  mha_key_train hapi MultiHeadAttention (d_model 512, 8 heads) at 64 x
               256 with a [1, 1, 1, S] padding bias, bf16 AMP, Adam, 3
               steps with causal off and 3 on: rows 6 and 7 once a step,
               both on their wgmma kernels
  transformer_train  bench.py's Transformer-base NMT
               (models/transformer.py: 6 + 6 layers, d_model 512, 8
               heads, d_inner 2048, vocabularies of 30000, dropout 0.1,
               label smoothing 0.1), unfused as bench_transformer runs
               it: flash on, Adam 1e-4, bf16 AMP, 64 x 256 -> 256 on one
               seed-0 random_nmt_batch; 2 warm and 10 timed steps (step
               ms, tokens/s, share of 989 TFLOP/s from
               transformer_step_flops), every step launching rows 4 and 5
               18 and 36 times (all on the wgmma kernels) and the LN
               kernels 30 and 30; 3 profiled steps; then 3 steps with
               fuse_stack
  transformer_train_parity  2 + 2 layers at those widths, 2 x 128,
               dropout 0, 3 Adam steps on the card (kernels) against the
               CPU (plain versions) from the same weights: f32 with TF32
               off, the losses and the first step's logits (then TF32 on,
               shown to exceed the limits), and the losses in bf16 AMP
  bert_long_train  BERT-base pretraining at s4096 / b8 as bench.py's
               _run_bert(8, 4096, 76, ...) runs it (fuse_stack, 4096
               positions, Adam 1e-4, bf16 AMP, dropout 0.1):
               Executor.memory_analysis under each rung of bench.py's
               remat ladder (peaks ordered remat_layer < "flash" <
               remat_ffn), the rung bench.py would choose run 2 warm and
               5 timed steps, then 3 under remat_policy="flash" (the
               flash forward once a layer); exact launches a step by
               program and rung; 2 profiled steps of each
  fit_resume   BERT-base pretraining as bert_train trains it (fuse_stack,
               dropout 0.1, Adam 1e-4, bf16 AMP, 8 x 512, 76 masked
               positions), written as a hapi.Model network over
               models/bert.py's builders and driven by Model.fit on 12
               random_pretrain_batch batches (seeds 0-11): two straight
               runs in this process, equal bit for bit (losses,
               parameters, Adam moments, step seed); the checkpoint's
               costs (bytes; sync save ms as snapshot, serialize + sha256,
               write + fsync; verify and restore ms; an async save's stall
               and the steps beside its writer; the embedding gradient's
               scatter, autograd's atomic index_add_ beside the port's
               fixed-order index_sum, at 4096 and 32,768 ids); then a child
               process (``--fit-child``) running the fit with
               checkpoint_dir, checkpoint_freq 4, checkpoint_keep 2, paced
               a step at a time and sent a real SIGTERM after step 6: it
               must exit 75 with a committed checkpoint; a second child
               resumes (resume=True) to step 12 with every step's launches
               of rows 2-5 counted and held to the program's; the trace up
               to the checkpoint's position followed by the resumed trace,
               and the step-12 parameters and moments, must equal the
               straight run's bit for bit, and tools/ckpt_doctor.py must
               report the checkpoint directory clean
  verify       FLAGS_program_verify=1 and FLAGS_op_callstack=1 over
               BERT-base training (fused, AMP), the frozen BERT-base infer
               program, ResNet-50 training after the conv+BN fusion (AMP)
               and the NMT's training (AMP): each built with every pass
               sandwich armed and run once through the executor's
               plan-cache hook, no ERROR finding anywhere; each program's
               op count and the full suite's host ms; then a seeded fault
               (an op reading a var nothing writes) raised as a
               ProgramVerifyError naming this file's line before any op
               runs
  dist_ring    ring attention at sp 4 (B 8, 12 heads of 64, S 2048, 512
               a rank), bf16 and f32, a key bias, causal off and on, on
               four rank processes sharing the card over gloo (NCCL
               refuses two ranks on one device): every rank's o, dq, dk,
               dv and key dbias block against the plain version run here
               over the whole sequence (f32 within 2e-5, dbias 5e-4; bf16
               within 1e-2 of each tensor's scale); rows 6 and 7 launched
               4 times a call by every rank, on the wgmma kernels in
               bf16; each rank's forward + backward ms
  dist_train   bert_train's program (BertConfig.base(), fuse_stack, bf16
               AMP, Adam 1e-4, dropout off) under fleet with mesh_axes
               {"dp": 2, "sp": 2} and sequence_parallel on four ranks
               sharing the card over gloo, global batch 8 x 512 (4 x 256
               a rank): 3 steps against the same program and weights in
               this process without a mesh (within 2e-2), the same at 2
               layers in f32 (within 1e-4), the four ranks' losses and
               state bit for bit, every step's launches exact (rows 6
               and 7 24 a rank, 12 layers x 2 ring steps, on wgmma; rows
               2 and 3 26); the time, bytes and host-staging time in
               collectives a step, each rank's step wall, the card's
               idle share (nvidia-smi utilization over 2 more steps);
               then 2 steps with dropout 0.1, finite and equal on every
               rank
  dist_nccl    one rank: init_parallel_env() picks NCCL on the card; a
               dp 1 mesh trains the 2-layer f32 program 2 steps equal bit
               for bit to the run without a mesh; every c_* emitter once
  dist_tp      BERT-base unfused (the fused attention op on the flash
               kernels, 6 of the 12 heads a rank) with
               tensor_parallel_rules() (Megatron column/row regions, the
               vocabulary-parallel embedding and tied head) under fleet
               at {"dp": 2, "tp": 2}, bf16 AMP, Adam, global batch 8 x
               512, four ranks sharing the card over gloo: 3 steps
               against the same program and weights in one process
               (within 2e-2), 2 layers in f32 (losses within 1e-4, every
               parameter gathered over tp within 2e-5), the ranks'
               gathered state bit for bit and the dp pair's blocks too,
               every step's launches exact (rows 4 and 5 once and twice
               a layer at [4, 512, 6 x 64], rows 2 and 3 26), the
               collectives, step wall and idle share; then dropout 0.1:
               finite, the replicated state equal on the tp pair, whose
               head-shard dropout seeds differ
  dist_pp      bert_train's program (fuse_stack) under fleet with
               pipeline at {"dp": 2, "pp": 2}, accumulate_steps 2 (6 of
               the 12 layers a stage, 2 microbatches of 2 x 512), then at
               {"pp": 2, "sp": 2} with sequence_parallel (the ring inside
               each stage) on the same four ranks: the holds of dist_tp
               (2 layers in f32: one a stage), the GPipe launches exact
               (rows 4 / 5 or, under pp x sp, 6 / 7 per stage layer and
               microbatch)

  bert_lamb_recompute
               BERT-base pretraining (unfused, dropout 0.1, 8 x 512, 76
               masked) through fleet at world size 1 as a large-batch
               recipe trains it: Adam swapped for LAMB (strategy.lamb,
               weight decay 0.01), bf16 AMP, linear_lr_warmup(
               polynomial_decay(1e-4, 8, 0), 3, 0, 1e-4) in the program,
               and strategy.recompute with a checkpoint at every encoder
               layer's output; 8 steps with recompute and 8 without from
               the same weights and seed: every step's launches exact
               (rows 4 / 5 / 2 / 3 24 / 24 / 52 / 26 a step with
               recompute, 12 / 24 / 26 / 26 without, all flash ones on
               wgmma), the fetched learning rates within 1e-9 of the
               closed form, step 1's loss identical and every loss within
               one bf16 ulp of the run without recompute, the last step's
               peak memory above the state lower with recompute; step
               medians after 2 warm steps and 2 profiled steps each
               (device busy, idle share); then strategy.gradient_merge
               at k_steps 2 for 4 steps (the parameters bit for bit
               unchanged after steps 1 and 3, all changed after 2 and 4),
               and ExponentialMovingAverage / ModelAverage apply() and
               restore() on a CUDA scope (the values stay CUDA tensors and
               come back as the very tensors); ``emitters`` holds the
               slice's update ops, where and comparisons on the card
               against the CPU

  dist_ep, dist_zero, dist_dcn
               BERT-base with a moe_ffn of 8 experts at dp 2 x ep 2 and
               dp 1 x ep 4, ZeRO-2 at dp 4 against unsharded dp, and the
               dense, DGC and LocalSGD multi-slice modes at dcn 2 x dp 2,
               on one set of four ranks, at 4 of BERT-base's layers
  dist_elastic BERT-base (4 of its 12 layers, the fused stack, bf16 AMP, Adam,
               dropout 0.1, ZeRO-2) started at dp 4 by ``python -m
               paddle_tpu_torch.distributed.launch`` with the lease plane
               armed and sharded checkpoints every 2 steps (global batch
               12 x 512): a clean run of 4 steps; (a) trainer1 killed
               between its shard commit and the global commit of step 4,
               relaunched from step 2, steps 3-4 and the step-4
               checkpoint bit for bit the clean run's; (b) trainer3 lost
               for good at step 5, evicted, the job resumed at dp 3
               from the clean step-4 checkpoint, steps 5-6 and the
               step-6 checkpoint bit for bit a clean dp-3 launch's; the
               launchers' exit codes and restarts held; each attempt's
               start-up by stage, step ms a rank, save ms and bytes a
               shard, detect-to-relaunch seconds, each rank's largest
               gap between answered lease renewals, rows 2-5 a step a
               rank, and beside each attempt the jobs that ran with it

  ps_train     the parameter server, no kernel on its path (rows 1-14:
               0 launches): (a) examples/ps_embedding_training.py's
               model (a 1,000,000 x 64 f32 table in host memory through
               DistributeTranspiler, a 20-way fc, Adam 1e-3, batch 64),
               30 steps on the card and on the CPU from the same weights,
               TF32 off: losses and touched rows within 1e-5; a step's
               split (the ids' and the gradient's device-to-host copies,
               the gather, the rows' host-to-device copy, the push, each
               timed alone) and the idle share of a profiled window; (b)
               ps_ref: ``python -m paddle_tpu_torch.distributed.launch
               --nproc_per_node 2 --server_num 2 --ps_replication 2``,
               two trainers on the card (tests/dist_ps_worker.py's
               contract at the example's widths: global batch 128, 12
               sync steps, server SGD 0.5, a frozen projection) against
               one process with an in-process table: mean loss within
               1e-5, table sums within 1e-5, both ranks' tables equal;
               (c) ps_kill: the same with pserver ps0 killed at its 30th
               RPC, bit for bit (b), a failover, and the ms from the
               kill to the promoted backup's first answer; no pserver
               sees the card (CUDA_VISIBLE_DEVICES empty, none among
               ``nvidia-smi --query-compute-apps``).  (b), (c) and the
               one process start before the gloo spawn and are joined
               after it; each job's and each gloo line's
               ``concurrent_with`` name what ran beside it
  serve_launch a serving fleet under the port's launcher, beside the gloo
               spawn: ``python -m paddle_tpu_torch.distributed.launch
               --serve --nproc_per_node 2 --elastic_retries 2 --lease_secs
               5 --heartbeat_timeout 10 --serve_kv_cache 1
               --serve_kv_pages 64 --servers (two loopback ports)
               --ps_replication 2`` over the serve phase's BERT-base f32
               export (--max_batch 8), each replica with a 2-layer decoder
               of head_dim 64 (row 1); two BERT-base parameter sets (v1, v2: the export's
               program at seeds 1 and 2, 418 MB of f32 rows) published
               into the job's replicated weight table: both replicas adopt
               v1 bit for bit an in-process oracle's replies (else within
               BERT_PARITY_LIMIT, and the line says which held); four
               client threads stream the serve phase's requests, replica
               0 is SIGKILLed mid-stream: no request error, the
               survivor's uptime spans the kill, the respawn re-adopts v1
               and answers bit for bit like the survivor; v2 published
               mid-stream moves each replica's fence once; generate
               against the in-process engine, the pools' pages, the
               coordinator's members, fresh heartbeat stamps; SIGTERM
               drains the job to exit 0.  Numbers: launch and publish
               seconds, publish to each replica's first reply at v2, the
               wire bytes of a full fetch and of a steady poll, kill to
               detected / respawned / listening / re-adopted, client p50
               / p99, the replies at the export's weights before the
               respawn's first adoption, the wall time

A dist phase's ranks are ``python3 chip_smoke.py --dist-child ...``
processes (dist_elastic's, ``--elastic-child`` processes under the
port's launcher; ps_train's, ``--ps-child``; serve_launch's child,
``--serve-launch-child``); one that fails or outlives its deadline fails the
phase, the others killed first.  The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; without one it
exits 2.  Weights and inputs are random from fixed seeds.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# this process's start on the host clock: an elastic child's start-up
# seconds are counted from here
_T_PROC0 = time.time()

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
ATOL_F32 = 2e-5             # f32 kernel vs plain: sums in another order
ATOL_BF16 = 1e-2            # bf16 output rounding (8-bit mantissa)
# bf16 outputs of the flash and LN kernels: both versions compute in f32
# and round once, so they may differ by one bf16 ulp (2**-7 relative)
RTOL_BF16 = 2.0 ** -7
# f32 log-sum-exp over up to 4096 keys: l sums terms in (0, 1] whose
# largest is 1, in another order in each version, and the rounding errors
# add like a random walk, ~sqrt(4096) * 2^-24 = 4e-6 of l (1e-6 read at
# 512 keys), so lse agrees to ~1e-5; one key tile dropped or doubled moves
# it by ~log(1 + 64/4096) = 1.6e-2 at the widest, and 1e-4 tells them apart
ATOL_LSE = 1e-4
PARITY_LIMIT = 5e-4         # paged decode vs dense forward, f32, TF32 off
BERT_PARITY_LIMIT = 5e-4    # BERT-base card vs CPU, f32, TF32 off
# BERT-base training, 3 Adam steps on 2 x 128, card vs CPU, f32 with TF32
# off: the loss and the parameters after the steps agree within 1e-6
# (the same math in another summation order), and TF32 on moves both by
# about 1e-4, so limits of 2e-5 hold the card to f32 and catch TF32.
# Under bf16 AMP both sides run bf16 matmuls, rounded at other places.
TRAIN_PARITY_LOSS = 2e-5
TRAIN_PARITY_PARAM = 2e-5
TRAIN_PARITY_LOSS_BF16 = 2e-2
# LN backward's dscale/dshift: f32 sums over 4096 rows of terms near 1,
# taken in another order (the kernel's per-warp partials, torch's tree):
# errors grow like sqrt(4096) ulps of partial sums up to ~200, whatever
# the (possibly cancelled) result's size.  They grow like sqrt(rows): read
# 6.1e-5 at 4096 rows and 1.2e-4 at 16,384, so ~1.8e-4 expected at
# BERT s4096's 32,768
ATOL_SUM = 5e-4
RTOL_SUM = 2e-6
# Philox keep rate over B*nh*S*S draws: within 6 standard deviations of
# the quantized keep probability thresh/256, itself within 1/512 of 1 - p
KEEP_SIGMAS = 6.0

_lines = []


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:   # where the time goes
        obj = dict(obj, elapsed_s=time.time() - _T_PROC0)
    line = json.dumps(obj) if not isinstance(obj, str) else obj
    _lines.append(line)
    print(line, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


# L2-flushed calls a kernel timing takes its median over (40 through
# PR 19's script; 20 leave the script room for the parameter-server jobs)
KERNEL_REPS = 20
# and a plain version's, after one warm call: its time is no yardstick,
# and the script's time is nearly spent (every hold of a kernel against
# its plain version is kept)
PLAIN_REPS = 3


def time_cold_ms(torch, fn, flush, reps: int = KERNEL_REPS,
                 warm: int = 3) -> dict:
    """Device time of ``fn`` with the 50 MB L2 flushed before each call
    (the decode step finds the pool cold: eleven other layers and their
    weights pass through the cache between two calls).

    A spin kernel (``torch.cuda._sleep``) holds the stream before each
    call, so the host queues both events and every op of ``fn`` before
    the device reaches them: the event window holds device work only,
    not the host's launch gaps.  The hold doubles until the host's
    slowest enqueue fits inside it.  A ``fn`` that synchronises inside
    (its enqueue waits out any hold) is timed without the hold, and says
    so (``held`` false): its window then includes the host's gaps after
    the sync.  Returns the median, min and max over ``reps`` calls, the
    hold and the slowest enqueue."""

    def run(cycles):
        pairs, enqueue_ms = [], 0.0
        for _ in range(warm + reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()   # the hold starts after this
            if cycles:
                torch.cuda._sleep(cycles)
            s.record()
            fn()
            e.record()
            enqueue_ms = max(enqueue_ms, (time.perf_counter() - t0) * 1e3)
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in pairs[warm:]]
        return {"median": statistics.median(times), "min": min(times),
                "max": max(times), "enqueue_ms_max": enqueue_ms}

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
        out = run(cycles)
        if out["enqueue_ms_max"] < hold_ms:
            return dict(out, hold_ms=hold_ms, held=True)
        if hold_ms > 5.0 and out["enqueue_ms_max"] > 0.9 * hold_ms:
            break  # the enqueue waited out the hold: fn synchronises
        cycles *= 2
    return dict(run(0), hold_ms=None, held=False)


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


def _ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's register, spill and shared-memory lines, by kernel (the
    mangled name of each entry function, its template arguments in it)."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if "'" in ln else ln.strip()
        elif cur and ("registers" in ln or "spill" in ln or "smem" in ln):
            out.setdefault(cur, []).append(ln.split("info    :")[-1].strip())
    return out


# the SIMT kernels redesigned for register tiles: their ptxas lines by
# kernel, and (the f32 forward) their SASS, which must hold no
# tensor-core instruction
SIMT_KERNELS = ("flash_fwd_bsh_kernel", "add_ln_bwd_kernel")


def _sass_ops(nvcc: str, path: str, needle: str) -> dict:
    """Opcode counts of each function of the library at ``path`` whose
    mangled name holds ``needle`` (``cuobjdump -sass``, beside nvcc)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass {path}: {proc.stderr.strip()[-2000:]}")
    out, cur = {}, None
    for ln in proc.stdout.splitlines():
        s = ln.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            cur = out.setdefault(name, {}) if needle in name else None
        elif cur is not None and s.startswith("/*") and "*/" in s:
            words = s.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and not words[0].startswith("/*"):
                op = words[0].split(".")[0]
                cur[op] = cur.get(op, 0) + 1
    return out


def phase_build() -> dict:
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    libs, tc, simt = {}, {}, {}
    for name, (path, log) in built.items():
        libs[name] = {
            "library": os.path.basename(path), "cached": log is None,
            "ptxas": [ln.strip() for ln in (log or "").splitlines()
                      if "registers" in ln or "spill" in ln]}
        by_kernel = _ptxas_by_kernel(log or "")
        tc.update({k: v for k, v in by_kernel.items() if "_tc_kernel" in k})
        simt.update({k: v for k, v in by_kernel.items()
                     if any(n in k for n in SIMT_KERNELS)})
    # row 4's f32 forward runs full-f32 FFMA: no HMMA/HGMMA (TF32) in it
    sass = _sass_ops(_build.nvcc_path(), built["flash_attention_bsh"][0],
                     SIMT_KERNELS[0])
    mma = {f: {op: n for op, n in ops.items() if "MMA" in op}
           for f, ops in sass.items()}
    if not sass or any(mma.values()) or not all(
            ops.get("FFMA", 0) for ops in sass.values()):
        fail(f"the f32 BSH forward's SASS: tensor-core instructions "
             f"{mma}, functions {sorted(sass)}")
    emit({"phase": "build", "seconds": secs, "libraries": libs,
          "tensor_core_kernels_ptxas": tc, "simt_kernels_ptxas": simt,
          "f32_forward_sass": {f: {"FFMA": ops.get("FFMA", 0),
                                   "instructions": sum(ops.values()),
                                   "tensor_core": mma[f]}
                               for f, ops in sass.items()}})
    return {"log": {name: log for name, (_, log) in built.items()}}


def _paged_case(torch, rng, *, b, h, kh, d, page, maxp, n_pages, lengths,
                dtype):
    """Pool pages, a page table whose live entries are distinct pages
    and whose trailing dead entries point at trash page 0, and q.  A
    length past the table's reach fills the whole row."""
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
        live = min(-(-n // page), maxp)
        table[i, :live] = [free.pop() for _ in range(live)]
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def _timed(torch, flush, kernel_fn, plain_fn, library_fn, *, nbytes,
           flops, peak_flops) -> dict:
    """Device times (time_cold_ms) of the kernel, its plain version and
    the library call, and the bound: the larger of bytes / HBM rate and
    flops / the dtype's peak.  ``plain_fn`` None: the plain version is
    not timed here (its inputs would not fit), and its entries are
    None."""
    none = {"median": None, "min": None, "max": None, "hold_ms": None,
            "enqueue_ms_max": None, "held": None}
    ker_t = time_cold_ms(torch, kernel_fn, flush)
    plain_t = none if plain_fn is None else time_cold_ms(
        torch, plain_fn, flush, reps=PLAIN_REPS, warm=1)
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
            "held": {"kernel": ker_t["held"], "plain": plain_t["held"],
                     "library": lib_t["held"]},
            "timing": f"CUDA events, median of {KERNEL_REPS} calls "
                      f"({PLAIN_REPS} for the plain version), L2 flushed "
                      "and the stream held by a spin kernel before each, "
                      "so the window is device time"}


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
        # the split's edges at the decode shape (chunks of 4 pages = 64
        # positions): lengths on a chunk boundary, one past and one short
        # of it, the table's whole reach and past it
        ("chunk_edges_f32", dict(b=8, h=12, kh=12, d=64, page=16, maxp=64,
                                 n_pages=513,
                                 lengths=[64, 65, 63, 128, 129, 1024, 2000,
                                          960],
                                 dtype=torch.float32), ATOL_F32),
        ("chunk_edges_gqa_bf16", dict(b=4, h=12, kh=4, d=128, page=16,
                                      maxp=32, n_pages=140,
                                      lengths=[64, 65, 512, 5000],
                                      dtype=torch.bfloat16), ATOL_BF16),
        ("length_1_everywhere_f32", dict(b=8, h=12, kh=12, d=64, page=16,
                                         maxp=64, n_pages=513,
                                         lengths=[1] * 8,
                                         dtype=torch.float32), ATOL_F32),
        ("d256_gqa_long_f32", dict(b=2, h=8, kh=2, d=256, page=8, maxp=100,
                                   n_pages=210, lengths=[800, 9],
                                   dtype=torch.float32), ATOL_F32),
    ]
    results = {}
    main = None
    for name, kw, atol in cases:
        args = _paged_case(torch, rng, **kw)
        ker = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        ref = pa.paged_attention(*args, impl="torch")
        split = pa.paged_attention_split_reference(*args)
        torch.cuda.synchronize()
        results[name] = _check(f"paged_attention {name}", ker, ref, atol)
        results[name]["split_reference_err"] = _check(
            f"paged_attention {name} vs the split plain version", ker,
            split, atol)["max_abs_err"]
        if not torch.equal(ker, again):
            fail(f"paged_attention {name}: two calls on the same inputs "
                 f"gave different outputs ({int((ker != again).sum())} "
                 f"elements)")
        results[name]["bitwise_repeatable"] = True
        if name == "f32":
            main = args
    # one launch: the merge runs inside the kernel, and no copy of lengths
    # to the host
    results["one_launch"] = _one_device_kernel(
        torch, lambda: pa.paged_attention(*main), "paged_attention_kernel",
        "paged_attention")

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
    chunk_pages, nchunks, hpb, hgroups = pa.split_geometry(
        h, kp.shape[2], maxp, page)
    out["split"] = {"chunk_pages": chunk_pages, "chunks": nchunks,
                    "heads_per_block": hpb, "head_groups": hgroups,
                    "blocks": nchunks * kp.shape[2] * hgroups * b,
                    "live_blocks": sum(max(1, -(-min(int(n), reach)
                                                // (chunk_pages * page)))
                                       for n in lengths.tolist())
                    * kp.shape[2] * hgroups}
    return results, out


def _key_bias(torch, rng, b, s):
    """BERT's additive padding mask as a per-key bias [B, 1, 1, S]: 0 on
    the first len_b keys, -1e4 on the padding; lengths 128..S."""
    lens = rng.integers(128, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return torch.as_tensor(1e4 * (mask - 1.0))[:, None, None, :].to("cuda")


def _flash_inputs(torch, rng, b, s, nh, d, dtype, bias, causal=False):
    h = nh * d
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, h)),
                               dtype=torch.float32).to("cuda", dtype)
               for _ in range(3))
    kb = _key_bias(torch, rng, b, s) if bias else None
    return dict(q=q, k=k, v=v, bias=kb, num_heads=nh, causal=causal)


def _bsh_fwd_rounding(torch, fa, name, kw, o, lse, checks, mask, keep_div,
                      o_ref) -> dict:
    """Row 4 in bf16 held rounding by rounding (``_fwd_rounding``)."""
    q, nh = kw["q"], kw["num_heads"]
    probs = fa.bsh_fwd_probs_reference(
        q, kw["k"], kw["bias"], nh, 1.0 / math.sqrt(q.shape[-1] // nh),
        kw.get("causal", False), mask, keep_div)
    return _fwd_rounding(
        torch, f"flash_attention_bsh {name}", o, lse, checks, probs,
        lambda p_k, m_k, tile: fa.bsh_fwd_products_reference(
            kw["v"], p_k, m_k, lse, nh, tile), o_ref)


def _bsh_fwd_check(torch, fa, name, kw, is_bf16) -> tuple:
    """Row 4 against its plain version (fed the Philox bits it drew):
    f32 (the SIMT kernel) elementwise at ATOL_F32; bf16 (the wgmma
    kernel, which must have run: ``launches_tc``) rounding by rounding
    (``_bsh_fwd_rounding``), and its Philox bits equal to the f32 SIMT
    forward's for the same seed and offset.  Returns (result, o, lse,
    bits, keep mask, keep_div)."""
    p = kw.get("dropout_prob", 0.0)
    n0 = (fa.flash_attention_bsh.launches, fa.flash_attention_bsh.launches_tc)
    o, lse, bits, checks = fa.flash_attention_bsh_fwd(
        **kw, return_bits=True, return_probs=True)
    ran = (fa.flash_attention_bsh.launches - n0[0],
           fa.flash_attention_bsh.launches_tc - n0[1])
    if ran != (1, int(is_bf16)) or (checks is None) == is_bf16:
        fail(f"flash_attention_bsh {name}: the forward launched {ran} (all, "
             f"on the tensor cores)")
    mask, keep_div = kw.get("mask"), 1.0 - p
    if "dropout_seed" in kw:
        mask = bits
        keep_div = fa.dropout_quantized_thresh(1.0 - p) / 256.0
    plain_kw = {k: kw[k] for k in ("q", "k", "v", "bias", "num_heads")}
    o_ref, lse_ref = fa.flash_attention_bsh_reference(
        **plain_kw, causal=kw.get("causal", False), dropout_prob=p,
        mask=mask, keep_div=keep_div if p else None)
    torch.cuda.synchronize()
    if is_bf16:
        r = _bsh_fwd_rounding(torch, fa, name, kw, o, lse, checks,
                              mask if p else None, keep_div, o_ref)
        r["max_abs_err"] = r["o_vs_products"]
        r["forward_kernel"] = "row 4 (wgmma)"
    else:
        r = _check(f"flash_attention_bsh {name} o", o, o_ref, ATOL_F32)
    del checks, o_ref
    r["lse"] = _check(f"flash_attention_bsh {name} lse", lse, lse_ref,
                      ATOL_LSE)["max_abs_err"]
    if "dropout_seed" in kw and is_bf16:
        kw32 = dict(kw, **{n: kw[n].float() for n in ("q", "k", "v")})
        bits32 = fa.flash_attention_bsh_fwd(**kw32, return_bits=True)[2]
        if not torch.equal(bits, bits32):
            fail(f"flash_attention_bsh {name}: the wgmma forward's Philox "
                 f"bits differ from the SIMT forward's in "
                 f"{int((bits != bits32).sum())} places")
        r["philox_bits_equal_simt_f32"] = True
        del kw32, bits32
    return r, o, lse, bits, mask, keep_div


def _time_fwd_nmt_infer(torch, F, flush, fa, rng) -> dict:
    """Row 4 in f32 at the frozen NMT's two decoder shapes (``nmt_infer``:
    8 x 256, 8 heads of 64): the causal self-attention and the
    cross-attention with its per-key source bias, each against its plain
    version and timed beside SDPA on the same inputs and the bound."""
    out = {}
    b, s, nh = 8, NMT["trg_len"], NMT["heads"]
    d = NMT["d_model"] // nh
    for name, causal in (("self_causal", True), ("cross_key_bias", False)):
        kw = _flash_inputs(torch, rng, b, s, nh, d, torch.float32,
                           not causal, causal)
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
        res = _bsh_fwd_check(torch, fa, f"nmt_infer {name}", kw, False)[0]
        qh, kh, vh = (t.reshape(b, s, nh, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        row = {"shape": {"B": b, "S": s, "H": nh * d, "nh": nh, "D": d,
                         "causal": causal,
                         "bias": None if causal else "per key",
                         "dtype": "float32"},
               "library": "F.scaled_dot_product_attention (is_causal or "
                          "the additive key mask)",
               "max_abs_err": res["max_abs_err"],
               "grid": fa.simt_fwd_grid(b, s, nh, d)}
        row.update(_timed(
            torch, flush, lambda: fa.flash_attention_bsh_fwd(**kw),
            lambda: fa.flash_attention_bsh_reference(**kw),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias, is_causal=causal),
            nbytes=fa.bound_bytes(q, k, v, bias, nh),
            flops=fa.bound_flops(q, k, nh, causal), peak_flops=F32_FLOPS))
        out[name] = row
        del kw, q, k, v, bias, qh, kh, vh
    return out


def _kernels_flash(torch, F, flush) -> tuple:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(3)

    def case(b, s, nh, d, dtype, bias, causal=False):
        return _flash_inputs(torch, rng, b, s, nh, d, dtype, bias, causal)

    def rect(b, sq, skv, nh, d, dtype):
        kw = case(b, max(sq, skv), nh, d, dtype, True)
        kw["q"] = kw["q"][:, :sq].contiguous()
        kw["k"], kw["v"] = (kw[n][:, :skv].contiguous() for n in "kv")
        kw["bias"] = kw["bias"][..., :skv].contiguous()
        return kw

    # the BERT-base attention of the infer path (B=8, S=512, 12 x 64),
    # padded, in f32 (the main path) and bf16 (row 4 on the wgmma
    # kernel: the key bias, causal, rectangular, D 64/128/256); dropout
    # in _kernels_flash_train
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("f32", case(8, 512, 12, 64, f32, True), False),
        ("bf16", case(8, 512, 12, 64, bf16, True), True),
        ("causal_f32", case(8, 512, 12, 64, f32, False, True), False),
        ("causal_bf16", case(8, 512, 12, 64, bf16, False, True), True),
        ("d128_f32", case(8, 512, 12, 128, f32, True), False),
        ("d128_bf16_causal", case(4, 512, 8, 128, bf16, True, True), True),
        ("d256_bf16", case(2, 512, 12, 256, bf16, True), True),
        ("rect_bf16_256_from_512", rect(8, 256, 512, 12, 64, bf16), True),
        ("rect_bf16_512_from_256_d256", rect(2, 512, 256, 4, 256, bf16),
         True),
        # the f32 kernel's ragged last tiles (128 x 128 at D 64, 64 x 128
        # at D 128): query rows and keys past a tile's end
        ("rect_f32_192_from_320", rect(2, 192, 320, 4, 64, f32), False),
        ("causal_f32_192", case(2, 192, 4, 64, f32, False, True), False),
        ("rect_f32_192_from_192_d128", rect(2, 192, 192, 4, 128, f32),
         False),
    ]
    results = {}
    for name, kw, is_bf16 in cases:
        results[name] = _bsh_fwd_check(torch, fa, name, kw, is_bf16)[0]

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
    grid = fa.simt_fwd_grid(b, s, nh, h // nh)
    out["grid"] = grid
    out["waves"] = (math.prod(grid) / torch.cuda.get_device_properties(
        0).multi_processor_count)  # one block an SM
    out["nmt_infer"] = _time_fwd_nmt_infer(torch, F, flush, fa, rng)
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

    # the forward's other routes and geometries: the NMT step's rows, bf16
    # with H % 8 != 0 (8-byte chunks), the widest rows (not pipelined,
    # four warps a block), and row counts that leave the last wave ragged
    for name, r_, h_, dtype, with_y in (
            ("nmt_bf16_y", 16384, 512, torch.bfloat16, True),
            ("bf16_y_h772", 512, 772, torch.bfloat16, True),
            ("bf16_h2052", 64, 2052, torch.bfloat16, False),
            ("bf16_y_h4096", 128, 4096, torch.bfloat16, True),
            ("f32_h4096", 64, 4096, torch.float32, False),
            ("f32_y_1000_rows", 1000, 768, torch.float32, True),
            ("bf16_1000_rows_h1024", 1000, 1024, torch.bfloat16, False),
            ("f32_y_h128", 4099, 128, torch.float32, True)):
        kw_, _ = _ln_case(torch, rng, r_, h_, dtype, with_y)
        is_bf16 = dtype == torch.bfloat16
        out, mean, rstd = add_ln.fused_add_ln_fwd(**kw_)
        out_r, mean_r, rstd_r = add_ln.fused_add_ln_reference(**kw_)
        torch.cuda.synchronize()
        res = _check(f"add_ln {name} out", out, out_r,
                     1e-5 if is_bf16 else ATOL_F32,
                     RTOL_BF16 if is_bf16 else 0.0)
        res["mean"] = _check(f"add_ln {name} mean", mean, mean_r, ATOL_F32)
        res["rstd"] = _check(f"add_ln {name} rstd", rstd, rstd_r, ATOL_F32)
        results[name] = res
        del kw_, out, out_r

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


def _check_grads(name, got, want, is_bf16) -> dict:
    return {g: _check(f"{name} {g}", a, b, 1e-5 if is_bf16 else ATOL_F32,
                      RTOL_BF16 if is_bf16 else 0.0)["max_abs_err"]
            for g, a, b in zip(("dq", "dk", "dv"), got, want)}


def _flash_train_case(torch, rng, b, s, nh, d, dtype, causal=False, p=0.0,
                      mode=None):
    """One attention case of the training path: q, k, v, dO, the padding
    bias, and the dropout as the forward takes it (an explicit keep mask,
    or Philox from a seed)."""
    kw = {**_flash_inputs(torch, rng, b, s, nh, d, dtype, True, causal),
          "dropout_prob": p}
    if mode == "mask":
        kw["mask"] = torch.as_tensor(
            rng.random((b, nh, s, s)) > p).to("cuda", torch.uint8)
    elif mode == "philox":
        kw["dropout_seed"] = int(rng.integers(1, 2 ** 62))
    do = torch.as_tensor(rng.standard_normal((b, s, nh * d)),
                         dtype=torch.float32).to("cuda", dtype)
    return kw, do


def _bwd_f64(torch, q, k, v, bias, o, lse, do, nh, causal):
    """(dq, dk, dv) in float64 under the TPU kernel's rounding rule: s,
    dp and delta in float64, p and ds rounded to bf16 from them, the
    products in float64."""
    b, s, hd = q.shape
    d = hd // nh

    def heads(t):
        return t.double().reshape(b, s, nh, d).transpose(1, 2)

    sc = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(d)
    if bias is not None:
        sc = sc + bias.reshape(b, 1, 1, s).double()
    if causal:
        sc = torch.where(torch.ones(s, s, dtype=torch.bool,
                                    device=q.device).tril(), sc, -1e30)
    p = torch.exp(sc - lse[..., None].double())
    dof = heads(do)
    dp = dof @ heads(v).transpose(-1, -2)
    delta = (dof * heads(o)).sum(-1, keepdim=True)
    ds = (p * (dp - delta) / math.sqrt(d)).to(torch.bfloat16).double()
    p = p.to(torch.bfloat16).double()
    out = (ds @ heads(k), ds.transpose(-1, -2) @ heads(q),
           p.transpose(-1, -2) @ dof)
    return tuple(t.transpose(1, 2).reshape(b, s, hd) for t in out)


def _end_to_end(grads, ref) -> dict:
    """Each bf16 gradient of a tensor-core backward against the plain
    backward end to end (both rounding p c and ds, each its own f32 S and
    dP): the largest difference and the elements past 1e-5 + 2^-7
    |plain|, where one term rounded to the neighbouring bf16 value moves
    an output that cancels to near zero."""
    out = {}
    for g, a, b in zip(("dq", "dk", "dv"), grads, ref):
        diff = (a.float() - b.float()).abs()
        out[g] = {"max_abs_err": diff.max().item(),
                  "beyond_limit": int((diff > 1e-5 + RTOL_BF16
                                       * b.float().abs()).sum()),
                  "elements": diff.numel()}
    return out


def _flash_bwd_check(torch, fa, name, kw, do) -> dict:
    """Forward (drawing its Philox bits; ``_bsh_fwd_check``) and backward
    kernels against the plain versions fed the same keep bits; returns
    the errors and, for Philox, the keep rate.

    bf16 (the wgmma kernels): both versions round p c and ds to bf16
    before the dv, dk and dq products, as the TPU kernel does.  Where an
    f32 p or ds sits within the two versions' f32 difference (their
    scores and dP summed in other orders) of a bf16 rounding boundary,
    the two round it to neighbouring values: one bf16 ulp of that term,
    which moves an output that cancels to near zero by more than
    1e-5 + 2^-7 |out| (on BERT-base's shape ~100 of 3.1M elements a
    gradient, each version as far from a float64 evaluation as the
    other).  So each rounding is held on its own at the same limits: the
    kernels' rounded intermediates (their check outputs) against the
    plain version's, and the kernels' dq, dk, dv against the plain
    products of those intermediates.  The end-to-end difference is
    reported beside them."""
    is_bf16 = kw["q"].dtype == torch.bfloat16
    p = kw["dropout_prob"]
    r, o, lse, bits, mask, keep_div = _bsh_fwd_check(torch, fa, name, kw,
                                                     is_bf16)
    # the backward's inputs are the kernel forward's o and lse on both
    # sides: a bf16 o one ulp off would move delta, not the backward
    q, k, v, nh = kw["q"], kw["k"], kw["v"], kw["num_heads"]
    out = fa.flash_attention_bsh_bwd(
        q, k, v, kw["bias"], o, lse, do, nh, causal=kw["causal"],
        dropout_prob=p, mask=kw.get("mask"),
        dropout_seed=kw.get("dropout_seed"), return_probs=is_bf16)
    grads = out[:3]
    p_ref, ds_ref = fa.bwd_probs_reference(
        q, k, v, kw["bias"], o, lse, do, nh, causal=kw["causal"],
        mask=mask if p else None, keep_div=keep_div)
    ref = fa.bwd_products_reference(q, k, v, do, p_ref, ds_ref, nh)
    torch.cuda.synchronize()
    if not is_bf16:
        r["grads"] = _check_grads(f"flash backward {name}", grads, ref,
                                  False)
    else:
        p_k, ds_k, dsq_k = out[3]
        r["intermediates"] = {
            t: _check(f"flash backward {name} {t}", a, p_ref if t == "p"
                      else ds_ref, 1e-5, RTOL_BF16)["max_abs_err"]
            for t, a in (("p", p_k), ("ds", ds_k), ("ds_dq", dsq_k))}
        fed = fa.bwd_products_reference(q, k, v, do, p_k, ds_k, nh,
                                        ds_q=dsq_k)
        r["grads"] = _check_grads(f"flash backward {name}", grads, fed,
                                  True)
        r["grads_end_to_end"] = _end_to_end(grads, ref)
        exact = (_bwd_f64(torch, q, k, v, kw["bias"], o, lse, do, nh,
                          kw["causal"]) if p == 0.0 else (None,) * 3)
        for g, a, b, e in zip(("dq", "dk", "dv"), grads, ref, exact):
            if e is not None:
                # each version's distance from the float64 evaluation of
                # the same rounding rule (relative L2)
                r["grads_end_to_end"][g]["rel_l2_to_f64"] = {
                    side: ((t.double() - e).norm() / e.norm()).item()
                    for side, t in (("kernel", a), ("plain", b))}
        del out, p_k, ds_k, dsq_k, fed, exact
    del p_ref, ds_ref, ref
    if "dropout_seed" in kw and not kw["causal"]:
        n = bits.numel()
        rate = bits.float().mean().item()
        want = keep_div
        sigma = math.sqrt(want * (1 - want) / n)
        if abs(rate - want) > KEEP_SIGMAS * sigma \
                or abs(want - (1.0 - p)) > 1.0 / 512:
            fail(f"flash {name}: Philox keep rate {rate} vs {want} "
                 f"(1 - p = {1 - p}, sigma {sigma})")
        r["keep_rate"] = {"measured": rate, "quantized_keep": want,
                          "one_minus_p": 1.0 - p, "draws": n,
                          "limit": KEEP_SIGMAS * sigma}
    return r


def _bsh_pair_timed(torch, F, flush, fa, kw, do, checked, what):
    """Rows 4 and 5 timed on one checked bf16 case (``kw``, ``do``: a
    padding bias, Philox dropout) beside the plain versions and SDPA
    (with the same dropout, on pre-split heads; its autograd backward),
    and each without dropout: what drawing the Philox bits costs."""
    q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
    b, s, h = q.shape
    nh, p = kw["num_heads"], kw["dropout_prob"]
    o, lse, bits = fa.flash_attention_bsh_fwd(**kw, return_bits=True)
    keep_div = fa.dropout_quantized_thresh(1.0 - p) / 256.0
    plain = {k_: kw[k_] for k_ in ("q", "k", "v", "bias", "num_heads")}
    # library yardstick: SDPA with dropout on pre-split heads and the
    # additive mask; its autograd backward is timed
    qh, kh, vh = (t.reshape(b, s, nh, h // nh).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (q, k, v))
    dout = do.reshape(b, s, nh, h // nh).transpose(1, 2).contiguous()
    lib_o = F.scaled_dot_product_attention(qh, kh, vh,
                                           attn_mask=bias.to(q.dtype),
                                           dropout_p=p)
    fwd = {"shape": {"B": b, "S": s, "H": h, "nh": nh, "D": h // nh,
                     "bias": "per key", "dtype": "bfloat16",
                     "dropout": f"Philox, p={p}"},
           "library": f"F.scaled_dot_product_attention with dropout_p={p} "
                      f"on pre-split heads, additive bf16 mask",
           "max_abs_err": checked["max_abs_err"]}
    n_tc = fa.flash_attention_bsh.launches_tc
    fwd.update(_timed(
        torch, flush, lambda: fa.flash_attention_bsh_fwd(**kw),
        lambda: fa.flash_attention_bsh_reference(
            **plain, dropout_prob=p, mask=bits, keep_div=keep_div),
        lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(q.dtype), dropout_p=p),
        nbytes=fa.bound_bytes(q, k, v, bias, nh),
        flops=fa.bound_flops(q, k, nh), peak_flops=BF16_FLOPS))
    if fa.flash_attention_bsh.launches_tc == n_tc:
        fail(f"row 4 at {what} ran no wgmma kernel")
    fwd["route"] = fa.bsh_fwd_route(q.dtype)
    # without dropout: what drawing the Philox bits costs row 4
    fwd["no_dropout_ms"] = time_cold_ms(
        torch, lambda: fa.flash_attention_bsh_fwd(q, k, v, bias, nh),
        flush)["median"]
    fwd["no_dropout_library_ms"] = time_cold_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias.to(q.dtype)), flush)["median"]
    bwd = {"shape": fwd["shape"],
           "library": f"autograd backward of F.scaled_dot_product_attention "
                      f"with dropout_p={p} on pre-split heads (dq, dk, dv)",
           "kernels_a_call": 2,
           "max_abs_err": max(checked["grads"].values())}
    bwd.update(_timed(
        torch, flush,
        lambda: fa.flash_attention_bsh_bwd(
            q, k, v, bias, o, lse, do, nh, dropout_prob=p,
            dropout_seed=kw["dropout_seed"]),
        lambda: fa.flash_attention_bsh_bwd_reference(
            q, k, v, bias, o, lse, do, nh, mask=bits, keep_div=keep_div),
        lambda: torch.autograd.grad(lib_o, (qh, kh, vh), dout,
                                    retain_graph=True),
        nbytes=fa.bound_bytes_bwd(q, k, v, bias, nh),
        flops=fa.bound_flops_bwd(q, k, nh), peak_flops=BF16_FLOPS))
    # the same backward without dropout: what regenerating the Philox
    # bits costs the two kernels
    o0, lse0 = fa.flash_attention_bsh_fwd(q, k, v, bias, nh)
    bwd["no_dropout_ms"] = time_cold_ms(
        torch, lambda: fa.flash_attention_bsh_bwd(q, k, v, bias, o0, lse0,
                                                  do, nh), flush)["median"]
    del qh, kh, vh, lib_o, dout, o0, lse0
    return fwd, bwd


def _tp_block_timed(torch, F, flush, fa, rng, results, fwd, bwd):
    """Rows 4 and 5 at dist_tp's shape: a rank's [4, 512, 6 x 64], 6 of
    BERT-base's 12 heads after the column-parallel q, k, v, the padding
    bias, dropout 0.1 by Philox; held against the plain versions in f32
    and bf16, then timed in bf16 (the path's AMP) beside SDPA, into
    ``fwd["dist_tp"]`` and ``bwd["dist_tp"]``."""
    c = DIST_TP_BLOCK
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        name = f"dist_tp_block_{tag}"
        kw, do = _flash_train_case(torch, rng, c["b"], c["s"], c["nh"],
                                   c["d"], dtype, p=0.1, mode="philox")
        results[name] = _flash_bwd_check(torch, fa, name, kw, do)
    f, b = _bsh_pair_timed(torch, F, flush, fa, kw, do,
                           results["dist_tp_block_bf16"],
                           "dist_tp's shape")
    f["shape"]["of"] = b["shape"]["of"] = (
        "a rank of dist_tp (dp 2 x tp 2 over 8 x 512): 6 of 12 heads")
    fwd["dist_tp"], bwd["dist_tp"] = f, b
    del kw, do
    torch.cuda.empty_cache()


def _kernels_flash_train(torch, F, flush) -> tuple:
    """The training path's flash kernels: the backward (and the forward's
    dropout) against the plain versions, then timed at BERT-base's
    training shapes: bf16, the padding bias, dropout 0.1 by Philox."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("f32", (8, 512, 12, 64, f32), {}),
        ("bf16", (8, 512, 12, 64, bf16), {}),
        ("causal_f32", (4, 512, 12, 64, f32), dict(causal=True)),
        ("d128_f32", (2, 512, 12, 128, f32), {}),
        ("d128_bf16_causal", (2, 256, 4, 128, bf16), dict(causal=True)),
        ("d256_bf16", (2, 512, 4, 256, bf16), {}),
        ("d256_f32_causal", (2, 256, 4, 256, f32), dict(causal=True)),
        ("mask_f32", (4, 512, 12, 64, f32), dict(p=0.1, mode="mask")),
        ("mask_bf16_causal", (2, 256, 4, 64, bf16),
         dict(p=0.2, mode="mask", causal=True)),
        ("philox_f32", (4, 512, 12, 64, f32), dict(p=0.1, mode="philox")),
        ("philox_bf16", (8, 512, 12, 64, bf16), dict(p=0.1, mode="philox")),
        ("philox_bf16_causal_d128", (2, 256, 4, 128, bf16),
         dict(p=0.3, mode="philox", causal=True)),
    ]
    results = {}
    main = None
    for name, shape, extra in cases:
        kw, do = _flash_train_case(torch, rng, *shape, **extra)
        results[name] = _flash_bwd_check(torch, fa, name, kw, do)
        if name == "philox_bf16":
            main = (kw, do)
        del kw, do

    kw, do = main
    fwd, bwd = _bsh_pair_timed(torch, F, flush, fa, kw, do,
                               results["philox_bf16"],
                               "BERT's training shape")
    fwd["shape"]["bias"] = "per key, lengths 128..512"
    del main, kw, do
    torch.cuda.empty_cache()
    _tp_block_timed(torch, F, flush, fa, rng, results, fwd, bwd)
    bwd["nmt_decoder"] = _time_bwd_nmt(torch, F, flush, fa, rng)
    fwd["nmt_decoder"] = _time_fwd_nmt(torch, F, flush, fa, rng)
    return results, fwd, bwd


def _time_fwd_nmt(torch, F, flush, fa, rng) -> dict:
    """Row 4 timed at the NMT decoder's two shapes (64 x 256, 8 heads of
    64, bf16, Philox p = 0.1): the causal self-attention and the
    cross-attention with its per-key source bias, each beside SDPA on the
    same inputs and the bound."""
    out = {}
    for name, causal in (("self_causal", True), ("cross_key_bias", False)):
        kw, _ = _flash_train_case(torch, rng, NMT["batch"], NMT["src_len"],
                                  NMT["heads"], NMT["d_model"] //
                                  NMT["heads"], torch.bfloat16,
                                  causal=causal, p=NMT["dropout"],
                                  mode="philox")
        if causal:
            kw["bias"] = None
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
        b, s, h = q.shape
        nh, p = kw["num_heads"], kw["dropout_prob"]
        bits = fa.flash_attention_bsh_fwd(**kw, return_bits=True)[2]
        keep_div = fa.dropout_quantized_thresh(1.0 - p) / 256.0
        qh, kh, vh = (t.reshape(b, s, nh, h // nh).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        mask = None if bias is None else bias.to(q.dtype)
        n0 = fa.flash_attention_bsh.launches_tc
        row = {"shape": {"B": b, "S": s, "H": h, "nh": nh, "D": h // nh,
                         "causal": causal, "bias": None if causal else
                         "per key", "dtype": "bfloat16",
                         "dropout": f"Philox, p={p}"},
               "library": "F.scaled_dot_product_attention (dropout_p, "
                          "is_causal or the additive key mask)"}
        row.update(_timed(
            torch, flush, lambda: fa.flash_attention_bsh_fwd(**kw),
            lambda: fa.flash_attention_bsh_reference(
                q, k, v, bias, nh, causal=causal, dropout_prob=p, mask=bits,
                keep_div=keep_div),
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, dropout_p=p, is_causal=causal),
            nbytes=fa.bound_bytes(q, k, v, bias, nh),
            flops=fa.bound_flops(q, k, nh, causal), peak_flops=BF16_FLOPS))
        if fa.flash_attention_bsh.launches_tc == n0:
            fail(f"row 4 at the NMT {name} shape ran no wgmma kernel")
        row["no_dropout_ms"] = time_cold_ms(
            torch, lambda: fa.flash_attention_bsh_fwd(
                q, k, v, bias, nh, causal=causal), flush)["median"]
        out[name] = row
        del kw, q, k, v, bias, bits, qh, kh, vh, mask
        torch.cuda.empty_cache()
    return out


def _time_bwd_nmt(torch, F, flush, fa, rng) -> dict:
    """Row 5 timed at the NMT decoder's two shapes (64 x 256, 8 heads of
    64, bf16, Philox p = 0.1): the causal self-attention and the
    cross-attention with its per-key source bias, each beside SDPA's
    autograd backward on the same inputs."""
    out = {}
    for name, causal in (("self_causal", True), ("cross_key_bias", False)):
        kw, do = _flash_train_case(torch, rng, NMT["batch"], NMT["src_len"],
                                   NMT["heads"], NMT["d_model"] //
                                   NMT["heads"], torch.bfloat16,
                                   causal=causal, p=NMT["dropout"],
                                   mode="philox")
        if causal:
            kw["bias"] = None
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
        b, s, h = q.shape
        nh, p = kw["num_heads"], kw["dropout_prob"]
        o, lse, bits = fa.flash_attention_bsh_fwd(**kw, return_bits=True)
        keep_div = fa.dropout_quantized_thresh(1.0 - p) / 256.0
        qh, kh, vh = (t.reshape(b, s, nh, h // nh).transpose(1, 2)
                      .contiguous().requires_grad_() for t in (q, k, v))
        dout = do.reshape(b, s, nh, h // nh).transpose(1, 2).contiguous()
        lib_o = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=None if bias is None else bias.to(q.dtype),
            dropout_p=p, is_causal=causal)
        n0 = fa.flash_attention_bsh_bwd.launches_tc
        row = {"shape": {"B": b, "S": s, "H": h, "nh": nh, "D": h // nh,
                         "causal": causal, "bias": None if causal else
                         "per key", "dtype": "bfloat16",
                         "dropout": f"Philox, p={p}"},
               "library": "autograd backward of "
                          "F.scaled_dot_product_attention (dropout_p, "
                          "is_causal or the additive key mask)"}
        row.update(_timed(
            torch, flush,
            lambda: fa.flash_attention_bsh_bwd(
                q, k, v, bias, o, lse, do, nh, causal=causal,
                dropout_prob=p, dropout_seed=kw["dropout_seed"]),
            lambda: fa.flash_attention_bsh_bwd_reference(
                q, k, v, bias, o, lse, do, nh, causal=causal, mask=bits,
                keep_div=keep_div),
            lambda: torch.autograd.grad(lib_o, (qh, kh, vh), dout,
                                        retain_graph=True),
            nbytes=fa.bound_bytes_bwd(q, k, v, bias, nh),
            flops=fa.bound_flops_bwd(q, k, nh, causal),
            peak_flops=BF16_FLOPS))
        if fa.flash_attention_bsh_bwd.launches_tc == n0:
            fail(f"row 5 at the NMT {name} shape ran no wgmma kernel")
        out[name] = row
        del kw, do, q, k, v, bias, o, lse, bits, qh, kh, vh, lib_o, dout
        torch.cuda.empty_cache()
    return out


def _ln_case(torch, rng, r, h, dtype, with_y):
    """LN inputs [r, h] in ``dtype`` (scale near 1, shift near 0, both
    f32) and a cotangent g."""
    def t(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor(shift + scale * rng.standard_normal(shape),
                               dtype=torch.float32)

    x, y, g = (t(r, h).to("cuda", dtype) for _ in range(3))
    return dict(x=x, y=y if with_y else None,
                scale=t(h, scale=0.1, shift=1.0).to("cuda"),
                shift=t(h, scale=0.1).to("cuda")), g


def _ln_bwd_timed(torch, F, flush, add_ln, kw, g, res) -> dict:
    """Row 3 timed on ``kw`` and g beside the autograd backward of
    F.layer_norm and its bound."""
    x, y, scale = kw["x"], kw["y"], kw["scale"]
    r, h = x.shape
    is_bf16 = x.dtype == torch.bfloat16
    _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
    s_ = (x.float() + y.float()).to(x.dtype) if y is not None else x
    xs = s_.detach().clone().requires_grad_()
    ws = scale.to(x.dtype).detach().clone().requires_grad_()
    bs = kw["shift"].to(x.dtype).detach().clone().requires_grad_()
    lib_out = F.layer_norm(xs, (h,), ws, bs, 1e-5)
    out = {"shape": {"R": r, "H": h, "y": y is not None,
                     "dtype": "bfloat16" if is_bf16 else "float32"},
           "library": "autograd backward of F.layer_norm (dx, dweight, "
                      "dbias; the residual add left out)",
           "max_abs_err": max(res["max_abs_err"], res["dscale"],
                              res["dshift"])}
    out.update(_timed(
        torch, flush,
        lambda: add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g),
        lambda: add_ln.fused_add_ln_bwd_reference(x, y, scale, mean, rstd,
                                                  g),
        lambda: torch.autograd.grad(lib_out, (xs, ws, bs), g,
                                    retain_graph=True),
        nbytes=add_ln.bound_bytes_bwd(x, y),
        flops=add_ln.bound_flops_bwd(x, y),
        peak_flops=BF16_FLOPS if is_bf16 else F32_FLOPS))
    threads, per_block, nblocks, ngroups = add_ln.bwd_geometry(
        r, h, torch.cuda.get_device_properties(0).multi_processor_count)
    out["geometry"] = {"threads": threads, "rows_per_block": per_block,
                       "blocks": nblocks, "groups": ngroups}
    return out


def _ln_fwd_timed(torch, F, flush, add_ln, kw) -> dict:
    """Row 2 on ``kw`` (bf16 with the residual) against its plain version
    and timed beside F.layer_norm of x + y."""
    x, y = kw["x"], kw["y"]
    r, h = x.shape
    s_ = (x.float() + y.float()).to(x.dtype)
    lib_scale, lib_shift = kw["scale"].to(x.dtype), kw["shift"].to(x.dtype)
    out = {"shape": {"R": r, "H": h, "y": True, "dtype": "bfloat16"},
           "library": "F.layer_norm of x + y (the add left out)",
           "max_abs_err": _check(
               f"add_ln {r} x {h} bf16_y out", add_ln.fused_add_ln_fwd(**kw)[0],
               add_ln.fused_add_ln_reference(**kw)[0], 1e-5,
               RTOL_BF16)["max_abs_err"]}
    out.update(_timed(
        torch, flush, lambda: add_ln.fused_add_ln_fwd(**kw),
        lambda: add_ln.fused_add_ln_reference(**kw),
        lambda: F.layer_norm(s_, (h,), lib_scale, lib_shift, 1e-5),
        nbytes=add_ln.bound_bytes(x, y),
        flops=add_ln.bound_flops(x, y), peak_flops=BF16_FLOPS))
    return out


def _ln_bwd_one_launch(torch, add_ln, kw, g) -> dict:
    """Row 3 is one launch and deterministic: two calls on the same
    inputs give dx, dscale and dshift equal bit for bit, and a
    torch.profiler window around one (warm) call sees exactly one CUDA
    kernel, the backward's (its final sums run inside it)."""
    x, y, scale = kw["x"], kw["y"], kw["scale"]
    _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
    first = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
    second = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dscale", "dshift"), first, second):
        if not torch.equal(a, b):
            fail(f"add_ln backward: two calls on the same inputs gave "
                 f"different {name} ({int((a != b).sum())} elements)")
    kernels = _one_device_kernel(
        torch, lambda: add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g),
        "add_ln_bwd_kernel", "add_ln backward")
    return {"bitwise_repeatable": True, "profiled": kernels}


def _profile_warm(torch):
    """A torch.profiler window whose device tracing is warm: it opens with
    a spin kernel (``torch.cuda._sleep``) and a short host pause, so a
    tracer that starts late loses the spin, not the work under test.
    Device events of the spin are to be left out (``spin_kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    torch.cuda._sleep(1 << 22)
    torch.cuda.synchronize()
    time.sleep(0.2)
    return prof


def _device_events(torch, prof) -> list:
    """The window's device events, the warm-up spin left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [evt for evt in prof.events()
            if evt.device_type == cuda and "spin_kernel" not in evt.name]


def _one_device_kernel(torch, fn, kernel: str, what: str,
                       calls: int = 3) -> dict:
    """The device operations of ``calls`` (warm) calls of ``fn`` in a
    torch.profiler window; fails unless every one is a kernel whose name
    holds ``kernel`` and there are at most ``calls`` of them, and at
    least one.  A window after the process's first can lose an event
    (PR 11's runs: 2 of 3, and 0 of 1), so the check asks for no other
    device op (a second kernel, a copy) rather than an exact count."""
    fn()
    torch.cuda.synchronize()
    prof = _profile_warm(torch)
    try:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    kernels = [evt.name for evt in _device_events(torch, prof)]
    if not 1 <= len(kernels) <= calls or any(kernel not in k
                                              for k in kernels):
        fail(f"{what}: {calls} profiled calls ran {len(kernels)} device "
             f"operations, not one kernel each: {kernels}")
    return {"calls": calls, "device_ops": len(kernels),
            "kernel": kernels[0]}


def _kernels_ln_train(torch, F, flush) -> tuple:
    """The LN backward against its plain version (f32 and bf16, with and
    without the residual), timed at the training paths' shapes: BERT's
    rows (4096 x 768) bf16 with the residual (the encoder stack's add+LN)
    and f32 without it, and the NMT step's (16,384 x 512, bf16, the
    residual), the forward beside it at both bf16 shapes; then the
    backward's one-launch and bit-for-bit checks."""
    from paddle_tpu_torch.ops.kernels import add_ln

    rng = np.random.default_rng(8)
    r, h = 4096, 768  # 8 x 512 rows, BERT-base width

    results, timed = {}, {}
    for name, dtype, with_y in (("f32", torch.float32, False),
                                ("f32_y", torch.float32, True),
                                ("bf16", torch.bfloat16, False),
                                ("bf16_y", torch.bfloat16, True)):
        kw, g = _ln_case(torch, rng, r, h, dtype, with_y)
        is_bf16 = dtype == torch.bfloat16
        _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
        x, y, scale = kw["x"], kw["y"], kw["scale"]
        dx, dsc, dsh = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
        rdx, rdsc, rdsh = add_ln.fused_add_ln_bwd_reference(
            x, y, scale, mean, rstd, g)
        torch.cuda.synchronize()
        res = _check(f"add_ln backward {name} dx", dx, rdx,
                     1e-5 if is_bf16 else ATOL_F32,
                     RTOL_BF16 if is_bf16 else 0.0)
        res["dscale"] = _check(f"add_ln backward {name} dscale", dsc, rdsc,
                               ATOL_SUM, RTOL_SUM)["max_abs_err"]
        res["dshift"] = _check(f"add_ln backward {name} dshift", dsh, rdsh,
                               ATOL_SUM, RTOL_SUM)["max_abs_err"]
        results[name] = res
        if name in ("f32", "bf16_y"):
            timed[name] = _ln_bwd_timed(torch, F, flush, add_ln, kw, g, res)
        if name == "bf16_y":
            # the forward at the same shapes, for the training path's row
            timed["fwd_bf16_y"] = _ln_fwd_timed(torch, F, flush, add_ln, kw)
            results["one_launch"] = _ln_bwd_one_launch(torch, add_ln, kw, g)
        del kw, g, dx, rdx

    # the other instantiations the paths above do not reach: bf16 rows with
    # H % 8 != 0 (8-byte chunks), wide rows (four warps a block), and a
    # row count that leaves the last block short
    for name, r_, h_, dtype, with_y in (
            ("bf16_y_h772", 512, 772, torch.bfloat16, True),
            ("f32_h2048", 256, 2048, torch.float32, False),
            ("bf16_y_h4096", 128, 4096, torch.bfloat16, True),
            ("f32_h4096", 64, 4096, torch.float32, False),
            ("bf16_h2052", 64, 2052, torch.bfloat16, False),
            ("f32_y_1000_rows_h1024", 1000, 1024, torch.float32, True)):
        kw, g = _ln_case(torch, rng, r_, h_, dtype, with_y)
        is_bf16 = dtype == torch.bfloat16
        _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
        x, y, scale = kw["x"], kw["y"], kw["scale"]
        got = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
        want = add_ln.fused_add_ln_bwd_reference(x, y, scale, mean, rstd, g)
        torch.cuda.synchronize()
        res = _check(f"add_ln backward {name} dx", got[0], want[0],
                     1e-5 if is_bf16 else ATOL_F32,
                     RTOL_BF16 if is_bf16 else 0.0)
        for i, part in ((1, "dscale"), (2, "dshift")):
            res[part] = _check(f"add_ln backward {name} {part}", got[i],
                               want[i], ATOL_SUM, RTOL_SUM)["max_abs_err"]
        results[name] = res
        del kw, g, got, want

    # the NMT step's rows: 64 x 256 tokens, d_model 512, bf16, residual
    kw, g = _ln_case(torch, rng, NMT["batch"] * NMT["src_len"],
                     NMT["d_model"], torch.bfloat16, True)
    x, y, scale = kw["x"], kw["y"], kw["scale"]
    _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
    dx, dsc, dsh = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
    rdx, rdsc, rdsh = add_ln.fused_add_ln_bwd_reference(x, y, scale, mean,
                                                        rstd, g)
    torch.cuda.synchronize()
    res = _check("add_ln backward nmt_bf16_y dx", dx, rdx, 1e-5, RTOL_BF16)
    # dscale/dshift sum 16,384 rows here: the same limits as at 4096
    res["dscale"] = _check("add_ln backward nmt_bf16_y dscale", dsc, rdsc,
                           ATOL_SUM, RTOL_SUM)["max_abs_err"]
    res["dshift"] = _check("add_ln backward nmt_bf16_y dshift", dsh, rdsh,
                           ATOL_SUM, RTOL_SUM)["max_abs_err"]
    results["nmt_bf16_y"] = res
    timed["nmt_bf16_y"] = _ln_bwd_timed(torch, F, flush, add_ln, kw, g, res)
    timed["nmt_fwd_bf16_y"] = _ln_fwd_timed(torch, F, flush, add_ln, kw)
    del kw, g, dx, rdx
    torch.cuda.empty_cache()
    return results, timed


# BERT-base pretraining at s4096 / b8 (bench.py's long-context row)
BERT_LONG = dict(batch=8, seq=4096, max_preds=76)


def _kernels_bert_long(torch, F, flush) -> tuple:
    """Rows 4 and 5 at BERT-base's long-context training shape (B 8, S
    4096, 12 heads of 64, bf16, the padding key bias, Philox p = 0.1):
    held against their plain versions at B 1 rounding by rounding
    (``_flash_bwd_check``; at B 8 the plain version's [B, 12, S, S] f32
    scores alone take 6.4 GB), timed at B 1 beside the plain versions and
    at B 8 beside SDPA's forward and autograd backward and the bound.
    Rows 2 and 3 at the step's rows (32,768 x 768, bf16, the residual),
    against their plain versions and timed."""
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(12)
    b, s, nh, d, p = BERT_LONG["batch"], BERT_LONG["seq"], 12, 64, 0.1
    bf16 = torch.bfloat16
    results, timed = {}, {}
    for batch in (1, b):
        kw, do = _flash_train_case(torch, rng, batch, s, nh, d, bf16, p=p,
                                   mode="philox")
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
        seed = kw["dropout_seed"]
        if batch == 1:
            results["philox_bf16_b1"] = _flash_bwd_check(
                torch, fa, "bert_long b1", kw, do)
        o, lse, bits = fa.flash_attention_bsh_fwd(**kw, return_bits=True)
        keep_div = fa.dropout_quantized_thresh(1.0 - p) / 256.0
        qh, kh, vh = (t.reshape(batch, s, nh, d).transpose(1, 2)
                      .contiguous().requires_grad_() for t in (q, k, v))
        dout = do.reshape(batch, s, nh, d).transpose(1, 2).contiguous()
        mask = bias.to(bf16)
        lib_o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               dropout_p=p)
        plain = batch == 1
        shape = {"B": batch, "S": s, "H": nh * d, "nh": nh, "D": d,
                 "bias": "per key, lengths 128..4096", "dtype": "bfloat16",
                 "dropout": f"Philox, p={p}"}
        n0 = (fa.flash_attention_bsh.launches_tc,
              fa.flash_attention_bsh_bwd.launches_tc)
        fwd = {"shape": shape,
               "library": "F.scaled_dot_product_attention with dropout_p="
                          "0.1 on pre-split heads, additive bf16 mask"}
        fwd.update(_timed(
            torch, flush, lambda: fa.flash_attention_bsh_fwd(**kw),
            (lambda: fa.flash_attention_bsh_reference(
                q, k, v, bias, nh, dropout_prob=p, mask=bits,
                keep_div=keep_div)) if plain else None,
            lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, dropout_p=p),
            nbytes=fa.bound_bytes(q, k, v, bias, nh),
            flops=fa.bound_flops(q, k, nh), peak_flops=BF16_FLOPS))
        fwd["no_dropout_ms"] = time_cold_ms(
            torch, lambda: fa.flash_attention_bsh_fwd(q, k, v, bias, nh),
            flush)["median"]
        bwd = {"shape": shape, "kernels_a_call": 2,
               "library": "autograd backward of "
                          "F.scaled_dot_product_attention with dropout_p="
                          "0.1 on pre-split heads (dq, dk, dv)"}
        bwd.update(_timed(
            torch, flush,
            lambda: fa.flash_attention_bsh_bwd(
                q, k, v, bias, o, lse, do, nh, dropout_prob=p,
                dropout_seed=seed),
            (lambda: fa.flash_attention_bsh_bwd_reference(
                q, k, v, bias, o, lse, do, nh, mask=bits,
                keep_div=keep_div)) if plain else None,
            lambda: torch.autograd.grad(lib_o, (qh, kh, vh), dout,
                                        retain_graph=True),
            nbytes=fa.bound_bytes_bwd(q, k, v, bias, nh),
            flops=fa.bound_flops_bwd(q, k, nh), peak_flops=BF16_FLOPS))
        if (fa.flash_attention_bsh.launches_tc == n0[0]
                or fa.flash_attention_bsh_bwd.launches_tc == n0[1]):
            fail(f"rows 4 and 5 at BERT s4096, B {batch}, ran no wgmma "
                 f"kernel")
        for row in (fwd, bwd):
            row["max_abs_err"] = (
                results["philox_bf16_b1"]["max_abs_err"] if row is fwd
                else max(results["philox_bf16_b1"]["grads"].values()))
        timed[f"flash_attention_bsh_b{batch}"] = fwd
        timed[f"flash_attention_bsh_bwd_b{batch}"] = bwd
        del kw, do, q, k, v, bias, o, lse, bits, qh, kh, vh, dout, mask
        del lib_o
        torch.cuda.empty_cache()

    kw, g = _ln_case(torch, rng, b * s, 768, bf16, True)
    x, y, scale = kw["x"], kw["y"], kw["scale"]
    _, mean, rstd = add_ln.fused_add_ln_fwd(**kw)
    got = add_ln.fused_add_ln_bwd(x, y, scale, mean, rstd, g)
    want = add_ln.fused_add_ln_bwd_reference(x, y, scale, mean, rstd, g)
    torch.cuda.synchronize()
    res = _check("add_ln backward bert_long dx", got[0], want[0], 1e-5,
                 RTOL_BF16)
    for i, part in ((1, "dscale"), (2, "dshift")):
        res[part] = _check(f"add_ln backward bert_long {part}", got[i],
                           want[i], ATOL_SUM, RTOL_SUM)["max_abs_err"]
    results["add_ln_bwd_bf16_y"] = res
    timed["add_ln_bwd"] = _ln_bwd_timed(torch, F, flush, add_ln, kw, g, res)
    timed["add_ln"] = _ln_fwd_timed(torch, F, flush, add_ln, kw)
    del kw, g, got, want
    torch.cuda.empty_cache()
    return results, timed


# BHSD flash (rows 6-9).  dbias is ds summed in f32 over up to B * nh * S
# = 131,072 terms (a [1, 1, 1, S] key bias) in another order than
# torch's (first reading 1.1e-4); a bf16 full dbias is rounded to bf16 by
# both sides
ATOL_DBIAS = 5e-4
BHSD_BIASES = ("key", "key_shared", "full", "full_b1", "full_1h", "full_11")


def _bhsd_bias(torch, rng, name, b, nh, s, dtype, padded=False):
    """A bias of the named broadcast: the per-key ones a padding mask
    (lengths S/2..S, f32 like the data), the full ones random N(0, 1) in
    the dtype (bf16 under AMP), or with ``padded`` the reference recipe's
    tiling of a padding mask over heads and query rows."""
    shape = {"key": (b, 1, 1, s), "key_shared": (1, 1, 1, s),
             "full": (b, nh, s, s), "full_b1": (b, 1, s, s),
             "full_1h": (1, nh, s, s), "full_11": (1, 1, s, s)}[name]
    if name.startswith("key") or padded:
        lens = rng.integers(s // 2, s + 1, shape[0])
        key = 1e4 * ((np.arange(s)[None, :] < lens[:, None]) - 1.0)
        x = np.broadcast_to(key[:, None, None, :], shape)
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32
                               ).to("cuda", torch.float32
                                    if name.startswith("key") else dtype)
    return torch.as_tensor(rng.standard_normal(shape),
                           dtype=torch.float32).to("cuda", dtype)


def _bhsd_case(torch, rng, b, nh, s, d, dtype, bias=None, *, causal=False,
               q_off=0, k_off=0, p=0.0, mode=None, g_lse=False,
               want_dbias=False, padded=False, bias_dtype=None):
    """q, k, v, dO [B, nh, S, D], the bias (a full one in ``bias_dtype``,
    default the data's), causal offsets, the dropout as the forward takes
    it, the lse cotangent and whether dbias is asked."""
    q, k, v, do = (torch.as_tensor(rng.standard_normal((b, nh, s, d)),
                                   dtype=torch.float32).to("cuda", dtype)
                   for _ in range(4))
    kw = dict(q=q, k=k, v=v, causal=causal, q_offset=q_off, k_offset=k_off,
              dropout_prob=p,
              bias=None if bias is None else _bhsd_bias(
                  torch, rng, bias, b, nh, s, bias_dtype or dtype, padded))
    if mode == "mask":
        kw["mask"] = torch.as_tensor(
            rng.random((b, nh, s, s)) > p).to("cuda", torch.uint8)
    elif mode == "philox":
        kw["dropout_seed"] = int(rng.integers(1, 2 ** 62))
    bwd = dict(do=do, want_dbias=want_dbias,
               g_lse=torch.as_tensor(rng.standard_normal((b, nh, s)),
                                     dtype=torch.float32).to("cuda")
               if g_lse else None)
    return kw, bwd


def _bhsd_keep(fa, kw, bits):
    """(keep mask, keep_div) the plain versions take: the given mask, or
    the Philox bits the forward drew at the quantized keep."""
    p = kw["dropout_prob"]
    if "dropout_seed" in kw:
        return bits, fa.dropout_quantized_thresh(1.0 - p) / 256.0
    return kw.get("mask"), 1.0 - p


def _fwd_rounding(torch, name, o, lse, checks, probs_ref, products,
                  o_ref) -> dict:
    """A bf16 wgmma forward (row 4 or row 6) held rounding by rounding, as
    the backwards are: it rounds p c to bf16 before P.V relative to its
    running max after each 64-key tile, the plain version relative to the
    row's max, and where an f32 p sits within the two versions' f32
    difference of a bf16 boundary the two round it to neighbouring
    values.  So the kernel's rounded p c (its check output), scaled by
    exp(m_t - lse) to p c / l, is held against the plain version's p c /
    l (``probs_ref``: p c, m, l_safe), and its o against the plain product
    of its own p c (``products(p_k, m_k, tile)``), both at 1e-5 + 2^-7
    |plain| (two roundings of one value differ by at most 2^-8 of it);
    the end-to-end difference from the plain forward is reported."""
    p_k, m_k = checks
    p_ref, _, l_ref = probs_ref
    tile = p_k.shape[-1] // m_k.shape[-1]
    pn_k = p_k.float() * torch.exp(
        m_k - lse[..., None]).repeat_interleave(tile, dim=-1)
    pn_ref = p_ref / l_ref
    del p_ref, l_ref, probs_ref
    r = {"p_over_l": _check(f"{name} forward p c / l", pn_k, pn_ref, 1e-5,
                            RTOL_BF16)["max_abs_err"]}
    del pn_k, pn_ref
    fed = products(p_k, m_k, tile)
    r["o_vs_products"] = _check(f"{name} o", o, fed, 1e-5,
                                RTOL_BF16)["max_abs_err"]
    del fed
    diff = (o.float() - o_ref.float()).abs()
    r["o_end_to_end"] = {
        "max_abs_err": diff.max().item(),
        "beyond_limit": int((diff > 1e-5 + RTOL_BF16
                             * o_ref.float().abs()).sum()),
        "elements": diff.numel()}
    return r


def _bhsd_fwd_rounding(torch, fa, name, kw, o, lse, checks, mask, keep_div,
                       o_ref) -> dict:
    """Row 6 in bf16 held rounding by rounding (``_fwd_rounding``)."""
    q, v = kw["q"], kw["v"]
    sm = 1.0 / math.sqrt(q.shape[-1])
    probs = fa.bhsd_fwd_probs_reference(
        q, kw["k"], kw["bias"], sm, kw["causal"],
        mask if kw["dropout_prob"] else None, keep_div, kw["q_offset"],
        kw["k_offset"])
    return _fwd_rounding(
        torch, f"flash bhsd {name}", o, lse, checks, probs,
        lambda p_k, m_k, tile: fa.bhsd_fwd_products_reference(
            v, p_k, m_k, lse, tile), o_ref)


def _bhsd_check(torch, fa, name, kw, bwd) -> dict:
    """Row 6 (drawing its Philox bits) and the backward kernels the bias
    selects (rows 8 and 9 for a full bias, row 7 otherwise) against the
    plain versions fed the same keep bits; the keep rate for Philox.

    bf16: row 6 (the wgmma kernel) rounds p c before P.V as the TPU
    kernel does, held rounding by rounding (``_bhsd_fwd_rounding``); its
    Philox bits must equal the f32 SIMT forward's for the same seed.
    Every bf16 backward (rows 8 and 9 on the wgmma kernels with a full
    bias, row 7 on the SIMT cores otherwise) rounds p c and ds0 sm_scale
    to bf16 before the products, as the TPU kernels do, and each rounding
    is held on its own, as row 5's (``_flash_bwd_check``): the kernels'
    rounded intermediates (their check outputs) against the plain
    version's, and their dq, dk, dv against the plain products of those
    intermediates, at 1e-5 + 2^-7 |plain|; dbias (the unrounded ds0)
    against the plain one at ATOL_DBIAS.  The end-to-end difference is
    reported beside them."""
    is_bf16 = kw["q"].dtype == torch.bfloat16
    p = kw["dropout_prob"]
    f0 = (fa.flash_attention.launches, fa.flash_attention.launches_tc)
    o, lse, bits, fchecks = fa.flash_attention_fwd(**kw, return_bits=True,
                                                   return_probs=True)
    ran_fwd = (fa.flash_attention.launches - f0[0],
               fa.flash_attention.launches_tc - f0[1])
    if ran_fwd != (1, int(is_bf16)) or (fchecks is None) == is_bf16:
        fail(f"flash bhsd {name}: the forward launched {ran_fwd} (all, on "
             f"the tensor cores)")
    mask, keep_div = _bhsd_keep(fa, kw, bits)
    plain = {k: kw[k] for k in ("q", "k", "v", "bias", "causal", "q_offset",
                                "k_offset")}
    o_ref, lse_ref = fa.flash_attention_reference(
        **plain, dropout_prob=p, mask=mask, keep_div=keep_div if p else None)
    # both backwards start from the kernel forward's o and lse
    q, k, v, do = kw["q"], kw["k"], kw["v"], bwd["do"]
    args = (q, k, v, kw["bias"], o, lse, do)
    offs = dict(causal=kw["causal"], q_offset=kw["q_offset"],
                k_offset=kw["k_offset"], g_lse=bwd["g_lse"])

    def counts():
        return (fa.flash_attention_bwd_fused.launches,
                fa.flash_attention_bwd_dq.launches,
                fa.flash_attention_bwd_dkv.launches,
                fa.flash_attention_bwd_fused.launches_tc,
                fa.flash_attention_bwd_dq.launches_tc,
                fa.flash_attention_bwd_dkv.launches_tc)

    n0 = counts()
    out = fa.flash_attention_bwd(*args, dropout_prob=p, mask=kw.get("mask"),
                                 dropout_seed=kw.get("dropout_seed"),
                                 want_dbias=bwd["want_dbias"],
                                 return_probs=True, **offs)
    got = out[:4]
    ref = fa.flash_attention_bwd_reference(
        *args, mask=mask if p else None, keep_div=keep_div,
        want_dbias=bwd["want_dbias"], **offs)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(counts(), n0)]
    full = kw["bias"] is not None and kw["bias"].shape[2] != 1
    want = [0, 1, 1, 0, int(is_bf16), int(is_bf16)] if full else [
        1, 0, 0, int(is_bf16), 0, 0]
    if ran != want:
        fail(f"flash bhsd {name}: backward launched {ran} (fused, dq, dkv, "
             f"each again on the tensor cores), want {want}")
    if is_bf16:
        r = _bhsd_fwd_rounding(torch, fa, name, kw, o, lse, fchecks, mask,
                               keep_div, o_ref)
        r["max_abs_err"] = r["o_vs_products"]
        r["forward_kernel"] = "row 6 (wgmma)"
    else:
        r = _check(f"flash bhsd {name} o", o, o_ref, ATOL_F32)
    del fchecks
    r["lse"] = _check(f"flash bhsd {name} lse", lse, lse_ref,
                      ATOL_LSE)["max_abs_err"]
    if not is_bf16:
        r["grads"] = _check_grads(f"flash bhsd backward {name}", got[:3],
                                  ref[:3], is_bf16)
    else:
        p_k, ds_k, dsq_k = out[4]
        sm = 1.0 / math.sqrt(q.shape[-1])
        p_num, ds0 = fa.bhsd_bwd_probs_reference(
            *args, sm, mask=mask if p else None, keep_div=keep_div, **offs)
        p_ref, ds_ref = fa.bhsd_bwd_rounded(p_num, ds0, sm, do.dtype,
                                            q.dtype)
        del p_num, ds0
        r["intermediates"] = {
            t: _check(f"flash bhsd backward {name} {t}", a, p_ref if t == "p"
                      else ds_ref, 1e-5, RTOL_BF16)["max_abs_err"]
            for t, a in (("p", p_k), ("ds", ds_k), ("ds_dq", dsq_k))}
        fed = fa.bhsd_bwd_products_reference(q, k, v, do, p_k, ds_k,
                                             ds_q=dsq_k)
        r["grads"] = _check_grads(f"flash bhsd backward {name}", got[:3],
                                  fed, True)
        r["grads_end_to_end"] = _end_to_end(got[:3], ref[:3])
        del out, p_k, ds_k, dsq_k, p_ref, ds_ref, fed
    if bwd["want_dbias"]:
        bias_bf16 = kw["bias"].dtype == torch.bfloat16
        r["grads"]["dbias"] = _check(
            f"flash bhsd backward {name} dbias", got[3], ref[3], ATOL_DBIAS,
            RTOL_BF16 if bias_bf16 else 0.0)["max_abs_err"]
    r["backward_kernels"] = ("rows 8 + 9" if full else "row 7") + (
        " (wgmma)" if is_bf16 else "")
    if "dropout_seed" in kw and is_bf16:
        # the same Philox bits as the f32 SIMT forward draws
        kw32 = dict(kw, **{n: kw[n].float() for n in ("q", "k", "v")})
        bits32 = fa.flash_attention_fwd(**kw32, return_bits=True)[2]
        if not torch.equal(bits, bits32):
            fail(f"flash bhsd {name}: the wgmma forward's Philox bits "
                 f"differ from the SIMT forward's in "
                 f"{int((bits != bits32).sum())} places")
        r["philox_bits_equal_simt_f32"] = True
        del kw32, bits32
    if "dropout_seed" in kw and not kw["causal"]:
        n = bits.numel()
        rate = bits.float().mean().item()
        sigma = math.sqrt(keep_div * (1 - keep_div) / n)
        if abs(rate - keep_div) > KEEP_SIGMAS * sigma \
                or abs(keep_div - (1.0 - p)) > 1.0 / 512:
            fail(f"flash bhsd {name}: Philox keep rate {rate} vs "
                 f"{keep_div} (sigma {sigma})")
        r["keep_rate"] = {"measured": rate, "quantized_keep": keep_div,
                          "draws": n, "limit": KEEP_SIGMAS * sigma}
    if kw["causal"] and kw["k_offset"] - kw["q_offset"] >= 64:
        # the first q tile sees no key: o 0, lse NEG_INF, no gradient
        blind = kw["k_offset"] - kw["q_offset"]
        if o[:, :, :blind].any() or got[0][:, :, :blind].any() \
                or not (lse[:, :, :blind] <= fa.NEG_INF).all():
            fail(f"flash bhsd {name}: rows that see no key are not 0")
        r["rows_seeing_no_key"] = blind
    return r


def _bhsd_block_lse_check(torch, fa, rng) -> dict:
    """``flash_block_with_lse`` through its autograd Function on the card:
    (o, lse) with cotangents for both and the key dbias, causal at
    offsets, against the plain versions."""
    b, nh, s, d = 8, 8, 256, 64
    kw, bwd = _bhsd_case(torch, rng, b, nh, s, d, torch.float32, "key",
                         causal=True, q_off=128, k_off=0, g_lse=True)
    kb = kw["bias"].reshape(b, s).clone().requires_grad_()
    qkv = [kw[n].clone().requires_grad_() for n in ("q", "k", "v")]
    o, lse = fa.flash_block_with_lse(*qkv, kb, causal=True, q_offset=128,
                                     k_offset=0)
    grads = torch.autograd.grad((o, lse), qkv + [kb],
                                (bwd["do"], bwd["g_lse"]))
    o_ref, lse_ref = fa.flash_attention_reference(
        kw["q"], kw["k"], kw["v"], kw["bias"], causal=True, q_offset=128)
    ref = fa.flash_attention_bwd_reference(
        kw["q"], kw["k"], kw["v"], kw["bias"], o.detach(), lse.detach(),
        bwd["do"], causal=True, q_offset=128, g_lse=bwd["g_lse"],
        want_dbias=True)
    torch.cuda.synchronize()
    r = _check("flash_block_with_lse o", o, o_ref, ATOL_F32)
    r["lse"] = _check("flash_block_with_lse lse", lse, lse_ref,
                      ATOL_LSE)["max_abs_err"]
    r["grads"] = _check_grads("flash_block_with_lse", grads[:3], ref[:3],
                              False)
    r["grads"]["dkey_bias"] = _check(
        "flash_block_with_lse dkey_bias", grads[3], ref[3].reshape(b, s),
        ATOL_DBIAS)["max_abs_err"]
    return r


def _bhsd_sdpa(torch, F, kw, p):
    """The library yardstick: SDPA on the same [B, nh, S, D] tensors with
    the bias as a float ``attn_mask``, and q, k, v needing grads for its
    autograd backward."""
    qh, kh, vh = (kw[n].detach().clone().requires_grad_()
                  for n in ("q", "k", "v"))
    mask = kw["bias"].to(kw["q"].dtype)

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              dropout_p=p)

    return (qh, kh, vh), call


def _kernels_flash_bhsd(torch, F, flush) -> tuple:
    """Rows 6-9 against their plain versions at the NMT path's shapes (B
    64, nh 8, S 256, D 64, f32 with TF32 off and bf16; every bias mode
    and broadcast, dbias, causal at offsets, dropout from a mask and from
    Philox), then each timed at its main path's inputs."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(11)
    f32, bf16 = torch.float32, torch.bfloat16
    b, nh, s, d = 64, 8, 256, 64
    cases = [("none_f32", (f32, None), {}),
             ("none_bf16_causal", (bf16, None), dict(causal=True))]
    for i, bias in enumerate(BHSD_BIASES):
        for dtype in (f32, bf16):
            cases.append((f"{bias}_{'bf16' if dtype == bf16 else 'f32'}",
                          (dtype, bias),
                          dict(want_dbias=True, causal=i % 2 == 1)))
    cases += [
        ("key_causal_k_after", (f32, "key"),
         dict(causal=True, q_off=0, k_off=128, g_lse=True)),
        ("full_causal_offsets", (f32, "full"),
         dict(causal=True, q_off=96, k_off=32, g_lse=True,
              want_dbias=True)),
        ("full_b1_bf16_k_after", (bf16, "full_b1"),
         dict(causal=True, q_off=64, k_off=192)),
        ("key_shared_g_lse", (f32, "key_shared"),
         dict(g_lse=True, want_dbias=True)),
        ("full_mask_f32", (f32, "full"), dict(p=0.1, mode="mask")),
        ("key_mask_bf16_causal", (bf16, "key"),
         dict(p=0.2, mode="mask", causal=True)),
        ("full_philox_bf16", (bf16, "full"), dict(p=0.1, mode="philox")),
        ("full_f32_bias_bf16_mask", (bf16, "full"),
         dict(p=0.1, mode="mask", bias_dtype=f32, want_dbias=True)),
        ("key_shared_philox_bf16", (bf16, "key_shared"),
         dict(p=0.1, mode="philox", want_dbias=True)),
        ("full_11_philox_f32_causal", (f32, "full_11"),
         dict(p=0.3, mode="philox", causal=True, want_dbias=True)),
        # row 7 on its wgmma kernel: causal offsets with the lse
        # cotangent, a query tile that sees no key, Philox without a bias
        ("key_causal_offsets_bf16", (bf16, "key"),
         dict(causal=True, q_off=96, k_off=32, g_lse=True,
              want_dbias=True)),
        ("key_shared_k_after_bf16", (bf16, "key_shared"),
         dict(causal=True, q_off=0, k_off=128, g_lse=True,
              want_dbias=True)),
        ("none_philox_bf16_causal", (bf16, None),
         dict(p=0.1, mode="philox", causal=True)),
    ]
    results = {}
    for name, (dtype, bias), extra in cases:
        kw, bwd = _bhsd_case(torch, rng, b, nh, s, d, dtype, bias, **extra)
        results[name] = _bhsd_check(torch, fa, name, kw, bwd)
        del kw, bwd
    # the other head dims the kernels are built for, at a smaller batch
    for name, dd, dtype, bias, extra in (
            ("d128_full_bf16", 128, bf16, "full_b1",
             dict(want_dbias=True)),
            ("d128_key_f32_philox", 128, f32, "key",
             dict(p=0.1, mode="philox")),
            ("d256_full_f32_causal", 256, f32, "full_1h",
             dict(causal=True, want_dbias=True)),
            ("d256_key_bf16", 256, bf16, "key_shared",
             dict(want_dbias=True)),
            ("d256_full_bf16_philox_causal", 256, bf16, "full_1h",
             dict(causal=True, p=0.1, mode="philox", want_dbias=True)),
            ("d128_key_bf16_causal_offsets", 128, bf16, "key",
             dict(causal=True, q_off=32, k_off=96, g_lse=True,
                  want_dbias=True)),
            ("d256_none_bf16_mask", 256, bf16, None,
             dict(p=0.2, mode="mask"))):
        kw, bwd = _bhsd_case(torch, rng, 4, 4, 256, dd, dtype, bias, **extra)
        results[name] = _bhsd_check(torch, fa, name, kw, bwd)
    results["block_with_lse"] = _bhsd_block_lse_check(torch, fa, rng)
    torch.cuda.empty_cache()

    timed = {}
    sm = 1.0 / math.sqrt(d)
    # rows 6, 8 and 9 at nmt_train's encoder: bf16, the reference
    # recipe's tiled padding bias [B, nh, S, S] in bf16, Philox p = 0.1
    p = 0.1
    kw, bwd = _bhsd_case(torch, rng, b, nh, s, d, bf16, "full", p=p,
                         mode="philox", padded=True)
    q, k, v, bias, do = kw["q"], kw["k"], kw["v"], kw["bias"], bwd["do"]
    o, lse, bits = fa.flash_attention_fwd(**kw, return_bits=True)
    mask, keep_div = _bhsd_keep(fa, kw, bits)
    bias_k, mode, dims = fa._classify_bias(bias, b, nh, s)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, sm, False, 0, 0, p,
            None, kw["dropout_seed"], 0, False)
    (qh, kh, vh), sdpa = _bhsd_sdpa(torch, F, kw, p)
    lib_o = sdpa()
    shape = {"B": b, "nh": nh, "S": s, "D": d, "dtype": "bfloat16",
             "bias": "full [B, nh, S, S] bf16, the tiled padding mask",
             "dropout": "Philox, p=0.1"}
    plain_fwd = dict(q=q, k=k, v=v, bias=bias, dropout_prob=p, mask=mask,
                     keep_div=keep_div)
    t = {"shape": shape, "max_abs_err": results["full_philox_bf16"][
        "max_abs_err"],
         "library": "F.scaled_dot_product_attention, the bias as a bf16 "
                    "attn_mask, dropout_p=0.1"}
    n_tc = fa.flash_attention.launches_tc
    t.update(_timed(torch, flush, lambda: fa.flash_attention_fwd(**kw),
                    lambda: fa.flash_attention_reference(**plain_fwd),
                    sdpa, nbytes=fa.bound_bytes_bhsd(q, bias),
                    flops=fa.bound_flops_bhsd(q), peak_flops=BF16_FLOPS))
    if fa.flash_attention.launches_tc == n_tc:
        fail("row 6 at the NMT encoder shape ran no wgmma kernel")
    t["route"] = fa.bhsd_fwd_route(q.dtype)
    # without dropout: what drawing the Philox bits costs row 6
    t["no_dropout_ms"] = time_cold_ms(
        torch, lambda: fa.flash_attention_fwd(q, k, v, bias),
        flush)["median"]
    t["no_dropout_library_ms"] = time_cold_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias), flush)["median"]
    timed["flash_attention"] = t
    plain_bwd = (lambda: fa.flash_attention_bwd_reference(
        q, k, v, bias, o, lse, do, mask=mask, keep_div=keep_div))
    lib_bwd = (lambda: torch.autograd.grad(lib_o, (qh, kh, vh), do,
                                           retain_graph=True))
    # the same inputs without dropout: what regenerating the Philox bits
    # costs rows 8 and 9 (as row 5 is timed)
    o0, lse0 = fa.flash_attention_fwd(q, k, v, bias)
    args0 = (q, k, v, bias_k, mode, dims, lse0,
             (o0.float() * do.float()).sum(-1), do, sm, False, 0, 0, 0.0,
             None, None, 0, False)
    n0 = (fa.flash_attention_bwd_dq.launches_tc,
          fa.flash_attention_bwd_dkv.launches_tc)
    for key, fn, part in (("flash_attention_bwd_dq",
                           fa.flash_attention_bwd_dq, "dq"),
                          ("flash_attention_bwd_dkv",
                           fa.flash_attention_bwd_dkv, "dkv")):
        t = {"shape": shape,
             "max_abs_err": max(results["full_philox_bf16"]["grads"]
                                .values()),
             "library": "autograd backward of the SDPA call above (dq, dk "
                        "and dv: rows 8 and 9 together)",
             "plain": "the plain backward (dq, dk and dv together)"}
        t.update(_timed(torch, flush, lambda fn=fn: fn(*args), plain_bwd,
                        lib_bwd, nbytes=fa.bound_bytes_bhsd(q, bias, part),
                        flops=fa.bound_flops_bhsd(q, part),
                        peak_flops=BF16_FLOPS))
        t["no_dropout_ms"] = time_cold_ms(
            torch, lambda fn=fn: fn(*args0), flush)["median"]
        timed[key] = t
    # the pair in one window, as one backward of the encoder runs it
    pair = {"ms": time_cold_ms(torch, lambda: (
        fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)),
        flush)["median"]}
    pair["no_dropout_ms"] = time_cold_ms(torch, lambda: (
        fa.flash_attention_bwd_dq(*args0),
        fa.flash_attention_bwd_dkv(*args0)), flush)["median"]
    pair["library_ms"] = timed["flash_attention_bwd_dq"]["library_ms"]
    timed["flash_attention_bwd_dkv"]["pair_with_dq"] = pair
    if (fa.flash_attention_bwd_dq.launches_tc == n0[0]
            or fa.flash_attention_bwd_dkv.launches_tc == n0[1]):
        fail("rows 8 and 9 at the NMT encoder shape ran no wgmma kernel")
    del kw, bwd, q, k, v, bias, do, o, lse, bits, lib_o, qh, kh, vh, args
    del o0, lse0, args0
    torch.cuda.empty_cache()

    # row 7 at mha_key_train's attention: bf16, a [1, 1, 1, S] padding
    # bias, Philox p = 0.1
    kw, bwd = _bhsd_case(torch, rng, b, nh, s, d, bf16, "key_shared", p=p,
                         mode="philox")
    q, k, v, bias, do = kw["q"], kw["k"], kw["v"], kw["bias"], bwd["do"]
    o, lse, bits = fa.flash_attention_fwd(**kw, return_bits=True)
    mask, keep_div = _bhsd_keep(fa, kw, bits)
    bias_k, mode, dims = fa._classify_bias(bias, b, nh, s)
    delta = (o.float() * do.float()).sum(-1)
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, sm, False, 0, 0, p,
            None, kw["dropout_seed"], 0, False)
    (qh, kh, vh), sdpa = _bhsd_sdpa(torch, F, kw, p)
    lib_o = sdpa()
    t = {"shape": dict(shape, bias="per key [1, 1, 1, S], shared over the "
                                   "batch"),
         "max_abs_err": max(results["key_shared_philox_bf16"]["grads"]
                            .values()),
         "library": "autograd backward of SDPA with the [1, 1, 1, S] bias "
                    "as a bf16 attn_mask, dropout_p=0.1 (dq, dk, dv)"}
    n_tc = fa.flash_attention_bwd_fused.launches_tc
    t.update(_timed(
        torch, flush, lambda: fa.flash_attention_bwd_fused(*args),
        lambda: fa.flash_attention_bwd_reference(
            q, k, v, bias, o, lse, do, mask=mask, keep_div=keep_div),
        lambda: torch.autograd.grad(lib_o, (qh, kh, vh), do,
                                    retain_graph=True),
        nbytes=fa.bound_bytes_bhsd(q, bias, "fused"),
        flops=fa.bound_flops_bhsd(q, "fused"), peak_flops=BF16_FLOPS))
    if fa.flash_attention_bwd_fused.launches_tc == n_tc:
        fail("row 7 at mha_key_train's shape ran no wgmma kernel")
    t["route"] = fa.bhsd_bwd_route(q.dtype, mode)
    # without dropout (what regenerating the Philox bits costs), and
    # causal (mha_key_train's second run)
    o0, lse0 = fa.flash_attention_fwd(q, k, v, bias)
    args0 = (q, k, v, bias_k, mode, dims, lse0,
             (o0.float() * do.float()).sum(-1), do, sm, False, 0, 0, 0.0,
             None, None, 0, False)
    t["no_dropout_ms"] = time_cold_ms(
        torch, lambda: fa.flash_attention_bwd_fused(*args0), flush)["median"]
    oc, lsec = fa.flash_attention_fwd(q, k, v, bias, causal=True,
                                      dropout_prob=p,
                                      dropout_seed=kw["dropout_seed"])
    argsc = (q, k, v, bias_k, mode, dims, lsec,
             (oc.float() * do.float()).sum(-1), do, sm, True, 0, 0, p,
             None, kw["dropout_seed"], 0, False)
    t["causal_ms"] = time_cold_ms(
        torch, lambda: fa.flash_attention_bwd_fused(*argsc), flush)["median"]
    t["causal_bound_ms"] = max(
        fa.bound_bytes_bhsd(q, bias, "fused") / HBM_BYTES_PER_S,
        fa.bound_flops_bhsd(q, "fused", causal=True) / BF16_FLOPS) * 1e3
    del o0, lse0, args0, oc, lsec, argsc
    timed["flash_attention_bwd_fused"] = t
    # row 6 at the same inputs (mha_key_train's forward)
    t = {"shape": timed["flash_attention_bwd_fused"]["shape"],
         "max_abs_err": results["key_shared_philox_bf16"]["max_abs_err"],
         "library": "F.scaled_dot_product_attention, the [1, 1, 1, S] bias "
                    "as a bf16 attn_mask, dropout_p=0.1"}
    t.update(_timed(
        torch, flush, lambda: fa.flash_attention_fwd(**kw),
        lambda: fa.flash_attention_reference(
            q, k, v, bias, dropout_prob=p, mask=mask, keep_div=keep_div),
        sdpa, nbytes=fa.bound_bytes_bhsd(q, bias),
        flops=fa.bound_flops_bhsd(q), peak_flops=BF16_FLOPS))
    timed["flash_attention"]["mha_key_train"] = t
    del kw, bwd, q, k, v, bias, do, o, lse, bits, lib_o, qh, kh, vh, args
    torch.cuda.empty_cache()
    _ring_block_timed(torch, F, flush, fa, rng, results, timed)
    return results, timed


def _ring_block_timed(torch, F, flush, fa, rng, results, timed):
    """Rows 6 and 7 at one ring step of dist_train: a rank's [4, 12, 256,
    64] block (DIST_RING_TRAIN), a per-batch key bias [B, 1, 1, S], the
    lse cotangent the ring's merge gives, dbias asked, no dropout; held
    against the plain versions in bf16 and f32, then timed in bf16 (the
    path's AMP).  Row 7's entry reports this timing: dist_train is its
    main path."""
    c = DIST_RING_TRAIN
    b, s = c["b"] // c["mesh"]["dp"], c["s"] // c["mesh"]["sp"]
    nh, d = c["nh"], c["d"]
    for dtype in (torch.float32, torch.bfloat16):
        name = f"dist_train_block_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
        kw, bwd = _bhsd_case(torch, rng, b, nh, s, d, dtype, "key",
                             g_lse=True, want_dbias=True)
        results[name] = _bhsd_check(torch, fa, name, kw, bwd)
    # kw, bwd: the bf16 case just checked
    q, k, v, bias, do, g = (kw["q"], kw["k"], kw["v"], kw["bias"],
                            bwd["do"], bwd["g_lse"])
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    bias_k, mode, dims = fa._classify_bias(bias, b, nh, s)
    delta = (o.float() * do.float()).sum(-1) - g
    args = (q, k, v, bias_k, mode, dims, lse, delta, do, 1.0 / math.sqrt(d),
            False, 0, 0, 0.0, None, None, 0, True)
    (qh, kh, vh), sdpa = _bhsd_sdpa(torch, F, kw, 0.0)
    lib_o = sdpa()
    shape = {"B": b, "nh": nh, "S": s, "D": d, "dtype": "bfloat16",
             "bias": "per key [B, 1, 1, S] f32, each rank's padding block",
             "g_lse": True, "dbias": True, "dropout": None,
             "of": "one ring step of dist_train (dp 2 x sp 2, 8 x 512)"}
    err = results["dist_train_block_bf16"]
    t = {"shape": shape, "max_abs_err": max(err["grads"].values()),
         "library": "autograd backward of SDPA with the key bias as a bf16 "
                    "attn_mask (dq, dk, dv; no lse cotangent, no dbias)"}
    n_tc = fa.flash_attention_bwd_fused.launches_tc
    t.update(_timed(
        torch, flush, lambda: fa.flash_attention_bwd_fused(*args),
        lambda: fa.flash_attention_bwd_reference(
            q, k, v, bias, o, lse, do, g_lse=g, want_dbias=True),
        lambda: torch.autograd.grad(lib_o, (qh, kh, vh), do,
                                    retain_graph=True),
        nbytes=fa.bound_bytes_bhsd(q, bias, "fused", want_dbias=True),
        flops=fa.bound_flops_bhsd(q, "fused"), peak_flops=BF16_FLOPS))
    if fa.flash_attention_bwd_fused.launches_tc == n_tc:
        fail("row 7 at dist_train's ring block ran no wgmma kernel")
    t["route"] = fa.bhsd_bwd_route(q.dtype, mode)
    t["mha_key_train"] = timed["flash_attention_bwd_fused"]
    timed["flash_attention_bwd_fused"] = t
    t = {"shape": shape, "max_abs_err": err["max_abs_err"],
         "library": "F.scaled_dot_product_attention, the key bias as a "
                    "bf16 attn_mask"}
    t.update(_timed(
        torch, flush, lambda: fa.flash_attention_fwd(q, k, v, bias),
        lambda: fa.flash_attention_reference(q, k, v, bias), sdpa,
        nbytes=fa.bound_bytes_bhsd(q, bias), flops=fa.bound_flops_bhsd(q),
        peak_flops=BF16_FLOPS))
    timed["flash_attention"]["dist_train"] = t


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
    (out["cases"]["flash_attention_bsh_train"],
     out["flash_attention_bsh_train"],
     out["flash_attention_bsh_bwd"]) = _kernels_flash_train(torch, F, flush)
    out["cases"]["add_ln_bwd"], ln = _kernels_ln_train(torch, F, flush)
    out["add_ln_bwd"] = ln["bf16_y"]
    out["add_ln_bwd_f32"] = ln["f32"]
    out["add_ln_train"] = ln["fwd_bf16_y"]
    out["add_ln_bwd_nmt"] = ln["nmt_bf16_y"]
    out["add_ln_train_nmt"] = ln["nmt_fwd_bf16_y"]
    out["cases"]["bert_long"], out["bert_long"] = _kernels_bert_long(
        torch, F, flush)
    out["cases"]["conv_bn"], cbn = _kernels_conv_bn(torch, F, flush)
    out.update(cbn)
    out["cases"]["flash_attention_bhsd"], bhsd = _kernels_flash_bhsd(
        torch, F, flush)
    out.update(bhsd)
    emit(out)
    del flush
    torch.cuda.empty_cache()
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


# host calls that wait for the card: a decode step must make none between
# its paged-attention launches (the wrapper never reads lengths)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuMemcpyDtoH",
              "cuStreamSynchronize", "cuCtxSynchronize")


def phase_decode_sync(torch, cfg, model) -> dict:
    """One decode step (``decode_model.decode_step``: 12 layers, 8 slots
    at the kernels phase's lengths) under torch.profiler: 12 launches of
    the paged-attention kernel, and between the start of the first of its
    12 wrapper calls and the end of the last the host makes no
    synchronising CUDA call (synchronize, blocking or device-to-host
    copy).  Syncs after the step, in the same window, show that the
    profiler sees such calls."""
    from torch.profiler import record_function

    from paddle_tpu_torch.inference import decode_model as dm

    params, dev = model.params, model.device
    psz, slots, maxp, n_pages = 16, 8, 64, 513
    lens = [1, 37, 1024, 300, 513, 64, 777, 129]
    rng = np.random.default_rng(3)
    table = np.zeros((slots, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lens):
        table[i, :-(-n // psz)] = [free.pop() for _ in range(-(-n // psz))]
    pos = np.asarray(lens, np.int32) - 1
    write = np.asarray([table[i, p // psz] * psz + p % psz
                        for i, p in enumerate(pos)], np.int32)
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (cfg.n_layers, n_pages * psz, cfg.n_heads, cfg.head_dim)
    k_flat = torch.randn(shape, generator=gen, device=dev)
    v_flat = torch.randn(shape, generator=gen, device=dev)
    args = (params, k_flat, v_flat,
            torch.as_tensor(rng.integers(1, cfg.vocab, slots)
                            .astype(np.int32), device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(table, device=dev),
            torch.as_tensor(write, device=dev))
    real = dm.paged_attention

    def traced(*a, **k):
        with record_function("paged_attention_wrapper"):
            return real(*a, **k)

    dm.paged_attention = traced
    try:
        dm.decode_step(*args, page_size=psz, n_heads=cfg.n_heads)  # warm
        torch.cuda.synchronize()
        prof = _profile_warm(torch)
        try:
            n0 = real.launches
            logits, nxt, _, _ = dm.decode_step(*args, page_size=psz,
                                               n_heads=cfg.n_heads)
            launches = real.launches - n0
            nxt.cpu()   # syncs the profiler must see, after the step
            torch.cuda.synchronize()
            logits[0, 0].item()
        finally:
            prof.__exit__(None, None, None)
    finally:
        dm.paged_attention = real
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the host's side of each wrapper call (the profiler also books a copy
    # of the annotation on the device's timeline)
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "paged_attention_wrapper"
                   and e.device_type != cuda)
    if len(calls) != cfg.n_layers:
        fail(f"decode step: {len(calls)} paged-attention calls profiled, "
             f"want {cfg.n_layers}")
    lo, hi = calls[0][0], calls[-1][1]
    syncs = [(e.name, e.time_range.start) for e in events
             if e.device_type != cuda and e.name.startswith(SYNC_CALLS)]
    inside = sorted({n for n, t in syncs if lo <= t <= hi})
    if inside:
        fail(f"decode step: host syncs between the paged-attention "
             f"launches: {inside}")
    after = sorted({n for n, t in syncs if t > hi})
    if not after:
        fail("decode step: the profiler saw no sync call even for the "
             "syncs after the step; the check would be blind")
    if launches != cfg.n_layers:
        fail(f"decode step: {launches} paged-attention launches, want "
             f"{cfg.n_layers}")
    # the profiler's count may lose an event (see _one_device_kernel)
    kernels = sum(1 for e in _device_events(torch, prof)
                  if "paged_attention_kernel" in e.name)
    if not bool(torch.isfinite(logits).all()):
        fail("decode step: non-finite logits")
    rows = [r for r in _device_rows(torch, prof)
            if "spin_kernel" not in r[2]
            and r[2] != "paged_attention_wrapper"]
    out = {"phase": "decode_sync", "lengths": lens,
           "wrapper_calls": len(calls), "launches": launches,
           "device_kernels_seen": kernels,
           "window_us": hi - lo, "syncs_between_launches": inside,
           "syncs_after_step": after,
           # the step's device time: every device op of the window (the
           # .cpu() copy of 8 tokens included), and row 1's share of it
           "decode_step_device_ms": sum(r[0] for r in rows),
           "paged_attention_device_ms": sum(
               r[0] for r in rows if "paged_attention_kernel" in r[2])}
    emit(out)
    del k_flat, v_flat
    torch.cuda.empty_cache()
    return out


def phase_emitters(torch) -> dict:
    """The emitters repaired against the JAX package's (take's fill mode,
    cast's saturation, sign's NaN and -0.0, scale's integer bias, the
    narrow-int sums, the int mean; C1-C5's zero divisors, bool operands,
    matmul's alpha and bool products) on the card against the same
    emitters on the CPU, bit for bit and dtype for dtype; gather and
    lookup_table_v2 with ids past the end give NaN rows, and no device
    assert; the lookup's gradient through them is zero."""
    from paddle_tpu_torch.ops import registry as reg

    f32 = np.float32
    cases = {
        "gather_past_end": ("gather", {
            "X": np.arange(12, dtype=f32).reshape(6, 2),
            "Index": np.array([-1, 6, 2, -7], np.int32)}, {}),
        "gather_int_past_end": ("gather", {
            "X": np.arange(12, dtype=np.int32).reshape(6, 2),
            "Index": np.array([6, 0], np.int32)}, {}),
        "lookup_past_table": ("lookup_table_v2", {
            "W": np.arange(15, dtype=f32).reshape(5, 3),
            "Ids": np.array([[4, 5], [-1, 900]], np.int32)},
            {"padding_idx": -1}),
        "cast_saturates": ("cast", {"X": np.array(
            [3e9, -3e9, np.nan, 300.7, -2.5, np.inf], f32)},
            {"out_dtype": np.dtype("int32")}),
        "cast_saturates_uint8": ("cast", {"X": np.array(
            [3e9, -3e9, np.nan, 300.7, -2.5, 2.5], f32)},
            {"out_dtype": np.dtype("uint8")}),
        "sign": ("sign", {"X": np.array([np.nan, -0.0, 2.0, -3.0], f32)},
                 {}),
        "scale_int": ("scale", {"X": np.array([1, 2, 3], np.int32)},
                      {"scale": 2.5, "bias": 0.5}),
        "reduce_sum_int8": ("reduce_sum", {"X": np.ones((2, 3), np.int8)},
                            {"dim": [1]}),
        "reduce_sum_uint8": ("reduce_sum", {
            "X": np.full((2, 300), 255, np.uint8)}, {"dim": [1]}),
        "mean_int": ("mean", {"X": np.array([[1, 2], [3, 4]], np.int32)},
                     {}),
        **_emitters_c1_c5(torch),
    }
    results = {}
    for name, (op, ins, attrs) in cases.items():
        got = {}
        for dev in ("cpu", "cuda"):
            t_ins = {k: [torch.as_tensor(v, device=dev)]
                     for k, v in ins.items()}
            got[dev] = reg.get(op).emit(reg.EmitContext(device=dev), t_ins,
                                        dict(attrs))["Out"][0]
        torch.cuda.synchronize()  # a device assert would surface here
        a, b = got["cpu"], got["cuda"].cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"emitter {name}: card {b.dtype} {tuple(b.shape)} vs CPU "
                 f"{a.dtype} {tuple(a.shape)}")
        same = (torch.equal(a, b) if not a.is_floating_point() else
                bool(((a == b) | (a.isnan() & b.isnan())).all())
                and torch.equal(a.signbit(), b.signbit()))
        if not same:
            fail(f"emitter {name}: card {b.tolist()} vs CPU {a.tolist()}")
        results[name] = {"dtype": str(b.dtype), "out": b.tolist()}
    if not np.isnan(results["lookup_past_table"]["out"][0][1]).all():
        fail("lookup_table_v2: an id past the table did not give NaN")
    grads = {}
    for dev in ("cpu", "cuda"):
        w = torch.arange(15, dtype=torch.float32, device=dev).reshape(
            5, 3).requires_grad_()
        ids = torch.tensor([[4, 7], [-1, 0]], dtype=torch.int32, device=dev)
        out = reg.get("lookup_table_v2").emit(
            reg.EmitContext(device=dev), {"W": [w], "Ids": [ids]},
            {"padding_idx": -1})["Out"][0]
        out.backward(torch.ones_like(out))
        grads[dev] = w.grad.cpu()
    torch.cuda.synchronize()
    if not torch.equal(grads["cpu"], grads["cuda"]):
        fail(f"lookup_table_v2 gradient: card {grads['cuda'].tolist()} vs "
             f"CPU {grads['cpu'].tolist()}")
    results["lookup_grad_past_table"] = {"grad": grads["cuda"].tolist()}
    out = {"phase": "emitters", "cases": results,
           "training_breadth": _emitters_training_breadth(torch),
           "core_ops": _emitters_core_ops(torch),
           "losses_norms_creation": _emitters_loss_ops(torch)}
    emit(out)
    return out


def _emitters_c1_c5(torch) -> dict:
    """ROADMAP C1-C5's cases (tests/test_torch_framework.py EDGE): zero
    divisors of floats, ints and uint8, two bools, matmul's alpha in
    Out's dtype, bool and int8 products, written out explicitly so that
    the card gives the CPU's (the JAX package's) values."""
    i32 = np.array([5, -5, 0, 7], np.int32)
    by0 = np.array([0, 0, 0, 2], np.int32)
    rng = np.random.default_rng(21)
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    cases = {
        "c1_floordiv_f32_by_zero": ("elementwise_floordiv", {
            "X": np.array([5, -5, 0, np.inf, 3], np.float32),
            "Y": np.array([0, -0.0, 0, 0, 2], np.float32)}, {}),
        "c1_floordiv_bf16_by_zero": ("elementwise_floordiv", {
            "X": bf(np.array([5, -5, 0, 3], np.float32)),
            "Y": bf(np.array([0, 0, 0, 2], np.float32))}, {}),
        "c3_mod_bool": ("elementwise_mod", {
            "X": np.array([True, False, True, True]),
            "Y": np.array([True, True, False, True])}, {}),
        "c3_floordiv_bool": ("elementwise_floordiv", {
            "X": np.array([True, False, True, True]),
            "Y": np.array([True, True, False, True])}, {}),
        "c4_matmul_int_alpha": ("matmul", {
            "X": np.arange(6, dtype=np.int32).reshape(2, 3),
            "Y": np.arange(6, dtype=np.int32).reshape(3, 2) - 2},
            {"alpha": 0.5}),
        "c4_matmul_bf16_alpha": ("matmul", {
            "X": bf(rng.integers(-3, 4, (4, 8, 64)).astype(np.float32)),
            "Y": bf(rng.integers(-3, 4, (4, 64, 8)).astype(np.float32))},
            {"alpha": 0.3}),
        "c5_matmul_bool": ("matmul", {"X": np.ones((2, 3), bool),
                                      "Y": np.ones((3, 2), bool)}, {}),
        "c5_mul_bool": ("mul", {
            "X": np.array([[True, False], [False, True]]),
            "Y": np.array([[False, True, True], [True, False, True]])}, {}),
        "c5_mul_int8_wraps": ("mul", {"X": np.full((2, 64), 5, np.int8),
                                      "Y": np.full((64, 3), 3, np.int8)},
                              {}),
    }
    for t in ("int32", "int8", "uint8"):
        x = i32.astype(t) if t != "uint8" else np.array([5, 0, 255, 7],
                                                        np.uint8)
        for op in ("mod", "floordiv"):
            cases[f"c2_{op}_{t}_by_zero"] = (
                f"elementwise_{op}", {"X": x, "Y": by0.astype(t)}, {})
    for op in ("mod", "floordiv"):   # uint8's 255 is no -1
        cases[f"c2_{op}_uint8_by_255"] = (f"elementwise_{op}", {
            "X": np.array([5, 254, 255], np.uint8),
            "Y": np.array([255, 255, 255], np.uint8)}, {})
    return cases


def _emitters_training_breadth(torch) -> dict:
    """The update ops, where and the comparisons of the training-breadth
    slice on CUDA tensors against the same emitters on CPU tensors, f32,
    within 1e-6 relative (dpsgd at sigma 0: the noise is drawn from each
    device's own generator)."""
    from paddle_tpu_torch.ops import registry as reg

    rng = np.random.default_rng(5)

    def f(*shape, pos=False):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.abs(a) + 0.1 if pos else a

    p, g = f(64, 32), f(64, 32)
    lr = np.array([0.01], np.float32)
    b1p, b2p = np.array([0.81], np.float32), np.array([0.998], np.float32)
    cases = {
        "adamax": ("adamax", {"Param": p, "Grad": g, "Moment": f(64, 32),
                              "InfNorm": f(64, 32, pos=True),
                              "Beta1Pow": b1p, "LearningRate": lr}, {}),
        "adagrad": ("adagrad", {"Param": p, "Grad": g,
                                "Moment": f(64, 32, pos=True),
                                "LearningRate": lr}, {"epsilon": 1e-6}),
        "decayed_adagrad": ("decayed_adagrad", {
            "Param": p, "Grad": g, "Moment": f(64, 32, pos=True),
            "LearningRate": lr}, {"decay": 0.9}),
        "rmsprop_centered": ("rmsprop", {
            "Param": p, "Grad": g, "MeanSquare": f(64, 32, pos=True) + 2,
            "Moment": f(64, 32), "MeanGrad": f(64, 32) * 0.1,
            "LearningRate": lr}, {"momentum": 0.9, "centered": True}),
        "lamb": ("lamb", {"Param": p, "Grad": g, "Moment1": f(64, 32),
                          "Moment2": f(64, 32, pos=True), "Beta1Pow": b1p,
                          "Beta2Pow": b2p, "LearningRate": lr},
                 {"weight_decay": 0.01}),
        "lars_momentum": ("lars_momentum", {
            "Param": p, "Grad": g, "Velocity": f(64, 32),
            "LearningRate": lr}, {"mu": 0.9}),
        "ftrl": ("ftrl", {"Param": p, "Grad": g,
                          "SquaredAccumulator": f(64, 32, pos=True),
                          "LinearAccumulator": f(64, 32),
                          "LearningRate": lr}, {"l1": 0.1, "l2": 0.01}),
        "ftrl_power": ("ftrl", {"Param": p, "Grad": g,
                                "SquaredAccumulator": f(64, 32, pos=True),
                                "LinearAccumulator": f(64, 32),
                                "LearningRate": lr}, {"lr_power": -0.25}),
        "dpsgd": ("dpsgd", {"Param": p, "Grad": g, "LearningRate": lr},
                  {"sigma": 0.0, "clip": 1.0}),
        "where": ("where", {"Condition": np.array([True]), "X": p,
                            "Y": g}, {}),
        "where_mask": ("where", {"Condition": f(64, 32) > 0, "X": p,
                                 "Y": g}, {}),
        **{op: (op, {"X": p, "Y": g}, {}) for op in (
            "equal", "not_equal", "less_than", "less_equal",
            "greater_than", "greater_equal", "logical_and", "logical_or",
            "logical_xor", "elementwise_min", "elementwise_max",
            "elementwise_mod", "elementwise_floordiv")},
    }
    out = {}
    for name, (op, ins, attrs) in cases.items():
        got = {}
        for dev in ("cpu", "cuda"):
            t_ins = {k: [torch.as_tensor(v, device=dev)]
                     for k, v in ins.items()}
            got[dev] = reg.get(op).emit(reg.EmitContext(seed=3, device=dev),
                                        t_ins, dict(attrs))
        torch.cuda.synchronize()
        worst = 0.0
        for slot, vals in got["cpu"].items():
            a, b = vals[0], got["cuda"][slot][0].cpu()
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"emitter {name} {slot}: card {b.dtype} "
                     f"{tuple(b.shape)} vs CPU {a.dtype} {tuple(a.shape)}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    fail(f"emitter {name} {slot}: card and CPU differ")
                continue
            # relative to the tensor's largest element
            rel = float((a.double() - b.double()).abs().max()
                        / a.double().abs().max().clamp_min(1e-30))
            if rel > 1e-6:
                fail(f"emitter {name} {slot}: card vs CPU {rel} relative")
            worst = max(worst, rel)
        out[name] = {"max_rel_err": worst}
    return out


# the core op types of ops/manipulation.py and ops/math_ops.py that came
# with the text-CNN slice, card against CPU.  Data movement (every
# manipulation op, and cumsum, scatter's adds and scatter_nd_add, whose
# adds run in a fixed order on both devices) is held bit for bit, dtype
# for dtype; the arithmetic within these limits of max(1, |CPU value|):
CORE_LIMIT_F32 = 2e-6     # f32 unary math, norms, softmax: an ulp or two
CORE_LIMIT_MM = 1e-5      # f32 products (TF32 off) and linear algebra
CORE_LIMIT_BF16 = 2.0 ** -7   # one bf16 rounding step of the result


def _core_inputs(torch):
    """f32 with ties, NaN, both infinities and both zeros; the same in
    bf16; int32 with its extremes; bool; a 5 x 3 table and its ids."""
    nan, inf = math.nan, math.inf
    f = np.array([[3, 1, 3, 2, 3, -0.0, 0.0, nan],
                  [nan, inf, -inf, nan, 0.0, -0.0, 1.0, -2.5]], np.float32)
    rng = np.random.default_rng(22)
    return {
        "f32": f, "bf16": torch.as_tensor(f).to(torch.bfloat16),
        "int": np.array([[3, -7, 3, 0, 2 ** 31 - 1, -2 ** 31, 5, 3],
                         [-1, 2, -2, 5, 0, 0, 7, -7]], np.int32),
        "bool": rng.random((2, 8)) > 0.5,
        "r3": rng.standard_normal((2, 3, 8)).astype(np.float32),
        "table": rng.standard_normal((5, 3)).astype(np.float32),
        "ids": np.array([0, 3, 0, -1, 9, -6, 3], np.int32),
        "upd": rng.standard_normal((7, 3)).astype(np.float32),
        "nd": np.array([[0, 1], [4, 2], [-1, 0], [0, -1], [5, 0], [2, 9]],
                       np.int32),
        "long": (rng.standard_normal((4, 299)) * 10).astype(np.float32),
        "spd": (lambda a: a @ a.transpose(0, 2, 1) + 4 * np.eye(
            4, dtype=np.float32))(rng.standard_normal((3, 4, 4)).astype(
                np.float32)),
    }


def _core_cases(torch, x) -> dict:
    """Every op type of the slice over the inputs ``x`` (``_core_inputs``):
    name -> (op, ins, attrs, limit), limit None for bit for bit."""
    kinds = ("f32", "bf16", "int", "bool")
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    c = {}

    def each(op, attrs, slot="X", ks=kinds, wrap=None, tag=""):
        for k in ks:
            v = x[k] if wrap is None else wrap(x[k])
            c[f"{op}{tag}_{k}"] = (op, {slot: v}, attrs, None)

    two = lambda v: [v, v]  # noqa: E731
    each("transpose", {"axis": [1, 0]})
    each("concat", {"axis": 1}, wrap=two)
    c["concat_int_bool"] = ("concat", {"X": [x["int"], x["bool"]]},
                            {"axis": 0}, None)
    each("split", {"axis": 1, "num": 2})
    c["split_sections"] = ("split", {"X": x["f32"]},
                           {"axis": 1, "sections": [3, 5]}, None)
    each("strided_slice", {"axes": [1], "starts": [7], "ends": [0],
                           "strides": [-2]}, slot="Input")
    c["strided_slice_pos"] = ("strided_slice", {"Input": x["r3"]}, {
        "axes": [1, 2], "starts": [0, 1], "ends": [3, 100],
        "strides": [2, 3]}, None)
    each("stack", {"axis": 1}, wrap=two)
    each("unstack", {"axis": 0})
    each("unbind", {"axis": 1})
    for op in ("squeeze", "squeeze2"):
        each(op, {"axes": [1]}, wrap=lambda v: v[:, None])
    each("flatten", {"axis": 1})
    each("flatten2", {"axis": 2}, wrap=lambda v: v[None])
    each("flatten_contiguous_range", {"start_axis": 0, "stop_axis": 1},
         wrap=lambda v: v[:, None])
    each("expand", {"expand_times": [2, 1]})
    each("expand_v2", {"shape": [3, -1, -1]})
    each("tile", {"repeat_times": [2, 2]})
    for k, t in (("f32", x["table"]), ("bf16", bf(x["table"])),
                 ("int", (x["table"] * 9).astype(np.int32)),
                 ("bool", x["table"] > 0)):
        c[f"gather_nd_{k}"] = ("gather_nd", {"X": t, "Index": x["nd"]}, {},
                               None)
        c[f"scatter_set_{k}"] = ("scatter", {
            "X": t, "Ids": x["ids"], "Updates": (
                x["upd"] > 0 if k == "bool" else x["upd"])},
            {"overwrite": True}, None)
        if k != "bool":
            u = x["upd"] * (100 if k == "bf16" else 1)
            c[f"scatter_add_{k}"] = ("scatter", {
                "X": t, "Ids": x["ids"], "Updates": u},
                {"overwrite": False}, None)
            c[f"scatter_nd_add_{k}"] = ("scatter_nd_add", {
                "X": t, "Index": np.repeat(x["nd"][:3], 4, 0),
                "Updates": x["upd"][:, 0].repeat(2)[:12] * 3}, {}, None)
    each("pad", {"paddings": [1, 0, 2, 3], "pad_value": -0.5})
    r4 = x["r3"][None]
    for m in ("constant", "reflect", "edge"):
        for fmt in ("NCHW", "NHWC"):
            c[f"pad2d_{m}_{fmt}"] = ("pad2d", {"X": r4}, {
                "paddings": [1, 2, 3, 0], "mode": m, "pad_value": 1.5,
                "data_format": fmt}, None)
    c["pad2d_reflect_bf16"] = ("pad2d", {"X": bf(r4)}, {
        "paddings": [2, 1, 9, 9], "mode": "reflect"}, None)
    c["pad2d_edge_int"] = ("pad2d", {"X": x["int"][None, None]}, {
        "paddings": [1, 1, 2, 2], "mode": "edge"}, None)
    for m in ("constant", "reflect", "replicate", "circular"):
        c[f"pad3d_{m}"] = ("pad3d", {"X": r4[None]}, {
            "paddings": [1, 2, 0, 1, 1, 0], "mode": m, "value": -2.0},
            None)
    c["pad3d_circular_bf16_ndhwc"] = ("pad3d", {"X": bf(r4[None])}, {
        "paddings": [4, 5, 0, 1, 0, 0], "mode": "circular",
        "data_format": "NDHWC"}, None)
    each("arg_max", {"axis": 1})
    each("arg_min", {"axis": -1, "keepdims": True})
    each("argsort", {"axis": 1})
    each("argsort", {"axis": 1, "descending": True},
         ks=("f32", "bf16", "int"), tag="_desc")
    each("top_k", {"k": 5})
    c["top_k_v2_smallest"] = ("top_k_v2", {"X": x["f32"]},
                              {"k": 6, "largest": False}, None)
    c["top_k_v2_axis0_int"] = ("top_k_v2", {"X": x["int"]},
                               {"k": 1, "axis": 0}, None)
    c["top_k_v2_bf16"] = ("top_k_v2", {"X": x["bf16"]}, {"k": 3}, None)
    for k, v in (("f32", x["long"]), ("bf16", bf(x["long"]))):
        c[f"cumsum_{k}"] = ("cumsum", {"X": v}, {"axis": 1}, None)
        c[f"cumsum_rev_excl_{k}"] = ("cumsum", {"X": v}, {
            "axis": 1, "reverse": True, "exclusive": True}, None)
    c["cumsum_long_flat"] = ("cumsum", {"X": x["long"]}, {"flatten": True},
                             None)
    c["cumsum_special"] = ("cumsum", {"X": x["f32"]}, {"axis": 1}, None)
    each("cumsum", {"axis": 0}, ks=("int", "bool"))
    each("flip", {"axis": [0, 1]})
    each("roll", {"shifts": [3], "axis": [1]})
    each("roll", {"shifts": [-5], "axis": []}, ks=("f32",), tag="_flat")
    each("tril_triu", {"diagonal": 1, "lower": True})
    c["tril_triu_upper"] = ("tril_triu", {"X": x["r3"]},
                            {"diagonal": -1, "lower": False}, None)
    each("diag_v2", {"offset": 1})
    c["diag_v2_vec"] = ("diag_v2", {"X": x["int"][0]},
                        {"offset": -2, "padding_value": 9.5}, None)
    for k in kinds:
        c[f"index_select_{k}"] = ("index_select", {
            "X": x[k], "Index": np.array([7, -1, 0, 9], np.int32)},
            {"dim": 1}, None)
        c[f"take_along_axis_{k}"] = ("take_along_axis", {
            "Input": x[k], "Index": np.array([[0, 7, -1], [9, 2, 2]],
                                             np.int32)}, {"Axis": 1}, None)
    c["meshgrid"] = ("meshgrid", {"X": [x["f32"][0], x["int"][1],
                                        x["bool"][0]]}, {}, None)
    c["shard_index"] = ("shard_index", {"X": x["int"]}, {
        "index_num": 20, "nshards": 3, "shard_id": 1}, None)

    # math_ops.py
    act = np.concatenate([x["f32"].ravel(), np.array(
        [-3.5, -3.0, -2.5, -0.5, 0.5, 2.5, 3.0, 6.0, 7.0], np.float32)])
    acts = {"sigmoid": {}, "tan": {}, "acos": {}, "asin": {}, "atan": {},
            "sinh": {}, "cosh": {}, "log2": {}, "log10": {}, "log1p": {},
            "softplus": {}, "softsign": {}, "silu": {}, "swish": {"beta": 1.5},
            "logsigmoid": {}, "relu6": {}, "leaky_relu": {}, "elu": {},
            "hard_sigmoid": {}, "hard_swish": {}, "thresholded_relu": {},
            "hard_shrink": {}, "soft_shrink": {}, "erf": {}, "mish": {}}
    for op, a in acts.items():
        c[f"{op}_f32"] = (op, {"X": act}, a, CORE_LIMIT_F32)
        c[f"{op}_bf16"] = (op, {"X": bf(act)}, a, CORE_LIMIT_BF16)
        if op not in ("sigmoid", "silu", "erf"):
            c[f"{op}_int"] = (op, {"X": x["int"] % 97}, a, CORE_LIMIT_F32)
        if op not in ("sigmoid", "silu", "erf", "logsigmoid", "soft_shrink"):
            c[f"{op}_bool"] = (op, {"X": x["bool"]}, a, CORE_LIMIT_F32)
    r = x["r3"]
    rng = np.random.default_rng(23)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c.update({
        "matmul_v2": ("matmul_v2", {"X": g(2, 5, 64), "Y": g(64, 3)},
                      {"trans_x": False}, CORE_LIMIT_MM),
        "matmul_v2_trans": ("matmul_v2", {"X": g(2, 64, 5), "Y": g(2, 3, 64)},
                            {"trans_x": True, "trans_y": True},
                            CORE_LIMIT_MM),
        "matmul_v2_int": ("matmul_v2", {"X": x["int"],
                                        "Y": x["int"].T.copy()}, {}, None),
        "matmul_v2_bool": ("matmul_v2", {"X": x["bool"],
                                         "Y": x["bool"].T.copy()}, {}, None),
        "matmul_v2_bf16_f32": ("matmul_v2", {"X": bf(g(2, 16)),
                                             "Y": g(16, 4)}, {},
                               CORE_LIMIT_MM),
        "dot": ("dot", {"X": g(3, 64), "Y": g(3, 64)}, {}, CORE_LIMIT_MM),
        "dot_int8": ("dot", {"X": np.array([[1, 2]], np.int8),
                             "Y": np.array([[100, 100]], np.int8)}, {}, None),
        "dot_bool": ("dot", {"X": x["bool"], "Y": x["bool"][::-1].copy()},
                     {}, None),
        "addmm": ("addmm", {"Input": g(3, 4), "X": g(3, 64), "Y": g(64, 4)},
                  {"Alpha": 0.5, "Beta": 2.0}, CORE_LIMIT_MM),
        "kron": ("kron", {"X": g(2, 3), "Y": g(3, 2)}, {}, None),
        "prelu_all": ("prelu", {"X": x["f32"], "Alpha": np.array(
            [0.25], np.float32)}, {"mode": "all"}, None),
        "prelu_channel": ("prelu", {"X": r[None], "Alpha": g(2)},
                          {"mode": "channel"}, None),
        "prelu_element": ("prelu", {"X": r, "Alpha": g(3, 8)},
                          {"mode": "element"}, None),
        "log_softmax": ("log_softmax", {"X": r}, {"axis": -1},
                        CORE_LIMIT_F32),
        "log_softmax_special": ("log_softmax", {"X": x["f32"]}, {"axis": 1},
                                CORE_LIMIT_F32),
        "log_softmax_int": ("log_softmax", {"X": x["int"] % 13},
                            {"axis": 1}, CORE_LIMIT_F32),
        "log_softmax_bf16": ("log_softmax", {"X": bf(r)}, {"axis": 1},
                             CORE_LIMIT_BF16),
        "maxout": ("maxout", {"X": np.concatenate([x["f32"], x["f32"]])[
            None]}, {"groups": 2}, None),
        "maxout_int": ("maxout", {"X": x["int"].reshape(1, 16)},
                       {"groups": 4}, None),
        "isfinite": ("isfinite", {"X": [r, x["f32"]]}, {}, None),
        "isfinite_true": ("isfinite", {"X": [r, x["int"]]}, {}, None),
        "isinf": ("isinf", {"X": x["bf16"]}, {}, None),
        "isnan": ("isnan", {"X": x["f32"]}, {}, None),
        "isnan_int": ("isnan", {"X": x["int"]}, {}, None),
        "isfinite_v2": ("isfinite_v2", {"X": x["f32"]}, {}, None),
        "isinf_v2": ("isinf_v2", {"X": x["bf16"]}, {}, None),
        "isnan_v2": ("isnan_v2", {"X": x["bool"]}, {}, None),
        "p_norm_int": ("p_norm", {"X": x["int"] % 11},
                       {"porder": 2.0, "axis": 1}, CORE_LIMIT_F32),
        "p_norm_bf16": ("p_norm", {"X": bf(r)}, {"porder": 2.0, "axis": 2},
                        CORE_LIMIT_BF16),
        "trace": ("trace", {"Input": r}, {"offset": 1, "axis1": 1,
                                          "axis2": 2}, CORE_LIMIT_F32),
        "trace_int": ("trace", {"Input": x["int"]}, {}, None),
        "trace_bool": ("trace", {"Input": x["bool"]}, {"offset": 1}, None),
        "cholesky": ("cholesky", {"X": x["spd"]}, {}, CORE_LIMIT_MM),
        "cholesky_upper": ("cholesky", {"X": x["spd"]}, {"upper": True},
                           CORE_LIMIT_MM),
        "cholesky_not_pd": ("cholesky", {"X": np.array(
            [[1.0, 2.0], [2.0, 1.0]], np.float32)}, {}, CORE_LIMIT_MM),
        "inverse": ("inverse", {"Input": x["spd"]}, {}, CORE_LIMIT_MM),
        "matrix_power": ("matrix_power", {"X": x["spd"] / 6}, {"n": 5},
                         CORE_LIMIT_MM),
        "matrix_power_neg": ("matrix_power", {"X": x["spd"]}, {"n": -2},
                             CORE_LIMIT_MM),
        "matrix_power_int": ("matrix_power", {"X": np.array(
            [[1, 1], [1, 0]], np.int32)}, {"n": 7}, None),
        "logsumexp": ("logsumexp", {"X": r}, {"axis": [1]}, CORE_LIMIT_F32),
        "logsumexp_special": ("logsumexp", {"X": x["f32"]}, {"axis": [1]},
                              CORE_LIMIT_F32),
        "logsumexp_all_bf16": ("logsumexp", {"X": bf(r)}, {"axis": []},
                               CORE_LIMIT_BF16),
        "cos_sim": ("cos_sim", {"X": np.concatenate(
            [np.zeros((1, 8), np.float32), r[0]]), "Y": r[1, :1]}, {},
            CORE_LIMIT_MM),
    })
    for p in (2.0, 1.0, 0.0, 3.0, 0.5, math.inf, -math.inf):
        c[f"p_norm_{p}"] = ("p_norm", {"X": np.concatenate(
            [r[0], np.zeros((1, 8), np.float32)])},
            {"porder": p, "axis": 1}, CORE_LIMIT_F32)
    return c


def _same_on_both(torch, a, b, limit) -> float:
    """0.0 if ``b`` (the card's) is ``a`` (the CPU's) bit for bit (limit
    None) or the largest |b - a| / max(1, |a|) within ``limit``, NaN and
    infinities in the same places; raises ValueError otherwise."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise ValueError(f"card {b.dtype} {tuple(b.shape)} vs CPU "
                         f"{a.dtype} {tuple(a.shape)}")
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise ValueError("card and CPU differ")
        return 0.0
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        raise ValueError("NaN in other places")
    if limit is None:
        ity = {2: torch.int16, 4: torch.int32}[a.element_size()]
        if not torch.equal(a.view(ity)[~nan], b.view(ity)[~nan]):
            raise ValueError("not bit for bit")
        return 0.0
    a64, b64 = a.double()[~nan], b.double()[~nan]
    inf = a64.isinf()
    if not torch.equal(inf, b64.isinf()) or not torch.equal(
            a64[inf], b64[inf]):
        raise ValueError("infinities in other places")
    if not inf.all():
        fin = ~inf
        err = float(((a64[fin] - b64[fin]).abs()
                     / a64[fin].abs().clamp_min(1.0)).max())
    else:
        err = 0.0
    if err > limit:
        raise ValueError(f"{err} > {limit}")
    return err


def _emit_on(torch, op, ins, attrs, dev):
    """The port's ``op`` emitter on ``dev``, each input (numpy or a CPU
    tensor, or a list of them) copied there."""
    from paddle_tpu_torch.ops import registry as reg

    t_ins = {k: [torch.as_tensor(a, device=dev) for a in
                 (v if isinstance(v, list) else [v])]
             for k, v in ins.items()}
    return reg.get(op).emit(reg.EmitContext(device=dev), t_ins, dict(attrs))


def _card_vs_cpu(torch, what, cases) -> tuple:
    """Each case (name -> (op, ins, attrs, limit)) on the card against the
    CPU, every output slot (``_same_on_both``: limit None bit for bit);
    returns (the worst error by op, the bit-for-bit case count, the op
    types run)."""
    worst, n_exact = {}, 0
    for name, (op, ins, attrs, limit) in cases.items():
        got = {dev: _emit_on(torch, op, ins, attrs, dev)
               for dev in ("cpu", "cuda")}
        torch.cuda.synchronize()   # a device assert would surface here
        if sorted(got["cpu"]) != sorted(got["cuda"]):
            fail(f"{what} {name}: slots {sorted(got['cuda'])} vs "
                 f"{sorted(got['cpu'])}")
        err = 0.0
        for slot, vals in got["cpu"].items():
            for i, a in enumerate(vals):
                try:
                    err = max(err, _same_on_both(
                        torch, a, got["cuda"][slot][i].cpu(), limit))
                except ValueError as e:
                    fail(f"{what} {name} {slot}[{i}] card vs CPU: {e}")
        if limit is None:
            n_exact += 1
        else:
            worst[op] = max(worst.get(op, 0.0), err)
    return worst, n_exact, {c[0] for c in cases.values()}


def _emitters_core_ops(torch) -> dict:
    """Every op type of ops/manipulation.py and ops/math_ops.py that the
    text-CNN slice ported (``_core_cases``), on the card against the same
    emitter on the CPU; the three explicit grad ops (argsort_grad,
    top_k_grad, top_k_v2_grad) from the CPU forward's Indices, bit for
    bit."""
    from paddle_tpu_torch.ops import registry as reg

    x = _core_inputs(torch)
    cases = _core_cases(torch, x)
    for op, fwd in (("argsort", {"axis": 1, "descending": True}),
                    ("top_k", {"k": 5}),
                    ("top_k_v2", {"k": 3, "axis": 0, "largest": False})):
        src = x["f32"] if op != "top_k_v2" else x["r3"][0]
        out = _emit_on(torch, op, {"X": src}, fwd, "cpu")
        cases[f"{op}_grad"] = (op + "_grad", {
            "X": src, "Indices": out["Indices"][0],
            "Out@GRAD": torch.randn(out["Out"][0].shape,
                                    generator=torch.Generator().manual_seed(
                                        7))}, fwd, None)
    worst, n_exact, done = _card_vs_cpu(torch, "emitter", cases)
    from paddle_tpu_torch.ops import manipulation, math_ops

    want = {o for o in reg.registered_ops()
            if reg.get(o).emit.__module__ in (manipulation.__name__,
                                              math_ops.__name__)}
    missing = sorted(_CORE_OP_TYPES - done)
    if missing or not _CORE_OP_TYPES <= want:
        fail(f"emitters: core op types not held on the card: {missing}")
    return {"cases": len(cases), "bit_for_bit": n_exact,
            "op_types": len(done & _CORE_OP_TYPES),
            "limits": {"f32": CORE_LIMIT_F32, "f32_products_linalg":
                       CORE_LIMIT_MM, "bf16": CORE_LIMIT_BF16},
            "worst_rel_err_by_op": worst}


# the 83 op types the slice ported (38 of ops/manipulation.py, 45 of
# ops/math_ops.py)
_CORE_OP_TYPES = frozenset("""
arg_max arg_min argsort argsort_grad concat cumsum diag_v2 expand expand_v2
flatten flatten2 flatten_contiguous_range flip gather_nd index_select
meshgrid pad pad2d pad3d roll scatter scatter_nd_add shard_index split
squeeze squeeze2 stack strided_slice take_along_axis tile top_k top_k_grad
top_k_v2 top_k_v2_grad transpose tril_triu unbind unstack
acos addmm asin atan cholesky cos_sim cosh dot elu erf hard_shrink
hard_sigmoid hard_swish inverse isfinite isfinite_v2 isinf isinf_v2 isnan
isnan_v2 kron leaky_relu log10 log1p log2 log_softmax logsigmoid logsumexp
matmul_v2 matrix_power maxout mish p_norm prelu relu6 sigmoid silu sinh
soft_shrink softplus softsign swish tan thresholded_relu trace
""".split())


# the 33 op types of ops/nn_ops.py, ops/reduce_ops.py and ops/creation.py
# that the losses-and-norms slice ported, card against CPU: one_hot,
# shape, eye, the fills, range, linspace, accuracy, auc (its counts and
# its value), embedding_with_scaled_gradient, reduce_min / all / any and
# the integer results bit for bit; the arithmetic within these limits of
# max(1, |CPU value|) (the core ops' limits otherwise):
LOSS_OPS_LIMIT_CONV = 1e-5     # f32 convolutions (cuDNN, TF32 off)
# group_norm / instance_norm at mean 100, std 3: the mean of 48 values
# near 100 summed in another order moves by an ulp or two of 100
# (7.6e-6 each), the normalized output by that over the std
LOSS_OPS_LIMIT_NORM100 = 1e-5
_LOSS_OP_TYPES = frozenset("""
depthwise_conv2d conv2d_transpose conv3d group_norm instance_norm norm
one_hot_v2 one_hot embedding_with_scaled_gradient cross_entropy
cross_entropy2 sigmoid_cross_entropy_with_logits bce_loss smooth_l1_loss
huber_loss log_loss kldiv_loss label_smooth mse_loss margin_rank_loss
accuracy auc reduce_min reduce_prod reduce_all reduce_any frobenius_norm
fill_constant_batch_size_like shape range fill_any_like eye linspace
""".split())


def _loss_ops_cases(torch, x) -> dict:
    """Every op type of ``_LOSS_OP_TYPES`` and both branches that no
    longer raise (adaptive pool2d with bins that do not divide: 7 -> 3 and
    5 -> 3 with tied maxima) over ``_core_inputs``'s f32 (NaN, +-inf,
    -0.0), bf16, int and bool, with out-of-range ids, the ignored label
    -100, a label past the classes, NaN and huge auc scores: name -> (op,
    ins, attrs, limit), limit None for bit for bit."""
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    rng = np.random.default_rng(23)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    e = np.exp(g(5, 6))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    probs[4] = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    hard = np.array([[2], [-100], [-1], [9], [0]], np.int64)
    ids = np.array([[0, 3, -1], [7, 2, 9]], np.int64)
    f32, lim, mm, b16 = x["f32"], CORE_LIMIT_F32, LOSS_OPS_LIMIT_CONV, \
        CORE_LIMIT_BF16
    m100 = 100.0 + 3.0 * g(2, 4, 4, 3, 4)
    scores = np.array([[0.2, 0.9], [0.5, np.nan], [0.1, 1e10],
                       [0.3, -np.inf], [0.0, 0.55], [0.7, 0.3],
                       [0.4, np.inf], [0.9, -1e10]], np.float32)
    stats = np.arange(11, dtype=np.float32)
    ztgt = np.array([[0.0, 0.3, 0.7, -0.1], [0.5, 0.0, 0.25, 0.25]],
                    np.float32)
    c = {
        "depthwise_conv2d": ("depthwise_conv2d", {
            "Input": g(2, 4, 7, 7), "Filter": g(4, 1, 3, 3)},
            {"strides": [2, 1], "paddings": [1, 0, 2, 1]}, mm),
        "depthwise_conv2d_nhwc": ("depthwise_conv2d", {
            "Input": g(2, 7, 7, 4), "Filter": g(8, 1, 3, 3)},
            {"paddings": [1, 1], "data_format": "NHWC"}, mm),
        "conv2d_transpose_output_padding": ("conv2d_transpose", {
            "Input": g(2, 4, 7, 7), "Filter": g(4, 3, 3, 3)},
            {"strides": [2, 2], "paddings": [1, 1],
             "output_padding": [1, 1]}, mm),
        "conv2d_transpose_groups_dil": ("conv2d_transpose", {
            "Input": g(2, 4, 7, 7), "Filter": g(4, 3, 3, 2)},
            {"strides": [2, 1], "paddings": [1, 0, 2, 1], "groups": 2,
             "dilations": [2, 1]}, mm),
        "conv2d_transpose_bf16": ("conv2d_transpose", {
            "Input": bf(g(2, 4, 7, 7)), "Filter": bf(g(4, 3, 3, 3))},
            {"strides": [2, 2], "paddings": [1, 1]}, b16),
        "conv3d": ("conv3d", {"Input": g(2, 3, 5, 6, 5),
                              "Filter": g(4, 3, 3, 3, 2)},
                   {"paddings": [1, 1, 0], "strides": [1, 2, 1]}, mm),
        "group_norm": ("group_norm", {"X": g(2, 6, 3, 4), "Scale": g(6),
                                      "Bias": g(6)}, {"groups": 3}, lim),
        "group_norm_mean100": ("group_norm", {"X": m100}, {"groups": 2},
                               LOSS_OPS_LIMIT_NORM100),
        "group_norm_bf16": ("group_norm", {"X": bf(g(2, 4, 3, 3))},
                            {"groups": 4}, b16),
        "instance_norm": ("instance_norm", {"X": g(2, 3, 4, 5),
                                            "Scale": g(3), "Bias": g(3)},
                          {}, lim),
        "instance_norm_mean100": ("instance_norm", {"X": m100}, {},
                                  LOSS_OPS_LIMIT_NORM100),
        "norm": ("norm", {"X": np.concatenate([np.zeros((1, 4), np.float32),
                                               g(2, 4)])}, {"axis": -1}, lim),
        "embedding_past_table": ("embedding_with_scaled_gradient", {
            "W": g(7, 3), "Ids": ids}, {"padding_idx": 3}, None),
        "one_hot_v2": ("one_hot_v2", {"X": ids}, {"depth": 7}, None),
        "one_hot_int32": ("one_hot", {"X": ids[..., None].astype(np.int32)},
                          {"depth": 5}, None),
        "one_hot_float_ids": ("one_hot_v2", {"X": np.array(
            [1.0, 2.5, np.nan, -0.0, 4.0], np.float32)}, {"depth": 5}, None),
        "cross_entropy_ignored": ("cross_entropy", {"X": probs,
                                                    "Label": hard}, {}, lim),
        "cross_entropy_soft": ("cross_entropy", {
            "X": probs, "Label": probs[::-1].copy()}, {"soft_label": True},
            lim),
        "cross_entropy_bf16": ("cross_entropy", {
            "X": bf(probs), "Label": hard}, {}, b16),
        "cross_entropy2": ("cross_entropy2", {"X": probs, "Label": hard},
                           {}, lim),
        "sigmoid_ce": ("sigmoid_cross_entropy_with_logits", {
            "X": f32, "Label": np.array([[1, 0, -100, 0.5, 1, 0, -100, 1],
                                         [0, 1, 1, 0, 0.25, 1, 0, 1]],
                                        np.float32)}, {}, lim),
        "sigmoid_ce_normalize": ("sigmoid_cross_entropy_with_logits", {
            "X": g(2, 8), "Label": np.where(g(2, 8) > 0.5, -1.0, 1.0).astype(
                np.float32)}, {"ignore_index": -1, "normalize": True}, lim),
        "bce_loss": ("bce_loss", {"X": np.array([[0.0, 1.0, 0.3, 0.999]],
                                                np.float32),
                                  "Label": np.array([[1.0, 0.0, 0.2, 1.0]],
                                                    np.float32)}, {}, lim),
        "smooth_l1_loss": ("smooth_l1_loss", {
            "X": g(3, 2, 2), "Y": g(3, 2, 2), "InsideWeight": g(3, 2, 2),
            "OutsideWeight": g(3, 2, 2)}, {"sigma": 2.0}, lim),
        "huber_loss": ("huber_loss", {"X": f32, "Y": g(2, 8)},
                       {"delta": 0.8}, lim),
        "log_loss": ("log_loss", {
            "Predicted": np.array([[0.0], [0.3], [0.9], [1.0]], np.float32),
            "Labels": np.array([[0.0], [1.0], [0.5], [1.0]], np.float32)},
            {"epsilon": 1e-4}, lim),
        **{f"kldiv_loss_{r}": ("kldiv_loss", {"X": g(2, 4), "Target": ztgt},
                               {"reduction": r}, lim)
           for r in ("mean", "sum", "batchmean", "none")},
        "label_smooth": ("label_smooth", {"X": np.eye(6, dtype=np.float32)[
            [0, 3, 5]]}, {"epsilon": 0.1}, lim),
        "label_smooth_prior_bf16": ("label_smooth", {
            "X": bf(np.eye(4)[[1, 2]]), "PriorDist": np.array(
                [[0.1, 0.2, 0.3, 0.4]], np.float32)}, {"epsilon": 0.25}, lim),
        "mse_loss": ("mse_loss", {"X": g(3, 4), "Y": g(3, 4)}, {}, lim),
        "margin_rank_loss": ("margin_rank_loss", {
            "X1": np.array([[1.0], [0.5], [2.0], [0.0]], np.float32),
            "X2": np.array([[0.5], [0.5], [1.0], [0.1]], np.float32),
            "Label": np.array([[1.0], [-1.0], [-1.0], [1.0]], np.float32)},
            {"margin": 0.1}, lim),
        "accuracy": ("accuracy", {
            "Out": g(5, 2), "Indices": np.array(
                [[1, 0], [2, 3], [0, 4], [4, 1], [3, 3]], np.int32),
            "Label": np.array([[0], [1], [4], [4], [2]], np.int64)}, {},
            None),
        **{f"auc_{cv}": ("auc", {"Predict": scores, "Label": np.array(
            [[1], [0], [1], [0], [1], [1], [0], [0]], np.int64),
            "StatPos": stats, "StatNeg": stats[::-1].copy()},
            {"num_thresholds": 10, "curve": cv}, None) for cv in ("ROC", "PR")},
        "reduce_prod": ("reduce_prod", {"X": x["r3"]}, {"dim": [0, 2]}, lim),
        "reduce_prod_special": ("reduce_prod", {"X": f32}, {"dim": [1]}, lim),
        "reduce_prod_int": ("reduce_prod", {"X": x["int"] % 5},
                            {"dim": [1]}, None),
        "frobenius_norm": ("frobenius_norm", {"X": x["r3"]},
                           {"dim": [1, 2]}, lim),
        "frobenius_norm_special": ("frobenius_norm", {"X": f32},
                                   {"reduce_all": True}, lim),
        "fcbsl": ("fill_constant_batch_size_like", {"Input": g(3, 5)}, {
            "shape": [2, 1, 7], "value": -3.7, "dtype": "int64",
            "input_dim_idx": 1, "output_dim_idx": 2}, None),
        "fcbsl_bf16": ("fill_constant_batch_size_like", {"Input": g(3, 5)},
                       {"shape": [-1, 2], "value": 0.1,
                        "dtype": "bfloat16"}, None),
        "shape": ("shape", {"Input": x["r3"]}, {}, None),
        "fill_any_like": ("fill_any_like", {"X": f32}, {"value": 2.5}, None),
        "fill_any_like_int_saturates": ("fill_any_like", {"X": f32}, {
            "value": 1e10, "dtype": "int32"}, None),
        "eye": ("eye", {}, {"num_rows": 3, "num_columns": 5}, None),
        "eye_bf16": ("eye", {}, {"num_rows": 4, "dtype": "bfloat16"}, None),
        "range_f32": ("range", {}, {"start": 0.0, "end": 1.0, "step": 0.1,
                                    "dtype": "float32"}, None),
        "range_int64": ("range", {}, {"start": -3.0, "end": 10.0,
                                      "step": 3.0, "dtype": "int64"}, None),
        "range_bf16": ("range", {}, {"start": 0.0, "end": 3.0, "step": 0.1,
                                     "dtype": "bfloat16"}, None),
        "linspace_f32": ("linspace", {}, {"start": -3.3, "stop": 7.1,
                                          "num": 1001, "dtype": "float32"},
                         None),
        "linspace_int64": ("linspace", {}, {"start": -100.0, "stop": 100.0,
                                            "num": 333, "dtype": "int64"},
                           None),
        "linspace_bf16": ("linspace", {}, {"start": 0.001, "stop": 5.5,
                                           "num": 77, "dtype": "bfloat16"},
                          None),
    }
    for k in ("f32", "bf16", "int", "bool"):
        c[f"reduce_min_{k}"] = ("reduce_min", {"X": x[k]}, {"dim": [1]},
                                None)
        for op in ("reduce_all", "reduce_any"):
            c[f"{op}_{k}"] = (op, {"X": x[k]}, {"dim": [1]}, None)
    c["reduce_min_all_keep"] = ("reduce_min", {"X": f32}, {
        "reduce_all": True, "keep_dim": True}, None)
    for t in ("avg", "max"):
        for h, xx in ((7, g(2, 3, 7, 7)), (5, np.zeros((1, 2, 5, 5),
                                                        np.float32))):
            c[f"adaptive_{t}_{h}to3"] = ("pool2d", {"X": xx}, {
                "pooling_type": t, "ksize": [3, 3], "adaptive": True},
                None if t == "max" else lim)
    return c


def _loss_ops_grads(torch, c) -> dict:
    """The generic grad ops of the cases where JAX's derivative is not
    torch's: the ignored and out-of-range labels (no gradient), kldiv
    where the target is 0 (-0.0 to X, NaN to Target), the adaptive max
    pool's shared ties, sigmoid_ce at 0 and +-inf: the forward's inputs
    and a cotangent from a seed, name -> (op, ins, attrs, limit)."""
    out = {}
    for name, slot in (("cross_entropy_ignored", "Y"),
                       ("kldiv_loss_sum", "Loss"),
                       ("adaptive_max_5to3", "Out"),
                       ("adaptive_avg_7to3", "Out"), ("sigmoid_ce", "Out"),
                       ("group_norm", "Y")):
        op, ins, attrs, _ = c[name]
        shape = _emit_on(torch, op, ins, attrs, "cpu")[slot][0].shape
        cot = torch.randn(shape, generator=torch.Generator().manual_seed(5))
        out[f"{name}_grad"] = (op + "_grad", dict(ins, **{
            slot + "@GRAD": cot}), dict(attrs, __fwd_in_slots__=sorted(ins)),
            CORE_LIMIT_F32)
    return out


def _im2col_on_card(torch) -> dict:
    """conv2d under FLAGS_conv_dw_im2col (NHWC, 3 x 3, groups 1): the
    forward and the generic grad op's dInput and dFilter (the patches
    against dy in one f32 product) on the card against the CPU, f32 and
    bf16; the flag put back after."""
    from paddle_tpu_torch.fluid import flags

    rng = np.random.default_rng(24)
    x = rng.standard_normal((4, 9, 9, 16)).astype(np.float32)
    w = (rng.standard_normal((8, 16, 3, 3)) * 0.2).astype(np.float32)
    attrs = {"data_format": "NHWC", "strides": [2, 2],
             "paddings": [1, 0, 2, 1]}
    flags.set_flags({"FLAGS_conv_dw_im2col": True})
    try:
        cases = {}
        for dt, limit in (("f32", LOSS_OPS_LIMIT_CONV),
                          ("bf16", CORE_LIMIT_BF16)):
            cast = (lambda a: torch.as_tensor(a).to(torch.bfloat16)) \
                if dt == "bf16" else (lambda a: a)
            ins = {"Input": cast(x), "Filter": cast(w)}
            shape = _emit_on(torch, "conv2d", ins, attrs, "cpu")[
                "Output"][0].shape
            cot = torch.randn(shape, generator=torch.Generator().manual_seed(
                6)).to(torch.bfloat16 if dt == "bf16" else torch.float32)
            cases[f"im2col_{dt}"] = ("conv2d", ins, attrs, limit)
            cases[f"im2col_{dt}_grad"] = ("conv2d_grad", dict(
                ins, **{"Output@GRAD": cot}), dict(
                attrs, __fwd_in_slots__=["Filter", "Input"]), limit)
        worst, n_exact, _ = _card_vs_cpu(torch, "im2col", cases)
    finally:
        flags.set_flags({"FLAGS_conv_dw_im2col": False})
    return {"cases": len(cases), "worst_rel_err": worst}


def _emitters_loss_ops(torch) -> dict:
    """The 33 op types of the losses-and-norms slice, the two branches
    that no longer raise (FLAGS_conv_dw_im2col, adaptive pool2d with bins
    that do not divide) and the grad ops where JAX's derivative is not
    torch's, on the card against the same emitters on the CPU."""
    from paddle_tpu_torch.ops import creation, nn_ops, reduce_ops
    from paddle_tpu_torch.ops import registry as reg

    x = _core_inputs(torch)
    cases = _loss_ops_cases(torch, x)
    cases.update(_loss_ops_grads(torch, cases))
    worst, n_exact, done = _card_vs_cpu(torch, "emitter", cases)
    want = {o for o in reg.registered_ops()
            if reg.get(o).emit.__module__ in (
                nn_ops.__name__, reduce_ops.__name__, creation.__name__)}
    missing = sorted(_LOSS_OP_TYPES - done)
    if missing or not _LOSS_OP_TYPES <= want:
        fail(f"emitters: loss-and-norm op types not held on the card: {missing}")
    return {"cases": len(cases), "bit_for_bit": n_exact,
            "op_types": len(done & _LOSS_OP_TYPES),
            "limits": {"f32": CORE_LIMIT_F32, "f32_conv": LOSS_OPS_LIMIT_CONV,
                       "norm_at_mean_100": LOSS_OPS_LIMIT_NORM100,
                       "bf16": CORE_LIMIT_BF16},
            "worst_rel_err_by_op": worst, "im2col": _im2col_on_card(torch)}


# the text classifier of the reference's sentiment-classification recipe
# (hapi's CNNEncoder) at its widths: a 30,000 x 128 embedding, 128 filters
# of each of the sizes 3, 4 and 5, two classes; Adam 1e-3, f32
TEXT_CNN = dict(batch=64, seq=256, vocab=30000, emb=128, filters=128,
                sizes=(3, 4, 5), classes=2, lr=1e-3, steps=10, cpu_steps=3)
# its loss, card against CPU over 3 Adam steps from one scope, f32 with
# TF32 off: the same math in another summation order (cuDNN's conv
# against the CPU's) moves it by ~1e-7; TF32's 10-bit mantissa in the
# convolutions and the fc moves it by ~1e-5 or more, so 2e-6 holds the
# card to f32 and catches TF32
TEXT_CNN_LOSS_LIMIT = 2e-6


def _text_cnn_program(c, pool_size=None):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.hapi import text

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [c["batch"], c["seq"]], "int64",
                     append_batch_size=False)
        lbl = L.data("lbl", [c["batch"], 1], "int64",
                     append_batch_size=False)
        emb = L.embedding(ids, size=[c["vocab"], c["emb"]])
        enc = text.CNNEncoder(num_channels=c["emb"],
                              num_filters=c["filters"],
                              filter_sizes=c["sizes"], pool_size=pool_size)
        logits = L.fc(enc(emb), c["classes"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, lbl))
        fluid.optimizer.AdamOptimizer(c["lr"]).minimize(loss)
    return main, startup, loss


def _text_cnn_losses(torch, c, pool_size, steps_card, steps_cpu,
                     tf32=False, profile=False) -> dict:
    """The program run from one CPU-initialised scope: ``steps_card``
    steps on the card (each timed, every launch counter set to 0 just
    before it) and ``steps_cpu`` on the CPU, on one batch from a seed;
    with ``profile``, 2 more card steps under torch.profiler."""
    from paddle_tpu_torch import fluid

    main, startup, loss = _text_cnn_program(c, pool_size)
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope.from_numpy(
        {n: v.numpy() for n, v in cpu_scope.vars.items()})
    card_exe = fluid.Executor()
    rng = np.random.default_rng(22)
    feed = {"ids": rng.integers(0, c["vocab"], (c["batch"], c["seq"]))
            .astype(np.int64),
            "lbl": rng.integers(0, c["classes"], (c["batch"], 1))
            .astype(np.int64)}
    card, ms, launches = [], [], {}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for _ in range(steps_card):
            _all_kernel_launches(reset=True)
            t0 = time.perf_counter()
            card.append(float(card_exe.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=card_scope)[0][0]))
            ms.append((time.perf_counter() - t0) * 1e3)   # fetch: synced
            for k, v in _all_kernel_launches().items():
                launches[k] = launches.get(k, 0) + v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prof = None
    if profile:
        prof = _step_profile(torch, card_exe, main, card_scope, feed, loss,
                             2, "text_cnn, f32, 64 x 256, after the timed "
                             "steps")
        prof["top_kernels"] = prof["top_kernels"][:8]
    cpu = [float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                             scope=cpu_scope)[0][0])
           for _ in range(steps_cpu)]
    n = min(steps_cpu, steps_card)
    return {"loss_card": card, "loss_cpu": cpu, "step_ms": ms,
            "profile": prof,
            "loss_gap": max(abs(a - b) for a, b in zip(card[:n], cpu[:n])),
            "launches": launches,
            "ops": sorted({op.type for op in main.global_block().ops})}


def phase_text_cnn(torch, card: str) -> dict:
    """hapi's text-CNN classifier through the port's entry points
    (``program_guard``, ``hapi.text.CNNEncoder``, ``AdamOptimizer
    .minimize``, ``Executor.run``): 10 Adam steps on the card at batch 64
    x 256 tokens, the same program from the same scope 3 steps on the
    CPU, the loss gap held to ``TEXT_CNN_LOSS_LIMIT``; 3 more card steps
    with TF32 on show that the limit catches TF32; the ``pool_size=2``
    encoder (``pool2d``, ``squeeze2``, ``transpose2``) one step on both;
    2 more card steps under torch.profiler give the device's idle share.
    No hand-written kernel lies on this path (its ops are plain torch and
    cuDNN); the launch counters read 0."""
    t0 = time.perf_counter()
    c = TEXT_CNN
    f32 = _text_cnn_losses(torch, c, None, c["steps"], c["cpu_steps"],
                           profile=True)
    tf32 = _text_cnn_losses(torch, c, None, c["cpu_steps"], c["cpu_steps"],
                            tf32=True)
    pool = _text_cnn_losses(torch, c, 2, 1, 1)
    losses = f32["loss_card"]
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"text_cnn: card losses {losses}")
    for what, r in (("f32", f32), ("pool_size 2", pool)):
        if not r["loss_gap"] <= TEXT_CNN_LOSS_LIMIT:
            fail(f"text_cnn {what}: card vs CPU loss gap {r['loss_gap']} > "
                 f"{TEXT_CNN_LOSS_LIMIT}")
    if not tf32["loss_gap"] > TEXT_CNN_LOSS_LIMIT:
        fail(f"text_cnn: TF32 moved the loss by {tf32['loss_gap']}, within "
             f"the limit {TEXT_CNN_LOSS_LIMIT}: the limit would not catch it")
    if not {"concat", "reduce_max", "conv2d"} <= set(f32["ops"]) \
            or not {"pool2d", "squeeze2", "transpose2"} <= set(pool["ops"]):
        fail(f"text_cnn: ops {f32['ops']} / {pool['ops']}")
    steady = f32["step_ms"][2:]
    out = {"phase": "text_cnn", "card": card,
           "model": "embedding 30000 x 128 -> CNNEncoder(128, 128, (3, 4, "
                    "5)) -> fc 2 -> softmax_with_cross_entropy -> mean; "
                    "Adam 1e-3, f32, random weights from the startup "
                    "program, a batch from seed 22",
           "batch": c["batch"], "seq": c["seq"], "steps": c["steps"],
           "step_ms_median": statistics.median(steady),
           "step_ms": f32["step_ms"],
           "loss_card": f32["loss_card"], "loss_cpu": f32["loss_cpu"],
           "loss_gap": f32["loss_gap"], "limit": TEXT_CNN_LOSS_LIMIT,
           "loss_gap_tf32_on": tf32["loss_gap"], "tf32_exceeds_limit": True,
           "pool_size_2": {k: pool[k] for k in (
               "loss_card", "loss_cpu", "loss_gap", "step_ms")},
           "launches": f32["launches"], "profile": f32["profile"],
           "phase_s": time.perf_counter() - t0}
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
    fa.flash_attention_bsh.launches_tc = 0
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
    if fa.flash_attention_bsh.launches_tc:
        fail(f"the f32 infer path launched row 4's wgmma kernel "
             f"{fa.flash_attention_bsh.launches_tc} times (f32 stays SIMT)")
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


# ---------------------------------------------------------------------------
# serve: the RPC replica (inference/server.py) over a saved BERT-base, and
# the decoder's generate verb through it
# ---------------------------------------------------------------------------

SERVE_LIMIT = 1e-5      # a served infer reply vs the direct predictor, f32
SERVE_MAX_BATCH = 8
SERVE_FEEDS = ("input_ids", "token_type_ids", "position_ids", "input_mask")


def _serve_save_bert(model_dir: str):
    """BERT-base's infer program (f32, seed-0 startup on the card) saved
    by ``fluid.io.save_inference_model``: returns (cfg, fetch names,
    seconds to save)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    main, startup, seq, pooled = _bert_program(cfg, SERVE_MAX_BATCH, 512)
    scope, exe = fluid.Scope(), fluid.Executor()  # device=None: the card
    exe.run(startup, scope=scope)
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fetch = fluid.io.save_inference_model(
            model_dir, list(SERVE_FEEDS), [seq, pooled], exe,
            main_program=main)
    return cfg, fetch, time.perf_counter() - t0


def _serve_requests(cfg, n: int, seed: int) -> list:
    """n infer requests of 1-4 sequences x 512 (lengths 128-512)."""
    rng = np.random.default_rng(seed)
    return [_bert_batch(rng, cfg, int(rng.integers(1, 5)), 512, 128)
            for _ in range(n)]


def _pad_rows(feed: dict, rows: int) -> dict:
    """``feed`` padded with zero rows to ``rows``, as the batcher pads."""
    return {k: np.concatenate([v, np.zeros((rows - len(v),) + v.shape[1:],
                                           v.dtype)])
            for k, v in feed.items()}


def _serve_diff(replies, direct) -> float:
    """Largest |served - direct| over every fetch of every request."""
    worst = 0.0
    for got, want in zip(replies, direct):
        for g, w in zip(got, want):
            if g.shape != w.shape or not np.isfinite(g).all():
                fail(f"a served fetch has shape {g.shape} (want {w.shape}) "
                     f"or non-finite values")
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


def _pcts(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "n": len(xs)}


def _serve_cli_replica(model_dir: str, reqs: list, fetch: list) -> dict:
    """``python -m paddle_tpu_torch.inference.server`` as a subprocess:
    its ``listening on`` line, 8 infer requests from 4 client threads,
    health and model_info, then SIGTERM: it must drain and exit 0."""
    import queue
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.inference.client import InferenceClient

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    err = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.server",
         "--model_dir", model_dir, "--port", "0", "--host", "127.0.0.1",
         "--max_batch", str(SERVE_MAX_BATCH)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()

    def tail() -> str:
        err.seek(0)
        return err.read().decode(errors="replace")[-3000:]

    try:
        ep, deadline = None, time.monotonic() + 300
        while ep is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail(f"the CLI replica never printed 'listening on' "
                         f"(rc {proc.poll()}): {tail()}")
                continue
            if "listening on" in line:
                ep = line.rsplit(" ", 1)[1].strip()
        ready_s = time.perf_counter() - t0
        cli = InferenceClient([ep], deadline_secs=300)

        def one(feed):
            t = time.perf_counter()
            res = cli.infer(feed, deadline_ms=300000)
            return res.outputs, (time.perf_counter() - t) * 1e3

        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(one, reqs))
        health, info = cli.health(), cli.model_info()
        served = cli.stats()["serving"]
        cli.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail(f"the CLI replica did not exit within 120 s of SIGTERM: "
                 f"{tail()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        fail(f"the CLI replica exited {rc} after SIGTERM: {tail()}")
    if not health.get("ok") or sorted(info["feeds"]) != sorted(SERVE_FEEDS) \
            or list(info["fetches"]) != list(fetch):
        fail(f"the CLI replica's health {health} or model_info {info}")
    if served["error_total"] or served["shed_total"] \
            or served["served_total"] != len(reqs):
        fail(f"the CLI replica's books: {served}")
    if "SIGTERM: draining" not in tail():
        fail(f"the CLI replica exited without draining: {tail()}")
    return {"endpoint": ep, "ready_s": ready_s, "rc": rc,
            "outputs": [g[0] for g in got],
            "client_ms": [g[1] for g in got],
            "batches": served["batches_total"],
            "num_ops": info["num_ops"]}


def phase_serve(torch, card: str, dec_cfg, model_dir: str) -> dict:
    """The RPC replica: a BERT-base export (saved into ``model_dir``, kept
    for serve_launch) served by the CLI replica and by an in-process
    replica that also answers generate, every reply held against the
    direct predictor or engine, the kernels' launches exact."""
    import threading

    from paddle_tpu_torch.distributed.ps_server import _Conn
    from paddle_tpu_torch.inference import (GenerationEngine, TinyDecoderLM,
                                            ServingPredictor, load_frozen)
    from paddle_tpu_torch.inference import server as srv_mod
    from paddle_tpu_torch.inference.client import InferenceClient
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.telemetry import get_registry

    reg = get_registry()
    cfg, fetch, save_s = _serve_save_bert(model_dir)
    disk_mb = sum(os.path.getsize(os.path.join(model_dir, f))
                  for f in os.listdir(model_dir)) / 2 ** 20
    reqs = _serve_requests(cfg, 32, seed=0)
    ref = ServingPredictor(load_frozen(model_dir))
    ref.run(_pad_rows(reqs[0], SERVE_MAX_BATCH))   # warm
    direct, direct_ms = [], []
    for feed in reqs:
        t = time.perf_counter()
        outs = ref.run(_pad_rows(feed, SERVE_MAX_BATCH))
        direct_ms.append((time.perf_counter() - t) * 1e3)
        direct.append([o[:len(feed["input_ids"])] for o in outs])

    cli_rep = _serve_cli_replica(model_dir, reqs[:8], fetch)
    cli_diff = _serve_diff(cli_rep["outputs"], direct[:8])
    if not cli_diff <= SERVE_LIMIT:
        fail(f"the CLI replica's infer replies differ from the direct "
             f"predictor by {cli_diff} > {SERVE_LIMIT}")

    # the direct engine run: the same seed-0 decoder and 8 greedy
    # requests submitted in order
    prompts = _engine_traffic(np.random.default_rng(0), dec_cfg.vocab)
    new_tokens = 64
    model = TinyDecoderLM(dec_cfg, seed=0)       # device=None: the card
    geom = dict(max_slots=8, page_size=16, n_pages=513)
    # warm cuBLAS at these prompts' prefill shapes on a throwaway
    # engine, so neither measured run pays a cold start
    eng = GenerationEngine(model, **geom)
    for r in [eng.submit(p, max_new_tokens=2) for p in prompts]:
        eng.result(r, timeout=900)
    eng.stop()
    step_h = reg.histogram("serve_decode_step_ms")
    h0 = step_h.sum
    eng = GenerationEngine(model, **geom)
    t0 = time.perf_counter()
    dreqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    dreps = [eng.result(r, timeout=900) for r in dreqs]
    direct_gen_s = time.perf_counter() - t0
    dc = dict(eng.counters)
    eng.stop()
    direct_step_ms = step_h.sum - h0

    # the in-process replica: both paths, counters set to 0 just
    # before it is driven
    frozen = load_frozen(model_dir)
    eng = GenerationEngine(model, **geom)
    order = []
    submit = eng.submit

    def submit_in_order(*a, **kw):
        req = submit(*a, **kw)
        order.append(req)
        return req

    eng.submit = submit_in_order
    ready = threading.Event()
    addr = {}

    def on_ready(a):
        addr["ep"] = f"127.0.0.1:{a[1]}"
        ready.set()

    serve_err = []

    def run_server():
        try:
            srv_mod.serve(frozen, port=0, host="127.0.0.1",
                          ready_cb=on_ready, max_batch=SERVE_MAX_BATCH,
                          engine=eng)
        except BaseException as e:  # noqa: BLE001 — reported below
            serve_err.append(f"{type(e).__name__}: {e}")
            ready.set()

    server = threading.Thread(target=run_server, daemon=True)
    server.start()
    if not ready.wait(300) or serve_err:
        fail(f"the in-process replica did not start: {serve_err}")
    ep = addr["ep"]
    inf = srv_mod._ACTIVE
    batch_ms = []
    run = inf.predictor.run

    def timed_run(feed):
        t = time.perf_counter()
        try:
            return run(feed)
        finally:
            batch_ms.append((time.perf_counter() - t) * 1e3)

    inf.predictor.run = timed_run
    torch.cuda.synchronize()
    b0 = reg.counter("serve_batches_total").value
    r0 = reg.counter("serve_batch_rows_total").value
    fa.flash_attention_bsh.launches = 0
    fa.flash_attention_bsh.launches_tc = 0
    add_ln.fused_add_ln.launches = 0
    pa.paged_attention.launches = 0

    errors = []

    def infer_threads(idx, n_threads=4):
        """Threads sending reqs[i] for i in idx from n_threads
        clients; (threads, {i: outputs}, {i: client ms})."""
        outs, ms = {}, {}

        def worker(part):
            c = InferenceClient([ep], deadline_secs=300)
            try:
                for i in part:
                    t1 = time.perf_counter()
                    res = c.infer(reqs[i], deadline_ms=300000)
                    ms[i] = (time.perf_counter() - t1) * 1e3
                    outs[i] = res.outputs
            except BaseException as e:  # noqa: BLE001
                errors.append(f"infer: {type(e).__name__}: {e}")
            finally:
                c.close()

        return ([threading.Thread(target=worker,
                                  args=(idx[t::n_threads],))
                 for t in range(n_threads)], outs, ms)

    def gen_worker(i, n_new, out):
        c = InferenceClient([ep], deadline_secs=600)
        try:
            if i % 2:
                timings, toks = {}, []
                for chunk in c.generate_stream(
                        prompts[i], max_new_tokens=n_new,
                        timings=timings):
                    toks.extend(chunk)
                out[i] = {"tokens": toks, "stream": True,
                          "ttft_ms_client": timings["ttft_ms"]}
            else:
                res = c.generate(prompts[i], max_new_tokens=n_new)
                out[i] = {"tokens": res.tokens, "stream": False,
                          "ttft_ms": res.ttft_ms}
        except BaseException as e:  # noqa: BLE001
            errors.append(f"generate {i}: {type(e).__name__}: {e}")
        finally:
            c.close()

    def window(name, idx, gen_idx=(), n_new=new_tokens):
        """Drive reqs[idx] and, submitted in order after them, the
        generate requests gen_idx; returns the window's record."""
        nb0 = len(batch_ms)
        b1 = reg.counter("serve_batches_total").value
        r1 = reg.counter("serve_batch_rows_total").value
        s1, d1 = step_h.sum, eng.counters["decode_positions"]
        threads, outs, ms = infer_threads(list(idx))
        gen_out, n_order = {}, len(order)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        # one thread submits the generate requests in order: each
        # next one only after the engine took the last
        for k, i in enumerate(gen_idx):
            th = threading.Thread(target=gen_worker,
                                  args=(i, n_new, gen_out))
            th.start()
            threads.append(th)
            limit = time.monotonic() + 60
            while len(order) <= n_order + k and not errors \
                    and time.monotonic() < limit:
                time.sleep(0.0005)
            if len(order) <= n_order + k:
                fail(f"generate request {i} never reached the "
                     f"engine: {errors}")
        done = sum(r.event.is_set() for r in order[n_order:])
        for th in threads:
            th.join(900)
        rec = {"window": name, "wall_s": time.perf_counter() - t0,
               "infer_requests": len(idx),
               "generate_requests": len(gen_idx)}
        if idx:
            nb = reg.counter("serve_batches_total").value - b1
            rec.update(
                batches=nb, rows_per_batch=(
                    reg.counter("serve_batch_rows_total").value - r1)
                / max(1, nb),
                client_ms=_pcts(list(ms.values())),
                serve_batch_ms_exact=_pcts(batch_ms[nb0:]))
        if gen_idx:
            rec.update(done_at_last_submit=done,
                       decode_tokens_per_s=(
                           eng.counters["decode_positions"] - d1)
                       / ((step_h.sum - s1) / 1e3))
        return rec, outs, gen_out

    # 1: infer alone through the replica; 2: infer beside the 8
    # generate requests (the run held against the direct engine);
    # 3: a short mixed replay under torch.profiler
    alone, alone_out, _ = window("infer_alone", range(len(reqs)))
    mixed, infer_out, gen_out = window("mixed", range(len(reqs)),
                                       range(len(prompts)))
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_rec, prof_out, _ = window("profiled", range(8), range(4),
                                       n_new=16)
        torch.cuda.synchronize()
    rows_dev = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows_dev)
    prof_rec.update(device_busy_ms=busy_ms, device_idle_share=max(
        0.0, 1 - busy_ms / (prof_rec["wall_s"] * 1e3)),
        top_kernels=[{"ms": ms, "calls": n, "name": k[:90]}
                     for ms, n, k in rows_dev[:10]])
    torch.cuda.synchronize()
    launches = {"flash": fa.flash_attention_bsh.launches,
                "flash_tc": fa.flash_attention_bsh.launches_tc,
                "ln": add_ln.fused_add_ln.launches,
                "paged": pa.paged_attention.launches}
    batches = reg.counter("serve_batches_total").value - b0
    rows = reg.counter("serve_batch_rows_total").value - r0
    sc = dict(eng.counters)
    cli = InferenceClient([ep], deadline_secs=60)
    stats = cli.stats()
    health = cli.health()
    cli.close()
    ctl = _Conn(ep, deadline=60.0)
    drained = ctl.call("drain", timeout=60.0)
    ctl.call("shutdown")
    ctl.close()
    server.join(120)
    if server.is_alive() or serve_err:
        fail(f"the in-process replica did not shut down: {serve_err}")

    if errors:
        fail(f"error replies from the in-process replica: {errors[:4]}")
    serving = stats["serving"]
    if serving["error_total"] or serving["shed_total"] \
            or serving["deadline_exceeded_total"]:
        fail(f"the replica's books: {serving}")
    if not drained.get("drained") or not health.get("ok"):
        fail(f"drain {drained}, health {health}")
    infer_diff = max(
        _serve_diff([o[i] for i in sorted(o)], [direct[i] for i in sorted(o)])
        for o in (alone_out, infer_out, prof_out))
    if not infer_diff <= SERVE_LIMIT:
        fail(f"served infer replies differ from the direct predictor by "
             f"{infer_diff} > {SERVE_LIMIT}")
    prefix = []
    for i, want in enumerate(dreps):
        a, b = gen_out[i]["tokens"], want["tokens"]
        n = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        prefix.append(n)
        if a != b:
            fail(f"generate request {i} through the replica differs from "
                 f"the direct engine after {n} of {len(b)} tokens")
    layers = cfg.num_hidden_layers
    want = {"flash": batches * layers, "flash_tc": 0,
            "ln": batches * (2 * layers + 1),
            "paged": sc["decode_steps"] * dec_cfg.n_layers}
    if launches != want:
        fail(f"launches in the served run {launches}, want {want} "
             f"({batches} infer batches, {sc['decode_steps']} decode steps)")
    if sc["served"] != len(prompts) + 4 \
            or serving["batches_total"] != batches:
        fail(f"served {sc['served']} generations, {batches} batches "
             f"(stats: {serving['batches_total']})")
    gens = [gen_out[i] for i in range(len(prompts))]
    ttft = [g["ttft_ms"] for g in gens if not g["stream"]]
    ttft_client = [g["ttft_ms_client"] for g in gens if g["stream"]]
    mixed.update(ttft_ms_server_p50=statistics.median(ttft),
                 ttft_ms_client_stream_p50=statistics.median(ttft_client),
                 streams=sum(g["stream"] for g in gens),
                 common_prefix=prefix)
    out = {
        "phase": "serve", "card": card,
        "model": {"bert": "BertConfig.base() f32, seed-0 startup",
                  "saved_mb": disk_mb, "save_s": save_s,
                  "fetch_names": fetch,
                  "decoder": dataclasses.asdict(dec_cfg)},
        "cli_replica": {k: v for k, v in cli_rep.items()
                        if k not in ("outputs",)},
        "cli_max_abs_diff": cli_diff,
        "direct": {"predictor_run_ms": _pcts(direct_ms),
                   "engine_ttft_ms_p50": statistics.median(
                       r["ttft_ms"] for r in dreps),
                   "engine_decode_tokens_per_s":
                       dc["decode_positions"] / (direct_step_ms / 1e3),
                   "engine_wall_s": direct_gen_s},
        "windows": [alone, mixed, prof_rec],
        "infer_max_abs_diff": infer_diff, "limit": SERVE_LIMIT,
        "batches": batches, "rows": rows,
        "rows_per_batch": rows / max(1, batches),
        "serve_batch_ms": serving["batch_ms"],
        "serve_batch_ms_p50_bucket": reg.histogram(
            "serve_batch_ms").quantile(0.5),
        "serve_request_ms": serving["request_ms"],
        "serve_request_ms_p50_bucket": serving["p50_ms"],
        "serve_request_ms_p99_bucket": serving["p99_ms"],
        "generate_counters": sc, "launches": launches,
        "engine_stats": {k: stats["generation"][k] for k in (
            "ttft_p50_ms", "tpot_p50_ms", "served_total",
            "cached_positions_total")},
    }
    emit(out)
    del frozen, ref, model, eng, inf
    torch.cuda.empty_cache()
    return out


def _train_program(cfg, b: int, s: int, max_preds: int, amp: bool):
    """BERT pretraining as a user builds it: the MLM + NSP program, Adam at
    1e-4, bf16 AMP (``decorate``) when ``amp``, ``minimize``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, b, s, max_preds, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-4)
            if amp:
                opt = mixed_precision.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return m, st, loss


KERNEL_COUNTERS = ("row6", "row7", "row8", "row9", "row6_tc", "row7_tc",
                   "row8_tc", "row9_tc", "bsh_fwd", "bsh_fwd_tc", "bsh_bwd",
                   "bsh_bwd_tc", "ln_fwd", "ln_bwd")


class _Counter:
    """A wrapper's launch counter kept under another attribute (the
    tensor-core route's ``launches_tc``), read and reset as ``launches``."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.fn, self.attr, value)


def _counters():
    from paddle_tpu_torch.ops.kernels import add_ln
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"row6": fa.flash_attention, "row7": fa.flash_attention_bwd_fused,
            "row8": fa.flash_attention_bwd_dq,
            "row9": fa.flash_attention_bwd_dkv,
            "row6_tc": _Counter(fa.flash_attention, "launches_tc"),
            "row7_tc": _Counter(fa.flash_attention_bwd_fused, "launches_tc"),
            "row8_tc": _Counter(fa.flash_attention_bwd_dq, "launches_tc"),
            "row9_tc": _Counter(fa.flash_attention_bwd_dkv, "launches_tc"),
            "bsh_fwd": fa.flash_attention_bsh,
            "bsh_fwd_tc": _Counter(fa.flash_attention_bsh, "launches_tc"),
            "bsh_bwd": fa.flash_attention_bsh_bwd,
            "bsh_bwd_tc": _Counter(fa.flash_attention_bsh_bwd,
                                   "launches_tc"),
            "ln_fwd": add_ln.fused_add_ln, "ln_bwd": add_ln.fused_add_ln_bwd}


def _launches_per_step(program, bf16: bool = False, ops=None,
                       train=None) -> dict:
    """The flash and LayerNorm kernel launches one run of ``program`` must
    make, counted from its ops and their bias shapes: an encoder stack
    layer with a full [.., S, S] bias runs row 6 (rows 8 and 9 in the
    backward), with a per-key [B, 1, 1, S] one the BSH forward (and its
    two backward kernels); a decoder layer the BSH forward for its causal
    self-attention and, with a per-key source bias, for its
    cross-attention; an LN forward and backward per residual (2 an
    encoder layer, 3 a decoder layer) and per last-axis affine
    layer_norm; an attention op with a per-key bias shared over the
    batch row 6 (row 7 in the backward), any other the BSH kernels.  In a
    bf16 program every flash launch is on its wgmma kernel (``*_tc``).
    In training, an encoder stack whose whole layer is recomputed
    (``remat_layer``, or a ``remat_policy``) runs its two LN forwards
    again, and its flash forward again unless the policy keeps the
    forward's o and lse (both ``flash_o`` and ``flash_lse``, as "flash"
    does) on the BSH branch; ``remat_ffn`` and ``remat_qkv`` recompute
    neither.  ``ops`` (default: the block's) and ``train`` (default:
    whether the block holds a grad op) count a part of the program."""
    from paddle_tpu_torch.ops.encoder_stack import _policy_names

    block = program.global_block()
    ops = block.ops if ops is None else ops
    n = dict.fromkeys(KERNEL_COUNTERS, 0)
    if train is None:
        train = any(op.type.endswith("_grad") for op in block.ops)

    def shape(op, slot):
        names = op.inputs.get(slot) or []
        return tuple(block.var(names[0]).shape) if names else None

    for op in ops:
        if op.type == "fused_encoder_stack":
            layers = shape(op, "QKVW")[0]
            bias = shape(op, "AttnBias")
            policy = set(_policy_names(op.attr("remat_policy") or ""))
            again = train and (bool(policy) or bool(op.attr("remat_layer")))
            if bias is not None and bias[2] != 1:
                n["row6"] += layers * (2 if again else 1)
                n["row8"] += layers
                n["row9"] += layers
            else:
                keeps = {"flash_o", "flash_lse"} <= policy
                n["bsh_fwd"] += layers * (2 if again and not keeps else 1)
                n["bsh_bwd"] += 2 * layers
            n["ln_fwd"] += 2 * layers * (2 if again else 1)
            n["ln_bwd"] += 2 * layers
        elif op.type == "fused_decoder_stack":
            layers = shape(op, "SelfQKVW")[0]
            bias = shape(op, "SrcBias")
            calls = 2 if bias is not None and bias[1:3] == (1, 1) else 1
            n["bsh_fwd"] += calls * layers
            n["bsh_bwd"] += 2 * calls * layers
            n["ln_fwd"] += 3 * layers
            n["ln_bwd"] += 3 * layers
        elif op.type == "fused_multihead_attention":
            bias = shape(op, "BiasQK")
            if bias is not None and bias[0] == 1:
                n["row6"] += 1
                n["row7"] += 1
            else:
                n["bsh_fwd"] += 1
                n["bsh_bwd"] += 2
        elif op.type == "layer_norm" and op.inputs.get("Scale") \
                and op.inputs.get("Bias") and op.attr("begin_norm_axis") \
                == len(shape(op, "X")) - 1:
            n["ln_fwd"] += 1
            n["ln_bwd"] += 1
    if not train:
        for k in ("row7", "row8", "row9", "bsh_bwd", "ln_bwd"):
            n[k] = 0
    # a bf16 program's flash kernels all run on the tensor cores
    # (bsh_fwd_route, bsh_bwd_route, bhsd_fwd_route, bhsd_bwd_route)
    for k in ("bsh_fwd", "bsh_bwd", "row6", "row7", "row8", "row9"):
        n[f"{k}_tc"] = n[k] if bf16 else 0
    return n



def phase_bert_train(torch, card: str) -> dict:
    """BERT-base pretraining on the card: fuse_stack, Adam, bf16 AMP,
    dropout 0.1, 8 x 512, on one fixed batch."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.fuse_stack = True
    b, s, max_preds, n_steps, n_warm = 8, 512, 76, 10, 2
    t0 = time.perf_counter()
    main, startup, loss = _train_program(cfg, b, s, max_preds, amp=True)
    build_s = time.perf_counter() - t0
    want = _launches_per_step(main, bf16=True)
    scope = fluid.Scope()
    exe = fluid.Executor()                        # device=None: the card
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in
                   (scope.find_var(v.name) for v in main.all_parameters()))
    feed = {k: torch.as_tensor(v, device=exe.device) for k, v in
            bert.random_pretrain_batch(cfg, b, s, max_preds, seed=0).items()}
    losses, step_ms, total = _train_steps(
        torch, "bert_train", exe, main, scope, feed, loss, want, n_steps,
        n_warm)
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        fail(f"bert_train loss did not fall on a fixed batch: {losses}")
    med = statistics.median(step_ms)
    out = {"phase": "bert_train", "card": card,
           "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                      "layers": cfg.num_hidden_layers,
                      "heads": cfg.num_attention_heads,
                      "ffn": cfg.intermediate_size, "dropout": 0.1,
                      "fuse_stack": True, "optimizer": "Adam 1e-4",
                      "amp": "bf16", "batch": b, "seq": s,
                      "max_preds": max_preds},
           "params": n_params, "program_ops": len(main.global_block().ops),
           "build_s": build_s, "startup_s": startup_s,
           "steps": n_steps, "warm_steps": n_warm,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "tokens_per_s": b * s / (med / 1e3),
           "losses": losses, "launches_per_step": want,
           "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(out)
    return dict(out, exe=exe, main=main, scope=scope, feed=feed, loss=loss)


def _train_parity(torch, cfg, amp: bool, steps: int = 3) -> dict:
    """The training program on 2 x 128 on the card (kernels) and on the
    CPU (plain versions) from the same weights: losses of every step and
    a few parameters after the last."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    b, s, max_preds = 2, 128, 20
    main, startup, loss = _train_program(cfg, b, s, max_preds, amp)
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope.from_numpy(
        {n: v.numpy() for n, v in cpu_scope.vars.items()})
    card_exe = fluid.Executor()
    feed = bert.random_pretrain_batch(cfg, b, s, max_preds, seed=3)
    card, cpu = [], []
    for _ in range(steps):
        card.append(float(card_exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=card_scope)[0][0]))
        cpu.append(float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu_scope)[0][0]))
    params = {}
    for n in ("encoder_stack.qkv_w", "encoder_stack.ffn_w2",
              "encoder_stack.ln1_scale", "word_embedding",
              "mask_lm_trans_fc.w_0", "next_sent_fc.w_0"):
        params[n] = float((card_scope.find_var(n).cpu().float()
                           - cpu_scope.find_var(n).float()).abs().max())
    return {"loss_card": card, "loss_cpu": cpu,
            "loss_diff": max(abs(a - c) for a, c in zip(card, cpu)),
            "param_diff": params}


def phase_bert_train_parity(torch) -> dict:
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.fuse_stack = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    counters = _counters()
    n0 = {k: c.launches for k, c in counters.items()}
    f32 = _train_parity(torch, cfg, amp=False)
    if any(counters[k].launches == n0[k]
           for k in ("bsh_fwd", "bsh_bwd", "ln_fwd", "ln_bwd")):
        fail("the f32 parity run on the card missed a kernel")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _train_parity(torch, cfg, amp=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    amp = _train_parity(torch, cfg, amp=True)
    checks = [("f32 loss", f32["loss_diff"], TRAIN_PARITY_LOSS),
              ("f32 params", max(f32["param_diff"].values()),
               TRAIN_PARITY_PARAM),
              ("bf16 loss", amp["loss_diff"], TRAIN_PARITY_LOSS_BF16)]
    for name, diff, limit in checks:
        if not math.isfinite(diff) or diff > limit:
            fail(f"BERT-base training card vs CPU, {name}: {diff} > "
                 f"{limit}")
    out = {"phase": "bert_train_parity", "batch": 2, "seq": 128,
           "steps": 3, "f32": f32, "f32_tf32_on": tf32, "amp_bf16": amp,
           "limits": {"f32_loss": TRAIN_PARITY_LOSS,
                      "f32_param": TRAIN_PARITY_PARAM,
                      "bf16_loss": TRAIN_PARITY_LOSS_BF16},
           "tf32_exceeds_limit": (
               tf32["loss_diff"] > TRAIN_PARITY_LOSS
               and max(tf32["param_diff"].values()) > TRAIN_PARITY_PARAM)}
    emit(out)
    return out


def _step_profile(torch, exe, main, scope, feed, loss, steps: int,
                  note: str) -> dict:
    """Where a training step's time goes: ``steps`` steps under
    torch.profiler; device busy time by kernel against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "top_kernels": [{"ms": ms, "calls": n, "name": k[:90]}
                            for ms, n, k in rows[:20]],
            "note": note + "; busy = sum of kernel self times"}


def phase_bert_train_profile(torch, train: dict) -> dict:
    """Where a training step's time goes: 3 steps of bert_train under
    torch.profiler; device busy time by kernel against the wall time."""
    out = {"phase": "bert_train_profile", **_step_profile(
        torch, train["exe"], train["main"], train["scope"], train["feed"],
        train["loss"], 3, "window = 3 training steps of 8 x 512 (forward, "
        "backward, Adam, loss fetch)")}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# ResNet-50 training: the conv+BN kernels (rows 10-14)
# ---------------------------------------------------------------------------

# conv+BN kernel checks against the plain versions on the same inputs.
# Rows 10/11, f32 (TF32 off): the kernel sums the K = kh*kw*C products in
# another order than cuDNN; the error is normalised by max |z| of the case.
# bf16: both round the f32 sum to bf16 once, so z may differ by one bf16
# ulp where the two f32 sums straddle a rounding boundary.  Rows 12 and 14
# repeat the plain version's arithmetic one rounding an op (no FMA), so
# they agree to the last bit; row 13 sums over R rows in another order.
CONV_Z_F32 = 2e-5           # max |z - z_plain| / max |z_plain|, f32
CONV_STAT_F32 = 2e-5        # batch mean/var vs the plain version's, f32
CONV_STAT_BF16 = 2e-3       # the same over bf16 z that may differ by 1 ulp
# row 13's dgamma/dbeta: f32 sums over up to 401,408 rows of terms of
# size ~1, in the kernel's per-block order against torch's tree
ATOL_CONV_SUM = 5e-3
RTOL_CONV_SUM = 1e-5
# ResNet-50 training card vs CPU (batch 8, 64 x 64, Momentum 0.01).  f32
# with TF32 off: the first step's loss (the forward), gradients and batch
# statistics are held.  This network's gradient at this size is sensitive
# to rounding: the library's own convolutions and batch_norm (the program
# without the fusion) differ card vs CPU by 1.5% in the first gradients
# (relative norm), and later steps diverge whatever computes them, so
# they are reported, not held.  TF32 moves the first loss by 3e-2, the
# gradients by 53% and the statistics by 2e-3, far past the f32 limits.
# bf16 AMP: one bf16 ulp is 2^-8 relative, and the rounding differences
# of any two correct paths grow from layer to layer.  On the H100 at
# seeds 0-3 the 53 conv+BN outputs of the kernels' path and of the
# library's path (cuDNN, torch's batch_norm) sit the same distance from
# the CPU's at every layer, from ~1e-4 after the first kernel to ~0.45
# at the last, and the first loss 0.02-0.25 (kernels) and 0.01-0.23
# (library) from the CPU's in two runs.  So the first loss is held on
# every seed at 0.4, above all sixteen readings: a sanity bound, since
# any rounding change moves it that far.  The kernels' accuracy is held
# op by op instead: each gated op run again from its own inputs of that
# step, kernels against the CPU's plain versions, read at most 2.1e-4
# (relative L2 of y; cuDNN's composition 2.6e-4).  The limit 5e-4 sits
# above both and below the fault it must catch, statistics of the
# unrounded f32 z (5.4e-4 to 1.8e-3 by op), which the phase computes
# beside.  The bench's learning rate 0.1 makes 8 images at
# 64 x 64 diverge within three steps; 0.01 keeps the reported steps
# stable.
PARITY_LR = 0.01
RESNET_PARITY_LOSS = 2e-4
RESNET_PARITY_GRAD = 5e-2
RESNET_PARITY_STAT = 1e-4
RESNET_BF16_SEEDS = (0, 1, 2, 3)
RESNET_PARITY_LOSS_BF16 = 0.4
RESNET_LOCAL_BF16 = 5e-4
CONV_BN_KERNELS = ("conv_stats", "mm_stats", "bn_apply", "bn_bwd_reduce",
                   "bn_bwd_dz")
# the kernel checks' cases, ResNet-50 at batch 128: (N, H, W, C, O, k,
# stride, relu); the four 3 x 3 stage shapes time row 10 (bf16, the wgmma
# kernel), the five 1 x 1 shapes row 11 (bf16, the wgmma kernel), s0_1x1
# rows 12-14
CONV_BN_CASES = {
    "s0_3x3": (128, 56, 56, 64, 64, 3, 1, True),
    "s0_1x1_64to256": (128, 56, 56, 64, 256, 1, 1, False),
    "s0_1x1_256to64": (128, 56, 56, 256, 64, 1, 1, True),
    "s1_3x3": (128, 28, 28, 128, 128, 3, 1, True),
    "s1_proj_s2_256to512": (128, 56, 56, 256, 512, 1, 2, False),
    "s2_3x3": (128, 14, 14, 256, 256, 3, 1, True),
    "s2_1x1_1024to256": (128, 14, 14, 1024, 256, 1, 1, True),
    "s3_3x3": (128, 7, 7, 512, 512, 3, 1, True),
    "s3_1x1_512to2048": (128, 7, 7, 512, 2048, 1, 1, False),
}
# the 1 x 1 case rows 12-14 are timed at (stage 0's widest BN)
SWEEP_CASE = "s0_1x1_64to256"
# a bf16 k x k conv that conv_route sends to the SIMT kernel (C = 3 is
# not a multiple of 8): that route's own card check
CONV_SIMT_BF16_CASE = (32, 32, 32, 3, 64, 3, 1, True)


def _conv_case(torch, rng, n, h, w, c, o, k, stride, dtype):
    dev = "cuda"
    x = torch.as_tensor(rng.standard_normal((n, h, w, c)),
                        dtype=torch.float32).to(dev, dtype)
    wt = torch.as_tensor(rng.standard_normal((o, c, k, k))
                         * math.sqrt(2.0 / (k * k * c)),
                         dtype=torch.float32).to(dev, dtype)
    scale = torch.as_tensor(1 + 0.1 * rng.standard_normal(o),
                            dtype=torch.float32).to(dev)
    shift = torch.as_tensor(0.1 * rng.standard_normal(o),
                            dtype=torch.float32).to(dev)
    pad = (k - 1) // 2
    return x, wt, scale, shift, (stride, stride), ((pad, pad), (pad, pad))


def _conv_bn_check(torch, cb, name, case, relu, seed):
    """Each of the five kernels against its plain version on one case: the
    conv kernel (row 10 or 11) on x and w; rows 12-14 on the kernel's z and
    statistics and a random cotangent (the same inputs on both sides)."""
    x, w, scale, shift, strides, pads = case
    is_bf16 = x.dtype == torch.bfloat16
    one_by_one = tuple(w.shape[2:]) == (1, 1)
    conv = (lambda: cb.mm_stats(x, w, strides)) if one_by_one else (
        lambda: cb.conv_stats(x, w, pads))
    z, s, ss = conv()
    zr, sr, ssr = cb.conv_stats_reference(x, w, strides, pads)
    torch.cuda.synchronize()
    r = z.shape[0]
    scale_z = zr.float().abs().max().item()
    if is_bf16:
        res = {"z": _check(f"{name} z", z, zr, 1e-3 * scale_z, RTOL_BF16)}
    else:
        res = {"z": _check(f"{name} z", z, zr, CONV_Z_F32 * scale_z)}
    m, mr = s / r, sr / r
    v, vr = ss / r - m * m, ssr / r - mr * mr
    lim = (CONV_STAT_BF16 if is_bf16 else CONV_STAT_F32) * vr.abs().max()
    res["mean"] = _check(f"{name} mean", m, mr, lim.item())["max_abs_err"]
    res["var"] = _check(f"{name} var", v, vr, lim.item())["max_abs_err"]
    v = torch.clamp_min(v, 0.0)
    stat = torch.stack([m, torch.rsqrt(v + 1e-5), scale, shift])
    y = cb.bn_apply(z, stat, relu)
    yr = cb.bn_apply_reference(z, stat, relu)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        tuple(z.shape)), dtype=torch.float32).to("cuda", z.dtype)
    dgamma, dbeta = cb.bn_bwd_reduce(z, g, stat, relu)
    rdg, rdb = cb.bn_bwd_reduce_reference(z, g, stat, relu)
    tot = torch.stack([dgamma, dbeta])
    dz = cb.bn_bwd_dz(z, g, stat, tot, relu)
    dzr = cb.bn_bwd_dz_reference(z, g, stat, tot, relu)
    torch.cuda.synchronize()
    res["y"] = _check(f"{name} y", y, yr, ATOL_F32)["max_abs_err"]
    res["dgamma"] = _check(f"{name} dgamma", dgamma, rdg, ATOL_CONV_SUM,
                           RTOL_CONV_SUM)["max_abs_err"]
    res["dbeta"] = _check(f"{name} dbeta", dbeta, rdb, ATOL_CONV_SUM,
                          RTOL_CONV_SUM)["max_abs_err"]
    res["dz"] = _check(f"{name} dz", dz, dzr, ATOL_F32)["max_abs_err"]
    res["relu_kept"] = float((y > 0).float().mean()) if relu else None
    return res, dict(z=z, stat=stat, g=g, tot=tot, conv=conv)


def _conv_tile_sweep(torch, cb, flush, x, w, pads) -> dict:
    """Row 10's wgmma kernel under each tile (bm, bn) it takes, on one
    stage shape: the record behind conv_tc_tile's choice (time_cold_ms,
    20 calls each)."""
    chosen = cb.conv_tc_tile
    out = {}
    try:
        for tile in ((128, 64), (128, 128), (64, 64), (64, 128)):
            cb.conv_tc_tile = lambda rows, o, t=tile: t
            out[f"{tile[0]}x{tile[1]}"] = time_cold_ms(
                torch, lambda: cb.conv_stats(x, w, pads), flush,
                reps=20)["median"]
    finally:
        cb.conv_tc_tile = chosen
    return out


def _mm_tile_sweep(torch, cb, flush, x, w, strides) -> dict:
    """Row 11's wgmma kernel under each tile (bm, bn) and ring depth it
    takes, on one 1 x 1 shape: the record behind mm_tc_tile's choice
    (time_cold_ms, 20 calls each)."""
    chosen = cb.mm_tc_tile
    out = {}
    try:
        for tile in ((128, 64), (128, 128), (64, 64), (64, 128)):
            for stages in (2, 4):
                cb.mm_tc_tile = lambda rows, c, o, t=tile + (stages,): t
                out[f"{tile[0]}x{tile[1]}x{stages}"] = time_cold_ms(
                    torch, lambda: cb.mm_stats(x, w, strides), flush,
                    reps=20)["median"]
    finally:
        cb.mm_tc_tile = chosen
    return out


def _simt_ms(torch, cb, flush, x, w, strides) -> float:
    """Row 11 on the SIMT kernel (the route f32 and odd bf16 shapes take,
    and every bf16 1 x 1 conv took before the wgmma kernel) at the same
    bf16 inputs: the redesign's yardstick in the same run."""
    route = cb.conv_route
    try:
        cb.conv_route = lambda dtype, c, o: "simt"
        return time_cold_ms(torch, lambda: cb.mm_stats(x, w, strides),
                            flush)["median"]
    finally:
        cb.conv_route = route


def _kernels_conv_bn(torch, F, flush) -> tuple:
    """Rows 10-14 against their plain versions at ResNet-50's shapes (batch
    128), f32 with TF32 off and bf16; then timed in bf16 (the training
    path's dtype): rows 10 and 11 at every stage shape in CONV_BN_CASES
    with their tile sweeps (row 11 beside its SIMT kernel), rows 12-14 at
    SWEEP_CASE's."""
    from paddle_tpu_torch.ops.kernels import conv_bn as cb

    rng = np.random.default_rng(9)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = CONV_BN_CASES
    results, main = {}, {}
    cases = [(name, tag, dt, shape) for name, shape in shapes.items()
             for tag, dt in (("f32", f32), ("bf16", bf16))]
    cases.append(("simt_route_c3", "bf16", bf16, CONV_SIMT_BF16_CASE))
    for name, tag, dt, (n, h, w, c, o, k, st, relu) in cases:
        case = _conv_case(torch, rng, n, h, w, c, o, k, st, dt)
        kxk = k > 1
        fn = cb.conv_stats if kxk else cb.mm_stats
        n0 = (fn.launches, fn.launches_tc)
        res, t = _conv_bn_check(torch, cb, f"conv_bn {name} {tag}", case,
                                relu, seed=len(results))
        # the route conv_route names, and only that one, launched
        tc = cb.conv_route(dt, c, o) == "tc"
        got = (fn.launches - n0[0], fn.launches_tc - n0[1])
        if got != (1, int(tc)):
            fail(f"conv_bn {name} {tag}: launches (all, tc) {got}, "
                 f"want (1, {int(tc)})")
        res["route"] = "tc" if tc else "simt"
        if tc:
            rows = t["z"].shape[0]
            res["tile"] = (cb.conv_tc_tile(rows, o) if kxk
                           else cb.mm_tc_tile(rows, c, o))
        results[f"{name}_{tag}"] = res
        if tag == "bf16" and name in shapes:
            main[name] = (case, t, relu)
        del case, t
        torch.cuda.empty_cache()
    if results["simt_route_c3_bf16"]["route"] != "simt" or any(
            results[f"{n}_bf16"].get("route") != "tc" for n in shapes):
        fail("conv_bn: a bf16 ResNet-50 shape missed the wgmma kernel, or "
             "the C = 3 case missed the SIMT one")

    # TF32 shown once: the f32 stage-0 3 x 3 plain conv with TF32 on,
    # against the kernel's f32 z
    case = _conv_case(torch, np.random.default_rng(10), *shapes["s0_3x3"][:7],
                      f32)
    x, w, _, _, strides, pads = case
    z = cb.conv_stats(x, w, pads)[0]
    torch.backends.cudnn.allow_tf32 = True
    try:
        zt = cb.conv_stats_reference(x, w, strides, pads)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    zr = cb.conv_stats_reference(x, w, strides, pads)[0]
    tf32_err = ((z - zt).abs().max() / zr.abs().max()).item()
    results["tf32"] = {"case": "s0_3x3_f32", "normalised_err_tf32_on":
                       tf32_err, "limit": CONV_Z_F32,
                       "tf32_exceeds_limit": tf32_err > CONV_Z_F32}
    del case, x, w, z, zt, zr
    torch.cuda.empty_cache()

    timed = {"conv_stats_by_stage": {}, "mm_stats_by_shape": {}}
    for name, (case, t, relu) in main.items():
        x, w, scale, shift, strides, pads = case
        z, stat, g, tot = t["z"], t["stat"], t["g"], t["tot"]
        xc = x.permute(0, 3, 1, 2)
        kname = "mm_stats" if tuple(w.shape[2:]) == (1, 1) else "conv_stats"
        row = {"shape": {"x": list(x.shape), "w": list(w.shape),
                         "strides": list(strides), "pads": pads,
                         "dtype": "bfloat16"},
               "library": "F.conv2d on the channels_last view (no stats)",
               "max_abs_err": results[f"{name}_bf16"]["z"]["max_abs_err"],
               "route": results[f"{name}_bf16"]["route"],
               "tile": results[f"{name}_bf16"]["tile"]}
        row.update(_timed(
            torch, flush, t["conv"],
            lambda: cb.conv_stats_reference(x, w, strides, pads),
            lambda: F.conv2d(xc, w, None, strides, pads[0][0]),
            nbytes=cb.bound_bytes_conv(x, w, strides, pads),
            flops=cb.bound_flops_conv(x, w, strides, pads),
            peak_flops=BF16_FLOPS))
        if kname == "conv_stats":
            row["tiles_ms"] = _conv_tile_sweep(torch, cb, flush, x, w, pads)
            timed["conv_stats_by_stage"][name] = row
            if name == "s0_3x3":
                timed[kname] = row
            continue
        row["tiles_ms"] = _mm_tile_sweep(torch, cb, flush, x, w, strides)
        row["simt_ms"] = _simt_ms(torch, cb, flush, x, w, strides)
        timed["mm_stats_by_shape"][name] = row
        if name != SWEEP_CASE:
            continue
        timed[kname] = row
        # the sweeps at [401408, 256] bf16 (stage 0's widest BN)
        zc = z.reshape(x.shape[0], x.shape[1], x.shape[2], -1).permute(
            0, 3, 1, 2)
        m, rstd = stat[0], stat[1]
        var = 1.0 / (rstd * rstd) - 1e-5
        shape = {"R": z.shape[0], "O": z.shape[1], "relu": relu,
                 "dtype": "bfloat16"}
        row = {"shape": shape, "library": "F.batch_norm(training=False) "
               "on the channels_last view (no ReLU)",
               "max_abs_err": results[f"{name}_bf16"]["y"]}
        row.update(_timed(
            torch, flush, lambda: cb.bn_apply(z, stat, relu),
            lambda: cb.bn_apply_reference(z, stat, relu),
            lambda: F.batch_norm(zc, m, var, stat[2], stat[3], False, 0.0,
                                 1e-5),
            nbytes=cb.bound_bytes_sweep(z, 1, 1, 4),
            flops=cb.bound_flops_sweep(z, 4), peak_flops=BF16_FLOPS))
        timed["bn_apply"] = row
        zl = zc.detach().clone().requires_grad_()
        wl = stat[2].detach().clone().requires_grad_()
        bl = stat[3].detach().clone().requires_grad_()
        lib_y = F.batch_norm(zl, None, None, wl, bl, True, 0.0, 1e-5)
        gc = g.reshape(zc.shape[0], zc.shape[2], zc.shape[3], -1).permute(
            0, 3, 1, 2)

        def lib_bwd():
            return torch.autograd.grad(lib_y, (zl, wl, bl), gc,
                                       retain_graph=True)

        lib_note = ("autograd backward of F.batch_norm(training=True) on the "
                    "channels_last view (dx, dweight, dbias: rows 13 and 14 "
                    "together; no ReLU mask)")
        row = {"shape": shape, "library": lib_note,
               "max_abs_err": max(results[f"{name}_bf16"]["dgamma"],
                                  results[f"{name}_bf16"]["dbeta"])}
        row.update(_timed(
            torch, flush, lambda: cb.bn_bwd_reduce(z, g, stat, relu),
            lambda: cb.bn_bwd_reduce_reference(z, g, stat, relu), lib_bwd,
            nbytes=cb.bound_bytes_sweep(z, 2, 0, 4) + 2 * 4 * z.shape[1],
            flops=cb.bound_flops_sweep(z, 6), peak_flops=BF16_FLOPS))
        timed["bn_bwd_reduce"] = row
        row = {"shape": shape, "library": lib_note,
               "max_abs_err": results[f"{name}_bf16"]["dz"]}
        row.update(_timed(
            torch, flush, lambda: cb.bn_bwd_dz(z, g, stat, tot, relu),
            lambda: cb.bn_bwd_dz_reference(z, g, stat, tot, relu), lib_bwd,
            nbytes=cb.bound_bytes_sweep(z, 2, 1, 6),
            flops=cb.bound_flops_sweep(z, 9), peak_flops=BF16_FLOPS))
        timed["bn_bwd_dz"] = row
        del zl, wl, bl, lib_y
    del main
    torch.cuda.empty_cache()
    return results, timed


def _resnet_train_program(cfg, batch: int, size: int, amp: bool,
                          lr: float = 0.1, fuse: bool = True):
    """ResNet training as the JAX package's bench builds it: conv+BN
    fusion on (``fuse``), Momentum ``lr`` (the bench's 0.1) / 0.9, bf16
    AMP (``decorate``) when ``amp``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.models import resnet

    flags.set_flags({"FLAGS_conv_bn_fusion": fuse})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard():
            m, st, _, loss = resnet.build_resnet_train_program(
                cfg, batch, size, main, startup)
            with fluid.program_guard(m, st):
                opt = fluid.optimizer.MomentumOptimizer(learning_rate=lr,
                                                        momentum=0.9)
                if amp:
                    opt = mixed_precision.decorate(opt, use_bf16=True)
                opt.minimize(loss)
    finally:
        flags.set_flags({"FLAGS_conv_bn_fusion": False})
    return m, st, loss


def _resnet_batch(batch: int, size: int, classes: int,
                  seed: int = 0) -> dict:
    """The bench's batch: uniform [0, 1) images and labels,
    RandomState(seed), 0 as the bench."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, classes, (batch, 1)).astype(np.int64)}


def _conv_bn_launches_per_step(program, bf16: bool = False) -> dict:
    """The conv+BN launches one step of ``program`` must make, from its
    fused ops and the kernel gate: row 10 per k x k stride-1 conv, row 11
    per 1 x 1 conv (each on the wgmma kernel, ``conv_stats_tc`` /
    ``mm_stats_tc``, where a bf16 program's shape takes it), rows 12-14
    once each per gated op; the reference route per other op."""
    from torch import bfloat16 as torch_bf16

    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.kernels import conv_bn as cb

    want = {k: 0 for k in CONV_BN_KERNELS + ("conv_stats_tc", "mm_stats_tc",
                                              "reference_routes")}
    block = program.global_block()
    for op in block.ops:
        if op.type != "fused_conv_bn":
            continue
        xs = block.var(op.input("Input")[0]).shape
        ws = block.var(op.input("Filter")[0]).shape
        strides = tuple(op.attr("strides"))
        pads = cb._resolve_pads(
            nn_ops._conv_padding(op.attr("paddings"),
                                 op.attr("padding_algorithm", "EXPLICIT"), 2),
            xs[1], xs[2], ws[2], ws[3], strides)
        if not cb.conv_bn_shapes_ok(xs, ws, strides, pads):
            want["reference_routes"] += 1
            continue
        kname = "mm_stats" if tuple(ws[2:]) == (1, 1) else "conv_stats"
        want[kname] += 1
        want[f"{kname}_tc"] += int(
            bf16 and cb.conv_route(torch_bf16, xs[3], ws[0]) == "tc")
        for k in ("bn_apply", "bn_bwd_reduce", "bn_bwd_dz"):
            want[k] += 1
    return want


def _conv_bn_counts(reset: bool = False) -> dict:
    from paddle_tpu_torch.ops.kernels import conv_bn as cb

    fns = {k: getattr(cb, k) for k in CONV_BN_KERNELS}
    fns["conv_stats_tc"] = _Counter(cb.conv_stats, "launches_tc")
    fns["mm_stats_tc"] = _Counter(cb.mm_stats, "launches_tc")
    if reset:
        for f in fns.values():
            f.launches = 0
        cb.fused_conv_bn.reference_routes = 0
    got = {k: f.launches for k, f in fns.items()}
    got["reference_routes"] = cb.fused_conv_bn.reference_routes
    return got


def phase_resnet_train(torch, card: str, n_steps: int = 10,
                       n_warm: int = 2, b: int = 128,
                       size: int = 224) -> dict:
    """ResNet-50 training on the card as the bench runs it: conv+BN
    fusion, Momentum 0.1/0.9, bf16 AMP, batch 128 at 224 x 224, one fixed
    seed-0 batch."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig.resnet50()
    t0 = time.perf_counter()
    main, startup, loss = _resnet_train_program(cfg, b, size, amp=True)
    build_s = time.perf_counter() - t0
    types = [op.type for op in main.global_block().ops]
    want = _conv_bn_launches_per_step(main, bf16=True)
    if (types.count("fused_conv_bn") != 53 or want != {
            "conv_stats": 13, "conv_stats_tc": 13, "mm_stats": 36,
            "mm_stats_tc": 36, "bn_apply": 49, "bn_bwd_reduce": 49, "bn_bwd_dz": 49,
            "reference_routes": 4}):
        fail(f"resnet_train program: {types.count('fused_conv_bn')} fused "
             f"ops, launches a step {want}")
    scope = fluid.Scope()
    exe = fluid.Executor()                        # device=None: the card
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in
                   (scope.find_var(v.name) for v in main.all_parameters()))
    feed = {k: torch.as_tensor(v, device=exe.device)
            for k, v in _resnet_batch(b, size, cfg.num_classes).items()}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(n_warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {k: 0 for k in want}
    step_ms = []
    for step in range(n_steps):
        _conv_bn_counts(reset=True)
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)  # numpy: synced
        got = _conv_bn_counts()
        if got != want:
            fail(f"resnet_train step {step} launched {got}, the program "
                 f"needs {want}")
        for k in total:
            total[k] += got[k]
        losses.append(float(lv[0]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"resnet_train losses not finite: {losses}")
    med = statistics.median(step_ms)
    flops = resnet.resnet_step_flops(cfg, b, size)
    out = {"phase": "resnet_train", "card": card,
           "config": {"depth": 50, "blocks": cfg.blocks, "classes": 1000,
                      "layout": cfg.layout, "conv_bn_fusion": True,
                      "optimizer": "Momentum 0.1 / 0.9", "amp": "bf16",
                      "batch": b, "image": size},
           "params": n_params, "program_ops": len(types),
           "fused_conv_bn_ops": types.count("fused_conv_bn"),
           "build_s": build_s, "startup_s": startup_s,
           "steps": n_steps, "warm_steps": n_warm,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "images_per_s": b / (med / 1e3),
           "step_flops": flops,
           "flops_share_of_bf16_peak": flops / (med * 1e-3) / BF16_FLOPS,
           "losses": losses, "launches_per_step": want, "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(out)
    return dict(out, exe=exe, main=main, scope=scope, feed=feed, loss=loss)


def phase_resnet_train_profile(torch, train: dict) -> dict:
    """Where a ResNet-50 training step's time goes: 3 steps under
    torch.profiler; device busy time by kernel against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    exe, main, scope = train["exe"], train["main"], train["scope"]
    feed, loss = train["feed"], train["loss"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    # one more step with the ops' input shapes recorded (outside the timed
    # window): which op launches each cuDNN layout transform
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
    transforms = {}
    for e in prof.events():
        for k in e.kernels:
            if any(t in k.name for t in ("nchwToNhwc", "nhwcToNchw",
                                         "tensorTransform")):
                key = (k.name.split("<")[0].split("::")[-1], e.name,
                       str(e.input_shapes[:3]))
                t = transforms.setdefault(key, [0, 0.0])
                t[0] += 1
                t[1] += k.duration / 1e3
    # rows 10 and 11 by their kernels' names: the wgmma kernel's last
    # template argument is true for the k x k conv, false for the 1 x 1
    shares = {"row10_conv_stats": ("conv_stats_tc_kernel<", "true>"),
              "row11_mm_stats": ("conv_stats_tc_kernel<", "false>")}
    by_row = {}
    for key, (stem, tail) in shares.items():
        ms = sum(r[0] for r in rows if stem in r[2] and tail in r[2])
        by_row[key] = {"ms_per_step": ms / 3, "share_of_busy": ms / busy_ms}
    out = {"phase": "resnet_train_profile", "steps": 3, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "conv_kernels_by_row": by_row,
           "top_kernels": [{"ms": ms, "calls": n, "name": k[:90]}
                           for ms, n, k in rows[:25]],
           "layout_transforms_one_step": [
               {"kernel": k, "op": op, "input_shapes": shapes, "calls": n,
                "ms": ms} for (k, op, shapes), (n, ms) in transforms.items()],
           "note": "window = 3 training steps of 128 x 224 x 224 (forward, "
                   "backward, Momentum, loss fetch); busy = sum of kernel "
                   "self times; layout transforms from a 4th step with "
                   "shapes recorded"}
    emit(out)
    return out


def _resnet_parity(torch, fuse: bool = True, steps: int = 3, b: int = 8,
                   size: int = 64, lr: float = PARITY_LR) -> dict:
    """ResNet-50 widths at batch 8, 64 x 64, f32: the training program on
    the card (kernels) and on the CPU (plain versions) from the same
    weights.
    The first step's loss (the forward), its gradients (the Momentum
    velocities after one step equal them) and its batch statistics (in
    the moving statistics) are compared; the later steps' losses are
    reported."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig.resnet50()
    # fuse=False: conv2d + batch_norm + relu, the library's own card-vs-CPU
    # gap beside the kernels'
    main, startup, loss = _resnet_train_program(cfg, b, size, False, lr,
                                               fuse)
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope.from_numpy(
        {n: v.numpy() for n, v in cpu_scope.vars.items()})
    card_exe = fluid.Executor()
    feed = _resnet_batch(b, size, cfg.num_classes)
    before = _conv_bn_counts()
    card, cpu, first = [], [], {}

    def rel(names):
        num = den = 0.0
        for n in names:
            ref = cpu_scope.find_var(n).double()
            num += float(((card_scope.find_var(n).cpu().double() - ref)
                          ** 2).sum())
            den += float((ref ** 2).sum())
        return math.sqrt(num / den)

    grads = [n for n in cpu_scope.vars if n.endswith("_velocity_0")]
    stats = [n for op in main.global_block().ops
             if op.type in ("fused_conv_bn", "batch_norm")
             for n in op.input("Mean") + op.input("Variance")]
    for step in range(steps):
        card.append(float(card_exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=card_scope)[0][0]))
        cpu.append(float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu_scope)[0][0]))
        if step == 0:
            first = {"grad_rel": rel(grads), "moving_stat_rel": rel(stats)}
    after = _conv_bn_counts()
    if fuse and any(after[k] == before[k] for k in CONV_BN_KERNELS):
        fail(f"resnet parity on the card missed a conv+BN kernel: {before} "
             f"-> {after}")
    return {"fused": fuse, "loss_card": card, "loss_cpu": cpu,
            "first_loss_diff": abs(card[0] - cpu[0]),
            "loss_diff_by_step": [abs(a - c) for a, c in zip(card, cpu)],
            "first_step_grad_rel": first["grad_rel"],
            "first_step_moving_stat_rel": first["moving_stat_rel"]}


def _rel(a, b) -> float:
    """||a - b|| / ||b||, in float64 on the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _resnet_bf16_seed(torch, seed: int, b: int = 8, size: int = 64,
                      local: bool = False) -> dict:
    """bf16 AMP at ResNet-50 widths, batch 8 at 64 x 64: the first step's
    forward from seed-``seed`` weights and batch on three paths, the fused
    program on the card (the kernels) and on the CPU (their plain
    versions), and the unfused program (library conv2d, batch_norm, relu)
    on the card.  Gives the first losses and, for the 53 conv+BN outputs
    in program order, the relative L2 distance between the paths.  With
    ``local``, each gated op is run again from its own inputs of that
    step: the kernels and the library composition on the card against the
    plain versions on the CPU, the error one op adds by itself."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.kernels import conv_bn as cb

    cfg = resnet.ResNetConfig.resnet50()
    fused, startup, loss = _resnet_train_program(cfg, b, size, True,
                                                 PARITY_LR)
    lib, _, lib_loss = _resnet_train_program(cfg, b, size, True, PARITY_LR,
                                             fuse=False)
    startup.random_seed = seed
    init = fluid.Scope()
    fluid.Executor(device="cpu").run(startup, scope=init)
    weights = {n: v.numpy() for n, v in init.vars.items()}
    feed = _resnet_batch(b, size, cfg.num_classes, seed)
    ops = [op for op in fused.global_block().ops
           if op.type == "fused_conv_bn"]
    outs = [op.output("Y")[0] for op in ops]
    ins = [n for k in ("Input", "Filter") for op in ops
           for n in op.input(k)] if local else []

    def run(program, lv, names, device):
        scope = fluid.Scope.from_numpy(weights, device=device)
        got = fluid.Executor(device=device).run(
            program, feed=feed, fetch_list=[lv] + names, scope=scope,
            return_numpy=False)
        return float(got[0].reshape(-1)[0]), got[1:]

    card_loss, card = run(fused, loss, outs + ins, None)
    library_loss, library = run(lib, lib_loss, outs, None)
    cpu_loss, cpu = run(fused, loss, outs, "cpu")
    out = {"seed": seed, "first_loss": {"kernels_card": card_loss,
                                        "library_card": library_loss,
                                        "cpu": cpu_loss},
           "first_loss_diff": abs(card_loss - cpu_loss),
           "library_first_loss_diff": abs(library_loss - cpu_loss),
           "kernels_vs_library_first_loss": abs(card_loss - library_loss),
           "layers": {
               "kernels_vs_library": [_rel(k, l)
                                      for k, l in zip(card, library)],
               "library_card_vs_cpu": [_rel(l, c)
                                       for l, c in zip(library, cpu)],
               "kernels_card_vs_cpu": [_rel(k, c)
                                       for k, c in zip(card, cpu)]}}
    if not local:
        return out
    n, rows = len(ops), []
    for i, op in enumerate(ops):
        x, w = card[n + i], card[2 * n + i]
        strides = tuple(op.attr("strides"))
        pads = cb._resolve_pads(
            nn_ops._conv_padding(op.attr("paddings"),
                                 op.attr("padding_algorithm", "EXPLICIT"), 2),
            x.shape[1], x.shape[2], w.shape[2], w.shape[3], strides)
        if not cb.conv_bn_shapes_ok(tuple(x.shape), tuple(w.shape), strides,
                                    pads):
            continue
        kw = dict(strides=strides, pads=pads, eps=op.attr("epsilon"),
                  with_relu=bool(op.attr("with_relu")))
        sb = [torch.as_tensor(weights[op.input(k)[0]])
              for k in ("Scale", "Bias")]
        xc, wc = x.cpu(), w.cpu()
        with torch.no_grad():
            yk = cb.fused_conv_bn(x, w, *(t.cuda() for t in sb), **kw)[0]
            yl = cb.conv_bn_reference(x, w, *(t.cuda() for t in sb), **kw)[0]
            yp = cb.fused_conv_bn(xc, wc, *sb, **kw)[0]
            # the fault the limit must catch: statistics of the unrounded
            # f32 z instead of the stored bf16 z (the plain versions, CPU)
            z = cb.conv_stats_reference(xc.float(), wc.float(), strides,
                                        pads)[0]
            m = z.mean(0)
            v = torch.clamp_min((z * z).mean(0) - m * m, 0.0)
            stat = torch.stack([m, torch.rsqrt(v + kw["eps"]), *sb])
            yf = cb.bn_apply_reference(z.to(x.dtype), stat,
                                       kw["with_relu"]).reshape(yp.shape)
        rows.append({"op": i, "w": list(w.shape), "strides": list(strides),
                     "kernels_vs_cpu": _rel(yk, yp),
                     "library_vs_cpu": _rel(yl, yp),
                     "kernels_vs_library": _rel(yk, yl),
                     "unrounded_stats_vs_cpu": _rel(yf, yp)})
    out["local"] = rows
    return out


def phase_resnet_train_parity(torch) -> dict:
    f32 = _resnet_parity(torch)
    library = _resnet_parity(torch, fuse=False)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _resnet_parity(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    amp = [_resnet_bf16_seed(torch, seed, local=seed == 0)
           for seed in RESNET_BF16_SEEDS]
    local = amp[0]["local"]
    limits = {"f32_first_loss": RESNET_PARITY_LOSS,
              "f32_first_grad_rel": RESNET_PARITY_GRAD,
              "f32_first_moving_stat_rel": RESNET_PARITY_STAT,
              "bf16_first_loss": RESNET_PARITY_LOSS_BF16,
              "bf16_local_y_rel": RESNET_LOCAL_BF16}
    got = {"f32_first_loss": f32["first_loss_diff"],
           "f32_first_grad_rel": f32["first_step_grad_rel"],
           "f32_first_moving_stat_rel": f32["first_step_moving_stat_rel"],
           "bf16_first_loss": max(a["first_loss_diff"] for a in amp),
           "bf16_local_y_rel": max(r["kernels_vs_cpu"] for r in local)}
    out = {"phase": "resnet_train_parity", "batch": 8, "image": 64,
           "steps": 3, "lr": PARITY_LR, "f32": f32,
           "f32_library_only": library, "f32_tf32_on": tf32,
           "amp_bf16_by_seed": amp, "limits": limits, "held": got,
           "bf16_library_first_loss_max": max(
               a["library_first_loss_diff"] for a in amp),
           "bf16_local_library_max": max(r["library_vs_cpu"]
                                         for r in local),
           "bf16_local_unrounded_stats_min": min(
               r["unrounded_stats_vs_cpu"] for r in local),
           "unrounded_stats_exceeds_limit": max(
               r["unrounded_stats_vs_cpu"] for r in local)
           > RESNET_LOCAL_BF16,
           "tf32_exceeds_limit": {
               "first_loss": tf32["first_loss_diff"] > RESNET_PARITY_LOSS,
               "first_grad_rel": tf32["first_step_grad_rel"]
               > RESNET_PARITY_GRAD,
               "first_moving_stat_rel": tf32["first_step_moving_stat_rel"]
               > RESNET_PARITY_STAT}}
    emit(out)
    for name, limit in limits.items():
        if not math.isfinite(got[name]) or got[name] > limit:
            fail(f"ResNet-50 training card vs CPU, {name}: {got[name]} > "
                 f"{limit}")
    return out


def phase_resnet_infer(torch, card: str, n_runs: int = 10, b: int = 32,
                       size: int = 224) -> dict:
    """The frozen ResNet-50 served on the card: freeze_program folds each
    conv+BN pair into the conv's weights (is_test), so no conv+BN kernel
    runs here; f32, batch 32 at 224 x 224."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import ServingPredictor, freeze_program
    from paddle_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig.resnet50()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("image", [b, 3, size, size],
                                append_batch_size=False)
        logits = resnet.resnet(cfg, img)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    frozen = freeze_program(main, scope=scope, fetch_list=[logits])
    if frozen.fused_conv_bn != 53:
        fail(f"freeze_program folded {frozen.fused_conv_bn} conv+BN pairs, "
             f"want 53")
    pred = ServingPredictor(frozen)
    feed = {"image": _resnet_batch(b, size, 1000)["image"]}
    pred.run(feed)
    torch.cuda.synchronize()
    _conv_bn_counts(reset=True)
    run_ms = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        (out,) = pred.run(feed)                   # numpy fetch: synchronises
        run_ms.append((time.perf_counter() - t0) * 1e3)
        if out.shape != (b, 1000) or not np.isfinite(out).all():
            fail(f"resnet_infer logits {out.shape} or non-finite")
    launched = _conv_bn_counts()
    if any(launched.values()):
        fail(f"the folded ResNet-50 launched conv+BN kernels: {launched}")
    med = statistics.median(run_ms)
    out = {"phase": "resnet_infer", "card": card,
           "config": {"depth": 50, "dtype": "float32", "batch": b,
                      "image": size},
           "frozen_ops": len(frozen.program.global_block().ops),
           "folded_conv_bn": frozen.fused_conv_bn, "runs": n_runs,
           "run_ms_median": med, "run_ms_min": min(run_ms),
           "run_ms_max": max(run_ms), "images_per_s": b / (med / 1e3),
           "conv_bn_launches": launched,
           "note": "no conv+BN kernel runs on this path: the fold leaves one "
                   "library conv and one bias add per pair"}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the image-classification recipe: ResNet-50 with the reference recipe's
# smoothed-label head (PaddleCV image_classification build_model.py)
# ---------------------------------------------------------------------------

# training as the recipe runs it: Momentum 0.1 / 0.9 with L2Decay(1e-4),
# label smoothing 0.1, conv+BN fusion, bf16 AMP, at resnet_train's batch
# (128 at 224 x 224, _resnet_batch's seed-0 data); 2 warm steps, 5 timed
RECIPE = dict(batch=128, size=224, lr=0.1, momentum=0.9, l2=1e-4,
              epsilon=0.1, warm=2, steps=5)
# the conv+BN launches a ResNet-50 step needs (resnet_train's, bf16)
RESNET50_LAUNCHES = {"conv_stats": 13, "conv_stats_tc": 13, "mm_stats": 36,
                     "mm_stats_tc": 36, "bn_apply": 49, "bn_bwd_reduce": 49,
                     "bn_bwd_dz": 49, "reference_routes": 4}
# parity, f32 with TF32 off, batch 8 at 64 x 64, 3 steps card vs CPU from
# one scope at resnet_train_parity's learning rate (PARITY_LR: at 0.1
# eight images at 64 x 64 diverge within three steps): the first step's
# loss (the forward through the head, before any update) held as
# resnet_train_parity holds its own (RESNET_PARITY_LOSS), the later
# steps reported; TF32 on is shown to exceed it
RECIPE_PARITY = dict(batch=8, size=64, steps=3)


def _recipe_program(cfg, batch: int, size: int, amp: bool, lr: float):
    """ResNet -> one_hot -> label_smooth -> softmax ->
    cross_entropy(soft_label=True) -> mean, with accuracy at k 1 and 5,
    through the port's entry points (``program_guard``, ``fluid.layers``,
    ``MomentumOptimizer`` with ``L2Decay``, ``decorate`` for AMP)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.models import resnet

    L = fluid.layers
    flags.set_flags({"FLAGS_conv_bn_fusion": True})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = L.data("image", [batch, 3, size, size],
                         append_batch_size=False)
            label = L.data("label", [batch, 1], dtype="int64",
                           append_batch_size=False)
            logits = resnet.resnet(cfg, img)
            soft = L.label_smooth(L.one_hot(label, cfg.num_classes),
                                  epsilon=RECIPE["epsilon"])
            probs = L.softmax(logits)
            loss = L.mean(L.cross_entropy(probs, soft, soft_label=True))
            acc1 = L.accuracy(probs, label, k=1)
            acc5 = L.accuracy(probs, label, k=5)
            opt = fluid.optimizer.MomentumOptimizer(
                learning_rate=lr, momentum=RECIPE["momentum"],
                regularization=fluid.regularizer.L2Decay(RECIPE["l2"]))
            if amp:
                opt = mixed_precision.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    finally:
        flags.set_flags({"FLAGS_conv_bn_fusion": False})
    return main, startup, [loss, acc1, acc5, probs]


def _topk_accuracy(probs: np.ndarray, label: np.ndarray, k: int):
    """The share of rows whose label is among their k largest, ties to
    the lower index (the port's top_k), as float32."""
    n = probs.shape[0]
    hit = 0
    for i in range(n):
        row, lb = probs[i], int(label[i, 0])
        rank = int((row > row[lb]).sum() + (row[:lb] == row[lb]).sum())
        hit += rank < k
    return np.float32(hit) / np.float32(n)


def _recipe_parity(torch) -> tuple:
    """The recipe in f32 at RECIPE_PARITY from one CPU-initialised scope:
    3 steps on the card with TF32 off, 3 more from the same scope with it
    on, and 3 on the CPU (which has no TF32): (f32, tf32) results."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    c = RECIPE_PARITY
    cfg = resnet.ResNetConfig.resnet50()
    main, startup, fetch = _recipe_program(cfg, c["batch"], c["size"],
                                           False, PARITY_LR)
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    state = {n: v.numpy() for n, v in cpu_scope.vars.items()}
    feed = _resnet_batch(c["batch"], c["size"], cfg.num_classes)

    def steps(exe, scope):
        return [[float(v.reshape(-1)[0]) for v in exe.run(
            main, feed=feed, fetch_list=fetch[:3], scope=scope)]
            for _ in range(c["steps"])]

    card = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            card[tf32] = steps(fluid.Executor(), fluid.Scope.from_numpy(state))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    cpu = steps(cpu_exe, cpu_scope)

    def cmp(rows):
        return {"loss_card": [r[0] for r in rows],
                "loss_cpu": [r[0] for r in cpu],
                "acc1_card": [r[1] for r in rows],
                "acc1_cpu": [r[1] for r in cpu],
                "acc5_card": [r[2] for r in rows],
                "acc5_cpu": [r[2] for r in cpu],
                "loss_gap_by_step": [abs(a[0] - b[0])
                                     for a, b in zip(rows, cpu)]}

    return cmp(card[False]), cmp(card[True])


def phase_resnet_recipe(torch, card: str) -> dict:
    """ResNet-50 (``models/resnet.py`` ``resnet(ResNetConfig.resnet50(),
    img)``) with the image-classification recipe's head, trained on the
    card through the port's entry points (RECIPE): each timed step
    launches rows 10-14 exactly as resnet_train's steps do, and its
    fetched acc1 / acc5 equal a top-k count (ties to the lower index)
    over the same step's fetched softmax of the card's logits.  Then the
    parity at RECIPE_PARITY (f32, card vs CPU from one scope, the first
    loss within RESNET_PARITY_LOSS) and with TF32 on (beyond it)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    c = RECIPE
    b, size = c["batch"], c["size"]
    cfg = resnet.ResNetConfig.resnet50()
    t0 = time.perf_counter()
    main, startup, fetch = _recipe_program(cfg, b, size, True, c["lr"])
    build_s = time.perf_counter() - t0
    types = [op.type for op in main.global_block().ops]
    want = _conv_bn_launches_per_step(main, bf16=True)
    head = {"one_hot", "label_smooth", "softmax", "cross_entropy", "top_k",
            "accuracy"}
    if types.count("fused_conv_bn") != 53 or want != RESNET50_LAUNCHES \
            or not head <= set(types):
        fail(f"resnet_recipe program: {types.count('fused_conv_bn')} fused "
             f"ops, launches a step {want}, head ops "
             f"{sorted(head & set(types))}")
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    batch = _resnet_batch(b, size, cfg.num_classes)
    feed = {k: torch.as_tensor(v, device=exe.device)
            for k, v in batch.items()}
    for _ in range(c["warm"]):
        exe.run(main, feed=feed, fetch_list=fetch[:1], scope=scope)
    torch.cuda.synchronize()
    total = {k: 0 for k in want}
    step_ms, trace = [], []
    for step in range(c["steps"]):
        _conv_bn_counts(reset=True)
        t0 = time.perf_counter()
        loss, acc1, acc5, probs = exe.run(main, feed=feed, fetch_list=fetch,
                                          scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)  # numpy: synced
        got = _conv_bn_counts()
        if got != want:
            fail(f"resnet_recipe step {step} launched {got}, the program "
                 f"needs {want}")
        for k in total:
            total[k] += got[k]
        if not np.isfinite(probs).all() or not math.isfinite(float(loss[0])):
            fail(f"resnet_recipe step {step}: loss {loss} or probs not "
                 f"finite")
        counted = {f"acc{k}": _topk_accuracy(probs, batch["label"], k)
                   for k in (1, 5)}
        fetched = {"acc1": np.float32(acc1[0]), "acc5": np.float32(acc5[0])}
        if counted != fetched:
            fail(f"resnet_recipe step {step}: accuracy {fetched}, a top-k "
                 f"count over its softmax gives {counted}")
        trace.append({"loss": float(loss[0]), "acc1": float(acc1[0]),
                      "acc5": float(acc5[0])})
    prof = _step_profile(torch, exe, main, scope, feed, fetch[0], 2,
                         "resnet_recipe, bf16, 128 x 224, after the timed "
                         "steps")
    prof["top_kernels"] = prof["top_kernels"][:8]
    t0 = time.perf_counter()
    f32, tf32 = _recipe_parity(torch)
    parity_s = time.perf_counter() - t0
    gap, gap_tf32 = f32["loss_gap_by_step"][0], tf32["loss_gap_by_step"][0]
    if not gap <= RESNET_PARITY_LOSS:
        fail(f"resnet_recipe parity: first loss card vs CPU {gap} > "
             f"{RESNET_PARITY_LOSS}")
    if not gap_tf32 > RESNET_PARITY_LOSS:
        fail(f"resnet_recipe parity: TF32 moved the first loss by "
             f"{gap_tf32}, within {RESNET_PARITY_LOSS}: the limit would not "
             f"catch it")
    med = statistics.median(step_ms)
    out = {"phase": "resnet_recipe", "card": card,
           "config": {"model": "models/resnet.py resnet(ResNetConfig."
                      "resnet50(), img)", "head": "one_hot(label, 1000) -> "
                      "label_smooth(0.1) -> softmax -> cross_entropy("
                      "soft_label=True) -> mean; accuracy k 1 and 5",
                      "optimizer": "Momentum 0.1 / 0.9, L2Decay(1e-4)",
                      "amp": "bf16", "conv_bn_fusion": True, "batch": b,
                      "image": size, "data": "_resnet_batch seed 0"},
           "program_ops": len(types), "build_s": build_s,
           "ops_by_type": dict(sorted(collections.Counter(types).items(),
                                      key=lambda kv: -kv[1])[:12]),
           "warm_steps": c["warm"], "steps": c["steps"],
           "step_ms_median": med, "step_ms": step_ms,
           "images_per_s": b / (med / 1e3), "trace": trace,
           "launches_per_step": want, "launches": total,
           "accuracy_equals_topk_count": True, "profile": prof,
           "parity": {"batch": RECIPE_PARITY["batch"],
                      "image": RECIPE_PARITY["size"], "lr": PARITY_LR,
                      "f32": f32, "tf32_on": tf32,
                      "first_loss_gap": gap, "limit": RESNET_PARITY_LOSS,
                      "first_loss_gap_tf32_on": gap_tf32,
                      "tf32_exceeds_limit": True, "seconds": parity_s},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# hapi Transformer NMT: the BHSD flash kernels (rows 6-9) behind full-bias
# attention
# ---------------------------------------------------------------------------

# Transformer-base widths (the JAX package's TransformerConfig.base(), the
# reference recipe's base model): 6 + 6 layers, d_model 512, 8 heads,
# d_inner 2048, vocabulary 30000, dropout 0.1; batch 64 at source and
# target length 256 (bench.py's NMT shapes)
NMT = dict(layers=6, d_model=512, heads=8, d_inner=2048, vocab=30000,
           dropout=0.1, batch=64, src_len=256, trg_len=256)
# nmt_train_parity's limits: f32 held to the BERT training limits (the
# same math in another order; TF32 on moves the parameters by ~1e-4,
# past them); bf16 AMP: the losses to the BERT bf16 limit, and each stack
# op's output, from the card's own inputs, within 1e-2 relative L2 of the
# CPU's (both round to bf16 at every op of six layers; the first reading
# was 1.5e-3 and 2.0e-3, and a wrong bias row or a dropped tile moves it
# by orders more)
NMT_OP_REL_BF16 = 1e-2


def _nmt_program(b, s, t, *, n_layers=NMT["layers"], dropout=NMT["dropout"],
                 amp=True, train=True, lr=1e-4):
    """The network of examples/hapi_text_nmt.py at Transformer-base widths
    as a user builds it: embeddings times sqrt(d_model),
    add_position_encoding, hapi TransformerEncoder (fed the reference
    recipe's full self-attention bias [B, n_head, S, S]) and
    TransformerDecoder (fed the [B, 1, 1, S] cross bias), an fc to the
    vocabulary, softmax cross entropy, mean; Adam (bf16 AMP when ``amp``)
    when ``train``, else the ``is_test`` network."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.hapi import text

    h, nh, f, v = NMT["d_model"], NMT["heads"], NMT["d_inner"], NMT["vocab"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        def data(name, shape, dtype="float32"):
            return layers.data(name, shape, dtype, append_batch_size=False)

        src, trg = data("src_ids", [b, s], "int64"), data("trg_ids", [b, t],
                                                          "int64")
        lbl = data("lbl", [b, t, 1], "int64")
        self_bias = data("src_slf_attn_bias", [b, nh, s, s])
        cross_bias = data("trg_src_attn_bias", [b, 1, 1, s])
        drop = dict(prepostprocess_dropout=dropout,
                    attention_dropout=dropout, relu_dropout=dropout)
        enc = text.TransformerEncoder(n_layers, nh, d_model=h,
                                      d_inner_hid=f, name="enc", **drop)
        dec = text.TransformerDecoder(n_layers, nh, d_model=h,
                                      d_inner_hid=f, name="dec", **drop)

        def embed(ids, name):
            return layers.add_position_encoding(layers.scale(
                layers.embedding(ids, size=[v, h],
                                 param_attr=fluid.ParamAttr(name=name)),
                scale=h ** 0.5), alpha=1.0, beta=1.0)

        out = dec(embed(trg, "trg_emb"),
                  enc(embed(src, "src_emb"), self_bias, is_test=not train),
                  cross_bias, is_test=not train)
        logits = layers.fc(out, v, num_flatten_dims=2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, lbl))
        if train:
            opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
            if amp:
                opt = mixed_precision.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return main, startup, loss, logits


def _nmt_batch(b, s, t, seed=0, min_len=128) -> dict:
    """Random ids from ``seed``: source lengths min_len..S (id 0 pads),
    the reference recipe's biases (pad_batch_data: -1e4 at padded keys,
    tiled to [B, n_head, S, S] for the encoder's self-attention)."""
    nh, v = NMT["heads"], NMT["vocab"]
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, s + 1, b)
    live = np.arange(s)[None, :] < lens[:, None]
    key = np.where(live, 0.0, -1e4).astype(np.float32)
    return {"src_ids": np.where(live, rng.integers(2, v, (b, s)), 0),
            "trg_ids": rng.integers(2, v, (b, t)),
            "lbl": rng.integers(2, v, (b, t, 1)),
            "src_slf_attn_bias": np.ascontiguousarray(np.broadcast_to(
                key[:, None, None, :], (b, nh, s, s))),
            "trg_src_attn_bias": key[:, None, None, :]}


def _count_step(counters, fn):
    """Run ``fn`` with every counter set to 0 just before; the launches it
    made."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def _train_steps(torch, what, exe, main, scope, feed, loss, want,
                 n_steps, n_warm=0) -> tuple:
    """``n_warm`` steps (cuBLAS, the allocator), the peak memory reset,
    then ``n_steps`` steps, each with every launch counter set to 0 just
    before it and held to ``want`` just after; fails on a loss that is
    not finite.  Returns (losses, step ms, launches summed)."""
    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0][0])

    losses = [step() for _ in range(n_warm)]
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    total = dict.fromkeys(counters, 0)
    step_ms = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        lv, got = _count_step(counters, step)       # numpy fetch: synced
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if got != want:
            fail(f"{what} step {i} launched {got}, the program needs "
                 f"{want}")
        for k in total:
            total[k] += got[k]
        losses.append(lv)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what} losses not finite: {losses}")
    return losses, step_ms, total


def phase_nmt_train(torch, card: str, n_steps: int = 10, n_warm: int = 2,
                    b: int = NMT["batch"], s: int = NMT["src_len"],
                    t: int = NMT["trg_len"],
                    n_layers: int = NMT["layers"]) -> dict:
    """hapi Transformer-base NMT training on the card: bf16 AMP, Adam
    1e-4, dropout 0.1, 64 x 256 -> 256, the encoder's full self-attention
    bias through rows 6, 8 and 9, on one fixed seed-0 batch: 2 warm steps,
    then 10 timed; every loss finite, the loss falling, and every step
    launching each kernel exactly as the program needs."""
    from paddle_tpu_torch import fluid

    t0 = time.perf_counter()
    main, startup, loss, _ = _nmt_program(b, s, t, n_layers=n_layers)
    build_s = time.perf_counter() - t0
    want = _launches_per_step(main, bf16=True)
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for p in
                   (scope.find_var(v.name) for v in main.all_parameters()))
    feed = {k: torch.as_tensor(v, device=exe.device)
            for k, v in _nmt_batch(b, s, t, seed=0).items()}

    losses, step_ms, total = _train_steps(
        torch, "nmt_train", exe, main, scope, feed, loss, want, n_steps,
        n_warm)
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        fail(f"nmt_train loss did not fall on a fixed batch: {losses}")
    med = statistics.median(step_ms)
    out = {"phase": "nmt_train", "card": card,
           "config": dict(NMT, layers=n_layers, batch=b, src_len=s,
                          trg_len=t, optimizer="Adam 1e-4", amp="bf16",
                          encoder_bias="full [B, 8, S, S] (tiled padding)",
                          cross_bias="[B, 1, 1, S]", src_lengths="128..256"),
           "params": n_params, "program_ops": len(main.global_block().ops),
           "build_s": build_s, "steps": n_steps, "warm_steps": n_warm,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms),
           "trg_tokens_per_s": b * t / (med / 1e3),
           "src_trg_tokens_per_s": b * (s + t) / (med / 1e3),
           "losses": losses, "launches_per_step": want, "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(out)
    return dict(out, exe=exe, main=main, scope=scope, feed=feed, loss=loss)


def phase_nmt_train_profile(torch, train: dict) -> dict:
    """Where an NMT training step's time goes: 3 steps under
    torch.profiler; device busy time by kernel against the wall time."""
    out = {"phase": "nmt_train_profile", **_step_profile(
        torch, train["exe"], train["main"], train["scope"], train["feed"],
        train["loss"], 3, "window = 3 NMT training steps of 64 x 256 -> 256 "
        "(forward, backward, Adam, loss fetch)")}
    emit(out)
    return out


def _nmt_parity_run(torch, amp: bool, b: int, s: int, n_layers: int,
                    steps: int = 3, op_by_op: bool = False) -> dict:
    """The training program at Transformer-base widths, ``n_layers`` + ``n_layers``
    layers, b x s -> s, dropout 0, on the card (kernels) and on the CPU
    (plain versions) from the same weights: the losses of every step and a
    few parameters after the last.  With ``op_by_op``, each stack op of
    the first step is run again from the card's own inputs on the card
    and on the CPU: the error it adds by itself."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops import registry

    main, startup, loss, _ = _nmt_program(b, s, s, n_layers=n_layers,
                                          dropout=0.0, amp=amp)
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope.from_numpy(
        {n: v.numpy() for n, v in cpu_scope.vars.items()})
    card_exe = fluid.Executor()
    feed = _nmt_batch(b, s, s, seed=3, min_len=s // 2)
    ops = [op for op in main.global_block().ops
           if op.type in ("fused_encoder_stack", "fused_decoder_stack")]
    in_names = sorted({n for op in ops for ns in op.inputs.values()
                       for n in ns}) if op_by_op else []
    card, cpu, local = [], [], []
    for i in range(steps):
        got = card_exe.run(main, feed=feed, fetch_list=[loss] + in_names,
                           scope=card_scope, return_numpy=False)
        card.append(float(got[0].reshape(-1)[0]))
        cpu.append(float(cpu_exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=cpu_scope)[0][0]))
        if i == 0 and op_by_op:
            env = dict(zip(in_names, got[1:]))
            for op in ops:
                ins = {k: [env[n] for n in ns] for k, ns in op.inputs.items()
                       if ns}
                spec = registry.get(op.type)
                with torch.no_grad():
                    yk = spec.emit(
                        registry.EmitContext(device=card_exe.device), ins,
                        dict(op.attrs))["Out"][0]
                    yp = spec.emit(registry.EmitContext(device="cpu"),
                                   {k: [x.cpu() for x in v]
                                    for k, v in ins.items()},
                                   dict(op.attrs))["Out"][0]
                local.append({"op": op.type, "dtype": str(yk.dtype),
                              "kernels_card_vs_cpu": _rel(yk, yp)})
    params = {}
    for n in ("enc.qkv_w", "enc.ffn_w2", "dec.cross_k_w", "dec.ln3_s",
              "src_emb", "trg_emb"):
        params[n] = float((card_scope.find_var(n).cpu().float()
                           - cpu_scope.find_var(n).float()).abs().max())
    out = {"loss_card": card, "loss_cpu": cpu,
           "loss_diff": max(abs(a - c) for a, c in zip(card, cpu)),
           "param_diff": params}
    if op_by_op:
        out["op_by_op"] = local
    return out


def phase_nmt_train_parity(torch, b: int = 2, s: int = 128,
                           n_layers: int = 2) -> dict:
    """The NMT training program at Transformer-base widths with 2 + 2
    layers, batch 2 at 128 -> 128, dropout 0, 3 Adam steps on the card
    against the CPU: f32 with TF32 off (then on, to show the limits catch
    it); bf16 AMP: the losses, and each stack op from the same inputs."""
    counters = _counters()
    n0 = {k: c.launches for k, c in counters.items()}
    f32 = _nmt_parity_run(torch, False, b, s, n_layers)
    missed = [k for k in ("row6", "row8", "row9", "bsh_fwd", "bsh_bwd",
                          "ln_fwd", "ln_bwd")
              if counters[k].launches == n0[k]]
    if missed:
        fail(f"the f32 NMT parity run on the card missed kernels {missed}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _nmt_parity_run(torch, False, b, s, n_layers)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    amp = _nmt_parity_run(torch, True, b, s, n_layers, op_by_op=True)
    missed = [k for k in ("row6_tc", "row8_tc", "row9_tc")
              if counters[k].launches == n0[k]]
    if missed:
        fail(f"the bf16 NMT parity run on the card missed kernels {missed}")
    checks = [("f32 loss", f32["loss_diff"], TRAIN_PARITY_LOSS),
              ("f32 params", max(f32["param_diff"].values()),
               TRAIN_PARITY_PARAM),
              ("bf16 loss", amp["loss_diff"], TRAIN_PARITY_LOSS_BF16)] + [
        (f"bf16 {r['op']}", r["kernels_card_vs_cpu"], NMT_OP_REL_BF16)
        for r in amp["op_by_op"]]
    for name, diff, limit in checks:
        if not math.isfinite(diff) or diff > limit:
            fail(f"NMT training card vs CPU, {name}: {diff} > {limit}")
    out = {"phase": "nmt_train_parity", "batch": b, "len": s,
           "layers": n_layers, "steps": 3, "f32": f32, "f32_tf32_on": tf32,
           "amp_bf16": amp,
           "limits": {"f32_loss": TRAIN_PARITY_LOSS,
                      "f32_param": TRAIN_PARITY_PARAM,
                      "bf16_loss": TRAIN_PARITY_LOSS_BF16,
                      "bf16_op_rel_l2": NMT_OP_REL_BF16},
           "tf32_exceeds_limit": (
               tf32["loss_diff"] > TRAIN_PARITY_LOSS
               or max(tf32["param_diff"].values()) > TRAIN_PARITY_PARAM)}
    if not out["tf32_exceeds_limit"]:
        fail(f"TF32 on stayed within the f32 NMT limits: {tf32}")
    emit(out)
    return out


def phase_nmt_infer(torch, card: str, n_runs: int = 10, b: int = 8,
                    s: int = NMT["src_len"],
                    n_layers: int = NMT["layers"]) -> dict:
    """The frozen ``is_test`` NMT (freeze_program + ServingPredictor) on
    the card at Transformer-base widths, f32, batch 8 at 256 -> 256,
    fetching the logits: every run launches row 6 once a layer."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.inference import ServingPredictor, freeze_program

    main, startup, _, logits = _nmt_program(b, s, s, n_layers=n_layers,
                                            train=False, amp=False)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    feeds = ["src_ids", "trg_ids", "src_slf_attn_bias", "trg_src_attn_bias"]
    frozen = freeze_program(main, scope=scope, feed_names=feeds,
                            fetch_list=[logits])
    want = _launches_per_step(frozen.program)
    pred = ServingPredictor(frozen)
    batch = _nmt_batch(b, s, s, seed=1)
    feed = {k: batch[k] for k in feeds}
    pred.run(feed)
    torch.cuda.synchronize()
    counters = _counters()
    total = dict.fromkeys(counters, 0)
    run_ms = []
    for i in range(n_runs):
        t0 = time.perf_counter()
        (out,), got = _count_step(counters, lambda: pred.run(feed))
        run_ms.append((time.perf_counter() - t0) * 1e3)
        if got != want:
            fail(f"nmt_infer run {i} launched {got}, the program needs "
                 f"{want}")
        if out.shape != (b, s, NMT["vocab"]) or not np.isfinite(out).all():
            fail(f"nmt_infer logits {out.shape} or non-finite")
        for k in total:
            total[k] += got[k]
    # the same runs without the numpy fetch of the 246 MB of logits
    dev_ms = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        pred.run(feed, return_numpy=False)
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(run_ms)
    out = {"phase": "nmt_infer", "card": card,
           "config": dict(NMT, layers=n_layers, batch=b, src_len=s,
                          trg_len=s, dtype="float32", dropout=0.0),
           "frozen_ops": len(frozen.program.global_block().ops),
           "runs": n_runs, "run_ms_median": med, "run_ms_min": min(run_ms),
           "run_ms_max": max(run_ms),
           "sentences_per_s": b / (med / 1e3),
           "run_ms_without_fetch_median": statistics.median(dev_ms),
           "launches_per_run": want, "launches": total,
           "note": "run = feed copy, the frozen ops, and the [8, 256, "
                   "30000] f32 logits fetched to numpy (246 MB)"}
    emit(out)
    return out


def phase_mha_key_train(torch, card: str, n_steps: int = 3, b: int = 64,
                        s: int = 256) -> dict:
    """hapi MultiHeadAttention at d_model 512, 8 heads, batch 64 at 256,
    with a padding bias shared over the batch ([1, 1, 1, S]: the BSH
    kernels refuse it), attention dropout 0.1, bf16 AMP, Adam 1e-4: 3
    steps with causal off and 3 with it on, each step launching row 6
    and row 7 once, both on their wgmma kernels."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.hapi import text

    h = NMT["d_model"]
    rng = np.random.default_rng(5)
    key = np.where(np.arange(s) < s - 64, 0.0, -1e4).astype(np.float32)
    feed = {"x": rng.standard_normal((b, s, h)).astype(np.float32),
            "bias": key[None, None, None, :]}
    counters = _counters()
    out = {"phase": "mha_key_train", "card": card,
           "config": {"d_model": h, "heads": NMT["heads"], "batch": b,
                      "seq": s, "bias": "[1, 1, 1, S], last 64 keys -1e4",
                      "attn_dropout": 0.1, "amp": "bf16",
                      "optimizer": "Adam 1e-4"}, "runs": {}}
    total = dict.fromkeys(counters, 0)
    for causal in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = layers.data("x", [b, s, h], append_batch_size=False)
            bias = layers.data("bias", [1, 1, 1, s], append_batch_size=False)
            y = text.MultiHeadAttention(d_model=h, n_head=NMT["heads"],
                                        dropout_rate=0.1)(
                x, attn_bias=bias, causal=causal)
            loss = layers.mean(layers.elementwise_mul(y, y))
            mixed_precision.decorate(fluid.optimizer.AdamOptimizer(1e-4),
                                     use_bf16=True).minimize(loss)
        want = _launches_per_step(main, bf16=True)
        if (want["row6"], want["row7"]) != (1, 1):
            fail(f"mha_key_train causal={causal}: the program needs "
                 f"{want}, not one launch each of rows 6 and 7")
        scope, exe = fluid.Scope(), fluid.Executor()
        exe.run(startup, scope=scope)
        dfeed = {k: torch.as_tensor(v, device=exe.device)
                 for k, v in feed.items()}
        losses, step_ms = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            (lv,), got = _count_step(counters, lambda: exe.run(
                main, feed=dfeed, fetch_list=[loss], scope=scope))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if got != want:
                fail(f"mha_key_train causal={causal} step {i} launched "
                     f"{got}, the program needs {want}")
            for k in total:
                total[k] += got[k]
            losses.append(float(lv[0]))
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"mha_key_train causal={causal} losses {losses}")
        out["runs"]["causal" if causal else "full"] = {
            "losses": losses, "step_ms": step_ms, "launches_per_step": want}
    out["launches"] = total
    emit(out)
    return out


# ---------------------------------------------------------------------------
# bench.py's Transformer-base NMT (models/transformer.py) and BERT-base at
# s4096 / b8 through the remat ladder
# ---------------------------------------------------------------------------

TRANSFORMER = dict(batch=64, src_len=256, trg_len=256)
# transformer_train_parity, f32 with TF32 off: the first step's logits
# (the same weights on both sides), relative L2 card vs CPU.  The first
# reading was 5.1e-7 (the same math in another summation order); TF32 on
# moved them by 3.5e-4 but the loss by only 1.1e-5, under
# TRAIN_PARITY_LOSS: the random-init logits are small and their errors
# average out over 256 tokens.  So the logits catch TF32, the loss does not
TRANSFORMER_PARITY_LOGITS = 2e-5


def _transformer_program(cfg, b, s, t, amp=True):
    """``build_transformer_nmt_program`` as bench.py's ``bench_transformer``
    trains it: Adam 1e-4, bf16 AMP (``decorate``) when ``amp``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = transformer.build_transformer_nmt_program(
            cfg, b, s, t, main_program=main, startup_program=startup)
        with fluid.program_guard(m, st):
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-4)
            if amp:
                opt = mixed_precision.decorate(opt, use_bf16=True)
            opt.minimize(loss)
    return m, st, loss


def phase_transformer_train(torch, card: str, n_steps: int = 10,
                            n_warm: int = 2, n_fused: int = 3) -> dict:
    """bench.py's Transformer-base NMT (``models/transformer.py``: 6 + 6
    layers, d_model 512, 8 heads, d_inner 2048, vocabularies of 30000,
    dropout 0.1, label smoothing 0.1) as ``bench_transformer`` trains it:
    unfused, flash on, Adam 1e-4, bf16 AMP, 64 x 256 -> 256 on one seed-0
    ``random_nmt_batch``; 2 warm and 10 timed steps, every loss finite,
    the loss falling, and every step launching each kernel exactly as the
    program needs (all 18 attentions on the BSH kernels); then 3 steps
    with ``fuse_stack``."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer

    b, s, t = (TRANSFORMER[k] for k in ("batch", "src_len", "trg_len"))
    cfg = transformer.TransformerConfig.base()
    t0 = time.perf_counter()
    main, startup, loss = _transformer_program(cfg, b, s, t)
    build_s = time.perf_counter() - t0
    want = _launches_per_step(main, bf16=True)
    layers = cfg.n_encoder_layers + 2 * cfg.n_decoder_layers
    if (want["bsh_fwd"], want["bsh_bwd"], want["ln_fwd"]) != (
            layers, 2 * layers, cfg.n_encoder_layers * 2
            + cfg.n_decoder_layers * 3):
        fail(f"transformer_train: the program needs {want}, not one BSH "
             f"launch an attention and one LN a residual")
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    n_params = sum(p.numel() for p in
                   (scope.find_var(v.name) for v in main.all_parameters()))
    feed = {k: torch.as_tensor(v, device=exe.device) for k, v in
            transformer.random_nmt_batch(cfg, b, s, t, seed=0).items()}
    losses, step_ms, total = _train_steps(
        torch, "transformer_train", exe, main, scope, feed, loss, want,
        n_steps, n_warm)
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        fail(f"transformer_train loss did not fall on a fixed batch: "
             f"{losses}")
    med = statistics.median(step_ms)
    flops = transformer.transformer_step_flops(cfg, b, s, t)
    out = {"phase": "transformer_train", "card": card,
           "config": dict(dataclasses.asdict(cfg), batch=b, src_len=s,
                          trg_len=t, optimizer="Adam 1e-4", amp="bf16",
                          flash=True),
           "params": n_params, "program_ops": len(main.global_block().ops),
           "build_s": build_s, "steps": n_steps, "warm_steps": n_warm,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms),
           "tokens_per_s": b * (s + t) / (med / 1e3),
           "step_flops": flops,
           "bf16_peak_share": flops / (med / 1e3) / BF16_FLOPS,
           "losses": losses, "launches_per_step": want, "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["profile"] = _step_profile(
        torch, exe, main, scope, feed, loss, 3,
        "window = 3 training steps of 64 x 256 -> 256 (forward, backward, "
        "Adam, loss fetch)")
    del main, startup, scope, exe
    torch.cuda.empty_cache()

    cfg.fuse_stack = True
    main, startup, loss = _transformer_program(cfg, b, s, t)
    fwant = _launches_per_step(main, bf16=True)
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    flosses, fms, _ = _train_steps(torch, "transformer_train fused", exe,
                                   main, scope, feed, loss, fwant, n_fused)
    out["fused"] = {"steps": n_fused, "losses": flosses, "step_ms": fms,
                    "launches_per_step": fwant}
    emit(out)
    return out


def _transformer_parity_run(torch, amp: bool, b: int, s: int,
                            n_layers: int, steps: int = 3) -> dict:
    """The Transformer-base NMT program at its widths with ``n_layers`` +
    ``n_layers`` layers, b x s -> s, dropout 0, on the card (kernels) and
    on the CPU (plain versions) from the same weights: the losses of every
    step and a few parameters after the last."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.base()
    cfg.n_encoder_layers = cfg.n_decoder_layers = n_layers
    cfg.dropout = 0.0
    main, startup, loss = _transformer_program(cfg, b, s, s, amp=amp)
    # the logits: the tied output projection, dec_out x trg_embedding^T
    (logits,) = [op.output("Out")[0] for op in main.global_block().ops
                 if op.type == "matmul" and any(
                     n.startswith("trg_embedding") for n in op.input("Y"))]
    cpu_exe, cpu_scope = fluid.Executor(device="cpu"), fluid.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    card_scope = fluid.Scope.from_numpy(
        {n: v.numpy() for n, v in cpu_scope.vars.items()})
    card_exe = fluid.Executor()
    feed = transformer.random_nmt_batch(cfg, b, s, s, seed=3)
    feed["src_mask"][-1, s // 2 + 5:] = 0.0     # one padded source row
    card, cpu, logits_rel = [], [], None
    for _ in range(steps):
        got = card_exe.run(main, feed=feed, fetch_list=[loss, logits],
                           scope=card_scope, return_numpy=False)
        want = cpu_exe.run(main, feed=feed, fetch_list=[loss, logits],
                           scope=cpu_scope, return_numpy=False)
        card.append(float(got[0].reshape(-1)[0]))
        cpu.append(float(want[0].reshape(-1)[0]))
        if logits_rel is None:      # the first step: the same weights
            logits_rel = _rel(got[1], want[1])
    params = {}
    for n in ("enc_0_q_fc.w_0", "enc_1_ffn_fc0.w_0", "enc_1_ffn_fc1.w_0",
              "dec_0_cross_key_fc.w_0", "dec_1_cross_ln_scale",
              "src_embedding", "trg_embedding"):
        diff = (card_scope.find_var(n).cpu().float()
                - cpu_scope.find_var(n).float()).abs()
        params[n] = {"max": float(diff.max()),
                     "beyond_2e-5": int((diff > 2e-5).sum()),
                     "elements": diff.numel()}
    return {"loss_card": card, "loss_cpu": cpu,
            "loss_diff": max(abs(a - c) for a, c in zip(card, cpu)),
            "logits_rel_l2": logits_rel, "param_diff": params}


def phase_transformer_train_parity(torch, b: int = 2, s: int = 128,
                                   n_layers: int = 2) -> dict:
    """The Transformer-base NMT training program with 2 + 2 layers at its
    widths, 2 x 128 -> 128, dropout 0, 3 Adam steps on the card against
    the CPU: in f32 with TF32 off the losses and the first step's logits
    (then TF32 on, to show the limits catch it), in bf16 AMP the
    losses."""
    counters = _counters()
    n0 = {k: c.launches for k, c in counters.items()}
    f32 = _transformer_parity_run(torch, False, b, s, n_layers)
    missed = [k for k in ("bsh_fwd", "bsh_bwd", "ln_fwd", "ln_bwd")
              if counters[k].launches == n0[k]]
    if missed:
        fail(f"the f32 Transformer parity run on the card missed kernels "
             f"{missed}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = _transformer_parity_run(torch, False, b, s, n_layers)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n1 = {k: c.launches for k, c in counters.items()}
    amp = _transformer_parity_run(torch, True, b, s, n_layers)
    if any(counters[k].launches == n1[k]
           for k in ("bsh_fwd_tc", "bsh_bwd_tc")):
        fail("the bf16 Transformer parity run on the card ran no wgmma "
             "flash kernel")
    # the losses are held; the parameters are reported: Adam's first
    # step moves every weight by about lr times the sign of its
    # gradient, so a weight whose gradient is ~0 on one side (a ReLU
    # unit at its kink) moves by up to 1e-4 on one side and not the other
    checks = [("f32 loss", f32["loss_diff"], TRAIN_PARITY_LOSS),
              ("f32 logits", f32["logits_rel_l2"],
               TRANSFORMER_PARITY_LOGITS),
              ("bf16 loss", amp["loss_diff"], TRAIN_PARITY_LOSS_BF16)]
    for name, diff, limit in checks:
        if not math.isfinite(diff) or diff > limit:
            fail(f"Transformer training card vs CPU, {name}: {diff} > "
                 f"{limit} (f32 {f32}, bf16 {amp})")
    out = {"phase": "transformer_train_parity", "batch": b, "len": s,
           "layers": n_layers, "steps": 3, "f32": f32, "f32_tf32_on": tf32,
           "amp_bf16": amp,
           "limits": {"f32_loss": TRAIN_PARITY_LOSS,
                      "f32_logits_rel_l2": TRANSFORMER_PARITY_LOGITS,
                      "bf16_loss": TRAIN_PARITY_LOSS_BF16},
           "tf32_exceeds_limit": (
               tf32["loss_diff"] > TRAIN_PARITY_LOSS
               or tf32["logits_rel_l2"] > TRANSFORMER_PARITY_LOGITS)}
    if not out["tf32_exceeds_limit"]:
        fail(f"TF32 on stayed within the f32 Transformer limits: {tf32}")
    emit(out)
    return out


# bench.py's remat ladder, cheapest recompute first
REMAT_LADDER = ({"remat_ffn": True}, {"remat_policy": "flash"},
                {"remat_layer": True})


def bert_step_flops(cfg, batch, seq) -> int:
    """bench.py's ``_bert_step_flops``: 6 N a token for the matmul
    parameters (forward 2 N, backward 4 N) plus 12 L S H a token for the
    attention scores and context."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    n_matmul = L * (4 * h * h + 2 * h * cfg.intermediate_size) \
        + cfg.vocab_size * h
    return (6 * n_matmul + 12 * L * seq * h) * batch * seq


def phase_bert_long_train(torch, card: str, n_steps: int = 5,
                          n_warm: int = 2, n_flash: int = 3) -> dict:
    """BERT-base pretraining at s4096 / b8 as bench.py's ``_run_bert(8,
    4096, 76, ...)`` runs it: fuse_stack, 4096 positions, Adam 1e-4, bf16
    AMP, dropout 0.1, one seed-0 ``random_pretrain_batch``.
    ``Executor.memory_analysis`` of the program under each rung of the
    ladder (their peaks must order remat_layer < "flash" < remat_ffn);
    the rung bench.py would choose (the first whose peak is at most 95%
    of the card's memory): 2 warm and 5 timed steps; then 3 steps under
    ``remat_policy="flash"``, the flash forward once a layer.  Every step
    launches each kernel exactly as its program and rung need."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    b, s, max_preds = (BERT_LONG[k] for k in ("batch", "seq", "max_preds"))
    base = bert.BertConfig.base()
    base.fuse_stack = True
    base.max_position_embeddings = max(base.max_position_embeddings, s)
    limit = torch.cuda.get_device_properties(0).total_memory
    exe, scope = fluid.Executor(), fluid.Scope()
    feed = {k: torch.as_tensor(v, device=exe.device) for k, v in
            bert.random_pretrain_batch(base, b, s, max_preds,
                                       seed=0).items()}
    programs, peaks, chosen = {}, {}, None
    for remat in REMAT_LADDER:
        name = remat.get("remat_policy") or next(iter(remat))
        cfg = dataclasses.replace(base, **remat)
        main, startup, loss = _train_program(cfg, b, s, max_preds, amp=True)
        if not scope.vars:
            # the rungs' programs hold the same parameters: one startup
            exe.run(startup, scope=scope)
        t0 = time.perf_counter()
        ma = exe.memory_analysis(main, feed=feed, fetch_list=[loss],
                                 scope=scope)
        ma["seconds"] = time.perf_counter() - t0
        peaks[name] = ma
        programs[name] = (main, loss)
        if chosen is None and ma["peak_bytes"] <= 0.95 * limit:
            chosen = name
        torch.cuda.empty_cache()
    order = [peaks[k]["peak_bytes"] for k in ("remat_layer", "flash",
                                              "remat_ffn")]
    if not order[0] < order[1] < order[2]:
        fail(f"bert_long_train: memory_analysis peaks do not order "
             f"remat_layer < flash < remat_ffn: {order}")
    if chosen is None:
        fail(f"bert_long_train: no rung fits 95% of {limit} bytes: {peaks}")
    flops = bert_step_flops(base, b, s)
    runs = {}
    for run, name, n_run, warm in (("chosen", chosen, n_steps, n_warm),
                                   ("flash", "flash", n_flash, 0)):
        main, loss = programs[name]
        want = _launches_per_step(main, bf16=True)
        if name == "flash" and want["bsh_fwd"] != base.num_hidden_layers:
            fail(f"bert_long_train: remat_policy flash needs {want}, not "
                 f"one flash forward a layer")
        losses, step_ms, total = _train_steps(
            torch, f"bert_long_train {name}", exe, main, scope, feed, loss,
            want, n_run, warm)
        med = statistics.median(step_ms)
        runs[run] = {"rung": name, "warm_steps": warm, "steps": n_run,
                     "losses": losses, "step_ms": step_ms,
                     "step_ms_median": med,
                     "tokens_per_s": b * s / (med / 1e3),
                     "bf16_peak_share": flops / (med / 1e3) / BF16_FLOPS,
                     "launches_per_step": want, "launches": total,
                     "peak_mem_gb": torch.cuda.max_memory_allocated()
                     / 2 ** 30}
        runs[run]["profile"] = _step_profile(
            torch, exe, main, scope, feed, loss, 2,
            f"window = 2 training steps of 8 x 4096 under {name} (forward, "
            f"backward, Adam, loss fetch)")
    out = {"phase": "bert_long_train", "card": card,
           "config": {"vocab": base.vocab_size, "hidden": base.hidden_size,
                      "layers": base.num_hidden_layers,
                      "heads": base.num_attention_heads,
                      "ffn": base.intermediate_size, "dropout": 0.1,
                      "fuse_stack": True, "positions": s,
                      "optimizer": "Adam 1e-4", "amp": "bf16", "batch": b,
                      "seq": s, "max_preds": max_preds},
           "device_memory_bytes": limit,
           "memory_analysis": peaks, "chosen": chosen, "step_flops": flops,
           "runs": runs}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# fit_resume: BERT-base pretraining through hapi.Model.fit, SIGTERM'd and
# resumed bit for bit
# ---------------------------------------------------------------------------

FIT = dict(batch=8, seq=512, max_preds=76, steps=12, freq=4, keep=2,
           sigterm_after=6)
FIT_FEEDS = ("input_ids", "token_type_ids", "position_ids", "input_mask",
             "mask_positions", "mask_labels", "mask_weights", "nsp_labels")
FIT_ROWS = ("bsh_fwd", "bsh_fwd_tc", "bsh_bwd", "bsh_bwd_tc", "ln_fwd",
            "ln_bwd")


def _fit_model(cfg, b: int, s: int, mp: int):
    """BERT pretraining (MLM + NSP) as bert_train trains it, written as a
    hapi.Model user writes it from models/bert.py's builders: the network
    takes the five feature inputs and returns the MLM and NSP logits, the
    loss is build_bert_pretrain_program's; Adam 1e-4 under bf16 AMP."""
    from paddle_tpu_torch import fluid, hapi
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.fluid import layers as L
    from paddle_tpu_torch.fluid.initializer import ConstantInitializer
    from paddle_tpu_torch.models import bert

    attr = fluid.ParamAttr

    def network(input_ids, token_type_ids, position_ids, input_mask,
                mask_positions):
        seq = bert.bert_encoder(cfg, input_ids, token_type_ids, position_ids,
                                input_mask, is_test=False)
        pooled = bert.bert_pooler(cfg, seq)
        picked = L.gather(L.reshape(seq, [b * s, cfg.hidden_size]),
                          mask_positions)
        trans = L.fc(picked, cfg.hidden_size,
                     param_attr=attr(name="mask_lm_trans_fc.w_0",
                                     initializer=bert._winit(cfg).initializer),
                     bias_attr=attr(name="mask_lm_trans_fc.b_0"),
                     act=cfg.hidden_act)
        trans = L.layer_norm(trans, begin_norm_axis=1,
                             param_attr=attr(name="mask_lm_trans_ln_scale"),
                             bias_attr=attr(name="mask_lm_trans_ln_bias"))
        word_emb = fluid.default_main_program().global_block().var(
            "word_embedding")
        logits = L.elementwise_add(
            L.matmul(trans, word_emb, transpose_y=True),
            L.create_parameter(shape=[cfg.vocab_size], dtype="float32",
                               name="mask_lm_out_fc.b_0",
                               default_initializer=ConstantInitializer(0.0)))
        nsp = L.fc(pooled, 2,
                   param_attr=attr(name="next_sent_fc.w_0",
                                   initializer=bert._winit(cfg).initializer),
                   bias_attr=attr(name="next_sent_fc.b_0"))
        return [logits, nsp]

    def loss(logits, nsp, mask_labels, mask_weights, nsp_labels):
        mlm = L.elementwise_mul(
            L.softmax_with_cross_entropy(logits, mask_labels), mask_weights)
        denom = L.elementwise_add(
            L.reduce_sum(mask_weights),
            L.fill_constant(shape=[1], dtype="float32", value=1e-5))
        mlm = L.elementwise_div(L.reduce_sum(mlm), denom)
        return L.elementwise_add(mlm, L.reduce_mean(
            L.softmax_with_cross_entropy(nsp, nsp_labels)))

    In = hapi.Input
    model = hapi.Model(
        network,
        [In("input_ids", [b, s], "int32"),
         In("token_type_ids", [b, s], "int32"),
         In("position_ids", [b, s], "int32"),
         In("input_mask", [b, s], "float32"),
         In("mask_positions", [b * mp], "int32")],
        [In("mask_labels", [b * mp, 1], "int32"),
         In("mask_weights", [b * mp, 1], "float32"),
         In("nsp_labels", [b, 1], "int32")])
    model.prepare(mixed_precision.decorate(
        fluid.optimizer.AdamOptimizer(learning_rate=1e-4), use_bf16=True),
        loss)
    return model


def _fit_setup(torch):
    """The fit's config, its model and its 12 batches on the card
    (random_pretrain_batch, seeds 0-11).  The attention ops' dropout salts
    are numbered from 0, as in a fresh process: this process built other
    programs before, and the children start afresh."""
    from paddle_tpu_torch.fluid.layers import nn as layers_nn
    from paddle_tpu_torch.models import bert

    layers_nn._rng_salt_counter[0] = 0
    cfg = bert.BertConfig.base()
    cfg.fuse_stack = True
    b, s, mp = FIT["batch"], FIT["seq"], FIT["max_preds"]
    model = _fit_model(cfg, b, s, mp)
    batches = [[torch.as_tensor(v[k], device="cuda") for k in FIT_FEEDS]
               for v in (bert.random_pretrain_batch(cfg, b, s, mp, seed=i)
                         for i in range(FIT["steps"]))]
    return model, batches


class _FitTrace:
    """A fit callback: each train step's loss; optionally a line a step
    on stdout (``report``), a line read from stdin after it (``paced``:
    the parent decides when the child goes on), and each step's kernel
    launches (``counters``, set to 0 at the step's start)."""

    def __init__(self, report=False, paced=False, counters=None):
        self.losses, self.launches = [], []
        self.report, self.paced, self.counters = report, paced, counters

    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch):
        pass

    def on_epoch_end(self, epoch, logs=None):
        return False

    def on_batch_begin(self, mode, step):
        for c in (self.counters or {}).values():
            c.launches = 0

    def on_batch_end(self, mode, step, logs=None):
        self.losses.append(logs["loss"])
        if self.counters:
            self.launches.append({k: c.launches
                                  for k, c in self.counters.items()})
        if self.report:
            print(f"FIT_STEP {len(self.losses)} {logs['loss'].hex()}",
                  flush=True)
        if self.paced:
            sys.stdin.readline()


def _host_state(model) -> dict:
    """Every persistable of the train program, copied to the host bit for
    bit, and the scope's step seed."""
    from paddle_tpu_torch.fluid.checkpoint import _host_array

    main = model._progs["train"][0]
    out = {v.name: _host_array(model._scope.find_var(v.name), deep=True)
           for v in main.list_vars() if v.persistable
           and model._scope.find_var(v.name) is not None}
    out["__seed__"] = model._scope._rng_seed
    return out


def _state_diff(a: dict, b: dict) -> list:
    """Names whose arrays differ in a bit (or in shape, dtype, presence)."""
    from paddle_tpu_torch.fluid.checkpoint import BF16Array

    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if isinstance(x, BF16Array) or isinstance(y, BF16Array):
            same = x == y
        elif isinstance(x, np.ndarray) and isinstance(y, np.ndarray):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and x.tobytes() == y.tobytes())
        else:
            same = x == y
        if not same:
            bad.append(k)
    return bad


def _fit_child(root: str, role: str) -> int:
    """One child of fit_resume: ``preempt`` runs the fit with checkpoints
    under ``root``, paced a step at a time by the parent, which sends the
    SIGTERM; ``resume`` resumes from ``root`` to the end, counting every
    step's launches, and prints its trace as FIT_DONE."""
    import torch

    from paddle_tpu_torch.fluid import checkpoint as ckpt

    if not torch.cuda.is_available():
        fail("the fit child needs the CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, batches = _fit_setup(torch)
    kw = dict(epochs=1, verbose=0, checkpoint_dir=root,
              checkpoint_freq=FIT["freq"], checkpoint_keep=FIT["keep"])
    if role == "preempt":
        trace = _FitTrace(report=True, paced=True)
        try:
            model.fit(batches, callbacks=[trace], **kw)
        except ckpt.Preempted:
            mgr = model._checkpoint_manager(root)
            print("FIT_DONE " + json.dumps(
                {"losses": [x.hex() for x in trace.losses],
                 "final_save": mgr.last_save}), flush=True)
            return ckpt.PREEMPTED_EXIT_CODE
        fail("the preempt child's fit ran to its end without the SIGTERM")
    counters = {k: c for k, c in _counters().items() if k in FIT_ROWS}
    want = {k: v for k, v in _launches_per_step(
        model._progs["train"][0], bf16=True).items() if k in FIT_ROWS}
    trace = _FitTrace(counters=counters)
    t0 = time.perf_counter()
    model.fit(batches, callbacks=[trace], resume=True, **kw)
    print("FIT_DONE " + json.dumps(
        {"losses": [x.hex() for x in trace.losses],
         "launches": trace.launches, "want": want,
         "fit_s": time.perf_counter() - t0}), flush=True)
    return 0


def _fit_child_run(root: str, role: str, sigterm_after=None) -> tuple:
    """Run ``_fit_child`` as a subprocess (``python3 chip_smoke.py
    --fit-child``): its FIT_STEP losses, its FIT_DONE record, its exit
    code and the seconds it took.  With ``sigterm_after`` the child goes
    on a step at a time, and gets a real SIGTERM after it reports that
    step."""
    import signal
    import tempfile

    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(here), env.get("PYTHONPATH")) if p)
    err = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", here, "--fit-child", root, "--fit-role",
         role], cwd=os.path.dirname(here), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=err, text=True)
    steps, done = [], None
    try:
        for line in proc.stdout:
            if line.startswith("FIT_STEP"):
                _, n, loss = line.split()
                steps.append(float.fromhex(loss))
                if sigterm_after is not None and int(n) == sigterm_after:
                    proc.send_signal(signal.SIGTERM)
                if sigterm_after is not None:
                    proc.stdin.write("\n")
                    proc.stdin.flush()
            elif line.startswith("FIT_DONE"):
                done = json.loads(line.split(" ", 1)[1])
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err.seek(0)
    tail = err.read().decode(errors="replace")[-3000:]
    return steps, done, rc, time.perf_counter() - t0, tail


def _embedding_grad_ms(torch, flush, rows: int, ids: int,
                       width: int) -> dict:
    """The embedding gradient's scatter: ``ids`` rows of ``width`` f32
    summed into a ``rows`` table by autograd's ``index_add_`` (atomics)
    and by the port's ``manipulation.index_sum`` (masked sums for a small
    table, else the sorted ``index_put_``), at uniform seed-0 ids: both
    timed, whether two runs of each agree bit for bit, and the largest
    difference between them.  Fails if the port's runs differ."""
    from paddle_tpu_torch.ops import manipulation

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    idx = torch.randint(0, rows, (ids,), device="cuda", generator=gen)
    g = torch.randn(ids, width, device="cuda", generator=gen)

    def atomic():
        return torch.zeros(rows, width, device="cuda").index_add_(0, idx, g)

    def port():
        return manipulation.index_sum((rows, width), 0, idx, g)

    runs = {f: [f() for _ in range(4)] for f in (atomic, port)}
    same = {f.__name__: all(torch.equal(r[0], x) for x in r[1:])
            for f, r in runs.items()}
    out = {"rows": rows, "ids": ids, "width": width,
           "atomic_runs_equal": same["atomic"],
           "port_runs_equal": same["port"],
           "port_max_abs_diff": float((runs[port][0]
                                       - runs[atomic][0]).abs().max()),
           "atomic_ms": time_cold_ms(torch, atomic, flush,
                                     reps=40)["median"],
           "port_ms": time_cold_ms(torch, port, flush, reps=40)["median"]}
    if not same["port"]:
        fail(f"the port's embedding gradient differs between runs: {out}")
    return out


def phase_fit_resume(torch, card: str) -> dict:
    """BERT-base pretraining through hapi.Model.fit, preempted by a real
    SIGTERM and resumed: every step's loss, the parameters and the Adam
    moments bit for bit against a straight run; the checkpoint's costs."""
    import shutil
    import tempfile

    from paddle_tpu_torch.fluid import checkpoint as ckpt

    t_phase = time.perf_counter()
    n = FIT["steps"]
    straight = []
    for _ in range(2):
        t0 = time.perf_counter()
        model, batches = _fit_setup(torch)
        build_s = time.perf_counter() - t0
        trace = _FitTrace()
        t0 = time.perf_counter()
        model.fit(batches, epochs=1, verbose=0, callbacks=[trace])
        torch.cuda.synchronize()
        straight.append({"losses": trace.losses, "state": _host_state(model),
                         "build_s": build_s,
                         "fit_s": time.perf_counter() - t0})
        if len(straight) == 1:
            del model
            torch.cuda.empty_cache()
    ref = straight[0]["losses"]
    if not all(math.isfinite(x) for x in ref) or len(ref) != n:
        fail(f"fit_resume straight losses {ref}")
    if straight[1]["losses"] != ref:
        fail(f"fit_resume: two straight runs differ: {ref} vs "
             f"{straight[1]['losses']}")
    bad = _state_diff(straight[0]["state"], straight[1]["state"])
    if bad:
        fail(f"fit_resume: two straight runs end with different state: "
             f"{bad[:8]}")

    # -- the checkpoint's costs, on the second straight run's model ------
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    work = tempfile.mkdtemp(prefix="fit_resume_")
    main = model._progs["train"][0]
    feed_n = len(model._inputs)
    mgr = ckpt.CheckpointManager(os.path.join(work, "costs"), keep_last_n=2,
                                 program=main, scope=model._scope)

    def step_ms(k):
        out = []
        for i in range(k):
            bt = batches[i % n]
            t0 = time.perf_counter()
            model.train_batch(bt[:feed_n], bt[feed_n:])   # numpy fetch
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    saved = _host_state(model)
    sync = []
    for s in (101, 102):
        mgr.save(s, async_=False)
        sync.append(dict(mgr.last_save))
    t0 = time.perf_counter()
    ok = mgr.verify(102)
    verify_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        fail("fit_resume: a committed checkpoint failed verification")
    restored = ckpt.CheckpointManager(
        os.path.join(work, "costs"), program=main,
        scope=model._scope).restore()
    if restored["step"] != 102 or _state_diff(saved, _host_state(model)):
        fail("fit_resume: the restore changed the state it read back")
    base_ms = step_ms(4)
    mgr.save(103, async_=True)
    async_save = dict(mgr.last_save)
    during_ms = step_ms(4)
    t0 = time.perf_counter()
    mgr.drain()
    drain_ms = (time.perf_counter() - t0) * 1e3
    async_write = dict(mgr.last_save)
    determinism = [_embedding_grad_ms(torch, flush, rows, ids, 768)
                   for ids in (FIT["batch"] * FIT["seq"],
                               BERT_LONG["batch"] * BERT_LONG["seq"])
                   for rows in (30522, 512, 2)]
    del model, mgr, flush
    torch.cuda.empty_cache()

    # -- the drill: a child SIGTERM'd after step 6, then one resuming ----
    root = os.path.join(work, "drill")
    pre, done1, rc1, secs1, tail1 = _fit_child_run(
        root, "preempt", sigterm_after=FIT["sigterm_after"])
    if rc1 != ckpt.PREEMPTED_EXIT_CODE or done1 is None:
        fail(f"fit_resume: the SIGTERM'd child exited {rc1}: {tail1}")
    dmgr = ckpt.CheckpointManager(root, device="cpu")
    pos = dmgr.latest_step()
    if pos is None or not dmgr.verify(pos):
        fail(f"fit_resume: no committed checkpoint after the SIGTERM "
             f"({dmgr.steps()})")
    extra = ckpt._loads(open(os.path.join(dmgr._dir(pos), "extra.pkl"),
                             "rb").read())
    if extra["global_step"] != pos or pos < FIT["sigterm_after"]:
        fail(f"fit_resume: checkpoint position {extra} at step {pos}")
    post, done2, rc2, secs2, tail2 = _fit_child_run(root, "resume")
    if rc2 != 0 or done2 is None:
        fail(f"fit_resume: the resuming child exited {rc2}: {tail2}")
    resumed = [float.fromhex(x) for x in done2["losses"]]
    joined = pre[:pos] + resumed
    if joined != ref:
        fail(f"fit_resume: the resumed trace differs from the straight "
             f"run: {joined} vs {ref}")
    last = dmgr.latest_step()
    state = ckpt._loads(open(os.path.join(dmgr._dir(last), "state.pkl"),
                             "rb").read())["arrays"]
    state["__seed__"] = ckpt._restore_rng(ckpt._loads(open(os.path.join(
        dmgr._dir(last), "rng.pkl"), "rb").read()))
    bad = _state_diff(straight[0]["state"], state)
    if last != n or bad:
        fail(f"fit_resume: the resumed step-{last} state differs from the "
             f"straight run's: {bad[:8]}")
    want = done2["want"]
    if any(got != want for got in done2["launches"]) \
            or len(done2["launches"]) != n - pos:
        fail(f"fit_resume: resumed launches {done2['launches']} against "
             f"{want} a step")
    doctor = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "ckpt_doctor.py"), root,
         "--json"], capture_output=True, text=True, timeout=300)
    rep = json.loads(doctor.stdout) if doctor.returncode == 0 else {}
    if doctor.returncode != 0 or rep.get("orphans") or not rep.get(
            "steps") or any(e["status"] != "ok" for e in rep["steps"]):
        fail(f"fit_resume: ckpt_doctor on the port's checkpoints "
             f"rc {doctor.returncode}: {doctor.stdout[-2000:]} "
             f"{doctor.stderr[-2000:]}")
    shutil.rmtree(work, ignore_errors=True)
    launches = {k: sum(step[k] for step in done2["launches"])
                for k in want}
    out = {"phase": "fit_resume", "card": card,
           "config": {"model": "BertConfig.base()", "fuse_stack": True,
                      "dropout": 0.1, "optimizer": "Adam 1e-4",
                      "amp": "bf16", "batch": FIT["batch"],
                      "seq": FIT["seq"], "max_preds": FIT["max_preds"],
                      "steps": n, "checkpoint_freq": FIT["freq"],
                      "checkpoint_keep": FIT["keep"],
                      "data": "random_pretrain_batch seeds 0-11"},
           "straight_losses": ref,
           "straight_runs_bit_equal": True,
           "straight_build_s": [r["build_s"] for r in straight],
           "straight_fit_s": [r["fit_s"] for r in straight],
           "sigterm_after_step": FIT["sigterm_after"],
           "preempted_rc": rc1, "checkpoint_position": pos,
           "preempted_child_s": secs1, "resumed_child_s": secs2,
           "final_save_ms": done1["final_save"],
           "resumed_steps": n - pos, "resumed_trace_bit_equal": True,
           "resumed_state_bit_equal": True,
           "state_vars": len(state) - 1,
           "ckpt_doctor": [(e["step"], e["status"]) for e in rep["steps"]],
           "checkpoint_bytes": sync[-1]["bytes"],
           "sync_save_ms": sync,
           "verify_ms": verify_ms, "restore_ms": restored["restore_ms"],
           "async_save_ms": async_save["save"],
           "async_snapshot_ms": async_save["snapshot"],
           "async_writer_ms": {k: async_write.get(k) for k in
                               ("serialize", "write")},
           "step_ms_before_async": base_ms, "step_ms_during_async": during_ms,
           "drain_ms": drain_ms,
           "launches_per_step": want, "launches": launches,
           "embedding_grad_scatter": determinism,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# verify: the static verifier on the programs the card runs
# ---------------------------------------------------------------------------


def _verify_program(what, build, run, findings):
    """Build a program under FLAGS_program_verify (every pass sandwich
    armed), run its first step (the executor's plan-cache hook), then
    time the full check suite on it standalone."""
    from paddle_tpu_torch.fluid import analysis

    t0 = time.perf_counter()
    prog, live = build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    first_run_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fs = analysis.verify_program(prog, live_out=live)
        times.append((time.perf_counter() - t0) * 1e3)
    errors = [f.format() for f in fs if f.severity == analysis.ERROR]
    if errors:
        fail(f"verify: {what} has {len(errors)} ERROR finding(s): "
             f"{errors[:4]}")
    findings[what] = {"ops": len(prog.global_block().ops),
                      "verify_ms": statistics.median(times),
                      "verify_ms_all": times, "build_s": build_s,
                      "first_run_s": first_run_s,
                      "errors": 0,
                      "warnings": sum(f.severity == analysis.WARNING
                                      for f in fs),
                      "checks": sorted({f.check for f in fs})}


LAMB_RC = dict(batch=8, seq=512, max_preds=76, steps=8, warm=2, lr=1e-4,
               warmup=3, decay_steps=8, weight_decay=0.01, gm_steps=4)


def _lamb_rc_program(cfg, c, *, recompute: bool, k_steps: int = 0):
    """BERT pretraining through fleet at world size 1 as a large-batch
    recipe trains it: Adam swapped for LAMB (``strategy.lamb``), bf16 AMP,
    an in-graph linear_lr_warmup(polynomial_decay) learning rate, with
    ``strategy.recompute`` checkpointing every encoder layer's output, or
    ``strategy.gradient_merge`` over ``k_steps``.  Returns the programs,
    the loss and the learning-rate var."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.fluid.layers import nn as lnn
    from paddle_tpu_torch.models import bert

    lnn._rng_salt_counter[0] = 0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, c["batch"], c["seq"], c["max_preds"], main_program=main,
            startup_program=startup)
        with fluid.program_guard(m, st):
            L = fluid.layers
            lr = L.linear_lr_warmup(
                L.polynomial_decay(c["lr"], decay_steps=c["decay_steps"],
                                   end_learning_rate=0.0),
                warmup_steps=c["warmup"], start_lr=0.0, end_lr=c["lr"])
            strategy = fleet.DistributedStrategy()
            strategy.lamb = True
            strategy.lamb_configs = {"lamb_weight_decay": c["weight_decay"]}
            strategy.amp = True
            if recompute:
                strategy.recompute = True
                strategy.recompute_configs = {"checkpoints": [
                    op.output("Y")[0] for op in m.global_block().ops
                    if op.type == "layer_norm" and op.input("Scale")[0]
                    .endswith("_post_ffn_ln_scale")]}
            if k_steps:
                strategy.gradient_merge = True
                strategy.gradient_merge_configs = {"k_steps": k_steps}
            fleet.init()
            fleet.distributed_optimizer(
                fluid.optimizer.AdamOptimizer(lr), strategy).minimize(loss)
    return m, st, loss, lr


def _recompute_launches_per_step(program) -> dict:
    """The launches of a bf16 program whose recompute segments each run
    their forward twice (the forward, and again in the grad op) and their
    backward once."""
    block = program.global_block()
    top = [op for op in block.ops if op.type != "recompute_segment"]
    subs = [sop for op in block.ops if op.type == "recompute_segment"
            for sop in op.attr("recompute_sub_ops")]
    parts = (_launches_per_step(program, True, ops=top, train=True),
             _launches_per_step(program, True, ops=subs, train=True),
             _launches_per_step(program, True, ops=subs, train=False))
    return {k: sum(p[k] for p in parts) for k in KERNEL_COUNTERS}


def _lamb_lr_closed_form(c, steps: int) -> list:
    """linear_lr_warmup(polynomial_decay(lr, decay_steps, 0), warmup, 0,
    lr) at steps 0..steps-1, in float64."""
    out = []
    for t in range(steps):
        if t < c["warmup"]:
            out.append(c["lr"] * t / c["warmup"])
        else:
            out.append(c["lr"] * (1.0 - min(t, c["decay_steps"])
                                  / c["decay_steps"]))
    return out


def _lamb_rc_run(torch, cfg, c, recompute: bool) -> dict:
    """``c["steps"]`` steps of the program on one fixed batch: the loss
    and the fetched learning rate of each, each step's launches held to
    the program's, the step wall of the steps after ``c["warm"]``, and
    the peak memory of the last step (from a reset just before it)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    main, startup, loss, lr = _lamb_rc_program(cfg, c, recompute=recompute)
    build_s = time.perf_counter() - t0
    want = (_recompute_launches_per_step(main) if recompute
            else _launches_per_step(main, bf16=True))
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feed = {k: torch.as_tensor(v, device=exe.device) for k, v in
            bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                       c["max_preds"], seed=0).items()}
    counters = _counters()
    losses, lrs, step_ms, total = [], [], [], dict.fromkeys(counters, 0)
    peak = None
    for i in range(c["steps"]):
        if i == c["steps"] - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        (lv, rv), got = _count_step(counters, lambda: exe.run(
            main, feed=feed, fetch_list=[loss, lr], scope=scope))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == c["steps"] - 1:
            peak = torch.cuda.max_memory_allocated()
        if got != want:
            fail(f"bert_lamb_recompute (recompute={recompute}) step {i} "
                 f"launched {got}, the program needs {want}")
        for k in total:
            total[k] += got[k]
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        lrs.append(float(np.asarray(rv).reshape(-1)[0]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"bert_lamb_recompute losses not finite: {losses}")
    prof = _step_profile(torch, exe, main, scope, feed, loss, 2,
                         "window = 2 more steps after the checked ones")
    params = [p.name for p in main.all_parameters()]
    return {"main": main, "scope": scope, "params": params,
            "profile": dict(prof, top_kernels=prof["top_kernels"][:6]),
            "losses": losses, "lrs": lrs, "build_s": build_s,
            "step_ms": step_ms[c["warm"]:], "launches_per_step": want,
            "launches": total, "peak_bytes": peak,
            "peak_above_state_bytes": peak - base,
            "segments": sum(op.type == "recompute_segment"
                            for op in main.global_block().ops)}


def _lamb_gradient_merge(torch, cfg, c, state) -> dict:
    """``strategy.gradient_merge`` k_steps 2 over the same recipe: after
    each odd step every parameter equals its value before the step bit
    for bit; after each even step they have moved."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    main, startup, loss, _ = _lamb_rc_program(cfg, c, recompute=False,
                                              k_steps=2)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    for n, v in state.items():
        scope.set_var(n, v.clone())
    names = [p.name for p in main.all_parameters()]
    feeds = [{k: torch.as_tensor(v, device=exe.device) for k, v in
              bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                         c["max_preds"], seed=i).items()}
             for i in range(c["gm_steps"])]
    steps = []
    for i, feed in enumerate(feeds, start=1):
        before = {n: scope.find_var(n).clone() for n in names}
        lv = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        same = [n for n in names if torch.equal(before[n],
                                                scope.find_var(n))]
        boundary = i % 2 == 0
        if boundary and len(same) == len(names):
            fail(f"gradient merge: step {i} (a boundary) left every "
                 f"parameter unchanged")
        if not boundary and len(same) != len(names):
            fail(f"gradient merge: step {i} (not a boundary) changed "
                 f"{sorted(set(names) - set(same))[:5]}")
        steps.append({"step": i, "boundary": boundary,
                      "loss": float(np.asarray(lv).reshape(-1)[0]),
                      "params_unchanged": len(same),
                      "params": len(names)})
    return {"k_steps": 2, "steps": steps}


def _ema_model_average_on_card(torch) -> dict:
    """ExponentialMovingAverage and ModelAverage over a small fc net
    trained 3 SGD steps on the card: apply() puts the debiased EMA / the
    window average in the scope as CUDA tensors, restore() puts back the
    very tensors it took out."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [8], "float32")
        y = L.data("y", [1], "int32")
        loss = L.reduce_mean(L.softmax_with_cross_entropy(
            L.fc(L.fc(x, 16, act="relu"), 4), y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(0.9)
        ema.update()
        ma = fluid.optimizer.ModelAverage(0.15, min_average_window=10,
                                          max_average_window=100)
    scope = fluid.Scope()
    exe = fluid.Executor()
    rng = np.random.default_rng(0)
    out = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        pname = main.all_parameters()[0].name
        snaps = []
        for _ in range(3):
            exe.run(main, feed={
                "x": rng.standard_normal((16, 8)).astype(np.float32),
                "y": rng.integers(0, 4, (16, 1)).astype(np.int32)},
                fetch_list=[loss])
            snaps.append(scope.find_var(pname).cpu().double().numpy())
        raw = scope.find_var(pname)
        ema_np = np.zeros_like(snaps[0])
        for sn in snaps:
            ema_np = 0.9 * ema_np + 0.1 * sn
        for what, avg, want in (("ema", ema, ema_np / (1 - 0.9 ** 3)),
                                ("model_average", ma,
                                 np.mean(snaps, axis=0))):
            with avg.apply():
                t = scope.find_var(pname)
                if t.device.type != "cuda":
                    fail(f"{what}.apply() left {pname} on {t.device}")
                err = float(np.abs(t.cpu().double().numpy() - want).max())
                if err > 1e-5:
                    fail(f"{what}.apply(): {pname} off by {err}")
            if scope.find_var(pname) is not raw:
                fail(f"{what}.restore() did not put back the parameter")
            out[what] = {"max_abs_err": err, "device": str(t.device)}
    return out


def phase_bert_lamb_recompute(torch, card: str) -> dict:
    """BERT-base pretraining through fleet with LAMB, warmup then
    polynomial decay, bf16 AMP and recompute (a checkpoint at every
    encoder layer's output), unfused, dropout 0.1, 8 x 512, against the
    same recipe without recompute from the same weights and seed; then
    gradient merge at k_steps 2 and EMA / ModelAverage on the card."""
    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    c = LAMB_RC
    cfg = bert.BertConfig.base()
    cfg.fuse_stack = False
    plain = _lamb_rc_run(torch, cfg, c, recompute=False)
    # the same startup program and seed give both runs the same weights,
    # which step 1's losses check
    rc = _lamb_rc_run(torch, cfg, c, recompute=True)
    want_lr = _lamb_lr_closed_form(c, c["steps"])
    for what, r in (("plain", plain), ("recompute", rc)):
        err = max(abs(a - b) for a, b in zip(r["lrs"], want_lr))
        if err > 1e-9:
            fail(f"bert_lamb_recompute {what}: learning rates {r['lrs']} "
                 f"vs the closed form {want_lr} (max diff {err})")
    if rc["losses"][0] != plain["losses"][0]:
        fail(f"bert_lamb_recompute: step 1's loss {rc['losses'][0]!r} with "
             f"recompute vs {plain['losses'][0]!r} without")
    # one bf16 ulp of the run's largest loss: the two runs' gradients are
    # sums taken in another order (one autograd pass a segment against a
    # grad op an op), which moves later losses by a bf16 rounding or so
    top = max(abs(x) for x in plain["losses"])
    tol = 2.0 ** (math.floor(math.log2(top)) - 7)
    diff = max(abs(a - b) for a, b in zip(rc["losses"], plain["losses"]))
    if diff > tol:
        fail(f"bert_lamb_recompute: losses {rc['losses']} with recompute "
             f"vs {plain['losses']} without, {diff} > {tol}")
    if not rc["peak_above_state_bytes"] < plain["peak_above_state_bytes"]:
        fail(f"bert_lamb_recompute: recompute's peak "
             f"{rc['peak_above_state_bytes']} is not below "
             f"{plain['peak_above_state_bytes']}")
    for k in ("bsh_fwd", "bsh_fwd_tc"):
        if rc["launches_per_step"][k] != 2 * plain["launches_per_step"][k]:
            fail(f"bert_lamb_recompute: {k} {rc['launches_per_step'][k]} a "
                 f"step with recompute vs {plain['launches_per_step'][k]}")
    gm = _lamb_gradient_merge(torch, cfg, c, {
        n: plain["scope"].find_var(n) for n in plain["params"]})
    avg = _ema_model_average_on_card(torch)
    runs = {}
    for what, r in (("plain", plain), ("recompute", rc)):
        runs[what] = {k: r[k] for k in (
            "losses", "lrs", "build_s", "step_ms", "launches_per_step",
            "launches", "peak_bytes", "peak_above_state_bytes", "segments",
            "profile")}
        runs[what]["step_ms_median"] = statistics.median(r["step_ms"])
        runs[what]["peak_gb"] = r["peak_bytes"] / 2 ** 30
    out = {"phase": "bert_lamb_recompute", "card": card,
           "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                      "layers": cfg.num_hidden_layers,
                      "heads": cfg.num_attention_heads,
                      "fuse_stack": False, "dropout": 0.1, "amp": "bf16",
                      "optimizer": "fleet: Adam -> strategy.lamb, "
                                   f"weight decay {c['weight_decay']}",
                      "lr": f"linear_lr_warmup(polynomial_decay({c['lr']}, "
                            f"{c['decay_steps']}, 0), {c['warmup']}, 0, "
                            f"{c['lr']})",
                      "recompute": "a checkpoint at every encoder layer",
                      "batch": c["batch"], "seq": c["seq"],
                      "max_preds": c["max_preds"], "steps": c["steps"],
                      "warm_steps": c["warm"]},
           "runs": runs, "lr_closed_form": want_lr,
           "loss_tol": tol, "loss_max_diff": diff,
           "gradient_merge": gm, "ema_model_average": avg,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_verify(torch, card: str) -> dict:
    """FLAGS_program_verify=1 and FLAGS_op_callstack=1 on the card's
    programs: BERT-base training (fused, AMP), the frozen BERT-base infer
    program, ResNet-50 training after the conv+BN fusion and the NMT's
    training; no ERROR finding through any pass sandwich, the executor's
    plan-cache hook or the standalone suite, each program's op count and
    the verifier's host ms; then a seeded fault (an op reading a var that
    nothing writes) caught before any op runs, naming this file's line."""
    import inspect

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import analysis, flags
    from paddle_tpu_torch.fluid.analysis import sandwich
    from paddle_tpu_torch.inference import ServingPredictor, freeze_program
    from paddle_tpu_torch.models import bert, resnet

    t_phase = time.perf_counter()
    calls = []
    real = sandwich.verify_program

    def counted(program, **kw):
        fs = real(program, **kw)
        calls.append(sum(f.severity == analysis.ERROR for f in fs))
        return fs

    sandwich.verify_program = counted
    flags.set_flags({"FLAGS_program_verify": True,
                     "FLAGS_op_callstack": True})
    found, sandwiches = {}, {}
    try:
        cfg = bert.BertConfig.base()
        cfg.fuse_stack = True
        exe = fluid.Executor()
        state = {}

        def bert_train():
            m, st, loss = _train_program(cfg, 8, 512, 76, amp=True)
            state.update(main=m, startup=st, loss=loss)
            return m, [loss.name]

        def bert_train_run():
            scope = fluid.Scope()
            exe.run(state["startup"], scope=scope)
            feed = bert.random_pretrain_batch(cfg, 8, 512, 76, seed=0)
            exe.run(state["main"], feed=feed, fetch_list=[state["loss"]],
                    scope=scope)
            state.clear()

        def bert_infer():
            m, st, seq, pooled = _bert_program(cfg, 8, 512)
            scope = fluid.Scope()
            exe.run(st, scope=scope)
            fm = freeze_program(m, scope=scope, fetch_list=[seq, pooled])
            state.update(frozen=fm)
            return fm.program, list(fm.feed_names) + list(fm.fetch_names)

        def bert_infer_run():
            feed = _bert_batch(np.random.default_rng(0), cfg, 8, 512, 128)
            ServingPredictor(state["frozen"]).run(feed)
            state.clear()

        def resnet_train():
            rcfg = resnet.ResNetConfig.resnet50()
            m, st, loss = _resnet_train_program(rcfg, 128, 224, amp=True)
            state.update(main=m, startup=st, loss=loss,
                         classes=rcfg.num_classes)
            return m, [loss.name]

        def resnet_run():
            scope = fluid.Scope()
            exe.run(state["startup"], scope=scope)
            exe.run(state["main"], feed=_resnet_batch(128, 224,
                                                      state["classes"]),
                    fetch_list=[state["loss"]], scope=scope)
            state.clear()

        def nmt_train():
            m, st, loss, _ = _nmt_program(NMT["batch"], NMT["src_len"],
                                          NMT["trg_len"])
            state.update(main=m, startup=st, loss=loss)
            return m, [loss.name]

        def nmt_run():
            scope = fluid.Scope()
            exe.run(state["startup"], scope=scope)
            exe.run(state["main"], feed=_nmt_batch(
                NMT["batch"], NMT["src_len"], NMT["trg_len"]),
                fetch_list=[state["loss"]], scope=scope)
            state.clear()

        for what, build, run in (
                ("bert_train_fused_amp", bert_train, bert_train_run),
                ("bert_infer_frozen", bert_infer, bert_infer_run),
                ("resnet50_train_fused_amp", resnet_train, resnet_run),
                ("nmt_train_amp", nmt_train, nmt_run)):
            before = len(calls)
            _verify_program(what, build, run, found)
            sandwiches[what] = len(calls) - before
            torch.cuda.empty_cache()
        if any(calls) or min(sandwiches.values()) < 2:
            fail(f"verify: sandwich ERROR counts {calls}, passes "
                 f"{sandwiches}")

        # the seeded fault: an op reading a var that nothing writes
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4, 8], append_batch_size=False)
            fluid.layers.relu(x)
        line = inspect.currentframe().f_lineno + 1
        main.global_block().append_op(type="relu", inputs={"X": ["ghost"]},
                                      outputs={"Out": ["o"]}, infer=False)
        where = f"{inspect.currentframe().f_code.co_filename}:{line}"
        t0 = time.perf_counter()
        try:
            exe.run(main, feed={"x": np.zeros((4, 8), np.float32)},
                    fetch_list=["o"], scope=fluid.Scope())
        except analysis.ProgramVerifyError as e:
            caught = str(e)
            checks = sorted({f.check for f in e.findings
                             if f.severity == analysis.ERROR})
        else:
            fail("verify: the seeded fault ran without a ProgramVerifyError")
        seeded_ms = (time.perf_counter() - t0) * 1e3
        if checks != ["dangling-ref"] or where not in caught:
            fail(f"verify: the seeded fault gave {checks}, not naming "
                 f"{where}: {caught[:1000]}")
    finally:
        sandwich.verify_program = real
        flags.set_flags({"FLAGS_program_verify": False})
    out = {"phase": "verify", "card": card, "programs": found,
           "sandwich_passes": sandwiches,
           "sandwich_errors": sum(calls),
           "seeded_fault": {"checks": checks, "user_frame": where,
                            "ms": seeded_ms},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# data and sequence parallelism: ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one device, so the multi-rank phases run their
# ranks as processes sharing the card over gloo (every kernel and model op
# on the card, the collectives staged through the host); NCCL runs at
# world size 1 (dist_nccl)
DIST_WORLD = 4
DIST_RING = dict(b=8, nh=12, s=2048, d=64, mesh={"sp": 4})
# ``layers``: the depth of a plan's bf16 runs.  dist_train, dist_tp,
# dist_pp, dist_ep, dist_zero and dist_dcn run 4 of BERT-base's 12
# layers (at full width), so that the script stays inside its time limit
# beside dist_elastic, which takes all 12
DIST_TRAIN = dict(batch=8, seq=512, max_preds=76, steps=3, timed=2,
                  drop_steps=2, mesh={"dp": 2, "sp": 2}, layers=4)
# dist_train's attention: BERT-base's 12 heads of 64 at 8 x 512 over dp 2
# x sp 2, so each rank's ring block is [4, 12, 256, 64]
DIST_RING_TRAIN = dict(b=DIST_TRAIN["batch"], nh=12, s=DIST_TRAIN["seq"],
                       d=64, mesh=DIST_TRAIN["mesh"])
DIST_JOIN_S = 420          # one spawn's deadline, its ranks' start included
DIST_PG_TIMEOUT_S = 240    # every collective's own timeout
# BERT-base dp 2 x sp 2 against one process, the same program and weights:
# bf16 AMP rounds at other places once the stack is split (the ring's
# per-block softmax, the weight gradients summed over sp in bf16), the
# limit of bert_train_parity's bf16 losses; f32 with TF32 off sums in
# another order only
DIST_LOSS_BF16 = 2e-2
DIST_LOSS_F32 = 1e-4
# every parameter after the f32 steps against the one-process run's: the
# limit bert_train_parity holds the card's f32 parameters to
DIST_PARAM_F32 = TRAIN_PARITY_PARAM
# the ring's bf16 result against the f32 plain version over the whole
# sequence: bf16 rounding (ATOL_BF16) at the scale of each tensor
DIST_RING_BF16_SCALE = ATOL_BF16
# tensor parallelism: BERT-base unfused over dp 2 x tp 2, each rank's
# attention 6 of the 12 heads of [4, 512]; pipeline parallelism: the
# fused stack over dp 2 x pp 2 (6 layers a stage, 2 microbatches), then
# pp 2 x sp 2 on the same ranks
DIST_TP = dict(DIST_TRAIN, mesh={"dp": 2, "tp": 2}, fuse_stack=False,
               tp=True)
DIST_PP = dict(DIST_TRAIN, mesh={"dp": 2, "pp": 2}, fuse_stack=True,
               pipeline=True, acc=2)
DIST_PP_SP = dict(DIST_PP, mesh={"pp": 2, "sp": 2}, drop_steps=0)
DIST_TP_BLOCK = dict(b=DIST_TP["batch"] // 2, s=DIST_TP["seq"], nh=12 // 2,
                     d=64)
# expert parallelism: BERT-base unfused with a moe_ffn of 8 experts of
# 3072 in every layer (top-2, capacity factor 1.25, aux weight 0.01) over
# dp 2 x ep 2, then dp 1 x ep 4 on the same ranks; ZeRO-2 at dp 4 (the
# fused stack, sharding on, then off); the multi-slice modes at dcn 2 x
# dp 2 (the fused stack: dense, DGC at sparsity 0.9 after one dense
# step, LocalSGD averaging every 2 steps), 4 of BERT-base's layers
DIST_MOE = dict(moe_num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                moe_aux_weight=0.01)
DIST_EP = dict(DIST_TRAIN, mesh={"dp": 2, "ep": 2}, fuse_stack=False,
               moe=True, drop_steps=0, gather_state=False)
DIST_EP4 = dict(DIST_EP, mesh={"dp": 1, "ep": 4})
DIST_ZERO = dict(DIST_TRAIN, mesh={"dp": 4}, fuse_stack=True, drop_steps=0)
DIST_DCN = dict(DIST_TRAIN, mesh={"dcn": 2, "dp": 2}, fuse_stack=True,
                drop_steps=0, dcn=2)
DIST_DGC = dict(DIST_DCN, timed=0, gather_state=False,
                dgc={"sparsity": 0.9, "rampup_begin_step": 1})
DIST_LSGD = dict(DIST_DCN, steps=2, timed=0, gather_state=False,
                 localsgd={"k_steps": 2})
# the gradient whose DGC sync dist_dcn recomputes on the host: the stacked
# attention output weight encoder_stack.out_w, [4, 768, 768] (2,359,296
# entries at 4 layers), the one gradient of that shape
DIST_DGC_PROBE = (DIST_DCN["layers"], 768, 768)


@contextlib.contextmanager
def _watch_op(op_type: str, seen):
    """While open, each emission of ``op_type`` on real tensors calls
    ``seen(ins, attrs, outs)`` after the op: the registry's emitter
    wrapped, nothing of the port changed (shape inference on meta
    tensors is not watched)."""
    from paddle_tpu_torch.ops import registry as treg

    spec = treg.get(op_type)
    real = spec.emit

    def emit(ctx, ins, attrs):
        outs = real(ctx, ins, attrs)
        if next(iter(ins.values()))[0].device.type != "meta":
            seen(ins, attrs, outs)
        return outs

    spec.emit = emit
    try:
        yield
    finally:
        spec.emit = real


def _moe_routing(log: list):
    """A ``_watch_op`` callback for ``moe_ffn``: each call's top-k picks
    (the op's own slot-by-slot argmax over the f32 router), the f32 logit
    margin of each token (its k-th choice's logit less the next one's)
    and the aux loss it gave, appended to ``log``."""
    import torch

    from paddle_tpu_torch.ops import moe_ops

    def seen(ins, attrs, outs):
        with torch.no_grad():
            x = ins["X"][0]
            logits = (x.reshape(-1, x.shape[-1]).float()
                      @ ins["GateW"][0].float())
            k = int(attrs.get("top_k", 2))
            idx, _ = moe_ops._route(torch.softmax(logits, dim=-1), k)
            top = torch.topk(logits, k + 1, dim=-1).values
            log.append({"picks": torch.stack(idx, 1).to(torch.int16).cpu(),
                        "margin": (top[:, k - 1] - top[:, k]).cpu(),
                        "aux": float(outs["AuxLoss"][0])})
    return seen


def _dist_spawn(groups: dict, workdir: str) -> dict:
    """Start every group at once, ``name: (modes, world)`` as ``world``
    rank processes that run each mode's body in turn (one process start
    for all of them), then join them all.  Returns each mode's per-rank
    results; each carries ``concurrent_with``, the modes of the other
    groups whose bodies ran while its own did (their times shared the
    card and the host; a group's first body counts from its ranks'
    process start).  A group that fails kills every other group's
    ranks too."""
    t0 = time.time()
    started = {}
    try:
        for name, (modes, world) in groups.items():
            d = os.path.join(workdir, name)
            os.makedirs(d, exist_ok=True)
            started[name] = (modes, d, _dist_start(",".join(modes), world, d))
        raw, group_of = {}, {}
        for name, (modes, d, st) in started.items():
            ranks = _dist_join(",".join(modes), st, d,
                               DIST_JOIN_S * len(modes))
            for m in modes:
                raw[m] = [dict(r[m], backend=r["backend"]) for r in ranks]
                group_of[m] = name
    except BaseException:
        for _, _, (procs, _) in started.values():
            for p in procs:
                try:
                    os.killpg(p.pid, 9)
                except ProcessLookupError:
                    pass
                p.wait()
        raise
    # each mode's window on the host clock: its first rank's start to
    # its last rank's end
    win = {m: (min(r["body_window"][0] for r in ranks),
               max(r["body_window"][1] for r in ranks))
           for m, ranks in raw.items()}
    for m, ranks in raw.items():
        beside = [o for o in raw if group_of[o] != group_of[m]
                  and win[o][0] < win[m][1] and win[m][0] < win[o][1]]
        for r in ranks:
            r["concurrent_with"] = beside
            r["window"] = win[m]
    emit({"phase": "dist_ranks", "groups": {
              name: {"modes": list(modes), "world": world}
              for name, (modes, world) in groups.items()},
          "body_windows_s": {m: [a - t0, b - t0] for m, (a, b) in
                             win.items()},
          "seconds": time.time() - t0})
    return raw


def _dist_start(mode: str, world: int, workdir: str) -> tuple:
    """``--dist-child mode`` started as ``world`` rank processes on the
    card, each in a session of its own (killing it kills what the rank
    started); (processes, logs)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-child", mode,
             "--dist-rank", str(r), "--dist-world", str(world),
             "--dist-dir", workdir], env=env, stdout=log, stderr=log,
            start_new_session=True))
    return procs, logs


def _dist_join(mode: str, started: tuple, workdir: str,
               join_s: float) -> list:
    """Each rank's result of a ``_dist_start``.  A rank that exits
    nonzero or outlives ``join_s`` fails the phase with its exit code and
    the tail of its log; every other rank is killed first."""
    import torch

    procs, logs = started
    deadline = time.monotonic() + join_s
    bad = None
    while bad is None:
        codes = [p.poll() for p in procs]
        if all(c == 0 for c in codes):
            break
        bad = next(((r, c) for r, c in enumerate(codes)
                    if c not in (None, 0)), None)
        if bad is None and time.monotonic() > deadline:
            bad = (codes.index(None), f"no exit within {join_s} s")
        time.sleep(0.2)
    for p in procs:
        try:
            os.killpg(p.pid, 9)     # the rank and anything it started
        except ProcessLookupError:
            pass
        p.wait()
    for log in logs:
        log.close()
    if bad is not None:
        r, code = bad
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            tail = f.read()[-3000:]
        fail(f"dist {mode}: rank {r} of {len(procs)} failed ({code}):\n"
             f"{tail}")
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"))
            for r in range(len(procs))]


def _dist_child(mode: str, rank: int, world: int, workdir: str) -> int:
    """One rank of a dist phase: the process group, the body, its result
    written for the parent."""
    import torch
    import torch.distributed as dist

    for k, v in (("RANK", rank), ("WORLD_SIZE", world),
                 ("PADDLE_TRAINER_ID", rank), ("PADDLE_TRAINERS_NUM", world),
                 ("LOCAL_RANK", rank)):
        os.environ[k] = str(v)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.parallel import env

    if mode == "nccl":
        env.init_parallel_env()          # the card: NCCL, picked, not named
    else:
        # ranks sharing one card: gloo, named (NCCL refuses them)
        env.init_parallel_env(backend="gloo", device="cuda:0",
                              init_method=f"file://{workdir}/store",
                              timeout_s=DIST_PG_TIMEOUT_S)
    bodies = {"ring": _dist_ring_child, "train": _dist_train_child,
              "nccl": _dist_nccl_child, "tp": _dist_tp_child,
              "pp": _dist_pp_child, "ep": _dist_ep_child,
              "zero": _dist_zero_child, "dcn": _dist_dcn_child}
    out = {}
    t0 = _T_PROC0       # the first body's window holds the rank's start
    for m in mode.split(","):       # each mode's body in turn
        torch.cuda.reset_peak_memory_stats()
        out[m] = bodies[m](torch, rank, world)
        out[m]["body_window"] = (t0, time.time())
        t0 = out[m]["body_window"][1]
        torch.cuda.empty_cache()
    out["backend"] = dist.get_backend()
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _ring_case(shape: dict, dtype_name: str, causal: bool) -> dict:
    """The global inputs of a dist_ring case, from a fixed seed (every
    rank and the parent make the same)."""
    import torch

    c = shape
    rng = np.random.default_rng(15 + int(causal) + 2 * (dtype_name == "f32")
                                + 4 * (c is DIST_RING_TRAIN))
    dims = (c["b"], c["nh"], c["s"], c["d"])
    q, k, v, do = (torch.as_tensor(rng.standard_normal(dims),
                                   dtype=torch.float32) for _ in range(4))
    lens = rng.integers(c["s"] // 2, c["s"] + 1, c["b"])
    bias = torch.as_tensor(
        1e4 * ((np.arange(c["s"])[None, :] < lens[:, None]) - 1.0),
        dtype=torch.float32)
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), do=do.to(dtype),
                bias=bias, causal=causal, dtype=dtype)


def _ring_blocks(shape: dict, rank: int) -> tuple:
    """(batch slice, sequence slice) rank ``rank`` holds of a dist_ring
    case: ranks laid out row-major over the case's mesh axes, the batch
    split over dp, the sequence over sp."""
    coords, r = {}, rank
    for a in reversed(list(shape["mesh"])):
        coords[a] = r % shape["mesh"][a]
        r //= shape["mesh"][a]
    bl = shape["b"] // shape["mesh"].get("dp", 1)
    sl = shape["s"] // shape["mesh"]["sp"]
    i, j = coords.get("dp", 0), coords["sp"]
    return slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl)


# (shape, dtype, causal): sp 4 with and without causal, then dist_train's
# own attention (dp 2 x sp 2, a per-batch key bias, not causal)
RING_CASES = tuple((DIST_RING, dt, c) for dt, c in (
    ("bf16", False), ("bf16", True), ("f32", False), ("f32", True))) + (
    (DIST_RING_TRAIN, "bf16", False), (DIST_RING_TRAIN, "f32", False))


def _dist_ring_child(torch, rank: int, world: int) -> dict:
    """ring_attention over each case's sp axis on this rank's block of the
    case: o and the gradients of q, k, v and the key bias, rows 6 and 7
    counted, and the ring's forward + backward wall time."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import create_mesh
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    meshes = {}
    for shape, _, _ in RING_CASES:      # every rank, the same order
        key = tuple(shape["mesh"].items())
        if key not in meshes:
            meshes[key] = create_mesh(shape["mesh"])
    counters = {"row6": fa.flash_attention, "row7": fa.flash_attention_bwd_fused,
                "row6_tc": _Counter(fa.flash_attention, "launches_tc"),
                "row7_tc": _Counter(fa.flash_attention_bwd_fused,
                                    "launches_tc")}
    out = {"cases": []}
    for shape, dtype_name, causal in RING_CASES:
        mesh = meshes[tuple(shape["mesh"].items())]
        bblk, sblk = _ring_blocks(shape, rank)
        case = _ring_case(shape, dtype_name, causal)
        loc = {n: case[n][bblk, :, sblk].contiguous().cuda()
               for n in ("q", "k", "v", "do")}
        bias = case["bias"][bblk, sblk].contiguous().cuda()

        def run():
            qkv = [loc[n].clone().requires_grad_() for n in ("q", "k", "v")]
            kb = bias.clone().requires_grad_()
            o = ring_attention(*qkv, "sp", kb, None, causal, mesh=mesh)
            grads = torch.autograd.grad(o, qkv + [kb], loc["do"])
            return o, grads

        (o, grads), launches = _count_step(counters, run)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["cases"].append({
            "dtype": dtype_name, "causal": causal, "launches": launches,
            "block": list(loc["q"].shape), "fwd_bwd_ms": statistics.median(ms),
            "o": o.detach().cpu(), "dq": grads[0].cpu(), "dk": grads[1].cpu(),
            "dv": grads[2].cpu(), "dbias": grads[3].cpu()})
    return out


def _ring_call_launches(sp: int, bf16: bool) -> dict:
    """One ring_attention call's forward and backward: row 6 and row 7 once
    a ring step, on their wgmma kernels in bf16."""
    return {"row6": sp, "row7": sp, "row6_tc": sp if bf16 else 0,
            "row7_tc": sp if bf16 else 0}


def phase_dist_ring(torch, card: str, ranks: list) -> dict:
    """ring_attention on four ranks sharing the card (gloo), bf16 and f32,
    a per-batch key bias: at sp 4, B 8, nh 12, S 2048 (512 a rank), D 64,
    causal off and on; and at dist_train's own attention, dp 2 x sp 2,
    B 8, S 512 ([4, 12, 256, 64] a rank), not causal.  Every rank's o,
    dq, dk, dv and dbias block against the plain version run by this
    process over the whole batch and sequence; rows 6 and 7 launched by
    every rank, sp times a call (on the wgmma kernels in bf16).
    ``ranks``: the ranks' results."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    t0 = time.perf_counter()
    cases = []
    for i, (shape, dtype_name, causal) in enumerate(RING_CASES):
        case = _ring_case(shape, dtype_name, causal)
        q, k, v, do = (case[n].float().cuda() for n in ("q", "k", "v", "do"))
        bias4 = case["bias"].cuda()[:, None, None, :]
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, bias4,
                                                      causal=causal)
        ref = fa.flash_attention_bwd_reference(
            q, k, v, bias4, o_ref, lse_ref, do, causal=causal,
            want_dbias=True)
        refs = {"o": o_ref, "dq": ref[0], "dk": ref[1], "dv": ref[2],
                "dbias": ref[3].reshape(shape["b"], shape["s"])}
        del q, k, v, do, ref, lse_ref
        bf16 = dtype_name == "bf16"
        limits = {n: (DIST_RING_BF16_SCALE * max(1.0, t.abs().max().item())
                      if bf16 else (ATOL_DBIAS if n == "dbias" else ATOL_F32))
                  for n, t in refs.items()}
        want = _ring_call_launches(shape["mesh"]["sp"], bf16)
        errs = {n: 0.0 for n in refs}
        what = f"dist_ring {shape['mesh']} {dtype_name} causal={causal}"
        for r, res in enumerate(ranks):
            got = res["cases"][i]
            if got["launches"] != want:
                fail(f"{what}: rank {r} launched {got['launches']}, want "
                     f"{want}")
            bblk, sblk = _ring_blocks(shape, r)
            for n, t in refs.items():
                part = t[bblk, sblk] if n == "dbias" else t[bblk, :, sblk]
                e = _check(f"{what} rank {r} {n}", got[n].cuda(), part,
                           limits[n])
                errs[n] = max(errs[n], e["max_abs_err"])
        cases.append({"mesh": shape["mesh"], "global": {
                          k: shape[k] for k in ("b", "nh", "s", "d")},
                      "block": ranks[0]["cases"][i]["block"],
                      "dtype": dtype_name, "causal": causal,
                      "key_bias": "per batch [B, S]", "max_abs_err": errs,
                      "limits": limits, "launches_per_rank": want,
                      "fwd_bwd_ms_by_rank": [res["cases"][i]["fwd_bwd_ms"]
                                             for res in ranks]})
        del refs
        torch.cuda.empty_cache()
    out = {"phase": "dist_ring", "card": card, "world": DIST_WORLD,
           "backend": ranks[0]["backend"], "cases": cases,
           "concurrent_with": ranks[0]["concurrent_with"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _fleet_bert_program(cfg, amp: bool, mesh_axes, plan=None, shape=None):
    """bert_train's program under fleet: dp x sp with sequence_parallel;
    with a ``plan`` (DIST_TP, DIST_PP, DIST_EP, DIST_ZERO, DIST_DCN...)
    its tensor_parallel_rules, its pipeline with accumulate_steps, expert
    parallelism, ZeRO or the multi-slice mode too.  ``shape`` (batch,
    seq, max_preds) defaults to DIST_TRAIN's."""
    from paddle_tpu_torch import fleet, fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert

    c = shape or DIST_TRAIN
    plan = plan or {}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        m, st, _, loss = bert.build_bert_pretrain_program(
            cfg, c["batch"], c["seq"], c["max_preds"], main_program=main,
            startup_program=startup)
        with fluid.program_guard(m, st):
            opt = fluid.optimizer.AdamOptimizer(learning_rate=1e-4)
            strategy = fleet.DistributedStrategy()
            if amp and plan.get("dcn"):
                # strategy.amp: the sync ops' bf16 wire is its default
                strategy.amp = True
            elif amp:
                opt = mixed_precision.decorate(opt, use_bf16=True)
            strategy.mesh_axes = dict(mesh_axes)
            strategy.sequence_parallel = "sp" in mesh_axes
            if plan.get("tp"):
                strategy.tensor_parallel = True
                strategy.tensor_parallel_rules = bert.tensor_parallel_rules()
            if plan.get("pipeline"):
                strategy.pipeline = True
                strategy.pipeline_configs = {"accumulate_steps": plan["acc"]}
            strategy.expert_parallel = bool(plan.get("moe"))
            strategy.sharding = bool(plan.get("sharding"))
            if plan.get("dcn"):
                strategy.hybrid_dcn = plan["dcn"]
                strategy.dgc = bool(plan.get("dgc"))
                strategy.dgc_configs = dict(plan.get("dgc") or {})
                strategy.localsgd = bool(plan.get("localsgd"))
                strategy.localsgd_configs = dict(plan.get("localsgd") or {})
            fleet.init()
            fleet.distributed_optimizer(opt, strategy).minimize(loss)
    return m, st, loss


def _state_hash(scope, names) -> str:
    h = hashlib.sha256()
    for n in sorted(names):
        t = scope.find_var(n)
        h.update(n.encode())
        h.update(t.detach().contiguous().view(-1).view(
            __import__("torch").uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _dist_bert_cfg(layers=None, dropout=0.0, fuse_stack=True, moe=False):
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    cfg.fuse_stack = fuse_stack
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    if layers is not None:
        cfg.num_hidden_layers = layers
    if moe:
        for k, v in DIST_MOE.items():
            setattr(cfg, k, v)
    return cfg


def _ring_launches_per_step(program, sp: int, bf16: bool) -> dict:
    """_launches_per_step with each sequence-parallel stack's attention on
    the ring: rows 6 and 7 sp times a layer instead of the BSH kernels."""
    n = _launches_per_step(program, bf16)
    block = program.global_block()
    for op in block.ops:
        if op.type == "fused_encoder_stack" and op.attr("sequence_parallel"):
            layers = block.var(op.inputs["QKVW"][0]).shape[0]
            n["bsh_fwd"] -= layers
            n["bsh_bwd"] -= 2 * layers
            n["row6"] += sp * layers
            n["row7"] += sp * layers
    for k in ("bsh_fwd", "bsh_bwd", "row6", "row7", "row8", "row9"):
        n[f"{k}_tc"] = n[k] if bf16 else 0
    return n


def _dist_launches_per_step(program, plan, bf16: bool) -> dict:
    """The launches one rank's step of ``program`` under ``plan`` makes:
    the sp ring's (``_ring_launches_per_step``) or the program's, and
    under the pipeline each stack (BERT's: a per-key bias, no remat)
    runs its L / pp layers once a microbatch, M times, where the program
    counts L layers once: rows 4 and 5 (under sp the ring's rows 6 and
    7, sp each) and two LN forwards and backwards a layer."""
    mesh = plan["mesh"]
    sp = mesh.get("sp", 1)
    n = (_ring_launches_per_step(program, sp, bf16) if sp > 1
         else _launches_per_step(program, bf16))
    if plan.get("pipeline"):
        block = program.global_block()
        per_layer = ({"row6": sp, "row7": sp} if sp > 1
                     else {"bsh_fwd": 1, "bsh_bwd": 2})
        per_layer.update(ln_fwd=2, ln_bwd=2)
        for op in block.ops:
            if op.type == "fused_encoder_stack":
                layers = block.var(op.inputs["QKVW"][0]).shape[0]
                extra = layers * plan["acc"] // mesh["pp"] - layers
                for k, v in per_layer.items():
                    n[k] += v * extra
        for k in ("bsh_fwd", "bsh_bwd", "row6", "row7", "row8", "row9"):
            n[f"{k}_tc"] = n[k] if bf16 else 0
    return n


class _Utilization:
    """nvidia-smi's utilization.gpu sampled every 100 ms: the share of
    each sample period in which a kernel of any process ran on the card
    (the ranks share it, so no one process's profiler sees it whole)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        return [int(x) for x in out.split() if x.strip().isdigit()]


def _gathered(scope, program, name):
    """``name``'s global value: this rank's block gathered over the axes
    that shard it ("tp", "pp"); a collective under such a program, which
    every rank calls in the same order."""
    from paddle_tpu_torch.parallel import gather_shard, get_var_sharding

    t = scope.find_var(name)
    mesh = getattr(program, "_mesh", None)
    var = program.global_block()._find_var_recursive(name)
    spec = None if var is None or mesh is None else get_var_sharding(var)
    return gather_shard(t, spec, mesh) if spec else t


def _params(scope, program) -> dict:
    """Every parameter of ``program`` on the host, gathered to its
    global value (every rank calls it)."""
    return {p.name: _gathered(scope, program, p.name).detach().cpu()
            for p in program.all_parameters()}


class _GatheredScope:
    """``scope`` as ``_state_hash`` reads it, each variable gathered."""

    def __init__(self, scope, program):
        self.scope, self.program = scope, program

    def find_var(self, name):
        return _gathered(self.scope, self.program, name)


def _sharded_names(program) -> dict:
    """name -> the mesh axes that shard it, for each persistable a rank
    holds a block of."""
    from paddle_tpu_torch.parallel import get_var_sharding, param_axes

    return {v.name: {a for _, a in param_axes(get_var_sharding(v))}
            for v in program.list_vars()
            if v.persistable and param_axes(get_var_sharding(v))}


def _dist_train_run(torch, cfg, amp: bool, steps: int, timed: int = 0,
                    scope=None, keep_params: bool = False,
                    plan=DIST_TRAIN, probe=None) -> dict:
    """One rank's training under ``plan``'s mesh: startup (rank 0's
    weights broadcast, each rank keeping its blocks of what tp or pp
    shard), ``steps`` steps held to their exact launches, the collective
    costs a step, then ``timed`` steps with the card's utilization
    sampled (rank 0); with ``keep_params`` rank 0 returns its parameters
    after the steps, gathered (the ranks' states are compared by hash:
    ``state_hash`` of the gathered state, ``local_hash`` of the blocks
    this rank holds, ``replicated_hash`` of what no axis shards); a MoE
    program gives its first step's routing (``routing``, ``_moe_routing``
    a layer); ``probe(i, scope, main)``, called after each of the
    ``steps``, gives ``probes``."""
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    c = plan
    t_run = time.perf_counter()
    main, startup, loss = _fleet_bert_program(cfg, amp, c["mesh"], plan)
    exe = fluid.Executor()
    out = {}
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        out["init_hash"] = _state_hash(_GatheredScope(scope, main), params)
    out["setup_s"] = time.perf_counter() - t_run
    want = _dist_launches_per_step(main, plan, amp)
    feed = bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                      c["max_preds"], seed=0)
    counters = _counters()

    def step():
        return float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0].reshape(-1)[0])

    losses, step_ms, comm, probes, routing = [], [], [], [], []
    total = dict.fromkeys(counters, 0)
    for i in range(steps):
        tdist.reset_stats()
        t0 = time.perf_counter()
        with (_watch_op("moe_ffn", _moe_routing(routing))
              if i == 0 and cfg.moe_num_experts else contextlib.nullcontext()):
            lv, got = _count_step(counters, step)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        # this step's own: later collectives add to the live stats
        comm.append(dict(tdist.stats, by={k: dict(v) for k, v in
                                          tdist.stats["by"].items()}))
        if routing:
            out["routing"] = routing[:cfg.num_hidden_layers]
        if got != want:
            raise RuntimeError(f"step {i} launched {got}, the program "
                               f"needs {want}")
        total = {k: total[k] + got[k] for k in total}
        losses.append(lv)
        if probe is not None:
            probes.append(probe(i, scope, main))
    if timed:
        torch.cuda.synchronize()
        dist.barrier()
        util = _Utilization() if dist.get_rank() == 0 else None
        try:
            t0 = time.perf_counter()
            for _ in range(timed):
                losses.append(step())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            samples = util.stop() if util else None
        out["window"] = {"steps": timed, "wall_ms": wall,
                         "utilization": samples}
    t_hash = time.perf_counter()
    state = [v.name for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None]
    sharded = _sharded_names(main)
    gathered = _GatheredScope(scope, main)
    # each variable gathered once, the state's hash of theirs; without
    # ``gather_state`` the replicated ones only (the ranks holding the
    # same blocks are held equal by ``local_hash``, which implies the
    # gathered state's equality)
    if c.get("gather_state", True):
        by_var = {n: _state_hash(gathered, [n]) for n in sorted(state)}
    else:
        by_var = {n: _state_hash(scope, [n]) for n in sorted(state)
                  if n not in sharded}
    out.update(losses=losses, step_ms=step_ms, comm=comm,
               launches_per_step=want, launches=total,
               state_hash=hashlib.sha256(json.dumps(by_var).encode())
               .hexdigest(), var_hashes=by_var,
               local_hash=_state_hash(scope, state),
               replicated_hash=_state_hash(
                   scope, [n for n in state if n not in sharded]),
               block_axes=sorted(set().union(*sharded.values())),
               probes=probes, scope=scope)
    if keep_params:
        params = _params(scope, main)
        if dist.get_rank() == 0:
            out["params"] = params
    out["hash_s"] = time.perf_counter() - t_hash
    return out


def _dist_train_child(torch, rank: int, world: int) -> dict:
    """BERT-base bf16 (3 + 2 profiled steps), 2 layers f32 (3 steps), then
    dropout 0.1 (2 steps) on the bf16 run's state."""
    depth = DIST_TRAIN["layers"]
    bf16 = _dist_train_run(torch, _dist_bert_cfg(layers=depth), True,
                           DIST_TRAIN["steps"], DIST_TRAIN["timed"])
    scope = bf16.pop("scope")
    drop = _dist_train_run(torch, _dist_bert_cfg(layers=depth, dropout=0.1),
                           True, DIST_TRAIN["drop_steps"], scope=scope)
    drop.pop("scope")
    del scope
    torch.cuda.empty_cache()
    f32 = _dist_train_run(torch, _dist_bert_cfg(layers=2), False,
                          DIST_TRAIN["steps"], keep_params=True)
    f32.pop("scope")
    return {"bf16": bf16, "f32": f32, "dropout": drop,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def _head_seed(torch, plan) -> int:
    """The dropout seed this rank's attention draws its heads' masks
    from, out of one step generator (``head_shard``; the mesh of
    ``plan`` bound)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import create_mesh

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    return fa.head_shard(12, gen, create_mesh(plan["mesh"]))[1] \
        .initial_seed()


def _dist_plan_child(torch, plans) -> dict:
    """Each plan's runs on this rank: BERT-base bf16 (3 + 2 timed
    steps), 2 layers in f32 (3 steps, parameters gathered), then dropout
    0.1 on the bf16 run's state (``drop_steps``)."""
    out, peak = {}, 0.0
    for name, plan in plans:
        torch.cuda.reset_peak_memory_stats()
        fuse, moe = plan["fuse_stack"], bool(plan.get("moe"))
        bf16 = _dist_train_run(torch, _dist_bert_cfg(plan["layers"],
                                                     fuse_stack=fuse,
                                                     moe=moe), True,
                               plan["steps"], plan["timed"], plan=plan)
        scope = bf16.pop("scope")
        drop = None
        if plan["drop_steps"]:
            drop = _dist_train_run(
                torch, _dist_bert_cfg(plan["layers"], dropout=0.1,
                                      fuse_stack=fuse), True,
                plan["drop_steps"], scope=scope, plan=plan)
            drop.pop("scope")
            if plan.get("tp"):
                drop["head_seed"] = _head_seed(torch, plan)
        del scope
        torch.cuda.empty_cache()
        f32 = _dist_train_run(torch, _dist_bert_cfg(layers=2,
                                                    fuse_stack=fuse,
                                                    moe=moe),
                              False, plan["steps"], keep_params=True,
                              plan=plan)
        f32.pop("scope")
        torch.cuda.empty_cache()
        plan_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peak = max(peak, plan_peak)
        out[name] = {"bf16": bf16, "f32": f32, "dropout": drop,
                     "peak_mem_gb": plan_peak}
    out["peak_mem_gb"] = peak
    return out


def _dist_tp_child(torch, rank: int, world: int) -> dict:
    return _dist_plan_child(torch, [("tp", DIST_TP)])


def _dist_pp_child(torch, rank: int, world: int) -> dict:
    return _dist_plan_child(torch, [("pp", DIST_PP), ("pp_sp", DIST_PP_SP)])


def _dist_ep_child(torch, rank: int, world: int) -> dict:
    return _dist_plan_child(torch, [("ep", DIST_EP), ("ep4", DIST_EP4)])


_ONE_PROCESS = {}


def _one_process_run(torch, cfg, amp: bool, steps: int,
                     keep_params: bool = False) -> dict:
    """The same program without a mesh, in this process: the reference of
    the dist phases (same seed-0 startup, same global batch); with
    ``keep_params`` its parameters after ``steps`` steps.  Kept for the
    phases that share it (dist_train and dist_pp: the fused stack)."""
    key = (cfg.fuse_stack, cfg.num_hidden_layers, cfg.moe_num_experts, amp,
           steps, keep_params)
    if key not in _ONE_PROCESS:
        _ONE_PROCESS[key] = _one_process_train(torch, cfg, amp, steps,
                                               keep_params)
    return _ONE_PROCESS[key]


def _one_process_train(torch, cfg, amp: bool, steps: int,
                       keep_params: bool = False) -> dict:
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    c = DIST_TRAIN
    main, startup, loss = _train_program(cfg, c["batch"], c["seq"],
                                         c["max_preds"], amp)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = _state_hash(scope, [p.name for p in main.all_parameters()])
    feed = bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                      c["max_preds"], seed=0)
    losses, step_ms, routing = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        with (_watch_op("moe_ffn", _moe_routing(routing))   # the first step's
              if i == 0 and cfg.moe_num_experts else contextlib.nullcontext()):
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)[0][0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"losses": losses, "init_hash": init,
           "routing": routing[:cfg.num_hidden_layers] or None,
           "step_ms_after_first": statistics.median(step_ms[1:])}
    if keep_params:
        out["params"] = _params(scope, main)
    return out


def _block_group(mesh: dict, rank: int, axes) -> tuple:
    """The coordinates of ``rank`` on ``axes``, the mesh axes that shard
    the run's state: ranks that share them hold the same blocks."""
    from paddle_tpu_torch.parallel import Mesh

    coords = Mesh(mesh, rank).coords
    return tuple(coords[a] for a in sorted(axes) if a in coords)


def _dist_holds(phase: str, c: dict, ranks: list, refs: tuple,
                out: dict) -> None:
    """The holds every dist training phase makes, into ``out``: for the
    bf16 and the f32 runs, every rank started from the one-process run's
    weights (gathered), the ranks' losses and gathered state equal bit
    for bit and the blocks equal on the ranks that hold the same ones,
    the losses within the limit of the one-process run's, the f32
    parameters (gathered) within DIST_PARAM_F32 of its; each rank's step
    wall, launches and collectives; the card's idle share over the bf16
    run's timed window."""
    for what, ref, limit in (("bf16", refs[0], DIST_LOSS_BF16),
                             ("f32", refs[1], DIST_LOSS_F32)):
        runs = [r[what] for r in ranks]
        if any(r["init_hash"] != ref["init_hash"] for r in runs):
            fail(f"{phase} {what}: the ranks did not start from the "
                 f"one-process run's weights")
        for r, run in enumerate(runs[1:], 1):
            if run["losses"] != runs[0]["losses"] \
                    or run["state_hash"] != runs[0]["state_hash"]:
                differ = sorted(n for n, h in run["var_hashes"].items()
                                if runs[0]["var_hashes"].get(n) != h)
                fail(f"{phase} {what}: rank {r} differs from rank 0 "
                     f"(losses {run['losses']} vs {runs[0]['losses']}; "
                     f"state {differ[:8]})")
        groups = {}
        for r, run in enumerate(runs):
            groups.setdefault(_block_group(c["mesh"], r,
                                           run["block_axes"]), set()).add(
                run["local_hash"])
        if any(len(h) != 1 for h in groups.values()):
            fail(f"{phase} {what}: ranks holding the same blocks differ")
        mine = runs[0]["losses"][:c["steps"]]
        diff = max(abs(a - b) for a, b in zip(mine, ref["losses"][
            :c["steps"]]))
        if not math.isfinite(diff) or diff > limit:
            fail(f"{phase} {what}: losses {mine} vs one process "
                 f"{ref['losses']}: {diff} > {limit}")
        params = None
        if "params" in ref:
            got_p, want_p = runs[0]["params"], ref["params"]
            if sorted(got_p) != sorted(want_p):
                fail(f"{phase} {what}: parameters {sorted(got_p)} vs "
                     f"{sorted(want_p)}")
            per = {n: float((got_p[n].float() - want_p[n].float()).abs()
                            .max()) for n in want_p}
            worst = max(per, key=per.get)
            if not math.isfinite(per[worst]) or per[worst] > DIST_PARAM_F32:
                fail(f"{phase} {what}: parameter {worst} differs from "
                     f"the one-process run's by {per[worst]} > "
                     f"{DIST_PARAM_F32}")
            params = {"max_abs_diff": per[worst], "worst": worst,
                      "count": len(per), "limit": DIST_PARAM_F32}
        comm = [st for run in runs for st in run["comm"][1:]]
        out[what] = {
            "losses": runs[0]["losses"], "one_process": ref["losses"],
            "one_process_step_ms": ref["step_ms_after_first"],
            "loss_diff": diff, "limit": limit, "ranks_bit_equal": True,
            "blocks_equal_by_group": len(groups),
            "params_vs_one_process": params,
            "step_ms_median_by_rank": [statistics.median(run["step_ms"])
                                       for run in runs],
            "step_ms_by_rank": [run["step_ms"] for run in runs],
            "launches_per_step": runs[0]["launches_per_step"],
            "launches": runs[0]["launches"],
            "collectives_per_step": {
                k: statistics.median(st[k] for st in comm)
                for k in ("calls", "bytes", "ms", "stage_ms")},
            "collectives_per_step_by": _comm_by(runs[0]["comm"][1:])}
    util = ranks[0]["bf16"]["window"]["utilization"]
    out["bf16"]["window"] = {
        "steps": c["timed"],
        "wall_ms_by_rank": [r["bf16"]["window"]["wall_ms"] for r in ranks],
        "utilization_samples": util,
        "card_idle_share": (1 - statistics.mean(util) / 100) if util
        else "not measured",
        "note": "nvidia-smi utilization.gpu every 100 ms over the window: "
                "the share of time a kernel of any rank ran"}


def _dist_dropout(phase: str, ranks: list) -> dict:
    """The dropout 0.1 run: finite losses, equal on every rank."""
    drop = [r["dropout"]["losses"] for r in ranks]
    if not all(math.isfinite(x) for x in drop[0]) or any(d != drop[0]
                                                          for d in drop):
        fail(f"{phase} dropout 0.1: losses {drop}")
    return {"p": 0.1, "losses": drop[0]}


def _dist_refs(torch, fuse_stack: bool, plan: dict) -> tuple:
    """The one-process bf16 (steps + timed, at ``plan``'s depth) and
    2-layer f32 runs of ``plan``'s model."""
    c = DIST_TRAIN
    moe = bool(plan.get("moe"))
    ref_bf16 = _one_process_run(torch, _dist_bert_cfg(plan["layers"],
                                                      fuse_stack=fuse_stack,
                                                      moe=moe),
                                True, c["steps"] + c["timed"])
    torch.cuda.empty_cache()
    ref_f32 = _one_process_run(torch, _dist_bert_cfg(layers=2,
                                                     fuse_stack=fuse_stack,
                                                     moe=moe),
                               False, c["steps"], keep_params=True)
    torch.cuda.empty_cache()
    return ref_bf16, ref_f32


def _dist_header(phase, card, c, ranks_backend) -> dict:
    return {"phase": phase, "card": card, "world": DIST_WORLD,
            "mesh": c["mesh"], "backend": ranks_backend,
            "bf16_layers": c["layers"],
            "batch": c["batch"], "seq": c["seq"],
            "per_rank_batch": [c["batch"] // c["mesh"].get("dp", 1)
                               // c["mesh"].get("dcn", 1),
                               c["seq"] // c["mesh"].get("sp", 1)]}


def phase_dist_train(torch, card: str, ranks: list) -> dict:
    """BERT-base pretraining (bert_train's program at BERT-base widths,
    ``DIST_TRAIN["layers"]`` layers, dropout off) under
    fleet at dp 2 x sp 2 on four ranks sharing the card over gloo, global
    batch 8 x 512 (4 x 256 a rank): 3 steps against the same program and
    weights in one process without a mesh (bf16 within 2e-2), the same at
    2 layers in f32 (within 1e-4), the four ranks' losses and state equal
    bit for bit; 2 profiled steps (each rank's step wall, the card's idle
    share, time and bytes in collectives); then 2 steps with dropout 0.1,
    finite.  ``ranks``: the ranks' results."""
    t0 = time.perf_counter()
    c = DIST_TRAIN
    refs = _dist_refs(torch, True, c)
    ref_s = time.perf_counter() - t0
    out = _dist_header("dist_train", card, c, ranks[0]["backend"])
    _dist_holds("dist_train", c, ranks, refs, out)
    out["dropout"] = _dist_dropout("dist_train", ranks)
    out["peak_mem_gb_by_rank"] = [r["peak_mem_gb"] for r in ranks]
    out["reference_s"] = ref_s
    out["concurrent_with"] = ranks[0]["concurrent_with"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_dist_tp(torch, card: str, raw: list) -> dict:
    """BERT-base (its widths, ``DIST_TP["layers"]`` layers) unfused with
    tensor_parallel_rules() at dp 2 x tp 2 on
    four ranks sharing the card over gloo (``_dist_holds`` against the
    unfused program in one process); then dropout 0.1: finite, the
    replicated state equal on every rank, the head-shard dropout seeds
    different on the two ranks of a tp pair and equal across dp.
    ``raw``: the ranks' results."""
    t0 = time.perf_counter()
    c = DIST_TP
    refs = _dist_refs(torch, False, c)
    ref_s = time.perf_counter() - t0
    ranks = [r["tp"] for r in raw]
    out = _dist_header("dist_tp", card, c, raw[0]["backend"])
    _dist_holds("dist_tp", c, ranks, refs, out)
    out["dropout"] = _dist_dropout("dist_tp", ranks)
    rep = {r["dropout"]["replicated_hash"] for r in ranks}
    seeds = [r["dropout"]["head_seed"] for r in ranks]
    # ranks 0, 1 (and 2, 3) are a tp pair; 0 and 2 share the tp index
    if len(rep) != 1 or seeds[0] == seeds[1] or seeds[0] != seeds[2] \
            or seeds[1] != seeds[3]:
        fail(f"dist_tp dropout: replicated state {len(rep)} ways, head "
             f"seeds {seeds}")
    out["dropout"].update(replicated_state_equal=True,
                          head_seeds_by_rank=seeds)
    out["peak_mem_gb_by_rank"] = [r["peak_mem_gb"] for r in raw]
    out["reference_s"] = ref_s
    out["concurrent_with"] = raw[0]["concurrent_with"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_dist_pp(torch, card: str, raw: list) -> dict:
    """BERT-base (its widths, ``DIST_PP["layers"]`` layers) with the
    fused stack and the pipeline at dp 2 x pp 2 (accumulate_steps 2,
    half the layers a stage), then pp 2 x sp 2, on the same
    four rank processes (``_dist_holds`` against dist_train's one-process
    runs; dropout 0.1 at dp 2 x pp 2; ``raw``: the ranks' results)."""
    t0 = time.perf_counter()
    refs = _dist_refs(torch, True, DIST_PP)
    ref_s = time.perf_counter() - t0
    out = {"phase": "dist_pp", "card": card}
    for name, c in (("pp", DIST_PP), ("pp_sp", DIST_PP_SP)):
        ranks = [r[name] for r in raw]
        sub = _dist_header(f"dist_pp {name}", card, c, raw[0]["backend"])
        sub["microbatches"] = c["acc"]
        _dist_holds(f"dist_pp {name}", c, ranks, refs, sub)
        if c["drop_steps"]:
            sub["dropout"] = _dist_dropout(f"dist_pp {name}", ranks)
        out[name] = sub
    out["peak_mem_gb_by_rank"] = [r["peak_mem_gb"] for r in raw]
    out["reference_s"] = ref_s
    out["concurrent_with"] = raw[0]["concurrent_with"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _comm_by(comm: list) -> dict:
    """Rank 0's calls, bytes and ms a step of each "collective:axis",
    the median over ``comm`` (``distributed.stats`` a step)."""
    keys = sorted({k for st in comm for k in st.get("by", {})})
    zero = {"calls": 0, "bytes": 0, "ms": 0.0}
    return {k: {f: statistics.median(st.get("by", {}).get(k, zero)[f]
                                     for st in comm)
                for f in ("calls", "bytes", "ms")} for k in keys} \
        if comm else {}


def _load_of(picks: np.ndarray, n_exp: int) -> dict:
    """The global routing of one layer from every token's top-k picks
    ([T, k], the data shards' tokens in order): the capacity, the share
    of (token, slot) pairs over it (slot 0's queue first, as the op
    places them) and the max / mean expert load."""
    from paddle_tpu_torch.ops.moe_ops import moe_capacity

    t, k = picks.shape
    totals = np.stack([np.bincount(picks[:, j], minlength=n_exp)
                       for j in range(k)])
    cap = moe_capacity(t, n_exp, k, DIST_MOE["moe_capacity_factor"])
    before = np.cumsum(totals, 0) - totals
    kept = np.minimum(totals, np.clip(cap - before, 0, None))
    load = totals.sum(0)
    return {"capacity": cap, "dropped_share": float((totals - kept).sum()
                                                    / totals.sum()),
            "max_over_mean_load": float(load.max() / load.mean())}


def _routing_stats(ranks: list, ref: list, mesh: dict) -> list:
    """Each MoE layer's first bf16 step: the (token, slot) pairs over
    capacity, the max / mean expert load and the aux loss, on the ranks
    (their picks joined over the data shards) and in one process; the
    share of tokens whose top-k picks equal the one process's, and the
    one process's f32 logit margin (k-th choice less the next) of each
    that does not."""
    from paddle_tpu_torch.parallel import Mesh

    n_exp = DIST_MOE["moe_num_experts"]
    shards = sorted((Mesh(mesh, r).coords.get("dp", 0), r)
                    for r in range(len(ranks))
                    if Mesh(mesh, r).coords.get("ep", 0) == 0)
    out = []
    for layer, want in enumerate(ref):
        got = [ranks[r][layer] for _, r in shards]
        picks = np.concatenate([g["picks"].numpy() for g in got])
        ref_picks = want["picks"].numpy()
        same = (picks == ref_picks).all(-1)
        margins = want["margin"].numpy()[~same]
        load, ref_load = _load_of(picks, n_exp), _load_of(ref_picks, n_exp)
        out.append({
            "capacity": load["capacity"],
            "dropped_share": load["dropped_share"],
            "dropped_share_one_process": ref_load["dropped_share"],
            "max_over_mean_load": load["max_over_mean_load"],
            "max_over_mean_load_one_process": ref_load["max_over_mean_load"],
            "aux": got[0]["aux"], "aux_one_process": want["aux"],
            "top_k_match_share": float(same.mean()),
            "flips": int((~same).sum()),
            "flip_margins_f32": sorted(float(m) for m in margins)[:8]})
    return out


def _first_flips(routing: list) -> dict:
    """The first layer whose top-k picks differ from the one process's,
    and those flips' f32 logit margins: no earlier flip moved that
    layer's inputs, so only the bf16 rounding of its own inputs
    explains them."""
    for layer, r in enumerate(routing):
        if r["flips"]:
            return {"layer": layer, "flips": r["flips"],
                    "margins_f32": r["flip_margins_f32"]}
    return {"layer": None, "flips": 0, "margins_f32": []}


def phase_dist_ep(torch, card: str, raw: list) -> dict:
    """BERT-base unfused with a moe_ffn of 8 experts in every layer
    (top-2, capacity factor 1.25) at dp 2 x ep 2, then dp 1 x ep 4, on
    four ranks sharing the card over gloo (``raw``: the ranks' results;
    ``_dist_holds`` against the same program in one process: bf16
    losses, 2 layers f32 with every parameter gathered); each layer's
    routing on the first step against the one process's."""
    t0 = time.perf_counter()
    refs = _dist_refs(torch, False, DIST_EP)
    ref_s = time.perf_counter() - t0
    out = {"phase": "dist_ep", "card": card, "moe": DIST_MOE}
    for name, c in (("ep", DIST_EP), ("ep4", DIST_EP4)):
        ranks = [r[name] for r in raw]
        sub = _dist_header(f"dist_ep {name}", card, c, raw[0]["backend"])
        _dist_holds(f"dist_ep {name}", c, ranks, refs, sub)
        sub["routing"] = _routing_stats(
            [r["bf16"]["routing"] for r in ranks], refs[0]["routing"],
            c["mesh"])
        sub["first_flips"] = _first_flips(sub["routing"])
        sub["peak_mem_gb_by_rank"] = [r["peak_mem_gb"] for r in ranks]
        out[name] = sub
    out["reference_s"] = ref_s
    out["concurrent_with"] = raw[0]["concurrent_with"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _dist_zero_child(torch, rank: int, world: int) -> dict:
    """BERT-base with the fused stack, bf16 AMP, at dp 4: ZeRO-2
    (``strategy.sharding``), then the unsharded run; each with its
    Adam-moment bytes on this rank and its peak memory."""
    out = {}
    for name, plan in (("zero", dict(DIST_ZERO, sharding=True)),
                       ("dp", DIST_ZERO)):
        torch.cuda.reset_peak_memory_stats()
        run = _dist_train_run(torch, _dist_bert_cfg(plan["layers"]), True,
                              plan["steps"], plan["timed"], plan=plan)
        scope = run.pop("scope")
        run["moment_bytes"] = sum(t.numel() * t.element_size()
                                  for n, t in scope.vars.items()
                                  if "_moment" in n)
        run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del scope
        torch.cuda.empty_cache()
        out[name] = run
    return out


def _same_runs(phase: str, runs: list) -> None:
    """Every rank's losses and gathered state equal bit for bit."""
    for r, run in enumerate(runs[1:], 1):
        if run["losses"] != runs[0]["losses"] \
                or run["state_hash"] != runs[0]["state_hash"]:
            fail(f"{phase}: rank {r} differs from rank 0 (losses "
                 f"{run['losses']} vs {runs[0]['losses']})")


def _loss_diff(phase: str, got: list, want: list, limit: float) -> float:
    diff = max(abs(a - b) for a, b in zip(got, want))
    if not math.isfinite(diff) or diff > limit:
        fail(f"{phase}: losses {got} vs {want}: {diff} > {limit}")
    return diff


def _window(run: dict) -> dict:
    util = run["window"]["utilization"]
    return {"steps": run["window"]["steps"], "wall_ms": run["window"]
            ["wall_ms"], "card_idle_share": (1 - statistics.mean(util) / 100)
            if util else "not measured"}


def phase_dist_zero(torch, card: str, raw: list) -> dict:
    """BERT-base (fused stack, bf16 AMP, Adam) at dp 4 with
    ``strategy.sharding`` and without (``raw``: the ranks' results), 3 +
    2 timed steps each: every
    master parameter and every moment (gathered) after the steps equal
    bit for bit between the two, the losses too; the losses within
    DIST_LOSS_BF16 of one process; each rank's Adam-moment bytes, peak
    memory, and the parameters' all-gather a step."""
    t0 = time.perf_counter()
    c = DIST_ZERO
    ref = _dist_refs(torch, True, c)[0]
    out = _dist_header("dist_zero", card, c, raw[0]["backend"])
    for name in ("zero", "dp"):
        runs = [r[name] for r in raw]
        if any(r["init_hash"] != ref["init_hash"] for r in runs):
            fail(f"dist_zero {name}: the ranks did not start from the "
                 f"one-process run's weights")
        _same_runs(f"dist_zero {name}", runs)
        comm = runs[0]["comm"][1:]
        out[name] = {
            "losses": runs[0]["losses"],
            "loss_diff": _loss_diff(f"dist_zero {name}",
                                    runs[0]["losses"][:c["steps"]],
                                    ref["losses"][:c["steps"]],
                                    DIST_LOSS_BF16),
            "step_ms_median_by_rank": [statistics.median(r["step_ms"])
                                       for r in runs],
            "moment_bytes_by_rank": [r["moment_bytes"] for r in runs],
            "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in runs],
            "collectives_per_step_by": _comm_by(comm),
            "launches_per_step": runs[0]["launches_per_step"],
            "launches": runs[0]["launches"], "window": _window(runs[0])}
    differ = []
    for r in raw:
        z, d = r["zero"], r["dp"]
        if z["losses"] != d["losses"]:
            fail(f"dist_zero: losses {z['losses']} sharded vs "
                 f"{d['losses']} unsharded")
        differ += [n for n, h in d["var_hashes"].items()
                   if z["var_hashes"].get(n) != h]
    if differ:
        fail(f"dist_zero: the sharded run's state differs from the "
             f"unsharded one's: {sorted(set(differ))[:8]}")
    out.update(one_process=ref["losses"], limit=DIST_LOSS_BF16,
               state_bit_equal_vars=len(raw[0]["dp"]["var_hashes"]),
               moment_bytes_ratio=raw[0]["zero"]["moment_bytes"]
               / raw[0]["dp"]["moment_bytes"],
               concurrent_with=raw[0]["concurrent_with"],
               seconds=time.perf_counter() - t0)
    emit(out)
    return out


def _dist_dcn_child(torch, rank: int, world: int) -> dict:
    """BERT-base (fused stack, bf16 AMP) at dcn 2 x dp 2: the dense
    two-level sync (3 + 2 timed steps), its 2-layer f32 run and flat dp
    4's; DGC (sparsity 0.9, one dense step) with the probe gradient's
    sync captured at its first sparse step; LocalSGD (k 2), this slice's
    parameters hashed after each step; all at ``DIST_DCN["layers"]``
    layers but the f32 runs."""
    c = DIST_DCN
    out = {}
    for name, cfg, amp, plan, timed, keep in (
            ("dense", _dist_bert_cfg(c["layers"]), True, c, c["timed"],
             False),
            ("f32", _dist_bert_cfg(layers=2), False, c, 0, True),
            ("flat_f32", _dist_bert_cfg(layers=2), False, DIST_ZERO, 0,
             True)):
        run = _dist_train_run(torch, cfg, amp, plan["steps"], timed,
                              keep_params=keep, plan=plan)
        run.pop("scope")
        torch.cuda.empty_cache()
        out[name] = run
    seen = {}

    def probe(ins, attrs, outs):
        x, step = ins["X"][0], ins.get("Step")
        if tuple(x.shape) == DIST_DGC_PROBE and step is not None \
                and float(step[0].reshape(-1)[0]) == 1.0:
            seen.update(x=x.cpu(), ef=ins["ErrorFeedback"][0].cpu(),
                        out=outs["Out"][0].cpu(),
                        ef_out=outs["ErrorFeedback"][0].cpu(),
                        sparsity=attrs["sparsity"],
                        wire=attrs["wire_dtype"])

    with _watch_op("c_dcn_grad_sync", probe):
        dgc = _dist_train_run(torch, _dist_bert_cfg(DIST_DGC["layers"]), True,
                              DIST_DGC["steps"], plan=DIST_DGC)
    dgc.pop("scope")
    dgc["probe"] = seen
    torch.cuda.empty_cache()

    def slice_params(i, scope, main):
        return _state_hash(scope, [p.name for p in main.all_parameters()])

    lsgd = _dist_train_run(torch, _dist_bert_cfg(DIST_LSGD["layers"]), True,
                           DIST_LSGD["steps"], plan=DIST_LSGD,
                           probe=slice_params)
    lsgd.pop("scope")
    out.update(dgc=dgc, lsgd=lsgd,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _dgc_recompute(probes: list, mesh: dict) -> dict:
    """c_dcn_grad_sync's DGC on the host from the ranks' captured inputs
    (each rank's gradient, each slice's error feedback): the mean over
    dp, g + e, the top k by magnitude (the lower index on a tie), the
    sent values on the wire dtype, the feedback kept, the pairs of both
    slices scatter-added and divided by n_dcn; against what the card
    gave each rank."""
    import torch

    from paddle_tpu_torch.fluid.dtypes import to_torch_dtype
    from paddle_tpu_torch.parallel import Mesh

    n_dcn, dp = mesh["dcn"], mesh["dp"]
    coords = [Mesh(mesh, r).coords for r in range(len(probes))]
    wire = probes[0]["wire"]
    sent, want_ef = [], {}
    for sl in range(n_dcn):
        mine = [p for p, c in zip(probes, coords) if c["dcn"] == sl]
        g = mine[0]["x"]
        for p in mine[1:]:
            g = g + p["x"]
        g = g / dp
        acc = (g + mine[0]["ef"][0]).float()
        flat = acc.reshape(-1)
        k = max(1, int(round(flat.numel() * (1.0 - mine[0]["sparsity"]))))
        top = torch.sort(-flat.abs(), stable=True).indices[:k]
        vals = flat[top]
        if wire:
            vals = vals.to(to_torch_dtype(wire))
        put = torch.zeros_like(flat).index_put_((top,), vals.float())
        want_ef[sl] = (flat - put).reshape(acc.shape)[None]
        sent.append((top, vals))
    flat = torch.zeros(probes[0]["x"].numel(), dtype=torch.float32)
    for top, vals in sent:
        flat = flat.index_add_(0, top, vals.float())
    synced = (flat.reshape(probes[0]["x"].shape) / n_dcn).to(
        probes[0]["x"].dtype)
    out_diff = max(float((p["out"].float() - synced.float()).abs().max())
                   for p in probes)
    ef_diff = max(float((p["ef_out"] - want_ef[c["dcn"]]).abs().max())
                  for p, c in zip(probes, coords))
    return {"k": int(sent[0][0].numel()), "numel": probes[0]["x"].numel(),
            "wire": wire, "synced_max_abs_diff": out_diff,
            "error_feedback_max_abs_diff": ef_diff}


def phase_dist_dcn(torch, card: str, raw: list, flat: list) -> dict:
    """BERT-base (fused stack, bf16 AMP, the bf16 wire on the dcn hop) at
    dcn 2 x dp 2 on four ranks sharing the card over gloo (``raw``: the
    ranks' results): the dense two-level sync held as ``_dist_holds``
    against one process, its bf16 losses against flat dp 4's (``flat``:
    dist_zero's unsharded run) and its 2-layer f32 parameters against
    flat dp 4's; DGC (sparsity 0.9 after one dense step): finite losses,
    the two dp ranks of a slice bit for bit, the synced gradient and
    error feedback of DIST_DGC_PROBE's gradient equal to the
    host's recomputation from the ranks' inputs; LocalSGD (k 2): the
    slices differ after the off step and are equal after the sync step.
    Bytes on the dcn hop a step, dense and DGC's k pairs."""
    t0 = time.perf_counter()
    c = DIST_DCN
    refs = _dist_refs(torch, True, c)
    out = _dist_header("dist_dcn", card, c, raw[0]["backend"])
    _dist_holds("dist_dcn", c, [{"bf16": r["dense"], "f32": r["f32"]}
                                for r in raw], refs, out)
    out["bf16"]["flat_dp4"] = flat
    out["bf16"]["flat_dp4_diff"] = _loss_diff(
        "dist_dcn vs flat dp 4", raw[0]["dense"]["losses"][:c["steps"]],
        flat[:c["steps"]], DIST_LOSS_BF16)
    got_p, want_p = raw[0]["f32"]["params"], raw[0]["flat_f32"]["params"]
    per = {n: float((got_p[n] - want_p[n]).abs().max()) for n in want_p}
    worst = max(per, key=per.get)
    if per[worst] > DIST_PARAM_F32:
        fail(f"dist_dcn f32: parameter {worst} differs from flat dp 4's by "
             f"{per[worst]} > {DIST_PARAM_F32}")
    out["f32"]["params_vs_flat_dp4"] = {"max_abs_diff": per[worst],
                                        "worst": worst}
    dgc = [r["dgc"] for r in raw]
    if not all(math.isfinite(x) for x in dgc[0]["losses"]):
        fail(f"dist_dcn dgc: losses {dgc[0]['losses']}")
    _same_runs("dist_dcn dgc", dgc)
    if dgc[0]["local_hash"] != dgc[1]["local_hash"] \
            or dgc[2]["local_hash"] != dgc[3]["local_hash"]:
        fail("dist_dcn dgc: the dp ranks of a slice differ")
    if any(not d["probe"] for d in dgc):
        fail("dist_dcn dgc: the probe parameter's sync was not captured")
    check = _dgc_recompute([d["probe"] for d in dgc], c["mesh"])
    if check["synced_max_abs_diff"] != 0 \
            or check["error_feedback_max_abs_diff"] != 0:
        fail(f"dist_dcn dgc: the card's sync differs from the host's "
             f"recomputation: {check}")
    lsgd = [r["lsgd"] for r in raw]
    after = [[r["probes"][i] for r in lsgd] for i in range(2)]
    if not (after[0][0] == after[0][1] and after[0][2] == after[0][3]
            and after[0][0] != after[0][2]):
        fail("dist_dcn localsgd: after the off step the slices should "
             "differ and the dp ranks of a slice agree")
    if len(set(after[1])) != 1:
        fail("dist_dcn localsgd: after the sync step the slices differ")
    dense_by = out["bf16"]["collectives_per_step_by"]
    dgc_by = [st.get("by", {}) for st in dgc[0]["comm"]]
    out["dgc"] = {
        "sparsity": DIST_DGC["dgc"]["sparsity"],
        "rampup_begin_step": DIST_DGC["dgc"]["rampup_begin_step"],
        "losses": dgc[0]["losses"],
        "step_ms_by_rank": [d["step_ms"] for d in dgc],
        "slice_ranks_bit_equal": True, "probe": check,
        "dcn_bytes_by_step": [
            {k: v["bytes"] for k, v in by.items() if k.endswith(":dcn")}
            for by in dgc_by],
        "launches": dgc[0]["launches"]}
    out["dense_dcn_bytes_per_step"] = {
        k: v["bytes"] for k, v in dense_by.items() if k.endswith(":dcn")}
    out["localsgd"] = {"k_steps": DIST_LSGD["localsgd"]["k_steps"],
                       "losses": lsgd[0]["losses"],
                       "slices_differ_after_off_step": True,
                       "slices_equal_after_sync_step": True,
                       "step_ms_by_rank": [r["step_ms"] for r in lsgd]}
    out["peak_mem_gb_by_rank"] = [r["peak_mem_gb"] for r in raw]
    out["concurrent_with"] = raw[0]["concurrent_with"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def _dist_nccl_child(torch, rank: int, world: int) -> dict:
    """One rank on NCCL: the 2-layer f32 program trained 2 steps in a dp 1
    mesh and without one, from the same weights; every c_* emitter once."""
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import registry as treg
    from paddle_tpu_torch.parallel import create_mesh

    if dist.get_backend() != "nccl":
        raise RuntimeError(f"init_parallel_env chose {dist.get_backend()}")
    c = DIST_TRAIN
    cfg = _dist_bert_cfg(layers=2)
    feed = bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                      c["max_preds"], seed=0)
    runs = {}
    for what in ("mesh", "plain"):
        if what == "mesh":
            main, startup, loss = _fleet_bert_program(cfg, False, {"dp": 1})
        else:
            main, startup, loss = _train_program(cfg, c["batch"], c["seq"],
                                                 c["max_preds"], False)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0].reshape(-1)[0])
                  for _ in range(2)]
        runs[what] = {"losses": losses, "ops": len(main.global_block().ops),
                      "state_hash": _state_hash(
                          scope, [p.name for p in main.all_parameters()])}
    mesh = create_mesh({"dp": 1})
    ctx = treg.EmitContext(device="cuda", mesh=mesh, axis_env=mesh.axis_env)
    x = torch.arange(12.0, device="cuda").reshape(4, 3) - 5.0
    emitters = {}
    for op in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
               "c_allreduce_prod", "c_broadcast", "c_allgather",
               "c_reducescatter", "c_identity", "c_sync_calc_stream",
               "c_sync_comm_stream", "c_wait_compute", "c_wait_comm"):
        y = treg.get(op).emit(ctx, {"X": [x]}, {"ring_id": 0})["Out"][0]
        torch.cuda.synchronize()
        emitters[op] = bool(torch.equal(y, x))
    return {"runs": runs, "emitters": emitters,
            "mesh_groups": sorted(mesh.groups)}


def phase_dist_nccl(torch, card: str, ranks: list) -> dict:
    """init_parallel_env() on the card at world size 1 picks NCCL: a dp 1
    mesh trains the 2-layer f32 program 2 steps equal bit for bit to the
    run without a mesh; every c_* emitter runs once on NCCL.  ``ranks``:
    the one rank's result."""
    t0 = time.perf_counter()
    res = ranks[0]
    runs = res["runs"]
    if res["backend"] != "nccl":
        fail(f"dist_nccl: backend {res['backend']}")
    if runs["mesh"]["losses"] != runs["plain"]["losses"] \
            or runs["mesh"]["state_hash"] != runs["plain"]["state_hash"]:
        fail(f"dist_nccl: the dp 1 mesh differs from the plain run: {runs}")
    if not all(res["emitters"].values()):
        fail(f"dist_nccl: emitters at world 1: {res['emitters']}")
    out = {"phase": "dist_nccl", "card": card, "backend": res["backend"],
           "mesh_groups": res["mesh_groups"], "runs": runs,
           "emitters_identity_at_world_1": res["emitters"],
           "concurrent_with": res["concurrent_with"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# the job control plane (dist_elastic): BERT-base with the fused stack,
# bf16 AMP, Adam and dropout 0.1 under ZeRO-2 at dp 4, started by the
# port's launcher; global batch 12 x 512 (3 sequences a rank at dp 4, 4
# at dp 3), sharded checkpoints every 2 steps, written without fsync
# (PADDLE_CKPT_FSYNC=0: the page cache holds them, the reads are warm)
# BERT-base at 4 of its 12 layers, as every other dist phase (it ran 12:
# the script's time went to resnet_recipe; the leases, the commit
# barrier, the relaunch and the eviction do not depend on the depth)
ELASTIC = dict(batch=12, seq=512, max_preds=76, freq=2, world=4, keep=5,
               lease_secs=10.0, device="cuda:0", bf16=True, dropout=0.1,
               bert={"num_hidden_layers": 4}, join_s=420)
# drill (a): trainer1 dies at its second save (step 4's) between its
# shard commit and the global commit
ELASTIC_FAULT = ("crash:ckpt_shard_committed:2", "trainer1")
# drill (b): trainer3 is lost for good at the start of step 5
ELASTIC_DIE = ("trainer3", 5)
ELASTIC_ROWS = ("bsh_fwd", "bsh_fwd_tc", "bsh_bwd", "bsh_bwd_tc", "ln_fwd",
                "ln_bwd")


def _elastic_child(cfg_path: str) -> int:
    """One rank of a dist_elastic job, started by the port's launcher
    (``python -m paddle_tpu_torch.distributed.launch ... chip_smoke.py
    --elastic-child CFG``): the launcher's rendezvous, heartbeat and lease,
    BERT pretraining under fleet at dp = the launcher's world with ZeRO-2,
    the newest globally committed sharded checkpoint restored (a resized
    world needs PADDLE_ELASTIC_RESHARD, which the launcher's resize
    exports), then the steps up to ``steps``: global batch g drawn from
    seed 1000 + g, each rank its dp block of it; a sharded save every
    ``freq`` steps.  Each step's launches of rows 2-5 are held to the
    program's on the card.  Every event goes to
    ``trace_dir/trace.<tag>.jsonl`` (appended across attempts).  A
    relaunched attempt drops PADDLE_PS_FAULT_SPEC: a crash rule kills one
    save, not every attempt's."""
    with open(cfg_path) as f:
        c = json.load(f)
    attempt = int(os.environ.get("PADDLE_ELASTIC_RESTART", "0"))
    if attempt > 0:
        os.environ.pop("PADDLE_PS_FAULT_SPEC", None)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import coordinator
    from paddle_tpu_torch.fluid import checkpoint as ckpt
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import env

    tag = os.environ["PADDLE_TRAINER_TAG"]
    trace = open(os.path.join(c["trace_dir"], f"trace.{tag}.jsonl"), "a")

    def note(**rec):
        trace.write(json.dumps(rec) + "\n")
        trace.flush()

    # the lease renewals this rank sends (its heartbeat thread's), each
    # timed when the coordinator has answered it
    renewals = []
    real_renew = coordinator.CoordinatorClient.renew

    def renew(self, *args, **kwargs):
        out = real_renew(self, *args, **kwargs)
        renewals.append(time.time())
        return out

    coordinator.CoordinatorClient.renew = renew
    # where a rank's start-up goes: host clock at each stage's end
    marks = {"imports": time.time()}
    device = env.init_parallel_env(backend="gloo", device=c["device"],
                                   timeout_s=DIST_PG_TIMEOUT_S)
    marks["process_group"] = time.time()
    rank, world = env.get_rank(), env.get_world_size()
    cfg = _dist_bert_cfg(dropout=c["dropout"])
    for k, v in c["bert"].items():
        setattr(cfg, k, v)
    plan = {"mesh": {"dp": world}, "sharding": True}
    main, startup, loss = _fleet_bert_program(cfg, c["bf16"], plan["mesh"],
                                              plan, shape=c)
    marks["program"] = time.time()
    exe = fluid.Executor(device=device)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    marks["startup_program"] = time.time()
    mgr = ckpt.CheckpointManager(c["root"], keep_last_n=c["keep"],
                                 program=main, scope=scope, device=device)
    committed = mgr.steps()
    st = mgr.restore()
    marks["restore"] = time.time()
    g0 = st["extra"]["global_step"] if st else 0
    note(ev="start", attempt=attempt, rank=rank, world=world,
         epoch=coordinator.membership_epoch_from_env(),
         sharded=mgr.sharded, restored=g0, committed=committed,
         restore_ms=st["restore_ms"] if st else None,
         t_proc0=_T_PROC0, t_ready=time.time(), marks=marks)
    want = _dist_launches_per_step(main, plan, c["bf16"])
    counters = _counters()
    for g in range(g0, c["steps"]):
        if (tag, g + 1) == (c.get("die_tag"), c.get("die_at")):
            note(ev="die", gs=g + 1, t=time.time())
            os._exit(9)     # the lost host: every attempt, before the step
        feed = bert.random_pretrain_batch(cfg, c["batch"], c["seq"],
                                          c["max_preds"], seed=1000 + g)
        t0 = time.perf_counter()
        lv, got = _count_step(counters, lambda: float(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0]
            .reshape(-1)[0]))
        ms = (time.perf_counter() - t0) * 1e3
        if device.type == "cuda" and got != want:
            raise RuntimeError(f"step {g + 1} launched {got}, the program "
                               f"needs {want}")
        note(ev="step", gs=g + 1, loss=lv, ms=ms,
             launches={k: got[k] for k in ELASTIC_ROWS},
             want={k: want[k] for k in ELASTIC_ROWS})
        if (g + 1) % c["freq"] == 0:
            mgr.save(g + 1, extra_state={"global_step": g + 1})
            note(ev="save", gs=g + 1, **mgr.last_save)
    gaps = np.diff(renewals)
    lease = coordinator.lease_secs_from_env()
    note(ev="end", t=time.time(), lease={
        "lease_secs": lease,
        "expiry_s": lease * coordinator.EXPIRE_PERIODS,
        "renewals": len(renewals),
        "max_gap_s": float(gaps.max()) if gaps.size else None})
    trace.close()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _elastic_launch(c: dict, name: str, workdir: str, world: int,
                    flags=(), env=None):
    """Start one dist_elastic job under the port's launcher: its config
    file, its log directory, the launcher's stderr in a file of its own.
    Returns the launcher process and the job's record."""
    cfg_path = os.path.join(workdir, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    logs = os.path.join(workdir, f"{name}.logs")
    os.makedirs(c["trace_dir"], exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, PYTHONPATH=here, PADDLE_CKPT_SHARDED="1",
                PADDLE_CKPT_FSYNC="0", **(env or {}))
    for k in ("PADDLE_ELASTIC_RESHARD", "PADDLE_PS_FAULT_SPEC",
              "PADDLE_PS_FAULT_TAGS", "PADDLE_TRACING"):
        if k not in (env or {}):
            full.pop(k, None)
    err = open(os.path.join(workdir, f"{name}.launcher.log"), "w")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(world), "--log_dir", logs,
           "--lease_secs", str(c["lease_secs"]), *flags,
           os.path.abspath(__file__), "--elastic-child", cfg_path]
    # a session of its own: a deadline kills the launcher and its ranks
    proc = subprocess.Popen(cmd, env=full, stdout=err, stderr=err,
                            start_new_session=True, cwd=here)
    return proc, {"name": name, "err": err, "logs": logs, "c": c,
                  "t0": time.time()}


def _elastic_join(c: dict, proc, job: dict, deadline: float) -> dict:
    """Wait for one launcher; kill its whole session past ``deadline``.
    The job's record gains its exit code, the launcher's log and each
    tag's trace events."""
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.2)
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()
        job["rc"] = f"no exit within {c['join_s']} s"
    else:
        job["rc"] = proc.returncode
    job["err"].close()
    job["seconds"] = time.time() - job["t0"]
    with open(job["err"].name) as f:
        job["launcher_log"] = f.read()
    job["traces"] = {}
    for fn in sorted(os.listdir(c["trace_dir"])):
        if fn.startswith("trace.") and fn.endswith(".jsonl"):
            with open(os.path.join(c["trace_dir"], fn)) as f:
                job["traces"][fn[6:-6]] = [json.loads(ln) for ln in f]
    return job


def _elastic_check(job: dict, restarts: list) -> None:
    """The launcher exited 0 after exactly ``restarts`` (the culprit tag
    and reason of each elastic restart, in order): any other failure of
    any rank fails the phase."""
    log = job["launcher_log"]
    seen = [ln for ln in log.splitlines() if "elastic restart" in ln]
    ok = job["rc"] == 0 and len(seen) == len(restarts) and all(
        f": {tag} (rank" in ln and why in ln
        for ln, (tag, why) in zip(seen, restarts))
    if not ok:
        tail = ""
        for fn in sorted(os.listdir(job["logs"])):
            with open(os.path.join(job["logs"], fn)) as f:
                tail += f"--- {fn}\n{f.read()[-1500:]}\n"
        fail(f"dist_elastic {job['name']}: launcher exit {job['rc']}, "
             f"restarts {seen} (wanted {restarts})\n{log[-3000:]}\n{tail}")


def _elastic_attempts(job: dict) -> list:
    """Per attempt: each rank's start event and its step / save / end
    events, in the order written."""
    out = {}
    for tag, evs in job["traces"].items():
        att = None
        for ev in evs:
            if ev["ev"] == "start":
                att = ev["attempt"]
                out.setdefault(att, {})[tag] = {"start": ev, "steps": [],
                                                "saves": [], "end": None}
            elif ev["ev"] in ("step", "save"):
                out[att][tag][ev["ev"] + "s"].append(ev)
            elif ev["ev"] in ("end", "die"):
                out[att][tag]["end"] = ev
    return [out[k] for k in sorted(out)]


def _elastic_losses(attempt: dict) -> dict:
    """gs -> loss of an attempt, held equal on every rank."""
    by = {tag: {s["gs"]: s["loss"] for s in a["steps"]}
          for tag, a in attempt.items()}
    first = next(iter(by.values()))
    for tag, losses in by.items():
        if losses != first:
            fail(f"dist_elastic: {tag}'s losses {losses} differ from "
                 f"another rank's {first}")
    return first


def _elastic_state(root: str, step: int) -> dict:
    """Every array of rank 0's shard of a step's checkpoint."""
    from paddle_tpu_torch.fluid import checkpoint as ckpt

    with open(os.path.join(root, f"ckpt-{step:08d}", "rank0",
                           "state.pkl"), "rb") as f:
        return ckpt._loads(f.read())["arrays"]


def _elastic_same_state(what: str, got: dict, want: dict) -> dict:
    """Bit for bit, every array; the f32 master parameters and Adam
    moments counted."""
    from paddle_tpu_torch.fluid import checkpoint as ckpt

    if sorted(got) != sorted(want):
        fail(f"dist_elastic {what}: the checkpoints hold other variables")
    differ, params, moments = [], 0, 0
    for n in sorted(want):
        a, b = got[n], want[n]
        if isinstance(a, ckpt.BF16Array) or isinstance(b, ckpt.BF16Array):
            same = a == b
        else:
            a, b = np.asarray(a), np.asarray(b)
            same = (a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes())
        if not same:
            differ.append(n)
        moments += "_moment" in n
        params += ("_moment" not in n and "_pow_acc" not in n
                   and np.asarray(want[n]).dtype == np.float32
                   and np.asarray(want[n]).ndim > 0)
    if differ:
        fail(f"dist_elastic {what}: {len(differ)} variables differ, "
             f"{differ[:8]}")
    return {"vars_bit_equal": len(want), "f32_arrays_not_moments": params,
            "adam_moments": moments}


def _elastic_restart_gap(job: dict) -> dict:
    """The launcher's restart line: when the failure was detected and
    when the new group was spawned; and when the new attempt's ranks
    were ready (restored, about to step)."""
    line = next(ln for ln in job["launcher_log"].splitlines()
                if "failure detected at" in ln)
    detect = float(line.split("failure detected at ")[1].split(",")[0])
    respawn = float(line.split("group respawned at ")[1].split(" ")[0])
    ready = max(a["start"]["t_ready"]
                for a in _elastic_attempts(job)[1].values())
    return {"detect_to_respawn_s": respawn - detect,
            "detect_to_ready_s": ready - detect}


def _elastic_stages(start: dict) -> dict:
    """A rank's start-up by stage: seconds from the stage before (the
    process's start for the imports)."""
    t, out = start["t_proc0"], {}
    for k, v in start["marks"].items():
        out[k], t = v - t, v
    return out


def _elastic_windows(jobs: dict) -> dict:
    """(job, attempt) -> its window on the host clock: its ranks' first
    process start to the next attempt's (or the launcher's exit)."""
    out = {}
    for name, job in jobs.items():
        starts = [min(a["start"]["t_proc0"] for a in att.values())
                  for att in _elastic_attempts(job)]
        ends = starts[1:] + [job["t0"] + job["seconds"]]
        for i, w in enumerate(zip(starts, ends)):
            out[name, i] = w
    return out


def _elastic_costs(name: str, jobs: dict) -> dict:
    """Per attempt of job ``name``: each rank's start-up seconds (process
    start to ready to step, restore included), its step ms (median), save
    ms and bytes of its shard, each rank's lease renewals and their
    largest gap as the rank saw them answered, and the jobs whose
    attempts ran beside it (their ranks shared the card and the host)."""
    job, win = jobs[name], _elastic_windows(jobs)
    out = []
    for i, att in enumerate(_elastic_attempts(job)):
        t0, t1 = win[name, i]
        steps = [s["ms"] for a in att.values() for s in a["steps"][1:]]
        saves = [s for a in att.values() for s in a["saves"]]
        out.append({
            "world": len(att),
            "startup_s_max": max(a["start"]["t_ready"] - a["start"]
                                 ["t_proc0"] for a in att.values()),
            "restore_ms_max": max((a["start"]["restore_ms"] or 0.0)
                                  for a in att.values()),
            # each stage's seconds, the slowest rank's
            "startup_stages_s_max": {
                k: max(_elastic_stages(a["start"])[k] for a in att.values())
                for k in _elastic_stages(next(iter(att.values()))["start"])},
            "restored_step": next(iter(att.values()))["start"]["restored"],
            "step_ms_median": statistics.median(steps) if steps else None,
            "first_step_ms_max": max((a["steps"][0]["ms"] for a in
                                      att.values() if a["steps"]),
                                     default=None),
            "save_ms_median": statistics.median(
                s["save"] for s in saves) if saves else None,
            "save_snapshot_ms_median": statistics.median(
                s["snapshot"] for s in saves) if saves else None,
            "save_write_ms_median": statistics.median(
                s["write"] for s in saves) if saves else None,
            "shard_bytes": sorted({s["bytes"] for s in saves}),
            "lease": {tag: a["end"]["lease"] for tag, a in att.items()
                      if a["end"] and "lease" in a["end"]},
            "concurrent_with": sorted({
                n for (n, _), (a, b) in win.items()
                if n != name and a < t1 and t0 < b})})
    return {"attempts": out, "launch_seconds": job["seconds"]}


def _elastic_launches(job: dict) -> dict:
    """Rows 2-5 a step a rank, the same on every step of every rank of
    the job (each child held its steps to the program's count)."""
    seen = {json.dumps(s["launches"], sort_keys=True)
            for att in _elastic_attempts(job) for a in att.values()
            for s in a["steps"]}
    if len(seen) != 1:
        fail(f"dist_elastic {job['name']}: launches a step {seen}")
    return json.loads(seen.pop())


def phase_dist_elastic(torch, card: str, workdir: str, c=None) -> dict:
    """The job control plane on the card: BERT-base (ELASTIC) started by
    ``python -m paddle_tpu_torch.distributed.launch`` at dp 4 with the
    lease plane armed, every rank checkpointing sharded; then

      clean  steps 1-4, saves at 2 and 4;
      (a)    the same job with ``crash:ckpt_shard_committed:2`` in
             trainer1 and --elastic_retries 1: step 4's save is torn
             (no global manifest), the relaunch restores step 2 and runs
             3-4, whose losses and step-4 checkpoint (every f32 master
             parameter and Adam moment) equal the clean run's bit for
             bit; the torn step was never restored;
      (b)    from the clean step-4 checkpoint, trainer3 lost for good at
             the start of step 5 under --elastic_retries 2
             --elastic_retries_per_rank 0 --min_world_size 3: the
             coordinator evicts it (membership epoch 1), the launcher
             restarts 3 ranks with PADDLE_ELASTIC_RESHARD=1, ZeRO's
             moments split again for dp 3, steps 5-6 equal bit for bit a
             clean dp-3 launch restored from the same checkpoint.

    (a) runs beside the clean run, and (b) and its reference beside
    (a)'s relaunch.  Each launcher's exit code and restarts are held; a
    rank failing for any other reason fails the phase.  Reports each attempt's
    start-up seconds, step ms a rank, save ms and bytes a shard, the
    jobs that ran beside it, the detect-to-relaunch seconds of (a) and
    (b), each rank's largest gap between answered lease renewals, and
    rows 2-5's launches a step a rank (held to the program's on the card,
    rows 4-5 on wgmma)."""
    import shutil

    t0 = time.perf_counter()
    c = dict(ELASTIC, **(c or {}))
    on_card = c["device"].startswith("cuda")
    jobs = {}

    def spec(name, root, steps, **kw):
        return dict(c, root=os.path.join(workdir, root), steps=steps,
                    trace_dir=os.path.join(workdir, f"{name}.traces"), **kw)

    def start(name, conf, world, flags=(), env=None):
        return name, _elastic_launch(conf, name, workdir, world, flags, env)

    def join(started):
        deadline = time.monotonic() + c["join_s"]
        for name, (proc, job) in started:
            jobs[name] = _elastic_join(job["c"], proc, job, deadline)

    fault, fault_tag = ELASTIC_FAULT
    a_env = {"FLAGS_ps_fault_injection": "1", "PADDLE_PS_FAULT_SPEC": fault,
             "PADDLE_PS_FAULT_TAGS": fault_tag}
    W = c["world"]
    # (a) runs beside the clean run; (b) and its reference start once the
    # clean step-4 checkpoint is committed, beside (a)'s relaunch (the
    # card holds 11 ranks at once: ~4 GB each at these shapes)
    clean = start("clean", spec("clean", "clean", 4), W)
    a_job = start("a", spec("a", "a", 4), W, ("--elastic_retries", "1"),
                  a_env)
    join([clean])
    _elastic_check(jobs["clean"], [])
    clean_root = jobs["clean"]["c"]["root"]
    # (b) and its reference start from the clean step-4 checkpoint
    for root in ("b", "b3"):
        shutil.copytree(os.path.join(clean_root, "ckpt-00000004"),
                        os.path.join(workdir, root, "ckpt-00000004"),
                        copy_function=os.link)
    die_tag, die_at = ELASTIC_DIE
    b_run = ("b", spec("b", "b", 6, die_tag=die_tag, die_at=die_at), W,
             ("--elastic_retries", "2", "--elastic_retries_per_rank", "0",
              "--min_world_size", str(W - 1)))
    ref_run = ("b3", spec("b3", "b3", 6), W - 1, (),
               {"PADDLE_ELASTIC_RESHARD": "1"})
    join([a_job, start(*b_run), start(*ref_run)])
    _elastic_check(jobs["a"], [(fault_tag, "nonzero exit (code 1)")])
    with open(os.path.join(jobs["a"]["logs"], "workerlog.1")) as f:
        if "at phase 'ckpt_shard_committed'" not in f.read():
            fail("dist_elastic (a): trainer1 exited 1 without the "
                 "injected crash")
    _elastic_check(jobs["b"], [(die_tag, "nonzero exit (code 9)")])
    _elastic_check(jobs["b3"], [])

    # clean: one attempt, steps 1-4, every rank's shard the same bytes
    cl = _elastic_attempts(jobs["clean"])
    clean_losses = _elastic_losses(cl[0])
    if sorted(clean_losses) != [1, 2, 3, 4] or not all(
            math.isfinite(v) for v in clean_losses.values()):
        fail(f"dist_elastic clean: losses {clean_losses}")
    shas = set()
    for r in range(W):
        with open(os.path.join(clean_root, "ckpt-00000004", f"rank{r}",
                               "manifest.json")) as f:
            shas.add(json.load(f)["files"]["state.pkl"]["sha256"])
    if len(shas) != 1:
        fail("dist_elastic clean: the ranks' step-4 shards differ")
    # (a): attempt 0 tore step 4, attempt 1 restored step 2
    att = _elastic_attempts(jobs["a"])
    a_root = jobs["a"]["c"]["root"]
    if len(att) != 2:
        fail(f"dist_elastic (a): {len(att)} attempts, wanted 2")
    first = next(iter(att[1].values()))["start"]
    if first["restored"] != 2 or 4 in first["committed"] \
            or 2 not in first["committed"]:
        fail(f"dist_elastic (a): the relaunch saw committed steps "
             f"{first['committed']} and restored {first['restored']}, "
             f"wanted step 2 restored and step 4 torn")
    torn_shards = sorted(
        d for d in os.listdir(os.path.join(a_root, "ckpt-00000004"))
        if d.startswith("rank"))
    relaunch = _elastic_losses(att[1])
    if relaunch != {3: clean_losses[3], 4: clean_losses[4]}:
        fail(f"dist_elastic (a): relaunch losses {relaunch} vs the clean "
             f"run's {clean_losses}")
    a_state = _elastic_same_state("(a) step 4", _elastic_state(a_root, 4),
                                  _elastic_state(clean_root, 4))
    # (b): attempt 0 at dp 4 from step 4, trainer3 lost at step 5;
    # attempt 1 at dp 3, epoch 1, re-sharded
    att_b = _elastic_attempts(jobs["b"])
    if len(att_b) != 2 or sorted(att_b[1]) != ["trainer0", "trainer1",
                                               "trainer2"]:
        fail(f"dist_elastic (b): attempts {[sorted(a) for a in att_b]}")
    st_b = next(iter(att_b[1].values()))["start"]
    if st_b["world"] != W - 1 or st_b["epoch"] != 1 \
            or st_b["restored"] != 4:
        fail(f"dist_elastic (b): the resized attempt {st_b}")
    b_losses = _elastic_losses(att_b[1])
    ref_losses = _elastic_losses(_elastic_attempts(jobs["b3"])[0])
    if b_losses != ref_losses or sorted(b_losses) != [5, 6]:
        fail(f"dist_elastic (b): losses {b_losses} vs the clean dp-3 "
             f"run's {ref_losses}")
    b_state = _elastic_same_state(
        "(b) step 6", _elastic_state(jobs["b"]["c"]["root"], 6),
        _elastic_state(jobs["b3"]["c"]["root"], 6))
    launches = ({n: _elastic_launches(j) for n, j in jobs.items()}
                if on_card else "not counted (the CPU runs plain versions)")
    out = {"phase": "dist_elastic", "card": card, "world": W,
           "resized_world": W - 1, "bf16_layers":
               c["bert"].get("num_hidden_layers", 12),
           "batch": c["batch"], "seq": c["seq"], "lease_secs":
               c["lease_secs"], "fsync": False, "fault": fault,
           "fault_tag": fault_tag, "lost": [die_tag, die_at],
           "clean_losses": clean_losses,
           "a": {"relaunch_losses": relaunch, "torn_step_shards":
                 torn_shards, "committed_at_relaunch":
                 first["committed"], "state": a_state,
                 **_elastic_restart_gap(jobs["a"])},
           "b": {"losses": b_losses, "dp3_reference": ref_losses,
                 "state": b_state, **_elastic_restart_gap(jobs["b"])},
           "costs": {n: _elastic_costs(n, jobs) for n in jobs},
           "launches_per_step_per_rank": launches,
           "seconds": time.perf_counter() - t0}
    for root in ("clean", "a", "b", "b3"):
        shutil.rmtree(os.path.join(workdir, root), ignore_errors=True)
    emit(out)
    return out


def _kernel_entry(name, source, replaces, launches, k) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]}


# ---------------------------------------------------------------------------
# the parameter server: ps_train
# ---------------------------------------------------------------------------

# examples/ps_embedding_training.py's model: a 1,000,000 x 64 f32 table in
# host memory, a 20-way fc, Adam 1e-3, batch 64; 30 steps held against the
# CPU, then 5 steps with each copy and host call timed alone and 5 under
# torch.profiler
PS_TRAIN = {"rows": 1_000_000, "dim": 64, "ncls": 20, "batch": 64,
            "steps": 30, "timing_steps": 5, "profile_steps": 5}
# tests/dist_ps_worker.py's contract at those widths: sync mode, a frozen
# projection, server SGD at 0.5, table seed 7, global batch 128 (64 a
# trainer), 12 steps; two trainers on the card over two pservers with
# every row partition replicated on both
PS_JOB = {"rows": 1_000_000, "dim": 64, "ncls": 20, "global_batch": 128,
          "steps": 12, "join_s": 480}
PS_KILL_ENV = {"FLAGS_ps_fault_injection": "1",
               "PADDLE_PS_FAULT_SPEC": "kill:*:30",
               "PADDLE_PS_FAULT_TAGS": "ps0",
               "PADDLE_PS_CALL_DEADLINE_SECS": "2"}
# card vs CPU (f32, TF32 off) and two trainers vs one process: the same
# float32 math summed in another order, ~1e-7 relative; TF32 would move
# the losses by ~1e-4
PS_RTOL = 1e-5
PS_ATOL = 1e-6
PS_ROWS_ATOL = 1e-7


def _all_kernel_launches(reset: bool = False) -> dict:
    """Every one of the 14 kernels' launch counters (the tensor-core
    routes' too), set to 0 first when ``reset``."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    counters = dict(_counters(), paged=pa.paged_attention)
    if reset:
        for c in counters.values():
            c.launches = 0
    got = {k: c.launches for k, c in counters.items()}
    conv = _conv_bn_counts(reset=reset)
    conv.pop("reference_routes")
    return dict(got, **conv)


def _ps_example_program(c: dict):
    """The example's program built with the port: a plain embedding
    transpiled onto an in-process host table (``giant_table``), then Adam
    over the dense rest."""
    import warnings

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import ps

    L = fluid.layers
    ps.drop_table("giant_table")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [c["batch"]], dtype="int64",
                     append_batch_size=False)
        y = L.data("y", [c["batch"], 1], dtype="int64",
                   append_batch_size=False)
        emb = L.embedding(ids, size=[c["rows"], c["dim"]],
                          param_attr=fluid.ParamAttr(name="giant_table"))
        logits = L.fc(emb, c["ncls"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        with warnings.catch_warnings():
            # the embedding's uniform init has no host-table form: the
            # table takes its normal(0, 1/sqrt(dim)) init from seed 0
            warnings.simplefilter("ignore", RuntimeWarning)
            tables = fluid.DistributeTranspiler().transpile(
                trainer_id=0, program=main, startup_program=startup)
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    if tables != ["giant_table"]:
        fail(f"ps_train: the transpile moved {tables}")
    return main, startup, loss


def _ps_example_run(torch, c: dict, device: str, state) -> dict:
    """``c["steps"]`` steps of the example on ``device`` from ``state``
    (None: take the startup's and return it), the table fresh from its
    seed: each step's loss and host wall, every kernel's launches over
    the steps, and the touched rows of the table after them."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.ops import ps_ops

    t0 = time.perf_counter()
    main, startup, loss = _ps_example_program(c)
    build_s = time.perf_counter() - t0
    exe = fluid.Executor(device=device)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if state is None:
        state = {n: v.detach().cpu().clone() for n, v in scope.vars.items()
                 if v is not None}
    for n, v in state.items():
        scope.set_var(n, v.to(exe.device).clone())
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(c["steps"]):
        ids = rng.randint(0, c["rows"], (c["batch"],)).astype(np.int64)
        feeds.append({"ids": ids, "y": (ids % c["ncls"])[:, None]})
    _all_kernel_launches(reset=True)
    ps_ops.reset_stats()
    losses, step_ms = [], []
    for feed in feeds:
        t1 = time.perf_counter()
        lv = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(np.asarray(lv).reshape(())))
    launches = _all_kernel_launches()
    if (ps_ops.stats["lookups"], ps_ops.stats["pushes"]) != (
            c["steps"], c["steps"]):
        fail(f"ps_train ({device}): {ps_ops.stats['lookups']} lookups and "
             f"{ps_ops.stats['pushes']} pushes in {c['steps']} steps")
    touched = np.unique(np.concatenate([f["ids"] for f in feeds]))
    table = ps.get_table("giant_table")
    if any(tuple(v.shape) == (c["rows"], c["dim"])
           for v in scope.vars.values() if v is not None):
        fail(f"ps_train ({device}): the table is in the scope")
    return {"exe": exe, "main": main, "scope": scope, "loss": loss,
            "feed": feeds[-1], "state": state, "losses": losses,
            "step_ms": step_ms, "launches": launches, "build_s": build_s,
            "touched": touched, "rows": table.gather(touched),
            "table_push_calls": table.push_calls}


def _ps_example(torch) -> dict:
    """(a): the example at its widths on the card and on the port's CPU
    path from the same weights and table seed, TF32 off: the 30 losses
    and the touched rows within PS_RTOL; no kernel launched on the card;
    then the split of a step (each copy and host call timed alone) and
    the device's idle share over a profiled window."""
    from paddle_tpu_torch.ops import ps_ops

    c = PS_TRAIN
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = _ps_example_run(torch, c, "cpu", None)
        card = _ps_example_run(torch, c, "cuda", cpu["state"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if any(card["launches"].values()):
        fail(f"ps_train: kernels launched on the PS path: "
             f"{card['launches']}")
    loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(card["losses"], cpu["losses"]))
    if not np.allclose(card["losses"], cpu["losses"], rtol=PS_RTOL,
                       atol=PS_ATOL):
        fail(f"ps_train: the card's losses {card['losses']} are not the "
             f"CPU's {cpu['losses']} within rtol {PS_RTOL}")
    if not np.allclose(card["rows"], cpu["rows"], rtol=PS_RTOL,
                       atol=PS_ROWS_ATOL):
        fail(f"ps_train: touched rows off by "
             f"{float(np.abs(card['rows'] - cpu['rows']).max())}")
    # the split: each copy and host call timed alone (the card
    # synchronized around it); what is left of the step is device work
    # and the executor's own host time
    exe, main, scope = card["exe"], card["main"], card["scope"]
    ps_ops.reset_stats()
    ps_ops.TIMING = True
    walls = []
    try:
        for _ in range(c["timing_steps"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            exe.run(main, feed=card["feed"], fetch_list=[card["loss"]],
                    scope=scope)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
    finally:
        ps_ops.TIMING = False
    n = c["timing_steps"]
    split = {k: ps_ops.stats[k] / n for k in (
        "d2h_ids_ms", "gather_ms", "h2d_ms", "d2h_grad_ms", "push_ms")}
    step_timed = statistics.median(walls)
    split["rest_ms"] = step_timed - sum(split.values())
    prof = _step_profile(torch, exe, main, scope, card["feed"],
                         card["loss"], c["profile_steps"],
                         f"window = {c['profile_steps']} steps after the "
                         f"timed ones (untimed)")
    return {"config": {k: c[k] for k in ("rows", "dim", "ncls", "batch",
                                          "steps")},
            "losses": card["losses"], "cpu_losses": cpu["losses"],
            "loss_max_rel_err": loss_err,
            "rows_touched": int(card["touched"].shape[0]),
            "rows_max_abs_err": float(np.abs(card["rows"]
                                             - cpu["rows"]).max()),
            "step_ms_median": statistics.median(card["step_ms"][2:]),
            "cpu_step_ms_median": statistics.median(cpu["step_ms"][2:]),
            "timed_step_ms_median": step_timed,
            "timed_split_ms": split,
            "launches": card["launches"],
            "profile": dict(prof, top_kernels=prof["top_kernels"][:6]),
            "build_s": card["build_s"]}


def _ps_hosted_init(c: dict, n_servers: int) -> dict:
    """The state an in-process table needs to start from the rows a table
    hosted on ``n_servers`` pservers starts from (partition s, seeded
    seed + s, holds the rows r with r % n == s at r // n; each table
    keeps row r in shard r % 4 at r // 4)."""
    from paddle_tpu_torch.distributed import ps

    dense = np.empty((c["rows"], c["dim"]), np.float32)
    for s in range(n_servers):
        part = ps.ShardedHostTable(
            "init", ((c["rows"] - s + n_servers - 1) // n_servers, c["dim"]),
            num_shards=4, optimizer="sgd", learning_rate=0.5, seed=7 + s)
        dense[s::n_servers] = part.to_dense()
    return {"shards": [dense[k::4].copy() for k in range(4)],
            "accum": [None] * 4, "optimizer": "sgd", "learning_rate": 0.5}


def _ps_child(cfg_path: str) -> int:
    """One trainer of a ps_train job (the contract of
    tests/dist_ps_worker.py at the example's widths), on the card: under
    the launcher a RemoteTable over its pservers; alone an in-process
    table.  Writes ``trace.<rank>.json`` to the config's trace_dir."""
    with open(cfg_path) as f:
        c = json.load(f)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import fluid, telemetry
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.ops import ps_ops

    t_import = time.time()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    rng = np.random.RandomState(0)
    all_ids = rng.randint(0, c["rows"], (c["global_batch"],)).astype(
        np.int64)
    all_labels = (all_ids % c["ncls"]).astype(np.int64)[:, None]
    per = c["global_batch"] // world
    ids = all_ids[rank * per:(rank + 1) * per]
    labels = all_labels[rank * per:(rank + 1) * per]
    table = ps.create_table("ps_dist_table", shape=(c["rows"], c["dim"]),
                            mode="sync", num_shards=4, optimizer="sgd",
                            learning_rate=0.5, seed=7)
    if c.get("hosted_init"):
        # one process: start from the rows the launched jobs' two pservers
        # start from
        table.load_state_dict(_ps_hosted_init(c, c["hosted_init"]))
    t_table = time.time()
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        w = L.data("ids", [per], dtype="int64", append_batch_size=False)
        y = L.data("y", [per, 1], dtype="int64", append_batch_size=False)
        emb = L.distributed_embedding(w, "ps_dist_table")
        proj = L.fc(emb, c["ncls"], param_attr=fluid.ParamAttr(
            name="proj_w", trainable=False), bias_attr=False)
        loss = L.mean(L.softmax_with_cross_entropy(proj, y))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(device=c.get("device"))   # None: the card
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    # the frozen projection from a seed of its own, the same in every
    # process
    scope.set_var("proj_w", torch.as_tensor(np.random.RandomState(
        11).uniform(-0.3, 0.3, (c["dim"], c["ncls"])).astype(np.float32),
        device=exe.device))
    t_ready = time.time()
    _all_kernel_launches(reset=True)
    losses, step_ms = [], []
    for _ in range(c["steps"]):
        t1 = time.perf_counter()
        lv = exe.run(main, feed={"ids": ids, "y": labels},
                     fetch_list=[loss], scope=scope)[0]
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(np.asarray(lv).reshape(())))
    launches = _all_kernel_launches()
    t_steps = time.time()
    dense = table.to_dense()
    touched = np.unique(all_ids)
    reg = telemetry.get_registry()
    rec = {"rank": rank, "world": world, "pid": os.getpid(),
           "losses": losses,
           "step_ms": step_ms,
           "table_sum": float(np.float64(dense.sum())),
           "touched_rows": dense[touched].tolist(),
           "failovers": reg.counter("ps_client_failovers_total").value,
           "failover_log": list(getattr(table, "failover_log", [])),
           "lookups": ps_ops.stats["lookups"],
           "pushes": ps_ops.stats["pushes"], "launches": launches,
           "t_proc0": _T_PROC0, "t_ready": t_ready, "t_end": time.time(),
           "startup_s": {"imports": t_import - _T_PROC0,
                         "table": t_table - t_import,
                         "program": t_ready - t_table},
           "to_dense_s": time.time() - t_steps}
    with open(os.path.join(c["trace_dir"], f"trace.{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _ps_job_start(name: str, workdir: str, launched: bool,
                  env=None, flags=(), cfg=None) -> dict:
    """Start one ps_train job in the background: under the port's
    launcher (two trainers, two pservers, every partition on both) or
    one process alone.  Its stdout and stderr go to a file."""
    c = dict(PS_JOB, trace_dir=os.path.join(workdir, name), **(cfg or {}))
    os.makedirs(c["trace_dir"], exist_ok=True)
    cfg_path = os.path.join(workdir, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    here = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, PYTHONPATH=here, **(env or {}))
    for k in ("PADDLE_PS_FAULT_SPEC", "PADDLE_PS_FAULT_TAGS",
              "FLAGS_ps_fault_injection", "PADDLE_PS_CALL_DEADLINE_SECS",
              "PADDLE_TRACING", "PADDLE_PSERVERS_IP_PORT_LIST",
              "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        if k not in (env or {}):
            full.pop(k, None)
    logs = os.path.join(workdir, f"{name}.logs")
    child = [os.path.abspath(__file__), "--ps-child", cfg_path]
    if launched:
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc_per_node", "2", "--server_num", "2",
               "--ps_replication", "2", "--log_dir", logs, *flags, *child]
    else:
        cmd = [sys.executable, *child]
    err = open(os.path.join(workdir, f"{name}.launcher.log"), "w")
    proc = subprocess.Popen(cmd, env=full, stdout=err, stderr=err,
                            start_new_session=True, cwd=here)
    return {"name": name, "proc": proc, "err": err, "logs": logs, "c": c,
            "t0": time.time(), "world": 2 if launched else 1}


class _PsWatch:
    """Polls, once a second while any of ``procs`` (the ps_train jobs)
    runs, the pservers' pids (their command line), whether each sees the
    card (CUDA_VISIBLE_DEVICES in its environment) and the card's compute
    processes (``nvidia-smi --query-compute-apps=pid``)."""

    def __init__(self, procs):
        import threading

        self.procs = procs
        self.ended = {}   # proc -> host time its exit was first seen
        self.pservers, self.visible, self.compute = set(), {}, set()
        self.smi_error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _poll(self):
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read()
                if b"paddle_tpu_torch.distributed.ps_server" not in cmd:
                    continue
                with open(f"/proc/{pid}/environ", "rb") as f:
                    env = dict(kv.split(b"=", 1) for kv in
                               f.read().split(b"\0") if b"=" in kv)
            except OSError:
                continue
            if not env:
                # an exiting process (ps_kill's SIGKILLed pserver, a job's
                # end): its memory, environment included, is already
                # gone between the two reads; a live pserver always has
                # an environment, and is read on the next poll
                continue
            self.pservers.add(int(pid))
            self.visible[int(pid)] = env.get(b"CUDA_VISIBLE_DEVICES",
                                             b"<unset>").decode()
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
        except (OSError, subprocess.TimeoutExpired) as e:
            self.smi_error = str(e)[:200]
            return
        if smi.returncode != 0:
            self.smi_error = smi.stderr.strip()[:200]
        self.compute |= {int(x) for x in smi.stdout.split() if x.isdigit()}

    def _loop(self):
        while not self._stop.wait(0.5):
            for p in self.procs:
                if p not in self.ended and p.poll() is not None:
                    self.ended[p] = time.time()
            if len(self.ended) == len(self.procs):
                return
            self._poll()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return {"pserver_pids": sorted(self.pservers),
                "pserver_cuda_visible_devices": sorted(
                    set(self.visible.values())),
                "compute_app_pids_seen": len(self.compute),
                "pservers_among_compute_apps": sorted(
                    self.pservers & self.compute),
                "nvidia_smi_error": self.smi_error}


def _ps_jobs_start(workdir: str) -> dict:
    """(b) ps_ref, (c) ps_kill and the one-process reference, started
    together in the background (before the gloo spawn), with the
    pserver watch."""
    jobs = {"ps_single": _ps_job_start("ps_single", workdir, False,
                                       cfg={"hosted_init": 2}),
            "ps_ref": _ps_job_start("ps_ref", workdir, True),
            "ps_kill": _ps_job_start("ps_kill", workdir, True, PS_KILL_ENV,
                                     ("--elastic_retries", "1"))}
    return {"jobs": jobs,
            "watch": _PsWatch([j["proc"] for j in jobs.values()])}


def _ps_jobs_kill(started: dict) -> dict:
    """Kill whatever of the jobs still runs; stop the watch and return
    what it saw."""
    for job in started["jobs"].values():
        if job["proc"].poll() is None:
            try:
                os.killpg(job["proc"].pid, 9)
            except ProcessLookupError:
                pass
            job["proc"].wait()
    return started["watch"].stop()


def _ps_job_join(job: dict, deadline: float) -> dict:
    proc = job["proc"]
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.2)
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()
        job["rc"] = f"no exit within {job['c']['join_s']} s"
    else:
        job["rc"] = proc.returncode
    job["err"].close()
    job["seconds"] = time.time() - job["t0"]
    with open(job["err"].name) as f:
        job["launcher_log"] = f.read()
    job["logs_text"] = ""
    if os.path.isdir(job["logs"]):
        for fn in sorted(os.listdir(job["logs"])):
            p = os.path.join(job["logs"], fn)
            if os.path.isfile(p):
                with open(p) as f:
                    job["logs_text"] += f"--- {fn}\n{f.read()}\n"
    if job["rc"] != 0:
        fail(f"ps_train {job['name']}: exit {job['rc']}\n"
             f"{job['launcher_log'][-3000:]}\n{job['logs_text'][-6000:]}")
    job["traces"] = []
    for r in range(job["world"]):
        with open(os.path.join(job["c"]["trace_dir"],
                               f"trace.{r}.json")) as f:
            job["traces"].append(json.load(f))
    return job


def _ps_kill_to_answer_ms(job: dict) -> float:
    """From the kill rule's stamp in the killed pserver's log to the
    promoted backup's first answered call (a trainer's promote)."""
    kills = [float(ln.split(" at ")[1].split(" ")[0])
             for ln in job["logs_text"].splitlines()
             if "[faults] killing server pid" in ln]
    answers = [e["answered_at"] for t in job["traces"]
               for e in t["failover_log"]]
    if len(kills) != 1 or not answers:
        fail(f"ps_train ps_kill: kill stamps {kills}, promotions "
             f"{[t['failover_log'] for t in job['traces']]}")
    return (min(answers) - kills[0]) * 1e3


def _ps_job_line(job: dict, windows: dict) -> dict:
    t0, t1 = windows[job["name"]]
    return {"launch_seconds": t1 - t0,
            "startup_s": [t["t_ready"] - t["t_proc0"]
                          for t in job["traces"]],
            "startup_stages_s": [t["startup_s"] for t in job["traces"]],
            "step_ms_median": [statistics.median(t["step_ms"][1:])
                               for t in job["traces"]],
            "to_dense_s": [t["to_dense_s"] for t in job["traces"]],
            "losses": [t["losses"] for t in job["traces"]],
            "table_sum": job["traces"][0]["table_sum"],
            "concurrent_with": sorted(
                n for n, (a, b) in windows.items()
                if n != job["name"] and a < t1 and t0 < b)}


def _ps_jobs(torch, started: dict, dist_windows: dict) -> tuple:
    """Join (b), (c) and the one-process reference and hold them: (b)'s
    mean loss within PS_RTOL / PS_ATOL of one process, its table_sum
    within PS_RTOL, both ranks' views equal; (c) bit for bit (b), with a
    failover and "promoting" in its logs; no pserver on the card.
    Returns the jobs' lines and their windows on the host clock."""
    deadline = time.monotonic() + PS_JOB["join_s"]
    try:
        jobs = {n: _ps_job_join(j, deadline)
                for n, j in started["jobs"].items()}
    finally:
        watch = _ps_jobs_kill(started)
    one, ref, kill = (jobs["ps_single"]["traces"][0],
                      jobs["ps_ref"]["traces"], jobs["ps_kill"]["traces"])
    for t in one, *ref, *kill:
        if any(t["launches"].values()) or t["pushes"] != PS_JOB["steps"]:
            fail(f"ps_train: a trainer launched {t['launches']} and "
                 f"pushed {t['pushes']} times")
    mean = (np.asarray(ref[0]["losses"]) + np.asarray(ref[1]["losses"])) / 2
    if not np.allclose(mean, one["losses"], rtol=PS_RTOL, atol=PS_ATOL):
        fail(f"ps_train ps_ref: mean losses {mean.tolist()} vs one "
             f"process {one['losses']}")
    if not np.isclose(ref[0]["table_sum"], one["table_sum"], rtol=PS_RTOL,
                      atol=0):
        fail(f"ps_train ps_ref: table_sum {ref[0]['table_sum']} vs one "
             f"process {one['table_sum']}")
    for t in ref, kill:
        if (t[0]["table_sum"] != t[1]["table_sum"]
                or t[0]["touched_rows"] != t[1]["touched_rows"]):
            fail("ps_train: the two ranks see different tables")
    for a, b in zip(kill, ref):
        if (a["losses"] != b["losses"] or a["table_sum"] != b["table_sum"]
                or a["touched_rows"] != b["touched_rows"]):
            fail(f"ps_train ps_kill: rank {a['rank']} is not ps_ref's bit "
                 f"for bit: {a['losses']} vs {b['losses']}")
    failovers = sum(t["failovers"] for t in kill)
    if failovers <= 0 or "promoting" not in jobs["ps_kill"]["logs_text"]:
        fail(f"ps_train ps_kill: no failover ({failovers})")
    if watch["pservers_among_compute_apps"] or not watch["pserver_pids"] \
            or watch["pserver_cuda_visible_devices"] != [""]:
        fail(f"ps_train: pservers and the card: {watch}")
    # a job's window ends when the watch saw its process exit (it was
    # joined only after the gloo spawn)
    ended = started["watch"].ended
    ps_windows = {n: (j["t0"], ended.get(j["proc"], j["t0"] + j["seconds"]))
                  for n, j in jobs.items()}
    windows = dict(dist_windows, **ps_windows)
    out = {n: _ps_job_line(j, windows) for n, j in jobs.items()}
    out["ps_ref"]["mean_loss_max_rel_err"] = float(np.max(
        np.abs(mean - one["losses"]) / np.abs(one["losses"])))
    out["ps_ref"]["table_sum_rel_err"] = abs(
        ref[0]["table_sum"] - one["table_sum"]) / abs(one["table_sum"])
    out["ps_kill"]["failovers"] = failovers
    out["ps_kill"]["kill_to_answer_ms"] = _ps_kill_to_answer_ms(
        jobs["ps_kill"])
    out["ps_kill"]["bit_equal_to_ps_ref"] = True
    # nvidia-smi may number processes in another pid namespace: the
    # trainers (which hold a context on the card) show whether it does
    watch["trainer_pids_among_compute_apps"] = sum(
        t["pid"] in started["watch"].compute for t in (one, *ref, *kill))
    out["pservers"] = watch
    out["launches"] = {k: sum(t["launches"][k] for t in (one, *ref, *kill))
                       for k in one["launches"]}
    return out, ps_windows


def phase_ps_train(torch, card: str, example: dict, jobs: dict) -> dict:
    """One line for the parameter server: (a) the example in process,
    (b) and (c) under the launcher."""
    out = {"phase": "ps_train", "card": card, "example": example, **jobs}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# serve_launch: BERT-base replicas under the port's launcher, with live
# weights from two pservers of the same job
# ---------------------------------------------------------------------------

# GPT-2 small's published widths: the engine phase's decoder, and the
# decoder each serve_launch replica attaches (PADDLE_SERVE_GEN_CONFIG)
GPT2_SMALL = dict(vocab=50257, d_model=768, n_layers=12, n_heads=12,
                  ffn=3072, max_seq=1024)
SERVE_LAUNCH = dict(retries=2, lease_secs=5.0, hb_timeout=10.0,
                    kv_pages=64, poll_secs=0.5, table="serve_bert_w",
                    seeds=(1, 2), threads=4, before_kill_s=3.0,
                    after_v2_s=3.0, gen_tokens=16, join_s=600,
                    device=None)


def _free_port_run(n: int) -> int:
    """A base port with ``n`` free loopback ports from it on."""
    import socket

    for _ in range(100):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n > 65000:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    fail("serve_launch: no run of free loopback ports")


def _proc_children(pid: int) -> list:
    out = []
    try:
        for task in os.listdir(f"/proc/{pid}/task"):
            try:
                with open(f"/proc/{pid}/task/{task}/children") as f:
                    out += [int(x) for x in f.read().split()]
            except OSError:
                pass
    except OSError:
        pass
    return out


def _proc_environ(pid: int) -> dict:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            raw = f.read()
    except OSError:
        return {}
    return dict(kv.split("=", 1) for kv in raw.decode(errors="replace")
                .split("\0") if "=" in kv)


def _proc_cmdline(pid: int) -> bytes:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read()
    except OSError:
        return b""


def _replica_pids(launcher_pid: int) -> dict:
    """rank -> pid of the launcher's serving replicas (its pservers are
    children too)."""
    out = {}
    for pid in _proc_children(launcher_pid):
        if b"paddle_tpu_torch.inference.server" in _proc_cmdline(pid):
            rank = _proc_environ(pid).get("PADDLE_TRAINER_ID")
            if rank is not None:
                out[int(rank)] = pid
    return out


def _kill_tree(pid: int) -> None:
    for kid in _proc_children(pid):
        _kill_tree(kid)
    try:
        os.kill(pid, 9)
    except OSError:
        pass


def _serve_weights(cfg, seed: int, names, device=None) -> dict:
    """One BERT-base parameter set: the export's startup program
    (``_bert_program``) run on ``device`` (None: the card) at ``seed``,
    as float32 numpy."""
    from paddle_tpu_torch import fluid

    _, startup, _, _ = _bert_program(cfg, SERVE_MAX_BATCH, 512)
    startup.random_seed = seed
    scope = fluid.Scope()
    fluid.Executor(device=device).run(startup, scope=scope)
    return {n: scope.find_var(n).detach().float().cpu().numpy()
            for n in names}


def _same(got, want) -> tuple:
    """(bit for bit, largest |got - want|) over a reply's fetches."""
    bit, worst = True, 0.0
    for g, w in zip(got, want):
        g = np.asarray(g)
        if g.shape != w.shape or not np.isfinite(g).all():
            return False, float("inf")
        bit = bit and np.array_equal(g.view(np.int32), w.view(np.int32))
        worst = max(worst, float(np.abs(g - w).max()))
    return bit, worst


def _serve_launch_child(cfg_path: str) -> int:
    """The serve_launch job, driven from a child of the script
    (``--serve-launch-child CFG``): ``python -m
    paddle_tpu_torch.distributed.launch --serve`` with two BERT-base
    replicas (heartbeats, leases, the paged KV pool, the GPT-2-small
    decoder) and two pservers of the same launcher holding the weight
    table at replication 2; v1 published, adopted by both replicas and
    held against an in-process oracle; a client fleet of 4 threads,
    replica 0 SIGKILLed mid-stream and respawned; v2 published
    mid-stream; SIGTERM drains the job.  Writes the result to the
    config's ``out`` path."""
    import signal

    with open(cfg_path) as f:
        c = json.load(f)
    res = {"t0": time.time()}
    try:
        _serve_launch_run(c, res)
    except Exception as e:  # noqa: BLE001 — the parent reports it
        res["error"] = f"{type(e).__name__}: {e}"
    finally:
        launcher = res.pop("_launcher", None)
        if launcher is not None and launcher.poll() is None:
            for pid in _replica_pids(launcher.pid).values():
                try:
                    os.kill(pid, signal.SIGTERM)
                except OSError:
                    pass
            try:
                launcher.wait(timeout=60)
            except subprocess.TimeoutExpired:
                _kill_tree(launcher.pid)
                launcher.wait()
        res["t_end"] = time.time()
        with open(c["out"], "w") as f:
            json.dump(res, f)
    return 1 if "error" in res else 0


def _serve_launch_run(c: dict, res: dict) -> None:
    import signal
    import threading

    import torch

    from paddle_tpu_torch.distributed import ps_server as tps
    from paddle_tpu_torch.distributed.coordinator import CoordinatorClient
    from paddle_tpu_torch.distributed.ps_server import _Conn
    from paddle_tpu_torch.inference import (DecoderConfig, GenerationEngine,
                                            ServingPredictor, TinyDecoderLM,
                                            load_frozen)
    from paddle_tpu_torch.inference import weight_sync as ws
    from paddle_tpu_torch.inference.client import InferenceClient
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.telemetry import get_registry

    reg = get_registry()
    dev = c["device"]   # None: the card

    # the job: two replicas on base, base + 1; two pservers on base + 2,
    # base + 3
    base = _free_port_run(4)
    eps = [f"127.0.0.1:{base + r}" for r in range(2)]
    ps_eps = [f"127.0.0.1:{base + 2 + s}" for s in range(2)]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, PADDLE_SERVE_GEN="1",
               PADDLE_SERVE_GEN_CONFIG=json.dumps(c["decoder"]),
               PADDLE_SERVE_WEIGHT_TABLE=c["table"],
               PADDLE_SERVE_WEIGHT_POLL_SECS=str(c["poll_secs"]))
    for k in ("PADDLE_TRACING", "PADDLE_SERVE_KV_PAGES",
              "PADDLE_SERVE_KV_CACHE", "PADDLE_SERVE_WEIGHT_ENDPOINTS",
              "PADDLE_PS_FAULT_SPEC", "PADDLE_PSERVERS_IP_PORT_LIST"):
        env.pop(k, None)
    cmd = [sys.executable, "-u", "-m", "paddle_tpu_torch.distributed.launch",
           "--serve", "--nproc_per_node", "2", "--started_port", str(base),
           "--elastic_retries", str(c["retries"]),
           "--lease_secs", str(c["lease_secs"]),
           "--heartbeat_timeout", str(c["hb_timeout"]),
           "--serve_kv_cache", "1", "--serve_kv_pages", str(c["kv_pages"]),
           "--servers", ",".join(ps_eps), "--ps_replication", "2",
           "--ps_snapshot_secs", "0", "--log_dir", c["logs"],
           c["model_dir"], "--max_batch", str(SERVE_MAX_BATCH)]
    if dev is not None:
        cmd += ["--device", dev]
    res["command"] = " ".join(cmd[2:])
    t_launch = time.time()
    launcher = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=here)
    res["_launcher"] = launcher
    lines = []   # (host time, line) of the launcher's output

    def read():
        for ln in launcher.stdout:
            lines.append((time.time(), ln.rstrip()))

    threading.Thread(target=read, daemon=True).start()

    def until(what, pred, timeout, every=0.1):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if launcher.poll() is not None:
                raise RuntimeError(
                    f"{what}: the launcher exited {launcher.returncode}: "
                    + "\n".join(ln for _, ln in lines[-20:]))
            try:
                got = pred()
            except Exception:  # noqa: BLE001 — not up yet
                got = None
            if got:
                return got
            time.sleep(every)
        raise RuntimeError(f"{what}: not within {timeout} s")

    def call(ep, verb, timeout=30.0, **kw):
        conn = _Conn(ep, deadline=timeout, io_timeout=timeout + 300.0)
        try:
            return conn.call(verb, **kw)
        finally:
            conn.close()

    # this child's own references, built while the job starts
    t_setup = time.time()
    cfg = bert.BertConfig.base()
    frozen = load_frozen(c["model_dir"], device=dev)
    plan = ws.plan_for_frozen(frozen)
    sets = {f"v{k + 1}": _serve_weights(cfg, seed, plan.names(), dev)
            for k, seed in enumerate(c["seeds"])}
    reqs = _serve_requests(cfg, 32, seed=0)
    # the oracle: the same frozen program in this process, with v1 and
    # v2, at the replicas' padded batch
    oracle = ServingPredictor(frozen, device=dev)
    want = {}
    for v in ("v1", "v2"):
        oracle.adopt_weights(sets[v])
        want[v] = [[o[:len(r["input_ids"])] for o in
                    oracle.run(_pad_rows(r, SERVE_MAX_BATCH))] for r in reqs]
    del oracle
    # the in-process engine the replicas' generate is held against: the
    # same decoder, seed and pool
    os.environ["PADDLE_SERVE_KV_PAGES"] = str(c["kv_pages"])
    os.environ["PADDLE_SERVE_KV_CACHE"] = "1"
    prompt = _engine_traffic(np.random.default_rng(0),
                             c["decoder"]["vocab"])[2]
    eng = GenerationEngine(TinyDecoderLM(DecoderConfig(**c["decoder"]),
                                         seed=0, device=dev))
    gen_want = eng.result(eng.submit(prompt,
                                     max_new_tokens=c["gen_tokens"]),
                          timeout=600)["tokens"]
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    res["setup_s"] = time.time() - t_setup
    res["decoder"] = c["decoder"]
    res["table_bytes"] = int(plan.total_rows * plan.dim * 4)

    until("the pservers answer", lambda: all(
        call(e, "ping", 1.0) == "pong" for e in ps_eps), 180)
    res["pservers_answer_s"] = time.time() - t_launch
    table = tps.RemoteTable(c["table"], ws.table_shape(plan), ps_eps,
                            replication=2, **ws.table_kwargs(plan))
    pub = ws.WeightPublisher(table, plan)
    t_pub1 = time.time()
    pub.publish(sets["v1"])
    res["publish_s"] = {"v1": time.time() - t_pub1}

    def epoch(ep):
        return int(call(ep, "health", 5.0).get("weight_epoch", 0))

    first_v1 = {}
    for r, ep in enumerate(eps):
        until(f"replica {r} adopts v1", lambda: epoch(ep) >= 1, 600, 0.1)
        first_v1[r] = time.time() - t_pub1
    res["publish_to_v1_adopted_s"] = first_v1
    res["launch_to_v1_adopted_s"] = time.time() - t_launch
    pids = _replica_pids(launcher.pid)
    renv = {r: _proc_environ(pid) for r, pid in pids.items()}
    # the kernels' launch counts, read from each replica's stats: a
    # replica process starts at 0; replica 0's first incarnation is read
    # just before its SIGKILL, every other one at the job's end
    launches = {}

    def kernel_launches(ep):
        return call(ep, "stats", 30.0)["kernel_launches"]

    res["pserver_cuda_visible_devices"] = sorted({
        _proc_environ(pid).get("CUDA_VISIBLE_DEVICES", "<unset>")
        for pid in _proc_children(launcher.pid)
        if b"distributed.ps_server" in _proc_cmdline(pid)})

    # v1 on both replicas against the oracle; generate against the
    # in-process engine; the pool, the coordinator, the stamps
    adopt = {}
    for r, ep in enumerate(eps):
        bits, worst = True, 0.0
        for i in range(4):
            out = call(ep, "infer", 300.0, feed=reqs[i],
                       deadline_ms=300000.0)
            if out["weight_epoch"] != 1:
                raise RuntimeError(f"replica {r}: epoch {out['weight_epoch']}")
            b, w = _same(out["outputs"], want["v1"][i])
            bits, worst = bits and b, max(worst, w)
        adopt[r] = {"bit_equal": bits, "max_abs_diff": worst}
    res["adopt_v1"] = adopt
    gen = {r: call(ep, "generate", 600.0, prompt=prompt,
                   max_new_tokens=c["gen_tokens"])["tokens"]
           for r, ep in enumerate(eps)}
    res["generate"] = {"want": gen_want, "got": gen}
    stats = {r: call(ep, "stats", 30.0) for r, ep in enumerate(eps)}
    res["kv_pool"] = {r: s["generation"]["kv_pool"] for r, s in
                      stats.items()}
    res["weight_sync"] = {r: s["weight_sync"] for r, s in stats.items()}
    coord = CoordinatorClient(renv[0]["PADDLE_COORDINATOR_ENDPOINT"],
                              deadline=10.0)
    try:
        members = coord.call("membership")["members"]
    finally:
        coord.close()
    res["members"] = {t: {"kind": m["kind"], "endpoint": m.get("endpoint"),
                          "alive": m.get("alive")}
                      for t, m in members.items()}
    hb_dir = renv[0]["PADDLE_HEARTBEAT_DIR"]
    now = time.time()
    res["stamp_age_s"] = {r: now - os.path.getmtime(
        os.path.join(hb_dir, f"heartbeat.{r}")) for r in range(2)}
    res["replica_env"] = {r: {k: v for k, v in e.items()
                              if k.startswith("PADDLE_SERVE")
                              or k in ("PADDLE_PSERVERS_IP_PORT_LIST",
                                       "PADDLE_CURRENT_ENDPOINT",
                                       "PADDLE_TRAINER_TAG",
                                       "CUDA_VISIBLE_DEVICES")}
                          for r, e in renv.items()}

    # the weight table's bytes on the wire: a full fetch, then a
    # steady-state poll, from a subscriber of this process's own
    def rx():
        return sum(reg.counter("ps_client_bytes_received_total",
                               verb=v).value
                   for v in ("fetch_replica_state", "replica_status"))

    sub = ws.WeightSubscriber(ps_eps, c["table"], plan, lambda w, v: None)
    wire = {}
    for what in ("full_fetch", "steady_poll"):
        b0 = rx()
        sub.poll_once()
        wire[what] = rx() - b0

    # the fleet: 4 client threads over both replicas, a probe of each
    # replica with request 0
    stop = threading.Event()
    records, errors, probes, probe_errors = [], [], [], []

    def client(k):
        order = eps if k % 2 == 0 else eps[::-1]
        cli = InferenceClient(order, deadline_secs=120.0, hedge_quantile=0)
        i = k
        try:
            while not stop.is_set():
                t1 = time.time()
                try:
                    out = cli.infer(reqs[i % len(reqs)], deadline_ms=120000)
                except Exception as e:  # noqa: BLE001 — held below
                    errors.append(f"{type(e).__name__}: {e}")
                    continue
                t2 = time.time()
                v = f"v{out.weight_epoch}"
                b, w = _same(out.outputs, want[v][i % len(reqs)]) \
                    if v in want else (False, float("inf"))
                records.append({"t": t2, "ms": (t2 - t1) * 1e3,
                                "replica": eps.index(out.replica),
                                "epoch": out.weight_epoch, "bit": b,
                                "diff": w})
                i += c["threads"]
        finally:
            cli.close()

    def probe():
        while not stop.is_set():
            for r, ep in enumerate(eps):
                try:
                    out = call(ep, "infer", 5.0, feed=reqs[0],
                               deadline_ms=60000.0)
                except Exception as e:  # noqa: BLE001 — the kill window
                    probe_errors.append({"t": time.time(), "replica": r,
                                         "error": type(e).__name__})
                    continue
                v = f"v{out['weight_epoch']}"
                b, w = _same(out["outputs"], want[v][0]) \
                    if v in want else (False, float("inf"))
                probes.append({"t": time.time(), "replica": r,
                               "epoch": out["weight_epoch"], "bit": b,
                               "diff": w})
            time.sleep(0.2)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(c["threads"])]
    threads.append(threading.Thread(target=probe, daemon=True))
    t_stream = time.time()
    for th in threads:
        th.start()
    time.sleep(c["before_kill_s"])
    victim = pids[0]
    launches["replica0"] = kernel_launches(eps[0])
    t_kill = time.time()
    os.kill(victim, signal.SIGKILL)
    newpid = until("replica 0 respawned", lambda: (
        _replica_pids(launcher.pid).get(0) not in (None, victim)
        and _replica_pids(launcher.pid)[0]), 120, 0.05)
    t_respawned = time.time()
    until("replica 0 listening", lambda: call(eps[0], "health", 1.0)["ok"],
          300, 0.1)
    t_listening = time.time()
    until("replica 0 re-adopts v1", lambda: epoch(eps[0]) >= 1, 300, 0.1)
    t_readopted = time.time()
    detected = [t for t, ln in lines if "respawning in place" in ln]
    res["respawn"] = {
        "kill_to_detected_s": (detected[0] - t_kill) if detected else None,
        "kill_to_respawned_s": t_respawned - t_kill,
        "kill_to_listening_s": t_listening - t_kill,
        "kill_to_readopted_s": t_readopted - t_kill,
        "old_pid": victim, "new_pid": newpid,
        "new_env_fault_spec": "PADDLE_PS_FAULT_SPEC" in _proc_environ(
            newpid)}
    a = call(eps[0], "infer", 300.0, feed=reqs[1], deadline_ms=300000.0)
    b = call(eps[1], "infer", 300.0, feed=reqs[1], deadline_ms=300000.0)
    res["respawned_vs_survivor"] = {
        "epochs": [a["weight_epoch"], b["weight_epoch"]],
        "bit_equal": _same(a["outputs"], [np.asarray(o) for o in
                                          b["outputs"]])[0]}
    survivor = call(eps[1], "health", 5.0)
    res["survivor_uptime_s"] = survivor["uptime_s"]
    res["survivor_uptime_spans_kill"] = \
        survivor["uptime_s"] > time.time() - t_kill
    time.sleep(1.0)
    # v2, mid-stream
    t_pub2 = time.time()
    pub.publish(sets["v2"])
    res["publish_s"]["v2"] = time.time() - t_pub2
    for r, ep in enumerate(eps):
        until(f"replica {r} adopts v2", lambda: epoch(ep) >= 2, 300, 0.1)
    time.sleep(c["after_v2_s"])
    stop.set()
    for th in threads:
        th.join(300)
    t_stream_end = time.time()
    launches["replica0_respawn"] = kernel_launches(eps[0])
    launches["replica1"] = kernel_launches(eps[1])
    res["launches"] = launches
    for what in ("v2_poll", "steady_poll_after_v2"):
        b0 = rx()
        sub.poll_once()
        wire[what] = rx() - b0
    sub.stop()
    res["wire_bytes"] = wire
    table.close()

    res["stream"] = {
        "seconds": t_stream_end - t_stream, "requests": len(records),
        "errors": errors, "client_ms": _pcts([r["ms"] for r in records]),
        "by_replica": {r: sum(x["replica"] == r for x in records)
                       for r in range(2)},
        "by_epoch": {e: sum(x["epoch"] == e for x in records)
                     for e in (1, 2)},
        "bit_equal": all(x["bit"] for x in records),
        "max_abs_diff": max([x["diff"] for x in records] or [0.0])}
    res["probes"] = {"n": len(probes), "errors": probe_errors,
                     "bit_equal": all(p["bit"] for p in probes),
                     "max_abs_diff": max([p["diff"] for p in probes]
                                         or [0.0])}
    # a replica binds its port only after its first adoption: no reply,
    # the respawn's included, at the export's weights (epoch 0)
    res["stream"]["epoch0_replies"] = sum(
        1 for x in records + probes if x["epoch"] == 0)
    # each replica's fence: one change of epoch (1 -> 2) in each
    # incarnation, its outputs the epoch's weights' throughout
    fences = {}
    for r in range(2):
        seq = [(p["t"], p["epoch"]) for p in probes if p["replica"] == r]
        if r == 0:   # the respawned incarnation, from its re-adoption
            seq = [x for x in seq if x[0] > t_readopted]
        eps_seen = [e for _, e in seq]
        changes = sum(1 for x, y in zip(eps_seen, eps_seen[1:]) if x != y)
        first2 = min([t for t, e in seq if e == 2] + [
            x["t"] for x in records if x["replica"] == r and x["epoch"] == 2
            and x["t"] > t_pub2] or [float("nan")])
        fences[r] = {"epochs_seen": sorted(set(eps_seen)),
                     "changes": changes,
                     "monotone": eps_seen == sorted(eps_seen),
                     "publish_to_first_v2_reply_s": first2 - t_pub2}
    res["fences"] = fences

    # SIGTERM drains each replica; a drained job exits 0
    t_term = time.time()
    for pid in _replica_pids(launcher.pid).values():
        os.kill(pid, signal.SIGTERM)
    res["rc"] = launcher.wait(timeout=180)
    res["drain_s"] = time.time() - t_term
    res.pop("_launcher")
    # each launcher line with its seconds from the launch ("2 pserver(s)
    # on ...": the pservers up; "serving replicas": the replicas spawned)
    res["launcher_lines"] = [[round(t - t_launch, 3), ln] for t, ln in lines
                             if ln.startswith("[launch]")]
    logs = {}
    for fn in sorted(os.listdir(c["logs"])):
        with open(os.path.join(c["logs"], fn), errors="replace") as f:
            logs[fn] = f.read()
    res["drained"] = {fn: "SIGTERM: draining" in t
                      for fn, t in logs.items() if fn.startswith("worker")}
    res["tracebacks"] = [fn for fn, t in logs.items() if "Traceback" in t]
    res["times"] = {"launch_to_end_s": time.time() - t_launch}


def _serve_launch_start(workdir: str, model_dir: str) -> dict:
    """Start the serve_launch child in the background (before the gloo
    spawn, beside the parameter-server jobs)."""
    os.makedirs(workdir, exist_ok=True)
    c = dict(SERVE_LAUNCH, model_dir=model_dir,
             decoder=GPT2_SMALL,
             logs=os.path.join(workdir, "logs"),
             out=os.path.join(workdir, "result.json"))
    cfg_path = os.path.join(workdir, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    here = os.path.dirname(os.path.abspath(__file__))
    err = open(os.path.join(workdir, "child.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve-launch-child",
         cfg_path], env=dict(os.environ, PYTHONPATH=here), stdout=err,
        stderr=err, start_new_session=True, cwd=here)
    return {"proc": proc, "err": err, "c": c, "t0": time.time()}


def _serve_launch_kill(started: dict) -> None:
    """Stop the child and everything it started (its process group)."""
    try:
        os.killpg(started["proc"].pid, 9)
    except ProcessLookupError:
        pass
    started["proc"].wait()


def _serve_launch_join(started: dict) -> dict:
    proc = started["proc"]
    deadline = started["t0"] + started["c"]["join_s"]
    while proc.poll() is None and time.time() < deadline:
        time.sleep(0.2)
    t_end = time.time()
    rc = proc.poll()
    _serve_launch_kill(started)
    started["err"].close()
    with open(started["err"].name, errors="replace") as f:
        tail = f.read()[-4000:]
    if rc is None:
        fail(f"serve_launch: no exit within {started['c']['join_s']} s: "
             f"{tail}")
    try:
        with open(started["c"]["out"]) as f:
            res = json.load(f)
    except (OSError, ValueError):
        fail(f"serve_launch: exit {rc}, no result: {tail}")
    if rc != 0 or "error" in res:
        fail(f"serve_launch: {res.get('error')} (exit {rc}): {tail}")
    # the child's own end: it is joined only after the gloo spawn
    res["window"] = (started["t0"], res.get("t_end", t_end))
    return res


def phase_serve_launch(card: str, res: dict, windows: dict) -> dict:
    """The holds of the serve_launch job and its line: both replicas adopt
    v1 (bit for bit the oracle's, else within the infer phase's f32
    limit), a kill costs no request, the respawn re-adopts and answers
    like the survivor, v2 moves each replica's fence once, generate,
    the pool, the coordinator, the stamps, the drain."""
    c = SERVE_LAUNCH
    if res["stream"]["epoch0_replies"]:
        fail(f"serve_launch: {res['stream']['epoch0_replies']} replies at "
             f"the export's weights, before a replica's first adoption")
    bits = all(a["bit_equal"] for a in res["adopt_v1"].values()) \
        and res["stream"]["bit_equal"] and res["probes"]["bit_equal"]
    worst = max([a["max_abs_diff"] for a in res["adopt_v1"].values()]
                + [res["stream"]["max_abs_diff"],
                   res["probes"]["max_abs_diff"]])
    if not (bits or worst <= BERT_PARITY_LIMIT):
        fail(f"serve_launch: replies differ from the oracle by {worst} > "
             f"{BERT_PARITY_LIMIT}")
    if res["stream"]["errors"]:
        fail(f"serve_launch: request errors {res['stream']['errors'][:4]}")
    if not res["survivor_uptime_spans_kill"]:
        fail(f"serve_launch: the survivor restarted "
             f"(uptime {res['survivor_uptime_s']} s)")
    rv = res["respawned_vs_survivor"]
    if rv["epochs"] != [1, 1] or not rv["bit_equal"]:
        fail(f"serve_launch: the respawned replica against the survivor "
             f"{rv}")
    if res["respawn"]["new_env_fault_spec"]:
        fail("serve_launch: the respawn inherited the fault schedule")
    for r, f in res["fences"].items():
        if f["epochs_seen"] != [1, 2] or f["changes"] != 1 \
                or not f["monotone"]:
            fail(f"serve_launch: replica {r}'s fence {f}")
    if any(g != res["generate"]["want"]
           for g in res["generate"]["got"].values()):
        fail(f"serve_launch: generate {res['generate']}")
    if any(p["n_pages"] != c["kv_pages"] for p in res["kv_pool"].values()):
        fail(f"serve_launch: pools {res['kv_pool']}")
    kinds = {t: m["kind"] for t, m in res["members"].items()}
    if kinds.get("trainer0") != "inference" \
            or kinds.get("trainer1") != "inference":
        fail(f"serve_launch: coordinator members {res['members']}")
    if res["pserver_cuda_visible_devices"] != [""]:
        fail(f"serve_launch: pservers see "
             f"{res['pserver_cuda_visible_devices']}")
    if max(res["stamp_age_s"].values()) >= c["hb_timeout"]:
        fail(f"serve_launch: heartbeat stamps {res['stamp_age_s']} s old")
    wire = res["wire_bytes"]
    steady = max(wire["steady_poll"], wire["steady_poll_after_v2"])
    if steady >= 2 ** 20 or wire["full_fetch"] < res["table_bytes"]:
        fail(f"serve_launch: weight-table bytes {wire}")
    if res["rc"] != 0 or not all(res["drained"].values()) \
            or res["tracebacks"]:
        fail(f"serve_launch: after SIGTERM: exit {res['rc']}, drained "
             f"{res['drained']}, tracebacks in {res['tracebacks']}")
    total = {k: sum(n[k] for n in res["launches"].values())
             for k in res["launches"]["replica1"]}
    ran = {k: total[k] for k in ("paged_attention", "add_ln",
                                 "flash_attention_bsh")}
    if not all(ran.values()):
        fail(f"serve_launch: rows 1, 2 and 4 launched {ran} in the replicas")
    a, b = res["window"]
    out = {"phase": "serve_launch", "card": card,
           "command": res["command"],
           "model": "BertConfig.base() f32 (the serve phase's export); "
                    "v1, v2 from seeds " + str(list(c["seeds"])),
           "decoder": res["decoder"], "table_bytes": res["table_bytes"],
           "pserver_cuda_visible_devices":
               res["pserver_cuda_visible_devices"],
           "bit_equal_to_oracle": bits, "max_abs_diff": worst,
           "limit_if_not_bit_equal": BERT_PARITY_LIMIT,
           "adopt_v1": res["adopt_v1"],
           "publish_to_v1_adopted_s": res["publish_to_v1_adopted_s"],
           "launch_to_v1_adopted_s": res["launch_to_v1_adopted_s"],
           "pservers_answer_s_after_setup": res["pservers_answer_s"],
           "publish_s": res["publish_s"],
           "publish_to_first_v2_reply_s": {
               r: f["publish_to_first_v2_reply_s"]
               for r, f in res["fences"].items()},
           "fences": res["fences"], "wire_bytes": wire,
           "respawn": res["respawn"],
           "survivor_uptime_s": res["survivor_uptime_s"],
           "stream": res["stream"],
           "probes": {k: v for k, v in res["probes"].items()
                      if k != "errors"},
           "probe_errors_in_kill_window": len(res["probes"]["errors"]),
           "generate_tokens_equal": True,
           "kv_pool": res["kv_pool"], "members": res["members"],
           "stamp_age_s": res["stamp_age_s"],
           "replica_env": res["replica_env"],
           "launcher_lines": res["launcher_lines"],
           "drain_s": res["drain_s"], "rc": res["rc"],
           "setup_s": res["setup_s"],
           "launches": total,
           "launches_by_replica": res["launches"],
           "wall_s": b - a,
           "concurrent_with": sorted(n for n, (x, y) in windows.items()
                                     if x < b and a < y)}
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every JSON line to this file")
    ap.add_argument("--fit-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fit-role", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-world", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--elastic-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ps-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-launch-child", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.serve_launch_child:
        return _serve_launch_child(args.serve_launch_child)
    if args.ps_child:
        return _ps_child(args.ps_child)
    if args.elastic_child:
        return _elastic_child(args.elastic_child)
    if args.fit_child:
        return _fit_child(args.fit_child, args.fit_role)
    if args.dist_child:
        return _dist_child(args.dist_child, args.dist_rank, args.dist_world,
                           args.dist_dir)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    os.environ["PADDLE_TRACING"] = "1"   # engine spans: per-step times
    t_start = time.perf_counter()
    env = phase_env(torch)
    build = phase_build()
    kern = phase_kernels(torch)
    phase_emitters(torch)
    text_cnn = phase_text_cnn(torch, env["card"])
    torch.cuda.empty_cache()

    from paddle_tpu_torch.inference import DecoderConfig, TinyDecoderLM

    # GPT-2 small's published widths (BERT-base's too), 50257-token
    # vocabulary and 1024 positions; random weights from seed 0
    cfg = DecoderConfig(**GPT2_SMALL)
    model = TinyDecoderLM(cfg, seed=0, device="cuda")
    eng = phase_engine(torch, cfg, model, env["card"])
    phase_parity(torch, cfg, model)
    phase_decode_sync(torch, cfg, model)
    phase_profile(torch, cfg, model)
    del model
    torch.cuda.empty_cache()

    infer = phase_bert_infer(torch, env["card"])
    phase_bert_parity(torch, infer)
    import shutil
    import tempfile

    # the serve phase's BERT-base export, kept for serve_launch
    serve_model = tempfile.mkdtemp(prefix="serve_bert_")
    atexit.register(shutil.rmtree, serve_model, True)
    serve = phase_serve(torch, env["card"], cfg, serve_model)
    phase_bert_profile(torch, infer)
    infer_launches = {"flash": infer["flash_launches"],
                      "ln": infer["ln_launches"]}
    del infer
    torch.cuda.empty_cache()

    train = phase_bert_train(torch, env["card"])
    phase_bert_train_profile(torch, train)
    launches = train["launches"]
    del train
    torch.cuda.empty_cache()
    phase_bert_train_parity(torch)

    rtrain = phase_resnet_train(torch, env["card"])
    phase_resnet_train_profile(torch, rtrain)
    rlaunches = rtrain["launches"]
    del rtrain
    torch.cuda.empty_cache()
    phase_resnet_train_parity(torch)
    phase_resnet_infer(torch, env["card"])
    recipe_launches = phase_resnet_recipe(torch, env["card"])["launches"]
    torch.cuda.empty_cache()

    nmt = phase_nmt_train(torch, env["card"])
    phase_nmt_train_profile(torch, nmt)
    nlaunches = nmt["launches"]
    del nmt
    torch.cuda.empty_cache()
    phase_nmt_train_parity(torch)
    ninfer = phase_nmt_infer(torch, env["card"])["launches"]
    mlaunches = phase_mha_key_train(torch, env["card"])["launches"]
    torch.cuda.empty_cache()

    tlaunches = phase_transformer_train(torch, env["card"])["launches"]
    torch.cuda.empty_cache()
    phase_transformer_train_parity(torch)
    long_runs = phase_bert_long_train(torch, env["card"])["runs"]
    llaunches = long_runs["chosen"]["launches"]
    flaunches = long_runs["flash"]["launches"]
    torch.cuda.empty_cache()
    rlaunches_fit = phase_fit_resume(torch, env["card"])["launches"]
    torch.cuda.empty_cache()
    phase_verify(torch, env["card"])
    torch.cuda.empty_cache()
    lamb_rc = phase_bert_lamb_recompute(torch, env["card"])["runs"]
    torch.cuda.empty_cache()
    ps_example = _ps_example(torch)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip-dist-") as tmp:
        # the parameter-server jobs and the serve_launch job run beside
        # the dist ranks
        os.makedirs(os.path.join(tmp, "ps"))
        ps_started = _ps_jobs_start(os.path.join(tmp, "ps"))
        sl_started = _serve_launch_start(os.path.join(tmp, "serve_launch"),
                                         serve_model)
        try:
            # the gloo phases' four ranks start once for all their
            # bodies, the NCCL rank beside them
            raw = _dist_spawn({"nccl": (("nccl",), 1), "gloo": (
                ("ring", "train", "tp", "pp", "ep", "zero", "dcn"),
                DIST_WORLD)}, tmp)
            served = _serve_launch_join(sl_started)
        except BaseException:
            _ps_jobs_kill(ps_started)
            _serve_launch_kill(sl_started)
            raise
        windows = {m: r[0]["window"] for m, r in raw.items()}
        windows["serve_launch"] = served["window"]
        ps_jobs, ps_windows = _ps_jobs(torch, ps_started, windows)
        windows.update(ps_windows)
        for m, ranks in raw.items():
            a, b = ranks[0]["window"]
            for r in ranks:
                r["concurrent_with"] = r["concurrent_with"] + sorted(
                    n for n, (c0, c1) in windows.items()
                    if n not in raw and c0 < b and a < c1)
        serve_launch = phase_serve_launch(env["card"], served, {
            n: w for n, w in windows.items() if n != "serve_launch"})
        ps = phase_ps_train(torch, env["card"], ps_example, ps_jobs)
        torch.cuda.empty_cache()
        phase_dist_ring(torch, env["card"], raw.pop("ring"))
        torch.cuda.empty_cache()
        dtrain = phase_dist_train(torch, env["card"], raw.pop("train"))
        torch.cuda.empty_cache()
        phase_dist_nccl(torch, env["card"], raw.pop("nccl"))
        dtp = phase_dist_tp(torch, env["card"], raw.pop("tp"))
        torch.cuda.empty_cache()
        dpp = phase_dist_pp(torch, env["card"], raw.pop("pp"))
        torch.cuda.empty_cache()
        dep = phase_dist_ep(torch, env["card"], raw.pop("ep"))
        torch.cuda.empty_cache()
        dzero = phase_dist_zero(torch, env["card"], raw.pop("zero"))
        torch.cuda.empty_cache()
        ddcn = phase_dist_dcn(torch, env["card"], raw.pop("dcn"),
                              dzero["dp"]["losses"])
        del raw
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(tmp, "elastic"))
        delastic = phase_dist_elastic(torch, env["card"],
                                      os.path.join(tmp, "elastic"))
    dlaunches = dtrain["bf16"]["launches"]
    dlaunches_f32 = dtrain["f32"]["launches"]

    def new_paths(key):
        """The launches of ``key`` on the paths of slices 12, 14 and 18
        (bert_lamb_recompute's 8 steps with recompute and without)."""
        return {"transformer_train": tlaunches[key],
                "bert_long_train": llaunches[key],
                "bert_long_train_flash": flaunches[key],
                "fit_resume": rlaunches_fit[key],
                "bert_lamb_recompute": lamb_rc["recompute"]["launches"][key],
                "bert_lamb_no_recompute": lamb_rc["plain"]["launches"][key]}

    def dist_paths(key):
        """Rank 0's launches of ``key`` over dist_train's 3 steps."""
        return {"dist_train": dlaunches[key],
                "dist_train_f32": dlaunches_f32[key]}

    def tp_pp_paths(key):
        """Rank 0's launches of ``key`` over the 3 bf16 and the 3 f32
        steps of dist_tp, dist_pp and its pp x sp run, dist_ep's two
        layouts and dist_dcn; dist_zero's 3 bf16 steps sharded and not,
        dist_dcn's 3 DGC steps, the clean dist_elastic run's 4 steps."""
        out = {}
        for path, runs in (("dist_tp", dtp), ("dist_pp", dpp["pp"]),
                           ("dist_pp_sp", dpp["pp_sp"]),
                           ("dist_ep", dep["ep"]), ("dist_ep4", dep["ep4"]),
                           ("dist_dcn", ddcn)):
            out[path] = runs["bf16"]["launches"][key]
            out[f"{path}_f32"] = runs["f32"]["launches"][key]
        out["dist_zero"] = dzero["zero"]["launches"][key]
        out["dist_zero_unsharded"] = dzero["dp"]["launches"][key]
        out["dist_dcn_dgc"] = ddcn["dgc"]["launches"][key]
        # rank 0 over the clean dist_elastic run's 4 steps
        out["dist_elastic"] = 4 * delastic["launches_per_step_per_rank"][
            "clean"].get(key, 0)
        return out

    # the parameter-server path: (a)'s 30 steps on the card and every
    # trainer of (b), (c) and their one-process reference; no kernel
    ps_launches = {k: ps_example["launches"][k] + ps["launches"][k]
                   for k in ps_example["launches"]}
    ps_key = {"paged_attention": "paged", "flash_attention_bsh": "bsh_fwd",
              "flash_attention_bsh_bwd": "bsh_bwd", "add_ln": "ln_fwd",
              "add_ln_bwd": "ln_bwd", "flash_attention": "row6",
              "flash_attention_bwd_fused": "row7",
              "flash_attention_bwd_dq": "row8",
              "flash_attention_bwd_dkv": "row9"}

    def entry(name, source, replaces, k, path_launches, main="bert_train"):
        e = _kernel_entry(name, source, replaces, path_launches[main], k)
        e["launches_by_path"] = dict(
            path_launches, ps_train=ps_launches[ps_key.get(name, name)],
            text_cnn=text_cnn["launches"][ps_key.get(name, name)],
            # summed over the replicas' processes (their stats)
            serve_launch=serve_launch["launches"][name])
        return e

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    conv_bn = [
        ("conv_stats", "paddle_tpu/ops/pallas/conv_bn.py:354"),
        ("mm_stats", "paddle_tpu/ops/pallas/conv_bn.py:387"),
        ("bn_apply", "paddle_tpu/ops/pallas/conv_bn.py:478"),
        ("bn_bwd_reduce", "paddle_tpu/ops/pallas/conv_bn.py:496"),
        ("bn_bwd_dz", "paddle_tpu/ops/pallas/conv_bn.py:510")]
    tc_paths = {
        "flash_attention_bsh": {"bert_train": launches["bsh_fwd_tc"],
                                "nmt_train": nlaunches["bsh_fwd_tc"],
                                "bert_infer": 0,
                                "serve": serve["launches"]["flash_tc"],
                                "nmt_infer": ninfer["bsh_fwd_tc"],
                                **new_paths("bsh_fwd_tc"),
                                **tp_pp_paths("bsh_fwd_tc")},
        "flash_attention_bsh_bwd": {"bert_train": launches["bsh_bwd_tc"],
                                    "nmt_train": nlaunches["bsh_bwd_tc"],
                                    **new_paths("bsh_bwd_tc"),
                                    **tp_pp_paths("bsh_bwd_tc")},
        "flash_attention_bwd_fused": {"mha_key_train": mlaunches["row7_tc"],
                                      **dist_paths("row7_tc"),
                                      **tp_pp_paths("row7_tc")},
        "flash_attention": {"nmt_train": nlaunches["row6_tc"],
                            "mha_key_train": mlaunches["row6_tc"],
                            **dist_paths("row6_tc"),
                            **tp_pp_paths("row6_tc")},
        "flash_attention_bwd_dq": {"nmt_train": nlaunches["row8_tc"]},
        "flash_attention_bwd_dkv": {"nmt_train": nlaunches["row9_tc"]},
        "conv_stats": {"resnet_train": rlaunches["conv_stats_tc"],
                       "resnet_recipe": recipe_launches["conv_stats_tc"]},
        "mm_stats": {"resnet_train": rlaunches["mm_stats_tc"],
                     "resnet_recipe": recipe_launches["mm_stats_tc"]}}
    # rows 4 and 5 also at dist_tp's shape, [4, 512, 6 x 64] a rank
    at_tp = {"flash_attention_bsh": kern["flash_attention_bsh_train"],
             "flash_attention_bsh_bwd": kern["flash_attention_bsh_bwd"]}
    at_tp = {name: {k: t["dist_tp"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for name, t in at_tp.items()}
    emit({"kernels": [dict(e, at_dist_tp_shape=at_tp[e["name"]])
                      if e["name"] in at_tp else e for e in [
                      dict(e, launches_tc_by_path=tc_paths[e["name"]])
                      if e["name"] in tc_paths else e for e in [
        entry("paged_attention", "paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:144",
              kern["paged_attention"],
              {"engine": eng["paged_attention_launches"],
               "serve": serve["launches"]["paged"]}, main="engine"),
        entry("flash_attention_bsh", "flash_attention_bsh.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:1500",
              kern["flash_attention_bsh_train"],
              {"bert_train": launches["bsh_fwd"],
               "bert_infer": infer_launches["flash"],
               "serve": serve["launches"]["flash"],
               "nmt_train": nlaunches["bsh_fwd"],
               "nmt_infer": ninfer["bsh_fwd"], **new_paths("bsh_fwd"),
               **tp_pp_paths("bsh_fwd")}),
        entry("flash_attention_bsh_bwd", "flash_attention_bsh.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:1697",
              kern["flash_attention_bsh_bwd"],
              {"bert_train": launches["bsh_bwd"],
               "nmt_train": nlaunches["bsh_bwd"], **new_paths("bsh_bwd"),
               **tp_pp_paths("bsh_bwd")}),
        entry("add_ln", "add_ln.cu", "paddle_tpu/ops/pallas/add_ln.py:145",
              kern["add_ln_train"],
              {"bert_train": launches["ln_fwd"],
               "bert_infer": infer_launches["ln"],
               "serve": serve["launches"]["ln"],
               "nmt_train": nlaunches["ln_fwd"],
               "nmt_infer": ninfer["ln_fwd"], **new_paths("ln_fwd"),
               **dist_paths("ln_fwd"), **tp_pp_paths("ln_fwd")}),
        entry("add_ln_bwd", "add_ln.cu",
              "paddle_tpu/ops/pallas/add_ln.py:175", kern["add_ln_bwd"],
              {"bert_train": launches["ln_bwd"],
               "nmt_train": nlaunches["ln_bwd"], **new_paths("ln_bwd"),
               **dist_paths("ln_bwd"), **tp_pp_paths("ln_bwd")}),
        entry("flash_attention", "flash_attention_bhsd.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:392",
              kern["flash_attention"],
              {"nmt_train": nlaunches["row6"], "nmt_infer": ninfer["row6"],
               "mha_key_train": mlaunches["row6"], **dist_paths("row6"),
               **tp_pp_paths("row6")},
              main="nmt_train"),
        entry("flash_attention_bwd_fused", "flash_attention_bhsd.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:790",
              kern["flash_attention_bwd_fused"],
              {"mha_key_train": mlaunches["row7"], **dist_paths("row7"),
               **tp_pp_paths("row7")},
              main="dist_train"),
        entry("flash_attention_bwd_dq", "flash_attention_bhsd.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:902",
              kern["flash_attention_bwd_dq"],
              {"nmt_train": nlaunches["row8"]}, main="nmt_train"),
        entry("flash_attention_bwd_dkv", "flash_attention_bhsd.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:943",
              kern["flash_attention_bwd_dkv"],
              {"nmt_train": nlaunches["row9"]}, main="nmt_train")]
        + [entry(name, "conv_bn.cu", replaces, kern[name],
                 {"resnet_train": rlaunches[name],
                  "resnet_recipe": recipe_launches[name]},
                 main="resnet_train")
           for name, replaces in conv_bn]]]})
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
