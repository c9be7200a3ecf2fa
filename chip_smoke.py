#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, replays the golden
traces through the round kernel, drives the paper's Algorithm 2 at full
width through the port's engine and through the full linreg round kernel,
runs the Weiszfeld loop over the step kernels at full width, serves
H2O-Danube3-4B at full width through the flash-attention kernel, times
every kernel, runs shard-local aggregation in one process and on rank
processes of the card, trains H2O-Danube3-4B at full width (2 layers)
under attack through the round kernel, and serves and trains the MoE
Granite-3.0-1B-A400M (full width; 8 layers for training), checks
Kimi-K2's router and dispatch, serves RWKV6-7B and Zamba2-2.7B at full
width (Zamba2's shared attention through the flash kernel at head width
80) and trains Zamba2 (6 layers) under attack through the round kernel,
serves SeamlessM4T-medium (its encoder and cross-attention through the
flash kernel's non-causal calls) and InternVL2-26B (a patch prefix) at
full width, trains SeamlessM4T (1 + 1 layers) under attack through
the round kernel, and prefills H2O-Danube3-4B and Granite-3.0-1B-A400M at
full width on a model mesh of 4 rank processes of the card (sequence-
parallel attention through the flash kernel at a query offset, the SP+TP
SwiGLU, expert parallelism).
Every phase prints JSON lines; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every check
passed.  Exits non-zero without it on any failure, when CUDA is
unavailable, or when the ``src/repro_torch`` package is missing.

Phases:
  0 device       nvidia-smi name and power limit, torch and CUDA versions
  1 build        nvcc build of every kernel source, one process each, all
                 at once (seconds, ptxas summary per library); no spill in
                 any instance of the GMoM libraries (every instance named
                 in GMOM_INSTANCES present) or of the tensor-core
                 attention kernel
  2 parity       every kernel vs its plain version (round kernel and
                 linreg round in each of MODES, the linreg round on both
                 routes and at their boundary), rtol 1e-4 / atol 1e-5
                 against max|y|; two kernel runs must be bitwise equal;
                 sqdist and the Weiszfeld loop kernel bit for bit equal to
                 their twins on the wrapper's plan
  3 goldens      the eleven goldens (the sign-wire and the staleness
                 campaigns among them) on the card with
                 round_backend="auto" (every gmom round one round-kernel
                 launch, the count asserted), the interrupted-resume
                 replay, and the compressed and staleness campaigns
                 interrupted at round 19 and resumed (checkpoints every 7
                 rounds) byte-identical to a straight run
  4 full width   the paper config (d=100) and a wide one (d=8192):
                 gmom under sign_flip/rotating through the engine (kernel
                 path vs plain paths, one round-kernel launch per round);
                 on the same data, (a) gmom with straggler_rotating at
                 tau = 2, (c) int8_gmom on the int8_stochastic wire, each
                 kernel path vs plain path with one round-kernel launch
                 per round, (c) also one round's int8 payload on the card
                 bit-equal to the CPU's, and (b) sign_sgd_majority on the
                 packed sign wire byte-identical to the raw vote; host ms
                 per round beside the synchronous gmom round's;
                 failure-free rounds theta <- theta - eta linreg_round(X,
                 y, theta) held against the engine's failure-free run
                 (one linreg launch per round, all on the one-pass route);
                 both below paper_floor.
                 The Weiszfeld loop (geometric_median_kernel) at (k, d) =
                 (11, 8192) and (11, 25 557 032) (the register-streamed
                 loop kernel) and (64, 1 000 000) (the loop kernel over
                 tiles), one launch each, and at (100, 1 000 000) over the
                 sqdist/reweight kernels (k > 64), against
                 core.geometric_median and the
                 plain loop: both stop below the cap or both reach it,
                 exact counts at max_iters=3, the loop kernel's stop
                 replayed from its iterates
                 Flash attention vs its plain version over a grid
                 (tests/test_kernels.py's cases, H2O and Minitron widths up
                 to T = 8192, ragged and non-causal ragged): f32 through
                 the CUDA-core route at 2e-5; bf16 through the tensor-core
                 route (route counts asserted) at 3e-2 and within the
                 restated bound of the f32 plain version (BF16_BOUND);
                 bitwise repeats; a planted fault (no window) must fail
                 the bf16 check against f32
  4b serve path  H2O-Danube3-4B at full width (24 layers, 3840, 32 x 8
                 heads of 120, 10240, 32 000): the prefill step at B = 1,
                 T = 8192 in bf16 and f32, kernel path vs plain path (24
                 launches per prefill, all on the tensor-core route in
                 bf16 and on the CUDA-core route in f32; the bf16 prefill
                 is the main path's run), and the kernel path without the
                 window as a
                 planted fault; launch/serve.py at --scale gpu (4
                 requests, 16-token prompts, 32 new tokens); in f32 the
                 prefill step's last-position logits vs the decode loop's
  5 timings      kernel, plain and library times (medians of 20 after
                 warm-up), iterations, launches per call, bounds; device
                 kernels per call counted by torch.profiler, a session per
                 call (the round kernel, sqdist and the Weiszfeld loop
                 must be 1, the linreg round at most 2) with their
                 device time and the wrapper's host time; the linreg round
                 also through its two-pass route on the same inputs;
                 flash attention also through its CUDA-core kernel on the
                 same bf16 inputs (the kernel it replaced), and the
                 library's backend pinned with sdpa_kernel
  6 sharded      shard-local aggregation: (a) the virtual mode on the
                 card, every rule x (none and its native codec) at (m, k)
                 = (50, 11) and (50, 10), d = 8192 in S = 8 shards, f32
                 and with "w" in bf16, two runs bitwise equal, against
                 the unsharded path (f32: round_backend="auto" within
                 RTOL / ATOL of max|y|; bf16: the reference backend within
                 BF16_STEPS of max|y|; int8_gmom on its wire: scales
                 bit-equal, q within a step); (b) make_sharded_aggregate
                 on 4 rank processes of the card over gloo at d =
                 25 557 032 for gmom, krum, norm_filter_gmom, coord_median
                 and int8_gmom on its wire, each rank's result its slice
                 of the virtual result bit for bit, ms of each mode beside
                 the unsharded gmom and round kernel; (c)
                 make_shardmap_aggregate on 8 rank processes (m = 8, k =
                 4, d = 8192, round_backend="auto"): one round-kernel
                 launch per rank per call, within 1e-5 of gmom_aggregator
                 on the gathered stack (kernel and reference)
  8 train        Byzantine-robust LM training through launch/train.py's
                 train(args) at H2O-Danube3-4B's published widths cut to
                 2 layers (P = 555.4 M), bf16, remat, m = 8, q = 2, gmom under
                 sign_flip/rotating, AdamW, 2 x 512 tokens a worker:
                 (a) 4 rounds, one round-kernel launch each, finite loss,
                 s per step and peak memory; kernel vs plain histories
                 ("auto" vs "fused_interpret") within compare_traces at
                 m = 4, q = 1, k = 4 (the plain round's (k, P) blocks do
                 not fit at k = 8); (b) 2 steps with a checkpoint resumed
                 to 4, bit-identical to the straight run; (c)
                 make_group_train_step with remat and 2 microbatches, k =
                 4, 3 steps, one launch a step, kernel vs plain; (d) the
                 reference's LM robustness assertions
                 (tests/test_system.py) on the card, and the same curves
                 at (a)'s config; the round kernel timed at (8, 8, P) on a
                 block of real gradients, against round_aggregate_ref
                 (rtol 1e-4 / atol 1e-5 of max|y|), its own stop, and
                 both at exactly 3 iterations (max_iters=3, tol=0)
  9 moe          the MoE family: (a) Granite-3.0-1B-A400M at full width
                 and depth (24 layers, 1024, 16 x 8 heads of 64, 32
                 experts of 512, top-8, 49 155): the prefill step at B =
                 1, T = 8192 in bf16 and f32, the kernel path (24 flash
                 launches at hd 64 on the dtype's route) and again with
                 the plain path's expert choices replayed, held against
                 the plain path under PREFILL_RTOL (the free path's error
                 and router flips recorded; the earliest flip's margin held
                 to FLIP_MARGIN_FACTOR x the replayed run's router
                 probability error), the dropped assignments at
                 the configured capacity; serve --arch
                 granite-moe-1b-a400m --scale gpu; in f32 at C = N the
                 prefill's last-position logits vs the decode loop's; (b)
                 launch/train.py at Granite's widths cut to 8 layers
                 (P = 528.8 M) with phase 8's settings: one round-kernel
                 launch a round at (8, 8, P), s per step and peak GB,
                 kernel vs plain histories at m = 4 (phase 8 (b) holds
                 the resume on the card); (c) the group-mode step with
                 remat, kernel vs plain, and the loss with remat equal to
                 the loss without; the round
                 kernel timed at (8, 8, P) on a block of real Granite
                 gradients, as phase 8 times it on H2O's; (d)
                 Kimi-K2's router and dispatch (E = 384, D = 7168) on 8192
                 tokens: top_ids equal across card and CPU except at near
                 ties, the dispatch on the same routing bitwise equal
 10 recurrent    the recurrent families: (a) RWKV6-7B at full width and
                 depth (32 layers, 4096, heads of 64, 65 536): the WKV
                 recurrence at one layer's (1, 8192, 64, 64) in f32,
                 chunked vs token by token within WKV_RTOL; the bf16
                 prefill at B = 1, T = 8192; serve --arch rwkv6-7b --scale
                 gpu (tokens/s, decode ms a step); in f32 at 8 layers a
                 512-token prefill's last logits vs 512 decode steps (1e-3 of
                 max|logits|); the reduced model on the card vs the CPU
                 (CARD_VS_CPU_RTOL); (b) Zamba2-2.7B at full width and depth
                 (54 Mamba2 blocks, 9 applications of the shared block of
                 32 x 32 heads of 80): the prefill at B = 1, T = 8192 in
                 bf16 and f32, kernel path vs plain path under
                 PREFILL_RTOL, 9 flash launches per prefill on the dtype's
                 route; in f32 the served prompts' prefill logits vs the
                 decode loop's; serve --arch zamba2-2.7b --scale gpu; (c)
                 launch/train.py at Zamba2's widths cut to 6 layers with
                 remat, phase 8's settings: one round-kernel launch a round
                 at (8, 8, P), kernel vs plain histories at m = 4, s per
                 step and peak GB; the
                 round kernel timed at (8, 8, P) on a block of real Zamba2
                 gradients; (d) train --arch rwkv6-7b --scale gpu refused
                 (item 16.13), the reduced config's 4 rounds on the card
                 through the round kernel vs plain; (e) per_worker_grads
                 with remat torch.equal to without at Granite and Zamba2
                 reduced, and at m = 8 at H2O's, Granite's and Zamba2's
                 train depth, with the peak GB above the params of each
 11 audio_vlm    the audio and VLM families: (a) SeamlessM4T-medium at
                 full width and depth (12 encoder and 12 decoder layers,
                 1024, 16 x 16 heads of 64, 4096, 256 206): the prefill
                 step at B = 1, T = 8192 tokens and 2048 frames
                 (frame_embeddings) in bf16 and f32, kernel path vs plain
                 path under PREFILL_RTOL, 36 flash launches a prefill on
                 the dtype's route (12 encoder non-causal, 12 decoder
                 causal, 12 cross-attention non-causal with Tq > Tk); the
                 encoder made causal as a planted fault must fail the f32
                 check; in f32 a 64-token, 16-frame prefill's last logits
                 vs the decode loop with the encoder's memory (1e-3 of
                 max|logits|); serve --arch seamless-m4t-medium --scale
                 gpu; (b) launch/train.py at 1 encoder + 1 decoder layer
                 (558 279 680 leaves) with phase 8's settings: one
                 round-kernel launch a round at (8, 8, P), kernel vs plain
                 histories at m = 4, s per step, peak GB, the round
                 kernel timed on real
                 gradients; (c) InternVL2-26B at full width (48 layers,
                 6144, 48 x 8 heads of 128, 16 384, 92 553, 256 patches):
                 the bf16 prefill of 256 patches + 7936 tokens at full
                 depth (48 launches) and the f32 prefill at 8 layers,
                 kernel vs plain; serve --arch internvl2-26b --scale gpu;
                 train --scale gpu refused (item 16.13), the reduced
                 config's rounds on the card through the round kernel vs
                 plain
 12 mesh         the model mesh on 4 rank processes of the card
                 (collectives staged through the host and a file the
                 ranks map, meshctx._Arena): (a) the flash
                 kernel's q_offset at H2O's sequence-parallel shape (2048
                 queries a rank against 8192 keys, offsets 2048 r, and a
                 ragged block) on both routes: the rows of the full launch
                 bit for bit, its plain twins at ATTN_TOL, offset 0 the
                 launch without it; timed per rank beside the plain
                 version and SDPA with the offset's bias; (b) H2O-Danube3-
                 4B's bf16 prefill at full width and 8 layers (B = 1, T =
                 8192) on a (1, 4) mesh, each rank's 8 flash launches
                 counted by route,
                 the gathered hidden states within PREFILL_RTOL of the
                 single-process kernel prefill, f32 at 4 layers; (c)
                 Granite-3.0-1B-A400M's bf16 prefill at full width and 8
                 layers, B = 2, on (2, 2) through SP attention and expert
                 parallelism,
                 held to each sequence's single-process prefill with its
                 expert choices replayed, the free-routing flips recorded;
                 (d) the WKV region at RWKV6-7B's heads against
                 wkv_chunked; (e) the reduced minitron-4b's and granite's
                 loss and gradients against one process; wall ms on the
                 mesh against one process, the collectives' host-staged
                 ms and share, a profiled prefill's device ms by family
 15 mesh decode  decode and the short prefill on 4 rank processes of the
                 card, every one-process reference first: (a) H2O-
                 Danube3-4B at full width and depth serves 4 x (16 + 32)
                 through serve.generate in bf16 on (2, 2) and decodes in
                 f32 on (1, 4), teacher-forced on the one process's greedy
                 tokens, every step's logits within MESH_DECODE_RTOL of
                 max|logits|; (b) the same prompts through the prefill
                 step below the sequence-parallel threshold (T = 16): 24
                 full flash launches a rank on the dtype's route, the f32
                 last-position logits within MESH_DECODE_RTOL of the mesh
                 decode loop's, a maskless kernel caught; (c) Granite,
                 RWKV6, Zamba2, SeamlessM4T and InternVL2 served on their
                 meshes (MESH_DECODE) with f32 checks; ms a decode step a
                 rank and one process's, the collectives a step, peak GB
 17 dry run      the pod dry run (launch/dryrun.py) held to the card, on
                 the host: phase 13 (a)'s and 16 (a)'s first steps traced
                 on fake cuda tensors of each rank of (2, 2), their
                 collectives by kind and group equal to the real step's,
                 their peaks within DRY_PEAK_RTOL of the rank's measured
                 one; dryrun_pair of DRY_PAIRS on (16, 16) (records and
                 trace seconds); the round and flash custom ops
                 torch.equal to their direct launches
 18 sweep        the pod sweep (sim/sweep.py) held to the card: (a) its
                 five microcells (the report wire, none / sign / int8,
                 and the staleness merge, sharded / gathered) for real
                 on (1, 4) rank processes at m = 4, d = SWEEP_MICRO_D,
                 each rank's collectives by kind and group equal to its
                 dry run's on fake cuda tensors, the aggregates the same
                 bits on every rank and equal to one process's (the
                 sharded stale cell's within RTOL / ATOL of max|y|), one
                 round-kernel launch a rank in each whole gmom consume,
                 and the wire's gather taken around the mesh caught; (b)
                 the five at production size (minitron-4b, (16, 16), rank
                 0) traced on the host, within the gate of the port's
                 record (compare_payloads, compression_wire_problems)
  7 kernel line  one JSON object, a row per kernel (the round kernel's
                 launches include phase 6 (c)'s, phase 8's, phase 9's,
                 phase 10's, phase 11's and phase 18 (a)'s; its row
                 carries the (8, 8, P) timings as train_shape (H2O),
                 granite_train_shape (Granite), zamba2_train_shape
                 (Zamba2) and seamless_train_shape (SeamlessM4T); the
                 flash row's
                 launches include phase 9's, 10's, 11's, 12's, 14's and
                 15's prefills
                 and it carries Granite's, Zamba2's, SeamlessM4T's and
                 InternVL2's shapes as granite_shape, zamba2_shape,
                 audio_enc_shape, audio_cross_shape and vlm_shape, and
                 phase 12 (a)'s offset shape as sp_offset_shape)
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.configs import linreg_paper  # noqa: E402

LINREG_PAPER = linreg_paper.CONFIG

# (m, k, d): the golden geometry; the paper's configs/linreg_paper.py with
# even and uneven k; a mid size; the wide main-path width; ResNet-50's
# parameter count (torchvision), an FL-scale server aggregation.
SHAPES = [(20, 10, 20), (50, 10, 100), (50, 11, 100), (64, 16, 4096),
          (50, 11, 8192), (50, 11, 25_557_032)]
MAIN_SHAPE = (50, 11, 8192)
RTOL, ATOL = 1e-4, 1e-5
# Weiszfeld stopping: tol=0 still stops at an exact float32 fixed point
# (squared move == 0), so "fixed32" runs up to 32 iterations; "few" runs
# exactly 3 in both versions; "early_exit" is the default tol=1e-8, cap 64.
MODES = (("fixed32", dict(tol=0.0, max_iters=32)),
         ("few", dict(tol=0.0, max_iters=3)),
         ("early_exit", {}))
REPEATS = 20
# (m, n, d, k) of the full linreg round: the reference tests' geometry;
# the paper's config (N/m = 1000 samples per worker, d=100) with k=10 and
# the uneven k=11; the wide main-path width (X is 1.64 GB); the two-pass
# route (d % 4 != 0; d past D_ONEPASS) and the one-pass route's last d;
# k = 64
LINREG_SHAPES = [(12, 16, 300, 6), (20, 16, 400, 10), (50, 1000, 100, 10),
                 (50, 1000, 100, 11), (50, 1000, 8192, 11),
                 (12, 16, 302, 6), (16, 64, 8196, 8), (16, 64, 8192, 8),
                 (64, 20, 512, 64)]
LINREG_MAIN = (50, 1000, 8192, 11)
# the timed linreg shapes: the paper's d and the main path's
LINREG_TIMED = [(50, 1000, 100, 11), LINREG_MAIN]
# (k, d) of the Weiszfeld kernels: the grid of tests/test_kernels.py,
# the wide width, ResNet-50's parameter count (Z is 1.12 GB), the loop
# benchmark of benchmarks/kernel_bench.py (32, 100 000), and k = 64
GEOMED_SHAPES = [(2, 64), (8, 1000), (16, 4096), (64, 512), (5, 777),
                 (32, 2048), (11, 8192), (11, 25_557_032), (32, 100_000),
                 (64, 1_000_000)]
# the Weiszfeld loop (geometric_median_kernel) at the wide width and at
# ResNet-50's (one launch of the register-streamed loop kernel each); at
# the reference's own benchmark of the loop, benchmarks/kernel_bench.py's
# k = 32, d = 100 000 (the loop kernel over tiles: 16 < k <= 64); and, for
# coverage with no workload behind them, the loop kernels' largest k (64)
# and a k past it (100: the step kernels) at a 1M-parameter width
GEOMED_PATH = [(11, 8192), (11, 25_557_032), (32, 100_000),
               (64, 1_000_000), (100, 1_000_000)]
GEOMED_MAIN = (11, 25_557_032)
GEOMED_TILES = (32, 100_000)
GEOMED_STEP = (100, 1_000_000)
GEOMED_LOOP_TIMED = [(11, 8192), GEOMED_MAIN, GEOMED_TILES,
                     (64, 1_000_000)]
# every kernel instance of the three GMoM libraries (ptxas names)
GMOM_INSTANCES = ("gmom_round_kernel<StackedRows>",
                  "gmom_round_kernel<SplitGradRows>", "linreg_onepass_kernel",
                  "residual_kernel", "grad_kernel", "sqdist_kernel<4>",
                  "sqdist_kernel<1>", "reweight_kernel",
                  "weiszfeld_regs_kernel", "weiszfeld_tiles_kernel")
# (HBM bytes/s, float32 non-tensor-core FLOP/s) by part, NVIDIA data sheets
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "SXM": (3.35e12, 67e12)}
# dense bf16 tensor-core FLOP/s by part (data sheets, without sparsity):
# the bound of attention, a matmul-bearing function
PEAK_BF16 = {"PCIe": 756e12, "NVL": 835e12, "SXM": 989e12}

# flash attention (B, Tq, Tk, H, KV, hd, causal, window): the grid of
# tests/test_kernels.py; a ragged T at H2O's head width; non-causal ragged
# Tk; H2O-Danube3-4B's heads (32/8 of 120, window 4096) around and past
# the window; Minitron-4B's (24/8 of 128, causal); Granite-3.0-1B-A400M's
# prefill (16/8 of 64, causal: ATTN_GRANITE); Zamba2-2.7B's shared block
# (32/32 of 80, causal: ATTN_ZAMBA; the tensor-core route's 128-column
# instance, 48 columns padded); a ragged cross-attention case (Tq > Tk,
# non-causal), SeamlessM4T's encoder and cross-attention and InternVL2's
# prefill (phase 11's)
ATTN_GRID = [(2, 64, 64, 4, 2, 32, True, None),
             (1, 128, 128, 8, 8, 64, True, None),
             (2, 100, 100, 4, 1, 32, True, None),
             (1, 256, 256, 4, 2, 64, True, 64),
             (2, 64, 64, 4, 4, 32, False, None),
             (1, 96, 96, 6, 2, 16, True, 32),
             (2, 333, 333, 8, 2, 120, True, 100),
             (1, 20, 20, 2, 1, 16, False, None),
             (1, 70, 150, 4, 1, 256, False, 50),
             (1, 1000, 1000, 32, 8, 120, True, 4096),
             (2, 16, 16, 32, 8, 120, True, 4096),
             (1, 4097, 4097, 32, 8, 120, True, 4096),
             (1, 8192, 8192, 32, 8, 120, True, 4096),
             (1, 8192, 8192, 24, 8, 128, True, None),
             (1, 8192, 8192, 16, 8, 64, True, None),
             (1, 8192, 8192, 32, 32, 80, True, None),
             (2, 333, 84, 4, 2, 64, False, None),
             (1, 2048, 2048, 16, 16, 64, False, None),
             (1, 8192, 2048, 16, 16, 64, False, None),
             (1, 8192, 8192, 48, 8, 128, True, None)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 against the plain version in f32 on the same inputs, elementwise:
#   |d| <= 2**-8 |y| + 2**-8 (P|V|) + 2 ATTN_TOL["float32"]
# 2**-8 |y| is the output's rounding; the tensor-core route rounds P to
# bf16 before P V (as the plain bf16 path does), a relative error of at
# most 2**-9 a term, so its sum moves by at most 2**-9 P|V| (2**-8 leaves
# room for l being summed from the unrounded p); P|V| is the plain version
# in f32 with |v| in place of v; then the f32 tolerance.  Unlike 3e-2, the
# bound stays tight past the window at T = 8192, where the outputs' RMS is
# about sqrt(e / 4096) = 0.026 for random inputs (P|V| is about 0.8 there)
BF16_BOUND = 2.0 ** -8
# the timed shapes: H2O's prefill at T = 8192 (the serve path's), Minitron's
# at 8192, one H2O call at prefill_32k's sequence length, Granite's
# prefill at 8192 (phase 9's serve path) and Zamba2's (phase 10's), and
# phase 11's: SeamlessM4T's encoder and cross-attention, InternVL2's
# prefill
ATTN_MAIN = (1, 8192, 8192, 32, 8, 120, True, 4096)
ATTN_GRANITE = (1, 8192, 8192, 16, 8, 64, True, None)
ATTN_ZAMBA = (1, 8192, 8192, 32, 32, 80, True, None)
# SeamlessM4T's encoder (bidirectional) and cross-attention (Tq > Tk) and
# InternVL2's prefill: phase 11's shapes
ATTN_AUDIO_ENC = (1, 2048, 2048, 16, 16, 64, False, None)
ATTN_AUDIO_CROSS = (1, 8192, 2048, 16, 16, 64, False, None)
ATTN_VLM = (1, 8192, 8192, 48, 8, 128, True, None)
ATTN_TIMED = [ATTN_MAIN, (1, 8192, 8192, 24, 8, 128, True, None),
              (1, 32768, 32768, 32, 8, 120, True, 4096), ATTN_GRANITE,
              ATTN_ZAMBA, ATTN_AUDIO_ENC, ATTN_AUDIO_CROSS, ATTN_VLM]
# the serve path: H2O-Danube3-4B at full width; prefill_32k (B=32,
# T=32 768) cut to B=1, T=8192 for the whole model
SERVE_ARCH = "h2o-danube-3-4b"
PREFILL_T = 8192
PREFILL_CUTS = ["prefill_32k's B=32, T=32768 cut to B=1, T=8192 for the "
                "whole model (the chip check's time)",
                "one flash_attention call timed at T=32768 (phase 5)"]
# kernel path vs plain path after 24 layers, against max|h|: f32 holds the
# algorithm (1e-3).  In bf16 the plain path rounds scores and probabilities
# to bf16 where the kernel keeps f32, and the difference rides the residual
# stream through 24 layers: the first full-width run on an H100 measured
# 0.1875 at max|h| 5.625 (3.3e-2, six bf16 ulps at |h| in [4, 8)); the
# bound, 5e-2 (nine such ulps), leaves room for that and fails a kernel
# that is wrong: the kernel path without the window moved h by 0.244 of
# max|h| in either type (the planted fault, asserted in serve_path)
PREFILL_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}

# The main path at full width (gmom under sign_flip/rotating): the paper's
# configs/linreg_paper.py (d=100, N=50 000, m=50, q=4) with k=10 and its
# rounds, and the same data size at d=8192 with the paper's uneven k=11
# (X is 1.64 GB).
FULL_WIDTH = {
    "paper": dict(dim=LINREG_PAPER.dim,
                  total_samples=LINREG_PAPER.total_samples,
                  num_workers=LINREG_PAPER.num_workers,
                  num_byzantine=LINREG_PAPER.num_byzantine, num_batches=10,
                  rounds=LINREG_PAPER.rounds),
    "wide": dict(dim=8192, total_samples=LINREG_PAPER.total_samples,
                 num_workers=LINREG_PAPER.num_workers,
                 num_byzantine=LINREG_PAPER.num_byzantine, num_batches=11,
                 rounds=30),
}

# Phase 6, shard-local aggregation (ShardSpec, make_sharded_aggregate,
# make_shardmap_aggregate): (a) the virtual mode at the wide width, S = 8
# shards, the paper's uneven k = 11 and k = 10, on {"w": (50, 8192), "s":
# (50,)}; (b) the model axis on 4 ranks at ResNet-50's parameter count
# (the stacked f32 gradient is 5.11 GB, 1.28 GB a rank) for one rule of
# each kind; (c) the data axis on 8 ranks at the reference test's
# geometry (m = 8, k = 4) and d = 8192.  Inputs: N(1, 1) rows, the first
# SHARD_Q scaled by -10.
SHARD_S = 8
SHARD_VIRTUAL = [(50, 11), (50, 10)]
SHARD_VIRTUAL_D = 8192
SHARD_Q = 4
SHARD_SEED = 17
SHARD_MODEL = (50, 11, 25_557_032, 4)       # m, k, d, ranks
SHARD_MODEL_RULES = [("gmom", "none"), ("krum", "none"),
                     ("norm_filter_gmom", "none"), ("coord_median", "none"),
                     ("int8_gmom", "int8_stochastic")]
SHARD_DATA = (8, 4, 8192)                   # m = ranks, k, d
# bf16 "w" against the unsharded reference path: the pytree Weiszfeld
# rounds its weights to bf16, so an ulp of summation order in an f32
# distance can flip a weight's rounding and move y by a bf16 step of
# max|z|; four bf16 steps of max|y| (tests/test_torch_shard_aggregation.py
# measured up to 1.6 against the JAX package)
BF16_STEPS = 2.0 ** -6

# Phase 8, Byzantine-robust LM training (launch/train.py, worker mode):
# H2O-Danube3-4B at its published widths (arXiv:2401.16818;
# configs/h2o_danube3_4b.py) cut to 2 layers (train.gpu_train_layers), bf16,
# remat on (the config's: blocks.maybe_remat batches under vmap of grad);
# m = 8 workers of 2 sequences of 512 tokens, q = 2, gmom under sign_flip
# with the rotating schedule, AdamW 1e-3, 4 steps: one round-kernel
# launch a round at (m, k, d) = (8, 8, P), P = 555.4 M.  The plain round
# (round_aggregate_ref) holds four (k, P) f32 blocks at once; at k = 8
# that is 71 GB, which with the params, moments and reports does not fit
# an 80 GB card, so the kernel-vs-plain histories run at the reference
# driver test's geometry, m = 4, q = 1, k = 4 (both paths).  (c) the
# group-mode step at the same config with remat on (plain autograd):
# k = 4 groups of 4 sequences in 2 microbatches, q = 1, 3 steps.  (d) the
# reference's tests/test_system.py::test_lm_training_robustness_end_to_end
# at its own setting (minitron-4b reduced, m = 8, q = 2, k = 8, 8 steps).
TRAIN_ARCH = "h2o-danube-3-4b"
TRAIN_STEPS = 4
TRAIN_SEQ = 512
TRAIN_MAIN = {"workers": 8, "byzantine": 2, "batch": 16}
TRAIN_COMPARED = {"workers": 4, "byzantine": 1, "batch": 8}
TRAIN_CUTS = ["24 layers cut to 2 (launch/train.py gpu_train_layers)",
              "seq_len 512, 2 sequences a worker",
              "kernel vs plain histories at m=4, q=1, k=4 (the plain "
              "round does not fit at k=8)"]
TRAIN_GROUP = {"k": 4, "q": 1, "batch": 16, "microbatches": 2, "steps": 3}
HEADLINE = {"arch": "minitron-4b", "m": 8, "q": 2, "k": 8, "steps": 8,
            "seq_len": 32, "batch": 16}
# Phase 9, the MoE family: Granite-3.0-1B-A400M
# (hf:ibm-granite/granite-3.0-1b-a400m-base; configs/granite_moe_1b.py),
# (a) served at full width and depth (24 layers, 1024 wide, 16/8 heads of
# 64, 32 experts of 512, top-8, vocab 49 155) with phase 4b's prefill and
# serve settings; (b) trained with phase 8's settings at its published
# widths cut to 8 layers (launch/train.py gpu_train_layers: P = 528.8 M);
# (c) the group-mode step with remat at phase 8 (c)'s settings; (d)
# Kimi-K2's router and dispatch (arXiv:2501.kimi2; configs/kimi_k2_1t.py:
# 384 experts, top-8, d_model 7168) on KIMI_TOKENS tokens of a random
# float32 router, without the experts (one layer's are 16.9 G params).
MOE_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_CUTS = ["24 layers cut to 8 (launch/train.py gpu_train_layers)",
                  "seq_len 512, 2 sequences a worker",
                  "kernel vs plain histories at m=4, q=1, k=4, as phase 8"]
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_TOKENS = 8192
# Phase 10, the recurrent families: (a) RWKV6-7B (arXiv:2404.05892;
# configs/rwkv6_7b.py) at full width and depth (32 layers, 4096 wide,
# heads of 64, d_ff 14 336, vocab 65 536), bf16, prefill at B = 1, T =
# PREFILL_T and serve with phase 4b's settings; in f32 the recurrence at
# one layer's shape (chunked vs token by token, WKV_RTOL of max|y|) and a
# RWKV_DECODE_T-token prefill against as many decode steps, at
# RWKV_DECODE_LAYERS layers (the decode loop's 512 steps at full depth
# took 27 s of the check's time); (b)
# Zamba2-2.7B (arXiv:2411.15242; configs/zamba2_2p7b.py) at full width and
# depth (54 Mamba2 blocks of state 64 and heads of 64, 9 applications of
# one shared block of 32 x 32 heads of 80 and d_ff 10 240, vocab 32 000),
# the prefill at B = 1, T = PREFILL_T in bf16 and f32, kernel path vs
# plain path as phase 4b; (c) Zamba2 trained with phase 8's settings at
# launch/train.py's depth (6 layers, one group: P = 507.8 M); (d) RWKV6's
# card path: --scale gpu refused (one layer reckons 83.8 GB), the reduced
# config's rounds on the card (RWKV_TRAIN); (e) remat under vmap of grad.
RWKV_ARCH = "rwkv6-7b"
ZAMBA_ARCH = "zamba2-2.7b"
RWKV_DECODE_T = 512
RWKV_DECODE_LAYERS = 8
# wkv_chunked vs wkv_scan (float32): the chunk's decays are exps of
# differences of cumulative log sums, the scan's products of w; they agree
# to float32 rounding over a chunk's 64 terms
WKV_RTOL = 1e-4
# the card vs the CPU on the same reduced inputs (float32): matmuls summed
# in other orders over 2 layers
CARD_VS_CPU_RTOL = 1e-5
ZAMBA_TRAIN_CUTS = ["54 layers cut to 6, one group of the shared block "
                    "(launch/train.py gpu_train_layers)",
                    "seq_len 512, 2 sequences a worker",
                    "kernel vs plain histories at m=4, q=1, k=4, as phase 8"]
RWKV_TRAIN = {"m": 8, "q": 2, "k": 8, "steps": 4, "batch": 16,
              "seq_len": 128}
# a near tie of the router: the two swapped experts' probabilities within
# this many float32 ulps (top-k on f32 router products that cuBLAS and the
# CPU's BLAS sum in other orders)
TIE_ULPS = 4
# Granite's free-routing prefill: at the earliest layer where the kernel
# path's experts leave the plain path's, every flipped token's margin is
# held within this many times the replayed run's router probability error
# there (a flip needs a margin of at most twice it)
FLIP_MARGIN_FACTOR = 4.0

# Phase 11, the audio and VLM families: (a) SeamlessM4T-medium
# (arXiv:2308.11596; configs/seamless_m4t_medium.py) at full width and
# depth (12 encoder and 12 decoder layers, 1024 wide, 16 x 16 heads of 64,
# d_ff 4096, vocab 256 206): the prefill at B = 1, T = PREFILL_T tokens and
# PREFILL_T // 4 = 2048 frames from frame_embeddings, in bf16 and f32,
# kernel path vs plain path; 36 flash launches a prefill (12 encoder
# non-causal 2048 x 2048, 12 decoder causal 8192 x 8192, 12 cross non-causal
# 8192 x 2048); the encoder made causal as the planted fault; in f32 a
# short prefill (AUDIO_DECODE tokens and frames) against the decode loop
# with the encoder's memory; serve --arch seamless-m4t-medium --scale gpu;
# (b) trained at launch/train.py's depth (1 encoder + 1 decoder layer:
# 558 279 680 leaves) with phase 8's settings; (c) InternVL2-26B
# (arXiv:2404.16821; configs/internvl2_26b.py) at full width and depth (48
# layers, 6144 wide, 48 x 8 heads of 128, d_ff 16 384, vocab 92 553, 256
# patches): the bf16 prefill at B = 1, 256 patches + 7936 tokens, kernel vs
# plain (48 launches), f32 kernel vs plain at VLM_F32_LAYERS of 48 layers
# (17.0 GB; the whole model in f32 is 79.4 GB), serve --arch internvl2-26b
# --scale gpu, train --scale gpu refused (item 16.13) and the reduced
# config's rounds on the card.
AUDIO_ARCH = "seamless-m4t-medium"
VLM_ARCH = "internvl2-26b"
AUDIO_DECODE = (64, 16)             # tokens, frames
VLM_F32_LAYERS = 8
VLM_F32_CUTS = ["48 layers cut to 8 in f32 (79.4 GB of f32 weights at 48)"]
AUDIO_TRAIN_CUTS = ["12 encoder and 12 decoder layers cut to 1 + 1 "
                    "(launch/train.py gpu_train_layers; the reference's "
                    "param_count reckons 2 + 2 at 66.6 GB)",
                    "seq_len 512 (128 frames), 2 sequences a worker",
                    "kernel vs plain histories at m=4, q=1, k=4, as phase 8"]

FAILURES: list[str] = []


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t": elapsed()}
    print(json.dumps(obj), flush=True)


def elapsed() -> float:
    """Seconds since the script started (CHIP_SMOKE_T0, which the rank
    processes inherit)."""
    return round(time.time() - float(os.environ.get("CHIP_SMOKE_T0",
                                                    time.time())), 3)


def mark(tag: str) -> None:
    """On rank 0 of a mesh phase: the time a part starts, on standard
    error (where the part's time goes inside the ranks)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({"rank_mark": tag, "t": elapsed()}),
              file=sys.stderr, flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
    return ok


def peaks(name: str):
    for part in ("PCIe", "NVL"):
        if part in name:
            return PEAKS[part]
    return PEAKS["SXM"]


def spills(summary: dict, match: str = "") -> dict:
    """{kernel: (spill store bytes, spill load bytes)} of a ptxas
    summary's kernels whose name holds ``match``."""
    out = {}
    for fn, text in summary.items():
        if match in fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          text)
            out[fn] = (int(m.group(1)), int(m.group(2))) if m else None
    return out


def ptxas_summary(log: str) -> dict:
    """{kernel<template argument>: "registers, spill bytes"} from ``nvcc
    -Xptxas -v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d([a-z]+(?:_[a-z]+)*"
                      r"_kernel)(?:ILi(\d+)E|INS_\d+([A-Z]\w*?)E)?", line)
        if m:
            arg = m.group(2) or m.group(3)
            fn = m.group(1) + (f"<{arg}>" if arg else "")
        elif fn and "spill" in line:
            out[fn] = line.split(":")[-1].strip() if ":" in line \
                else line.strip()
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[fn] = f"{regs} registers; {out.get(fn, '')}"
    return out


def compare(y, y_ref):
    """(max abs error, within RTOL/ATOL of max|y_ref|, max|y_ref|)."""
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    return err, err <= ATOL + RTOL * scale, scale


def timed(fn, repeats=REPEATS, warmup=3):
    """Median ms of ``repeats`` calls after ``warmup`` calls (CUDA
    events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernel_counts(dev, round_shapes=SHAPES,
                         linreg_shapes=LINREG_TIMED,
                         geomed_shapes=GEOMED_LOOP_TIMED):
    """{("round", (m, k, d)) | ("linreg", (m, n, d, k)) | ("sqdist", (k,
    d)) | ("loop", (k, d)): (device events, device ms, kernel names)} of
    one call of each (the loop: ``geometric_median_kernel``, unit
    weights): every kernel, copy and
    fill the call puts on the card, in a torch.profiler session of its own
    around the call, after a warm-up call.  The session records CPU
    activity too: a CUDA-only session around one short kernel can close
    before the kernel's record arrives and come back empty (PERF.md,
    Findings)."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.geomed import geomed, ops
    from repro_torch.kernels.geomed import round as rk
    gen = torch.Generator(device=dev)

    def sqdist_call(k, d):
        z, y, _ = geomed_inputs(k, d, 11, dev)
        return lambda: geomed.sqdist(z, y)

    def loop_call(k, d):
        z = geomed_inputs(k, d, 5 * k + d % 997, dev)[0]
        return lambda: ops.geometric_median_kernel(z)

    def round_call(m, k, d):
        gen.manual_seed(m * 7 + k)
        g = torch.randn((m, d), generator=gen, device=dev) + 1.0
        return lambda: rk.round_aggregate_kernel(g, make_grouping(m, k))

    def linreg_call(m, n, d, k):
        x, t, theta = linreg_inputs(m, n, d, 3, dev)
        return lambda: rk.linreg_round_kernel(x, t, theta,
                                              make_grouping(m, k))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for key, make in ([(("round", shape), round_call)
                       for shape in round_shapes]
                      + [(("linreg", shape), linreg_call)
                         for shape in linreg_shapes]
                      + [((name, shape), make)
                         for name, make in (("sqdist", sqdist_call),
                                            ("loop", loop_call))
                         for shape in geomed_shapes]):
        call = make(*key[1])
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        out[key] = (len(events),
                    sum(ev.time_range.elapsed_us() for ev in events) / 1e3,
                    sorted({re.sub(r"^.*?(\w+_kernel)\b.*$", r"\1", ev.name)
                            for ev in events}))
        del call
        torch.cuda.empty_cache()
    return out


def host_ms(fn):
    """Median host ms of REPEATS calls of ``fn`` on an idle card: what the
    wrapper costs to enqueue (allocations, ctypes, launch), no sync
    inside."""
    import torch
    times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(nbytes, ops, hbm, flops):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    operations / float32 rate."""
    by_bytes = nbytes / hbm >= ops / flops
    return (max(nbytes / hbm, ops / flops) * 1e3,
            "bytes" if by_bytes else "operations")


def linreg_inputs(m, n, d, seed, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, n, d), generator=gen, device=dev)
    t = torch.randn((m, n), generator=gen, device=dev)
    theta = torch.randn((d,), generator=gen, device=dev)
    return x, t, theta


def geomed_inputs(k, d, seed, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((k, d), generator=gen, device=dev) + 1.0
    y = torch.randn((d,), generator=gen, device=dev)
    w = torch.rand((k,), generator=gen, device=dev) + 0.1
    return z, y, w


def stops_on_its_test(iterate, iters, cap, tol):
    """A round kernel's device-side early exit, replayed from outside: it
    stops after the first iteration whose squared move is <= tol^2, or at
    the cap.  So the move of every iteration before ``iters`` must be >
    tol^2, and, below the cap, the move of iteration ``iters`` <= tol^2.
    ``iterate(i)`` is the kernel's output at ``max_iters=i``, the loop's
    i-th iterate bit for bit.  Moves are summed in float64 and held to
    tol^2 within a relative 1e-4 (the kernel sums them in float32 in
    another order)."""
    if not 1 <= iters <= cap:
        return False
    tol2 = float(tol) ** 2
    prev = iterate(0).double()
    for i in range(1, iters + 1 if iters < cap else iters):
        cur = iterate(i).double()
        move = float(((cur - prev) ** 2).sum())
        if i < iters and not move > tol2 * (1 - 1e-4):
            return False                  # it should have stopped at i
        if i == iters and not move <= tol2 * (1 + 1e-4):
            return False                  # it stopped too soon
        prev = cur
    return True


def moved_route(before):
    """The linreg kernel's launches by route since ``before``."""
    from repro_torch.kernels.geomed import round as rk
    return {r: n - before[r]
            for r, n in rk.linreg_round_kernel.route_launches.items()}


def linreg_parity(dev, shapes=LINREG_SHAPES, main_shape=LINREG_MAIN):
    """The linreg round kernel vs ``linreg_round_fused`` in every mode ->
    {shape: worst max_abs_err}."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.geomed import round as rk
    worst = {}
    for m, n, d, k in shapes:
        route = rk.linreg_route(d)
        x, t, theta = linreg_inputs(m, n, d, m * 7 + k, dev)
        cases = [("contiguous", 3.0)]
        if (m, n, d, k) == main_shape:
            cases = [(sc, tr) for sc in ("contiguous", "strided", "seeded")
                     for tr in (None, 1.0, 3.0)]
        worst[(m, n, d, k)] = 0.0
        for scheme, trim in cases:
            grouping = make_grouping(m, k, scheme=scheme)
            for label, kw in MODES:
                kw = dict(kw, trim_multiplier=trim)
                cap, tol = kw.get("max_iters", 64), kw.get("tol", 1e-8)
                before = dict(rk.linreg_round_kernel.route_launches)
                y1, it1 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
                y2, it2 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
                moved = moved_route(before)
                yp, itp = rk.linreg_round_fused(x, t, theta, grouping, **kw)
                torch.cuda.synchronize(dev)
                err, ok, scale = compare(y1, yp)
                bitwise = bool(torch.equal(y1, y2)) and int(it1) == int(it2)
                # exact counts only where neither can stop early: in the
                # other modes one summation order may settle into a 1-ulp
                # limit cycle (runs to the cap) while the other reaches an
                # exact fixed point, in either direction (PERF.md,
                # Findings); there the kernel's own stop is replayed
                stop_ok = stops_on_its_test(
                    lambda i: rk.linreg_round_kernel(
                        x, t, theta, grouping, **dict(kw, max_iters=i))[0],
                    int(it1), cap, tol)
                iters_ok = stop_ok and (int(it1) == int(itp)
                                        if label == "few"
                                        else 1 <= int(itp) <= cap)
                worst[(m, n, d, k)] = max(worst[(m, n, d, k)], err)
                tag = f"linreg {(m, n, d, k)} {scheme} trim={trim} {label}"
                check(moved == {r: 2 * (r == route) for r in rk.ROUTES},
                      f"{tag}: launches by route {moved}, want 2 on "
                      f"{route}")
                check(ok, f"parity {tag}: max_abs_err {err} "
                          f"(max|y| {scale})")
                check(bitwise, f"determinism {tag}")
                check(iters_ok, f"iterations {tag}: kernel {int(it1)} "
                                f"plain {int(itp)} (cap {cap})")
                emit({"phase": "parity_linreg", "shape": [m, n, d, k],
                      "route": route, "scheme": scheme, "trim": trim,
                      "mode": label,
                      "max_abs_err": err, "max_abs_y": scale, "ok": ok,
                      "bitwise_repeat": bitwise, "iters_kernel": int(it1),
                      "iters_plain": int(itp), "stop_ok": stop_ok,
                      "iters_ok": iters_ok})
        del x, t, theta
        torch.cuda.empty_cache()
    return worst


def geomed_parity(dev, shapes=GEOMED_SHAPES, twin_max=10 ** 6):
    """sqdist, reweight, the step and the loop kernel (``weiszfeld_loop``,
    max_iters=3 and the default stop) vs their plain versions; sqdist and
    the loop also vs their twins on the wrapper's plan (bit for bit, up to
    k d = ``twin_max``: the twins run on the CPU) -> {(kernel, shape):
    max_abs_err}."""
    import torch
    from repro_torch.kernels.geomed import geomed, ops, ref
    errs = {}
    for k, d in shapes:
        z, y, w = geomed_inputs(k, d, k * 31 + d % 1000, dev)
        cases = (("sqdist", lambda: geomed.sqdist(z, y),
                  lambda: ref.weiszfeld_distances_ref(z, y)),
                 ("reweight", lambda: geomed.reweight(z, w),
                  lambda: ref.weiszfeld_reweight_ref(z, w)),
                 ("weiszfeld_step", lambda: geomed.weiszfeld_step(z, y, w),
                  lambda: ref.weiszfeld_step_ref(z, y, w)))
        line = {"phase": "parity_geomed", "shape": [k, d]}
        for name, kernel, plain in cases:
            a, b, want = kernel(), kernel(), plain()
            torch.cuda.synchronize(dev)
            err, ok, scale = compare(a, want)
            bitwise = bool(torch.equal(a, b))
            check(ok, f"parity {name} {(k, d)}: max_abs_err {err} "
                      f"(max|y| {scale})")
            check(bitwise, f"determinism {name} {(k, d)}")
            errs[(name, (k, d))] = err
            line[name] = {"max_abs_err": err, "max_abs_y": scale, "ok": ok,
                          "bitwise_repeat": bitwise}
            if name == "sqdist" and k * d <= twin_max:
                nb, vec = geomed.sqdist_plan(z, y)
                want_bits = ref.weiszfeld_distances_blocked(
                    z, y, n_blocks=nb, vec=vec)
                twin = bool(torch.equal(a.cpu(), want_bits))
                check(twin, f"sqdist {(k, d)}: not its twin's bits")
                line[name].update(twin_equal=twin, n_blocks=nb, vec=vec)
            del a, b, want
        w[0] = 0.0       # a zero weight: that point drops out of the sums
        for mode, kw in (("few", dict(max_iters=3, tol=0.0)),
                         ("early_exit", {})):
            (y1, it1), (y2, it2) = (geomed.weiszfeld_loop(z, w, **kw),
                                    geomed.weiszfeld_loop(z, w, **kw))
            yp, itp = ops._geometric_median(z, w, plain=True, **kw)
            torch.cuda.synchronize(dev)
            err, ok, scale = compare(y1, yp)
            bitwise = bool(torch.equal(y1, y2)) and int(it1) == int(it2)
            tag = f"weiszfeld_loop {(k, d)} {mode}"
            check(ok, f"parity {tag}: max_abs_err {err} (max|y| {scale})")
            check(bitwise, f"determinism {tag}")
            check(mode != "few" or int(it1) == int(itp) == 3,
                  f"iterations {tag}: kernel {int(it1)} plain {int(itp)}")
            res = {"max_abs_err": err, "max_abs_y": scale, "ok": ok,
                   "bitwise_repeat": bitwise, "iters_kernel": int(it1),
                   "iters_plain": int(itp)}
            if k * d <= twin_max:
                vec = geomed.vector_width(d, z)
                nb = geomed.loop_blocks(k, d, vec, dev)
                yt, itt = ops.geometric_median_blocked(z, w, n_blocks=nb,
                                                       vec=vec, **kw)
                twin = bool(torch.equal(y1.cpu(), yt)) and int(it1) == int(itt)
                check(twin, f"{tag}: not its twin's bits or count")
                res.update(twin_equal=twin, n_blocks=nb, vec=vec,
                           kernel=geomed.loop_kernel(k))
            line[f"weiszfeld_loop_{mode}"] = res
            errs[("weiszfeld_loop", (k, d))] = max(
                err, errs.get(("weiszfeld_loop", (k, d)), 0.0))
        emit(line)
        del z, y, w
        torch.cuda.empty_cache()
    return errs


def linreg_path(dev, configs=None):
    """The slice's path at full width: failure-free Algorithm 2 through
    ``linreg_round_kernel`` (``engine.run_failure_free``), held against
    the engine's failure-free run (per-worker grads + the round kernel).
    -> (linreg kernel launches, launches by route)."""
    import torch
    from repro_torch import random as prng
    from repro_torch.data import regression
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario
    total, by_route = 0, dict.fromkeys(rk.ROUTES, 0)
    for cname, cfg in (configs or FULL_WIDTH).items():
        sc = Scenario(name=f"linreg-{cname}/gmom/none/static", attack="none",
                      schedule="static", **cfg)
        ds = regression.generate(
            prng.PRNGKey(sc.seed, device=dev), dim=sc.dim,
            total_samples=sc.total_samples, num_workers=sc.num_workers,
            noise_std=sc.noise_std, device=dev)
        engine_trace = engine.run_scenario(sc, round_backend="auto",
                                           device=dev, dataset=ds)

        def drive(plain):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            trace = engine.run_failure_free(sc, device=dev, dataset=ds,
                                            plain=plain)
            return trace, (time.perf_counter() - t0) * 1e3 / sc.rounds

        rk.reset_linreg_launches()
        kern, ms_kernel = drive(plain=False)
        n_launch = rk.linreg_round_kernel.launches
        routes = dict(rk.linreg_round_kernel.route_launches)
        plain, ms_plain = drive(plain=True)
        total += n_launch
        for r, v in routes.items():
            by_route[r] += v
        want = {key: engine_trace[key] for key in kern}
        vs_engine = goldens.compare_traces(kern, want)
        vs_plain = goldens.compare_traces(kern, plain)
        below = (kern["final_est_error"] < sc.paper_floor
                 and engine_trace["final_est_error"] < sc.paper_floor)
        check(not vs_engine, f"linreg {cname}: kernel path vs engine "
                             f"{vs_engine[:3]}")
        check(not vs_plain, f"linreg {cname}: kernel vs plain path "
                            f"{vs_plain[:3]}")
        check(below, f"linreg {cname}: final est_error "
                     f"{kern['final_est_error']} (engine "
                     f"{engine_trace['final_est_error']}) >= paper_floor "
                     f"{sc.paper_floor}")
        check(n_launch == sc.rounds, f"linreg {cname}: {n_launch} kernel "
                                     f"launches for {sc.rounds} rounds")
        check(routes == {r: sc.rounds * (r == "one_pass") for r in routes},
              f"linreg {cname}: launches by route {routes}, want "
              f"{sc.rounds} on one_pass")
        emit({"phase": "linreg_path", "config": cname, "dim": sc.dim,
              "total_samples": sc.total_samples,
              "num_workers": sc.num_workers,
              "num_batches": engine_trace["num_batches"],
              "rounds": sc.rounds,
              "final_est_error": kern["final_est_error"],
              "engine_final_est_error": engine_trace["final_est_error"],
              "paper_floor": sc.paper_floor, "kernel_launches": n_launch,
              "launches_by_route": routes,
              "kernel_vs_engine_ok": not vs_engine,
              "kernel_vs_plain_ok": not vs_plain,
              "ms_per_round": {"linreg_round_kernel": ms_kernel,
                               "linreg_round_fused": ms_plain}})
        del ds
        torch.cuda.empty_cache()
    return total, by_route


def _strip(trace, *keys):
    return {k: v for k, v in trace.items() if k not in keys}


def wire_and_stale_paths(dev, configs=None):
    """The staleness buffer and the report wire at full width, each through
    the engine on the card, on the data of the configuration generated
    once: (a) gmom under sign_flip/rotating with straggler_rotating at
    tau = 2, kernel path vs plain path, one round-kernel launch a round;
    (b) sign_sgd_majority on the packed sign wire vs the same rule on raw
    reports, byte-identical traces once the trace's "compression" key (the
    one field that names the wire) is set aside; (c) int8_gmom on the
    int8_stochastic wire, kernel path vs plain path, and one round's int8
    payload on the card bit-equal to the CPU's for the same inputs and
    key.  Host ms per round with a synchronize, beside the synchronous
    gmom round of the same width.  -> round-kernel launches of (a) and
    (c)."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.core import compression, per_worker_grads
    from repro_torch.core.train_state import advance
    from repro_torch.data import regression
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario
    total = 0
    for cname, cfg in (configs or FULL_WIDTH).items():
        base = Scenario(name=f"linreg-{cname}/gmom/sign_flip/rotating",
                        **cfg)
        ds = regression.generate(
            prng.PRNGKey(base.seed, device=dev), dim=base.dim,
            total_samples=base.total_samples, num_workers=base.num_workers,
            noise_std=base.noise_std, device=dev)

        def drive(sc, backend="auto"):
            """-> (trace, host ms per round, round-kernel launches)."""
            run, state, batches, rc, _ = engine._build_run(
                sc, round_backend=backend, device=dev, dataset=ds)
            torch.cuda.synchronize(dev)
            rk.round_aggregate_kernel.launches = 0
            t0 = time.perf_counter()
            state, _ = advance(run, state, batches, num_rounds=sc.rounds)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3 / sc.rounds
            n = rk.round_aggregate_kernel.launches
            return engine._trace(sc, rc, sc.rounds, state.history), ms, n

        sync, sync_ms, _ = drive(base)
        line = {"phase": "wire_and_stale", "config": cname, "dim": base.dim,
                "rounds": base.rounds, "paper_floor": base.paper_floor,
                "host_ms_per_round": {"gmom_sync": sync_ms}}

        # (a) bounded staleness
        stale = dataclasses.replace(base, name=base.name + "/stale",
                                    arrival="straggler_rotating",
                                    staleness_bound=2)
        kern, ms, n = drive(stale)
        plain, plain_ms, _ = drive(stale, "fused_interpret")
        bad = goldens.compare_traces(kern, plain)
        check(not bad, f"stale {cname}: kernel vs plain path {bad[:3]}")
        check(n == stale.rounds, f"stale {cname}: {n} round-kernel "
                                 f"launches for {stale.rounds} rounds")
        check(sum(kern["stale_count"]) > 0,
              f"stale {cname}: no round had a stale worker")
        total += n
        line["stale"] = {"final_est_error": kern["final_est_error"],
                         "stale_count_sum": sum(kern["stale_count"]),
                         "kernel_launches": n, "kernel_vs_plain_ok": not bad}
        line["host_ms_per_round"].update(stale_kernel=ms,
                                         stale_plain=plain_ms)

        # (b) the packed sign wire against raw reports
        sign = dataclasses.replace(base, name=f"linreg-{cname}/sign_majority",
                                   aggregator="sign_sgd_majority",
                                   schedule="static", compression="sign",
                                   step_size=0.05)
        packed, ms, _ = drive(sign)
        raw, raw_ms, _ = drive(dataclasses.replace(sign, compression="none"))
        same = (goldens.trace_bytes(_strip(packed, "compression"))
                == goldens.trace_bytes(raw))
        check(same, f"sign {cname}: packed-wire trace differs from the raw "
                    "vote's")
        check(all(map(math.isfinite, packed["est_error"])),
              f"sign {cname}: non-finite est_error")
        line["sign"] = {"final_est_error": packed["final_est_error"],
                        "packed_equals_raw_bytes": same}
        line["host_ms_per_round"].update(sign_packed=ms, sign_raw=raw_ms)

        # (c) the int8 wire
        int8 = dataclasses.replace(base, name=base.name + "/int8",
                                   aggregator="int8_gmom",
                                   compression="int8_stochastic")
        kern, ms, n = drive(int8)
        plain, plain_ms, _ = drive(int8, "fused_interpret")
        bad = goldens.compare_traces(kern, plain)
        check(not bad, f"int8 {cname}: kernel vs plain path {bad[:3]}")
        check(n == int8.rounds, f"int8 {cname}: {n} round-kernel launches "
                                f"for {int8.rounds} rounds")
        total += n
        # round 0's codec key and reports, encoded on the card and the CPU
        key = prng.fold_in(prng.fold_in(prng.fold_in(
            prng.PRNGKey(base.seed, device=dev), 999), 0), 29)
        grads, _ = per_worker_grads(
            regression.squared_loss,
            torch.zeros((base.dim,), device=dev), regression.worker_batches(ds))
        codec = compression.get_codec("int8_stochastic")
        on_card = codec.encode(grads, key=key)
        on_cpu = codec.encode(grads.cpu(), key=key.cpu())
        payload_equal = all(torch.equal(on_card[p].cpu(), on_cpu[p])
                            for p in ("q", "scale"))
        check(payload_equal, f"int8 {cname}: the card's payload differs from "
                             "the CPU's")
        line["int8"] = {"final_est_error": kern["final_est_error"],
                        "kernel_launches": n, "kernel_vs_plain_ok": not bad,
                        "payload_card_equals_cpu": payload_equal}
        line["host_ms_per_round"].update(int8_kernel=ms, int8_plain=plain_ms)
        line["final_est_error_sync"] = sync["final_est_error"]
        emit(line)
        del ds, grads
        torch.cuda.empty_cache()
    return total


def geomed_path(dev, shapes=GEOMED_PATH):
    """The Weiszfeld loop (``geometric_median_kernel``) at full width,
    each route by its k: held against ``core.geometric_median`` and the
    plain loop (exact counts at max_iters=3); on the loop kernel's route
    both stop below the cap, or both reach it, and the kernel's stop is
    replayed from its iterates.  The step kernels' route (k > 64) replays
    its own stop: there the sqdist kernel's summation order settles into a
    1-ulp cycle to the cap on about one input in four where the plain loop
    stops, and so did the older two-launch sqdist's order, on other inputs
    (``tests/step_route_stop.py``; PERF.md, open questions).  ->
    launches {"weiszfeld_loop", "sqdist", "reweight"} of the run with the
    default stop (the counts set to 0 just before it)."""
    import torch
    from repro_torch.core.geometric_median import geometric_median
    from repro_torch.kernels.geomed import geomed, ops
    points = [geomed_inputs(k, d, 5 * k + d % 997, dev)[0]
              for k, d in shapes]
    want_routes = {r: sum(ops.loop_route(k) == r for k, _ in shapes)
                   for r in ops.ROUTES}
    want_kernels = {kern: sum(ops.loop_route(k) == "device_loop"
                              and geomed.loop_kernel(k) == kern
                              for k, _ in shapes)
                    for kern in geomed.LOOP_KERNELS}
    ops.reset_launches()
    geomed.reset_loop_launches()
    geomed.sqdist.launches = geomed.reweight.launches = 0
    results = []
    for z in points:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y, it = ops._geometric_median(z)
        torch.cuda.synchronize(dev)
        results.append((y, int(it), (time.perf_counter() - t0) * 1e3))
    launches = {"weiszfeld_loop": geomed.weiszfeld_loop.launches,
                "sqdist": geomed.sqdist.launches,
                "reweight": geomed.reweight.launches,
                **{f"weiszfeld_{kern}": n for kern, n
                   in geomed.weiszfeld_loop.kernel_launches.items()}}
    routes = dict(ops.geometric_median_kernel.route_launches)
    steps = sum(it for (k, _), (_, it, _) in zip(shapes, results)
                if ops.loop_route(k) == "step_kernels")
    check(routes == want_routes
          and launches["weiszfeld_loop"] == want_routes["device_loop"]
          and geomed.weiszfeld_loop.kernel_launches == want_kernels
          and launches["sqdist"] == launches["reweight"] == steps,
          f"geometric_median_kernel: routes {routes} (want {want_routes}), "
          f"launches {launches} ({steps} steps on the step kernels)")
    for (k, d), z, (y, it, ms) in zip(shapes, points, results):
        cap = 64
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y_core = geometric_median(z)
        torch.cuda.synchronize(dev)
        ms_core = (time.perf_counter() - t0) * 1e3
        _, itp = ops._geometric_median(z, plain=True)
        _, it3 = ops._geometric_median(z, max_iters=3, tol=0.0)
        _, itp3 = ops._geometric_median(z, max_iters=3, tol=0.0, plain=True)
        err, ok, scale = compare(y, y_core)
        tag = f"geometric_median_kernel {(k, d)}"
        check(ok, f"{tag} vs core: max_abs_err {err} (max|y| {scale})")
        both = (it < cap) == (int(itp) < cap)
        if ops.loop_route(k) == "device_loop":
            check(both, f"{tag}: {it} iterations, plain {int(itp)} (cap "
                        f"{cap})")
        check(int(it3) == int(itp3) == 3,
              f"{tag}: {int(it3)} iterations at max_iters=3, plain "
              f"{int(itp3)}")
        stop_ok = stops_on_its_test(
            lambda i: ops._geometric_median(z, max_iters=i)[0], it, cap,
            1e-8)
        check(stop_ok, f"{tag}: the stop at {it} iterations")
        emit({"phase": "geomed_path", "shape": [k, d],
              "route": ops.loop_route(k),
              "loop_kernel": (geomed.loop_kernel(k)
                              if ops.loop_route(k) == "device_loop"
                              else None), "max_abs_err": err,
              "max_abs_y": scale, "ok": ok, "iters_kernel": it,
              "iters_plain": int(itp), "both_or_neither_ok": both,
              "stop_ok": stop_ok, "iters_at_3": [int(it3), int(itp3)],
              "ms": {"geometric_median_kernel": ms,
                     "core.geometric_median": ms_core}})
    emit({"phase": "geomed_path", "launches": launches,
          "launches_by_route": routes})
    del points, results
    torch.cuda.empty_cache()
    return launches


def new_kernel_timings(dev, hbm, flops, smi, counts):
    """Kernel, plain and library ms of the linreg round, the step kernels
    and the Weiszfeld loop at their main shapes -> {name: timing dict}.
    ``counts``: device kernels per call (``device_kernel_counts``)."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.geomed import geomed, ops, ref
    from repro_torch.kernels.geomed import round as rk
    out = {}
    for m, n, d, k in LINREG_TIMED:
        x, t, theta = linreg_inputs(m, n, d, 3, dev)
        grouping = make_grouping(m, k)
        th3 = theta.reshape(1, d, 1).expand(m, d, 1)
        _, it = rk.linreg_round_kernel(x, t, theta, grouping)
        iters = int(it)
        before = rk.linreg_round_kernel.launches
        rk.linreg_round_kernel(x, t, theta, grouping)
        per_call = rk.linreg_round_kernel.launches - before
        check(per_call == 1, f"linreg_round: {per_call} launches per call")
        n_dev, dev_ms, names = counts.get(("linreg", (m, n, d, k)),
                                          (None, None, None))
        check(n_dev is not None and 1 <= n_dev <= 2,
              f"linreg_round {(m, n, d, k)}: {n_dev} device kernels per "
              f"call {names}")
        kernel_ms = timed(lambda: rk.linreg_round_kernel(x, t, theta,
                                                         grouping))
        wrapper_ms = host_ms(lambda: rk.linreg_round_kernel(x, t, theta,
                                                            grouping))
        # the two-pass front on the same inputs: the design the one-pass
        # route replaced at this d
        two_pass = dict(trim_multiplier=3.0, max_iters=64, tol=1e-8,
                        eps=1e-12)
        two_pass_ms = timed(lambda: rk._linreg_launch(
            x, t, theta, grouping, "two_pass", **two_pass))
        plain_ms = timed(lambda: rk.linreg_round_fused(x, t, theta,
                                                       grouping))
        library_ms = timed(lambda: torch.bmm(
            (torch.bmm(x, th3)[..., 0] - t)[:, None, :], x))
        # the function reads X, y and theta once and writes y; the
        # two-pass design reads X twice and writes and reads the gradient
        # partials P (n_split, m, d), reported beside the bound
        n_split = rk.onepass_split(m, n, rk._sm_count(dev))
        two_split = rk.linreg_split(m, n, d)
        nbytes = 4 * (m * n * d + m * n + 2 * d)
        two_pass_bytes = nbytes + 4 * (m * n * d + 2 * two_split * m * d)
        ops_ = 4 * m * n * d + m * d + (iters + 1) * 6 * k * d
        bound_ms, bound_by = bound(nbytes, ops_, hbm, flops)
        out[("linreg_round", (m, n, d, k))] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "timing", "kernel": "linreg_round",
              "shape": [m, n, d, k], "route": rk.linreg_route(d),
              "iters": iters, "launches_per_call": per_call,
              "n_split": n_split, "device_kernels_per_call": n_dev,
              "device_kernel_names": names, "device_ms": dev_ms,
              "wrapper_host_ms": wrapper_ms, "two_pass_route_ms": two_pass_ms,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms_gradient_stage_only": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_two_pass_ms": two_pass_bytes / hbm * 1e3, "card": smi})
        del x, t, theta, th3
        torch.cuda.empty_cache()
    k, d = GEOMED_MAIN
    z, y, w = geomed_inputs(k, d, 11, dev)
    cases = (("sqdist", lambda: geomed.sqdist(z, y),
              lambda: ref.weiszfeld_distances_ref(z, y),
              lambda: torch.cdist(z, y[None]) ** 2,
              4 * (k * d + d + k), 3 * k * d, geomed.sqdist),
             ("reweight", lambda: geomed.reweight(z, w),
              lambda: ref.weiszfeld_reweight_ref(z, w),
              lambda: w @ z, 4 * (k * d + k + d), 2 * k * d,
              geomed.reweight))
    for name, kernel, plain, library, nbytes, ops_, wrapper in cases:
        before = wrapper.launches
        kernel()
        per_call = wrapper.launches - before
        check(per_call == 1, f"{name}: {per_call} launches per call")
        n_dev, dev_ms, names = counts.get((name, (k, d)), (None, None, None))
        if name == "sqdist":
            check(n_dev == 1, f"sqdist {(k, d)}: {n_dev} device kernels per "
                              f"call {names}")
        kernel_ms, plain_ms = timed(kernel), timed(plain)
        library_ms = timed(library)
        bound_ms, bound_by = bound(nbytes, ops_, hbm, flops)
        out[(name, (k, d))] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "timing", "kernel": name, "shape": [k, d],
              "launches_per_call": per_call, "device_kernels_per_call": n_dev,
              "device_kernel_names": names, "device_ms": dev_ms,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "card": smi})
    del z, y, w
    torch.cuda.empty_cache()
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for k, d in GEOMED_LOOP_TIMED:
        z = geomed_inputs(k, d, 5 * k + d % 997, dev)[0]
        before = geomed.weiszfeld_loop.launches
        _, it = ops._geometric_median(z)
        iters = int(it)
        per_call = geomed.weiszfeld_loop.launches - before
        check(per_call == 1, f"weiszfeld_loop: {per_call} launches per call")
        n_dev, dev_ms, names = counts.get(("loop", (k, d)), (None, None, None))
        check(n_dev == 1, f"geometric_median_kernel {(k, d)}: {n_dev} device "
                          f"kernels per call {names}")
        kernel_ms = timed(lambda: ops.geometric_median_kernel(z))
        wrapper_ms = host_ms(lambda: ops.geometric_median_kernel(z))
        plain_ms = timed(lambda: ops.geometric_median_kernel(z, plain=True))
        # the loop must read Z from HBM once a pass (init + each
        # iteration) where Z is larger than the L2, and once where it
        # fits; it writes y once (the kernel recomputes the previous y
        # from Z and never reads it); Z read once beside it
        z_reads = 1 if 4 * k * d <= l2 else iters + 1
        nbytes = 4 * (k * d * z_reads + d)
        ops_ = (iters + 1) * 6 * k * d
        bound_ms, bound_by = bound(nbytes, ops_, hbm, flops)
        out[("weiszfeld_loop", (k, d))] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by)
        vec = geomed.vector_width(d, z)
        emit({"phase": "timing", "kernel": "weiszfeld_loop", "shape": [k, d],
              "loop_kernel": geomed.loop_kernel(k), "vec": vec,
              "iters": iters, "launches_per_call": per_call,
              "n_blocks": geomed.loop_blocks(k, d, vec, dev),
              "device_kernels_per_call": n_dev, "device_kernel_names": names,
              "device_ms": dev_ms, "wrapper_host_ms": wrapper_ms,
              "kernel_ms": kernel_ms, "ms_per_pass": kernel_ms / (iters + 1),
              "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "z_reads": z_reads, "l2_bytes": l2,
              "bound_z_once_ms": 4 * (k * d + d) / hbm * 1e3,
              "card": smi})
        del z
        torch.cuda.empty_cache()
    return out


def attn_inputs(case, dtype, dev, seed=0):
    import torch
    B, Tq, Tk, H, KV, hd = case[:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, Tq, H, hd), (B, Tk, KV, hd),
                               (B, Tk, KV, hd)))


def attention_parity(dev, grid=ATTN_GRID):
    """The flash kernel (``ops.attention`` on CUDA tensors) vs
    ``flash_attention_ref`` -> {(case, dtype): max_abs_err}.  f32 goes
    through the CUDA-core route, bf16 through the tensor-core route (the
    route counts are asserted); in bf16 also vs the plain version in f32
    on the same inputs (``BF16_BOUND``) and, as a diagnostic, vs the
    route's plain twin; at ATTN_MAIN a planted fault (the kernel without
    the window) shows what each bf16 check sees."""
    import torch
    from repro_torch.kernels.attention import flash, ops, ref
    errs = {}
    for case in grid:
        causal, window = case[6], case[7]
        for dname in ("float32", "bfloat16"):
            q, k, v = attn_inputs(case, getattr(torch, dname), dev,
                                  seed=case[1] + case[5])
            route = flash.route(q.dtype, case[5])
            before = dict(flash.flash_attention.route_launches)
            a = ops.attention(q, k, v, causal=causal, sliding_window=window)
            b = ops.attention(q, k, v, causal=causal, sliding_window=window)
            moved = {r: n - before[r] for r, n in
                     flash.flash_attention.route_launches.items()}
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           sliding_window=window)
            torch.cuda.synchronize(dev)
            diff = (a.float() - want.float()).abs()
            tol = ATTN_TOL[dname]
            ok = bool((diff <= tol + tol * want.float().abs()).all())
            err = float(diff.max())
            bitwise = bool(torch.equal(a, b))
            tag = f"attention {case} {dname}"
            check(ok, f"parity {tag}: max_abs_err {err}")
            check(bitwise, f"determinism {tag}")
            check(a.dtype == q.dtype and a.shape == q.shape,
                  f"{tag}: output {a.dtype} {tuple(a.shape)}")
            want_route = "tensor_core" if dname == "bfloat16" else \
                "cuda_core"
            check(route == want_route and moved == {
                r: 2 * (r == want_route) for r in moved},
                f"{tag}: launches by route {moved}, want 2 on {want_route}")
            errs[(case, dname)] = err
            line = {"phase": "parity_attention", "case": list(case),
                    "dtype": dname, "route": route, "max_abs_err": err,
                    "max_abs_y": float(want.float().abs().max()),
                    "tol": tol, "ok": ok, "bitwise_repeat": bitwise}
            if dname == "bfloat16":
                want32, allowed = restated_bound(q, k, v, causal, window)
                ok32, err32, ratio = within_bound(a, want32, allowed)
                check(ok32, f"parity {tag} vs f32: max_abs_err {err32}, "
                            f"max |d| / bound {ratio}")
                twin = ref.flash_attention_tiled_ref(
                    q, k, v, causal=causal, sliding_window=window)
                line.update(max_abs_err_vs_f32=err32, ok_vs_f32=ok32,
                            max_ratio_to_bound=ratio,
                            max_abs_err_vs_twin=float(
                                (a.float() - twin.float()).abs().max()))
                del twin
                if case == ATTN_MAIN:
                    line["planted_fault"] = planted_attention_fault(
                        q, k, v, want, want32, allowed)
                del want32, allowed
            emit(line)
            del q, k, v, a, b, want, diff
            torch.cuda.empty_cache()
    return errs


def restated_bound(q, k, v, causal, window):
    """(y32, allowed): the plain version in f32 on bf16 q, k, v, and the
    elementwise bound 2**-8 |y32| + 2**-8 (P|V|) + 2 ATTN_TOL["float32"]
    (``BF16_BOUND``)."""
    from repro_torch.kernels.attention import ref
    q, k, v = q.float(), k.float(), v.float()
    want32 = ref.flash_attention_ref(q, k, v, causal=causal,
                                     sliding_window=window)
    pv = ref.flash_attention_ref(q, k, v.abs(), causal=causal,
                                 sliding_window=window)
    allowed = BF16_BOUND * (want32.abs() + pv) + 2 * ATTN_TOL["float32"]
    return want32, allowed


def within_bound(got, want32, allowed):
    """bf16 ``got`` vs the f32 plain version: (ok, max_abs_err, max of
    |d| / bound)."""
    diff = (got.float() - want32).abs()
    return (bool((diff <= allowed).all()), float(diff.max()),
            float((diff / allowed).max()))


def planted_attention_fault(q, k, v, want, want32, allowed):
    """The kernel with the window dropped, against both bf16 checks: the
    strict one must fail it."""
    from repro_torch.kernels.attention import ops
    bad = ops.attention(q, k, v, causal=True, sliding_window=None)
    diff = (bad.float() - want.float()).abs()
    tol = ATTN_TOL["bfloat16"]
    loose_ok = bool((diff <= tol + tol * want.float().abs()).all())
    strict_ok, strict_err, _ = within_bound(bad, want32, allowed)
    check(not strict_ok, "planted attention fault (no window) passed the "
                         "bf16 check against f32")
    return {"fault": "no window", "max_abs_err": float(diff.max()),
            "passes_3e-2": loose_ok, "max_abs_err_vs_f32": strict_err,
            "passes_vs_f32": strict_ok}


def _synced_ms(fn, dev):
    """(fn(), ms) on the host clock, synchronised before and after."""
    import torch
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _prefill_ms(step, params, batch, dev):
    return _synced_ms(lambda: step(params, batch), dev)


def serve_path(dev):
    """The serve path at full width -> the flash kernel's launches by
    route in each prefill: {"bfloat16": {...}, "float32": {...}} (the bf16
    prefill is the main path's run).  (a) the prefill step at B = 1, T =
    PREFILL_T in bf16, then in f32: kernel path vs plain path, 24 launches
    per prefill (all on the tensor-core route in bf16, on the CUDA-core
    route in f32), and a planted fault (the kernel path without the
    window) against the same bound; (b) launch/serve.py at --scale gpu;
    (c) in f32, the prefill step's last-position logits on the served
    prompts vs the logits the decode loop reaches after the same
    prompt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    base = get_config(SERVE_ARCH)
    L = base.num_layers
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T),
                           generator=gen, device=dev)
    prompts = torch.randint(0, base.vocab_size, (4, 16), generator=gen,
                            device=dev)
    by_route = {}
    for dname in ("bfloat16", "float32"):
        cfg = base.with_(dtype=getattr(torch, dname),
                         param_dtype=getattr(torch, dname))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params = model.init(0, cfg, device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        kernel_step = steps.make_prefill_step(cfg)
        plain_step = steps.make_prefill_step(cfg, plain=True)
        _prefill_ms(kernel_step, params, {"tokens": tokens[:, :256]}, dev)
        flash.reset_launches()
        h, ms_kernel = _prefill_ms(kernel_step, params, {"tokens": tokens},
                                   dev)
        n_prefill = flash.flash_attention.launches
        routes = by_route[dname] = dict(flash.flash_attention.route_launches)
        h_plain, ms_plain = _prefill_ms(plain_step, params,
                                        {"tokens": tokens}, dev)
        plain_launches = flash.flash_attention.launches - n_prefill
        scale = float(h_plain.float().abs().max())
        err = float((h.float() - h_plain.float()).abs().max())
        ok = err <= PREFILL_RTOL[dname] * scale
        # planted fault: the same params through the kernel path with the
        # window dropped (a wrong mask), against the plain path's h
        h_bad = steps.make_prefill_step(cfg.with_(sliding_window=None))(
            params, {"tokens": tokens})
        fault_err = float((h_bad.float() - h_plain.float()).abs().max())
        fault_fails = fault_err > PREFILL_RTOL[dname] * scale
        del h_bad
        check(fault_fails, f"prefill {dname}: a planted fault (no window) "
                           f"passed, rel_err {fault_err / scale}")
        finite = bool(torch.isfinite(h).all())
        check(ok, f"prefill {dname}: kernel vs plain max_abs_err {err} "
                  f"(max|h| {scale}, rtol {PREFILL_RTOL[dname]})")
        check(finite and h.shape == (1, PREFILL_T, cfg.d_model),
              f"prefill {dname}: output {tuple(h.shape)}, finite {finite}")
        check(n_prefill == L and plain_launches == 0,
              f"prefill {dname}: {n_prefill} kernel launches (want {L}), "
              f"plain path {plain_launches}")
        want_route = "tensor_core" if dname == "bfloat16" else "cuda_core"
        check(routes == {r: L * (r == want_route) for r in routes},
              f"prefill {dname}: launches by route {routes}, want {L} on "
              f"{want_route}")
        emit({"phase": "serve_prefill", "arch": cfg.name, "dtype": dname,
              "batch": 1, "seq_len": PREFILL_T, "num_layers": L,
              "reduced": PREFILL_CUTS,
              "init_s": init_s, "kernel_launches": n_prefill,
              "launches_by_route": routes,
              "ms_per_prefill": {"kernel": ms_kernel, "plain": ms_plain},
              "max_abs_err": err, "max_abs_h": scale,
              "rel_err": err / scale, "rtol": PREFILL_RTOL[dname], "ok": ok,
              "planted_fault": {"fault": "no window",
                                "rel_err": fault_err / scale,
                                "fails_rtol": fault_fails},
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        del h, h_plain
        if dname == "float32":
            # (c) the same function through the kernel and the cache path
            flash.reset_launches()
            hp = kernel_step(params, {"tokens": prompts})
            n_check = flash.flash_attention.launches
            check(n_check == L, f"prefill of the served prompts: {n_check} "
                                f"kernel launches (want {L})")
            want = model._unembed_fn(params, cfg)(hp[:, -1:])
            _, got, _ = serve.generate(params, cfg, prompts, 1)
            lscale = float(want.abs().max())
            lerr = float((got - want).abs().max())
            lok = lerr <= 1e-3 * lscale
            check(lok, f"prefill vs decode logits (f32): max_abs_err {lerr} "
                       f"(max|logits| {lscale})")
            emit({"phase": "serve_prefill_vs_decode", "dtype": dname,
                  "prompts": list(prompts.shape), "kernel_launches": n_check,
                  "max_abs_err": lerr, "max_abs_logits": lscale,
                  "rtol": 1e-3, "ok": lok})
            del hp, want, got
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if dname == "bfloat16":
            # (b) the serve CLI as a user runs it, on its own params
            out, stats = serve.main(["--scale", "gpu", "--arch", SERVE_ARCH])
            good = (tuple(out.shape) == (4, 32) and int(out.min()) >= 0
                    and int(out.max()) < base.vocab_size)
            check(good, f"serve --scale gpu: tokens {tuple(out.shape)}")
            emit({"phase": "serve_gpu", "arch": SERVE_ARCH, "requests": 4,
                  "prompt_len": 16, "new_tokens": 32,
                  "tokens_per_s": stats["tokens_per_s"],
                  "prefill_s": stats["prefill_s"],
                  "decode_s": stats["decode_s"], "ok": good,
                  "first_tokens": out[0, :8].tolist()})
            del out
            torch.cuda.empty_cache()
    return by_route


def cuda_core_call(q, k, v, causal, window, q_offset=0):
    """One launch of the CUDA-core kernel on bf16 inputs through the
    library's C entry (route 0), bypassing ``flash.route``: the kernel the
    tensor-core route replaced, timed beside it.  Counts nothing."""
    import torch
    from repro_torch.kernels.attention import flash
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = flash._library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        flash._DTYPES[q.dtype], B, Tq, Tk, H, KV, hd, int(causal),
        int(window or 0), q_offset, hd ** -0.5, flash.ROUTES["cuda_core"],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA-core flash kernel: CUDA error {rc}")
    return out


def attention_timings(dev, hbm, smi):
    """Kernel, plain and library ms of flash attention at ATTN_TIMED (bf16)
    -> {case: timing dict}.  The kernel is the tensor-core route; the
    CUDA-core kernel is timed beside it on the same inputs.  The library
    call's backend is pinned with ``sdpa_kernel`` and named."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.attention import flash, ops, ref
    from repro_torch.models.attention import attention_core_blocked
    tc = PEAK_BF16[next((p for p in ("PCIe", "NVL")
                         if p in torch.cuda.get_device_name(0)), "SXM")]
    out = {}
    for case in ATTN_TIMED:
        B, Tq, Tk, H, KV, hd, causal, window = case
        q, k, v = attn_inputs(case, torch.bfloat16, dev, seed=11)
        before = flash.flash_attention.route_launches["tensor_core"]
        ops.attention(q, k, v, causal=causal, sliding_window=window)
        per_call = flash.flash_attention.route_launches["tensor_core"] \
            - before
        check(per_call == 1, f"attention {case}: {per_call} tensor-core "
                             "launches/call")
        kernel_ms = timed(lambda: ops.attention(
            q, k, v, causal=causal, sliding_window=window))
        cuda_core_ms = timed(lambda: cuda_core_call(q, k, v, causal,
                                                    window))
        # the plain version; at T = 32 768 its (B, KV, G, T, T) scores
        # would take 137 GB, so there the blocked core (the plain path
        # above 2048 positions) is timed
        if Tq <= 8192:
            plain_name = "flash_attention_ref"
            plain_ms = timed(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, sliding_window=window))
        else:
            plain_name = "attention_core_blocked"
            plain_ms = timed(lambda: attention_core_blocked(
                q, k, v, causal=causal, sliding_window=window))
        torch.cuda.empty_cache()
        # one library call on the same inputs in its (B, H, T, hd) layout,
        # its backend pinned: causal GQA through is_causal on the flash
        # backend (kv repeated to H heads if that backend refuses GQA); the
        # window through an explicit mask on the memory-efficient backend,
        # kv repeated to H heads (GQA with a mask would go to the math
        # backend, whose scores do not fit at 32 768)
        qt = q.transpose(1, 2).contiguous()
        if window is None:
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            library_name = "flash (enable_gqa)"
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                try:
                    F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)
                except RuntimeError:
                    library_name = "flash (kv repeated to H heads)"
                    kt, vt = (x.repeat_interleave(H // KV, dim=1)
                              for x in (kt, vt))
                gqa = library_name == "flash (enable_gqa)"
                library_ms = timed(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa))
            # which backend an unpinned call takes: it beside cuDNN's
            others = {"unpinned": timed(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa))}
            try:
                with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
                    others["cudnn"] = timed(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=gqa))
            except RuntimeError:
                others["cudnn"] = None
        else:
            others = {}
            library_name = "efficient (dense window mask, kv repeated)"
            kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1)
                      .contiguous() for x in (k, v))
            pos = torch.arange(Tq, device=dev)
            live = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            bias = torch.zeros((Tq, Tk), dtype=q.dtype, device=dev)
            bias.masked_fill_(~live, float("-inf"))
            del live
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                library_ms = timed(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias))
            del bias
        pairs = flash.live_pairs(Tq, Tk, causal, window)
        ops_ = pairs * 4 * H * hd
        nbytes = 2 * (2 * B * Tq * H * hd + 2 * B * Tk * KV * hd)
        bound_ms, bound_by = bound(nbytes, ops_, hbm, tc)
        out[case] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        emit({"phase": "timing", "kernel": "flash_attention",
              "case": list(case), "dtype": "bfloat16",
              "route": "tensor_core", "launches_per_call": per_call,
              "kernel_ms": kernel_ms, "cuda_core_kernel_ms": cuda_core_ms,
              "plain_ms": plain_ms, "plain": plain_name,
              "library_ms": library_ms, "library": library_name,
              "library_other_backends_ms": others,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "live_pairs": pairs,
              "kernel_tflops": ops_ / kernel_ms / 1e9,
              "cuda_core_tflops": ops_ / cuda_core_ms / 1e9, "card": smi})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


# -- phase 6: shard-local aggregation -----------------------------------

def shard_rules():
    """Every registered rule x (``none`` and its native codec)."""
    from repro_torch.core import aggregators
    return [(n, c) for n in aggregators.available()
            for c in ("none",) + tuple(
                x for x in [aggregators.get_aggregator(n).native_codec] if x)]


def shard_inputs(m, d, seed, dev, shards=1, index=None):
    """{"w": (m, d), "s": (m,)}: N(1, 1) rows, the first SHARD_Q rows
    scaled by -10 (outliers for the trims and filters).  "w" is drawn in
    ``shards`` column blocks, block j from seed (seed, j), so that rank
    ``index`` draws its block alone (``index=None``: every block, whole)."""
    import torch

    def block(j, width):
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + j)
        x = torch.randn((m, width), generator=gen, device=dev) + 1.0
        x[:SHARD_Q] *= -10.0
        return x

    c = d // shards
    w = (block(index, c) if index is not None
         else torch.cat([block(j, c) for j in range(shards)], dim=1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"w": w, "s": torch.randn((m,), generator=gen, device=dev)}


def _timed_call(fn, dev):
    """(result, host ms) of one call, the card synchronised around it (a
    CPU device, for a rehearsal at a small size, has nothing to sync)."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _tree_err(got, want):
    """(max abs error, max|want|) over the leaves, in float32."""
    from repro_torch import tree as jtree
    err = scale = 0.0
    for g, w in zip(jtree.leaves(got), jtree.leaves(want)):
        err = max(err, float((g.float() - w.float()).abs().max()))
        scale = max(scale, float(w.float().abs().max()))
    return err, scale


def _tree_equal(a, b):
    import torch
    from repro_torch import tree as jtree
    return all(torch.equal(x, y)
               for x, y in zip(jtree.leaves(a), jtree.leaves(b)))


def sharded_virtual(dev, shapes=SHARD_VIRTUAL, d=SHARD_VIRTUAL_D,
                    shards=SHARD_S):
    """(a) Virtual mode on the card: every rule x codec at each (m, k),
    f32 and with "w" in bf16, two runs bitwise equal; against the
    unsharded path on the card: f32 within RTOL / ATOL of max|y| of
    ``round_backend="auto"`` (the round kernel for the gmom family), bf16
    within BF16_STEPS of max|y| of the unsharded ``reference`` backend
    (the path a partitioned spec resolves to; the bf16 Weiszfeld rounds
    its weights to bf16, so an ulp of order in an f32 distance can flip
    one); int8_gmom on its wire: the payload's scales bit-equal to the
    unsharded ones and q within one step (the uniforms are keyed per
    shard)."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch import tree as jtree
    from repro_torch.core import compression
    from repro_torch.core.robust_train import RobustConfig, aggregate_reported
    from repro_torch.core.shard_aggregation import ShardSpec
    spec = ShardSpec(num_shards=shards, mode="virtual")
    key = prng.PRNGKey(SHARD_SEED, device=dev)
    worst = {}
    for m, k in shapes:
        base = shard_inputs(m, d, SHARD_SEED, dev)
        for dt in ("float32", "bfloat16"):
            stacked = dict(base, w=base["w"].to(getattr(torch, dt)))
            for name, codec in shard_rules():
                cfg = RobustConfig(num_workers=m, num_byzantine=SHARD_Q,
                                   num_batches=k, aggregator=name,
                                   compression=codec)
                v1 = aggregate_reported(stacked, cfg, key=key,
                                        shard_spec=spec)
                v2 = aggregate_reported(stacked, cfg, key=key,
                                        shard_spec=spec)
                repeat = _tree_equal(v1, v2)
                tag = f"{name}/{codec} {(m, k)} w {dt}"
                check(repeat, f"sharded (a) {tag}: two runs differ")
                line = {"phase": "sharded", "part": "a", "rule": name,
                        "codec": codec, "m": m, "k": k, "d": d,
                        "shards": shards, "w_dtype": dt,
                        "bitwise_repeat": repeat}
                if codec == "int8_stochastic":
                    enc = compression.get_codec(codec).encode
                    ckey = prng.fold_in(key, 29)
                    pv = enc(stacked, key=ckey, shard_spec=spec)
                    pu = enc(stacked, key=ckey)
                    scales = _tree_equal(pv["scale"], pu["scale"])
                    step = max(int((a.int() - b.int()).abs().max())
                               for a, b in zip(jtree.leaves(pv["q"]),
                                               jtree.leaves(pu["q"])))
                    ok = scales and step <= 1
                    line.update(scales_bit_equal=scales, q_max_step=step)
                else:
                    backend = "auto" if dt == "float32" else "reference"
                    want = aggregate_reported(
                        stacked, dataclasses.replace(
                            cfg, round_backend=backend), key=key)
                    err, scale = _tree_err(v1, want)
                    ok = err <= (ATOL + RTOL * scale if dt == "float32"
                                 else BF16_STEPS * scale)
                    worst[dt] = max(worst.get(dt, 0.0),
                                    err / max(scale, 1e-30))
                    line.update(unsharded_backend=backend, max_abs_err=err,
                                max_abs_y=scale)
                check(ok, f"sharded (a) {tag}: {line}")
                emit(dict(line, ok=ok))
    return worst


def _model_axis_rank(rank, world, device, m, k, d, rules, seed):
    """(b) on one rank: its column block of the inputs, each rule through
    ``make_sharded_aggregate`` twice (the second timed, its all-gathers
    counted) -> ({rule: (result on the CPU, ms, bitwise repeat,
    all-gathers)}, median ms of one all-gather of a (k,) partial, the
    collective of a Weiszfeld iterate)."""
    import torch
    import torch.distributed as dist
    from repro_torch import random as prng
    from repro_torch.core import make_sharded_aggregate
    from repro_torch.core.robust_train import RobustConfig
    from repro_torch.core.shard_aggregation import all_gather
    from torch.utils._pytree import tree_map
    dev = torch.device(device)
    local = shard_inputs(m, d, seed, dev, shards=world, index=rank)
    key = prng.PRNGKey(seed, device=dev)
    gather, gathers = dist.all_gather, [0]

    def counted(*args, **kwargs):
        gathers[0] += 1
        return gather(*args, **kwargs)

    dist.all_gather = counted
    out = {}
    for name, codec in rules:
        agg = make_sharded_aggregate(RobustConfig(
            num_workers=m, num_byzantine=SHARD_Q, num_batches=k,
            aggregator=name, compression=codec))
        first, _ = _timed_call(lambda: agg(local, key), dev)
        gathers[0] = 0
        again, ms = _timed_call(lambda: agg(local, key), dev)
        out[f"{name}/{codec}"] = (tree_map(lambda t: t.cpu(), again), ms,
                                  _tree_equal(first, again), gathers[0])
        del first, again
        torch.cuda.empty_cache()
    part = torch.ones((k,), device=dev)
    gather_ms = statistics.median(
        _timed_call(lambda: all_gather(part), dev)[1] for _ in range(20))
    return out, gather_ms


def sharded_model_axis(dev, smi, m=SHARD_MODEL[0], k=SHARD_MODEL[1],
                       d=SHARD_MODEL[2], world=SHARD_MODEL[3],
                       rules=SHARD_MODEL_RULES):
    """(b) Model-axis shard_map on ``world`` rank processes of the one
    card over gloo, against the virtual mode in this process: each rank's
    result is its slice of the virtual result, bit for bit; ms per
    aggregation of each mode beside the unsharded round kernel's."""
    import torch
    from repro_torch import random as prng
    from repro_torch.core.robust_train import RobustConfig, aggregate_reported
    from repro_torch.core.grouping import make_grouping
    from repro_torch.core.shard_aggregation import ShardSpec, shard_slice
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import ranks
    stacked = shard_inputs(m, d, SHARD_SEED, dev, shards=world)
    key = prng.PRNGKey(SHARD_SEED, device=dev)
    spec = ShardSpec(num_shards=world, mode="virtual")
    virtual, virtual_ms, virtual_repeat = {}, {}, {}
    for name, codec in rules:
        rid = f"{name}/{codec}"
        cfg = RobustConfig(num_workers=m, num_byzantine=SHARD_Q,
                           num_batches=k, aggregator=name, compression=codec)
        first = aggregate_reported(stacked, cfg, key=key, shard_spec=spec)
        res, virtual_ms[rid] = _timed_call(lambda: aggregate_reported(
            stacked, cfg, key=key, shard_spec=spec), dev)
        virtual_repeat[rid] = _tree_equal(first, res)
        virtual[rid] = {n: t.cpu() for n, t in res.items()}
        del first, res
        torch.cuda.empty_cache()
    # unsharded: gmom through aggregate_reported ("auto": the leaves
    # concatenated, then the round kernel), and the round kernel alone on
    # "w", the (m, d) block
    gmom = RobustConfig(num_workers=m, num_byzantine=SHARD_Q, num_batches=k)
    aggregate_reported(stacked, gmom, key=key)
    _, unsharded_ms = _timed_call(lambda: aggregate_reported(stacked, gmom,
                                                             key=key), dev)
    grouping = make_grouping(m, k)
    kw = dict(trim_multiplier=gmom.trim_multiplier,
              max_iters=gmom.gmom_max_iters, tol=gmom.gmom_tol)
    rk.round_aggregate_kernel(stacked["w"], grouping, **kw)
    (_, iters), kernel_ms = _timed_call(lambda: rk.round_aggregate_kernel(
        stacked["w"], grouping, **kw), dev)
    del stacked
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = ranks.run(_model_axis_rank, world, dev.type, m, k, d, rules,
                         SHARD_SEED, timeout=600.0)
    spawn_s = time.perf_counter() - t0
    gather_ms = [res[1] for res in per_rank]
    per_rank = [res[0] for res in per_rank]
    for rid, want in virtual.items():
        equal = all(
            torch.equal(res[rid][0]["w"], shard_slice(want["w"], r, world))
            and torch.equal(res[rid][0]["s"], want["s"])
            for r, res in enumerate(per_rank))
        repeat = virtual_repeat[rid] and all(res[rid][2] for res in per_rank)
        check(equal, f"sharded (b) {rid}: a rank's slice differs from the "
                     "virtual result")
        check(repeat, f"sharded (b) {rid}: two runs on a rank differ")
        emit({"phase": "sharded", "part": "b", "rule": rid, "m": m, "k": k,
              "d": d, "ranks": world, "transport": "gloo, host-staged",
              "ranks_bit_equal_virtual": equal, "bitwise_repeat": repeat,
              "ms_virtual": virtual_ms[rid],
              "ms_shard_map_per_rank": [res[rid][1] for res in per_rank],
              "all_gathers_per_call": per_rank[0][rid][3],
              "ms_unsharded_gmom": unsharded_ms,
              "ms_unsharded_round_kernel_w": kernel_ms,
              "round_kernel_iterations": int(iters), "card": smi})
    emit({"phase": "sharded", "part": "b", "ranks_wall_s": spawn_s,
          "ms_all_gather_k_partial_per_rank": gather_ms, "card": smi})


def _data_axis_rank(rank, world, device, m, k, d, seed):
    """(c) on one rank: worker ``rank``'s gradient through
    ``make_shardmap_aggregate`` (``round_backend="auto"``) twice, the
    second timed -> (y on the CPU, round-kernel launches of one call,
    ms)."""
    import torch
    from repro_torch.core import make_shardmap_aggregate
    from repro_torch.core.robust_train import RobustConfig
    from repro_torch.kernels.geomed import round as rk
    dev = torch.device(device)
    mine = {n: t[rank] for n, t in shard_inputs(m, d, seed, dev).items()}
    agg = make_shardmap_aggregate(RobustConfig(
        num_workers=m, num_byzantine=1, num_batches=k, gmom_max_iters=32,
        gmom_tol=1e-7))
    agg(mine)
    rk.round_aggregate_kernel.launches = 0
    y, ms = _timed_call(lambda: agg(mine), dev)
    return ({n: t.cpu() for n, t in y.items()},
            rk.round_aggregate_kernel.launches, ms)


def sharded_data_axis(dev, smi, m=SHARD_DATA[0], k=SHARD_DATA[1],
                      d=SHARD_DATA[2]):
    """(c) Data-axis GMoM, ``make_shardmap_aggregate`` on m rank processes
    of the one card over gloo: one round-kernel launch per rank per call;
    every rank the same y, within 1e-5 of ``gmom_aggregator`` on the
    gathered stack through the kernel and through the reference path (the
    bound of tests/test_shardmap_aggregate.py).  -> the launches."""
    from repro_torch.core.aggregators import gmom_aggregator
    from repro_torch.launch import ranks
    per_rank = ranks.run(_data_axis_rank, m, dev.type, m, k, d, SHARD_SEED,
                         timeout=600.0)
    stacked = shard_inputs(m, d, SHARD_SEED, dev)
    launches = [res[1] for res in per_rank]
    check(launches == [1] * m, f"sharded (c): round-kernel launches per "
                               f"rank {launches}, want 1 each")
    same = all(_tree_equal(res[0], per_rank[0][0]) for res in per_rank)
    check(same, "sharded (c): ranks disagree")
    line = {"phase": "sharded", "part": "c", "m": m, "k": k, "d": d,
            "launches_per_rank": launches, "ranks_equal": same,
            "ms_per_rank": [res[2] for res in per_rank], "card": smi}
    for backend in ("auto", "reference"):
        want = gmom_aggregator(stacked, num_batches=k, num_byzantine=1,
                               max_iters=32, tol=1e-7, round_backend=backend)
        err, _ = _tree_err(per_rank[0][0],
                           {n: t.cpu() for n, t in want.items()})
        check(err < 1e-5, f"sharded (c) vs {backend}: {err}")
        line[f"max_abs_err_vs_{backend}"] = err
        _, line[f"ms_gathered_{backend}"] = _timed_call(
            lambda: gmom_aggregator(stacked, num_batches=k, num_byzantine=1,
                                    max_iters=32, tol=1e-7,
                                    round_backend=backend), dev)
    emit(line)
    return sum(launches)


# -- phase 8: Byzantine-robust LM training -----------------------------------

def _train_args(**kw):
    """launch/train.py's arguments for the phase 8 (a) config, with
    ``kw`` in place of the defaults (``workers``, ``ckpt_dir``, ...)."""
    from repro_torch.launch import train as train_lib
    args = train_lib.parse_args(
        ["--scale", "gpu", "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
         "--seq-len", str(TRAIN_SEQ), "--lr", "1e-3", "--attack",
         "sign_flip", "--aggregator", "gmom", "--log-every", "1"])
    for name, value in {**TRAIN_MAIN, **kw}.items():
        setattr(args, name, value)
    return args


def _train_run(args, dev):
    """(result, round-kernel launches, peak GB) of one ``train(args)``: the
    count set to 0 just before, read just after."""
    import torch
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import train as train_lib
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rk.round_aggregate_kernel.launches = 0
    res = train_lib.train(args)
    n = rk.round_aggregate_kernel.launches
    return res, n, torch.cuda.max_memory_allocated(dev) / 1e9


def _curve(res, name="loss_median"):
    return [row[name] for row in res["history"]]


def _compared(rows, keys=("loss_median", "agg_grad_norm")):
    return {"history": [{k: row[k] for k in keys} for row in rows]}


def train_block(dev, m, q, seed=0, arch=TRAIN_ARCH):
    """The (m, P) f32 block the round kernel aggregates in a main-path
    round of ``arch`` at its train depth: per-worker LM gradients of step
    0's batch, sign_flip on a mask of q, each leaf cast into its columns
    (round.concat_block, as round_aggregate_pytree does)."""
    from repro_torch import random as prng
    from repro_torch.core import byzantine, robust_train
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    cfg = train_lib.train_config(arch, "gpu")
    params = model.init(seed, cfg, device=dev)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=2 * m, num_workers=m, seed=seed,
                         device=dev)
    # step 0's batch as train(args) builds it (the audio family's frames
    # drawn on its round key)
    batch = train_lib.build_cpu_batch(
        cfg, stream, 0, prng.fold_in(prng.PRNGKey(seed, device=dev), 0))
    grads, _ = robust_train.per_worker_grads(
        lambda p, b: model.loss_fn(p, b, cfg), params, batch)
    del params, batch
    mask = byzantine.sample_byzantine_mask(prng.PRNGKey(seed, device=dev),
                                           m, q)
    reported = byzantine.get_attack("sign_flip")(grads, mask, None)
    del grads
    return rk.concat_block(reported)[0]


def train_kw() -> dict:
    """The main path's round settings: RobustConfig's defaults, which
    ``train(args)`` leaves as they are."""
    from repro_torch.core.robust_train import RobustConfig
    rc = RobustConfig(num_workers=TRAIN_MAIN["workers"])
    return {"trim_multiplier": rc.trim_multiplier,
            "max_iters": rc.gmom_max_iters, "tol": rc.gmom_tol}


def train_kernel_timing(dev, hbm, flops, smi, m=8, q=2, arch=TRAIN_ARCH):
    """The round kernel at the main path's (m, k, P) on a block of real LM
    gradients: ms (events), iterations, held against round_aggregate_ref
    on the same block at the main path's settings and at exactly 3
    iterations (max_iters=3, tol=0), the plain and library times and the
    bound."""
    import torch
    from repro_torch.core.grouping import assignment_matrix, make_grouping
    from repro_torch.kernels.geomed import round as rk
    kw = train_kw()
    torch.cuda.empty_cache()
    block = train_block(dev, m, q, arch=arch)
    torch.cuda.empty_cache()
    _, d = block.shape
    k = m
    grouping = make_grouping(m, k)
    y, it = rk.round_aggregate_kernel(block, grouping, **kw)
    iters = int(it)
    kernel_ms = timed(lambda: rk.round_aggregate_kernel(block, grouping,
                                                        **kw),
                      repeats=3, warmup=0)
    torch.cuda.empty_cache()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    yp, itp = rk.round_aggregate_ref(block, grouping, **kw)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err, ok, scale = compare(y, yp)
    cap = kw["max_iters"]
    # the kernel stops on its own test, replayed from its iterates; whether
    # the plain version stops at the same count is recorded, not held: at
    # tol^2 = 1e-14 over 5.6e8 columns only an exact float32 fixed point
    # stops the loop, and which order reaches one, and which cycles by an
    # ulp, is the summation order's (ROADMAP Queue 3)
    stop_ok = stops_on_its_test(
        lambda i: rk.round_aggregate_kernel(
            block, grouping, **dict(kw, max_iters=i))[0],
        iters, cap, kw["tol"])
    both_stop_or_cap = (iters < cap) == (int(itp) < cap)
    del y, yp
    torch.cuda.empty_cache()
    # where neither can stop early the iterates are held at an exact count
    few = dict(kw, max_iters=3, tol=0.0)
    y3, it3 = rk.round_aggregate_kernel(block, grouping, **few)
    yp3, itp3 = rk.round_aggregate_ref(block, grouping, **few)
    err3, ok3, scale3 = compare(y3, yp3)
    del y3, yp3
    torch.cuda.empty_cache()
    s = torch.as_tensor(assignment_matrix(grouping), device=dev)
    bsz = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                       device=dev).reshape(k, 1)
    library_ms = timed(lambda: torch.matmul(s, block) / bsz, repeats=3,
                       warmup=1)
    # the work this block needs: the passes of whichever version stops
    # first (the other's extra passes are its ulp cycle, not the function)
    needed = min(iters, int(itp))
    bound_ms, bound_by = bound(4 * (m * d + d),
                               m * d + (needed + 1) * 6 * k * d, hbm, flops)
    check(ok, f"train block {(m, k, d)}: kernel vs plain max_abs_err {err} "
              f"(max|y| {scale})")
    check(stop_ok, f"train block {(m, k, d)}: the kernel's stop at {iters} "
                   f"iterations (cap {cap})")
    check(ok3, f"train block {(m, k, d)} at max_iters=3, tol=0: kernel vs "
               f"plain max_abs_err {err3} (max|y| {scale3})")
    check(int(it3) == int(itp3) == 3,
          f"train block {(m, k, d)} at max_iters=3, tol=0: kernel "
          f"{int(it3)} plain {int(itp3)} iterations, want 3")
    line = {"phase": "train", "part": "kernel", "arch": arch,
            "shape": [m, k, d],
            "iters_kernel": iters, "iters_plain": int(itp),
            "max_abs_err": err, "max_abs_y": scale, "ok": ok,
            "stop_ok": stop_ok, "both_stop_or_cap": both_stop_or_cap,
            "few": {"iters_kernel": int(it3), "iters_plain": int(itp3),
                    "max_abs_err": err3, "max_abs_y": scale3, "ok": ok3},
            "bound_iters": needed,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms_means_only": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "card": smi}
    emit(line)
    del block, s
    torch.cuda.empty_cache()
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "iters": iters,
            "iters_plain": int(itp), "shape": (m, k, d)}


def group_step_run(dev, backend, seed=0, arch=TRAIN_ARCH):
    """(rows, launches, s per step, peak GB) of make_group_train_step at
    the phase 8 config (``arch`` at its train depth) with remat and
    microbatches."""
    import torch
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.core import RobustConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    g = TRAIN_GROUP
    cfg = train_lib.train_config(arch, "gpu").with_(remat=True)
    rc = RobustConfig(num_workers=g["k"], num_byzantine=g["q"],
                      num_batches=g["k"], aggregator="gmom",
                      attack="sign_flip", round_backend=backend)
    opt = optim.adamw(1e-3)
    step = steps.make_group_train_step(cfg, rc, opt,
                                       microbatches=g["microbatches"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(seed, cfg, device=dev)
    opt_state = opt.init(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=g["batch"], num_workers=g["k"],
                         seed=seed, device=dev)
    key = prng.fold_in(prng.PRNGKey(seed, device=dev), 10_000)
    rows = []
    torch.cuda.synchronize()
    rk.round_aggregate_kernel.launches = 0
    t0 = time.perf_counter()
    for t in range(g["steps"]):
        params, opt_state, met = step(params, opt_state, stream.batch(t),
                                      prng.fold_in(key, t), t)
        rows.append({name: float(v) for name, v in met.items()})
    seconds = time.perf_counter() - t0
    n = rk.round_aggregate_kernel.launches
    del params, opt_state
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()
    return rows, n, seconds / g["steps"], peak


def headline_run(dev, aggregator, attack):
    """The reference's _run_lm (tests/test_system.py) on the card: the
    loss_median curve and the round-kernel launches."""
    from repro_torch import configs, optim
    from repro_torch import random as prng
    from repro_torch.core import RobustConfig, make_robust_train_step
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.models import model
    h = HEADLINE
    cfg = configs.get_config(h["arch"]).reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=h["seq_len"],
                         global_batch=h["batch"], num_workers=h["m"], seed=0,
                         device=dev)
    rc = RobustConfig(num_workers=h["m"], num_byzantine=h["q"],
                      attack=attack, aggregator=aggregator,
                      num_batches=h["k"])
    opt = optim.adamw(1e-3)
    step = make_robust_train_step(lambda p, b: model.loss_fn(p, b, cfg),
                                  opt, rc)
    params = model.init(0, cfg, device=dev)
    opt_state = opt.init(params)
    losses = []
    rk.round_aggregate_kernel.launches = 0
    for i in range(h["steps"]):
        params, opt_state, met = step(params, opt_state, stream.batch(i),
                                      prng.PRNGKey(7, device=dev), i)
        losses.append(float(met["loss_median"]))
    return losses, rk.round_aggregate_kernel.launches


def train_path(dev, hbm, flops, smi):
    """Phase 8 -> (round-kernel launches of its runs, the kernel's timing
    at the main path's (8, 8, P)).  (a) launch/train.py's train(args) at
    the main config through round_backend "auto" (4 rounds, 4 launches),
    and at m = 4 on "auto" and "fused_interpret" (histories within
    compare_traces); (b) 2 steps with a checkpoint, resumed to 4, against
    the straight run bit for bit; (c) make_group_train_step with remat and
    microbatches, kernel vs plain; (d) the reference's LM robustness
    assertions at their own setting, and the same comparison's curves at
    the main config."""
    import shutil
    import tempfile

    from repro_torch.sim.goldens import compare_traces
    t_phase = time.perf_counter()
    launches = 0
    # (a) kernel vs plain at the compared geometry (which also warms the
    # card up for the LM's shapes), then the main path
    compared = {}
    for backend in ("auto", "fused_interpret"):
        res, n, peak = _train_run(_train_args(round_backend=backend,
                                              **TRAIN_COMPARED), dev)
        compared[backend] = (res, n, peak)
    launches += compared["auto"][1]
    main, n_main, peak_main = _train_run(_train_args(), dev)
    launches += n_main
    finite = all(math.isfinite(v) for row in main["history"]
                 for v in row.values())
    check(n_main == TRAIN_STEPS, f"train: {n_main} round-kernel launches "
                                 f"for {TRAIN_STEPS} rounds")
    check(finite and len(main["history"]) == TRAIN_STEPS,
          f"train: history {main['history']}")
    vs_plain = compare_traces(
        _compared(compared["auto"][0]["history"]),
        _compared(compared["fused_interpret"][0]["history"]))
    check(not vs_plain, f"train m=4: kernel vs plain {vs_plain[:3]}")
    check(compared["auto"][1] == TRAIN_STEPS
          and compared["fused_interpret"][1] == 0,
          f"train m=4: launches {compared['auto'][1]} (kernel), "
          f"{compared['fused_interpret'][1]} (plain)")
    emit({"phase": "train", "part": "a", "arch": TRAIN_ARCH,
          "layers": 2, "seq_len": TRAIN_SEQ, **TRAIN_MAIN,
          "num_batches": 8, "steps": TRAIN_STEPS, "reduced": TRAIN_CUTS,
          "kernel_launches": n_main, "s_per_step":
          main["seconds"] / TRAIN_STEPS, "peak_mem_gb": peak_main,
          "loss_median": _curve(main),
          "agg_grad_norm": _curve(main, "agg_grad_norm"),
          "finite": finite, "compared_geometry": TRAIN_COMPARED,
          "compared": {b: {"launches": n, "peak_mem_gb": peak,
                           "s_per_step": r["seconds"] / TRAIN_STEPS,
                           "loss_median": _curve(r),
                           "agg_grad_norm": _curve(r, "agg_grad_norm")}
                       for b, (r, n, peak) in compared.items()},
          "kernel_vs_plain_ok": not vs_plain, "card": smi})
    del compared
    # (b) resume: 2 steps with a checkpoint, then on to 4
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        first, n1, _ = _train_run(_train_args(steps=2, ckpt_dir=ckpt,
                                              ckpt_every=2), dev)
        resumed, n2, _ = _train_run(_train_args(ckpt_dir=ckpt, ckpt_every=2),
                                    dev)
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches += n1 + n2
    bitwise = (resumed["resumed_from"] == 2
               and resumed["history"] == main["history"])
    check(bitwise and n1 == 2 and n2 == 2,
          f"train resume: resumed_from {resumed['resumed_from']}, history "
          f"{resumed['history']} vs {main['history']}; launches {n1}, {n2}")
    emit({"phase": "train", "part": "b", "resumed_from":
          resumed["resumed_from"], "bit_identical": bitwise,
          "launches": [n1, n2], "seconds": resume_s})
    # (c) the group-mode step with remat and microbatches
    group = {b: group_step_run(dev, b) for b in ("auto", "fused_interpret")}
    launches += group["auto"][1]
    vs_group = compare_traces(_compared(group["auto"][0]),
                              _compared(group["fused_interpret"][0]))
    check(not vs_group, f"group step: kernel vs plain {vs_group[:3]}")
    check(group["auto"][1] == TRAIN_GROUP["steps"]
          and group["fused_interpret"][1] == 0,
          f"group step: launches {group['auto'][1]}, "
          f"{group['fused_interpret'][1]}")
    emit({"phase": "train", "part": "c", **TRAIN_GROUP, "remat": True,
          "kernel_vs_plain_ok": not vs_group,
          "runs": {b: {"history": rows, "launches": n, "s_per_step": s,
                       "peak_mem_gb": peak}
                   for b, (rows, n, s, peak) in group.items()}})
    # (d) the reference's headline on the card, at its own setting
    clean, _ = headline_run(dev, "mean", "none")
    broken, _ = headline_run(dev, "mean", "sign_flip")
    robust, n_robust = headline_run(dev, "gmom", "sign_flip")
    launches += n_robust
    asserts = {"learns": clean[-1] < clean[0],
               "mean_destroyed": broken[-1] > clean[-1] + 1.0,
               "gmom_tracks_clean": abs(robust[-1] - clean[-1]) < 0.5}
    for what, ok in asserts.items():
        check(ok, f"headline {what}: clean {clean}, mean+attack {broken}, "
                  f"gmom+attack {robust}")
    check(n_robust == HEADLINE["steps"],
          f"headline gmom: {n_robust} round-kernel launches")
    curves = {"gmom_sign_flip": _curve(main)}
    for agg, attack in (("mean", "none"), ("mean", "sign_flip")):
        res, _, _ = _train_run(_train_args(aggregator=agg, attack=attack),
                               dev)
        curves[f"{agg}_{attack}"] = _curve(res)
    emit({"phase": "train", "part": "d", "setting": HEADLINE,
          "clean": clean, "mean_attack": broken, "gmom_attack": robust,
          "assertions": asserts, "gmom_launches": n_robust,
          "curves_at_main_config": curves})
    timing = train_kernel_timing(dev, hbm, flops, smi)
    emit({"phase": "train", "seconds": time.perf_counter() - t_phase,
          "kernel_launches": launches})
    return launches, timing


# -- phase 9: the MoE family ----------------------------------------------------

class RouteTape:
    """``models.moe.route`` for one pass of the model, call by call (one
    call a layer): records each call's top_ids and, with ``keep_probs``,
    the router's probabilities; given ``replay`` (an earlier tape's ids),
    hands each call the recorded ids in place of its own top-k, weighted
    by its own probabilities renormalised over them.  ``installed()``
    puts it in place of ``moe.route`` for a ``with`` block."""

    def __init__(self, replay=None, keep_probs=False):
        self.replay, self.keep_probs = replay, keep_probs
        self.ids, self.probs = [], []
        self._route = None

    def __call__(self, params, spec, x_flat):
        import torch
        ids, w, aux, z = self._route(params, spec, x_flat)
        if self.replay is not None or self.keep_probs:
            probs = torch.softmax(x_flat.float() @ params["router"], dim=-1)
        if self.replay is not None:
            ids = self.replay[len(self.ids)]
            w = torch.gather(probs, 1, ids)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        if self.keep_probs:
            self.probs.append(probs)
        self.ids.append(ids)
        return ids, w, aux, z

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import moe
        self._route = moe.route
        moe.route = self
        try:
            yield self
        finally:
            moe.route = self._route


def route_flips(plain, other, num_experts):
    """Where ``other``'s expert choices left ``plain``'s, layer by layer:
    (assignments whose expert differs, tokens that diverged, the plain
    run's margin at each token's first divergence: the least probability
    it kept that ``other`` dropped minus the largest it dropped that
    ``other`` took, the max and the median over tokens; the earliest
    layer where any token diverged and the max margin there)."""
    import torch
    n_tok = plain.ids[0].shape[0]
    dev = plain.ids[0].device
    diverged = torch.zeros(n_tok, dtype=torch.bool, device=dev)
    flips, margins, first_layer = 0, [], None
    for layer, (a, b, p) in enumerate(zip(plain.ids, other.ids,
                                          plain.probs)):
        ina = torch.zeros((n_tok, num_experts), dtype=torch.bool,
                          device=dev).scatter(1, a, True)
        inb = torch.zeros_like(ina).scatter(1, b, True)
        differs = (ina != inb).any(-1)
        flips += int((ina & ~inb).sum())
        first = differs & ~diverged
        if bool(first.any()):
            lost, gained, pf = (ina & ~inb)[first], (inb & ~ina)[first], \
                p[first]
            margins.append(pf.masked_fill(~lost, float("inf")).amin(-1)
                           - pf.masked_fill(~gained, -float("inf"))
                           .amax(-1))
            if first_layer is None:
                first_layer = layer
        diverged |= differs
    m = torch.cat(margins) if margins else torch.zeros(0, device=dev)
    return {"assignments": flips, "tokens": int(diverged.sum()),
            "max_first_margin": float(m.max()) if len(m) else None,
            "median_first_margin": float(m.median()) if len(m) else None,
            "first_layer": first_layer,
            "first_layer_tokens": len(margins[0]) if margins else 0,
            "first_layer_max_margin": (float(margins[0].max()) if margins
                                       else None)}


def moe_serve_path(dev):
    """Phase 9 (a), Granite at full width and depth -> ({dtype: the flash
    kernel's launches by route in the kernel-path prefill}, bf16 prefill
    ms).  The prefill step at B = 1, T = PREFILL_T in bf16 and f32: the
    plain path; the kernel path (the main path's run: 24 launches on the
    dtype's route); and the kernel path again with the plain path's
    expert choices replayed (``RouteTape``), held against the plain path
    under PREFILL_RTOL.  Near ties of the router flip experts between
    two summation orders, and a flipped expert moves its token by a
    weighted expert output, far past what the attention kernel's rounding
    moves: so the free kernel path's error and its flips are recorded,
    not held, but at the earliest layer where any token flips, every
    flipped token's margin is held to ``FLIP_MARGIN_FACTOR`` times the
    replayed run's router probability error there (a near tie, not a
    fault).  The dropped assignments at the configured capacity are
    counted from the kernel path's choices.  Then launch/serve.py
    --arch granite-moe-1b-a400m --scale gpu, and in f32 at C = N (nothing
    drops) the prefill step's last-position logits vs the decode loop's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import serve, steps
    from repro_torch.models import blocks, model, moe
    base = get_config(MOE_ARCH)
    L, E, K = base.num_layers, base.num_experts, base.experts_per_token
    C = moe._capacity(blocks.moe_spec(base), PREFILL_T)
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T),
                           generator=gen, device=dev)
    prompts = torch.randint(0, base.vocab_size, (4, 16), generator=gen,
                            device=dev)
    by_route, ms = {}, {}
    for dname in ("bfloat16", "float32"):
        cfg = base.with_(dtype=getattr(torch, dname),
                         param_dtype=getattr(torch, dname))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(0, cfg, device=dev)
        check(params["layers"]["moe"]["router"].dtype == torch.float32,
              f"granite {dname}: router "
              f"{params['layers']['moe']['router'].dtype}")
        kernel_step = steps.make_prefill_step(cfg)
        plain_step = steps.make_prefill_step(cfg, plain=True)
        _prefill_ms(kernel_step, params, {"tokens": tokens[:, :256]}, dev)
        plain_tape = RouteTape(keep_probs=True)
        flash.reset_launches()
        with plain_tape.installed():
            h_plain, ms_plain = _prefill_ms(plain_step, params,
                                            {"tokens": tokens}, dev)
        plain_launches = flash.flash_attention.launches
        free_tape = RouteTape()
        flash.reset_launches()
        with free_tape.installed():
            h, ms_kernel = _prefill_ms(kernel_step, params,
                                       {"tokens": tokens}, dev)
        n_prefill = flash.flash_attention.launches
        routes = by_route[dname] = dict(flash.flash_attention.route_launches)
        ms[dname] = ms_kernel
        forced_tape = RouteTape(replay=plain_tape.ids, keep_probs=True)
        with forced_tape.installed():
            h_forced = kernel_step(params, {"tokens": tokens})
        n_forced = flash.flash_attention.launches - n_prefill
        scale = float(h_plain.float().abs().max())
        err = float((h_forced.float() - h_plain.float()).abs().max())
        ok = err <= PREFILL_RTOL[dname] * scale
        free_err = float((h.float() - h_plain.float()).abs().max())
        flips = route_flips(plain_tape, free_tape, E)
        # up to the earliest layer where a token flips, the free run routed
        # as the replayed run: a flip there needs a margin of at most twice
        # the router probabilities' error, which the replayed run shows
        lf = flips["first_layer"]
        prob_err = None if lf is None else float(
            (forced_tape.probs[lf] - plain_tape.probs[lf]).abs().max())
        ties_ok = lf is None or (flips["first_layer_max_margin"]
                                 <= FLIP_MARGIN_FACTOR * prob_err)
        dropped = [int((moe._ranks(ids.reshape(-1), E)[3] >= C).sum())
                   for ids in free_tape.ids]
        finite = bool(torch.isfinite(h).all())
        check(ok, f"granite prefill {dname}: kernel (plain path's experts) "
                  f"vs plain max_abs_err {err} (max|h| {scale}, rtol "
                  f"{PREFILL_RTOL[dname]})")
        check(finite and h.shape == (1, PREFILL_T, cfg.d_model),
              f"granite prefill {dname}: output {tuple(h.shape)}, finite "
              f"{finite}")
        check(ties_ok,
              f"granite prefill {dname}: routing flips first at layer {lf} "
              f"with a margin of {flips['first_layer_max_margin']}, past "
              f"{FLIP_MARGIN_FACTOR} x the replayed run's router "
              f"probability error {prob_err}")
        check(n_prefill == L and n_forced == L and plain_launches == 0,
              f"granite prefill {dname}: {n_prefill} and {n_forced} kernel "
              f"launches (want {L}), plain path {plain_launches}")
        want_route = "tensor_core" if dname == "bfloat16" else "cuda_core"
        check(routes == {r: L * (r == want_route) for r in routes},
              f"granite prefill {dname}: launches by route {routes}, want "
              f"{L} on {want_route}")
        check(len(free_tape.ids) == len(plain_tape.ids) == L,
              f"granite prefill {dname}: {len(free_tape.ids)} router calls")
        emit({"phase": "moe", "part": "a", "step": "prefill",
              "arch": cfg.name, "dtype": dname, "batch": 1,
              "seq_len": PREFILL_T, "num_layers": L,
              "reduced": PREFILL_CUTS[:1],
              "kernel_launches": n_prefill, "launches_by_route": routes,
              "ms_per_prefill": {"kernel": ms_kernel, "plain": ms_plain},
              "max_abs_err": err, "max_abs_h": scale,
              "rel_err": err / scale, "rtol": PREFILL_RTOL[dname], "ok": ok,
              "free_routing": {"max_abs_err": free_err,
                               "rel_err": free_err / scale,
                               "flips": flips,
                               "first_layer_prob_err": prob_err,
                               "flip_margin_factor": FLIP_MARGIN_FACTOR,
                               "ties_ok": ties_ok},
              "capacity": C, "dropped_assignments": sum(dropped),
              "dropped_by_layer": dropped, "assignments": PREFILL_T * K * L,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        del h, h_plain, h_forced, plain_tape, free_tape, forced_tape
        if dname == "float32":
            # at C = N nothing drops: the prefill step and the decode loop
            # compute one function
            slack = cfg.with_(moe_capacity_factor=E / K)
            n = prompts.numel()
            check(moe._capacity(blocks.moe_spec(slack), n) == n,
                  "granite slack capacity")
            flash.reset_launches()
            hp = steps.make_prefill_step(slack)(params, {"tokens": prompts})
            n_check = flash.flash_attention.launches
            want = model._unembed_fn(params, slack)(hp[:, -1:])
            _, got, _ = serve.generate(params, slack, prompts, 1)
            lscale = float(want.abs().max())
            lerr = float((got - want).abs().max())
            lok = lerr <= 1e-3 * lscale
            check(lok and n_check == L,
                  f"granite prefill vs decode logits (f32, C = N): "
                  f"max_abs_err {lerr} (max|logits| {lscale}), {n_check} "
                  "kernel launches")
            emit({"phase": "moe", "part": "a", "step": "prefill_vs_decode",
                  "dtype": dname, "capacity_factor": E / K,
                  "prompts": list(prompts.shape), "kernel_launches": n_check,
                  "max_abs_err": lerr, "max_abs_logits": lscale,
                  "rtol": 1e-3, "ok": lok})
            del hp, want, got
        del params
        torch.cuda.empty_cache()
        if dname == "bfloat16":
            out, stats = serve.main(["--scale", "gpu", "--arch", MOE_ARCH])
            good = (tuple(out.shape) == (4, 32) and int(out.min()) >= 0
                    and int(out.max()) < base.vocab_size)
            check(good, f"serve --arch {MOE_ARCH}: tokens "
                        f"{tuple(out.shape)}")
            emit({"phase": "moe", "part": "a", "step": "serve_gpu",
                  "arch": MOE_ARCH, "requests": 4, "prompt_len": 16,
                  "new_tokens": 32, "tokens_per_s": stats["tokens_per_s"],
                  "prefill_s": stats["prefill_s"],
                  "decode_s": stats["decode_s"], "ok": good,
                  "first_tokens": out[0, :8].tolist()})
            del out
            torch.cuda.empty_cache()
    return by_route, ms


def moe_train_path(dev, hbm, flops, smi):
    """Phase 9 (b), (c) -> the round-kernel launches of its runs.  (b)
    launch/train.py's train(args) for Granite at its train depth with
    phase 8's settings: m = 4 kernel vs plain histories, the main run at
    m = 8 (one launch a round at (8, 8, P)) (phase 8 (b) resumes
    train(args) from a checkpoint on the card; the CPU tests hold a Granite
    checkpoint's router leaves float32); (c) the group-mode step with
    remat, kernel vs plain, and the loss with remat (the block hands its
    aux back) equal to the loss without; then
    the round kernel timed at (8, 8, P) on a block of real Granite
    gradients (``train_kernel_timing``).  -> (launches, that timing)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    from repro_torch.sim.goldens import compare_traces
    t_phase = time.perf_counter()
    cfg = train_lib.train_config(MOE_ARCH, "gpu")
    P = cfg.param_count()
    launches = 0
    compared = {}
    for backend in ("auto", "fused_interpret"):
        compared[backend] = _train_run(_train_args(
            arch=MOE_ARCH, round_backend=backend, **TRAIN_COMPARED), dev)
    launches += compared["auto"][1]
    main_res, n_main, peak_main = _train_run(_train_args(arch=MOE_ARCH), dev)
    launches += n_main
    finite = all(math.isfinite(v) for row in main_res["history"]
                 for v in row.values())
    vs_plain = compare_traces(
        _compared(compared["auto"][0]["history"]),
        _compared(compared["fused_interpret"][0]["history"]))
    check(n_main == TRAIN_STEPS, f"granite train: {n_main} round-kernel "
                                 f"launches for {TRAIN_STEPS} rounds")
    check(finite and len(main_res["history"]) == TRAIN_STEPS,
          f"granite train: history {main_res['history']}")
    check(not vs_plain, f"granite train m=4: kernel vs plain {vs_plain[:3]}")
    check(compared["auto"][1] == TRAIN_STEPS
          and compared["fused_interpret"][1] == 0,
          f"granite train m=4: launches {compared['auto'][1]} (kernel), "
          f"{compared['fused_interpret'][1]} (plain)")
    emit({"phase": "moe", "part": "b", "arch": MOE_ARCH,
          "layers": cfg.num_layers, "params": P, "seq_len": TRAIN_SEQ,
          **TRAIN_MAIN, "num_batches": TRAIN_MAIN["workers"],
          "round_shape": [TRAIN_MAIN["workers"], TRAIN_MAIN["workers"], P],
          "steps": TRAIN_STEPS, "reduced": MOE_TRAIN_CUTS,
          "kernel_launches": n_main,
          "s_per_step": main_res["seconds"] / TRAIN_STEPS,
          "peak_mem_gb": peak_main, "loss_median": _curve(main_res),
          "agg_grad_norm": _curve(main_res, "agg_grad_norm"),
          "finite": finite, "compared_geometry": TRAIN_COMPARED,
          "compared": {b: {"launches": n, "peak_mem_gb": peak,
                           "s_per_step": r["seconds"] / TRAIN_STEPS,
                           "loss_median": _curve(r)}
                       for b, (r, n, peak) in compared.items()},
          "kernel_vs_plain_ok": not vs_plain, "card": smi})
    del compared
    group = {b: group_step_run(dev, b, arch=MOE_ARCH)
             for b in ("auto", "fused_interpret")}
    launches += group["auto"][1]
    vs_group = compare_traces(_compared(group["auto"][0]),
                              _compared(group["fused_interpret"][0]))
    check(not vs_group, f"granite group step: kernel vs plain "
                        f"{vs_group[:3]}")
    check(group["auto"][1] == TRAIN_GROUP["steps"]
          and group["fused_interpret"][1] == 0,
          f"granite group step: launches {group['auto'][1]}, "
          f"{group['fused_interpret'][1]}")
    # the loss with autograd recording, with and without remat
    torch.cuda.empty_cache()
    params = model.init(0, cfg, device=dev)
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=2, num_workers=1, device=dev).batch(0)
    one = {k: v[0] for k, v in batch.items()}
    losses = []
    with torch.enable_grad():
        for remat in (False, True):
            ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
            losses.append(model.loss_fn(ps, one,
                                        cfg.with_(remat=remat)).detach())
            del ps
    _, aux = model.forward(params, cfg, one)
    remat_ok = bool(torch.equal(losses[0], losses[1])) and float(aux) > 0
    check(remat_ok, f"granite loss with remat {float(losses[1])} vs without "
                    f"{float(losses[0])}, aux {float(aux)}")
    del params
    torch.cuda.empty_cache()
    emit({"phase": "moe", "part": "c", **TRAIN_GROUP, "remat": True,
          "kernel_vs_plain_ok": not vs_group,
          "loss_with_remat": float(losses[1]),
          "loss_without_remat": float(losses[0]), "aux": float(aux),
          "remat_keeps_aux": remat_ok,
          "runs": {b: {"history": rows, "launches": n, "s_per_step": s,
                       "peak_mem_gb": peak}
                   for b, (rows, n, s, peak) in group.items()},
          "seconds": time.perf_counter() - t_phase})
    return launches, train_kernel_timing(dev, hbm, flops, smi, arch=MOE_ARCH)


def kimi_dispatch(dev):
    """Phase 9 (d): Kimi-K2's router (E = 384, D = 7168, top-8) on
    KIMI_TOKENS random tokens with a random float32 router: the card's
    top_ids equal the CPU's except at near ties (TIE_ULPS); on the CPU's
    top_ids/top_w the card's dispatch (expert buffers, slots, experts,
    weights) is bitwise the CPU's; ms of the router and of the dispatch
    on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, moe
    cfg = get_config(KIMI_ARCH)
    spec = blocks.moe_spec(cfg)
    E, D, N = cfg.num_experts, cfg.d_model, KIMI_TOKENS
    C = moe._capacity(spec, N)
    gen = torch.Generator().manual_seed(384)
    router = torch.randn(D, E, generator=gen) * D ** -0.5
    x = torch.randn(N, D, generator=gen)
    ids, w, aux, z = moe.route({"router": router}, spec, x)
    on_card = {"router": router.to(dev)}
    xc = x.to(dev)
    cids, cw, caux, cz = moe.route(on_card, spec, xc)
    route_ms = timed(lambda: moe.route(on_card, spec, xc), repeats=5)
    probs = torch.softmax(x @ router, dim=-1)
    differ = (cids.cpu() != ids).nonzero().tolist()
    gaps = [float((probs[n, ids[n, j]] - probs[n, cids[n, j]]).abs())
            / float(np.spacing(np.float32(probs[n, ids[n, j]])))
            for n, j in differ]
    ties_ok = all(g <= TIE_ULPS for g in gaps)
    check(ties_ok, f"kimi router: card top_ids differ from the CPU's at "
                   f"{len(differ)} entries, gaps {gaps[:5]} ulps")
    want_in, want = moe._dispatch_local(spec, x, ids, w, expert_lo=0,
                                        num_local=E, capacity=C)
    idc, wc = ids.to(dev), w.to(dev)
    got_in, got = moe._dispatch_local(spec, xc, idc, wc, expert_lo=0,
                                      num_local=E, capacity=C)
    dispatch_ms = timed(lambda: moe._dispatch_local(
        spec, xc, idc, wc, expert_lo=0, num_local=E, capacity=C),
        repeats=5)
    equal = bool(torch.equal(got_in.cpu(), want_in)) and all(
        bool(torch.equal(a.cpu(), b)) for a, b in zip(got, want))
    kept = int((want[3] != 0).sum())
    check(equal, "kimi dispatch: the card's slots, keep mask or buffers "
                 "differ from the CPU's on the same routing")
    emit({"phase": "moe", "part": "d", "arch": KIMI_ARCH, "experts": E,
          "top_k": spec.experts_per_token, "d_model": D, "tokens": N,
          "capacity": C, "kept_assignments": kept,
          "assignments": N * spec.experts_per_token,
          "top_ids_differ": len(differ), "tie_gaps_ulps": gaps[:16],
          "ties_ok": ties_ok, "dispatch_bitwise_equal": equal,
          "aux": [float(aux), float(caux)], "z": [float(z), float(cz)],
          "route_ms": route_ms, "dispatch_ms": dispatch_ms})
    del want_in, got_in, xc, on_card
    torch.cuda.empty_cache()


def moe_path(dev, hbm, flops, smi):
    """Phase 9 -> (round-kernel launches, flash launches by dtype and
    route, the round kernel's timing at Granite's (8, 8, P))."""
    t0 = time.perf_counter()
    attn_routes, prefill_ms = moe_serve_path(dev)
    launches, timing = moe_train_path(dev, hbm, flops, smi)
    kimi_dispatch(dev)
    emit({"phase": "moe", "seconds": time.perf_counter() - t0,
          "round_kernel_launches": launches,
          "flash_launches_by_route": attn_routes,
          "granite_prefill_ms": prefill_ms})
    return launches, attn_routes, timing


# -- phase 10: the recurrent families (RWKV6, Zamba2) ------------------------

def _serve_gpu(arch, vocab):
    """launch/serve.py --arch ``arch`` --scale gpu: (ok, its stats line)."""
    from repro_torch.launch import serve
    out, stats = serve.main(["--scale", "gpu", "--arch", arch])
    good = (tuple(out.shape) == (4, 32) and int(out.min()) >= 0
            and int(out.max()) < vocab)
    check(good, f"serve --arch {arch}: tokens {tuple(out.shape)}")
    return {"arch": arch, "requests": 4, "prompt_len": 16, "new_tokens": 32,
            "tokens_per_s": stats["tokens_per_s"],
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "decode_ms_per_step": stats["decode_s"] * 1e3 / 31, "ok": good,
            "first_tokens": out[0, :8].tolist()}


def _prefill_vs_decode(params, cfg, prompts):
    """The kernel-path prefill's last-position logits against the logits
    the decode loop reaches after the same prompt: (err, max|logits|)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    hp = steps.make_prefill_step(cfg)(params, {"tokens": prompts})
    want = model._unembed_fn(params, cfg)(hp[:, -1:])
    _, got, _ = serve.generate(params, cfg, prompts, 1)
    return float((got - want).abs().max()), float(want.abs().max())


def rwkv_serve_path(dev):
    """Phase 10 (a), RWKV6-7B at full width and depth: the recurrence at
    one layer's shape in f32 (``wkv_chunked`` vs ``wkv_scan``); the bf16
    prefill step at B = 1, T = PREFILL_T; serve --arch rwkv6-7b --scale
    gpu; in f32 at RWKV_DECODE_LAYERS layers a RWKV_DECODE_T-token
    prefill's last logits against as
    many decode steps (the chunked path against the token-by-token path
    through the whole model); the reduced model on the card against the
    CPU."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model, rwkv
    t_phase = time.perf_counter()
    base = get_config(RWKV_ARCH)
    H, hd = base.d_model // base.ssm_head_dim, base.ssm_head_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T),
                           generator=gen, device=dev)
    shape = (1, PREFILL_T, H, hd)
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(
        torch.randn(shape, generator=gen, device=dev) * 0.5 - 0.6))
    u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
    s0 = torch.zeros((1, H, hd, hd), device=dev)
    (y, S), chunked_ms = _synced_ms(
        lambda: rwkv.wkv_chunked(r, k, v, w, u, s0), dev)
    (ys, Ss), scan_ms = _synced_ms(
        lambda: rwkv.wkv_scan(r, k, v, w, u, s0), dev)
    wkv_err = float((y - ys).abs().max())
    wkv_scale = float(ys.abs().max())
    state_err = float((S - Ss).abs().max()) / float(Ss.abs().max())
    wkv_ok = wkv_err <= WKV_RTOL * wkv_scale
    check(wkv_ok, f"rwkv wkv_chunked vs wkv_scan at {shape}: max_abs_err "
                  f"{wkv_err} (max|y| {wkv_scale})")
    emit({"phase": "recurrent", "part": "a", "step": "wkv",
          "shape": list(shape), "chunked_ms": chunked_ms,
          "scan_ms": scan_ms, "max_abs_err": wkv_err, "max_abs_y": wkv_scale,
          "state_rel_err": state_err, "rtol": WKV_RTOL, "ok": wkv_ok})
    del r, k, v, w, y, ys, S, Ss
    # the bf16 prefill, the main path's run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_ms = _synced_ms(lambda: model.init(0, base, device=dev), dev)
    step = steps.make_prefill_step(base)
    _prefill_ms(step, params, {"tokens": tokens[:, :256]}, dev)
    h, ms = _prefill_ms(step, params, {"tokens": tokens}, dev)
    finite = bool(torch.isfinite(h).all())
    check(finite and h.shape == (1, PREFILL_T, base.d_model),
          f"rwkv prefill bf16: output {tuple(h.shape)}, finite {finite}")
    emit({"phase": "recurrent", "part": "a", "step": "prefill",
          "arch": RWKV_ARCH, "dtype": "bfloat16", "batch": 1,
          "seq_len": PREFILL_T, "num_layers": base.num_layers,
          "params": base.param_count(), "reduced": PREFILL_CUTS[:1],
          "init_ms": init_ms, "ms_per_prefill": ms, "finite": finite,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    del params, h
    torch.cuda.empty_cache()
    emit({"phase": "recurrent", "part": "a", "step": "serve_gpu",
          **_serve_gpu(RWKV_ARCH, base.vocab_size)})
    torch.cuda.empty_cache()
    # f32: the chunked prefill against the token-by-token decode
    cfg = base.with_(dtype=torch.float32, param_dtype=torch.float32,
                     num_layers=RWKV_DECODE_LAYERS)
    params = model.init(0, cfg, device=dev)
    prompts = tokens[:, :RWKV_DECODE_T]
    (lerr, lscale), pd_ms = _synced_ms(
        lambda: _prefill_vs_decode(params, cfg, prompts), dev)
    lok = lerr <= 1e-3 * lscale
    check(lok, f"rwkv prefill vs decode logits (f32, T={RWKV_DECODE_T}): "
               f"max_abs_err {lerr} (max|logits| {lscale})")
    del params
    torch.cuda.empty_cache()
    # the reduced model on the card against the CPU
    rcfg = base.reduced()
    cpu_params = model.init(0, rcfg, device="cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    rtok = torch.randint(0, rcfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(3))
    h_cpu, _ = model.forward(cpu_params, rcfg, {"tokens": rtok})
    h_card, _ = model.forward(card_params, rcfg, {"tokens": rtok.to(dev)})
    cerr = float((h_card.cpu() - h_cpu).abs().max())
    cscale = float(h_cpu.abs().max())
    cok = cerr <= CARD_VS_CPU_RTOL * cscale
    check(cok, f"rwkv reduced forward card vs CPU: max_abs_err {cerr} "
               f"(max|h| {cscale})")
    emit({"phase": "recurrent", "part": "a", "step": "prefill_vs_decode",
          "dtype": "float32", "prompt_len": RWKV_DECODE_T,
          "num_layers": cfg.num_layers,
          "max_abs_err": lerr, "max_abs_logits": lscale, "rtol": 1e-3,
          "ok": lok, "ms": pd_ms,
          "card_vs_cpu": {"max_abs_err": cerr, "max_abs_h": cscale,
                          "rtol": CARD_VS_CPU_RTOL, "ok": cok},
          "seconds": time.perf_counter() - t_phase})
    return ms


def zamba_serve_path(dev):
    """Phase 10 (b), Zamba2-2.7B at full width and depth -> ({dtype: the
    flash kernel's launches by route in the kernel-path prefill}, bf16
    prefill ms).  The prefill step at B = 1, T = PREFILL_T in bf16 and
    f32: the kernel path (the main path's run: one flash launch per
    shared-block application on the dtype's route) against the plain
    path under PREFILL_RTOL; in f32 the served prompts' prefill logits
    against the decode loop's; serve --arch zamba2-2.7b --scale gpu."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    from repro_torch.models import model
    base = get_config(ZAMBA_ARCH)
    G = base.num_layers // base.shared_attn_every
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T),
                           generator=gen, device=dev)
    prompts = torch.randint(0, base.vocab_size, (4, 16), generator=gen,
                            device=dev)
    by_route, ms = {}, {}
    for dname in ("bfloat16", "float32"):
        cfg = base.with_(dtype=getattr(torch, dname),
                         param_dtype=getattr(torch, dname))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(0, cfg, device=dev)
        scalars = {n: params["mamba"][n].dtype
                   for n in ("A_log", "dt_bias", "D")}
        check(set(scalars.values()) == {torch.float32},
              f"zamba2 {dname}: SSM scalars {scalars}")
        kernel_step = steps.make_prefill_step(cfg)
        plain_step = steps.make_prefill_step(cfg, plain=True)
        _prefill_ms(kernel_step, params, {"tokens": tokens[:, :256]}, dev)
        flash.reset_launches()
        h, ms_kernel = _prefill_ms(kernel_step, params, {"tokens": tokens},
                                   dev)
        n_prefill = flash.flash_attention.launches
        routes = by_route[dname] = dict(flash.flash_attention.route_launches)
        ms[dname] = ms_kernel
        h_plain, ms_plain = _prefill_ms(plain_step, params,
                                        {"tokens": tokens}, dev)
        plain_launches = flash.flash_attention.launches - n_prefill
        scale = float(h_plain.float().abs().max())
        err = float((h.float() - h_plain.float()).abs().max())
        ok = err <= PREFILL_RTOL[dname] * scale
        finite = bool(torch.isfinite(h).all())
        want_route = "tensor_core" if dname == "bfloat16" else "cuda_core"
        check(ok, f"zamba2 prefill {dname}: kernel vs plain max_abs_err "
                  f"{err} (max|h| {scale}, rtol {PREFILL_RTOL[dname]})")
        check(finite and h.shape == (1, PREFILL_T, cfg.d_model),
              f"zamba2 prefill {dname}: output {tuple(h.shape)}, finite "
              f"{finite}")
        check(n_prefill == G and plain_launches == 0
              and routes == {r: G * (r == want_route) for r in routes},
              f"zamba2 prefill {dname}: launches by route {routes} (want "
              f"{G} on {want_route}), plain path {plain_launches}")
        line = {"phase": "recurrent", "part": "b", "step": "prefill",
                "arch": cfg.name, "dtype": dname, "batch": 1,
                "seq_len": PREFILL_T, "num_layers": cfg.num_layers,
                "shared_block_applications": G, "params":
                cfg.param_count(), "reduced": PREFILL_CUTS[:1],
                "kernel_launches": n_prefill, "launches_by_route": routes,
                "ms_per_prefill": {"kernel": ms_kernel, "plain": ms_plain},
                "max_abs_err": err, "max_abs_h": scale,
                "rel_err": err / scale, "rtol": PREFILL_RTOL[dname],
                "ok": ok,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del h, h_plain
        if dname == "float32":
            flash.reset_launches()
            lerr, lscale = _prefill_vs_decode(params, cfg, prompts)
            n_check = flash.flash_attention.launches
            lok = lerr <= 1e-3 * lscale
            check(lok and n_check == G,
                  f"zamba2 prefill vs decode logits (f32): max_abs_err "
                  f"{lerr} (max|logits| {lscale}), {n_check} launches")
            line["prefill_vs_decode"] = {
                "prompts": list(prompts.shape), "max_abs_err": lerr,
                "max_abs_logits": lscale, "rtol": 1e-3, "ok": lok}
        emit(line)
        del params
        torch.cuda.empty_cache()
        if dname == "bfloat16":
            emit({"phase": "recurrent", "part": "b", "step": "serve_gpu",
                  **_serve_gpu(ZAMBA_ARCH, base.vocab_size)})
            torch.cuda.empty_cache()
    return by_route, ms


def train_at_depth(dev, hbm, flops, smi, arch=ZAMBA_ARCH,
                   cuts=ZAMBA_TRAIN_CUTS, phase="recurrent", part="c"):
    """Phase 10 (c), phase 11 (b): launch/train.py's train(args) for
    ``arch`` at its train depth (Zamba2: 6 layers; SeamlessM4T: 1 encoder
    and 1 decoder layer; remat as the config has it) with phase 8's
    settings: m = 4 kernel vs plain histories, the main run at m = 8 (one
    launch a round at (8, 8, P)); then the round kernel timed at (8, 8, P)
    on a block of real gradients of ``arch`` (phase 8 (b) resumes
    train(args) from a checkpoint on the card).  -> (launches, that
    timing)."""
    from repro_torch.launch import train as train_lib
    from repro_torch.sim.goldens import compare_traces
    t_phase = time.perf_counter()
    cfg = train_lib.train_config(arch, "gpu")
    launches = 0
    compared = {}
    for backend in ("auto", "fused_interpret"):
        compared[backend] = _train_run(_train_args(
            arch=arch, round_backend=backend, **TRAIN_COMPARED), dev)
    launches += compared["auto"][1]
    main_res, n_main, peak_main = _train_run(_train_args(arch=arch), dev)
    launches += n_main
    finite = all(math.isfinite(v) for row in main_res["history"]
                 for v in row.values())
    vs_plain = compare_traces(
        _compared(compared["auto"][0]["history"]),
        _compared(compared["fused_interpret"][0]["history"]))
    check(n_main == TRAIN_STEPS, f"{arch} train: {n_main} round-kernel "
                                 f"launches for {TRAIN_STEPS} rounds")
    check(finite and len(main_res["history"]) == TRAIN_STEPS,
          f"{arch} train: history {main_res['history']}")
    check(not vs_plain, f"{arch} train m=4: kernel vs plain {vs_plain[:3]}")
    check(compared["auto"][1] == TRAIN_STEPS
          and compared["fused_interpret"][1] == 0,
          f"{arch} train m=4: launches {compared['auto'][1]} (kernel), "
          f"{compared['fused_interpret'][1]} (plain)")
    timing = train_kernel_timing(dev, hbm, flops, smi, arch=arch)
    m = TRAIN_MAIN["workers"]
    emit({"phase": phase, "part": part, "arch": arch,
          "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
          "remat": cfg.remat, "params": cfg.param_count(),
          "param_leaves": timing["shape"][2], "seq_len": TRAIN_SEQ,
          **TRAIN_MAIN,
          "num_batches": m, "round_shape": list(timing["shape"]),
          "steps": TRAIN_STEPS, "reduced": cuts,
          "kernel_launches": n_main,
          "s_per_step": main_res["seconds"] / TRAIN_STEPS,
          "peak_mem_gb": peak_main, "loss_median": _curve(main_res),
          "agg_grad_norm": _curve(main_res, "agg_grad_norm"),
          "finite": finite, "compared_geometry": TRAIN_COMPARED,
          "compared": {b: {"launches": n, "peak_mem_gb": peak,
                           "s_per_step": r["seconds"] / TRAIN_STEPS,
                           "loss_median": _curve(r)}
                       for b, (r, n, peak) in compared.items()},
          "kernel_vs_plain_ok": not vs_plain,
          "card": smi, "seconds": time.perf_counter() - t_phase})
    return launches, timing


def reduced_rounds(dev, arch, backend, seed=0):
    """RWKV_TRAIN's rounds of ``arch``'s reduced config on the card
    through make_run_rounds (gmom under sign_flip, the rotating schedule,
    AdamW 1e-3) -> (history rows, round-kernel launches, s a round)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch import configs, optim
    from repro_torch import random as prng
    from repro_torch.core import (RobustConfig, init_train_state,
                                  make_run_rounds, schedule_from_config)
    from repro_torch.core.train_state import advance, history_rows
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    s = RWKV_TRAIN
    cfg = configs.get_config(arch).reduced()
    rc = RobustConfig(num_workers=s["m"], num_byzantine=s["q"],
                      attack="sign_flip", aggregator="gmom",
                      num_batches=s["k"], round_backend=backend)
    opt = optim.adamw(1e-3)
    schedule = schedule_from_config(rc)
    run = make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg), opt, rc,
                          schedule=schedule, device=dev)
    params = model.init(seed, cfg, device=dev)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=s["seq_len"],
                         global_batch=s["batch"], num_workers=s["m"],
                         seed=seed, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    batch = tree_map(lambda *xs: torch.stack(xs), *[
        train_lib.build_cpu_batch(cfg, stream, i, prng.fold_in(key, i))
        for i in range(s["steps"])])
    state = init_train_state(
        params, opt.init(params),
        prng.fold_in(prng.PRNGKey(seed, device=dev), 10_000),
        schedule=schedule)
    rk.round_aggregate_kernel.launches = 0
    (state, _), ms = _synced_ms(
        lambda: advance(run, state, batch, per_round_batches=True), dev)
    return (history_rows(state.history), rk.round_aggregate_kernel.launches,
            ms / 1e3 / s["steps"])


def refused_card_train(dev, arch=RWKV_ARCH, phase="recurrent", part="d"):
    """Phase 10 (d), phase 11 (c): ``train --arch <arch> --scale gpu`` is
    refused, naming item 16.13 (several cards); the reduced config's
    rounds on the card
    through the round kernel, kernel vs plain histories within
    compare_traces.  -> round-kernel launches."""
    from repro_torch.launch import train as train_lib
    from repro_torch.sim.goldens import compare_traces
    try:
        train_lib.train(train_lib.parse_args(
            ["--arch", arch, "--scale", "gpu", "--steps", "1"]))
        refusal = None
    except NotImplementedError as exc:
        refusal = str(exc)
    refused = refusal is not None and "16.13" in refusal
    check(refused, f"train --arch {arch} --scale gpu: {refusal}")
    runs = {b: reduced_rounds(dev, arch, b)
            for b in ("auto", "fused_interpret")}
    vs_plain = compare_traces(_compared(runs["auto"][0]),
                              _compared(runs["fused_interpret"][0]))
    finite = all(math.isfinite(v) for row in runs["auto"][0]
                 for v in row.values())
    steps_ = RWKV_TRAIN["steps"]
    check(not vs_plain and finite,
          f"{arch} reduced rounds: kernel vs plain {vs_plain[:3]}, finite "
          f"{finite}")
    check(runs["auto"][1] == steps_ and runs["fused_interpret"][1] == 0,
          f"{arch} reduced rounds: launches {runs['auto'][1]}, "
          f"{runs['fused_interpret'][1]}")
    emit({"phase": phase, "part": part, "arch": arch,
          "gpu_scale_refused": refused,
          "refusal": refusal, "setting": RWKV_TRAIN,
          "kernel_vs_plain_ok": not vs_plain,
          "runs": {b: {"loss_median": [r["loss_median"] for r in rows],
                       "launches": n, "s_per_round": sec}
                   for b, (rows, n, sec) in runs.items()}})
    return runs["auto"][1]


def _grads_with_and_without_remat(cfg, params, batch, dev):
    """per_worker_grads of ``cfg`` without remat, then with (the larger
    peak first, while nothing of the other is held) -> (equal, the peak
    GB each allocated above what was live before it)."""
    import torch
    from repro_torch.core import robust_train
    from repro_torch.models import model
    runs, peak = [], {}
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        runs.append(robust_train.per_worker_grads(
            lambda p, b: model.loss_fn(p, b, c), params, batch))
        torch.cuda.synchronize(dev)
        peak[remat] = (torch.cuda.max_memory_allocated(dev) - live) / 1e9
    equal = all(bool(torch.equal(a, b)) for a, b in zip(
        torch.utils._pytree.tree_leaves(runs[0]),
        torch.utils._pytree.tree_leaves(runs[1])))
    return equal, peak


def remat_on_card(dev):
    """Phase 10 (e): per_worker_grads (vmap of grad) with remat torch.equal
    to without, at Granite reduced and Zamba2 reduced on the card; then at
    the main path's m = 8 and 2 x TRAIN_SEQ tokens a worker, at the train
    depth of H2O, Granite and Zamba2, equal too, with the peak GB each
    allocates above the params and the batch, with remat and without."""
    import torch
    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    out, peaks_gb = {}, {}
    for arch in (MOE_ARCH, ZAMBA_ARCH):
        cfg = configs.get_config(arch).reduced()
        params = model.init(0, cfg, device=dev)
        batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=8, num_workers=4,
                            device=dev).batch(0)
        equal, _ = _grads_with_and_without_remat(cfg, params, batch, dev)
        check(equal, f"{arch} reduced: per_worker_grads with remat differ "
                     "from without")
        out[arch] = equal
    m = TRAIN_MAIN["workers"]
    for arch in (TRAIN_ARCH, MOE_ARCH, ZAMBA_ARCH):
        cfg = train_lib.train_config(arch, "gpu")
        params = model.init(0, cfg, device=dev)
        batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=2 * m, num_workers=m,
                            device=dev).batch(0)
        equal, peak = _grads_with_and_without_remat(cfg, params, batch, dev)
        check(equal, f"{arch} at {cfg.num_layers} layers, m = {m}: "
                     "per_worker_grads with remat differ from without")
        out[f"{arch} train depth"] = equal
        peaks_gb[arch] = {"layers": cfg.num_layers, "remat": peak[True],
                          "no_remat": peak[False]}
        del params, batch
        torch.cuda.empty_cache()
    emit({"phase": "recurrent", "part": "e", "remat_equal": out,
          "per_worker_grads_peak_gb_above_params": peaks_gb,
          "workers": m, "seq_len": TRAIN_SEQ, "sequences_a_worker": 2})


def recurrent_path(dev, hbm, flops, smi):
    """Phase 10 -> (round-kernel launches, flash launches by dtype and
    route, the round kernel's timing at Zamba2's (8, 8, P), RWKV6's and
    Zamba2's bf16 prefill ms)."""
    t0 = time.perf_counter()
    rwkv_ms = rwkv_serve_path(dev)
    attn_routes, zamba_ms = zamba_serve_path(dev)
    launches, timing = train_at_depth(dev, hbm, flops, smi)
    launches += refused_card_train(dev)
    remat_on_card(dev)
    emit({"phase": "recurrent", "seconds": time.perf_counter() - t0,
          "round_kernel_launches": launches,
          "flash_launches_by_route": attn_routes,
          "prefill_ms": {"rwkv6_bf16": rwkv_ms, "zamba2": zamba_ms}})
    return launches, attn_routes, timing


# -- phase 11: the audio and VLM families (SeamlessM4T, InternVL2) -----------

def _stub(kind, cfg, n, dev, seed=7):
    """(1, n, D) float32 frames (``kind`` "frames") or patches from
    data/tokens.py's stubs, on the card."""
    import torch
    from repro_torch import random as prng
    from repro_torch.data import tokens
    fn = (tokens.frame_embeddings if kind == "frames"
          else tokens.patch_embeddings)
    size = {"num_frames" if kind == "frames" else "num_patches": n}
    return fn(prng.PRNGKey(seed, device=dev), num_workers=1, per_worker=1,
              d_model=cfg.d_model, dtype=torch.float32, **size)[0]


@contextlib.contextmanager
def causal_encoder():
    """The planted fault: the audio encoder's self-attention made causal
    (``blocks.encoder_attn_spec``, which ``encoder_block`` reads)."""
    import dataclasses
    from repro_torch.models import blocks
    spec = blocks.encoder_attn_spec
    blocks.encoder_attn_spec = lambda cfg: dataclasses.replace(spec(cfg),
                                                               causal=True)
    try:
        yield
    finally:
        blocks.encoder_attn_spec = spec


def _prefill_pair(cfg, params, batch, warm, dev, want_launches, dname, tag):
    """The prefill step's kernel path (the flash counts zeroed just before,
    read just after) against its plain path on ``batch`` under
    PREFILL_RTOL -> (line, launches by route, h_plain, max|h_plain|)."""
    import torch
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    kernel_step = steps.make_prefill_step(cfg)
    plain_step = steps.make_prefill_step(cfg, plain=True)
    _prefill_ms(kernel_step, params, warm, dev)
    flash.reset_launches()
    h, ms_kernel = _prefill_ms(kernel_step, params, batch, dev)
    n_prefill = flash.flash_attention.launches
    routes = dict(flash.flash_attention.route_launches)
    h_plain, ms_plain = _prefill_ms(plain_step, params, batch, dev)
    plain_launches = flash.flash_attention.launches - n_prefill
    scale = float(h_plain.float().abs().max())
    err = float((h.float() - h_plain.float()).abs().max())
    ok = err <= PREFILL_RTOL[dname] * scale
    finite = bool(torch.isfinite(h).all())
    T = batch["tokens"].shape[1]
    want_route = "tensor_core" if dname == "bfloat16" else "cuda_core"
    check(ok, f"{tag} prefill {dname}: kernel vs plain max_abs_err {err} "
              f"(max|h| {scale}, rtol {PREFILL_RTOL[dname]})")
    check(finite and h.shape == (1, T, cfg.d_model),
          f"{tag} prefill {dname}: output {tuple(h.shape)}, finite {finite}")
    check(n_prefill == want_launches and plain_launches == 0
          and routes == {r: want_launches * (r == want_route)
                         for r in routes},
          f"{tag} prefill {dname}: launches by route {routes} (want "
          f"{want_launches} on {want_route}), plain path {plain_launches}")
    line = {"arch": cfg.name, "dtype": dname, "batch": 1, "seq_len": T,
            "num_layers": cfg.num_layers, "params": cfg.param_count(),
            "kernel_launches": n_prefill, "launches_by_route": routes,
            "ms_per_prefill": {"kernel": ms_kernel, "plain": ms_plain},
            "max_abs_err": err, "max_abs_h": scale, "rel_err": err / scale,
            "rtol": PREFILL_RTOL[dname], "ok": ok,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del h
    return line, routes, h_plain, scale


def _audio_prefill_vs_decode(params, cfg, tokens, frames):
    """The kernel path's last-position logits against the decode loop's
    with ``state["memory"]`` set to the encoder's output for the same
    frames: (err, max|logits|)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model
    dev = tokens.device
    hp = steps.make_prefill_step(cfg)(params, {"tokens": tokens,
                                               "frames": frames})
    want = model._unembed_fn(params, cfg)(hp[:, -1:])
    B, T = tokens.shape
    state = model.init_decode_state(cfg, B, T, device=dev)
    with torch.no_grad():
        state["memory"] = model._run_encoder(params, cfg, frames,
                                             plain=False)
    step = steps.make_serve_step(cfg)
    for t in range(T):
        got, state = step(params, state, tokens[:, t:t + 1],
                          torch.full((B,), t, device=dev))
    return float((got - want).abs().max()), float(want.abs().max())


def audio_serve_path(dev):
    """Phase 11 (a), SeamlessM4T-medium at full width and depth -> ({dtype:
    the flash launches by route in the kernel-path prefill}, {dtype: its
    ms}).  The prefill at B = 1, T = PREFILL_T tokens and T / 4 frames in
    bf16 (the main path's run) and f32: kernel path vs plain path, 36
    launches (encoder, decoder self- and cross-attention); in f32 the
    encoder made causal must fail the check, and a short prefill's last
    logits are held against the decode loop with the encoder's memory;
    serve --arch seamless-m4t-medium --scale gpu."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model
    base = get_config(AUDIO_ARCH)
    launches = 2 * base.num_layers + base.encoder_layers
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T),
                           generator=gen, device=dev)
    frames = _stub("frames", base, PREFILL_T // base.encoder_seq_divisor,
                   dev)
    batch = {"tokens": tokens, "frames": frames}
    warm = {"tokens": tokens[:, :256], "frames": frames[:, :64]}
    by_route, ms = {}, {}
    for dname in ("bfloat16", "float32"):
        cfg = base.with_(dtype=getattr(torch, dname),
                         param_dtype=getattr(torch, dname))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params, init_ms = _synced_ms(lambda: model.init(0, cfg, device=dev),
                                     dev)
        line, by_route[dname], h_plain, scale = _prefill_pair(
            cfg, params, batch, warm, dev, launches, dname, "seamless")
        ms[dname] = line["ms_per_prefill"]["kernel"]
        line.update(phase="audio_vlm", part="a", step="prefill",
                    frames=frames.shape[1], encoder_layers=cfg.encoder_layers,
                    init_ms=init_ms, reduced=PREFILL_CUTS[:1])
        if dname == "float32":
            with causal_encoder():
                h_bad = steps.make_prefill_step(cfg)(params, batch)
            fault = float((h_bad.float() - h_plain.float()).abs().max())
            fails = fault > PREFILL_RTOL[dname] * scale
            check(fails, f"seamless prefill f32: the planted fault (a causal "
                         f"encoder) passed, rel_err {fault / scale}")
            line["planted_fault"] = {"fault": "causal encoder",
                                     "rel_err": fault / scale,
                                     "fails_rtol": fails}
            del h_bad
            n_tok, n_frames = AUDIO_DECODE
            lerr, lscale = _audio_prefill_vs_decode(
                params, cfg, tokens[:, :n_tok], frames[:, :n_frames])
            lok = lerr <= 1e-3 * lscale
            check(lok, f"seamless prefill vs decode logits (f32): "
                       f"max_abs_err {lerr} (max|logits| {lscale})")
            line["prefill_vs_decode"] = {
                "tokens": n_tok, "frames": n_frames, "max_abs_err": lerr,
                "max_abs_logits": lscale, "rtol": 1e-3, "ok": lok}
        emit(line)
        del params, h_plain
        torch.cuda.empty_cache()
        if dname == "bfloat16":
            emit({"phase": "audio_vlm", "part": "a", "step": "serve_gpu",
                  **_serve_gpu(AUDIO_ARCH, base.vocab_size)})
            torch.cuda.empty_cache()
    return by_route, ms


def vlm_serve_path(dev):
    """Phase 11 (c), InternVL2-26B at full width -> ({dtype: the flash
    launches by route in the kernel-path prefill}, {dtype: its ms}).  The
    bf16 prefill at B = 1, 256 patches + 7936 tokens at full depth (48
    launches; the main path's run), kernel vs plain; the same in f32 at
    VLM_F32_LAYERS layers; serve --arch internvl2-26b --scale gpu."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    base = get_config(VLM_ARCH)
    P = base.num_patches
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, base.vocab_size, (1, PREFILL_T - P),
                           generator=gen, device=dev)
    patches = _stub("patches", base, P, dev)
    batch = {"tokens": tokens, "patches": patches}
    warm = {"tokens": tokens[:, :256], "patches": patches}
    by_route, ms = {}, {}
    for dname, layers, cuts in (
            ("bfloat16", base.num_layers, PREFILL_CUTS[:1]),
            ("float32", VLM_F32_LAYERS, PREFILL_CUTS[:1] + VLM_F32_CUTS)):
        cfg = base.with_(num_layers=layers, dtype=getattr(torch, dname),
                         param_dtype=getattr(torch, dname))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params, init_ms = _synced_ms(lambda: model.init(0, cfg, device=dev),
                                     dev)
        line, by_route[dname], h_plain, _ = _prefill_pair(
            cfg, params, batch, warm, dev, layers, dname, "internvl2")
        ms[dname] = line["ms_per_prefill"]["kernel"]
        line.update(phase="audio_vlm", part="c", step="prefill",
                    patches=P, positions=P + tokens.shape[1],
                    init_ms=init_ms, reduced=cuts)
        emit(line)
        del params, h_plain
        torch.cuda.empty_cache()
        if dname == "bfloat16":
            emit({"phase": "audio_vlm", "part": "c", "step": "serve_gpu",
                  **_serve_gpu(VLM_ARCH, base.vocab_size)})
            torch.cuda.empty_cache()
    return by_route, ms


def audio_vlm_path(dev, hbm, flops, smi):
    """Phase 11 -> (round-kernel launches, flash launches by dtype and
    route, the round kernel's timing at SeamlessM4T's (8, 8, P))."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 1e9
    audio_routes, audio_ms = audio_serve_path(dev)
    launches, timing = train_at_depth(
        dev, hbm, flops, smi, arch=AUDIO_ARCH, cuts=AUDIO_TRAIN_CUTS,
        phase="audio_vlm", part="b")
    vlm_routes, vlm_ms = vlm_serve_path(dev)
    launches += refused_card_train(dev, VLM_ARCH, phase="audio_vlm",
                                   part="c")
    routes = {d: {r: audio_routes[d][r] + vlm_routes[d][r]
                  for r in audio_routes[d]} for d in audio_routes}
    emit({"phase": "audio_vlm", "seconds": time.perf_counter() - t0,
          "gb_held_before": held, "round_kernel_launches": launches,
          "flash_launches_by_route": routes,
          "prefill_ms": {"seamless": audio_ms, "internvl2": vlm_ms}})
    return launches, routes, timing


# -- phases 12-15: the model mesh on rank processes of the card -------------

def _mesh_ranks_of(body, args, t0):
    """Inside a mesh phase (a generator that ``mesh_phases`` drives): hand
    over the phase's rank body (its name in this module) and arguments,
    and take back each rank's result and the body's seconds on rank 0.
    -> (the results in rank order, those seconds, ``t0`` moved on by the
    time the phase waited for the other phases' work, so that the phase's
    "seconds" count its own: before, its ranks, after)."""
    waited = time.perf_counter()
    per_rank, body_s = yield body, args
    return per_rank, body_s, t0 + (time.perf_counter() - waited) - body_s


def _mesh_phase_ranks(rank, world, device, bodies):
    """Phases 12-15 on one rank of the card: each phase's rank body in
    turn, in this one process -> [(its result, its seconds)]."""
    import torch
    out = []
    for name, args in bodies:
        t0 = time.perf_counter()
        res = globals()[name](rank, world, device, *args)
        torch.cuda.empty_cache()
        out.append((res, time.perf_counter() - t0))
    return out


def mesh_phases(dev, hbm, smi, started):
    """Phases 12-16 and 18 (a) on MESH_RANKS rank processes of the card,
    started once (a start took 10-15 s, and each phase's first calls on
    the card as many again): every phase's kernel checks and one-process
    references first (each phase's code up to its rank body), then one
    ``ranks.run`` that runs the six rank bodies in turn, then each
    phase's checks (phase 18's with ``started``'s traces, from
    ``dry_run_start``).  -> the six phases' returns."""
    import torch
    from repro_torch.launch import ranks
    phases = (mesh_path(dev, hbm, smi), mesh_train_path(dev, smi),
              mesh_families_path(dev, hbm, smi), mesh_decode_path(dev, smi),
              mesh_whole_path(dev, smi), sweep_path(dev, smi, started))
    bodies = []
    for phase in phases:
        bodies.append(next(phase))
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = ranks.run(_mesh_phase_ranks, MESH_RANKS, dev.type, bodies,
                         timeout=1800.0)
    emit({"phase": "mesh_ranks", "ranks": MESH_RANKS,
          "seconds": time.perf_counter() - t0,
          "body_s": {name: per_rank[0][i][1]
                     for i, (name, _) in enumerate(bodies)}, "card": smi})
    out = []
    for i, phase in enumerate(phases):
        try:
            phase.send(([pr[i][0] for pr in per_rank], per_rank[0][i][1]))
        except StopIteration as stop:
            out.append(stop.value)
        else:
            raise RuntimeError(f"mesh phase {(12, 13, 14, 15, 16, 18)[i]} "
                               "handed over a second rank body")
    return out


# -- phase 12: the model mesh -------------------------------------------------

# rank processes of the one card over gloo (NCCL refuses two ranks of one
# card); H2O-Danube3-4B prefills on a (1, 4) ("data", "model") mesh,
# Granite-3.0-1B-A400M on (2, 2)
MESH_RANKS = 4
# H2O's sequence-parallel attention core on 4 ranks: each rank's 2048
# queries (32 heads, 8 kv heads of 120, window 4096) against all 8192
# keys, at query offset 2048 r; and a block whose length and offset are
# no multiple of a tile
SP_SHAPE = (1, PREFILL_T // MESH_RANKS, PREFILL_T, 32, 8, 120, True, 4096)
SP_RAGGED = (1000, 3000)                # (Tq, q_offset)
# H2O's bf16 prefill and Granite's at 8 of their 24 layers (at full depth
# 27 s and 14 s of the chip check; phase 15 runs H2O at full depth)
MESH_BF16_LAYERS = 8
MESH_BF16_CUTS = ["24 layers cut to 8"]
MESH_F32_LAYERS = 4
MESH_F32_CUTS = ["24 layers cut to 4 in f32"]
MESH_GRANITE_B = 2
# the WKV region at RWKV6-7B's heads: (B, T, H, hd)
MESH_WKV = (2, 2048, 64, 64)
# loss and gradients of reduced configs on (2, 2), (B, T) = (8, 64);
# Granite without drops (a capacity buffer a data shard drops other
# assignments than one for the whole batch)
MESH_REDUCED = ("minitron-4b", "granite-moe-1b-a400m")
MESH_REDUCED_OVERRIDES = {"granite-moe-1b-a400m":
                          {"moe_capacity_factor": 8.0}}
MESH_GRAD_RTOL = 1e-4


def _library_offset(q, k, v, H, KV, off, causal, window, dev):
    """One library call on a rank's block in its (B, H, T, hd) layout, kv
    repeated to H heads -> ({backend: ms, None where it refuses}, the
    fastest backend's name, its output (B, Tq, H, hd)).  With a mask (causal or a
    window, at the block's offset) the mask is a bias on the
    memory-efficient backend; without one every backend takes the call
    unmasked, each pinned with ``sdpa_kernel``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Tq, Tk = q.shape[1], k.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1)
              .contiguous() for x in (k, v))
    bias = None
    if causal or window is not None:
        qp = torch.arange(off, off + Tq, device=dev)[:, None]
        kp = torch.arange(Tk, device=dev)[None, :]
        live = (kp <= qp) | (not causal)
        if window is not None:
            live = live & (kp > qp - window)
        bias = torch.zeros((Tq, Tk), dtype=q.dtype, device=dev)
        bias.masked_fill_(~live, float("-inf"))
        backends = {"efficient": SDPBackend.EFFICIENT_ATTENTION}
    else:
        backends = {"cudnn": SDPBackend.CUDNN_ATTENTION,
                    "flash": SDPBackend.FLASH_ATTENTION,
                    "efficient": SDPBackend.EFFICIENT_ATTENTION}
    ms, outs = {}, {}
    for name, backend in backends.items():
        with sdpa_kernel([backend]):
            try:
                outs[name] = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias)
            except RuntimeError:
                ms[name] = None
                continue
            ms[name] = timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias))
    best = min((n for n in ms if ms[n] is not None), key=ms.get)
    label = f"{best} (kv repeated to H heads, " + (
        "the offset's mask as a bias)" if bias is not None else "unmasked)")
    return ms, label, outs[best].transpose(1, 2)


def sp_offset_kernel(dev, hbm, smi, shapes, phase, seed):
    """Part (a) of phases 12 and 14: the flash kernel's q_offset on both
    routes at each sequence-parallel shape of ``shapes``, {name: ((B, Tq a
    rank, Tk, H, KV, hd, causal, window), |model|, extra (Tq, q_offset)
    blocks)}: |model| ranks' blocks of queries at offsets Tq r against all
    Tk keys, as the mesh the model runs on cuts them.  With identical q,
    k and v each rank's launch equals the matching rows of the one launch
    over all Tq |model| queries (torch.equal), as does each extra (ragged)
    block; each is held to its route's plain twin (f32:
    ``flash_attention_ref``, bf16: ``flash_attention_tiled_ref``) at
    ATTN_TOL; a launch at offset 0 equals the launch without the argument.
    bf16 timed per rank beside, for the heaviest rank (the last), the
    plain version and the fastest library call (``_library_offset``) ->
    ({name: the flash row's numbers at that shape}, the worst bf16 error
    of the ranks' blocks)."""
    import torch
    from repro_torch.kernels.attention import flash, ops, ref
    tc = PEAK_BF16[next((p for p in ("PCIe", "NVL")
                         if p in torch.cuda.get_device_name(0)), "SXM")]
    rows, worst = {}, 0.0
    for i, (name, (shape, n, extra)) in enumerate(shapes.items()):
        B, Tq, Tk, H, KV, hd, causal, window = shape
        kw = dict(causal=causal, sliding_window=window)
        offsets = [r * Tq for r in range(n)]
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            route = flash.route(dtype, hd)
            q, k, v = attn_inputs((B, Tq * n, Tk, H, KV, hd), dtype, dev,
                                  seed=seed + i)
            full = ops.attention(q, k, v, **kw)
            zero = torch.equal(flash.flash_attention(q, k, v, q_offset=0,
                                                     **kw), full)
            check(zero, f"flash {name} {dname}: offset 0 differs from the "
                        "launch without an offset")
            twin = (ref.flash_attention_ref if dname == "float32"
                    else ref.flash_attention_tiled_ref)
            blocks = []
            for tq, off in [(Tq, off) for off in offsets] + list(extra):
                qr = q[:, off:off + tq]
                got = ops.attention(qr, k, v, q_offset=off, **kw)
                equal = bool(torch.equal(got, full[:, off:off + tq]))
                want = twin(qr, k, v, q_offset=off, **kw)
                err = float((got.float() - want.float()).abs().max())
                ok = err <= ATTN_TOL[dname]
                check(equal, f"flash {name} {dname} at q_offset {off} (Tq "
                             f"{tq}): not the full launch's rows")
                check(ok, f"flash {name} {dname} at q_offset {off} (Tq "
                          f"{tq}): max_abs_err {err} vs its twin")
                blocks.append({"q_offset": off, "Tq": tq,
                               "equal_full_rows": equal,
                               "max_abs_err_twin": err, "ok": ok})
                del got, want
                torch.cuda.empty_cache()
            emit({"phase": phase, "part": "a", "shape_name": name,
                  "dtype": dname, "route": route, "shape": list(shape),
                  "model_ranks": n, "offset_zero_equal": zero,
                  "blocks": blocks, "tol": ATTN_TOL[dname]})
            if dname == "bfloat16":
                err = max(b["max_abs_err_twin"] for b in blocks[:n])
                worst = max(worst, err)
                pairs_full = flash.live_pairs(Tq * n, Tk, causal, window)
                ms, bounds, shares = [], [], []
                for off in offsets:
                    qr = q[:, off:off + Tq]
                    ms.append(timed(lambda: ops.attention(
                        qr, k, v, q_offset=off, **kw)))
                    pairs = flash.live_pairs(Tq, Tk, causal, window, off)
                    nbytes = 2 * (2 * B * Tq * H * hd + 2 * B * Tk * KV * hd)
                    bounds.append(bound(nbytes, pairs * 4 * H * hd, hbm, tc))
                    shares.append(pairs / pairs_full)
                full_ms = timed(lambda: ops.attention(q, k, v, **kw))
                off = offsets[-1]
                qr = q[:, off:off + Tq]
                plain_ms = timed(lambda: ref.flash_attention_ref(
                    qr, k, v, q_offset=off, **kw), repeats=5, warmup=1)
                lib, label, lib_out = _library_offset(qr, k, v, H, KV, off,
                                                     causal, window, dev)
                lib_err = float((lib_out.float()
                                 - full[:, off:off + Tq].float()).abs().max())
                del lib_out
                rows[name] = {
                    "shape": list(shape), "model_ranks": n,
                    "q_offsets": offsets, "kernel_ms": ms[-1],
                    "kernel_ms_by_rank": ms, "full_launch_ms": full_ms,
                    "plain_ms": plain_ms,
                    "plain": "flash_attention_ref at the offset (bf16)",
                    "library_ms": min(t for t in lib.values()
                                      if t is not None),
                    "library": label,
                    "library_backends_ms": lib,
                    "library_max_abs_diff": lib_err,
                    "bound_ms": bounds[-1][0], "bound_by": bounds[-1][1],
                    "bound_ms_by_rank": [b[0] for b in bounds],
                    "live_pair_share_by_rank": shares,
                    "max_abs_err": err, "route": route}
                emit({"phase": "timing", "kernel": "flash_attention",
                      "part": "sp_offset", "shape_name": name, **rows[name],
                      "card": smi})
            del q, k, v, full
            torch.cuda.empty_cache()
    return rows, worst


def _mesh_cfg(arch, dname=None, layers=None, reduced=False):
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced().with_(**MESH_REDUCED_OVERRIDES.get(arch, {}))
    if dname is not None:
        cfg = cfg.with_(dtype=getattr(torch, dname),
                        param_dtype=getattr(torch, dname))
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    return cfg


def _mesh_tokens(cfg, batch, seq, dev, seed=7):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=dev)


def _wkv_inputs(dev, seed=21):
    import torch
    B, T, H, hd = MESH_WKV
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v, w0 = (torch.randn((B, T, H, hd), generator=gen, device=dev)
                   for _ in range(4))
    u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
    s = torch.randn((B, H, hd, hd), generator=gen, device=dev)
    return r, k, v, torch.exp(-torch.exp(w0)), u, s


def _flat_grads(params):
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out["/".join(path + (k,))] = v.grad.detach().cpu()
    walk(params, ())
    return out


def _mesh_prefill(step, params, batch, dev, profile=False):
    """One timed prefill on the mesh (counts zeroed before it) -> (h on
    the CPU, wall ms, the flash launches by route, the collectives'
    {calls, bytes, ms}, and with ``profile`` a second, profiled prefill's
    device ms by family)."""
    import torch
    from repro_torch.kernels.attention import flash
    from repro_torch.models import meshctx
    mesh = meshctx.current_mesh()
    flash.reset_launches()
    mesh.reset_stats()
    h, ms = _synced_ms(lambda: step(params, batch), dev)
    routes = dict(flash.flash_attention.route_launches)
    stats = dict(mesh.stats)
    fam = None
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(params, batch)
            torch.cuda.synchronize(dev)
        fam = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = ev.time_range.elapsed_us() / 1e3
            name = ev.name.lower()
            if "flash_attention" in name:
                fam["flash_attention"] += t
            elif any(s in name for s in ("gemm", "nvjet", "cutlass",
                                         "sm90_xmma", "matmul")):
                fam["matmul"] += t
            else:
                fam["other"] += t
    return h.cpu(), ms, routes, stats, fam


def _mesh_rank(rank, world, device, job):
    """Phase 12 (b)-(e) on one rank of the card: H2O's prefills on the
    (1, 4) mesh, Granite's on (2, 2) with the expert choices replayed and
    free, the WKV region, the reduced models' loss and gradients."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding, steps
    from repro_torch.models import meshctx, model, rwkv
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    mark("mesh: rank started")
    line = mesh_lib.make_mesh((1, world), ("data", "model"))
    square = mesh_lib.make_mesh((2, world // 2), ("data", "model"))
    out = {}
    # (b) H2O-Danube3-4B
    for dname, layers in (("bfloat16", MESH_BF16_LAYERS),
                          ("float32", MESH_F32_LAYERS)):
        mark(f"mesh (b) h2o {dname}")
        cfg = _mesh_cfg(SERVE_ARCH, dname, layers)
        params = model.init(0, cfg, device=dev)
        local = sharding.local_params(params, line, cfg)
        del params
        torch.cuda.empty_cache()
        tokens = _mesh_tokens(cfg, 1, PREFILL_T, dev)
        with meshctx.set_mesh(line):
            batch = sharding.local_batch({"tokens": tokens}, line, cfg)
            warm = sharding.local_batch({"tokens": tokens[:, :512]}, line,
                                        cfg)
            step = steps.make_prefill_step(cfg)
            step(local, warm)
            out[("h2o", dname)] = _mesh_prefill(
                step, local, batch, dev, profile=dname == "bfloat16")
        out[("h2o", dname, "peak_gb")] = \
            torch.cuda.max_memory_allocated(dev) / 1e9
        del local
        torch.cuda.empty_cache()
    # (c) Granite-3.0-1B-A400M, B = 2: replayed, then free routing
    mark("mesh (c) granite")
    cfg = _mesh_cfg(MOE_ARCH, "bfloat16", MESH_BF16_LAYERS)
    params = model.init(0, cfg, device=dev)
    local = sharding.local_params(params, square, cfg)
    del params
    torch.cuda.empty_cache()
    tokens = _mesh_tokens(cfg, MESH_GRANITE_B, PREFILL_T, dev)
    d = square.index(("data",))
    step = steps.make_prefill_step(cfg)
    with meshctx.set_mesh(square):
        batch = sharding.local_batch({"tokens": tokens}, square, cfg)
        warm = sharding.local_batch({"tokens": tokens[:, :512]}, square, cfg)
        step(local, warm)
        replay = [ids.to(dev) for ids in job["granite_ids"][d]]
        with RouteTape(replay=replay).installed():
            out[("granite", "replayed")] = _mesh_prefill(step, local, batch,
                                                         dev)
        tape = RouteTape()
        with tape.installed():
            out[("granite", "free")] = _mesh_prefill(step, local, batch, dev)
        out[("granite", "free_ids")] = [i.cpu() for i in tape.ids]
    del local
    torch.cuda.empty_cache()
    # (d) the WKV region at RWKV6-7B's heads
    mark("mesh (d) wkv")
    r, k, v, w, u, s = _wkv_inputs(dev)
    d = square.index(("data",))
    with meshctx.set_mesh(square):
        square.reset_stats()
        (y, st), ms = _synced_ms(lambda: rwkv._wkv_dispatch(
            r[d:d + 1], k[d:d + 1], v[d:d + 1], w[d:d + 1], u,
            s[d:d + 1]), dev)
    out["wkv"] = (y.cpu(), st.cpu(), ms, dict(square.stats))
    del r, k, v, w, s, y, st
    torch.cuda.empty_cache()
    # (e) loss and gradients of the reduced configs
    mark("mesh (e) reduced")
    for arch in MESH_REDUCED:
        cfg = _mesh_cfg(arch, reduced=True)
        params = model.init(3, cfg, device=dev)
        local = _requiring_grad(
            sharding.local_params(params, square, cfg))
        tokens = _mesh_tokens(cfg, 8, 64, dev, seed=5)
        with meshctx.set_mesh(square):
            batch = sharding.local_batch(
                {"tokens": tokens, "labels": tokens.roll(-1, -1)}, square,
                cfg)
            loss = model.loss_fn(local, batch, cfg)
            loss.backward()
        out[("reduced", arch)] = (float(loss.detach()), _flat_grads(local))
    out["coords"] = {"line": dict(line.coords), "square": dict(square.coords)}
    mark("mesh: rank done")
    return out


def _requiring_grad(params):
    """A copy of ``params`` whose leaves require grad."""
    return {k: (_requiring_grad(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in params.items()}


def _mesh_assemble_grads(per_rank, key, cfg):
    """The (2, 2) mesh's gradients assembled to the full params' shapes
    (ranks row-major: rank 2 d + m)."""
    import torch
    from repro_torch.models import blocks, moe

    class _Mesh:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")

    out = {}
    for name in per_rank[0][key][1]:
        parts = [[per_rank[2 * d + m][key][1][name] for m in range(2)]
                 for d in range(2)]
        path = name.split("/")
        if "moe" in path and path[-1] != "router":
            gate_ax, down_ax, fsdp_ok = moe.fsdp_layout(
                blocks.moe_spec(cfg), _Mesh)
            ax = 1 + (down_ax if path[-1] == "w_down" else gate_ax)
            rows = [torch.cat(p, 1) for p in parts]
            out[name] = torch.cat(rows, ax) if fsdp_ok else rows[0]
        elif "mlp" in path and cfg.d_ff % 2 == 0:
            out[name] = torch.cat(parts[0], -2 if path[-1] == "w_down"
                                  else -1)
        else:
            out[name] = parts[0][0]
    return out


def mesh_path(dev, hbm, smi):
    """Phase 12 (a generator: ``mesh_phases`` runs its rank body with the
    other mesh phases'): the model mesh on 4 rank processes of the card.
    (a) the kernel's q_offset (``sp_offset_kernel``); then, with every
    single-process reference computed first and freed: (b)
    H2O-Danube3-4B's bf16 prefill at full width (B = 1, T = 8192, 8
    layers) on a (1, 4) mesh
    through sequence-parallel attention (one flash launch a layer a rank
    at query offset 2048 r) and the SP+TP SwiGLU, the gathered hidden
    states held to the single-process kernel prefill within PREFILL_RTOL,
    and f32 at 4 layers; (c) Granite-3.0-1B-A400M's bf16 prefill at full
    width and 8 layers, B = 2, T = 8192, on (2, 2) through SP attention
    and expert parallelism, held to the single-process prefill of each
    data shard's sequence (the capacity buffer is a data shard's) with its
    expert choices replayed (``RouteTape``), the free-routing flips
    recorded;
    (d) the WKV region at RWKV6-7B's heads on (2, 2) against
    ``wkv_chunked`` in one process; (e) the reduced minitron-4b's and
    granite's loss and gradients on (2, 2) against one process.  ->
    ({dtype: flash launches by route of the mesh prefills}, the flash
    row's ``sp_offset_shape``)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model, rwkv
    from repro_torch.kernels.attention import flash
    t0 = time.perf_counter()
    sp_row = sp_offset_kernel(dev, hbm, smi, {
        "h2o": (SP_SHAPE, MESH_RANKS, [SP_RAGGED])}, "mesh", 13)[0]["h2o"]
    # single-process references
    refs = {}
    for dname, layers in (("bfloat16", MESH_BF16_LAYERS),
                          ("float32", MESH_F32_LAYERS)):
        cfg = _mesh_cfg(SERVE_ARCH, dname, layers)
        params = model.init(0, cfg, device=dev)
        step = steps.make_prefill_step(cfg)
        tokens = _mesh_tokens(cfg, 1, PREFILL_T, dev)
        step(params, {"tokens": tokens[:, :512]})
        h, ms = _prefill_ms(step, params, {"tokens": tokens}, dev)
        refs[("h2o", dname)] = (h.cpu(), ms)
        del params, h
        torch.cuda.empty_cache()
    cfg = _mesh_cfg(MOE_ARCH, "bfloat16", MESH_BF16_LAYERS)
    params = model.init(0, cfg, device=dev)
    step = steps.make_prefill_step(cfg)
    tokens = _mesh_tokens(cfg, MESH_GRANITE_B, PREFILL_T, dev)
    step(params, {"tokens": tokens[:1, :512]})
    g_h, g_tapes, g_ms = [], [], []
    for b in range(MESH_GRANITE_B):
        tape = RouteTape(keep_probs=True)
        with tape.installed():
            h, ms = _prefill_ms(step, params, {"tokens": tokens[b:b + 1]},
                                dev)
        g_h.append(h.cpu())
        g_ms.append(ms)
        g_tapes.append(tape)
    granite_ids = [[i.cpu() for i in t.ids] for t in g_tapes]
    del params, h
    torch.cuda.empty_cache()
    r, k, v, w, u, s = _wkv_inputs(dev)
    y_ref, s_ref = rwkv.wkv_chunked(r, k, v, w, u, s)
    wkv_ref = (y_ref.cpu(), s_ref.cpu())
    del r, k, v, w, s, y_ref, s_ref
    reduced_ref = {}
    for arch in MESH_REDUCED:
        rcfg = _mesh_cfg(arch, reduced=True)
        params = _requiring_grad(model.init(3, rcfg, device=dev))
        tok = _mesh_tokens(rcfg, 8, 64, dev, seed=5)
        loss = model.loss_fn(params, {"tokens": tok,
                                      "labels": tok.roll(-1, -1)}, rcfg)
        loss.backward()
        reduced_ref[arch] = (float(loss.detach()), _flat_grads(params))
        del params
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_mesh_rank", ({"granite_ids": granite_ids},), t0)
    by_route = {"bfloat16": {r: 0 for r in flash.ROUTES},
                "float32": {r: 0 for r in flash.ROUTES}}

    # (b) H2O on (1, 4): rank r holds positions 2048 r ..
    for dname in ("bfloat16", "float32"):
        cfg = _mesh_cfg(SERVE_ARCH, dname, MESH_BF16_LAYERS
                        if dname == "bfloat16" else MESH_F32_LAYERS)
        h_ref, ms_ref = refs[("h2o", dname)]
        res = [pr[("h2o", dname)] for pr in per_rank]
        h = torch.cat([x[0] for x in res], 1)
        scale = float(h_ref.float().abs().max())
        err = float((h.float() - h_ref.float()).abs().max())
        ok = err <= PREFILL_RTOL[dname] * scale and bool(
            torch.isfinite(h).all()) and h.shape == h_ref.shape
        want_route = flash.route(cfg.dtype, cfg.head_dim)
        L = cfg.num_layers
        launches_ok = all(x[2] == {r: L * (r == want_route)
                                   for r in flash.ROUTES} for x in res)
        for x in res:
            for rt, n in x[2].items():
                by_route[dname][rt] += n
        check(ok, f"mesh (b) H2O {dname}: max_abs_err {err} (max|h| "
                  f"{scale}, rtol {PREFILL_RTOL[dname]})")
        check(launches_ok, f"mesh (b) H2O {dname}: launches by rank "
                           f"{[x[2] for x in res]}, want {L} on {want_route}")
        line = {"phase": "mesh", "part": "b", "arch": SERVE_ARCH,
                "dtype": dname, "mesh": {"data": 1, "model": MESH_RANKS},
                "batch": 1, "seq_len": PREFILL_T, "num_layers": L,
                "reduced": (MESH_BF16_CUTS if dname == "bfloat16"
                            else MESH_F32_CUTS),
                "launches_by_rank": [x[2] for x in res],
                "ms_per_prefill_mesh_by_rank": [x[1] for x in res],
                "ms_per_prefill_one_process": ms_ref,
                "collectives_by_rank": [x[3] for x in res],
                "staged_share_by_rank": [x[3]["ms"] / x[1] for x in res],
                "max_abs_err": err, "max_abs_h": scale,
                "rel_err": err / scale, "rtol": PREFILL_RTOL[dname],
                "peak_gb_by_rank": [pr[("h2o", dname, "peak_gb")]
                                    for pr in per_rank],
                "ok": ok, "card": smi}
        if dname == "bfloat16":
            line["device_ms_by_family_by_rank"] = [x[4] for x in res]
        emit(line)

    # (c) Granite on (2, 2): rank 2 d + m holds sequence d's block m
    cfg = _mesh_cfg(MOE_ARCH, "bfloat16", MESH_BF16_LAYERS)
    L = cfg.num_layers
    for mode in ("replayed", "free"):
        res = [pr[("granite", mode)] for pr in per_rank]
        rows = [torch.cat([res[2 * d + m][0] for m in range(2)], 1)
                for d in range(2)]
        errs = [float((rows[d].float() - g_h[d].float()).abs().max())
                for d in range(2)]
        scale = max(float(x.float().abs().max()) for x in g_h)
        launches_ok = all(x[2] == {r: L * (r == "tensor_core")
                                   for r in flash.ROUTES} for x in res)
        line = {"phase": "mesh", "part": "c", "arch": MOE_ARCH,
                "routing": mode, "dtype": "bfloat16",
                "mesh": {"data": 2, "model": 2}, "num_layers": L,
                "reduced": MESH_BF16_CUTS,
                "batch": MESH_GRANITE_B, "seq_len": PREFILL_T,
                "launches_by_rank": [x[2] for x in res],
                "ms_per_prefill_mesh_by_rank": [x[1] for x in res],
                "ms_per_prefill_one_process_by_sequence": g_ms,
                "collectives_by_rank": [x[3] for x in res],
                "max_abs_err_by_sequence": errs, "max_abs_h": scale,
                "rtol": PREFILL_RTOL["bfloat16"], "card": smi}
        if mode == "replayed":
            ok = max(errs) <= PREFILL_RTOL["bfloat16"] * scale
            check(ok, f"mesh (c) Granite replayed: max_abs_err {errs} "
                      f"(max|h| {scale})")
            check(launches_ok, f"mesh (c) Granite: launches by rank "
                               f"{[x[2] for x in res]}")
            line["ok"] = ok
            for x in res:
                for rt, n in x[2].items():
                    by_route["bfloat16"][rt] += n
        else:
            flips = []
            for d in range(2):
                other = RouteTape()
                other.ids = [i.to(dev) for i in per_rank[2 * d][
                    ("granite", "free_ids")]]
                flips.append(route_flips(g_tapes[d], other,
                                         cfg.num_experts))
            same = all(torch.equal(a, b) for d in range(2) for a, b in zip(
                per_rank[2 * d][("granite", "free_ids")],
                per_rank[2 * d + 1][("granite", "free_ids")]))
            check(same, "mesh (c) Granite: the model ranks of a data shard "
                        "routed its tokens differently")
            line.update(route_flips_by_sequence=flips,
                        model_ranks_route_alike=same)
        emit(line)
    del g_tapes

    # (d) the WKV region: rank 2 d + m holds sequence d, all heads
    y = torch.cat([per_rank[2 * d]["wkv"][0] for d in range(2)], 0)
    st = torch.cat([per_rank[2 * d]["wkv"][1] for d in range(2)], 0)
    y_err = float((y - wkv_ref[0]).abs().max())
    s_err = float((st - wkv_ref[1]).abs().max())
    equal = bool(torch.equal(y, wkv_ref[0]) and torch.equal(st, wkv_ref[1]))
    wkv_ok = y_err <= 1e-3 and s_err <= 1e-3
    check(wkv_ok, f"mesh (d) WKV: max_abs_err y {y_err}, state {s_err}")
    emit({"phase": "mesh", "part": "d", "shape": list(MESH_WKV),
          "mesh": {"data": 2, "model": 2}, "max_abs_err_y": y_err,
          "max_abs_err_state": s_err, "equal_one_process": equal,
          "ms_by_rank": [pr["wkv"][2] for pr in per_rank],
          "collectives_by_rank": [pr["wkv"][3] for pr in per_rank],
          "ok": wkv_ok, "card": smi})

    # (e) the reduced configs' loss and gradients
    for arch in MESH_REDUCED:
        rcfg = _mesh_cfg(arch, reduced=True)
        losses = [pr[("reduced", arch)][0] for pr in per_rank]
        want_loss, want_grads = reduced_ref[arch]
        grads = _mesh_assemble_grads(per_rank, ("reduced", arch), rcfg)
        worst = max(float((grads[n] - g).abs().max())
                    / (float(g.abs().max()) + 1e-12)
                    for n, g in want_grads.items())
        loss_err = max(abs(x - want_loss) for x in losses)
        ok = loss_err <= 1e-5 * abs(want_loss) and worst <= MESH_GRAD_RTOL \
            and len(set(losses)) == 1
        check(ok, f"mesh (e) {arch}: loss {losses} vs {want_loss}, worst "
                  f"gradient rel err {worst}")
        emit({"phase": "mesh", "part": "e", "arch": arch + "-reduced",
              "overrides": MESH_REDUCED_OVERRIDES.get(arch, {}),
              "mesh": {"data": 2, "model": 2}, "tokens": [8, 64],
              "loss_one_process": want_loss, "loss_by_rank": losses,
              "worst_grad_rel_err": worst, "rtol": MESH_GRAD_RTOL,
              "ok": ok})
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s, "card": smi})
    return by_route, sp_row


# -- phase 13: the group train step on the model mesh -------------------------

# (a) H2O-Danube3-4B at full width and 1 layer (bf16, remat; at
# launch/train.py's depth of 2, 60 s of the chip check) on a (2, 2)
# ("data", "model") mesh of 4 rank processes of the card: params and
# AdamW state as FSDP storage blocks, k = 4 groups of 2 sequences of 512
# (one a group a data rank), q = 1, gmom under
# sign_flip, one microbatch; 1 shard-local step (the reference's
# partitioned spec: the reference round on the 2D layout) and 1 gathered
# step (the stacked gradients gathered whole, the round kernel on every
# rank, the ranks taking turns on the card for its (k, P) f32 block and
# scratch); (b) the reduced granite-moe-1b-a400m (capacity factor 8.0)
# and rwkv6-7b on (2, 2), f32, SGD, 2 steps of each variant.  Each is
# held to one process on the card at the same settings, computed first.
MESH_TRAIN = {"k": 4, "q": 1, "batch": 8, "microbatches": 1, "lr": 1e-3}
MESH_TRAIN_STEPS = {"shard_local": 1, "gathered": 1}
MESH_TRAIN_LAYERS = {TRAIN_ARCH: 1}
MESH_TRAIN_CUTS = ["24 layers cut to 1 (launch/train.py gpu_train_layers' "
                   "2, cut once more for the chip check's time)",
                   "seq_len 512, one sequence a group a data rank"]
MESH_TRAIN_SEED = 0
# the first step's aggregate against one process's, each leaf's
# ||mesh - one|| over ||one||: both round bf16 gradients summed in
# another order (about 2**-8 of a coordinate), and GMoM moves with its
# inputs; a missing, flipped or misplaced aggregate is off by 1 or more
MESH_TRAIN_AGG_RTOL = 2.0 ** -5
MESH_TRAIN_REDUCED = ("granite-moe-1b-a400m", "rwkv6-7b")
MESH_TRAIN_REDUCED_RC = {"k": 4, "q": 1, "batch": 8, "seq": 64,
                         "lr": 0.1, "steps": 2}
MESH_TRAIN_REDUCED_RTOL = 1e-4


def _mesh_train_rc(k, q, backend):
    from repro_torch.core import RobustConfig
    return RobustConfig(num_workers=k, num_byzantine=q, num_batches=k,
                        aggregator="gmom", attack="sign_flip",
                        round_backend=backend)


def _mesh_train_stream(cfg, dev, seed=MESH_TRAIN_SEED):
    from repro_torch.data.tokens import TokenStream
    return TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=MESH_TRAIN["batch"],
                       num_workers=MESH_TRAIN["k"], seed=seed, device=dev)


def _mesh_train_key(dev, seed=MESH_TRAIN_SEED):
    from repro_torch import random as prng
    return prng.fold_in(prng.PRNGKey(seed, device=dev), 10_000)


def mesh_train_config(arch, dname=None):
    """Phase 13 (a)'s (and 14 (e)'s) config of ``arch``: its train depth
    (MESH_TRAIN_LAYERS where that names it), remat, in ``dname`` (None:
    the config's own bf16)."""
    import torch
    from repro_torch.launch import train as train_lib
    cfg = train_lib.train_config(arch, "gpu").with_(remat=True)
    if arch in MESH_TRAIN_LAYERS:
        cfg = cfg.with_(num_layers=MESH_TRAIN_LAYERS[arch])
    if dname is not None:
        cfg = cfg.with_(dtype=getattr(torch, dname),
                        param_dtype=getattr(torch, dname))
    return cfg


def mesh_train_reference(dev, backend, steps_n, arch=TRAIN_ARCH, dname=None,
                         seed=MESH_TRAIN_SEED, rc=None):
    """One process, phase 13 (a)'s settings (phase 14 (e): ``arch``; the
    model in ``dname``, params, tokens and keys from ``seed``; phase 16
    (a): the ``rc`` aggregation): (rows, s per step, peak GB, the first
    step's aggregate on the CPU)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import steps
    from repro_torch.models import model
    g = MESH_TRAIN
    cfg = mesh_train_config(arch, dname)
    opt = optim.adamw(g["lr"])
    step = steps.make_group_train_step(
        cfg, rc or _mesh_train_rc(g["k"], g["q"], backend), opt,
        microbatches=g["microbatches"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(seed, cfg, device=dev)
    opt_state = opt.init(params)
    stream, key = _mesh_train_stream(cfg, dev, seed), _mesh_train_key(dev, seed)
    rows, held = [], []
    real_agg = steps.aggregate_reported

    def agg_hook(*a, **kw):
        out = real_agg(*a, **kw)
        if not held:
            held.append(tree_map(lambda x: x.cpu(), out))
        return out
    steps.aggregate_reported = agg_hook
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps_n):
            params, opt_state, met = step(params, opt_state,
                                          stream.batch(t),
                                          prng.fold_in(key, t), t)
            rows.append({name: float(v) for name, v in met.items()})
        torch.cuda.synchronize()
    finally:
        steps.aggregate_reported = real_agg
    seconds = (time.perf_counter() - t0) / steps_n
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, opt_state
    torch.cuda.empty_cache()
    return rows, seconds, peak, held[0]


def _digest(tree) -> str:
    """The sha256 of every leaf's bytes, in leaf order."""
    import hashlib

    import torch
    from torch.utils._pytree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _update_exact(opt, p0, agg, p1) -> bool:
    """Whether ``p1`` is ``p0`` after ``opt``'s first update with the
    aggregate ``agg``, bit for bit, as the step applies it (whole leaves,
    one at a time)."""
    import torch
    from torch.utils._pytree import tree_leaves
    ok = True
    for p, g, q in zip(tree_leaves(p0), tree_leaves(agg), tree_leaves(p1)):
        u, _ = opt.update([g], opt.init([p]), [p])
        ok = ok and torch.equal((p + u[0]).to(p.dtype), q)
    return ok


def _mesh_train_variant(cfg, mesh, variant, full, specs, dev, steps_n,
                        rc, opt, batches, keys, check_first=False):
    """``steps_n`` mesh steps of one variant from ``full``'s storage
    blocks -> a dict of this rank's rows, s, stage s and staged
    collectives a step, round-kernel launches and the kernel's ms, peak
    GB, the gathered variant's aggregates' digests, and
    (``check_first``) on rank 0 the first step's aggregate whole on the
    CPU and whether the whole params after that step are ``full`` after
    ``opt``'s update with it, bit for bit: the aggregate cut back into
    the storage blocks and applied there.  The stages are timed with the
    card synchronised at their edges: the gradients (the model's own
    collectives included), the storage-to-compute gather (and the
    gathered variant's stacked gather), the reduce-scatter, the
    aggregation (the gathered variant's turns included) and AdamW; the
    rest is the attack, the stacking and the update.  Phase 17's record
    of the first step (``dry``): its collectives by kind and by group,
    the card's memory before it and its peak (reset before it), the
    bytes of its inputs, and its count of host stop reads (the Weiszfeld
    loop's iterations)."""
    import dataclasses

    import torch
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch import _device
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import sharding, steps
    spec = sharding.grad_shard_spec(mesh, cfg)
    if variant == "gathered":
        gshard = sharding.gathered_grad_shardings(full, mesh)
        spec = dataclasses.replace(spec, num_shards=1)
    else:
        gshard = sharding.stacked_grad_shardings(full, mesh, cfg)
    stage = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            stage[name] = stage.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    step = steps.make_group_train_step(
        cfg, rc, dataclasses.replace(opt, update=timed("adamw", opt.update)),
        microbatches=MESH_TRAIN["microbatches"], grad_shardings=gshard,
        shard_spec=spec)
    storage = sharding.cut_tree(full, specs, mesh)
    opt_state = opt.init(storage)
    held, kernel_ms = [], []
    real_kernel = rk.round_aggregate_kernel
    real_agg = steps.aggregate_reported

    def agg_hook(*a, **kw):
        out = real_agg(*a, **kw)
        held.append(out)
        return out

    def kernel_hook(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real_kernel(*a, **kw)
        torch.cuda.synchronize(dev)
        kernel_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    # the wrapper counts its launches on the name it is called by
    kernel_hook.launches = start = real_kernel.launches
    patched = [(steps, "_value_and_grad", "grads"),
               (sharding, "compute_params", "gather"),
               (sharding, "gather_tree", "gather"),
               (sharding, "storage_grads", "scatter")]
    real = [getattr(mod, name) for mod, name, _ in patched]
    for (mod, name, label), fn in zip(patched, real):
        setattr(mod, name, timed(label, fn))
    steps.aggregate_reported = timed("aggregate", agg_hook)
    rk.round_aggregate_kernel = kernel_hook
    torch.cuda.reset_peak_memory_stats(dev)
    rows, secs, stages, staged, digests, first = [], [], [], [], [], {}
    first_digest = None
    dry = {}
    real_read = _device.host_value

    def counted_read(t, *, traced):
        dry["reads"] += 1
        return real_read(t, traced=traced)

    try:
        for t in range(steps_n):
            batch = sharding.local_train_batch(batches(t), mesh, cfg)
            key_t = keys(t)
            mesh.reset_stats()
            stage.clear()
            torch.cuda.synchronize(dev)
            if t == 0:
                torch.cuda.reset_peak_memory_stats(dev)
                dry.update(base=torch.cuda.memory_allocated(dev), reads=0,
                           inputs=sum(x.numel() * x.element_size()
                                      for x in tree_leaves(
                                          (storage, opt_state, batch,
                                           key_t))))
                _device.host_value = counted_read
            t0 = time.perf_counter()
            storage, opt_state, met = step(storage, opt_state, batch,
                                           key_t, t)
            torch.cuda.synchronize(dev)
            if t == 0:
                _device.host_value = real_read
                # copies: the stats go on counting until the next reset
                dry.update(peak=torch.cuda.max_memory_allocated(dev),
                           kinds={k: dict(v) for k, v in
                                  mesh.stats["kinds"].items()},
                           groups=dict(mesh.stats["groups"]))
            secs.append(time.perf_counter() - t0)
            stages.append(dict(stage, rest=secs[-1] - sum(stage.values())))
            staged.append(dict(mesh.stats))
            rows.append({name: float(v) for name, v in met.items()})
            if variant == "gathered":
                digests.extend(_digest(agg) for agg in held)
            if check_first and t == 0:
                untimed_gather = real[2]
                agg = held[0] if variant == "gathered" \
                    else untimed_gather(held[0], specs, mesh)
                first_digest = _digest(agg)
                whole = untimed_gather(storage, specs, mesh)
                if mesh.rank == 0:
                    first = {"agg": tree_map(lambda x: x.cpu(), agg),
                             "update_exact": _update_exact(opt, full, agg,
                                                           whole)}
                del agg, whole
            held.clear()
    finally:
        _device.host_value = real_read
        for (mod, name, _), fn in zip(patched, real):
            setattr(mod, name, fn)
        real_kernel.launches = rk.round_aggregate_kernel.launches
        steps.aggregate_reported, rk.round_aggregate_kernel = \
            real_agg, real_kernel
    out = {"rows": rows, "s_per_step": secs, "stages": stages,
           "staged": staged, "launches": real_kernel.launches - start,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "digests": digests, "kernel_ms": kernel_ms, "whole": None,
           "first": first, "first_digest": first_digest, "dry": dry}
    if not check_first:
        whole = sharding.gather_tree(storage, specs, mesh)
        if mesh.rank == 0:
            out["whole"] = tree_map(lambda x: x.cpu(), whole)
        del whole
    del storage, opt_state
    torch.cuda.empty_cache()
    return out


def _reduced_batches(rcfg, dev):
    """Phase 13 (b)'s and 14 (e)'s batches of a reduced config: t -> the
    step's (k, B/k, seq) tokens and labels, and the audio family's frames
    (seq / 2 a row) or the vlm family's patches, drawn from seeds."""
    from repro_torch import random as prng
    from repro_torch.data import tokens as data
    r = MESH_TRAIN_REDUCED_RC
    k, rows = r["k"], r["batch"] // r["k"]

    def batch(t):
        tok = _mesh_tokens(rcfg, r["batch"], r["seq"], dev,
                           seed=5 + t).reshape(k, -1, r["seq"])
        out = {"tokens": tok, "labels": tok.roll(-1, -1)}
        key = prng.PRNGKey(31 + t, device=dev)
        kw = dict(num_workers=k, per_worker=rows, d_model=rcfg.d_model,
                  dtype=rcfg.dtype)
        if rcfg.family == "audio":
            out["frames"] = data.frame_embeddings(
                key, num_frames=r["seq"] // 2, **kw)
        if rcfg.family == "vlm":
            out["patches"] = data.patch_embeddings(
                key, num_patches=rcfg.num_patches, **kw)
        return out
    return batch


def _mesh_train_rank(rank, world, device):
    """Phase 13 (a) and (b) on one rank of the card."""
    import torch
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import meshctx, model
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    mark("mesh_train: rank started")
    square = mesh_lib.make_mesh((2, world // 2), ("data", "model"))
    out = {"coords": dict(square.coords)}
    g = MESH_TRAIN
    # (a) H2O-Danube3-4B at full width, 2 layers
    cfg = mesh_train_config(TRAIN_ARCH)
    full = model.init(MESH_TRAIN_SEED, cfg, device=dev)
    specs = sharding.param_shardings(full, square, cfg)
    stream, key = _mesh_train_stream(cfg, dev), _mesh_train_key(dev)
    with meshctx.set_mesh(square):
        for variant, n in MESH_TRAIN_STEPS.items():
            mark(f"mesh_train (a) h2o {variant}")
            out[("h2o", variant)] = _mesh_train_variant(
                cfg, square, variant, full, specs, dev, n,
                _mesh_train_rc(g["k"], g["q"], "auto"),
                optim.adamw(g["lr"]), stream.batch,
                lambda t: prng.fold_in(key, t), check_first=True)
    del full
    torch.cuda.empty_cache()
    # (b) the reduced MoE and ssm families, f32, SGD
    r = MESH_TRAIN_REDUCED_RC
    for arch in MESH_TRAIN_REDUCED:
        mark(f"mesh_train (b) {arch}")
        rcfg = _mesh_cfg(arch, reduced=True)
        full = model.init(3, rcfg, device=dev)
        rspecs = sharding.param_shardings(full, square, rcfg)
        batches = _reduced_batches(rcfg, dev)
        with meshctx.set_mesh(square):
            for variant in ("shard_local", "gathered"):
                out[(arch, variant)] = _mesh_train_variant(
                    rcfg, square, variant, full, rspecs, dev, r["steps"],
                    _mesh_train_rc(r["k"], r["q"], "auto"),
                    optim.sgd(r["lr"]), batches,
                    lambda t: prng.PRNGKey(11 + t, device=dev))
        del full
    torch.cuda.empty_cache()
    return out


def mesh_train_reduced_reference(dev, arch, backend):
    """One process, phase 13 (b) (and 14 (e)): (rows, the params after the
    steps on the CPU)."""
    import torch
    from torch.utils._pytree import tree_map
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import steps
    from repro_torch.models import model
    r = MESH_TRAIN_REDUCED_RC
    rcfg = _mesh_cfg(arch, reduced=True)
    opt = optim.sgd(r["lr"])
    step = steps.make_group_train_step(
        rcfg, _mesh_train_rc(r["k"], r["q"], backend), opt)
    params = model.init(3, rcfg, device=dev)
    state = opt.init(params)
    batches = _reduced_batches(rcfg, dev)
    rows = []
    for t in range(r["steps"]):
        params, state, met = step(params, state, batches(t),
                                  prng.PRNGKey(11 + t, device=dev), t)
        rows.append({name: float(v) for name, v in met.items()})
    return rows, tree_map(lambda x: x.cpu(), params)


def _leaves_close(got, want, rtol, atol):
    """(ok, worst error over the leaf's max|want|) of two param trees."""
    from torch.utils._pytree import tree_leaves
    worst, ok = 0.0, True
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max())
        top = float(b.abs().max())
        ok = ok and a.shape == b.shape and bool(a.isfinite().all()) \
            and err <= rtol * top + atol
        worst = max(worst, err / (top + 1e-12))
    return ok, worst


def _rel_norms(got, want, dev=None) -> dict:
    """{leaf path: ||got - want|| / ||want||} over the leaves of two trees,
    each pair taken to ``dev`` (inf where a shape differs or a value is
    not finite)."""
    from torch.utils._pytree import keystr, tree_flatten_with_path
    from torch.utils._pytree import tree_leaves
    out = {}
    for (path, b), a in zip(tree_flatten_with_path(want)[0],
                            tree_leaves(got), strict=True):
        a, b = a.to(dev).float(), b.to(dev).float()
        out[keystr(path)] = (
            float("inf") if a.shape != b.shape or not bool(a.isfinite().all())
            else float((a - b).norm() / b.norm().clamp_min(1e-30)))
    return out


def _worst_leaves(rel, n=3) -> dict:
    """The ``n`` largest of ``_rel_norms``' values, by leaf."""
    return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:n])


def reduced_step_checks(per_rank, reduced_refs, archs, phase, part):
    """Phase 13 (b), 14 (e): each reduced ``arch``'s mesh steps of both
    variants (rank 0's metrics and whole params) against one process's
    (``reduced_refs``: the reference round for shard-local, the kernel
    for gathered) at MESH_TRAIN_REDUCED_RTOL, the same metrics on every
    rank, the round kernel once a rank a gathered step and never
    shard-local -> the round-kernel launches counted."""
    r = MESH_TRAIN_REDUCED_RC
    launches = 0
    for arch in archs:
        for variant in ("shard_local", "gathered"):
            res = [pr[(arch, variant)] for pr in per_rank]
            backend = "auto" if variant == "gathered" else "reference"
            want_rows, want_params = reduced_refs[(arch, backend)]
            bad = [name for t, row in enumerate(res[0]["rows"])
                   for name, v in row.items()
                   if abs(v - want_rows[t][name]) > MESH_TRAIN_REDUCED_RTOL
                   * abs(want_rows[t][name]) + 1e-7]
            ok_p, worst = _leaves_close(res[0]["whole"], want_params,
                                        MESH_TRAIN_REDUCED_RTOL, 1e-7)
            same_rows = all(x["rows"] == res[0]["rows"] for x in res)
            want_launches = r["steps"] if variant == "gathered" else 0
            n_launch = [x["launches"] for x in res]
            launches += sum(n_launch)
            ok = not bad and ok_p and same_rows and all(
                x == want_launches for x in n_launch)
            check(ok, f"{phase} ({part}) {arch} {variant}: metrics off "
                      f"{bad}, params worst {worst}, launches {n_launch}")
            emit({"phase": phase, "part": part,
                  "arch": arch + "-reduced", "variant": variant,
                  "overrides": MESH_REDUCED_OVERRIDES.get(arch, {}),
                  "mesh": {"data": 2, "model": 2}, **r,
                  "history_by_rank0": res[0]["rows"],
                  "history_one_process": want_rows,
                  "params_worst_rel_err": worst,
                  "rtol": MESH_TRAIN_REDUCED_RTOL,
                  "launches_by_rank": n_launch,
                  "s_per_step_by_rank0": res[0]["s_per_step"], "ok": ok})
    return launches


def mesh_train_path(dev, smi):
    """Phase 13 (a generator, as phase 12's): the group train step on the
    mesh, 4 rank processes of the card -> (round-kernel launches, the
    round row's ``mesh_train_shape``)."""
    import torch
    from repro_torch.sim.goldens import compare_traces
    t0 = time.perf_counter()
    refs = {b: mesh_train_reference(dev, b, MESH_TRAIN_STEPS["shard_local"])
            for b in ("auto", "reference")}
    reduced_refs = {(arch, b): mesh_train_reduced_reference(dev, arch, b)
                    for arch in MESH_TRAIN_REDUCED
                    for b in ("reference", "auto")}
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_mesh_train_rank", (), t0)
    cfg = mesh_train_config(TRAIN_ARCH)
    P = cfg_param_leaves(cfg)
    launches = gathered_launches = 0
    kernel_ms = []
    # (a) H2O at full width
    for variant, n in MESH_TRAIN_STEPS.items():
        res = [pr[("h2o", variant)] for pr in per_rank]
        DRY_SHARED[("none", variant)] = [x["dry"] for x in res]
        backend = "auto" if variant == "gathered" else "reference"
        want_rows = refs[backend][0][:n]
        vs = [compare_traces(_compared(x["rows"]), _compared(want_rows))
              for x in res]
        same_rows = all(x["rows"] == res[0]["rows"] for x in res)
        want_launches = n if variant == "gathered" else 0
        n_launch = [x["launches"] for x in res]
        launches += sum(n_launch)
        check(not any(vs), f"mesh train (a) {variant}: vs one process "
                           f"{vs[0][:3]}")
        check(same_rows, f"mesh train (a) {variant}: ranks' metrics differ")
        check(all(x == want_launches for x in n_launch),
              f"mesh train (a) {variant}: round-kernel launches by rank "
              f"{n_launch}, want {want_launches}")
        line = {"phase": "mesh_train", "part": "a", "arch": TRAIN_ARCH,
                "variant": variant, "mesh": {"data": 2, "model": 2},
                "num_layers": cfg.num_layers, "param_leaves": P,
                "reduced": MESH_TRAIN_CUTS, **MESH_TRAIN, "steps": n,
                "history_by_rank0": res[0]["rows"],
                "history_one_process": want_rows,
                "one_process_backend": backend,
                "launches_by_rank": n_launch,
                "s_per_step_by_rank": [x["s_per_step"] for x in res],
                "s_per_step_one_process": refs[backend][1],
                "staged_by_rank": [x["staged"] for x in res],
                "stage_s_by_rank": [x["stages"] for x in res],
                "staged_gb_per_step_by_rank": [
                    [st["bytes"] / 1e9 for st in x["staged"]] for x in res],
                "staged_share_by_rank": [
                    [st["ms"] / 1e3 / s for st, s in zip(x["staged"],
                                                        x["s_per_step"])]
                    for x in res],
                "peak_gb_by_rank": [x["peak_gb"] for x in res],
                "peak_gb_one_process": refs[backend][2],
                "ok": not any(vs) and same_rows, "card": smi}
        first = res[0]["first"]
        rel = _rel_norms(first["agg"], refs[backend][3], dev)
        agg_err = max(rel.values())
        agg_ok = agg_err <= MESH_TRAIN_AGG_RTOL
        check(agg_ok, f"mesh train (a) {variant}: the first step's aggregate "
                      f"{agg_err} from one process's (relative norm)")
        check(first["update_exact"], f"mesh train (a) {variant}: the params "
                                     "after one step are not the update "
                                     "of the aggregate")
        line.update(agg_worst_rel_norm_err=agg_err,
                    agg_worst_leaves=_worst_leaves(rel),
                    agg_rtol=MESH_TRAIN_AGG_RTOL,
                    update_of_aggregate_exact=first["update_exact"])
        line["ok"] = line["ok"] and agg_ok and first["update_exact"]
        if variant == "gathered":
            gathered_launches = sum(n_launch)
            digests = [x["digests"] for x in res]
            equal = all(d == digests[0] and len(d) == n for d in digests)
            check(equal, f"mesh train (a) gathered: aggregates differ "
                         f"across ranks {digests}")
            kernel_ms = [ms for x in res for ms in x["kernel_ms"]]
            line.update(aggregate_equal_across_ranks=equal,
                        kernel_ms_by_rank=[x["kernel_ms"] for x in res])
        emit(line)
    # (b) the reduced MoE and ssm families
    launches += reduced_step_checks(per_rank, reduced_refs,
                                    MESH_TRAIN_REDUCED, "mesh_train", "b")
    emit({"phase": "mesh_train", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s, "card": smi})
    return launches, {"shape": [MESH_TRAIN["k"], MESH_TRAIN["k"], P],
                      "kernel_ms": (sorted(kernel_ms)[len(kernel_ms) // 2]
                                    if kernel_ms else None),
                      "kernel_ms_by_rank": kernel_ms,
                      "launches": gathered_launches}


# -- phase 14: the hybrid, audio and vlm families on the model mesh -----------

# the meshes of phase 14 (b)-(e), ("data", "model") sizes
FAMILY_MESHES = {"line": (1, MESH_RANKS), "square": (2, MESH_RANKS // 2)}
FAMILY_AUDIO_FRAMES = PREFILL_T // 4
# (a) the flash kernel at these families' sequence-parallel shapes on the
# mesh each runs on, name: ((B, Tq a rank, Tk, H, KV, hd, causal, window),
# |model|, no extra blocks): a rank's block of queries at offset Tq r
# against all the keys.  Zamba2's shared block and InternVL2 on (1, 4);
# SeamlessM4T on (2, 2): its encoder over the frames, its decoder's
# causal self-attention and its cross-attention against the memory
_M_LINE, _M_SQUARE = FAMILY_MESHES["line"][1], FAMILY_MESHES["square"][1]
FAMILY_SP = {
    "zamba2_shared": ((1, PREFILL_T // _M_LINE, PREFILL_T, 32, 32, 80,
                       True, None), _M_LINE, ()),
    "seamless_encoder": ((1, FAMILY_AUDIO_FRAMES // _M_SQUARE,
                          FAMILY_AUDIO_FRAMES, 16, 16, 64, False, None),
                         _M_SQUARE, ()),
    "seamless_decoder": ((1, PREFILL_T // _M_SQUARE, PREFILL_T, 16, 16, 64,
                          True, None), _M_SQUARE, ()),
    "seamless_cross": ((1, PREFILL_T // _M_SQUARE, FAMILY_AUDIO_FRAMES, 16,
                        16, 64, False, None), _M_SQUARE, ()),
    "internvl2": ((1, PREFILL_T // _M_LINE, PREFILL_T, 48, 8, 128, True,
                   None), _M_LINE, ())}
# (b) Zamba2-2.7B on (1, 4) at 12 layers in both dtypes (the bf16 prefill
# at full depth took 22 s of the chip check)
FAMILY_ZAMBA_LAYERS = 12
FAMILY_ZAMBA_CUTS = ["54 layers cut to 12 (2 groups)"]
# (c) SeamlessM4T-medium on (2, 2): a sequence a data rank
FAMILY_AUDIO_B = 2
# (d) InternVL2-26B on (1, 4): each rank holds the attention weights and
# both vocab matrices whole, 2.27 + 0.327 L GB a rank in bf16 (48 layers:
# 72 GB for four ranks)
FAMILY_VLM_LAYERS = 16
FAMILY_VLM_F32_LAYERS = 8
FAMILY_VLM_CUTS = ["48 layers cut to 16 (each rank holds 2.27 + 0.327 L "
                   "GB of bf16 weights)"]
FAMILY_VLM_F32_CUTS = ["48 layers cut to 8 in f32"]
# (e) Zamba2-2.7B trained at its train depth (6 layers, one group) with
# phase 13 (a)'s settings, shard-local; the reduced SeamlessM4T and
# InternVL2 with phase 13 (b)'s
FAMILY_TRAIN_STEPS = 1
FAMILY_TRAIN_CUTS = ["54 layers cut to 6, one group of the shared block "
                     "(launch/train.py gpu_train_layers)",
                     "seq_len 512, one sequence a group a data rank"]
FAMILY_TRAIN_REDUCED = (AUDIO_ARCH, VLM_ARCH)


def _family_local(cfg, mesh, dev, seed=0):
    """``cfg``'s params drawn from ``seed`` and cut to the mesh's compute
    layout, the ranks of one card taking turns (a rank's whole params and
    its cut live at once in its turn only)."""
    from repro_torch.launch import sharding
    from repro_torch.models import meshctx, model

    def build():
        params = model.init(seed, cfg, device=dev)
        local = sharding.local_params(params, mesh, cfg)
        del params
        return local
    return meshctx.one_card_turns(mesh, build, dev)


def _family_inputs(cfg, dev):
    """The prefill inputs of phase 14 (b)-(d), drawn from seeds on the
    card (the same in either dtype): Zamba2's (1, T) tokens; SeamlessM4T's
    (2, T) tokens and (2, T / 4, D) frames; InternVL2's 256 patches and
    T - 256 tokens."""
    import torch
    if cfg.family == "hybrid":
        return {"tokens": _mesh_tokens(cfg, 1, PREFILL_T, dev)}
    if cfg.family == "audio":
        return {"tokens": _mesh_tokens(cfg, FAMILY_AUDIO_B, PREFILL_T, dev),
                "frames": torch.cat([
                    _stub("frames", cfg, FAMILY_AUDIO_FRAMES, dev, seed=7 + b)
                    for b in range(FAMILY_AUDIO_B)])}
    P = cfg.num_patches
    return {"tokens": _mesh_tokens(cfg, 1, PREFILL_T - P, dev),
            "patches": _stub("patches", cfg, P, dev)}


def _family_warm(batch):
    """A short batch of the same kind (the first prefill's warm-up)."""
    out = {"tokens": batch["tokens"][:, :512]}
    if "frames" in batch:
        out["frames"] = batch["frames"][:, :128]
    if "patches" in batch:
        out["patches"] = batch["patches"]
    return out


# (arch, mesh, dtype, layers (None: full depth)) of phase 14 (b)-(d)
FAMILY_PREFILLS = (
    (ZAMBA_ARCH, "line", "bfloat16", FAMILY_ZAMBA_LAYERS),
    (ZAMBA_ARCH, "line", "float32", FAMILY_ZAMBA_LAYERS),
    (AUDIO_ARCH, "square", "bfloat16", None),
    (AUDIO_ARCH, "square", "float32", None),
    (VLM_ARCH, "line", "bfloat16", FAMILY_VLM_LAYERS),
    (VLM_ARCH, "line", "float32", FAMILY_VLM_F32_LAYERS))


def _family_mesh_rank(rank, world, device):
    """Phase 14 (b)-(e) on one rank of the card: the three families'
    prefills on their meshes (SeamlessM4T's f32 once more with the
    encoder made causal), then the group steps."""
    import torch
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding, steps
    from repro_torch.models import meshctx, model
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    meshes = {n: mesh_lib.make_mesh(sizes, ("data", "model"))
              for n, sizes in FAMILY_MESHES.items()}
    out = {"coords": {n: dict(m.coords) for n, m in meshes.items()}}
    mark("mesh_families: meshes built")
    for arch, mname, dname, layers in FAMILY_PREFILLS:
        mark(f"mesh_families {arch} {dname}")
        mesh = meshes[mname]
        cfg = _mesh_cfg(arch, dname, layers)
        local = _family_local(cfg, mesh, dev)
        full_batch = _family_inputs(cfg, dev)
        with meshctx.set_mesh(mesh):
            batch = sharding.local_batch(full_batch, mesh, cfg)
            warm = sharding.local_batch(_family_warm(full_batch), mesh, cfg)
            step = steps.make_prefill_step(cfg)
            step(local, warm)
            torch.cuda.reset_peak_memory_stats(dev)
            res = _mesh_prefill(step, local, batch, dev)
            out[(arch, dname)] = res + (
                torch.cuda.max_memory_allocated(dev) / 1e9, _digest(res[0]))
            if cfg.family == "audio" and dname == "float32":
                with causal_encoder():
                    out[(arch, "causal_encoder")] = _mesh_prefill(
                        step, local, batch, dev)
        del local, batch, warm, full_batch
        torch.cuda.empty_cache()
    # (e) Zamba2 at its train depth, shard-local, AdamW
    mark("mesh_families (e) zamba2 train")
    square = meshes["square"]
    g = MESH_TRAIN
    cfg = mesh_train_config(ZAMBA_ARCH)
    full = model.init(MESH_TRAIN_SEED, cfg, device=dev)
    specs = sharding.param_shardings(full, square, cfg)
    stream, key = _mesh_train_stream(cfg, dev), _mesh_train_key(dev)
    with meshctx.set_mesh(square):
        out[(ZAMBA_ARCH, "train")] = _mesh_train_variant(
            cfg, square, "shard_local", full, specs, dev, FAMILY_TRAIN_STEPS,
            _mesh_train_rc(g["k"], g["q"], "auto"), optim.adamw(g["lr"]),
            stream.batch, lambda t: prng.fold_in(key, t), check_first=True)
    del full
    torch.cuda.empty_cache()
    # the reduced audio and vlm families, f32, SGD, both variants
    r = MESH_TRAIN_REDUCED_RC
    for arch in FAMILY_TRAIN_REDUCED:
        mark(f"mesh_families (e) {arch}")
        rcfg = _mesh_cfg(arch, reduced=True)
        full = model.init(3, rcfg, device=dev)
        rspecs = sharding.param_shardings(full, square, rcfg)
        with meshctx.set_mesh(square):
            for variant in ("shard_local", "gathered"):
                out[(arch, variant)] = _mesh_train_variant(
                    rcfg, square, variant, full, rspecs, dev, r["steps"],
                    _mesh_train_rc(r["k"], r["q"], "auto"),
                    optim.sgd(r["lr"]), _reduced_batches(rcfg, dev),
                    lambda t: prng.PRNGKey(11 + t, device=dev))
        del full
    torch.cuda.empty_cache()
    return out


def _family_want_launches(cfg) -> int:
    """Flash launches a rank a prefill: Zamba2's shared block a group;
    SeamlessM4T's encoder, decoder and cross-attention a layer each;
    one a decoder layer for InternVL2."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _family_references(dev):
    """The one-process prefills of phase 14 (b)-(d) on the card, kernel
    path, each freed before the next: {(arch, dtype): (h on the host, for
    SeamlessM4T one a sequence, ms)}."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model
    refs = {}
    for arch, _, dname, layers in FAMILY_PREFILLS:
        cfg = _mesh_cfg(arch, dname, layers)
        params = model.init(0, cfg, device=dev)
        step = steps.make_prefill_step(cfg)
        batch = _family_inputs(cfg, dev)
        seqs = [{k: v[b:b + 1] for k, v in batch.items()}
                for b in range(batch["tokens"].shape[0])]
        step(params, _family_warm(seqs[0]))
        hs, ms = [], []
        for one in seqs:
            h, t = _prefill_ms(step, params, one, dev)
            hs.append(h.cpu())
            ms.append(t)
        refs[(arch, dname)] = (hs, ms)
        del params, h, batch, seqs
        torch.cuda.empty_cache()
    return refs


def _family_rows(key, per_rank, sizes):
    """The ranks' hidden states of the prefill ``key`` (arch, dtype)
    joined into each sequence's (1, T, D): rank d |model| + m holds
    sequence d's block m (the hybrid's whole T on every model rank: rank
    0's taken, the others' digests held to it)."""
    import torch
    nd, nm = sizes
    res = [pr[key] for pr in per_rank]
    if key[0] == ZAMBA_ARCH:
        same = all(x[6] == res[0][6] for x in res)
        check(same, f"mesh families (b) {key}: the model ranks' hidden "
                    "states differ")
        return [res[0][0]]
    return [torch.cat([res[d * nm + m][0] for m in range(nm)], 1)
            for d in range(nd)]


def mesh_families_path(dev, hbm, smi):
    """Phase 14 (a generator, as phase 12's): the hybrid, audio and vlm
    families on the model mesh, 4 rank processes of the card.  (a) the
    flash kernel at their
    sequence-parallel offset shapes (``sp_offset_kernel``); then,
    with every single-process reference computed first and freed: (b)
    Zamba2-2.7B's bf16 and f32 prefills at full width and 12 layers on
    (1, 4), B = 1, T = 8192 (the Mamba2 blocks channel-parallel, the
    shared block on the rank's T block, 2 flash launches a rank at hd 80);
    (c) SeamlessM4T-medium's bf16 and f32 prefills at full width and
    depth on (2, 2), B = 2, T = 8192 and 2048 frames (the encoder
    sequence-parallel over the frames, its output gathered into the
    memory; 36 launches a rank), and f32 with the encoder made causal,
    which must fail; (d) InternVL2-26B's bf16 prefill at full width cut to
    16 layers on (1, 4), 256 patches + 7936 tokens, f32 at 8 layers; (e)
    Zamba2 at its train depth on (2, 2), one shard-local step with phase
    13 (a)'s settings and checks, and the reduced SeamlessM4T and
    InternVL2 with phase 13 (b)'s.  -> ({dtype: flash launches by route of
    the mesh prefills}, round-kernel launches, the flash row's
    ``family_sp_shapes``)."""
    import torch
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import train as train_lib
    from repro_torch.sim.goldens import compare_traces
    t0 = time.perf_counter()
    sp_rows, sp_worst = sp_offset_kernel(dev, hbm, smi, FAMILY_SP,
                                         "mesh_families", 40)
    refs = _family_references(dev)
    train_ref = mesh_train_reference(dev, "reference", FAMILY_TRAIN_STEPS,
                                     arch=ZAMBA_ARCH)
    reduced_refs = {(arch, b): mesh_train_reduced_reference(dev, arch, b)
                    for arch in FAMILY_TRAIN_REDUCED
                    for b in ("reference", "auto")}
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_family_mesh_rank", (), t0)
    sizes = FAMILY_MESHES
    by_route = {"bfloat16": {r: 0 for r in flash.ROUTES},
                "float32": {r: 0 for r in flash.ROUTES}}
    part = {ZAMBA_ARCH: "b", AUDIO_ARCH: "c", VLM_ARCH: "d"}
    for arch, mname, dname, layers in FAMILY_PREFILLS:
        cfg = _mesh_cfg(arch, dname, layers)
        hs_ref, ms_ref = refs[(arch, dname)]
        rows = _family_rows((arch, dname), per_rank, sizes[mname])
        scale = max(float(h.float().abs().max()) for h in hs_ref)
        errs = [float((h.float() - w.float()).abs().max())
                if h.shape == w.shape else float("inf")
                for h, w in zip(rows, hs_ref)]
        finite = all(bool(torch.isfinite(h).all()) for h in rows)
        ok = max(errs) <= PREFILL_RTOL[dname] * scale and finite
        res = [pr[(arch, dname)] for pr in per_rank]
        L = _family_want_launches(cfg)
        want_route = flash.route(cfg.dtype, cfg.head_dim)
        launches_ok = all(x[2] == {r: L * (r == want_route)
                                   for r in flash.ROUTES} for x in res)
        for x in res:
            for rt, n in x[2].items():
                by_route[dname][rt] += n
        check(ok, f"mesh families ({part[arch]}) {arch} {dname}: "
                  f"max_abs_err {errs} (max|h| {scale}, rtol "
                  f"{PREFILL_RTOL[dname]})")
        check(launches_ok, f"mesh families ({part[arch]}) {arch} {dname}: "
                           f"launches by rank {[x[2] for x in res]}, want "
                           f"{L} on {want_route}")
        line = {"phase": "mesh_families", "part": part[arch], "arch": arch,
                "dtype": dname, "mesh": dict(zip(("data", "model"),
                                                 sizes[mname])),
                "batch": len(hs_ref), "seq_len": PREFILL_T,
                "num_layers": cfg.num_layers,
                "reduced": ([] if layers is None else
                            {ZAMBA_ARCH: FAMILY_ZAMBA_CUTS,
                             VLM_ARCH: FAMILY_VLM_CUTS if dname == "bfloat16"
                             else FAMILY_VLM_F32_CUTS}[arch]),
                "launches_by_rank": [x[2] for x in res],
                "ms_per_prefill_mesh_by_rank": [x[1] for x in res],
                "ms_per_prefill_one_process_by_sequence": ms_ref,
                "collectives_by_rank": [x[3] for x in res],
                "staged_gb_by_rank": [x[3]["bytes"] / 1e9 for x in res],
                "staged_share_by_rank": [x[3]["ms"] / x[1] for x in res],
                "peak_gb_by_rank": [x[5] for x in res],
                "max_abs_err_by_sequence": errs, "max_abs_h": scale,
                "rel_err": max(errs) / scale, "rtol": PREFILL_RTOL[dname],
                "ok": ok and launches_ok, "card": smi}
        if cfg.family == "audio" and dname == "float32":
            fault = [pr[(arch, "causal_encoder")] for pr in per_rank]
            nd, nm = sizes[mname]
            f_rows = [torch.cat([fault[d * nm + m][0] for m in range(nm)], 1)
                      for d in range(nd)]
            f_err = max(float((h.float() - w.float()).abs().max())
                        for h, w in zip(f_rows, hs_ref))
            caught = f_err > PREFILL_RTOL[dname] * scale
            check(caught, f"mesh families (c) {arch}: the causal encoder's "
                          f"max_abs_err {f_err} passes the f32 check")
            line.update(causal_encoder_max_abs_err=f_err,
                        causal_encoder_caught=caught)
        emit(line)
    # (e) Zamba2 at its train depth on (2, 2)
    cfg = train_lib.train_config(ZAMBA_ARCH, "gpu")
    res = [pr[(ZAMBA_ARCH, "train")] for pr in per_rank]
    want_rows = train_ref[0]
    vs = [compare_traces(_compared(x["rows"]), _compared(want_rows))
          for x in res]
    same_rows = all(x["rows"] == res[0]["rows"] for x in res)
    n_launch = [x["launches"] for x in res]
    first = res[0]["first"]
    rel = _rel_norms(first["agg"], train_ref[3], dev)
    agg_err = max(rel.values())
    digests_equal = all(x["first_digest"] == res[0]["first_digest"]
                        for x in res)
    ok = (not any(vs) and same_rows and all(n == 0 for n in n_launch)
          and agg_err <= MESH_TRAIN_AGG_RTOL and first["update_exact"]
          and digests_equal)
    check(ok, f"mesh families (e) {ZAMBA_ARCH}: vs one process {vs[0][:3]}, "
              f"same rows {same_rows}, launches {n_launch}, aggregate "
              f"{agg_err}, update exact {first['update_exact']}, digests "
              f"equal {digests_equal}")
    emit({"phase": "mesh_families", "part": "e", "arch": ZAMBA_ARCH,
          "variant": "shard_local", "mesh": {"data": 2, "model": 2},
          "num_layers": cfg.num_layers, "param_leaves": cfg_param_leaves(cfg),
          "reduced": FAMILY_TRAIN_CUTS, **MESH_TRAIN,
          "steps": FAMILY_TRAIN_STEPS, "history_by_rank0": res[0]["rows"],
          "history_one_process": want_rows,
          "launches_by_rank": n_launch,
          "s_per_step_by_rank": [x["s_per_step"] for x in res],
          "s_per_step_one_process": train_ref[1],
          "stage_s_by_rank": [x["stages"] for x in res],
          "staged_gb_per_step_by_rank": [
              [st["bytes"] / 1e9 for st in x["staged"]] for x in res],
          "staged_share_by_rank": [
              [st["ms"] / 1e3 / s for st, s in zip(x["staged"],
                                                  x["s_per_step"])]
              for x in res],
          "peak_gb_by_rank": [x["peak_gb"] for x in res],
          "peak_gb_one_process": train_ref[2],
          "agg_worst_rel_norm_err": agg_err,
          "agg_worst_leaves": _worst_leaves(rel),
          "agg_rtol": MESH_TRAIN_AGG_RTOL,
          "update_of_aggregate_exact": first["update_exact"],
          "aggregate_sha256_equal_across_ranks": digests_equal,
          "ok": ok, "card": smi})
    # the reduced audio and vlm families
    launches = sum(n_launch) + reduced_step_checks(
        per_rank, reduced_refs, FAMILY_TRAIN_REDUCED, "mesh_families", "e")
    emit({"phase": "mesh_families", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s,
          "sp_worst_bf16_err": sp_worst, "card": smi})
    return by_route, launches, sp_rows


# -- phase 15: decode and short prefill on the model mesh ---------------------

# the reference driver's defaults (launch/serve.py): 4 requests, prompts of
# 16 tokens, 32 new
DECODE_B, DECODE_PROMPT, DECODE_NEW = 4, 16, 32
DECODE_LEN = DECODE_PROMPT + DECODE_NEW
# Zamba2's decode makes 3 host-staged collectives a Mamba2 block and 2 a
# shared block (180 a step at 54 layers, 4.3 ms each on 4 ranks of one
# H100 80GB at 700 W), so it serves at 2 of its 9 groups
MESH_DECODE_ZAMBA_LAYERS = 12
# name: (arch, bf16 mesh, bf16 layers, f32 mesh, f32 layers, f32 steps)
# (layers None: full depth).  H2O in bf16 on (2, 2), in f32 on (1, 4);
# the others on their phase-12 and phase-14 meshes (Granite and RWKV6 on
# (2, 2))
MESH_DECODE = {
    "h2o": (SERVE_ARCH, "square", None, "line", None, DECODE_LEN),
    "granite": (MOE_ARCH, "square", None, "square", None, 24),
    "rwkv6": (RWKV_ARCH, "square", None, "square", 8, 24),
    "zamba2": (ZAMBA_ARCH, "line", MESH_DECODE_ZAMBA_LAYERS, "line",
               MESH_DECODE_ZAMBA_LAYERS, 24),
    "seamless": (AUDIO_ARCH, "square", None, "square", None, 24),
    "internvl2": (VLM_ARCH, "line", FAMILY_VLM_LAYERS, "line",
                  FAMILY_VLM_F32_LAYERS, 24)}
MESH_DECODE_RTOL = 1e-3
# H2O's bf16 decode on (2, 2), teacher-forced on the one process's f32
# greedy tokens, against the one process's bf16 decode of the same tokens:
# its worst step within this many times the one process's own bf16-vs-f32
# worst step (the rounding of bf16 itself, measured in the same run); the
# planted fault (the ranks' softmax parts summed unrescaled) runs its first
# MESH_DECODE_FAULT_STEPS steps.  Both bf16 decodes are roundings of the
# same f32 function, each about the control away from it, so their
# difference is at most about twice the control; MESH_DECODE_TF_STEPS
# (the prompt and 16 new tokens) fill both model ranks' halves of the
# 48-slot cache on (2, 2)
MESH_DECODE_BF16_FACTOR = 2.0
MESH_DECODE_TF_STEPS = 32
MESH_DECODE_FAULT_STEPS = 8
MESH_DECODE_CUTS = {
    ("rwkv6", "float32"): ["32 layers cut to 8 in f32 (every rank holds "
                           "every weight: 30.3 GB a rank at full depth)"],
    ("zamba2", "bfloat16"): ["54 layers cut to 12 (2 groups): 180 "
                             "host-staged collectives a step at full depth"],
    ("zamba2", "float32"): ["54 layers cut to 12 (2 groups)"],
    ("internvl2", "bfloat16"): FAMILY_VLM_CUTS,
    ("internvl2", "float32"): FAMILY_VLM_F32_CUTS}
MESH_DECODE_F32_CUT = ("the f32 check teacher-forces the prompt and 8 of "
                       "the one process's greedy tokens (24 steps)")
# the ranks build whole params in turns above this many bytes a rank
MESH_DECODE_TURNS_BYTES = 12e9
# phase 15's one-process job and references, which phase 16 (b) reuses
DECODE_SHARED = {}


def _decode_logits(cfg, params, state, tokens):
    """Token t at position t through the serve step: every step's logits
    (B, S, V), float32."""
    import torch
    from repro_torch.launch import steps
    step = steps.make_serve_step(cfg)
    out = []
    for t in range(tokens.shape[1]):
        pos = torch.full((tokens.shape[0],), t, dtype=torch.int64,
                         device=tokens.device)
        logits, state = step(params, state, tokens[:, t:t + 1], pos)
        out.append(logits[:, 0].float())
    return torch.stack(out, 1)


def _decode_memory(cfg, dev, seed=17):
    """The audio decode state's memory (B, S_enc, D), drawn from a seed
    (``model.init_decode_state`` holds zeros, which the cross-attention
    turns into an exact 0)."""
    import torch
    # model.init_decode_state's memory length
    enc_len = min(max(DECODE_LEN // cfg.encoder_seq_divisor, 1), 8192)
    shape = (DECODE_B, enc_len, cfg.d_model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)


@contextlib.contextmanager
def unrescaled_combine():
    """The planted fault of the decode's combine: the ranks' softmax parts
    summed as they are, each normalised by its own max."""
    import torch
    from repro_torch.models import meshctx
    real = meshctx.softmax_combine

    def combine(m, l, o, axes, *, mesh=None):
        mesh = meshctx._mesh_for(mesh)
        parts = meshctx._parts(torch.cat([l[..., None], o], -1), mesh,
                               mesh.axes(axes))
        total = meshctx._chain(parts)
        return total[..., 1:] / total[..., :1]
    meshctx.softmax_combine = combine
    try:
        yield
    finally:
        meshctx.softmax_combine = real


@contextlib.contextmanager
def maskless_kernel():
    """The planted fault: every flash launch without its mask (non-causal,
    no window).  At T = 16 H2O's window of 4096 masks nothing, so the
    fault removes the causal mask with it."""
    from repro_torch.kernels.attention import ops
    real = ops.attention

    def launch(q, k, v, *, causal, sliding_window=None, **kw):
        return real(q, k, v, causal=False, sliding_window=None, **kw)
    ops.attention = launch
    try:
        yield
    finally:
        ops.attention = real


def _decode_local(cfg, mesh, dev):
    """``cfg``'s params drawn from seed 0 and cut to the mesh's serve
    layout (the experts' FSDP dim whole), built in turns where four
    ranks' whole params would not fit the card together."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.models import meshctx, model

    def build():
        params = model.init(0, cfg, device=dev)
        local = sharding.local_params(params, mesh, cfg, expert_fsdp=False)
        del params
        return local
    nbytes = cfg_param_leaves(cfg) * torch.empty(
        (), dtype=cfg.param_dtype).element_size()
    if nbytes > MESH_DECODE_TURNS_BYTES:
        return meshctx.one_card_turns(mesh, build, dev)
    return build()


def _decode_mesh_rank(rank, world, device, job):
    """Phase 15 on one rank of the card: each family's bf16 serve through
    ``serve.generate`` on its mesh (H2O's also teacher-forced on the one
    process's f32 tokens, and with the planted combine), then its f32
    decode teacher-forced on the one process's tokens; H2O's short
    prefill in both dtypes (and f32 with the kernel's mask removed)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, sharding, steps
    from repro_torch.models import meshctx, model
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    meshes = {n: mesh_lib.make_mesh(sizes, ("data", "model"))
              for n, sizes in FAMILY_MESHES.items()}
    out = {"coords": {n: dict(m.coords) for n, m in meshes.items()}}
    mark("mesh_decode: meshes built")
    for name, (arch, bmesh, blayers, fmesh, flayers, fsteps) in \
            MESH_DECODE.items():
        for dname, mname, layers in (("bfloat16", bmesh, blayers),
                                     ("float32", fmesh, flayers)):
            mark(f"mesh_decode {name} {dname}")
            cfg = _mesh_cfg(arch, dname, layers)
            mesh = meshes[mname]
            local = _decode_local(cfg, mesh, dev)
            mark(f"mesh_decode {name} {dname} params cut")
            torch.cuda.reset_peak_memory_stats(dev)
            res = {}
            with meshctx.set_mesh(mesh):
                prompts = job["prompts"][name].to(dev)
                rows = sharding.local_rows(prompts, mesh)
                mesh.reset_stats()
                if dname == "bfloat16":
                    tokens, first, times = serve.generate(local, cfg, rows,
                                                          DECODE_NEW)
                    res.update(tokens=tokens.cpu(), times=times,
                               steps=DECODE_LEN - 1)
                else:
                    seq = sharding.local_rows(
                        job["f32_tokens"][name][:, :fsteps].to(dev), mesh)
                    whole = model.init_decode_state(cfg, DECODE_B, DECODE_LEN,
                                                    device=dev)
                    if "memory" in whole:
                        whole["memory"] = job["memory"][name].to(dev)
                    state = sharding.local_decode_state(whole, mesh, cfg,
                                                        DECODE_B)
                    logits, ms = _synced_ms(
                        lambda: _decode_logits(cfg, local, state, seq), dev)
                    first = logits[:, DECODE_PROMPT - 1:DECODE_PROMPT]
                    res.update(digest=_digest(logits), ms=ms, steps=fsteps,
                               logits=(logits.cpu() if mesh.coords["model"]
                                       == 0 else None))
                res["stats"] = dict(mesh.stats)
                res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                if name == "h2o" and dname == "bfloat16":
                    mark("mesh_decode h2o bf16 teacher-forced")
                    res.update(_teacher_forced_bf16(cfg, local, mesh, job,
                                                    dev))
                if name == "h2o":
                    # the same prompts through the prefill step below the
                    # threshold: T = 16 whole on every model rank, one
                    # full flash launch a layer
                    short = steps.make_prefill_step(cfg)
                    batch = sharding.local_batch({"tokens": prompts}, mesh,
                                                 cfg)
                    unembed = model._unembed_fn(local, cfg)
                    short(local, batch)
                    h, ms, routes, stats, _ = _mesh_prefill(short, local,
                                                            batch, dev)
                    last = unembed(h[:, -1:].to(dev)).float()
                    scale = float(first.float().abs().max())
                    res["prefill"] = dict(
                        ms=ms, routes=routes, stats=stats,
                        rel_err=float((last - first.float()).abs().max())
                        / scale)
                    if dname == "float32":
                        with maskless_kernel():
                            hb = _mesh_prefill(short, local, batch, dev)[0]
                        lb = unembed(hb[:, -1:].to(dev)).float()
                        res["prefill"]["maskless_rel_err"] = float(
                            (lb - first.float()).abs().max()) / scale
            out[(name, dname)] = res
            del local
            torch.cuda.empty_cache()
    return out


def _teacher_forced_bf16(cfg, local, mesh, job, dev):
    """H2O's bf16 decode on the mesh teacher-forced on the one process's
    f32 greedy tokens (MESH_DECODE_TF_STEPS steps' logits, on model rank
    0), and the first MESH_DECODE_FAULT_STEPS steps with
    ``unrescaled_combine``."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.models import model
    seq = sharding.local_rows(job["f32_tokens"]["h2o"].to(dev), mesh)
    out = {}
    for key, n, planted in (("tf", MESH_DECODE_TF_STEPS,
                             contextlib.nullcontext),
                            ("fault", MESH_DECODE_FAULT_STEPS,
                             unrescaled_combine)):
        state = sharding.local_decode_state(
            model.init_decode_state(cfg, DECODE_B, DECODE_LEN, device=dev),
            mesh, cfg, DECODE_B)
        with planted():
            logits = _decode_logits(cfg, local, state, seq[:, :n])
        out[key] = logits.cpu() if mesh.coords["model"] == 0 else None
        out[key + "_digest"] = _digest(logits)
    return out


def _decode_references(dev):
    """The one process on the card, each model freed before the next:
    H2O's bf16 serve (its tokens and decode ms a step) and its bf16 decode
    teacher-forced on the f32 greedy tokens; every family's f32 greedy
    decode of DECODE_NEW tokens after the prompts, every
    step's logits on the host.  -> (job for the ranks, {name: refs})."""
    import torch
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    job = {"prompts": {}, "f32_tokens": {}, "memory": {}}
    refs = {}
    for name, (arch, _, blayers, _, flayers, _) in MESH_DECODE.items():
        bcfg = _mesh_cfg(arch, "bfloat16", blayers)
        prompts = serve.draw_prompts(0, bcfg, DECODE_B, DECODE_PROMPT, dev)
        job["prompts"][name] = prompts.cpu()
        ref = {}
        cfg = _mesh_cfg(arch, "float32", flayers)
        params = model.init(0, cfg, device=dev)
        state = model.init_decode_state(cfg, DECODE_B, DECODE_LEN, device=dev)
        if "memory" in state:
            state["memory"] = job["memory"][name] = _decode_memory(cfg, dev)
            job["memory"][name] = job["memory"][name].cpu()
        step = steps.make_serve_step(cfg)
        _decode_logits(cfg, params, model.init_decode_state(
            cfg, DECODE_B, 2, device=dev), prompts[:, :2])      # warm-up
        seq, logits = [prompts[:, :1]], []
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in range(DECODE_LEN):
            pos = torch.full((DECODE_B,), t, dtype=torch.int64, device=dev)
            lg, state = step(params, state, seq[t], pos)
            logits.append(lg[:, 0].float().cpu())
            if t + 1 < DECODE_LEN:
                seq.append(prompts[:, t + 1:t + 2] if t + 1 < DECODE_PROMPT
                           else torch.argmax(lg, dim=-1))
        torch.cuda.synchronize(dev)
        ref.update(logits=torch.stack(logits, 1),
                   ms=(time.perf_counter() - t0) * 1e3)
        job["f32_tokens"][name] = torch.cat(seq, 1).cpu()
        refs[name] = ref
        del params, state
        torch.cuda.empty_cache()
        if name == "h2o":
            # the bf16 serve, and the bf16 decode teacher-forced on the f32
            # greedy tokens (the control of the mesh's bf16 check)
            params = model.init(0, bcfg, device=dev)
            serve.generate(params, bcfg, prompts[:, :2], 2)     # warm-up
            tokens, _, times = serve.generate(params, bcfg, prompts,
                                              DECODE_NEW)
            # phase 16 (b)'s one request, served alone
            one, _, one_times = serve.generate(
                params, bcfg, prompts[:MESH_WHOLE_B], DECODE_NEW)
            ref.update(whole_tokens=one.cpu(), whole_times=one_times)
            state = model.init_decode_state(bcfg, DECODE_B, DECODE_LEN,
                                            device=dev)
            ref.update(tokens=tokens.cpu(), times=times,
                       tf_logits=_decode_logits(
                           bcfg, params, state, job["f32_tokens"][name][
                               :, :MESH_DECODE_TF_STEPS].to(dev)).cpu())
            del params, state
            torch.cuda.empty_cache()
    return job, refs


def _bf16_tf_check(res, one, f32_logits, nd, nm, arch):
    """H2O's bf16 mesh decode teacher-forced on the f32 greedy tokens
    against the one process's bf16 decode of them: the worst step's
    error (of max|logits|) within MESH_DECODE_BF16_FACTOR times the one
    process's own bf16-vs-f32 worst step; the unrescaled combine's first
    steps must miss that bound."""
    import torch

    def worst(got, want):
        return max(float((got[:, t] - want[:, t]).abs().max())
                   / float(want[:, t].abs().max())
                   for t in range(got.shape[1]))
    same = all(res[d * nm + m][k] == res[d * nm][k] for k in
               ("tf_digest", "fault_digest") for d in range(nd)
               for m in range(nm))
    got = torch.cat([res[d * nm]["tf"] for d in range(nd)])
    bad = torch.cat([res[d * nm]["fault"] for d in range(nd)])
    want = one["tf_logits"]
    f32_logits = f32_logits[:, :want.shape[1]]
    control = worst(want, f32_logits)
    bound = MESH_DECODE_BF16_FACTOR * control
    err = worst(got, want)
    fault = worst(bad, want[:, :bad.shape[1]])
    ok = same and bool(torch.isfinite(got).all()) and err <= bound
    caught = fault > bound
    check(ok, f"mesh decode (a) {arch} bf16 teacher-forced: worst step "
              f"{err} of max|logits|, bound {bound} ({MESH_DECODE_BF16_FACTOR}"
              f" x the one process's bf16 vs f32 {control}), model ranks "
              f"agree {same}")
    check(caught, f"mesh decode (a) {arch} bf16: the unrescaled combine's "
                  f"{fault} passes the bound {bound}")
    return {"teacher_forced_steps": got.shape[1],
            "teacher_forced_rel_err": err,
            "teacher_forced_bound": bound,
            "one_process_bf16_vs_f32_rel_err": control,
            "mesh_bf16_vs_f32_rel_err": worst(got, f32_logits),
            "teacher_forced_fault_rel_err": fault,
            "teacher_forced_fault_caught": caught,
            "teacher_forced_ok": ok and caught}


def mesh_decode_path(dev, smi):
    """Phase 15 (a generator, as phase 12's): decode and the short prefill
    on the model mesh, 4 rank processes of the card, every one-process
    reference computed first.
    (a) H2O-Danube3-4B at full width and depth serves the reference
    driver's 4 x (16 + 32) in bf16 on (2, 2) through ``serve.generate``
    (the KV cache's slots over model, B over data), and decodes in f32 on
    (1, 4), teacher-forced on the one process's greedy tokens: every
    step's logits within MESH_DECODE_RTOL of max|logits| of one process;
    its bf16 decode on (2, 2) teacher-forced on the same tokens within
    MESH_DECODE_BF16_FACTOR times the one process's bf16-vs-f32 error of
    the one process's bf16 logits, and an unrescaled combine missing
    that (``_bf16_tf_check``);
    (b) the same prompts through the prefill step below the
    sequence-parallel threshold (T = 16 whole on every model rank): 24
    full flash launches a rank on the dtype's route, the f32 last-position
    logits within MESH_DECODE_RTOL of the mesh decode loop's after the
    prompt, and with the kernel's mask removed (non-causal; the window of
    4096 masks nothing at T = 16) missing it; (c) Granite-3.0-1B-A400M
    (its own capacity factor: 4 tokens a step, C = K = 8, nothing can
    overflow) and RWKV6-7B on (2, 2), Zamba2-2.7B on (1, 4), SeamlessM4T-
    medium on (2, 2) (its f32 decode against a memory drawn from a seed)
    and InternVL2-26B at 16 layers on (1, 4) serve the same in bf16, each
    with its f32 check (MESH_DECODE's depths and steps).  Recorded, not
    held: ms a decode step a rank against one process, ``Mesh.stats``
    calls, bytes and staged ms a step, peak GB a rank, the bf16 tokens'
    agreement with one process (H2O).  -> {dtype: flash launches by route
    of the short prefills}."""
    import torch
    from repro_torch.kernels.attention import flash
    t0 = time.perf_counter()
    job, refs = _decode_references(dev)
    DECODE_SHARED.update(job=job, refs=refs)
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_decode_mesh_rank", (job,), t0)
    by_route = {"bfloat16": {r: 0 for r in flash.ROUTES},
                "float32": {r: 0 for r in flash.ROUTES}}
    for name, (arch, bmesh, blayers, fmesh, flayers, fsteps) in \
            MESH_DECODE.items():
        part = "a" if name == "h2o" else "c"
        for dname, mname, layers in (("bfloat16", bmesh, blayers),
                                     ("float32", fmesh, flayers)):
            cfg = _mesh_cfg(arch, dname, layers)
            nd, nm = FAMILY_MESHES[mname]
            res = [pr[(name, dname)] for pr in per_rank]
            steps_n = res[0]["steps"]
            line = {"phase": "mesh_decode", "part": part, "arch": arch,
                    "dtype": dname, "mesh": {"data": nd, "model": nm},
                    "requests": DECODE_B, "prompt_len": DECODE_PROMPT,
                    "new_tokens": DECODE_NEW, "num_layers": cfg.num_layers,
                    "reduced": MESH_DECODE_CUTS.get((name, dname), [])
                    + ([MESH_DECODE_F32_CUT] if dname == "float32"
                       and fsteps < DECODE_LEN else []),
                    "collectives_per_step_by_rank": [
                        {k: v / steps_n for k, v in x["stats"].items()
                         if k in ("calls", "bytes", "ms")}
                        for x in res],
                    "peak_gb_by_rank": [x["peak_gb"] for x in res],
                    "card": smi}
            if dname == "bfloat16":
                toks = [torch.cat([res[d * nm + m]["tokens"]
                                   for d in range(nd)]) for m in range(nm)]
                same = all(torch.equal(t, toks[0]) for t in toks)
                good = (same and tuple(toks[0].shape) == (DECODE_B,
                                                          DECODE_NEW)
                        and int(toks[0].min()) >= 0
                        and int(toks[0].max()) < cfg.vocab_size)
                check(good, f"mesh decode ({part}) {arch} bf16: tokens "
                            f"{tuple(toks[0].shape)}, model ranks agree "
                            f"{same}")
                line.update(
                    ok=good, model_ranks_agree=same,
                    first_tokens=toks[0][0, :8].tolist(),
                    ms_per_decode_step_by_rank=[
                        x["times"]["decode_s"] * 1e3 / (DECODE_NEW - 1)
                        for x in res],
                    prefill_s_by_rank=[x["times"]["prefill_s"]
                                       for x in res])
                if "tokens" in refs[name]:
                    one = refs[name]
                    f32_new = job["f32_tokens"][name][:, DECODE_PROMPT:]
                    line.update(
                        ms_per_decode_step_one_process=one["times"][
                            "decode_s"] * 1e3 / (DECODE_NEW - 1),
                        tokens_equal_one_process_share=float(
                            (toks[0] == one["tokens"]).float().mean()),
                        one_process_bf16_f32_tokens_equal_share=float(
                            (one["tokens"][:, :f32_new.shape[1]]
                             == f32_new).float().mean()))
                    tf = _bf16_tf_check(res, one, refs[name]["logits"],
                                        nd, nm, arch)
                    line.update(tf)
                    line["ok"] = good and tf["teacher_forced_ok"]
            else:
                want = refs[name]["logits"][:, :steps_n]
                digests = [x["digest"] for x in res]
                same = all(digests[d * nm + m] == digests[d * nm]
                           for d in range(nd) for m in range(nm))
                got = torch.cat([res[d * nm]["logits"] for d in range(nd)])
                errs = [float((got[:, t] - want[:, t]).abs().max())
                        / float(want[:, t].abs().max())
                        for t in range(steps_n)]
                finite = bool(torch.isfinite(got).all())
                ok = same and finite and max(errs) <= MESH_DECODE_RTOL
                check(ok, f"mesh decode ({part}) {arch} f32: worst step "
                          f"{max(errs)} of max|logits| (rtol "
                          f"{MESH_DECODE_RTOL}), model ranks agree {same}")
                line.update(ok=ok, model_ranks_agree=same, steps=steps_n,
                            rel_err_by_step=errs, rel_err=max(errs),
                            rtol=MESH_DECODE_RTOL,
                            ms_per_step_by_rank=[x["ms"] / steps_n
                                                 for x in res],
                            ms_per_step_one_process=refs[name]["ms"]
                            / DECODE_LEN)
            emit(line)
            if name == "h2o":
                pre = [x["prefill"] for x in res]
                want_route = flash.route(cfg.dtype, cfg.head_dim)
                L = cfg.num_layers
                launches_ok = all(x["routes"] == {r: L * (r == want_route)
                                                  for r in flash.ROUTES}
                                  for x in pre)
                for x in pre:
                    for rt, n in x["routes"].items():
                        by_route[dname][rt] += n
                check(launches_ok, f"mesh decode (b) {arch} {dname}: "
                                   f"launches by rank "
                                   f"{[x['routes'] for x in pre]}, want {L} "
                                   f"on {want_route}")
                err = max(x["rel_err"] for x in pre)
                pl = {"phase": "mesh_decode", "part": "b", "arch": arch,
                      "dtype": dname, "mesh": {"data": nd, "model": nm},
                      "batch": DECODE_B, "seq_len": DECODE_PROMPT,
                      "launches_by_rank": [x["routes"] for x in pre],
                      "ms_per_prefill_by_rank": [x["ms"] for x in pre],
                      "collectives_by_rank": [x["stats"] for x in pre],
                      "last_logits_rel_err_vs_decode": err,
                      "ok": launches_ok, "card": smi}
                if dname == "float32":
                    ok = err <= MESH_DECODE_RTOL
                    bad = min(x["maskless_rel_err"] for x in pre)
                    caught = bad > MESH_DECODE_RTOL
                    check(ok, f"mesh decode (b) {arch} f32: prefill's last "
                              f"logits {err} of max|logits| from the "
                              "decode loop's")
                    check(caught, f"mesh decode (b) {arch} f32: the maskless "
                                  f"kernel's {bad} passes the check")
                    pl.update(ok=ok and caught and launches_ok,
                              rtol=MESH_DECODE_RTOL,
                              maskless_rel_err=bad, maskless_caught=caught)
                emit(pl)
    DECODE_SHARED["h2o_bf16_ms_by_rank"] = [
        pr[("h2o", "bfloat16")]["times"]["decode_s"] * 1e3 / (DECODE_NEW - 1)
        for pr in per_rank]
    emit({"phase": "mesh_decode", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s, "card": smi})
    return by_route


# -- phase 16: the int8 wire on the mesh step, and one request on (2, 2) -----

# (a) phase 13 (a)'s H2O step (1 layer, full width, (2, 2)) with int8_gmom
# on the int8_stochastic wire: one step of each variant
MESH_INT8_STEPS = {"shard_local": 1, "gathered": 1}
# the shard-local payload's leaves checked against the unsharded encode:
# the embedding (cut over both axes) and the SwiGLU's gate (data x model);
# all twelve took 17 s of gathering and encoding on 4 ranks of one H100
MESH_INT8_CHECKED = ("['embed']", "['layers']['mlp']['w_gate']")
# (b) H2O-Danube3-4B serves one request on (2, 2): rows the data axes do
# not divide, whole on every rank (the reference's serve_batch_spec
# (None,)); its prompt is phase 15's first, its f32 check phase 15's one
# process's greedy tokens and logits of that row
MESH_WHOLE_B = 1
MESH_WHOLE_PREFILL_LAYERS = 8
MESH_WHOLE_PREFILL_CUTS = ["24 layers cut to 8"]
MESH_WHOLE_PREFILL_SEED = 41


def _mesh_int8_rc(backend):
    import dataclasses
    return dataclasses.replace(
        _mesh_train_rc(MESH_TRAIN["k"], MESH_TRAIN["q"], backend),
        aggregator="int8_gmom", compression="int8_stochastic")


class _Int8Wire:
    """Phase 16 (a)'s view of the int8_stochastic wire for a ``with``
    block: the codec's encode keeps (its stacked input, key, payload) of
    the shard-local step's 2D layout; every block draw
    (``shard_aggregation.draw_block``) records the most memory it took
    above what the card held when it began, beyond its output, and the
    peak the card reached before it (the draw resets the peak)."""

    def __init__(self, dev):
        self.dev, self.kept, self.draw_bytes, self.peak_before = dev, [], 0, 0

    def _encode(self, stacked, *, key=None, shard_spec=None):
        payload = self.codec.encode(stacked, key=key, shard_spec=shard_spec)
        if shard_spec is not None and shard_spec.layout is not None:
            self.kept.append((stacked, key, payload))
        return payload

    def _draw(self, spec, block, key, dist):
        import torch
        torch.cuda.synchronize(self.dev)
        self.peak_before = max(self.peak_before,
                               torch.cuda.max_memory_allocated(self.dev))
        start = torch.cuda.memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        out = self.real_draw(spec, block, key, dist)
        torch.cuda.synchronize(self.dev)
        self.draw_bytes = max(
            self.draw_bytes, torch.cuda.max_memory_allocated(self.dev)
            - start - out.numel() * out.element_size())
        return out

    def __enter__(self):
        import dataclasses

        from repro_torch.core import compression
        from repro_torch.core import shard_aggregation as sa
        self.codec = compression.get_codec("int8_stochastic")
        compression._REGISTRY["int8_stochastic"] = dataclasses.replace(
            self.codec, encode=self._encode)
        self.real_draw, sa.draw_block = sa.draw_block, self._draw
        return self

    def __exit__(self, *exc):
        from repro_torch.core import compression
        from repro_torch.core import shard_aggregation as sa
        compression._REGISTRY["int8_stochastic"] = self.codec
        sa.draw_block = self.real_draw

    def check(self, stacked_specs, mesh, names):
        """The leaves ``names`` of the kept payload against the cut of the
        unsharded encode of the stack gathered whole, with the same key:
        those leaves gathered, every other leaf a (k, 1, ...) stand-in
        that keeps the leaf order (each leaf's key is its place), the
        encode one rank at a time -> {leaf: (its spec, q block equal and
        scales bit-equal)}."""
        import torch
        from torch.utils._pytree import keystr, tree_flatten_with_path
        from torch.utils._pytree import tree_leaves, tree_unflatten
        from repro_torch.launch import sharding
        from repro_torch.models import meshctx
        stacked, key, payload = self.kept[0]
        self.kept.clear()
        flat, treedef = tree_flatten_with_path(stacked)
        specs = sharding.spec_leaves(stacked, stacked_specs)
        leaves = []
        for (path, g), spec in zip(flat, specs):
            if keystr(path) in names:
                leaves.append(sharding.gather_tree({"g": g}, {"g": spec},
                                                   mesh)["g"])
            else:
                leaves.append(g.new_zeros((g.shape[0],) + (1,) * (g.ndim
                                                                 - 1)))
        del stacked, flat
        picked = [(i, keystr(p)) for i, (p, _) in enumerate(
            tree_flatten_with_path(payload["q"])[0]) if keystr(p) in names]

        def compare():
            plain = self.codec.encode(tree_unflatten(leaves, treedef),
                                      key=key)
            q, s = tree_leaves(payload["q"]), tree_leaves(payload["scale"])
            pq, ps = tree_leaves(plain["q"]), tree_leaves(plain["scale"])
            return {name: (specs[i], bool(
                torch.equal(q[i], meshctx.cut(pq[i], specs[i], mesh.coords,
                                              mesh.shape))
                and torch.equal(s[i].view(torch.int32),
                                ps[i].view(torch.int32))))
                for i, name in picked}
        try:
            return meshctx.one_card_turns(mesh, compare, self.dev)
        finally:
            leaves.clear()


def _mesh_whole_rank(rank, world, device, job):
    """Phase 16 on one rank of the card: (a) phase 13 (a)'s H2O step on
    the int8 wire, each variant, the shard-local payload checked against
    the unsharded encode of the gathered stack; (b) one request served
    on (2, 2): bf16 through ``serve.generate``, f32 teacher-forced, and
    the B = 1 prefill at T = 8192 on the kernel and the plain path."""
    import torch
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, sharding, steps
    from repro_torch.models import meshctx, model
    dev = torch.device(device)
    torch.set_float32_matmul_precision("highest")
    square = mesh_lib.make_mesh((2, world // 2), ("data", "model"))
    out = {"coords": dict(square.coords)}
    g = MESH_TRAIN
    cfg = mesh_train_config(TRAIN_ARCH)
    full = model.init(MESH_TRAIN_SEED, cfg, device=dev)
    specs = sharding.param_shardings(full, square, cfg)
    stacked = sharding.stacked_grad_shardings(full, square, cfg)
    stream, key = _mesh_train_stream(cfg, dev), _mesh_train_key(dev)
    with meshctx.set_mesh(square):
        for variant, n in MESH_INT8_STEPS.items():
            mark(f"mesh_whole (a) h2o int8 {variant}")
            with _Int8Wire(dev) as wire:
                res = _mesh_train_variant(
                    cfg, square, variant, full, specs, dev, n,
                    _mesh_int8_rc("auto"), optim.adamw(g["lr"]),
                    stream.batch, lambda t: prng.fold_in(key, t),
                    check_first=True)
            res["peak_gb"] = max(res["peak_gb"], wire.peak_before / 1e9)
            res["dry"]["peak"] = max(res["dry"]["peak"], wire.peak_before)
            res["draw_extra_gb"] = wire.draw_bytes / 1e9
            if variant == "shard_local":
                mark("mesh_whole (a) payload check")
                res["payload_equal"] = wire.check(stacked, square,
                                                  MESH_INT8_CHECKED)
            out[("int8", variant)] = res
            torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    # (b) one request on (2, 2), its rows whole on every rank
    prompts = job["prompts"][:MESH_WHOLE_B].to(dev)
    for dname in ("bfloat16", "float32"):
        mark(f"mesh_whole (b) h2o {dname}")
        cfg = _mesh_cfg(SERVE_ARCH, dname)
        local = _decode_local(cfg, square, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with meshctx.set_mesh(square):
            square.reset_stats()
            if dname == "bfloat16":
                rows = sharding.local_rows(prompts, square)
                tokens, _, times = serve.generate(local, cfg, rows,
                                                  DECODE_NEW,
                                                  batch=MESH_WHOLE_B)
                res = dict(tokens=tokens.cpu(), times=times,
                           steps=DECODE_LEN - 1, rows=rows.shape[0])
            else:
                seq = sharding.local_rows(
                    job["f32_tokens"][:MESH_WHOLE_B].to(dev), square)
                state = sharding.local_decode_state(
                    model.init_decode_state(cfg, MESH_WHOLE_B, DECODE_LEN,
                                            device=dev), square, cfg,
                    MESH_WHOLE_B)
                logits, ms = _synced_ms(
                    lambda: _decode_logits(cfg, local, state, seq), dev)
                res = dict(digest=_digest(logits), ms=ms, steps=DECODE_LEN,
                           logits=logits.cpu() if rank == 0 else None)
            res["stats"] = dict(square.stats)
            res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[("whole", dname)] = res
        del local
        torch.cuda.empty_cache()
    mark("mesh_whole (b) prefill")
    cfg = _mesh_cfg(SERVE_ARCH, "bfloat16", MESH_WHOLE_PREFILL_LAYERS)
    local = _decode_local(cfg, square, dev)
    with meshctx.set_mesh(square):
        batch = sharding.local_batch({"tokens": job["prefill"].to(dev)},
                                     square, cfg)
        kernel = steps.make_prefill_step(cfg)
        plain = steps.make_prefill_step(cfg, plain=True)
        kernel(local, batch)                                  # warm-up
        h, ms, routes, stats, _ = _mesh_prefill(kernel, local, batch, dev)
        hp, plain_ms, plain_routes, _, _ = _mesh_prefill(plain, local,
                                                         batch, dev)
    out["prefill"] = dict(
        rows_whole=batch.rows_whole, shape=list(h.shape), ms=ms,
        plain_ms=plain_ms, routes=routes, plain_routes=plain_routes,
        stats=stats, digest=_digest(h),
        finite=bool(torch.isfinite(h.float()).all()),
        rel_err=float((h.float() - hp.float()).abs().max())
        / float(hp.float().abs().max()))
    del local
    torch.cuda.empty_cache()
    return out


def mesh_whole_path(dev, smi):
    """Phase 16 (a generator, as phase 12's), on the 4 rank processes of
    the card.
    (a) Phase 13 (a)'s H2O-Danube3-4B step (full width, 1 layer, (2, 2),
    k = 4, q = 1, sign_flip, AdamW) with int8_gmom on the int8_stochastic
    wire, 1 shard-local and 1 gathered step: in the shard-local step
    each rank's ``q`` block and the scales of MESH_INT8_CHECKED's leaves
    (the embedding and the SwiGLU's gate, each cut over both axes)
    bit-equal to the cut of the unsharded encode of the stack gathered
    whole, with the step's key; the round kernel once a rank in the
    gathered step, never shard-local;
    the metrics within ``compare_traces`` and the first aggregate within
    MESH_TRAIN_AGG_RTOL (each leaf's relative norm) of one process's int8
    step; the params after it its AdamW update, bit for bit; the same
    metrics on every rank.  Recorded: s a step, peak GB a rank and the
    block draw's most memory beyond its output.
    (b) H2O at full width and depth serves one request (phase 15's first
    prompt, 16 + 32 tokens) on (2, 2): the rows the data axes do not
    divide whole on every rank; bf16 through ``serve.generate``, every
    rank's tokens the same bits; f32 teacher-forced on the one process's
    greedy tokens of that row, every step within MESH_DECODE_RTOL of
    max|logits| of its logits (phase 15's references); the B = 1 prefill
    at T = 8192 and 8 layers in bf16, whole on every rank (below the
    sequence-parallel threshold: B % data != 0), its flash kernel's full
    launch (one a layer a rank on the tensor cores) against the plain
    path within PREFILL_RTOL.  Recorded: ms a decode step a rank against
    B = 4's (phase 15) and one process's B = 1.
    -> (round-kernel launches, {dtype: flash launches by route})."""
    import torch
    from repro_torch.kernels.attention import flash
    from repro_torch.sim.goldens import compare_traces
    t0 = time.perf_counter()
    ref = mesh_train_reference(dev, "auto", 1, rc=_mesh_int8_rc("auto"))
    torch.cuda.empty_cache()
    pcfg = _mesh_cfg(SERVE_ARCH, "bfloat16", MESH_WHOLE_PREFILL_LAYERS)
    job = {"prompts": DECODE_SHARED["job"]["prompts"]["h2o"],
           "f32_tokens": DECODE_SHARED["job"]["f32_tokens"]["h2o"],
           "prefill": _mesh_tokens(pcfg, MESH_WHOLE_B, PREFILL_T, dev,
                                   seed=MESH_WHOLE_PREFILL_SEED).cpu()}
    one = DECODE_SHARED["refs"]["h2o"]
    ref_s = time.perf_counter() - t0
    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_mesh_whole_rank", (job,), t0)
    launches = 0
    # (a) the int8 wire
    for variant, n in MESH_INT8_STEPS.items():
        res = [pr[("int8", variant)] for pr in per_rank]
        DRY_SHARED[("int8", variant)] = [x["dry"] for x in res]
        vs = compare_traces(_compared(res[0]["rows"]), _compared(ref[0][:n]))
        same_rows = all(x["rows"] == res[0]["rows"] for x in res)
        want_launches = n if variant == "gathered" else 0
        n_launch = [x["launches"] for x in res]
        launches += sum(n_launch)
        first = res[0]["first"]
        rel = _rel_norms(first["agg"], ref[3], dev)
        agg_err = max(rel.values())
        ok = (not vs and same_rows and agg_err <= MESH_TRAIN_AGG_RTOL
              and first["update_exact"]
              and all(x == want_launches for x in n_launch))
        line = {"phase": "mesh_whole", "part": "a", "arch": TRAIN_ARCH,
                "variant": variant, "mesh": {"data": 2, "model": 2},
                "aggregator": "int8_gmom", "compression": "int8_stochastic",
                "reduced": MESH_TRAIN_CUTS, **MESH_TRAIN, "steps": n,
                "history_by_rank0": res[0]["rows"],
                "history_one_process": ref[0][:n],
                "launches_by_rank": n_launch,
                "agg_worst_rel_norm_err": agg_err,
                "agg_worst_leaves": _worst_leaves(rel),
                "agg_rtol": MESH_TRAIN_AGG_RTOL,
                "update_of_aggregate_exact": first["update_exact"],
                "s_per_step_by_rank": [x["s_per_step"] for x in res],
                "s_per_step_one_process": ref[1],
                "stage_s_by_rank": [x["stages"] for x in res],
                "peak_gb_by_rank": [x["peak_gb"] for x in res],
                "peak_gb_one_process": ref[2],
                "block_draw_extra_gb_by_rank": [x["draw_extra_gb"]
                                                for x in res],
                "card": smi}
        if variant == "shard_local":
            eq = [x["payload_equal"] for x in res]
            both = [k for k, (spec, _) in eq[0].items()
                    if len({a for e in spec if e for a in (
                        (e,) if isinstance(e, str) else e)}) >= 2]
            leaves_ok = all(set(e) == set(MESH_INT8_CHECKED)
                            and all(v for _, v in e.values()) for e in eq)
            ok = ok and leaves_ok and bool(both)
            line.update(payload_leaves_checked={
                k: list(spec) for k, (spec, _) in eq[0].items()},
                payload_leaves_cut_over_both_axes=both,
                payload_equal_by_rank=[sum(v for _, v in e.values())
                                       for e in eq],
                payload_bad=[k for e in eq for k, (_, v) in e.items()
                             if not v])
        line["ok"] = ok
        check(ok, f"mesh whole (a) int8 {variant}: vs one process "
                  f"{vs[:3]}, aggregate {agg_err}, launches {n_launch}, "
                  f"payload {line.get('payload_bad')}")
        emit(line)
    # (b) one request on (2, 2)
    bres = [pr[("whole", "bfloat16")] for pr in per_rank]
    toks = [x["tokens"] for x in bres]
    same = all(torch.equal(t, toks[0]) for t in toks)
    good = (same and all(x["rows"] == MESH_WHOLE_B for x in bres)
            and tuple(toks[0].shape) == (MESH_WHOLE_B, DECODE_NEW)
            and int(toks[0].min()) >= 0
            and int(toks[0].max()) < _mesh_cfg(SERVE_ARCH).vocab_size)
    check(good, f"mesh whole (b) bf16: tokens {tuple(toks[0].shape)}, "
                f"ranks agree {same}")
    per_step = DECODE_NEW - 1
    emit({"phase": "mesh_whole", "part": "b", "arch": SERVE_ARCH,
          "dtype": "bfloat16", "mesh": {"data": 2, "model": 2},
          "requests": MESH_WHOLE_B, "prompt_len": DECODE_PROMPT,
          "new_tokens": DECODE_NEW, "ok": good, "ranks_agree": same,
          "ms_per_decode_step_by_rank": [
              x["times"]["decode_s"] * 1e3 / per_step for x in bres],
          "ms_per_decode_step_b4_by_rank": DECODE_SHARED.get(
              "h2o_bf16_ms_by_rank"),
          "ms_per_decode_step_one_process": one["whole_times"][
              "decode_s"] * 1e3 / per_step,
          "tokens_equal_one_process_share": float(
              (toks[0] == one["whole_tokens"]).float().mean()),
          "collectives_per_step_by_rank": [
              {k: v / x["steps"] for k, v in x["stats"].items()
               if k in ("calls", "bytes", "ms")}
              for x in bres],
          "peak_gb_by_rank": [x["peak_gb"] for x in bres], "card": smi})
    fres = [pr[("whole", "float32")] for pr in per_rank]
    got = fres[0]["logits"]
    want = one["logits"][:MESH_WHOLE_B]
    errs = [float((got[:, t] - want[:, t]).abs().max())
            / float(want[:, t].abs().max()) for t in range(DECODE_LEN)]
    same = all(x["digest"] == fres[0]["digest"] for x in fres)
    ok = same and bool(torch.isfinite(got).all()) \
        and max(errs) <= MESH_DECODE_RTOL
    check(ok, f"mesh whole (b) f32: worst step {max(errs)} of max|logits| "
              f"(rtol {MESH_DECODE_RTOL}), ranks agree {same}")
    emit({"phase": "mesh_whole", "part": "b", "arch": SERVE_ARCH,
          "dtype": "float32", "mesh": {"data": 2, "model": 2},
          "requests": MESH_WHOLE_B, "steps": DECODE_LEN, "ok": ok,
          "ranks_agree": same, "rel_err": max(errs),
          "rel_err_by_step": errs, "rtol": MESH_DECODE_RTOL,
          "ms_per_step_by_rank": [x["ms"] / DECODE_LEN for x in fres],
          "peak_gb_by_rank": [x["peak_gb"] for x in fres], "card": smi})
    pre = [pr["prefill"] for pr in per_rank]
    want_route = flash.route(pcfg.dtype, pcfg.head_dim)
    L = pcfg.num_layers
    by_route = {"bfloat16": {r: 0 for r in flash.ROUTES},
                "float32": {r: 0 for r in flash.ROUTES}}
    for x in pre:
        for rt, k in x["routes"].items():
            by_route["bfloat16"][rt] += k
    launches_ok = all(x["routes"] == {r: L * (r == want_route)
                                      for r in flash.ROUTES}
                      and not any(x["plain_routes"].values()) for x in pre)
    err = max(x["rel_err"] for x in pre)
    same = all(x["digest"] == pre[0]["digest"] for x in pre)
    ok = (launches_ok and same and all(x["rows_whole"] and x["finite"]
                                       for x in pre)
          and err <= PREFILL_RTOL["bfloat16"])
    check(ok, f"mesh whole (b) prefill: kernel vs plain {err} (rtol "
              f"{PREFILL_RTOL['bfloat16']}), launches "
              f"{[x['routes'] for x in pre]}, ranks agree {same}")
    emit({"phase": "mesh_whole", "part": "b", "arch": SERVE_ARCH,
          "what": "prefill", "dtype": "bfloat16",
          "mesh": {"data": 2, "model": 2}, "batch": MESH_WHOLE_B,
          "seq_len": PREFILL_T, "num_layers": L,
          "reduced": MESH_WHOLE_PREFILL_CUTS, "ok": ok,
          "rel_err_vs_plain": err, "rtol": PREFILL_RTOL["bfloat16"],
          "launches_by_rank": [x["routes"] for x in pre],
          "ranks_agree": same,
          "ms_by_rank": [x["ms"] for x in pre],
          "plain_ms_by_rank": [x["plain_ms"] for x in pre],
          "collectives_by_rank": [x["stats"] for x in pre], "card": smi})
    emit({"phase": "mesh_whole", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s, "card": smi})
    return launches, by_route


# -- phase 17: the pod dry run held to the card --------------------------------

# the dry run's peak against a rank's measured one: the reference's memory
# tolerance (its pod sweep's RTOL_MEMORY, src/repro/sim/sweep.py)
DRY_PEAK_RTOL = 0.25
# phase 13 (a)'s and 16 (a)'s steps, by the wire they take
DRY_STEPS = (("none", "shard_local"), ("none", "gathered"),
             ("int8", "shard_local"), ("int8", "gathered"))
# (b): pairs of the pod dry run on the (16, 16) mesh, rank 0; cut to the
# prefill (the flash op's path) after a run of the script passed 1000 s
# on a slow host (H2O's train_4k trace takes 50 s of a worker; (a) traces
# that step's program at (2, 2))
DRY_PAIRS = (("h2o-danube-3-4b", "prefill_32k"),)
# worker processes of the traces, started (and their imports done) before
# the mesh phases; (b) runs then too, as it needs nothing of them
DRY_WORKERS = 8
# phase 13's and 16's per-rank records of the first step, by (wire,
# variant)
DRY_SHARED = {}


def _dry_job(job):
    """One dry run of phase 17 in a worker process: ("step", wire,
    variant, rank, reads) traces phase 13 (a)'s (wire "none") or 16 (a)'s
    (wire "int8") first step on rank ``rank`` of the (2, 2) mesh, its
    host Weiszfeld loop capped at ``reads`` iterations (the real step's
    count; 0 where the loop is the round kernel's, on the card);
    ("pair", arch, shape) traces ``dryrun_pair`` on the (16, 16) mesh;
    ("micro", ...) and ("sweep", ...) are phase 18's (``_sweep_job``).
    All on fake cuda tensors -> the record as a dict."""
    import dataclasses

    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    if job[0] == "pair":
        return dryrun.dryrun_pair(job[1], job[2], verbose=False).to_dict()
    if job[0] in ("micro", "sweep"):
        return _sweep_job(job)
    _, wire, variant, rank, reads = job
    g = MESH_TRAIN
    rc = (_mesh_int8_rc("auto") if wire == "int8"
          else _mesh_train_rc(g["k"], g["q"], "auto"))
    if reads:       # the gathered step's loop is the round kernel's own
        rc = dataclasses.replace(rc, gmom_max_iters=reads)
    art = dryrun.lower_pair(
        mesh_train_config(TRAIN_ARCH),
        InputShape("mesh_train", TRAIN_SEQ, g["batch"], "train"),
        mesh=mesh_lib.make_mesh((2, MESH_RANKS // 2), ("data", "model"),
                                rank=rank),
        num_groups=g["k"], microbatches=g["microbatches"], rc=rc,
        gather_grads=variant == "gathered", verbose=False)
    return art.record.to_dict()


def _ops_equal_their_launches(dev):
    """(c): the custom ops' results against the direct launches of their
    CUDA implementations (the path before the ops) on the same inputs:
    the round op at phase 13's gathered (k, k, P) block, the flash op at
    the mesh prefill's sequence-parallel shape and query offsets, bf16
    -> {name: torch.equal}."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.geomed import round as rk
    out = {}
    k = MESH_TRAIN["k"]
    P = cfg_param_leaves(mesh_train_config(TRAIN_ARCH))
    gen = torch.Generator(device=dev).manual_seed(17)
    g = torch.randn((k, P), generator=gen, device=dev)
    grouping = make_grouping(k, k)
    kw = dict(trim_multiplier=3.0, max_iters=32, tol=1e-7, eps=1e-12)
    y, it = rk.round_aggregate_kernel(g, grouping, **kw)
    y0, it0 = rk._launch(g, *rk._grouping_on(grouping, dev),
                         *rk._round_args(k, kw["trim_multiplier"],
                                         kw["max_iters"], kw["tol"],
                                         kw["eps"]))
    out["round_aggregate"] = bool(torch.equal(y, y0)) and int(it) == int(
        it0[0])
    del g, y, y0
    torch.cuda.empty_cache()
    B, Tq, Tk, H, KV, hd, causal, window = SP_SHAPE
    q, kk, v = attn_inputs(SP_SHAPE, torch.bfloat16, dev, seed=5)
    same = True
    for r in range(MESH_RANKS):
        off = r * Tq
        a = flash.flash_attention(q, kk, v, causal=causal,
                                  sliding_window=window, q_offset=off)
        b = flash._launch(q, kk, v, causal, window, off)
        same = same and bool(torch.equal(a, b))
    out["flash_attention"] = same
    return out


def _op_dispatch_ms(dev):
    """(c): what an op's dispatch costs: the op and the direct launch of
    its CUDA implementation timed in turns (op, launch, launch, op;
    ``timed`` and ``host_ms``, the better of each path's two) at the
    kernel line's shapes, MAIN_SHAPE and ATTN_MAIN, bf16 -> {name: {path:
    {"ms", "host_ms"}}}."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.geomed import round as rk

    def turns(op, launch):
        got = {}
        for name, fn in (("op", op), ("launch", launch), ("launch", launch),
                         ("op", op)):
            got.setdefault(name, []).append((timed(fn), host_ms(fn)))
        return {name: {"ms": min(t for t, _ in v),
                       "host_ms": min(h for _, h in v)}
                for name, v in got.items()}

    m, k, d = MAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(18)
    g = torch.randn((m, d), generator=gen, device=dev)
    grouping = make_grouping(m, k)
    plan = (*rk._grouping_on(grouping, dev), *rk._round_args(
        k, 3.0, 64, 1e-8, 1e-12))
    dispatch = {"round_aggregate": turns(
        lambda: rk.round_aggregate_kernel(g, grouping),
        lambda: rk._launch(g, *plan))}
    B, Tq, Tk, H, KV, hd, causal, window = ATTN_MAIN
    q, kk, v = attn_inputs(ATTN_MAIN, torch.bfloat16, dev, seed=6)
    dispatch["flash_attention"] = turns(
        lambda: flash.flash_attention(q, kk, v, causal=causal,
                                      sliding_window=window),
        lambda: flash._launch(q, kk, v, causal, window, 0))
    return dispatch


def _dry_warm(_):
    """A worker's imports, done before its first trace."""
    from repro_torch.launch import dryrun  # noqa: F401


def dry_run_start():
    """Phase 17's DRY_WORKERS worker processes, started before the mesh
    phases with their imports done, and the traces that need nothing of
    the mesh phases submitted: 17 (b)'s, then 18's (``_sweep_jobs``) ->
    (the pool, 17 (b)'s futures, 18's {job: future})."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=DRY_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    for _ in range(DRY_WORKERS):
        pool.submit(_dry_warm, None)
    pairs = [pool.submit(_dry_job, ("pair", arch, shape))
             for arch, shape in DRY_PAIRS]
    return pool, pairs, {job: pool.submit(_dry_job, job)
                         for job in _sweep_jobs()}


def dry_run_path(dev, smi, started):
    """Phase 17, on the host after the mesh phases: the pod dry run held
    to the card.
    (a) For every rank of phases 13 (a) and 16 (a)'s first steps (H2O at
    full width, 1 layer, (2, 2), both variants, the none and the int8
    wire), the dry run of the same step on fake cuda tensors of the same
    rank (its Weiszfeld loop capped at the real step's iterations) must
    give exactly the real step's collectives by kind (calls,
    result_bytes, wire_bytes) and the bytes received by group, the
    layout's blocked-sum gathers among them; its peak must lie within
    DRY_PEAK_RTOL of the rank's measured peak of the step (the card's
    peak over the step, reset before it, less what the card held before
    it beside the step's inputs).
    (b) ``dryrun_pair`` of DRY_PAIRS on the (16, 16) mesh: the records
    and each trace's seconds.
    (c) The round op and the flash op ``torch.equal`` to the direct
    launches of their CUDA implementations.
    The traces run in ``started``'s pool (``dry_run_start``), (a)'s the
    int8 wire's first (the longest)."""
    t0 = time.perf_counter()
    pool, pair_futures, _ = started
    jobs = [("step", wire, variant, rank, DRY_SHARED[(wire, variant)][rank]
             ["reads"]) for wire, variant in reversed(DRY_STEPS)
            for rank in range(MESH_RANKS)]
    with pool:
        futures = [pool.submit(_dry_job, job) for job in jobs]
        equal = _ops_equal_their_launches(dev)
        records = [f.result() for f in futures]
        jobs = [("pair", arch, shape) for arch, shape in DRY_PAIRS] + jobs
        records = [f.result() for f in pair_futures] + records
    traced_s = time.perf_counter() - t0
    dispatch = _op_dispatch_ms(dev)
    n = len(DRY_PAIRS)
    for (_, arch, shape), rec in zip(jobs[:n], records[:n]):
        emit({"phase": "dry_run", "part": "b", "arch": arch, "shape": shape,
              "mesh": rec["mesh"], "rank": rec["rank"],
              "trace_seconds": rec["trace_seconds"], "record": rec,
              "card": smi})
    ratios, worst = {}, 0.0
    for (_, wire, variant, rank, reads), rec in zip(jobs[n:], records[n:]):
        real = DRY_SHARED[(wire, variant)][rank]
        groups = {key: v["wire_bytes"]
                  for key, v in rec["collective_groups"].items()}
        same = (rec["collective_breakdown"] == real["kinds"]
                and groups == real["groups"])
        peak = real["peak"] - real["base"] + real["inputs"]
        ratio = rec["peak_memory_bytes"] / peak
        ratios[f"{wire}/{variant}/{rank}"] = ratio
        worst = max(worst, abs(ratio - 1.0))
        check(same, f"dry run (a) {wire} {variant} rank {rank}: collectives "
                    f"{rec['collective_breakdown']} {groups}, the real step's "
                    f"{real['kinds']} {real['groups']}")
        check(abs(ratio - 1.0) <= DRY_PEAK_RTOL,
              f"dry run (a) {wire} {variant} rank {rank}: peak "
              f"{rec['peak_memory_bytes']} against the step's {peak}")
        emit({"phase": "dry_run", "part": "a", "wire": wire,
              "variant": variant, "rank": rank, "weiszfeld_iters": reads,
              "collectives_equal": same, "kinds": real["kinds"],
              "groups": real["groups"], "dry_peak_gb":
              rec["peak_memory_bytes"] / 1e9, "step_peak_gb": peak / 1e9,
              "peak_ratio": ratio, "trace_seconds": rec["trace_seconds"],
              "dot_flops": rec["flops_per_device"],
              "bytes_accessed": rec["bytes_per_device"], "card": smi})
    for name, ok in equal.items():
        check(ok, f"dry run (c): the {name} op differs from its direct "
                  "launch")
    emit({"phase": "dry_run", "part": "c", "op_equals_launch": equal,
          "op_against_launch": dispatch, "card": smi})
    emit({"phase": "dry_run", "seconds": time.perf_counter() - t0,
          "traces_s": traced_s, "peak_ratios": ratios,
          "worst_peak_rel": worst, "peak_rtol": DRY_PEAK_RTOL,
          "card": smi})


# -- phase 18: the pod sweep held to the card ----------------------------------

# (a): the five microcells at m = 4 (the cells' k) and d = 2**20, cut from
# minitron-4b's padded d of 5.10e9: the host-staged gathers move 16 MB in
# 46.6 ms (phase 12's transport)
SWEEP_MICRO_D = 1 << 20
SWEEP_MICRO_SEED = 29


def _sweep_cells():
    """The five microcells, wire cells first."""
    from repro_torch.sim import sweep
    return (sweep.WIRE_BASELINE_SCENARIO, sweep.WIRE_SIGN_SCENARIO,
            sweep.WIRE_INT8_SCENARIO, sweep.STALE_SHARDED_SCENARIO,
            sweep.STALE_GATHERED_SCENARIO)


def _sweep_jobs():
    """Phase 18's traces: (b)'s production microcells, then (a)'s five on
    each rank of (1, MESH_RANKS)."""
    cells = _sweep_cells()
    return ([("sweep", name) for name in cells]
            + [("micro", name, rank) for name in cells
               for rank in range(MESH_RANKS)])


def _sweep_job(job):
    """One trace of phase 18 in a worker (``_dry_job``): ("sweep", name)
    the cell's sweep entry at production size (``lower_any``: rank 0 of
    (16, 16)); ("micro", name, rank) the RooflineRecord of the cell on
    rank ``rank`` of (1, MESH_RANKS) at SWEEP_MICRO_D, as a dict."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sim import sweep
    ps = sweep.get_pod_scenario(job[1])
    if job[0] == "sweep":
        return sweep.lower_any(ps)
    return sweep.trace_microcell(
        ps, mesh=mesh_lib.make_mesh((1, MESH_RANKS), ("data", "model"),
                                    rank=job[2]),
        d_pad=SWEEP_MICRO_D).record.to_dict()


def _direct_gather_many(xs, axes, dim, *, mesh=None):
    """``meshctx.all_gather_many`` taken around the mesh: a direct
    ``dist.all_gather`` on the axes' group (the same bits, uncounted)."""
    import torch
    import torch.distributed as dist
    group, ranks = mesh.group(axes)
    out = []
    for x in xs:
        local = x.detach().cpu().contiguous()
        parts = [torch.empty_like(local) for _ in ranks]
        dist.all_gather(parts, local, group=group)
        out.append(torch.cat(parts, dim=dim).to(x.device))
    return out


def _sweep_rank(rank, world, device, job):
    """Phase 18 (a) on one rank of the card: each microcell of
    ``job["cells"]`` on this rank of the (1, world) mesh, its counts,
    round-kernel launches and sha256 of the aggregate (a cut aggregate
    gathered whole after the counts), then the planted fault: the
    baseline wire with its gather taken around the mesh."""
    import hashlib
    import torch
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import meshctx
    from repro_torch.sim import sweep
    dev = torch.device(device)
    line = mesh_lib.make_mesh((1, world), ("data", "model"))
    out = {}

    def run(name):
        ps = sweep.get_pod_scenario(name)
        with meshctx.set_mesh(line):
            torch.cuda.synchronize()
            line.reset_stats()
            rk.round_aggregate_kernel.launches = 0
            t0 = time.perf_counter()
            res = sweep.run_microcell(ps, line, SWEEP_MICRO_D,
                                      SWEEP_MICRO_SEED,
                                      rc=sweep.capped_rc(ps), device=dev)
            torch.cuda.synchronize()
            got = {"s": time.perf_counter() - t0,
                   "launches": rk.round_aggregate_kernel.launches,
                   "kinds": {k: dict(v)
                             for k, v in line.stats["kinds"].items()},
                   "groups": dict(line.stats["groups"])}
            agg = res["aggregate"]
            if ps.stale and ps.grad_mode == "sharded":
                agg = meshctx.all_gather_many([agg], "model", -1)[0]
        agg = agg.cpu()
        got.update(aggregate=agg, sha256=hashlib.sha256(
            agg.numpy().tobytes()).hexdigest())
        return got

    for name in job["cells"]:
        mark(f"sweep (a) {name}")
        out[name] = run(name)
        torch.cuda.empty_cache()
    mark("sweep (a) planted fault")
    real = meshctx.all_gather_many
    meshctx.all_gather_many = _direct_gather_many
    try:
        out["fault"] = run(job["cells"][0])
    finally:
        meshctx.all_gather_many = real
    return out


def sweep_path(dev, smi, started):
    """Phase 18 (a generator, as phase 12's), on the 4 rank processes of
    the card, and on the host.
    (a) The pod sweep's five microcells (sim/sweep.py: the report wire,
    none / sign / int8, and the staleness merge, sharded / gathered) for
    real on the (1, 4) mesh at m = 4 and d = SWEEP_MICRO_D, inputs from
    SWEEP_MICRO_SEED, the Weiszfeld stop at the cap: on every rank the
    collectives by kind (calls, result_bytes, wire_bytes) and the bytes
    received by group equal the dry run of the same rank's microcell on
    fake cuda tensors (traced in phase 17's pool); the aggregates' sha256
    equal across ranks; the aggregate equal to one process's unsharded
    run on the card (``torch.equal``; the sharded stale cell within RTOL
    / ATOL of max|y|, its blocked sums in rank order); one round-kernel
    launch a rank in each whole gmom consume (the none and int8 wires,
    the gathered stale cell), none in the others; the baseline wire with
    its gather taken around the mesh (a direct ``dist.all_gather``) must
    miss the dry run's counts.
    (b) The five at production size (minitron-4b, (16, 16), rank 0)
    traced in the pool on fake cuda tensors: ``compare_payloads`` against
    the port's record (src/repro_torch/sim/pod_sweeps.json) restricted to
    them, and ``compression_wire_problems``, report no problem.
    -> the ranks' round-kernel launches."""
    import torch
    from repro_torch.sim import sweep
    t0 = time.perf_counter()
    cells = _sweep_cells()
    one = {}
    for name in cells:
        ps = sweep.get_pod_scenario(name)
        out = sweep.run_microcell(ps, None, SWEEP_MICRO_D, SWEEP_MICRO_SEED,
                                  rc=sweep.capped_rc(ps), device=dev)
        one[name] = out["aggregate"].cpu()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    per_rank, ranks_s, t0 = yield from _mesh_ranks_of(
        "_sweep_rank", ({"cells": cells},), t0)
    _, _, futures = started
    launches = 0
    whole_gmom = (sweep.WIRE_BASELINE_SCENARIO, sweep.WIRE_INT8_SCENARIO,
                  sweep.STALE_GATHERED_SCENARIO)
    for name in cells:
        ps = sweep.get_pod_scenario(name)
        res = [pr[name] for pr in per_rank]
        dry = [futures[("micro", name, r)].result()
               for r in range(MESH_RANKS)]
        counts_ok = [x["kinds"] == d["collective_breakdown"]
                     and x["groups"] == {g: v["wire_bytes"] for g, v in
                                         d["collective_groups"].items()}
                     for x, d in zip(res, dry)]
        same = len({x["sha256"] for x in res}) == 1
        if ps.stale and ps.grad_mode == "sharded":
            err, equal, scale = compare(res[0]["aggregate"], one[name])
        else:
            equal = bool(torch.equal(res[0]["aggregate"], one[name]))
            err = float((res[0]["aggregate"] - one[name]).abs().max())
            scale = float(one[name].abs().max())
        want = 1 if name in whole_gmom else 0
        n_launch = [x["launches"] for x in res]
        launches += sum(n_launch)
        ok = (all(counts_ok) and same and equal
              and all(n == want for n in n_launch))
        check(ok, f"sweep (a) {name}: counts {counts_ok}, ranks agree "
                  f"{same}, vs one process {err} (max|y| {scale}), "
                  f"launches {n_launch} (want {want} a rank)")
        emit({"phase": "sweep", "part": "a", "scenario": name,
              "mesh": {"data": 1, "model": MESH_RANKS},
              "m": ps.num_groups, "d": SWEEP_MICRO_D,
              "reduced": ["d cut from minitron-4b's padded 5.10e9 to "
                          f"{SWEEP_MICRO_D} (host-staged gathers)"],
              "ok": ok, "counts_equal_dry_by_rank": counts_ok,
              "kinds": res[0]["kinds"], "groups": res[0]["groups"],
              "ranks_agree": same, "equal_one_process": equal,
              "max_abs_err": err, "max_abs_y": scale,
              "launches_by_rank": n_launch,
              "s_by_rank": [x["s"] for x in res],
              "dry_trace_s_by_rank": [d["trace_seconds"] for d in dry],
              "card": smi})
    fault = [pr["fault"] for pr in per_rank]
    base = [futures[("micro", cells[0], r)].result()
            for r in range(MESH_RANKS)]
    caught = all(x["kinds"] != d["collective_breakdown"]
                 for x, d in zip(fault, base))
    fault_same = all(torch.equal(x["aggregate"], one[cells[0]])
                     for x in fault)
    check(caught and fault_same,
          f"sweep (a) planted fault: the counts miss the direct gather "
          f"{caught}, the same bits {fault_same}")
    emit({"phase": "sweep", "part": "a", "fault": "direct_gather",
          "caught": caught, "aggregate_equal": fault_same,
          "kinds_by_rank": [x["kinds"] for x in fault], "card": smi})
    # (b) production size against the port's record
    fresh = {"scenarios": {name: futures[("sweep", name)].result()
                           for name in cells}}
    record = sweep.load_record()
    record["scenarios"] = {n: e for n, e in record["scenarios"].items()
                           if n in fresh["scenarios"]}
    problems, notes = sweep.compare_payloads(record, fresh)
    problems += sweep.compression_wire_problems(fresh["scenarios"])
    check(not problems, f"sweep (b): {problems}")
    base_b = fresh["scenarios"][sweep.WIRE_BASELINE_SCENARIO][
        "collective_bytes_per_device"]
    emit({"phase": "sweep", "part": "b", "ok": not problems,
          "problems": problems, "notes": notes,
          "wire_reduction": {
              codec: base_b / fresh["scenarios"][n][
                  "collective_bytes_per_device"]
              for codec, n in (("sign", sweep.WIRE_SIGN_SCENARIO),
                               ("int8", sweep.WIRE_INT8_SCENARIO))},
          "entries": fresh["scenarios"],
          "peak_over_record": {
              n: e["peak_memory_bytes"]
              / record["scenarios"][n]["peak_memory_bytes"]
              for n, e in fresh["scenarios"].items()},
          "trace_s": {n: e["trace_seconds"]
                      for n, e in fresh["scenarios"].items()},
          "card": smi})
    emit({"phase": "sweep", "seconds": time.perf_counter() - t0,
          "references_s": ref_s, "ranks_s": ranks_s, "card": smi})
    return launches


def cfg_param_leaves(cfg) -> int:
    """The number of parameters in ``cfg``'s leaves (the round's d)."""
    import math
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch import sharding
    return sum(math.prod(x.shape) for x in tree_leaves(
        sharding.param_shapes(cfg), is_leaf=lambda x: hasattr(x, "shape")))


def main() -> int:
    t_start = time.perf_counter()
    os.environ["CHIP_SMOKE_T0"] = repr(time.time())
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch import _device
    # phase 8's (8, P) and (k, P) f32 blocks, after every earlier phase
    _device.expandable_segments()
    from repro_torch.core.grouping import assignment_matrix, make_grouping
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.geomed import geomed
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.core.train_state import advance
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario, golden_scenarios

    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")

    # -- 0 device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    hbm, flops = peaks(name)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "peak_hbm_bytes_per_s": hbm, "peak_f32_flops": flops})

    # -- 1 build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = _build.build_all([rk.SOURCE, rk.LINREG_SOURCE,
                                  geomed.SOURCE, flash.SOURCE])
    rk._library()
    rk._linreg_library()
    geomed._library()
    flash._library()
    ptxas = {os.path.relpath(path, HERE): ptxas_summary(
        _build.BUILD_LOGS.get(str(path), "")) for path in lib_paths}
    tc_spills = spills(ptxas[os.path.relpath(lib_paths[-1], HERE)], "wgmma")
    gmom_spills = {fn: sp for path in lib_paths[:3]
                   for fn, sp in spills(
                       ptxas[os.path.relpath(path, HERE)]).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, "tensor_core_attention_spills": {
              fn: list(sp) if sp else None for fn, sp in tc_spills.items()},
          "gmom_spills": {fn: list(sp) if sp else None
                          for fn, sp in gmom_spills.items()}})
    # the tensor-core attention kernels (one per padded width) keep their
    # accumulators in registers: no spill anywhere in them
    check(len(tc_spills) == 3 and all(sp == (0, 0)
                                      for sp in tc_spills.values()),
          f"tensor-core attention kernels spill: {tc_spills}")
    # nor does any kernel of the GMoM libraries (the round kernel at every
    # k up to 64 is one instance per library; sqdist one per load width)
    check(set(GMOM_INSTANCES) <= set(gmom_spills)
          and all(sp == (0, 0) for sp in gmom_spills.values()),
          f"GMoM kernels spill or are missing: {gmom_spills}")

    gen = torch.Generator(device=dev)

    def stacked(m, d, seed):
        gen.manual_seed(seed)
        return torch.randn((m, d), generator=gen, device=dev) + 1.0

    # -- 2 parity ---------------------------------------------------------
    parity = {}
    for m, k, d in SHAPES:
        g = stacked(m, d, seed=m * 7 + k)
        cases = [("contiguous", 3.0)]
        if (m, k, d) == MAIN_SHAPE:
            cases = [(s, t) for s in ("contiguous", "strided", "seeded")
                     for t in (None, 1.0, 3.0)]
        worst = 0.0
        for scheme, trim in cases:
            grouping = make_grouping(m, k, scheme=scheme)
            for label, kw in MODES:
                kw = dict(kw, trim_multiplier=trim)
                cap, tol = kw.get("max_iters", 64), kw.get("tol", 1e-8)
                y1, it1 = rk.round_aggregate_kernel(g, grouping, **kw)
                y2, it2 = rk.round_aggregate_kernel(g, grouping, **kw)
                yp, itp = rk.round_aggregate_ref(g, grouping, **kw)
                torch.cuda.synchronize()
                err, ok, scale = compare(y1, yp)
                bitwise = bool(torch.equal(y1, y2)) and int(it1) == int(it2)
                # the kernel stops on its own test, replayed from its
                # iterates; and both versions stop on it (an exact float32
                # fixed point may come an iteration or a few apart, the
                # sums run in other orders), or both run to the cap; exact
                # counts where neither can stop early
                stop_ok = stops_on_its_test(
                    lambda i: rk.round_aggregate_kernel(
                        g, grouping, **dict(kw, max_iters=i))[0],
                    int(it1), cap, tol)
                iters_ok = stop_ok and (
                    int(it1) == int(itp) if label == "few"
                    else (int(it1) < cap) == (int(itp) < cap))
                worst = max(worst, err)
                tag = f"{(m, k, d)} {scheme} trim={trim} {label}"
                check(ok, f"parity {tag}: max_abs_err {err} (max|y| {scale})")
                check(bitwise, f"determinism {tag}")
                check(iters_ok, f"iterations {tag}: kernel {int(it1)} "
                                f"plain {int(itp)} (cap {cap})")
                emit({"phase": "parity", "shape": [m, k, d],
                      "scheme": scheme, "trim": trim, "mode": label,
                      "max_abs_err": err, "max_abs_y": scale, "ok": ok,
                      "bitwise_repeat": bitwise, "iters_kernel": int(it1),
                      "iters_plain": int(itp), "stop_ok": stop_ok,
                      "iters_ok": iters_ok})
        parity[(m, k, d)] = worst
        del g
        torch.cuda.empty_cache()
    linreg_err = linreg_parity(dev)
    geomed_err = geomed_parity(dev)
    attn_err = attention_parity(dev)

    # -- 3 goldens on the card --------------------------------------------
    rk.round_aggregate_kernel.launches = 0
    res = goldens.check_all(round_backend="auto", device=dev)
    launches = rk.round_aggregate_kernel.launches
    # every gmom round of the goldens (the stale one's included) is one
    # launch of the round kernel
    want_launches = sum(sc.rounds for sc in golden_scenarios()
                        if sc.aggregator == "gmom")
    resume = goldens.check_resume_replay(device=dev)
    bit_exact = {n: goldens.check_resume_bit_exact(n, device=dev)
                 for n in goldens.BIT_EXACT_RESUME_SCENARIOS}
    for gname, bad in res.items():
        check(not bad, f"golden {gname}: {bad[:3]}")
    check(len(res) == 11, f"{len(res)} goldens, want 11")
    check(not resume, f"resume replay: {resume[:3]}")
    for gname, bad in bit_exact.items():
        check(not bad, f"bit-exact resume {gname}: {bad[:3]}")
    check(launches == want_launches,
          f"goldens: {launches} round-kernel launches, want {want_launches}")
    emit({"phase": "goldens", "matched": sum(not v for v in res.values()),
          "of": len(res), "resume_replay_ok": not resume,
          "bit_exact_resume_ok": {n: not v for n, v in bit_exact.items()},
          "kernel_launches": launches,
          "mismatches": {k: v[:3] for k, v in res.items() if v}})

    # -- 4 full width: the port's main path -------------------------------
    main_launches = 0
    for cname, cfg in FULL_WIDTH.items():
        sc = Scenario(name=f"linreg-{cname}/gmom/sign_flip/rotating", **cfg)
        traces, ms_round, host_round = {}, {}, {}
        for backend in ("auto", "reference", "fused_interpret"):
            run, state, batches, rc, _ = engine._build_run(
                sc, round_backend=backend, device=dev)
            torch.cuda.synchronize()
            if backend == "auto":
                rk.round_aggregate_kernel.launches = 0
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            state, _ = advance(run, state, batches, num_rounds=sc.rounds)
            end.record()
            torch.cuda.synchronize()
            host_round[backend] = ((time.perf_counter() - t0) * 1e3
                                   / sc.rounds)
            if backend == "auto":
                n_launch = rk.round_aggregate_kernel.launches
            ms_round[backend] = start.elapsed_time(end) / sc.rounds
            traces[backend] = engine._trace(sc, rc, sc.rounds, state.history)
            del run, state, batches
            torch.cuda.empty_cache()
        main_launches += n_launch
        kern = traces["auto"]
        vs_ref = goldens.compare_traces(kern, traces["reference"])
        vs_plain = goldens.compare_traces(kern, traces["fused_interpret"])
        below = kern["final_est_error"] < sc.paper_floor
        check(not vs_ref, f"{cname}: kernel vs reference {vs_ref[:3]}")
        check(not vs_plain, f"{cname}: kernel vs plain {vs_plain[:3]}")
        check(below, f"{cname}: final est_error {kern['final_est_error']} "
                     f">= paper_floor {sc.paper_floor}")
        check(n_launch == sc.rounds,
              f"{cname}: {n_launch} kernel launches for {sc.rounds} rounds")
        emit({"phase": "full_width", "config": cname, "dim": sc.dim,
              "total_samples": sc.total_samples,
              "num_workers": sc.num_workers,
              "num_byzantine": sc.num_byzantine,
              "num_batches": sc.num_batches, "rounds": sc.rounds,
              "final_est_error": kern["final_est_error"],
              "paper_floor": sc.paper_floor, "kernel_launches": n_launch,
              "kernel_vs_reference_ok": not vs_ref,
              "kernel_vs_plain_ok": not vs_plain,
              "ms_per_round": ms_round, "host_ms_per_round": host_round})
    main_launches += wire_and_stale_paths(dev)
    linreg_launches, linreg_routes = linreg_path(dev)
    geomed_launches = geomed_path(dev)
    attn_routes = serve_path(dev)

    # -- 5 timings --------------------------------------------------------
    counts = device_kernel_counts(dev)
    timing = {}
    for m, k, d in SHAPES:
        g = stacked(m, d, seed=m * 7 + k)
        grouping = make_grouping(m, k)
        s = torch.as_tensor(assignment_matrix(grouping), device=dev)
        bsz = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                           device=dev).reshape(k, 1)
        _, it = rk.round_aggregate_kernel(g, grouping)
        iters = int(it)
        n_dev, dev_ms, names = counts.get(("round", (m, k, d)),
                                          (None, None, None))
        check(n_dev == 1, f"round kernel {(m, k, d)}: {n_dev} device "
                          f"kernels per call {names}")
        kernel_ms = timed(lambda: rk.round_aggregate_kernel(g, grouping))
        wrapper_ms = host_ms(lambda: rk.round_aggregate_kernel(g, grouping))
        plain_ms = timed(lambda: rk.round_aggregate_ref(g, grouping))
        library_ms = timed(lambda: torch.matmul(s, g) / bsz)
        io_bytes = 4 * (m * d + d)
        z_bytes = 4 * (m * d + (iters + 1) * k * d + d)
        ops = m * d + (iters + 1) * 6 * k * d
        bound_ms = max(io_bytes / hbm, ops / flops) * 1e3
        bound_by = "bytes" if io_bytes / hbm >= ops / flops else "operations"
        timing[(m, k, d)] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
        emit({"phase": "timing", "shape": [m, k, d], "iters": iters,
              "device_kernels_per_call": n_dev, "device_kernel_names": names,
              "device_ms": dev_ms, "wrapper_host_ms": wrapper_ms,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms_means_only": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "bound_with_z_traffic_ms": z_bytes / hbm * 1e3,
              "card": smi})
        del g
        torch.cuda.empty_cache()
    timing.update(new_kernel_timings(dev, hbm, flops, smi, counts))
    timing.update(attention_timings(dev, hbm, smi))

    # -- 6 sharded: shard-local aggregation --------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst = sharded_virtual(dev)
    sharded_model_axis(dev, smi)
    main_launches += sharded_data_axis(dev, smi)
    emit({"phase": "sharded", "seconds": time.perf_counter() - t0,
          "worst_err_over_max_abs_y": worst, "card": smi})

    # -- 8 train: Byzantine-robust LM training ------------------------------
    train_launches, train_timing = train_path(dev, hbm, flops, smi)
    main_launches += train_launches

    # -- 9 moe: the MoE family ----------------------------------------------
    moe_launches, moe_routes, moe_timing = moe_path(dev, hbm, flops, smi)
    main_launches += moe_launches

    # -- 10 recurrent: RWKV6 and Zamba2 --------------------------------------
    rec_launches, rec_routes, rec_timing = recurrent_path(dev, hbm, flops,
                                                          smi)
    main_launches += rec_launches

    # -- 11 audio and VLM: SeamlessM4T and InternVL2 --------------------------
    av_launches, av_routes, av_timing = audio_vlm_path(dev, hbm, flops, smi)
    main_launches += av_launches

    # -- 12-16 the model mesh on rank processes of the card, one start:
    # 12 the regions and prefills, 13 the group step, 14 the hybrid, audio
    # and vlm families, 15 decode and the short prefill, 16 the int8 wire
    # on the mesh step and one request served on (2, 2)
    torch.cuda.empty_cache()
    # 18 (a) the pod sweep's microcells on the same rank processes
    dry = dry_run_start()
    ((mesh_routes, sp_row), (mt_launches, mt_row),
     (fam_routes, fam_launches, fam_rows), dec_routes,
     (whole_launches, whole_routes), sweep_launches) = mesh_phases(
        dev, hbm, smi, dry)
    main_launches += mt_launches + fam_launches + whole_launches
    main_launches += sweep_launches

    # -- 17 the pod dry run held to the card (on the host) ------------------
    torch.cuda.empty_cache()
    dry_run_path(dev, smi, dry)

    # -- 7 the kernel line --------------------------------------------------
    csrc = "src/repro_torch/kernels/"
    rows = (("round_aggregate", "geomed/csrc/round_aggregate.cu",
             "src/repro/kernels/geomed/round.py:268", main_launches,
             parity[MAIN_SHAPE], timing[MAIN_SHAPE], MAIN_SHAPE),
            ("linreg_round", "geomed/csrc/linreg_round.cu",
             "src/repro/kernels/geomed/round.py:428", linreg_launches,
             linreg_err[LINREG_MAIN],
             timing[("linreg_round", LINREG_MAIN)], LINREG_MAIN),
            ("sqdist", "geomed/csrc/geomed.cu",
             "src/repro/kernels/geomed/geomed.py:75",
             geomed_launches["sqdist"], geomed_err[("sqdist", GEOMED_MAIN)],
             timing[("sqdist", GEOMED_MAIN)], GEOMED_MAIN),
            ("reweight", "geomed/csrc/geomed.cu",
             "src/repro/kernels/geomed/geomed.py:96",
             geomed_launches["reweight"],
             geomed_err[("reweight", GEOMED_MAIN)],
             timing[("reweight", GEOMED_MAIN)], GEOMED_MAIN),
            ("weiszfeld_regs", "geomed/csrc/geomed.cu",
             "src/repro/kernels/geomed/ops.py:25",
             geomed_launches["weiszfeld_regs"],
             geomed_err[("weiszfeld_loop", GEOMED_MAIN)],
             timing[("weiszfeld_loop", GEOMED_MAIN)], GEOMED_MAIN),
            ("weiszfeld_tiles", "geomed/csrc/geomed.cu",
             "src/repro/kernels/geomed/ops.py:25",
             geomed_launches["weiszfeld_tiles"],
             geomed_err[("weiszfeld_loop", GEOMED_TILES)],
             timing[("weiszfeld_loop", GEOMED_TILES)], GEOMED_TILES),
            ("flash_attention", "attention/csrc/flash_attention_tc.cuh",
             "src/repro/kernels/attention/flash.py:124",
             sum(r["bfloat16"]["tensor_core"] for r in (
                 attn_routes, moe_routes, rec_routes, av_routes,
                 mesh_routes, fam_routes, dec_routes, whole_routes)),
             attn_err[(ATTN_MAIN, "bfloat16")], timing[ATTN_MAIN],
             ATTN_MAIN))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    line = [{
        "name": kname, "route": "cuda", "source": csrc + source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": list(shape)}
        for kname, source, replaces, launches, err, t, shape in rows]
    # sqdist's and reweight's launches are the step route's at GEOMED_STEP
    # (the only route that launches them); their error and times are at
    # GEOMED_MAIN
    for row in line[2:4]:
        row["launches_shape"] = list(GEOMED_STEP)
    # the round kernel at the train paths' (8, 8, P): H2O's, phase 8,
    # Granite's, phase 9, Zamba2's, phase 10, and SeamlessM4T's, phase 11
    for key, t in (("train_shape", train_timing),
                   ("granite_train_shape", moe_timing),
                   ("zamba2_train_shape", rec_timing),
                   ("seamless_train_shape", av_timing)):
        line[0][key] = {"shape": list(t["shape"]), **{k: t[k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "iters", "iters_plain")}}
    # and phase 13's gathered mesh steps: one launch a rank at (k, k, P)
    # (phase 14's reduced gathered steps are counted in its launches)
    line[0]["mesh_train_shape"] = mt_row
    # the linreg round's row is its one-pass route at LINREG_MAIN
    line[1].update(kernel_route="one_pass", launches_by_route=linreg_routes)
    # flash attention's row is its tensor-core route at ATTN_MAIN (bf16);
    # the f32 prefills' launches went to the CUDA-core route; its launches
    # are H2O's prefills (phase 4b), Granite's (phase 9), Zamba2's (phase
    # 10), SeamlessM4T's and InternVL2's (phase 11), and the mesh
    # prefills' of phases 12 and 14, each rank's measured; the other
    # models' prefill shapes are timed beside ATTN_MAIN, and the mesh
    # families' offset shapes (phase 14 (a)) as family_sp_shapes
    line[-1].update(kernel_route="tensor_core", sp_offset_shape=sp_row,
                    family_sp_shapes=fam_rows, launches_by_route={
        route: sum(r[dname][route] for r in (attn_routes, moe_routes,
                                             rec_routes, av_routes,
                                             mesh_routes, fam_routes,
                                             dec_routes, whole_routes))
        for dname, route in (("bfloat16", "tensor_core"),
                             ("float32", "cuda_core"))}, **{
        key: {"shape": list(case), **{
            k: timing[case][k] for k in (
                "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")},
            "max_abs_err": attn_err[(case, "bfloat16")]}
        for key, case in (("granite_shape", ATTN_GRANITE),
                          ("zamba2_shape", ATTN_ZAMBA),
                          ("audio_enc_shape", ATTN_AUDIO_ENC),
                          ("audio_cross_shape", ATTN_AUDIO_CROSS),
                          ("vlm_shape", ATTN_VLM))})
    emit({"kernels": line})

    if FAILURES:
        for f in FAILURES:
            print("FAIL:", f, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
