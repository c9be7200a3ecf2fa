#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, replays the golden
traces through the round kernel, drives the paper's Algorithm 2 at full
width through the port's engine and through the full linreg round kernel,
runs the Weiszfeld loop over the step kernels at full width, serves
H2O-Danube3-4B at full width through the flash-attention kernel, and
times every kernel.  Every phase prints JSON lines; the last line is
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
  3 goldens      the nine float goldens and the interrupted-resume replay
                 on the card with round_backend="auto" (gmom -> kernel)
  4 full width   the paper config (d=100) and a wide one (d=8192):
                 gmom under sign_flip/rotating through the engine (kernel
                 path vs plain paths, one round-kernel launch per round);
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
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

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
# the window; Minitron-4B's (24/8 of 128, causal)
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
             (1, 4097, 4097, 32, 8, 120, True, 4096),
             (1, 8192, 8192, 32, 8, 120, True, 4096),
             (1, 8192, 8192, 24, 8, 128, True, None)]
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
# at 8192, and one H2O call at prefill_32k's sequence length
ATTN_MAIN = (1, 8192, 8192, 32, 8, 120, True, 4096)
ATTN_TIMED = [ATTN_MAIN, (1, 8192, 8192, 24, 8, 128, True, None),
              (1, 32768, 32768, 32, 8, 120, True, 4096)]
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
# configs/linreg_paper.py (d=100, N=50 000, m=50, q=4) with k=10, and the
# same data size at d=8192 with the paper's uneven k=11 (X is 1.64 GB).
FULL_WIDTH = {
    "paper": dict(dim=100, total_samples=50_000, num_workers=50,
                  num_byzantine=4, num_batches=10, rounds=60),
    "wide": dict(dim=8192, total_samples=50_000, num_workers=50,
                 num_byzantine=4, num_batches=11, rounds=30),
}

FAILURES: list[str] = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def timed(fn):
    """Median ms of REPEATS calls after 3 warm-up calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPEATS):
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


def live_pairs(Tq, Tk, causal, window):
    """(q, k) pairs that the masks leave live, with default positions."""
    total = 0
    for q in range(Tq):
        hi = min(q, Tk - 1) if causal else Tk - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


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


def _prefill_ms(step, params, batch, dev):
    import torch
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    h = step(params, batch)
    torch.cuda.synchronize(dev)
    return h, (time.perf_counter() - t0) * 1e3


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


def cuda_core_call(q, k, v, causal, window):
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
        int(window or 0), hd ** -0.5, flash.ROUTES["cuda_core"],
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
        pairs = live_pairs(Tq, Tk, causal, window)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.grouping import assignment_matrix, make_grouping
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.geomed import geomed
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.core.train_state import advance
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario

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
    resume = goldens.check_resume_replay(device=dev)
    for gname, bad in res.items():
        check(not bad, f"golden {gname}: {bad[:3]}")
    check(not resume, f"resume replay: {resume[:3]}")
    check(launches > 0, "goldens did not go through the kernel")
    emit({"phase": "goldens", "matched": sum(not v for v in res.values()),
          "of": len(res), "resume_replay_ok": not resume,
          "kernel_launches": launches,
          "mismatches": {k: v[:3] for k, v in res.items() if v}})

    # -- 4 full width: the port's main path -------------------------------
    main_launches = 0
    for cname, cfg in FULL_WIDTH.items():
        sc = Scenario(name=f"linreg-{cname}/gmom/sign_flip/rotating", **cfg)
        traces, ms_round = {}, {}
        for backend in ("auto", "reference", "fused_interpret"):
            run, state, batches, rc, _ = engine._build_run(
                sc, round_backend=backend, device=dev)
            torch.cuda.synchronize()
            if backend == "auto":
                rk.round_aggregate_kernel.launches = 0
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            state, _ = advance(run, state, batches, num_rounds=sc.rounds)
            end.record()
            torch.cuda.synchronize()
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
              "ms_per_round": ms_round})
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

    # -- 6 the kernel line --------------------------------------------------
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
             attn_routes["bfloat16"]["tensor_core"],
             attn_err[(ATTN_MAIN, "bfloat16")], timing[ATTN_MAIN],
             ATTN_MAIN))
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
    # the linreg round's row is its one-pass route at LINREG_MAIN
    line[1].update(kernel_route="one_pass", launches_by_route=linreg_routes)
    # flash attention's row is its tensor-core route at ATTN_MAIN (bf16);
    # the f32 prefill's launches went to the CUDA-core route
    line[-1].update(kernel_route="tensor_core", launches_by_route={
        "tensor_core": attn_routes["bfloat16"]["tensor_core"],
        "cuda_core": attn_routes["float32"]["cuda_core"]})
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
