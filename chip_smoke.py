#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, replays the golden
traces through the round kernel, drives the paper's Algorithm 2 at full
width through the port's engine and through the full linreg round kernel,
runs the Weiszfeld loop over the step kernels at full width, and times
every kernel.  Every phase prints JSON lines; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every check
passed.  Exits non-zero without it on any failure, when CUDA is
unavailable, or when the ``src/repro_torch`` package is missing.

Phases:
  0 device       nvidia-smi name and power limit, torch and CUDA versions
  1 build        nvcc build of every kernel source, one process each, all
                 at once (seconds, ptxas summary per library)
  2 parity       every kernel vs its plain version (round kernel and
                 linreg round in each of MODES), rtol 1e-4 / atol 1e-5
                 against max|y|; two kernel runs must be bitwise equal
  3 goldens      the nine float goldens and the interrupted-resume replay
                 on the card with round_backend="auto" (gmom -> kernel)
  4 full width   the paper config (d=100) and a wide one (d=8192):
                 gmom under sign_flip/rotating through the engine (kernel
                 path vs plain paths, one round-kernel launch per round);
                 failure-free rounds theta <- theta - eta linreg_round(X,
                 y, theta) held against the engine's failure-free run
                 (one linreg launch per round); both below paper_floor.
                 The Weiszfeld loop over sqdist/reweight at (k, d) = (11,
                 8192) and (11, 25 557 032) against core.geometric_median
  5 timings      kernel, plain and library times (medians of 20 after
                 warm-up), iterations, launches per call, bounds
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
# the uneven k=11; the wide main-path width (X is 1.64 GB)
LINREG_SHAPES = [(12, 16, 300, 6), (20, 16, 400, 10), (50, 1000, 100, 10),
                 (50, 1000, 100, 11), (50, 1000, 8192, 11)]
LINREG_MAIN = (50, 1000, 8192, 11)
# (k, d) of the Weiszfeld-step kernels: the grid of tests/test_kernels.py,
# the wide width, and ResNet-50's parameter count (Z is 1.12 GB)
GEOMED_SHAPES = [(2, 64), (8, 1000), (16, 4096), (64, 512), (5, 777),
                 (32, 2048), (11, 8192), (11, 25_557_032)]
GEOMED_PATH = [(11, 8192), (11, 25_557_032)]
GEOMED_MAIN = (11, 25_557_032)
# (HBM bytes/s, float32 non-tensor-core FLOP/s) by part, NVIDIA data sheets
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "SXM": (3.35e12, 67e12)}

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


def ptxas_summary(log: str) -> dict:
    """{kernel<KMAX>: "registers, spill bytes"} from ``nvcc -Xptxas -v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d([a-z]+(?:_[a-z]+)*"
                      r"_kernel)(?:ILi(\d+)E)?", line)
        if m:
            fn = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
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
    """The linreg kernel's device-side early exit, replayed from outside:
    it stops after the first iteration whose squared move is <= tol^2, or
    at the cap.  So the move of iteration ``iters - 1`` must be > tol^2,
    and, below the cap, the move of iteration ``iters`` <= tol^2.
    ``iterate(i)`` is the kernel's output at ``max_iters=i``, the loop's
    i-th iterate bit for bit.  Moves are summed in float64 and held to
    tol^2 within a relative 1e-4 (the kernel sums them in float32 in
    another order)."""
    if not 1 <= iters <= cap:
        return False
    tol2, seen = float(tol) ** 2, {}

    def move(i):
        for j in (i, i - 1):
            if j not in seen:
                seen[j] = iterate(j).double()
        return float(((seen[i] - seen[i - 1]) ** 2).sum())

    stopped = iters == cap or move(iters) <= tol2 * (1 + 1e-4)
    return stopped and (iters == 1 or move(iters - 1) > tol2 * (1 - 1e-4))


def linreg_parity(dev, shapes=LINREG_SHAPES, main_shape=LINREG_MAIN):
    """The linreg round kernel vs ``linreg_round_fused`` in every mode ->
    {shape: worst max_abs_err}."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.geomed import round as rk
    worst = {}
    for m, n, d, k in shapes:
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
                y1, it1 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
                y2, it2 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
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
                check(ok, f"parity {tag}: max_abs_err {err} "
                          f"(max|y| {scale})")
                check(bitwise, f"determinism {tag}")
                check(iters_ok, f"iterations {tag}: kernel {int(it1)} "
                                f"plain {int(itp)} (cap {cap})")
                emit({"phase": "parity_linreg", "shape": [m, n, d, k],
                      "scheme": scheme, "trim": trim, "mode": label,
                      "max_abs_err": err, "max_abs_y": scale, "ok": ok,
                      "bitwise_repeat": bitwise, "iters_kernel": int(it1),
                      "iters_plain": int(itp), "stop_ok": stop_ok,
                      "iters_ok": iters_ok})
        del x, t, theta
        torch.cuda.empty_cache()
    return worst


def geomed_parity(dev, shapes=GEOMED_SHAPES):
    """sqdist, reweight and the step vs their plain versions ->
    {(kernel, shape): max_abs_err}."""
    import torch
    from repro_torch.kernels.geomed import geomed, ref
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
            del a, b, want
        emit(line)
        del z, y, w
        torch.cuda.empty_cache()
    return errs


def linreg_path(dev, configs=None):
    """The slice's path at full width: failure-free Algorithm 2 through
    ``linreg_round_kernel`` (``engine.run_failure_free``), held against
    the engine's failure-free run (per-worker grads + the round kernel).
    -> linreg kernel launches."""
    import torch
    from repro_torch import random as prng
    from repro_torch.data import regression
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario
    total = 0
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

        rk.linreg_round_kernel.launches = 0
        kern, ms_kernel = drive(plain=False)
        n_launch = rk.linreg_round_kernel.launches
        plain, ms_plain = drive(plain=True)
        total += n_launch
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
        emit({"phase": "linreg_path", "config": cname, "dim": sc.dim,
              "total_samples": sc.total_samples,
              "num_workers": sc.num_workers,
              "num_batches": engine_trace["num_batches"],
              "rounds": sc.rounds,
              "final_est_error": kern["final_est_error"],
              "engine_final_est_error": engine_trace["final_est_error"],
              "paper_floor": sc.paper_floor, "kernel_launches": n_launch,
              "kernel_vs_engine_ok": not vs_engine,
              "kernel_vs_plain_ok": not vs_plain,
              "ms_per_round": {"linreg_round_kernel": ms_kernel,
                               "linreg_round_fused": ms_plain}})
        del ds
        torch.cuda.empty_cache()
    return total


def geomed_path(dev, shapes=GEOMED_PATH):
    """The Weiszfeld loop over the step kernels at full width, held
    against ``core.geometric_median``.  -> (sqdist, reweight) launches."""
    import torch
    from repro_torch.core.geometric_median import geometric_median
    from repro_torch.kernels.geomed import geomed, ops
    points = [geomed_inputs(k, d, 5 * k + d % 997, dev)[0]
              for k, d in shapes]
    geomed.sqdist.launches = geomed.reweight.launches = 0
    results = []
    for z in points:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        results.append(ops.geometric_median_kernel(z))
        torch.cuda.synchronize(dev)
        results[-1] = (results[-1], (time.perf_counter() - t0) * 1e3)
    launches = (geomed.sqdist.launches, geomed.reweight.launches)
    check(launches[0] > 0 and launches[0] == launches[1],
          f"geometric_median_kernel: sqdist/reweight launches {launches}")
    for (k, d), z, (y, ms) in zip(shapes, points, results):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y_core = geometric_median(z)
        torch.cuda.synchronize(dev)
        ms_core = (time.perf_counter() - t0) * 1e3
        err, ok, scale = compare(y, y_core)
        check(ok, f"geometric_median_kernel {(k, d)} vs core: max_abs_err "
                  f"{err} (max|y| {scale})")
        emit({"phase": "geomed_path", "shape": [k, d], "max_abs_err": err,
              "max_abs_y": scale, "ok": ok,
              "ms": {"geometric_median_kernel": ms,
                     "core.geometric_median": ms_core}})
    emit({"phase": "geomed_path", "sqdist_launches": launches[0],
          "reweight_launches": launches[1]})
    del points, results
    torch.cuda.empty_cache()
    return launches


def new_kernel_timings(dev, hbm, flops, smi):
    """Kernel, plain and library ms of the linreg round and the step
    kernels at their main shapes -> {name: timing dict}."""
    import torch
    from repro_torch.core.grouping import make_grouping
    from repro_torch.kernels.geomed import geomed, ref
    from repro_torch.kernels.geomed import round as rk
    out = {}
    for m, n, d, k in ((50, 1000, 100, 11), LINREG_MAIN):
        x, t, theta = linreg_inputs(m, n, d, 3, dev)
        grouping = make_grouping(m, k)
        th3 = theta.reshape(1, d, 1).expand(m, d, 1)
        _, it = rk.linreg_round_kernel(x, t, theta, grouping)
        iters = int(it)
        before = rk.linreg_round_kernel.launches
        rk.linreg_round_kernel(x, t, theta, grouping)
        per_call = rk.linreg_round_kernel.launches - before
        check(per_call == 1, f"linreg_round: {per_call} launches per call")
        kernel_ms = timed(lambda: rk.linreg_round_kernel(x, t, theta,
                                                         grouping))
        plain_ms = timed(lambda: rk.linreg_round_fused(x, t, theta,
                                                       grouping))
        library_ms = timed(lambda: torch.bmm(
            (torch.bmm(x, th3)[..., 0] - t)[:, None, :], x))
        # the function reads X, y and theta once and writes y; the
        # two-pass design reads X twice and writes and reads the gradient
        # partials P (n_split, m, d), reported beside the bound
        n_split = rk.linreg_split(m, n, d)
        nbytes = 4 * (m * n * d + m * n + 2 * d)
        two_pass_bytes = nbytes + 4 * (m * n * d + 2 * n_split * m * d)
        ops = 4 * m * n * d + m * d + (iters + 1) * 6 * k * d
        bound_ms, bound_by = bound(nbytes, ops, hbm, flops)
        out[("linreg_round", (m, n, d, k))] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "timing", "kernel": "linreg_round",
              "shape": [m, n, d, k], "iters": iters,
              "launches_per_call": per_call, "n_split": n_split,
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
    for name, kernel, plain, library, nbytes, ops, wrapper in cases:
        before = wrapper.launches
        kernel()
        per_call = wrapper.launches - before
        check(per_call == 1, f"{name}: {per_call} launches per call")
        kernel_ms, plain_ms = timed(kernel), timed(plain)
        library_ms = timed(library)
        bound_ms, bound_by = bound(nbytes, ops, hbm, flops)
        out[(name, (k, d))] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "timing", "kernel": name, "shape": [k, d],
              "launches_per_call": per_call, "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "card": smi})
    del z, y, w
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.grouping import assignment_matrix, make_grouping
    from repro_torch.kernels import _build
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
                                  geomed.SOURCE])
    rk._library()
    rk._linreg_library()
    geomed._library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {os.path.relpath(path, HERE): ptxas_summary(
              _build.BUILD_LOGS.get(str(path), "")) for path in lib_paths}})

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
                cap = kw.get("max_iters", 64)
                y1, it1 = rk.round_aggregate_kernel(g, grouping, **kw)
                y2, it2 = rk.round_aggregate_kernel(g, grouping, **kw)
                yp, itp = rk.round_aggregate_ref(g, grouping, **kw)
                torch.cuda.synchronize()
                err, ok, scale = compare(y1, yp)
                bitwise = bool(torch.equal(y1, y2)) and int(it1) == int(it2)
                # both stop on their own test (an exact float32 fixed point
                # may come an iteration or a few apart, the sums run in
                # other orders), or both run to the cap
                iters_ok = (int(it1) == int(itp) if label == "few"
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
                      "iters_plain": int(itp), "iters_ok": iters_ok})
        parity[(m, k, d)] = worst
        del g
        torch.cuda.empty_cache()
    linreg_err = linreg_parity(dev)
    geomed_err = geomed_parity(dev)

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
    linreg_launches = linreg_path(dev)
    sqdist_launches, reweight_launches = geomed_path(dev)

    # -- 5 timings --------------------------------------------------------
    timing = {}
    for m, k, d in SHAPES:
        g = stacked(m, d, seed=m * 7 + k)
        grouping = make_grouping(m, k)
        s = torch.as_tensor(assignment_matrix(grouping), device=dev)
        bsz = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                           device=dev).reshape(k, 1)
        _, it = rk.round_aggregate_kernel(g, grouping)
        iters = int(it)
        kernel_ms = timed(lambda: rk.round_aggregate_kernel(g, grouping))
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
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms_means_only": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by,
              "bound_with_z_traffic_ms": z_bytes / hbm * 1e3,
              "card": smi})
        del g
        torch.cuda.empty_cache()
    timing.update(new_kernel_timings(dev, hbm, flops, smi))

    # -- 6 the kernel line --------------------------------------------------
    csrc = "src/repro_torch/kernels/geomed/csrc/"
    rows = (("round_aggregate", "round_aggregate.cu",
             "src/repro/kernels/geomed/round.py:268", main_launches,
             parity[MAIN_SHAPE], timing[MAIN_SHAPE], MAIN_SHAPE),
            ("linreg_round", "linreg_round.cu",
             "src/repro/kernels/geomed/round.py:428", linreg_launches,
             linreg_err[LINREG_MAIN],
             timing[("linreg_round", LINREG_MAIN)], LINREG_MAIN),
            ("sqdist", "geomed.cu", "src/repro/kernels/geomed/geomed.py:75",
             sqdist_launches, geomed_err[("sqdist", GEOMED_MAIN)],
             timing[("sqdist", GEOMED_MAIN)], GEOMED_MAIN),
            ("reweight", "geomed.cu",
             "src/repro/kernels/geomed/geomed.py:96", reweight_launches,
             geomed_err[("reweight", GEOMED_MAIN)],
             timing[("reweight", GEOMED_MAIN)], GEOMED_MAIN))
    print(smi, flush=True)
    emit({"kernels": [{
        "name": kname, "route": "cuda", "source": csrc + source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": list(shape)}
        for kname, source, replaces, launches, err, t, shape in rows]})

    if FAILURES:
        for f in FAILURES:
            print("FAIL:", f, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
