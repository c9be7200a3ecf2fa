#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, replays the golden traces
through it, drives the paper's Algorithm 2 at full width through the
port's engine, and times the kernel.  Every phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}`` and is printed only
when every check passed.  Exits non-zero without it on any failure, when
CUDA is unavailable, or when the ``src/repro_torch`` package is missing.

Phases:
  0 device       nvidia-smi name and power limit, torch and CUDA versions
  1 build        nvcc build of the round kernel (seconds, ptxas summary)
  2 parity       kernel vs plain version (see MODES), rtol 1e-4 /
                 atol 1e-5 against max|y|; two kernel runs must be bitwise
                 equal
  3 goldens      the nine float goldens and the interrupted-resume replay
                 on the card with round_backend="auto" (gmom -> kernel)
  4 full width   the paper config (d=100) and a wide one (d=8192), gmom
                 under sign_flip/rotating: kernel path vs plain paths,
                 final est_error < paper_floor, one launch per round
  5 timings      per phase-2 shape: kernel, plain and library times
                 (medians of 20 after warm-up), iterations, bounds
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.grouping import assignment_matrix, make_grouping
    from repro_torch.kernels import _build
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
    lib_path = _build.build(rk.SOURCE)
    rk._library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, HERE),
          "ptxas": ptxas_summary(_build.BUILD_LOGS.get(str(lib_path), ""))})

    gen = torch.Generator(device=dev)

    def stacked(m, d, seed):
        gen.manual_seed(seed)
        return torch.randn((m, d), generator=gen, device=dev) + 1.0

    def compare(y, y_ref):
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        return err, err <= ATOL + RTOL * scale, scale

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

    # -- 5 timings --------------------------------------------------------
    def timed(fn):
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

    # -- 6 the kernel line --------------------------------------------------
    t = timing[MAIN_SHAPE]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "round_aggregate", "route": "cuda",
        "source": "src/repro_torch/kernels/geomed/csrc/round_aggregate.cu",
        "replaces": "src/repro/kernels/geomed/round.py:268",
        "launches": main_launches, "max_abs_err": parity[MAIN_SHAPE],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": list(MAIN_SHAPE),
        "parity_ok": not any(f.startswith("parity") for f in FAILURES)}]})

    if FAILURES:
        for f in FAILURES:
            print("FAIL:", f, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
