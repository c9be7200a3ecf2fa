#!/usr/bin/env python3
"""Where a main-path round's time goes on the card.

    python3 chip_profile.py

For each full-width config of ``chip_smoke.py`` (gmom under
sign_flip/rotating through the port's engine, round_backend="auto"):

* a stage breakdown of single rounds — the round key, per-worker
  gradients, the attack schedule (mask draw + attack), the aggregation
  (the CUDA round kernel), the SGD update and its application — each
  stage closed by a synchronise and timed on the host clock (medians over
  ``ROUNDS`` rounds);
* a ``torch.profiler`` trace of ``ROUNDS`` rounds run as the engine runs
  them: device busy time, idle share, device kernels per round, and the
  device time of the round kernel's five CUDA kernels;
* a ``torch.profiler`` trace of ``ROUNDS`` failure-free rounds through
  ``linreg_round_kernel`` (theta <- theta - eta aggregate): the same
  shares, and the device time of each of its CUDA kernels by name.

Prints two JSON lines per config.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

ROUNDS = 10
ROUND_KERNELS = ("means_kernel", "trim_kernel", "init_kernel",
                 "step_head_kernel", "step_kernel")
LINREG_KERNELS = ("residual_kernel", "grad_kernel") + ROUND_KERNELS


def device_events(prof):
    """(name, device ms) of every CUDA event in a profile."""
    import torch
    return [(ev.name, ev.time_range.elapsed_us() / 1e3)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def profile_linreg_path(cname, cfg, dev, smi):
    """Profile ROUNDS failure-free rounds through the linreg kernel."""
    import torch
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import Scenario
    sc = Scenario(name=f"linreg-{cname}/gmom/none/static", attack="none",
                  schedule="static", **dict(cfg, rounds=ROUNDS))
    step, ds = engine.failure_free_step(sc, device=dev)
    theta = torch.zeros((sc.dim,), dtype=torch.float32, device=dev)

    def rounds(theta, n):
        for _ in range(n):
            theta = step(theta)
        return theta

    theta = rounds(theta, 2)                                   # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rounds(theta, ROUNDS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(ms for _, ms in events)
    by_kernel = {k: sum(ms for n, ms in events if k in n) / ROUNDS
                 for k in LINREG_KERNELS}
    print(json.dumps({
        "path": "linreg_round_kernel", "config": cname, "dim": sc.dim,
        "num_workers": sc.num_workers, "num_batches": sc.num_batches,
        "rounds": ROUNDS, "card": smi,
        "profiled_wall_ms_per_round": wall_ms / ROUNDS,
        "device_busy_ms_per_round": busy_ms / ROUNDS,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels_per_round": len(events) / ROUNDS,
        "device_ms_per_round_by_kernel": by_kernel}), flush=True)
    del step, ds
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import FULL_WIDTH
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.core.robust_train import (aggregate_reported,
                                               per_worker_grads)
    from repro_torch.core.train_state import advance
    from repro_torch.data import regression
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import Scenario

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    for cname, cfg in FULL_WIDTH.items():
        sc = Scenario(name=f"linreg-{cname}/gmom/sign_flip/rotating",
                      **dict(cfg, rounds=ROUNDS))
        run, state, batches, rc, schedule = engine._build_run(sc, device=dev)
        state, _ = advance(run, state, batches, num_rounds=2)   # warm-up

        # stage breakdown, one synchronised stage at a time
        stages: dict[str, list[float]] = {}
        params, opt_state = state.params, state.opt_state
        astate = state.attack_state
        opt = optim.sgd(sc.step_size)

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        for t in range(2, 2 + ROUNDS):
            key_t = stage("fold_in", lambda: prng.fold_in(state.base_key, t))
            stacked, losses = stage("grads", lambda: per_worker_grads(
                regression.squared_loss, params, batches))
            reported, mask, astate = stage("attack", lambda: schedule.apply(
                stacked, key_t, t, astate))
            agg = stage("aggregate", lambda: aggregate_reported(
                reported, rc, key=key_t))
            updates, opt_state = stage("sgd", lambda: opt.update(
                agg, opt_state, params))
            params = stage("apply", lambda: params + updates)
        breakdown = {k: statistics.median(v) for k, v in stages.items()}

        # profiler over the engine's own loop
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, _ = advance(run, state, batches, num_rounds=ROUNDS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_dev, ours_ms, ours_n = 0.0, 0, 0.0, 0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = ev.time_range.elapsed_us() / 1e3
            busy_ms += ms
            n_dev += 1
            if any(k in ev.name for k in ROUND_KERNELS):
                ours_ms += ms
                ours_n += 1
        print(json.dumps({
            "config": cname, "dim": sc.dim, "num_workers": sc.num_workers,
            "num_batches": sc.num_batches, "rounds": ROUNDS, "card": smi,
            "stage_ms_median": breakdown,
            "stage_sum_ms": sum(breakdown.values()),
            "profiled_wall_ms_per_round": wall_ms / ROUNDS,
            "device_busy_ms_per_round": busy_ms / ROUNDS,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels_per_round": n_dev / ROUNDS,
            "round_kernel_device_ms_per_round": ours_ms / ROUNDS,
            "round_kernel_cuda_launches_per_round": ours_n / ROUNDS}),
            flush=True)
        del run, state, batches, params, stacked, reported
        torch.cuda.empty_cache()
        profile_linreg_path(cname, cfg, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
