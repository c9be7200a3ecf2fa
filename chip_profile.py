#!/usr/bin/env python3
"""Where the time of the port's paths goes on the card.

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
  device time and launches of the round kernel (one persistent CUDA
  kernel);
* a ``torch.profiler`` trace of ``ROUNDS`` failure-free rounds through
  ``linreg_round_kernel`` (theta <- theta - eta aggregate): the same
  shares, and the device time of each of its CUDA kernels by name.

Prints two JSON lines per config.  Then, for the LM serve path of
``chip_smoke.py`` (H2O-Danube3-4B at full width, bf16), a trace of one
prefill step at B = 1, T = 8192 and one of ``DECODE_STEPS`` decode steps
at 4 requests: device busy time, idle share, device kernels, and device
time by kernel family (the flash kernel, matmuls, the rest) with the
heaviest kernels by name, and the flash kernel's launches by route (the
bf16 prefill's must all be on the tensor-core route).  Needs a CUDA
card.
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
DECODE_STEPS = 8
# the round kernel is one persistent CUDA kernel; the linreg round adds its
# one-pass front, or the two-pass route's residual and gradient kernels
ROUND_KERNELS = ("gmom_round_kernel",)
LINREG_KERNELS = ("linreg_onepass_kernel", "residual_kernel",
                  "grad_kernel") + ROUND_KERNELS


def device_events(prof):
    """(name, device ms) of every CUDA event in a profile."""
    import torch
    return [(ev.name, ev.time_range.elapsed_us() / 1e3)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def weiszfeld_iters(sc, ds, dev, rounds):
    """The Weiszfeld iterations of each of ``rounds`` failure-free rounds
    from theta = 0 (the kernel's own count, read back after the rounds)."""
    import torch
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.sim import engine
    counts, kernel = [], rk.linreg_round_kernel

    def counted(*args, **kw):
        y, it = kernel(*args, **kw)
        counts.append(it)
        return y, it

    rk.linreg_round_kernel = counted
    try:
        step, _ = engine.failure_free_step(sc, device=dev, dataset=ds)
    finally:
        rk.linreg_round_kernel = kernel
    theta = torch.zeros((sc.dim,), dtype=torch.float32, device=dev)
    for _ in range(rounds):
        theta = step(theta)
    return [int(it) for it in counts]


def profile_linreg_path(cname, cfg, dev, smi):
    """Profile ROUNDS failure-free rounds through the linreg kernel, and
    count the Weiszfeld iterations of each of the config's rounds."""
    import torch
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import Scenario
    sc = Scenario(name=f"linreg-{cname}/gmom/none/static", attack="none",
                  schedule="static", **dict(cfg, rounds=ROUNDS))
    step, ds = engine.failure_free_step(sc, device=dev)
    iters = weiszfeld_iters(sc, ds, dev, cfg["rounds"])
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
        "device_ms_per_round_by_kernel": by_kernel,
        "weiszfeld_iters_per_round": iters,
        "rounds_at_max_iters": sum(
            it >= engine._robust_config(sc, "auto").gmom_max_iters
            for it in iters)}), flush=True)
    del step, ds
    torch.cuda.empty_cache()


def _trace(fn, dev):
    """(wall ms, device events) of one profiled call of ``fn``."""
    import torch
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, device_events(prof)


def _shares(wall_ms, events, per):
    """Busy/idle and device ms by kernel family, per ``per`` units."""
    busy = sum(ms for _, ms in events)
    family = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for name, ms in events:
        if "flash_attention" in name:
            family["flash_attention"] += ms
        elif any(k in name.lower() for k in ("gemm", "nvjet", "cutlass",
                                              "sm90_xmma", "matmul")):
            family["matmul"] += ms
        else:
            family["other"] += ms
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms / per, "device_busy_ms": busy / per,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_kernels": len(events) / per,
            "device_ms_by_family": {k: v / per for k, v in family.items()},
            "heaviest_device_ms": {k: v / per for k, v in top}}


def profile_serve_path(dev, smi):
    """Profile the prefill step and decode steps of the serve path."""
    import torch
    from chip_smoke import PREFILL_T, SERVE_ARCH
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = get_config(SERVE_ARCH)
    params = model.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_T), generator=gen,
                           device=dev)
    prefill = steps.make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :256]})                # warm-up
    flash.reset_launches()
    wall, events = _trace(lambda: prefill(params, {"tokens": tokens}), dev)
    routes = dict(flash.flash_attention.route_launches)
    print(json.dumps({"path": "serve_prefill", "arch": cfg.name,
                      "dtype": "bfloat16", "batch": 1, "seq_len": PREFILL_T,
                      "card": smi, "launches_by_route": routes,
                      **_shares(wall, events, 1)}), flush=True)
    if routes != {"tensor_core": cfg.num_layers, "cuda_core": 0}:
        raise RuntimeError(f"bf16 prefill: flash launches by route {routes}")

    B, P = 4, 16
    step = steps.make_serve_step(cfg)
    state = model.init_decode_state(cfg, B, P + DECODE_STEPS, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)

    def pos(t):
        return torch.full((B,), t, dtype=torch.int64, device=dev)

    for t in range(P):                                  # prompt, warm-up
        logits, state = step(params, state, prompts[:, t:t + 1], pos(t))

    def decode():
        nonlocal logits, state
        for i in range(DECODE_STEPS):
            tok = torch.argmax(logits, dim=-1)
            logits, state = step(params, state, tok, pos(P + i))

    wall, events = _trace(decode, dev)
    print(json.dumps({"path": "serve_decode", "arch": cfg.name,
                      "dtype": "bfloat16", "batch": B, "steps": DECODE_STEPS,
                      "card": smi, "per": "decode step",
                      **_shares(wall, events, DECODE_STEPS)}), flush=True)
    del params, state
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
    profile_serve_path(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
