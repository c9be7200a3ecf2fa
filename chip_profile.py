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
  shares, and the device time of each of its CUDA kernels by name;
* a ``torch.profiler`` trace of ``ROUNDS`` rounds of each of the
  staleness, sign-wire and int8-wire variants (``chip_smoke.py`` phase 4):
  the same shares and the round kernel's device ms per round.

Prints five JSON lines per config.  Then, for the LM serve path of
``chip_smoke.py`` (H2O-Danube3-4B at full width, bf16), a trace of one
prefill step at B = 1, T = 8192 and one of ``DECODE_STEPS`` decode steps
at 4 requests: device busy time, idle share, device kernels, and device
time by kernel family (the flash kernel, matmuls, the rest) with the
heaviest kernels by name, and the flash kernel's launches by route (the
bf16 prefill's must all be on the tensor-core route); the same for
Granite-3.0-1B-A400M's serve path (phase 9), and its MoE layer's four
stages (router, dispatch, expert matmuls, combine) timed alone.  Last,
the LM train path of ``chip_smoke.py`` phase 8 (a) (H2O-Danube3-4B at
full width cut to 2 layers, m = 8, q = 2, k = 8, gmom under sign_flip,
AdamW), then Granite's at 8 layers (phase 9 (b)): a stage breakdown of
single rounds (per-worker gradients, the attack, the f32 concatenation
of the reports, the round kernel, the split back, AdamW, the update) and
a trace of ``TRAIN_ROUNDS`` rounds as launch/train.py runs them, with the
peak memory.  The recurrent families of phase 10 come after Granite's
in both: RWKV6-7B's and Zamba2-2.7B's serve paths (Zamba2's shared block
through the flash kernel, 9 launches a prefill; RWKV6 has no attention),
and Zamba2's train path at 6 layers.  The audio and VLM families of
phase 11 close the serve paths: SeamlessM4T-medium's (2048 frames from
``frame_embeddings``; 36 flash launches a prefill: the encoder's, the
decoder's self- and cross-attention) and InternVL2-26B's (256 patches
ahead of 7936 tokens; 48 launches).  Needs a CUDA card.
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
TRAIN_ROUNDS = 3
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


def profile_wire_and_stale(cname, cfg, dev, smi):
    """A trace of ``ROUNDS`` rounds, run as the engine runs them, of each
    of chip_smoke's phase-4 variants at this width: gmom with
    straggler_rotating at tau = 2 ("stale"), sign_sgd_majority on the
    packed sign wire ("sign") and int8_gmom on the int8_stochastic wire
    ("int8"): wall and device busy ms per round, idle share, device
    kernels per round and the round kernel's device ms per round."""
    import dataclasses
    import torch
    from repro_torch import random as prng
    from repro_torch.core.train_state import advance
    from repro_torch.sim import engine
    from repro_torch.sim.scenarios import Scenario
    base = Scenario(name=f"linreg-{cname}/gmom/sign_flip/rotating",
                    **dict(cfg, rounds=ROUNDS))
    variants = {
        "stale": dict(arrival="straggler_rotating", staleness_bound=2),
        "sign": dict(aggregator="sign_sgd_majority", schedule="static",
                     compression="sign", step_size=0.05),
        "int8": dict(aggregator="int8_gmom", compression="int8_stochastic")}
    # the variants share the configuration's data: generate it once
    ds = engine._generate(base, prng.PRNGKey(base.seed, device=dev), dev)
    for label, kw in variants.items():
        sc = dataclasses.replace(base, name=f"{base.name}/{label}", **kw)
        run, state, batches, _, _ = engine._build_run(sc, device=dev,
                                                      dataset=ds)
        state, _ = advance(run, state, batches, num_rounds=2)   # warm-up
        wall_ms, events = _trace(
            lambda: advance(run, state, batches, num_rounds=ROUNDS), dev)
        shares = _shares(wall_ms, events, ROUNDS)
        ours = [ms for name, ms in events
                if any(k in name for k in ROUND_KERNELS)]
        print(json.dumps({
            "config": cname, "path": label, "dim": sc.dim, "rounds": ROUNDS,
            "card": smi, "wall_ms_per_round": shares["wall_ms"],
            "device_busy_ms_per_round": shares["device_busy_ms"],
            "device_idle_share": shares["device_idle_share"],
            "device_kernels_per_round": shares["device_kernels"],
            "round_kernel_device_ms_per_round": sum(ours) / ROUNDS,
            "round_kernel_launches_per_round": len(ours) / ROUNDS,
            "heaviest_device_ms": shares["heaviest_device_ms"]}),
            flush=True)
        del run, state, batches
        torch.cuda.empty_cache()
    del ds
    torch.cuda.empty_cache()


def profile_serve_path(dev, smi, arch):
    """Profile the prefill step and decode steps of the serve path of
    ``arch`` at full width."""
    import torch
    from chip_smoke import PREFILL_T
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    from repro_torch.models import model
    from chip_smoke import _stub
    cfg = get_config(arch)
    params = model.init(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    # the vlm prefix's patches take PREFILL_T's first positions; the audio
    # encoder reads PREFILL_T / 4 frames
    stub = {"vlm": ("patches", cfg.num_patches),
            "audio": ("frames", PREFILL_T // cfg.encoder_seq_divisor)}
    kind, n = stub.get(cfg.family, (None, 0))
    T = PREFILL_T - n if kind == "patches" else PREFILL_T
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, T),
                                     generator=gen, device=dev)}
    if kind:
        batch[kind] = _stub(kind, cfg, n, dev)
    prefill = steps.make_prefill_step(cfg)
    prefill(params, {name: x[:, :256] for name, x in batch.items()})
    flash.reset_launches()
    wall, events = _trace(lambda: prefill(params, batch), dev)
    routes = dict(flash.flash_attention.route_launches)
    print(json.dumps({"path": "serve_prefill", "arch": cfg.name,
                      "dtype": "bfloat16", "batch": 1, "seq_len": PREFILL_T,
                      "stub": kind, "stub_len": n,
                      "card": smi, "launches_by_route": routes,
                      **_shares(wall, events, 1)}), flush=True)
    if cfg.family == "ssm":
        attention_layers = 0
    elif cfg.family == "hybrid":
        attention_layers = cfg.num_layers // cfg.shared_attn_every
    elif cfg.family == "audio":
        # the encoder's, and the decoder's self- and cross-attention
        attention_layers = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        attention_layers = cfg.num_layers
    if routes != {"tensor_core": attention_layers, "cuda_core": 0}:
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


def profile_train_path(dev, smi, arch):
    """Stage breakdown (host clock, each stage synchronised, medians over
    ``TRAIN_ROUNDS`` rounds after one warm-up round) and a profiler trace
    of ``TRAIN_ROUNDS`` rounds through ``make_run_rounds`` at the phase 8
    (a) config for ``arch`` at its train depth: device busy ms, idle
    share, device kernels per round, the round kernel's device ms and
    launches, its Weiszfeld iterations."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_map
    from chip_smoke import TRAIN_MAIN, TRAIN_SEQ
    from repro_torch import optim
    from repro_torch import random as prng
    from repro_torch.core import robust_train
    from repro_torch.core.grouping import make_grouping
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.geomed import round as rk
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    cfg = train_lib.train_config(arch, "gpu")
    m, q = TRAIN_MAIN["workers"], TRAIN_MAIN["byzantine"]
    rc = robust_train.RobustConfig(num_workers=m, num_byzantine=q,
                                   attack="sign_flip", aggregator="gmom")
    k = rc.resolved_num_batches()
    schedule = robust_train.schedule_from_config(rc)
    opt = optim.adamw(1e-3)

    def loss_fn(p, b):
        return model.loss_fn(p, b, cfg)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, cfg, device=dev)
    opt_state = opt.init(params)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_MAIN["batch"], num_workers=m,
                         device=dev)
    key = prng.fold_in(prng.PRNGKey(0, device=dev), 10_000)
    astate = schedule.init_state(dev)
    grouping = make_grouping(m, k)
    stages: dict[str, list[float]] = {}
    iters = []

    def stage(name, fn, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if t > 0:                                   # round 0 warms up
            stages.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        return out

    for t in range(1 + TRAIN_ROUNDS):
        batch = stream.batch(t)
        key_t = stage("fold_in", lambda: prng.fold_in(key, t), t)
        stacked, _ = stage("grads", lambda: robust_train.per_worker_grads(
            loss_fn, params, batch), t)
        reported, _, astate = stage("attack", lambda: schedule.apply(
            stacked, key_t, t, astate), t)
        del stacked
        block, split = stage("concat", lambda: rk.concat_block(reported), t)
        y, it = stage("round_kernel", lambda: rk.round_aggregate_kernel(
            block, grouping, trim_multiplier=rc.trim_multiplier,
            max_iters=rc.gmom_max_iters, tol=rc.gmom_tol), t)
        del block
        agg = stage("split", lambda: split(y), t)
        del reported, y
        updates, opt_state = stage("adamw", lambda: opt.update(
            agg, opt_state, params), t)
        params = stage("apply", lambda: tree_map(
            lambda p, u: (p + u).to(p.dtype), params, updates), t)
        del agg, updates
        iters.append(int(it))
    breakdown = {name: statistics.median(v) for name, v in stages.items()}
    stage_peak = torch.cuda.max_memory_allocated(dev) / 1e9

    run = robust_train.make_run_rounds(loss_fn, opt, rc, schedule=schedule,
                                       device=dev)
    batches = tree_map(lambda *xs: torch.stack(xs),
                       *[stream.batch(t) for t in range(TRAIN_ROUNDS)])
    wall_ms, events = _trace(lambda: run(
        params, opt_state, batches, key, start_round=1 + TRAIN_ROUNDS,
        attack_state=astate, per_round_batches=True), dev)
    busy = sum(ms for _, ms in events)
    ours = [ms for name, ms in events
            if any(kn in name for kn in ROUND_KERNELS)]
    print(json.dumps({
        "path": "train", "arch": cfg.name, "layers": cfg.num_layers,
        "params": sum(p.numel() for p in tree_leaves(params)),
        "num_workers": m, "num_byzantine": q, "num_batches": k,
        "seq_len": TRAIN_SEQ, "rounds": TRAIN_ROUNDS, "card": smi,
        "stage_ms_median": breakdown,
        "stage_sum_ms": sum(breakdown.values()),
        "weiszfeld_iters": iters,
        "stage_peak_mem_gb": stage_peak,
        "profiled_wall_ms_per_round": wall_ms / TRAIN_ROUNDS,
        "device_busy_ms_per_round": busy / TRAIN_ROUNDS,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_kernels_per_round": len(events) / TRAIN_ROUNDS,
        "round_kernel_device_ms_per_round": sum(ours) / TRAIN_ROUNDS,
        "round_kernel_launches_per_round": len(ours) / TRAIN_ROUNDS,
        "heaviest_device_ms": _shares(wall_ms, events,
                                      TRAIN_ROUNDS)["heaviest_device_ms"],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}),
        flush=True)
    del params, opt_state, run, batches
    torch.cuda.empty_cache()


def profile_moe_layer(dev, smi):
    """The MoE layer's four stages at Granite-3.0-1B-A400M's widths in
    bf16, one layer's forward: the router (f32 products, softmax, top-k,
    the aux losses), the dispatch (ranks, the slot gathers), the experts'
    batched matmuls and the combine; CUDA-event ms (medians of 20) at the
    prefill's N = 8192 tokens and a train worker's 2 x 512, with the
    expert matmuls' bf16 FLOP rate."""
    import torch
    from chip_smoke import MOE_ARCH, PREFILL_T, TRAIN_SEQ, timed
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, moe
    cfg = get_config(MOE_ARCH)
    spec = blocks.moe_spec(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init(gen, spec, dtype=torch.bfloat16)
    for n in (PREFILL_T, 2 * TRAIN_SEQ):
        x = torch.randn((n, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        C = moe._capacity(spec, n)
        ids, w, _, _ = moe.route(p, spec, x)
        xin, info = moe._dispatch_local(spec, x, ids, w, expert_lo=0,
                                        num_local=spec.num_experts,
                                        capacity=C)
        out = moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"], xin)
        ms = {
            "route": timed(lambda: moe.route(p, spec, x)),
            "dispatch": timed(lambda: moe._dispatch_local(
                spec, x, ids, w, expert_lo=0, num_local=spec.num_experts,
                capacity=C)),
            "experts": timed(lambda: moe._expert_ffn(
                p["w_gate"], p["w_up"], p["w_down"], xin)),
            "combine": timed(lambda: moe._combine(out, info, n)),
            "layer": timed(lambda: moe.apply(p, spec, x[None]))}
        flops = 2 * 3 * spec.num_experts * C * cfg.d_model * cfg.d_ff
        print(json.dumps({
            "path": "moe_layer", "arch": cfg.name, "tokens": n,
            "capacity": C, "experts": spec.num_experts,
            "top_k": spec.experts_per_token, "card": smi, "ms": ms,
            "experts_tflops": flops / ms["experts"] / 1e9}), flush=True)
        del x, xin, out, info
    del p
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch import _device
    _device.expandable_segments()      # the train path's blocks
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
        profile_wire_and_stale(cname, cfg, dev, smi)
    from chip_smoke import (AUDIO_ARCH, MOE_ARCH, RWKV_ARCH, SERVE_ARCH,
                            TRAIN_ARCH, VLM_ARCH, ZAMBA_ARCH)
    for arch in (SERVE_ARCH, MOE_ARCH, RWKV_ARCH, ZAMBA_ARCH, AUDIO_ARCH,
                 VLM_ARCH):
        profile_serve_path(dev, smi, arch)
    profile_moe_layer(dev, smi)
    for arch in (TRAIN_ARCH, MOE_ARCH, ZAMBA_ARCH):
        profile_train_path(dev, smi, arch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
