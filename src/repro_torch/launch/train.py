"""End-to-end training driver (port of ``repro.launch.train``).

Worker-mode Byzantine GD on a transformer LM (the paper-faithful path):
a synthetic token stream, per-worker gradients, the attack schedule,
robust aggregation (GMoM through the CUDA round kernel on the card),
AdamW, checkpoints of the full ``TrainState`` and a metrics log.

* ``--scale gpu`` (default): the architecture at its published widths on
  the CUDA card, cut only in depth (``gpu_train_layers``), with the
  config's remat (``models.blocks.maybe_remat``, which batches under the
  per-worker ``vmap`` of ``grad``); raises without a card.
* ``--scale cpu``: the reduced config on the CPU, as the reference's
  default.
* ``--scale pod``: the reference's dry run of the production job, one
  train_4k step of rank ``--rank`` of the (16, 16) mesh (``--multi-pod``:
  (2, 16, 16)) traced on fake tensors (``launch.dryrun``; no card, no
  process group), its roofline record printed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --scale cpu \\
        --steps 20 --byzantine 2 --attack sign_flip --aggregator gmom
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \\
        --seq-len 512          # H2O-Danube3-4B, 2 layers, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \\
        --seq-len 512 --arch granite-moe-1b-a400m     # 8 layers
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \\
        --seq-len 512 --arch zamba2-2.7b              # 6 layers
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \\
        --seq-len 512 --arch seamless-m4t-medium      # 1 + 1 layers
    PYTHONPATH=src python -m repro_torch.launch.train --scale pod \\
        --arch qwen2-72b                              # dry run, rank 0
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
from torch.utils._pytree import tree_map

from repro_torch import _device, checkpoint, optim
from repro_torch import random as prng
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core import (RobustConfig, aggregators, byzantine,
                              init_train_state, make_run_rounds,
                              restore_train_state, save_train_state,
                              schedule_from_config, staleness)
from repro_torch.core.train_state import advance, history_rows
from repro_torch.data.tokens import (TokenStream, frame_embeddings,
                                     patch_embeddings)
from repro_torch.models import model as model_lib

# --scale gpu keeps the published widths and cuts the depth to the most
# layers whose reckoned round fits the card: a round at m = k = 8 holds
# about 111 bytes a parameter (params, AdamW moments, the stacked and
# reported bf16 gradients, the (8, P) f32 block, the round kernel's Z;
# 61.6 GB at H2O-Danube3-4B's P = 555.4 M on an H100 80GB), and the
# reckoning may take 64 GB of the card's 80, leaving 16 GB to what does
# not scale with P: the activations of m workers under vmap.  With remat
# the per-worker gradients at m = 8 and 2 x 512 tokens a worker take 14.5
# to 16.0 GB above the params for H2O, Granite-3.0-1B-A400M and Zamba2
# (24.3, 42.0 and 63.9 GB without remat; an H100 80GB, as chip_smoke.py
# phase 10 (e) measures them).  So H2O trains at
# 2 layers, Granite at 8 of its 24, Zamba2 at 6 of its 54 (one group: a
# hybrid depth is a multiple of its shared-block period).
GPU_TRAIN_BYTES_PER_PARAM = 111
GPU_TRAIN_BUDGET_BYTES = 64e9
DEFAULT_ARCH = {"cpu": "minitron-4b", "gpu": "h2o-danube-3-4b"}


def _at_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers: for the audio family the encoder
    and the decoder both, to the one count."""
    if cfg.family == "audio":
        return cfg.with_(num_layers=layers, encoder_layers=layers)
    return cfg.with_(num_layers=layers)


def gpu_train_layers(cfg) -> int:
    """The most layers (up to ``cfg.num_layers``; for the hybrid family a
    multiple of ``shared_attn_every``, whole groups; for the audio family
    one count for the encoder and the decoder, up to the smaller of the
    two) at which ``GPU_TRAIN_BYTES_PER_PARAM`` bytes a parameter fit
    ``GPU_TRAIN_BUDGET_BYTES``; raises when not even the least depth
    fits.  The count is the reference's ``param_count``, which reckons
    SeamlessM4T at one encoder and one decoder layer at 62.43 GB (two:
    66.62 GB), so the card's scale trains it at 1 + 1 layers, 558 279 680
    real parameters: that cut is this scale's own, not the reference's."""
    step = (cfg.shared_attn_every or 1) if cfg.family == "hybrid" else 1
    deepest = cfg.num_layers
    if cfg.family == "audio":
        deepest = min(deepest, cfg.encoder_layers)

    def reckoned(layers):
        return (GPU_TRAIN_BYTES_PER_PARAM
                * _at_depth(cfg, layers).param_count())

    if reckoned(step) > GPU_TRAIN_BUDGET_BYTES:
        # a mesh of one card's ranks shares its memory: only more cards
        # add room
        cards = math.ceil(reckoned(deepest) / GPU_TRAIN_BUDGET_BYTES)
        raise NotImplementedError(
            f"{cfg.name} at {step} layer(s) reckons "
            f"{reckoned(step) / 1e9:.1f} GB a round, past the card's "
            f"{GPU_TRAIN_BUDGET_BYTES / 1e9:.0f} GB budget; at its "
            f"{deepest} layers it needs {cards} cards of "
            f"{GPU_TRAIN_BUDGET_BYTES / 1e9:.0f} GB, its params and "
            "gradients sharded over a mesh of several cards (ROADMAP Queue "
            "1 item 16.13, which waits for a 4-chip cell)")
    return max(layers for layers in range(step, deepest + 1, step)
               if reckoned(layers) <= GPU_TRAIN_BUDGET_BYTES)


def train_config(arch: str, scale: str):
    """The config ``train`` runs at ``scale``: reduced on the CPU; the
    published widths at ``gpu_train_layers`` layers on the card (the audio
    encoder cut with the decoder), remat as the config has it; the config
    itself on the pod (the dry run's)."""
    if scale == "cpu":
        return get_config(arch).reduced()
    if scale == "gpu":
        cfg = get_config(arch)
        return _at_depth(cfg, gpu_train_layers(cfg))
    if scale == "pod":
        return get_config(arch)
    raise ValueError(f"unknown scale {scale!r}")


def build_cpu_batch(cfg, stream: TokenStream, step: int, key):
    """The step's worker batches, (m, B/m, T) tokens and labels.  vlm:
    tokens and labels cut to T - num_patches, and (m, B/m, num_patches, D)
    patches drawn on ``key``; audio: (m, B/m, max(T // divisor, 1), D)
    frames drawn on ``key``; both in ``cfg.dtype``, drawn in float32 and
    cast (the reference draws in ``cfg.dtype``: the same values in a
    float32 config).  The other families need only the stream."""
    batch = stream.batch(step)
    m, bw, t = batch["tokens"].shape
    if cfg.family == "vlm":
        keep = t - cfg.num_patches
        return {"tokens": batch["tokens"][..., :keep],
                "labels": batch["labels"][..., :keep],
                "patches": patch_embeddings(
                    key, num_workers=m, per_worker=bw,
                    num_patches=cfg.num_patches, d_model=cfg.d_model,
                    dtype=cfg.dtype)}
    if cfg.family == "audio":
        return dict(batch, frames=frame_embeddings(
            key, num_workers=m, per_worker=bw,
            num_frames=max(t // cfg.encoder_seq_divisor, 1),
            d_model=cfg.d_model, dtype=cfg.dtype))
    return batch


def resume_train_state(ckpt_dir, params, opt_state, schedule, step_key,
                       arrival=None):
    """Restore the latest checkpoint in ``ckpt_dir`` into a TrainState.

    Returns ``(state, restored_step)``, ``(fresh state, 0)`` when there is
    no checkpoint.  A TrainState checkpoint (format_version >= 2) restores
    the full state, so the resumed trajectory replays an uninterrupted
    run.  A legacy params-only checkpoint restores the params (cast to
    their dtypes) and nothing else, with a warning; the next save writes
    the full state."""
    state = init_train_state(params, opt_state, step_key, schedule=schedule,
                             arrival=arrival)
    step = checkpoint.latest_step(ckpt_dir) if ckpt_dir else None
    if step is None:
        return state, 0
    manifest = checkpoint.read_manifest(ckpt_dir, step)
    if manifest.get("payload") == "train_state":
        state = restore_train_state(ckpt_dir, step, params, opt_state,
                                    schedule=schedule, arrival=arrival)
        print(f"[train] restored full TrainState (round {step}, "
              f"schedule {schedule.name!r}) from {ckpt_dir}")
        return state, step
    params = checkpoint.restore(ckpt_dir, step, params, allow_cast=True)
    print(f"[train] WARNING: legacy params-only checkpoint (step {step}, "
          f"{ckpt_dir}): optimizer state, adversary state, and metrics "
          "history were not saved and restart fresh — the resumed "
          "trajectory will NOT match an uninterrupted run. The next "
          "checkpoint upgrades to a full TrainState.")
    return state._replace(params=params, round_index=torch.tensor(
        step, dtype=torch.int32, device=state.round_index.device)), step


def train(args) -> dict:
    """The reference's ``train_cpu``, line for line, at ``args.scale``:
    on the CPU for ``cpu``, on the CUDA card (raising without one) for
    ``gpu``; ``pod`` is ``train_pod``."""
    if args.scale == "pod":
        return train_pod(args)
    cfg = train_config(args.arch, args.scale)
    if args.scale != "cpu":
        _device.expandable_segments()
    dev = _device.enter("cpu" if args.scale == "cpu" else None)
    m = args.workers
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.batch, num_workers=m,
                         seed=args.seed, device=dev)
    rc = RobustConfig(num_workers=m, num_byzantine=args.byzantine,
                      attack=args.attack, aggregator=args.aggregator,
                      num_batches=args.num_batches,
                      round_backend=args.round_backend,
                      arrival=args.arrival,
                      staleness_bound=args.staleness_bound)
    opt = optim.adamw(args.lr)

    def loss_fn(p, b):
        return model_lib.loss_fn(p, b, cfg)

    if args.schedule:
        schedule = byzantine.make_schedule(
            args.schedule, num_workers=m, num_byzantine=args.byzantine,
            attack=args.attack)
    else:
        schedule = schedule_from_config(rc)
    # rounds run in chunks of --scan-chunk (the reference fuses a chunk
    # into one lax.scan dispatch; here a chunk's batches are built at once
    # and the rounds loop on the host)
    arrival = staleness.arrival_from_config(rc)
    run = make_run_rounds(loss_fn, opt, rc, schedule=schedule,
                          arrival=arrival, device=dev)

    key = prng.PRNGKey(args.seed, device=dev)
    params = model_lib.init(args.seed, cfg, device=dev)
    opt_state = opt.init(params)
    step_key = prng.fold_in(key, 10_000)
    # NOTE: resume assumes the same --seed/--batch/--seq-len (the data
    # stream re-derives from args); the step keys themselves are restored
    # from the checkpoint.
    state, start = resume_train_state(args.ckpt_dir, params, opt_state,
                                      schedule, step_key, arrival=arrival)

    chunk = max(1, args.scan_chunk)
    if args.ckpt_dir:
        chunk = min(chunk, args.ckpt_every)
    t0 = time.time()
    i = start
    while i < args.steps:
        n = min(chunk, args.steps - i)
        if args.ckpt_dir:   # never run a chunk across a checkpoint boundary
            n = min(n, args.ckpt_every - i % args.ckpt_every)
        rounds = [build_cpu_batch(cfg, stream, j, prng.fold_in(key, j))
                  for j in range(i, i + n)]
        batch = tree_map(lambda *xs: torch.stack(xs), *rounds)
        state, _ = advance(run, state, batch, per_round_batches=True)
        i += n
        if (i - 1) % args.log_every < n or i == args.steps:
            print(f"[train] step {i - 1:4d} loss_median="
                  f"{float(state.history['loss_median'][-1]):.4f} "
                  f"gnorm={float(state.history['agg_grad_norm'][-1]):.3f} "
                  f"({time.time() - t0:.1f}s)")
        # boundary saves plus a final save, so the completed run is always
        # resumable/inspectable even when steps % ckpt_every != 0
        if args.ckpt_dir and (i % args.ckpt_every == 0 or i == args.steps):
            save_train_state(args.ckpt_dir, state)
    seconds = time.time() - t0
    history = history_rows(state.history)
    result = {"arch": args.arch, "aggregator": args.aggregator,
              "attack": args.attack, "byzantine": args.byzantine,
              "schedule": schedule.name,
              "arrival": args.arrival,
              "staleness_bound": args.staleness_bound,
              "resumed_from": start,
              "seconds": seconds,     # the rounds' wall time, after init
              "final_loss": history[-1]["loss_median"] if history else None,
              "first_loss": history[0]["loss_median"] if history else None,
              "history": history}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def train_pod(args) -> dict:
    """One train_4k step of rank ``args.rank`` of the production mesh,
    traced on fake tensors (the reference's ``train_pod``): its roofline
    record, printed and returned as a dict."""
    from repro_torch.launch import dryrun
    rec = dryrun.dryrun_pair(args.arch, "train_4k",
                             multi_pod=args.multi_pod, rank=args.rank,
                             num_groups=args.num_batches or 4,
                             microbatches=args.microbatches)
    print("[train] pod-scale step traced; roofline:",
          json.dumps(rec.to_dict(), indent=1, default=str))
    return rec.to_dict()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default=None, choices=list(ARCHITECTURES),
                   help="default: minitron-4b at --scale cpu, "
                        "h2o-danube-3-4b at --scale gpu")
    p.add_argument("--scale", default="gpu", choices=["gpu", "cpu", "pod"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--byzantine", type=int, default=2)
    p.add_argument("--num-batches", type=int, default=None, dest="num_batches")
    p.add_argument("--attack", default="sign_flip",
                   choices=byzantine.available())
    p.add_argument("--schedule", default=None,
                   choices=byzantine.available_schedules(),
                   help="multi-round attack schedule (default: rotating)")
    p.add_argument("--scan-chunk", type=int, default=10, dest="scan_chunk",
                   help="rounds whose batches are built at once")
    p.add_argument("--round-backend", default="auto", dest="round_backend",
                   choices=["auto", "fused", "fused_interpret", "reference"],
                   help="gmom hot path: the CUDA round kernel (fused; auto "
                        "on the card), its plain PyTorch version "
                        "(fused_interpret) or the reference pytree path")
    p.add_argument("--aggregator", default="gmom",
                   choices=aggregators.available())
    p.add_argument("--arrival", default="all_sync",
                   choices=staleness.available_arrivals(),
                   help="arrival model: which workers report fresh each "
                        "round; stale workers contribute their "
                        "bounded-staleness buffered gradient")
    p.add_argument("--staleness-bound", type=int, default=0,
                   dest="staleness_bound",
                   help="max buffered-gradient age tau (0 with all_sync = "
                        "the paper's synchronous path, bit-identical)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--microbatches", type=int, default=1,
                   help="a group's microbatches (--scale pod)")
    p.add_argument("--multi-pod", action="store_true",
                   help="the (2, 16, 16) mesh (--scale pod)")
    p.add_argument("--rank", type=int, default=0,
                   help="the rank whose step is traced (--scale pod)")
    p.add_argument("--out", default=None)
    return p


def parse_args(argv=None):
    """The CLI's arguments, with ``--arch`` defaulted by ``--scale``."""
    args = build_parser().parse_args(argv)
    if args.arch is None:
        args.arch = DEFAULT_ARCH.get(args.scale, DEFAULT_ARCH["cpu"])
    return args


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
