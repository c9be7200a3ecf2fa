"""Batched serving from the command line (port of ``repro.launch.serve``).

* ``--scale gpu`` (default): the config at full width on the CUDA card
  (all layers, all published widths; weights random from ``--seed``);
  raises without a card.
* ``--scale cpu``: the reduced config on the CPU, as the reference serves
  it.

Both prefill the prompts through decode steps (the reference's path) and
then decode greedily.  The audio family decodes against the zero encoder
memory of ``model.init_decode_state``, as the reference's ``serve_cpu``
does, so its cross-attention adds exactly 0; the vlm family decodes text
tokens alone, with no patch prefix, as the reference's does.  Prompts
are drawn from ``--seed`` too, on a generator of their own (seeded with
``--seed`` XOR ``PROMPT_SEED``), so their stream differs from the
params', as the reference folds its key for them.  The reference's
``--scale pod`` (a dry-run lowering on the production mesh) is ROADMAP
Queue 1 item 17 and is not ported, nor are its ``--shape`` and
``--multi-pod`` flags, which are refused.

    PYTHONPATH=src python -m repro_torch.launch.serve          # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --scale cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import _device
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import sharding, steps
from repro_torch.models import meshctx
from repro_torch.models import model as model_lib

# XORed into --seed for the prompts' generator (the params' takes --seed)
PROMPT_SEED = 0x5EED_F01D_0000_0001


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts, new_tokens: int, *,
             batch: int | None = None):
    """Greedy decoding.  prompts: (B, P) on the params' device.  The prompt
    goes through P decode steps, then ``new_tokens - 1`` more steps decode.
    Returns (tokens (B, new_tokens), logits after the prompt (B, 1, V),
    {"prefill_s", "decode_s"}).  Under an ambient model mesh ``params``
    are the rank's (``sharding.local_params``) and ``prompts`` its rows
    (``sharding.local_rows``) of ``batch`` prompts (default B |data|);
    where the data axes do not divide ``batch`` those rows are all of
    them, the same on every rank.  The rank decodes on its block of the
    state (``sharding.local_decode_state``) and returns its rows' tokens
    and logits, the same on every model rank."""
    B, P = prompts.shape
    dev = prompts.device
    step = steps.make_serve_step(cfg)
    mesh = meshctx.current_mesh()
    if mesh is None:
        state = model_lib.init_decode_state(cfg, B, P + new_tokens,
                                            device=dev)
    else:
        rows = B * meshctx.data_size(mesh) if batch is None else batch
        if sharding.block_shape((rows,), sharding.serve_batch_spec(
                mesh, rows), mesh) != (B,):
            raise ValueError(
                f"{B} prompt rows on a rank are not its serve rows of a "
                f"batch of {rows} on {meshctx.data_size(mesh)} data ranks")
        state = sharding.local_decode_state(
            model_lib.init_decode_state(cfg, rows, P + new_tokens,
                                        device=dev), mesh, cfg, rows)

    def pos(t):
        return torch.full((B,), t, dtype=torch.int64, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, state = step(params, state, prompts[:, t:t + 1], pos(t))
    prompt_logits = logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits[:, -1:], dim=-1)
    out = [tokens]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, state = step(params, state, tokens, pos(P + i))
        tokens = torch.argmax(logits, dim=-1)
        out.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return (torch.cat(out, dim=1), prompt_logits,
            {"prefill_s": t_prefill, "decode_s": t_decode})


def draw_prompts(seed: int, cfg, batch: int, prompt_len: int, device):
    """(batch, prompt_len) token ids from a generator of their own."""
    gen = torch.Generator(device=device).manual_seed(seed ^ PROMPT_SEED)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def _serve(args, cfg, device):
    params = model_lib.init(args.seed, cfg, device=device)
    prompts = draw_prompts(args.seed, cfg, args.batch, args.prompt_len,
                           device)
    tokens, _, times = generate(params, cfg, prompts, args.new_tokens)
    where = ("CPU" if device.type == "cpu"
             else torch.cuda.get_device_name(device))
    rate = args.batch * args.new_tokens / max(times["decode_s"], 1e-9)
    print(f"[serve] {args.arch}: prefill {args.prompt_len}tok in "
          f"{times['prefill_s']:.2f}s; decode {args.new_tokens}x{args.batch} "
          f"in {times['decode_s']:.2f}s ({rate:.1f} tok/s {where})")
    return tokens, dict(times, tokens_per_s=rate)


def serve_cpu(args):
    """The reduced config on the CPU.  -> (tokens, stats)."""
    cfg = get_config(args.arch).reduced()
    if cfg.family == "hybrid":
        cfg = cfg.with_(ssm_chunk=8)
    return _serve(args, cfg, _device.enter("cpu"))


def serve_gpu(args):
    """The config at full width on the CUDA card.  -> (tokens, stats)."""
    return _serve(args, get_config(args.arch), _device.enter(None))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="h2o-danube-3-4b",
                   choices=list(ARCHITECTURES))
    p.add_argument("--scale", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--shape", default=None,
                   choices=["decode_32k", "long_500k"])
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.shape is not None or args.multi_pod:
        p.error("--shape and --multi-pod belong to the pod dry-run, which is "
                "not ported (ROADMAP Queue 1 item 17)")
    return serve_cpu(args) if args.scale == "cpu" else serve_gpu(args)


if __name__ == "__main__":
    main()
