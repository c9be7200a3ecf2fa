"""Batched serving demo of the PyTorch port: prefill a batch of prompts,
then decode tokens (the port's counterpart of examples/serve_decode.py).

Builds the decode state (KV caches, recurrent states, the audio
encoder's memory), feeds the prompt through single-token decode steps and
samples greedily, for every architecture the port serves (all of the
reference's), at its ``reduced()`` widths; on the card by default:

    PYTHONPATH=src python examples/torch_serve_decode.py --arch h2o-danube-3-4b
    PYTHONPATH=src python examples/torch_serve_decode.py \\
        --arch seamless-m4t-medium --device cpu

Serving at published widths on the card is launch/serve.py's
``--scale gpu``.
"""

import argparse
import time

import torch

from repro_torch import _device
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import steps
from repro_torch.models import model as M


def prefill_into_state(params, cfg, tokens, state):
    """Feed the prompt through decode steps token by token (the simple
    prefill; the batched one is launch/steps.py's make_prefill_step)."""
    B, T = tokens.shape
    step = steps.make_serve_step(cfg)
    logits = None
    for t in range(T):
        logits, state = step(params, state, tokens[:, t:t + 1],
                             torch.full((B,), t, device=tokens.device))
    return logits, state


def main(argv=None):
    """-> the generated token ids (B, new_tokens)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="h2o-danube-3-4b",
                   choices=list(ARCHITECTURES))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.family == "hybrid":
        cfg = cfg.with_(ssm_chunk=8)
    dev = _device.enter(args.device)
    params = M.init(0, cfg, device=dev)
    B = args.batch
    max_len = args.prompt_len + args.new_tokens
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    state = M.init_decode_state(cfg, B, max_len, device=dev)
    shapes = [tuple(x.shape) for x in torch.utils._pytree.tree_leaves(state)]
    print(f"{args.arch}: state leaves {shapes[:4]} ...")

    t0 = time.time()
    logits, state = prefill_into_state(params, cfg, prompts, state)
    print(f"prefill {args.prompt_len} tokens x{B}: {time.time() - t0:.2f}s")

    step = steps.make_serve_step(cfg)
    tokens = torch.argmax(logits[:, -1:], dim=-1)
    generated = [tokens]
    t0 = time.time()
    for i in range(args.new_tokens - 1):
        pos = torch.full((B,), args.prompt_len + i, device=dev)
        logits, state = step(params, state, tokens, pos)
        tokens = torch.argmax(logits, dim=-1)
        generated.append(tokens)
    dt = time.time() - t0
    out = torch.cat(generated, dim=1)
    print(f"decoded {args.new_tokens} tokens x{B} in {dt:.2f}s "
          f"({B * args.new_tokens / max(dt, 1e-9):.1f} tok/s on {dev.type})")
    print("sample token ids:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
