"""Train a (reduced) assigned-architecture LM under Byzantine attack on
the PyTorch port (its counterpart of examples/train_lm_under_attack.py).

The paper's comparison, classical BGD against Byzantine GD, on a
non-convex transformer LM with the worker-mode robust step; every
architecture of the reference, at its ``reduced()`` widths, on the card by
default:

    PYTHONPATH=src python examples/torch_train_lm_under_attack.py \\
        --arch minitron-4b --steps 200
    PYTHONPATH=src python examples/torch_train_lm_under_attack.py \\
        --arch seamless-m4t-medium --steps 20 --device cpu

Training at published widths on the card is launch/train.py's
``--scale gpu``.
"""

import argparse

from repro_torch import optim
from repro_torch import random as prng
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core import RobustConfig, make_robust_train_step
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.train import build_cpu_batch
from repro_torch.models import model as M


def run(arch: str, aggregator: str, attack: str, steps: int, m: int = 8, *,
        device=None, seq_len: int = 64):
    """-> the median worker loss of every step."""
    cfg = get_config(arch).reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=2 * m, num_workers=m, seed=0,
                         device=device)
    rc = RobustConfig(num_workers=m, num_byzantine=2, attack=attack,
                      aggregator=aggregator, num_batches=m)
    opt = optim.adamw(1e-3)
    step = make_robust_train_step(lambda p, b: M.loss_fn(p, b, cfg), opt,
                                  rc)
    params = M.init(0, cfg, device=device)
    dev = next(iter(params.values())).device
    opt_state = opt.init(params)
    key = prng.PRNGKey(0, device=dev)
    trace = []
    for i in range(steps):
        # the vlm and audio families add their patch and frame stubs
        batch = build_cpu_batch(cfg, stream, i, prng.fold_in(key, i))
        params, opt_state, metrics = step(params, opt_state, batch,
                                          prng.PRNGKey(5, device=dev), i)
        loss = float(metrics["loss_median"])
        trace.append(loss)
        if i % max(steps // 10, 1) == 0:
            print(f"  step {i:4d}  loss {loss:.4f}")
    return trace


def main(argv=None) -> dict:
    """-> {(aggregator, attack): the loss trace}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="minitron-4b",
                   choices=list(ARCHITECTURES))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (raises without one)")
    args = p.parse_args(argv)
    results = {}
    for aggregator, attack in [("mean", "none"), ("mean", "sign_flip"),
                               ("gmom", "sign_flip")]:
        print(f"\n=== {args.arch}: aggregator={aggregator} "
              f"attack={attack} ===")
        results[(aggregator, attack)] = run(
            args.arch, aggregator, attack, args.steps, device=args.device,
            seq_len=args.seq_len)
    print("\nsummary (final loss):")
    for (agg, atk), trace in results.items():
        print(f"  {agg:5s} + {atk:10s}: {trace[0]:.3f} -> {trace[-1]:.3f}")
    clean = results[("mean", "none")][-1]
    robust = results[("gmom", "sign_flip")][-1]
    print(f"\nByzantine GD within {abs(robust - clean):.3f} nats of the "
          f"attack-free run; classical BGD ended at "
          f"{results[('mean', 'sign_flip')][-1]:.2f}.")
    return results


if __name__ == "__main__":
    main()
