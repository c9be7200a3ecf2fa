"""The paper's linear-regression experiment (§4, Corollary 1) end to end
on the PyTorch port (its counterpart of
examples/linear_regression_byzantine.py).

Sweeps every attack of the port against mean and gmom aggregation and
prints the convergence table beside the paper's closed forms.  On the
card by default:

    PYTHONPATH=src python examples/torch_linear_regression_byzantine.py
    PYTHONPATH=src python examples/torch_linear_regression_byzantine.py \\
        --device cpu --rounds 20
"""

import argparse

import torch

from repro_torch import optim
from repro_torch import random as prng
from repro_torch.core import (RobustConfig, byzantine,
                              make_robust_train_step, theory)
from repro_torch.core.grouping import choose_num_batches
from repro_torch.data import regression

DIM, N, M_WORKERS, Q, ROUNDS = 100, 50_000, 50, 4, 50


def run(aggregator: str, attack: str, *, device=None, rounds: int = ROUNDS):
    """-> (||theta_t - theta*|| for t = 0..rounds, k)."""
    ds = regression.generate(prng.PRNGKey(0), dim=DIM, total_samples=N,
                             num_workers=M_WORKERS, device=device)
    dev = ds.features.device
    k = choose_num_batches(M_WORKERS, Q)
    rc = RobustConfig(num_workers=M_WORKERS, num_byzantine=Q,
                      num_batches=k, attack=attack, aggregator=aggregator)
    opt = optim.sgd(theory.LINEAR_REGRESSION.step_size)   # the paper's GD
    step = make_robust_train_step(regression.squared_loss, opt, rc)
    theta = torch.zeros((DIM,), device=dev)
    opt_state = opt.init(theta)
    batches = regression.worker_batches(ds)
    errs = []
    for t in range(rounds):
        errs.append(float(torch.linalg.norm(theta - ds.theta_star)))
        theta, opt_state, _ = step(theta, opt_state, batches,
                                   prng.PRNGKey(1, device=dev), t)
    errs.append(float(torch.linalg.norm(theta - ds.theta_star)))
    return errs, k


def main(argv=None) -> dict:
    """-> {(aggregator, attack): the error trace}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (raises without one)")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    args = p.parse_args(argv)
    print(f"linear regression: d={DIM} N={N} m={M_WORKERS} q={Q}")
    print(f"theory: eta = {theory.LINEAR_REGRESSION.step_size}, "
          f"contraction = {theory.LINEAR_REGRESSION.theorem1_contraction:.4f}"
          f" (Cor. 1: 1/2 + sqrt(3)/4)\n")
    header = f"{'aggregator':18s} {'attack':18s} {'err@0':>8s} " \
             f"{'err@10':>8s} {'err@final':>10s}"
    print(header)
    print("-" * len(header))
    traces = {}
    for attack in byzantine.available():
        for aggregator in (["mean", "gmom"] if attack != "none"
                           else ["mean"]):
            errs, k = run(aggregator, attack, device=args.device,
                          rounds=args.rounds)
            traces[(aggregator, attack)] = errs
            print(f"{aggregator:18s} {attack:18s} {errs[0]:8.3f} "
                  f"{errs[min(10, args.rounds)]:8.3f} {errs[-1]:10.4f}")
    print(f"\nerror floor (Thm 5, c2=1): "
          f"{theory.error_floor(DIM, N, k):.4f}; "
          f"centralized minimax sqrt(d/N) = {(DIM / N) ** 0.5:.4f}")
    return traces


if __name__ == "__main__":
    main()
