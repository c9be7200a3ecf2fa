"""Quickstart of the PyTorch port: Byzantine Gradient Descent in ~50
lines (the port's counterpart of examples/quickstart.py).

Trains the paper's linear-regression model (§4) with m = 20 workers of
which q = 3 are Byzantine (omniscient sign flip), comparing classical BGD
(mean aggregation, the paper's Algorithm 1) against the paper's geometric
median of means (Algorithm 2).  On the card by default:

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch import optim
from repro_torch import random as prng
from repro_torch.core import RobustConfig, make_robust_train_step, theory
from repro_torch.data import regression

DIM, N, M_WORKERS, Q, ROUNDS = 50, 20_000, 20, 3, 30


def main(device=None, rounds: int = ROUNDS) -> dict:
    """-> {aggregator: ||theta - theta*|| after ``rounds`` rounds}."""
    dataset = regression.generate(prng.PRNGKey(0), dim=DIM, total_samples=N,
                                  num_workers=M_WORKERS, device=device)
    dev = dataset.features.device
    batches = regression.worker_batches(dataset)
    errors = {}
    for aggregator in ("mean", "gmom"):
        rc = RobustConfig(
            num_workers=M_WORKERS,
            num_byzantine=Q,
            attack="sign_flip",          # Byzantine workers report -10 x g
            aggregator=aggregator,       # "gmom": the paper's Algorithm 2
        )
        # the paper's fixed step eta = L / (2 M^2) (the reference's paper_gd)
        optimizer = optim.sgd(theory.LINEAR_REGRESSION.step_size)
        train_step = make_robust_train_step(regression.squared_loss,
                                            optimizer, rc)
        theta = torch.zeros((DIM,), device=dev)
        opt_state = optimizer.init(theta)
        for t in range(rounds):
            theta, opt_state, _ = train_step(
                theta, opt_state, batches, prng.PRNGKey(1, device=dev), t)
        err = float(torch.linalg.norm(theta - dataset.theta_star))
        errors[aggregator] = err
        print(f"{aggregator:5s}: ||theta - theta*|| = {err:10.4f}  "
              f"({'BROKEN' if err > 1 else 'converged'})")
    print(f"\ntheory floor ~ C_a*sqrt(dk/N) = "
          f"{theory.error_floor(DIM, N, rc.resolved_num_batches()):.4f}")
    return errors


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (raises without one)")
    main(p.parse_args().device)
