"""The paper's linear-regression data model (§4).

    y_i = <w_i, theta*> + zeta_i,   w_i ~ N(0, I_d),  zeta_i ~ N(0, 1)

Population risk F(theta) = 0.5 ||theta - theta*||^2 + 0.5 — strongly convex
with L = M = 1, so the paper's step size is eta = 1/2.

Data is generated once, split evenly into the m workers' local shards S_j
(|S_j| = N/m, disjoint), and kept fixed across rounds: full-batch
gradients, exactly Algorithm 1/2.  The draws are the reference's threefry
bits (``repro_torch.random``), made directly on the target device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import _device
from repro_torch import random as prng


@dataclasses.dataclass(frozen=True)
class RegressionDataset:
    features: torch.Tensor    # (m, N/m, d) — worker-major layout
    targets: torch.Tensor     # (m, N/m)
    theta_star: torch.Tensor  # (d,)

    @property
    def num_workers(self) -> int:
        return self.features.shape[0]

    @property
    def samples_per_worker(self) -> int:
        return self.features.shape[1]

    @property
    def dim(self) -> int:
        return self.features.shape[2]


def generate(key, *, dim: int, total_samples: int, num_workers: int,
             theta_star: torch.Tensor | None = None,
             noise_std: float = 1.0,
             heterogeneity: float = 0.0,
             device=None) -> RegressionDataset:
    """Entry point (``device=None`` means CUDA).  ``heterogeneity`` > 0
    scales worker j's covariates and label noise by per-worker factors in
    [1-h, 1+h]; h=0 is the paper's iid model."""
    device = _device.enter(device)
    if total_samples % num_workers != 0:
        raise ValueError("N must be divisible by m (paper: |S_j| = N/m)")
    per = total_samples // num_workers
    key = key.to(device)
    k_theta, k_w, k_z, k_h = prng.split(key, 4)
    if theta_star is None:
        theta_star = prng.normal(k_theta, (dim,))
    theta_star = theta_star.to(device=device, dtype=torch.float32)
    w = prng.normal(k_w, (num_workers, per, dim))
    zeta = noise_std * prng.normal(k_z, (num_workers, per))
    if heterogeneity > 0:
        k1, k2 = prng.split(k_h)
        scale_w = 1.0 + heterogeneity * prng.uniform(
            k1, (num_workers, 1, 1), -1.0, 1.0)
        scale_z = 1.0 + heterogeneity * prng.uniform(
            k2, (num_workers, 1), -1.0, 1.0)
        w = w * scale_w
        zeta = zeta * scale_z
    y = torch.einsum("mnd,d->mn", w, theta_star) + zeta
    return RegressionDataset(features=w, targets=y, theta_star=theta_star)


def squared_loss(theta, batch) -> torch.Tensor:
    """0.5 (<w, theta> - y)^2 averaged over the batch — the local empirical
    risk of S_j when batch = S_j."""
    w, y = batch
    pred = w @ theta
    return 0.5 * torch.mean((pred - y) ** 2)


def worker_batches(ds: RegressionDataset):
    """Tuple with leading worker axis, as ``per_worker_grads`` expects."""
    return (ds.features, ds.targets)


def centralized_erm(ds: RegressionDataset) -> torch.Tensor:
    """Oracle: the failure-free centralized least-squares solution."""
    w = ds.features.reshape(-1, ds.dim)
    y = ds.targets.reshape(-1, 1)
    return torch.linalg.lstsq(w, y).solution[:, 0]
