"""Plain PyTorch versions of the Weiszfeld-step kernels (port of
``repro.kernels.geomed.ref``): the CPU path of ``kernels.geomed.geomed``
and the yardstick the chip check holds the CUDA kernels against."""

from __future__ import annotations

import torch


def weiszfeld_distances_ref(points, y, *, eps: float = 1e-12):
    """Squared-distance accumulation: ||z_i - y||^2 per point.
    points: (k, d), y: (d,) -> (k,) f32."""
    del eps
    diff = points.to(torch.float32) - y.to(torch.float32)[None, :]
    return torch.sum(diff * diff, dim=-1)


def weiszfeld_reweight_ref(points, inv_weights):
    """Weighted sum: sum_i w_i z_i.  points: (k, d), inv_weights: (k,)
    -> (d,) f32 (normalization happens outside, it is O(k))."""
    return torch.einsum("k,kd->d", inv_weights.to(torch.float32),
                        points.to(torch.float32))


def weiszfeld_step_ref(points, y, weights, *, eps: float = 1e-12):
    """One full Weiszfeld step.  points: (k, d), y: (d,), weights: (k,)
    -> (d,)."""
    sq = weiszfeld_distances_ref(points, y)
    dist = torch.sqrt(sq + eps * eps)
    inv = weights.to(torch.float32) / dist
    denom = torch.clamp(torch.sum(inv), min=eps)
    return weiszfeld_reweight_ref(points, inv) / denom
