"""Plain PyTorch versions of the Weiszfeld kernels (port of
``repro.kernels.geomed.ref``): the CPU path of ``kernels.geomed.geomed``
and the yardstick the chip check holds the CUDA kernels against; and
``weiszfeld_distances_blocked``, the twin of the sqdist kernel's order
(``twin.unit_partials``, which the loop kernel's twin shares)."""

from __future__ import annotations

import math

import torch

from repro_torch import _device
from repro_torch.core.geometric_median import f32_threshold
from repro_torch.kernels.geomed.twin import reduce_partials, unit_partials


def weiszfeld_distances_ref(points, y, *, eps: float = 1e-12):
    """Squared-distance accumulation: ||z_i - y||^2 per point.
    points: (k, d), y: (d,) -> (k,) f32."""
    del eps
    diff = points.to(torch.float32) - y.to(torch.float32)[None, :]
    return torch.sum(diff * diff, dim=-1)


def weiszfeld_distances_blocked(points, y, *, n_blocks: int, vec: int):
    """Plain PyTorch twin of the sqdist kernel on a grid of ``n_blocks``
    with units of ``vec`` columns (4: float4 loads, 1: single columns), bit
    for bit: ``unit_partials`` of z - y, reduced in ``reduce_partials``'
    order.  CPU, float32 -> (k,)."""
    e = points.to(torch.float32).cpu() - y.to(torch.float32).cpu()[None, :]
    return reduce_partials(unit_partials(e, n_blocks, vec))


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


def geometric_median_ref(points, weights, *, max_iters: int = 64,
                         tol: float = 1e-8, eps: float = 1e-12,
                         step=weiszfeld_step_ref):
    """The reference's Weiszfeld loop on the host: init at the weighted
    mean, then ``step`` until the NORM of the move is <= ``tol`` (the
    reference's rule here, unlike the squared move of the round kernels)
    or ``max_iters`` steps; the test reads one scalar back per iteration.
    -> ((d,) f32, iterations as a 0-d int32 tensor)."""
    weights = weights.to(torch.float32)
    w_sum = torch.clamp(torch.sum(weights), min=1e-12)
    y = (weights @ points.to(torch.float32)) / w_sum
    it, delta = 0, float("inf")
    while it < max_iters and delta > f32_threshold(tol):
        y_new = step(points, y, weights, eps=eps)
        delta = _device.host_value(torch.linalg.norm(y_new - y),
                                   traced=math.inf)
        y = y_new
        it += 1
    return y, torch.tensor(it, dtype=torch.int32, device=points.device)
