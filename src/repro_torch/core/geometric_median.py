"""Geometric median of points in R^d — the heart of the paper's aggregator.

The geometric median of ``{z_1..z_n}`` is ``argmin_y sum_i ||y - z_i||_2``
(paper eq. (6)), approximated by the classical Weiszfeld fixed-point
iteration initialised at the weighted mean.  Per-point weights let
norm-trimmed points (paper Remark 2) take part with weight zero.

Port of ``repro.core.geometric_median``.  The loops are Python loops
whose stopping test reads one scalar back from the device per iteration;
the CUDA round kernel (``kernels.geomed.round``) is the path that keeps
the loop on the device.  Under a dry trace (fake tensors) the read has no
value and a loop runs to its cap (``_device.host_value``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch import _device
from repro_torch.core.shard_aggregation import blocked_partial_sum


# repro_torch: bit-stable — the pytree Weiszfeld is part of the shard-local
# bit-equality contract (tests/test_torch_shard_aggregation.py): reductions
# over the stacked k/member axis stay unrolled multiply-add chains (_wsum)
# or go through blocked_partial_sum (repro_torch.verify RV101/RV105).


def f32_threshold(x: float) -> float:
    """A Python-float threshold as the reference compares it: rounded to
    float32 (a weakly typed constant against a float32 value)."""
    return float(np.float32(x))


def sum_trailing(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading one; (k,) stays (k,)."""
    return torch.sum(x.reshape(x.shape[0], -1), dim=1)


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the median over the leading axis, the
    mean of the two middle order statistics for even length
    (``torch.median`` returns the lower one), NaN where any entry is NaN.
    A 1-D tensor gives a 0-d one."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=0), torch.nan, mid)


def _pairwise_dists(points, y, eps: float):
    """||z_i - y||, smoothed by ``eps`` so the weights stay finite."""
    diff = points - y[None, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + eps * eps)


def weiszfeld_step(points, y, weights, eps: float):
    """One Weiszfeld update: y <- sum_i (w_i/d_i) z_i / sum_i (w_i/d_i)."""
    d = _pairwise_dists(points, y, eps)
    inv = weights / d
    denom = torch.sum(inv)
    return (inv @ points) / torch.clamp(denom, min=eps)


def geometric_median(points, *, weights=None, max_iters: int = 64,
                     tol: float = 1e-8, eps: float = 1e-12):
    """(1+gamma)-approximate geometric median of ``points`` (n, d).

    Stops when the NORM of the move is <= ``tol`` (the squared-move rule
    belongs to ``geometric_median_pytree``) or after ``max_iters`` steps."""
    n = points.shape[0]
    if weights is None:
        weights = torch.ones((n,), dtype=points.dtype, device=points.device)
    weights = weights.to(points.dtype)
    w_sum = torch.clamp(torch.sum(weights), min=eps)
    y = (weights @ points) / w_sum
    step = 0
    delta = float("inf")
    while step < max_iters and delta > f32_threshold(tol):
        y_new = weiszfeld_step(points, y, weights, eps)
        delta = _device.host_value(torch.linalg.norm(y_new - y),
                                   traced=math.inf)
        y = y_new
        step += 1
    return y


def _wsum(w, leaf):
    """Weighted sum over the leading k axis as an unrolled multiply-add
    chain, the reference's fixed expression tree."""
    wf = w.to(leaf.dtype)
    acc = wf[0] * leaf[0]
    for i in range(1, leaf.shape[0]):
        acc = acc + wf[i] * leaf[i]
    return acc


def geometric_median_pytree(batch_means, *, weights=None,
                            max_iters: int = 64, tol: float = 1e-8,
                            eps: float = 1e-12, shard_spec=None):
    """Geometric median of k stacked pytrees (leaves with leading axis k),
    taken in the concatenation of all leaves as one R^d vector.

    ``shard_spec`` (a :class:`repro_torch.core.shard_aggregation.ShardSpec`)
    selects the shard-local contract: the iterate and every weighted sum
    stay per shard (the unrolled ``_wsum`` is coordinate-local), and only
    the (k,) squared distances and the scalar move cross shards, one
    blocked reduction each per iterate.

    Stops when the SQUARED move is <= tol^2 or after ``max_iters`` steps.
    Returns a pytree of the same structure without the leading axis."""
    leaves, spec = tree_flatten(batch_means)
    k = leaves[0].shape[0]
    dev = leaves[0].device
    if weights is None:
        weights = torch.ones((k,), dtype=torch.float32, device=dev)
    weights = weights.to(torch.float32)
    w_sum = torch.clamp(torch.sum(weights), min=eps)

    def pair_sq(leaf, yl):
        diff = (leaf - yl[None]).to(torch.float32)
        return sum_trailing(diff * diff)

    def sq_dists(y):
        return blocked_partial_sum(shard_spec, list(zip(leaves, y)), pair_sq,
                                   shape=(k,), lead_axes=1)

    def pair_delta(x, z):
        return torch.sum((x - z).to(torch.float32) ** 2)

    def flat_delta(a, b):
        return blocked_partial_sum(shard_spec, list(zip(a, b)), pair_delta,
                                   shape=(), lead_axes=0)

    y = [_wsum(weights, leaf) / w_sum.to(leaf.dtype) for leaf in leaves]
    it = 0
    delta = float("inf")
    while it < max_iters and delta > f32_threshold(tol * tol):
        d = torch.sqrt(sq_dists(y) + eps * eps)
        inv = weights / d
        denom = torch.clamp(torch.sum(inv), min=eps)
        y_new = [_wsum(inv / denom, leaf) for leaf in leaves]
        delta = _device.host_value(flat_delta(y_new, y), traced=math.inf)
        y = y_new
        it += 1
    return tree_unflatten(y, spec)


def trim_weights(norms, *, multiplier: float = 3.0, eps: float = 1e-12):
    """Norm-trimming weights (paper Remark 2, self-tuning threshold):
    tau = multiplier x median(norms); {0,1} weights, never all zero."""
    tau = multiplier * median(norms) + eps
    w = (norms <= tau).to(norms.dtype)
    return torch.where(torch.sum(w) > 0, w, torch.ones_like(w))


def batch_mean_norms(batch_means, *, shard_spec=None) -> torch.Tensor:
    """Global L2 norm of each of the k stacked pytree batch means; with a
    blocked ``shard_spec`` the squared norms are per-shard partials
    combined by one ordered (k,)-sized reduction."""
    leaves = tree_leaves(batch_means)
    k = leaves[0].shape[0]

    def leaf_sq(leaf):
        lf = leaf.to(torch.float32)
        return sum_trailing(lf * lf)

    return torch.sqrt(blocked_partial_sum(shard_spec, leaves, leaf_sq,
                                          shape=(k,), lead_axes=1))
