"""Robust gradient aggregation rules (PyTorch port of
``repro.core.aggregators``).

Every aggregator maps a *stacked* per-worker gradient pytree (leaves with a
leading worker axis ``m``) to one gradient pytree (no leading axis).  This
slice ports the rules the golden traces use:

* ``gmom``         — geometric median of means, the paper's Algorithm 2
* ``mean``         — the paper's Algorithm 1 baseline
* ``trimmed_mean`` — coordinate-wise trimmed mean [Yin et al. '18]

The registry metadata (``needs_*``, ``shard_contract``,
``sanitization_point``, descriptions) is carried over unchanged; the other
rules follow in ROADMAP Queue 1 item 10.

``gmom`` dispatches its hot path through ``round_backend``:

* ``"reference"``       — batch means -> Remark-2 trim -> pytree Weiszfeld
                          (the path the golden traces were recorded on).
* ``"fused"``           — the CUDA round kernel
                          (``repro_torch.kernels.geomed.round``); CUDA
                          tensors only.
* ``"fused_interpret"`` — the kernel's plain PyTorch version (the fused
                          formulation on the CPU tests).
* ``"auto"`` (default)  — ``fused`` for CUDA tensors with k <= the
                          kernel's limit (64 batches), ``reference``
                          otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core.geometric_median import (
    batch_mean_norms, geometric_median_pytree, trim_weights)
from repro_torch.core.grouping import (Grouping, assignment_matrix,
                                       choose_num_batches, make_grouping)

AggregatorFn = Callable[..., object]   # stacked pytree -> pytree

_REGISTRY: dict[str, "Aggregator"] = {}

SHARD_CONTRACTS = ("coordinate_wise", "norm_based", "whole_gradient")
SANITIZATION_POINTS = ("clip", "order_stat", "rank_select", "sign_vote",
                       "weiszfeld")


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Registry entry: the aggregation fn plus the kwarg-dispatch metadata
    ``robust_train.aggregate_reported`` reads (see ``repro``'s registry
    for each flag's meaning)."""
    name: str
    fn: AggregatorFn
    description: str = ""
    needs_num_byzantine: bool = False
    needs_key: bool = False
    needs_grouping: bool = False
    needs_shard_spec: bool = False
    shard_contract: str = "coordinate_wise"
    native_codec: str | None = None
    sanitization_point: str | None = None

    def __call__(self, stacked_grads, **kw):
        return self.fn(stacked_grads, **kw)


def register(name: str, description: str = "", *,
             needs_num_byzantine: bool = False, needs_key: bool = False,
             needs_grouping: bool = False, needs_shard_spec: bool = False,
             shard_contract: str = "coordinate_wise",
             native_codec: str | None = None,
             sanitization_point: str | None = None):
    if shard_contract not in SHARD_CONTRACTS:
        raise ValueError(
            f"aggregator {name!r} declares unknown shard_contract "
            f"{shard_contract!r}; must be one of {SHARD_CONTRACTS}")
    if sanitization_point is not None and \
            sanitization_point not in SANITIZATION_POINTS:
        raise ValueError(
            f"aggregator {name!r} declares unknown sanitization_point "
            f"{sanitization_point!r}; must be None or one of "
            f"{SANITIZATION_POINTS}")

    def deco(fn):
        _REGISTRY[name] = Aggregator(
            name=name, fn=fn, description=description,
            needs_num_byzantine=needs_num_byzantine, needs_key=needs_key,
            needs_grouping=needs_grouping, needs_shard_spec=needs_shard_spec,
            shard_contract=shard_contract, native_codec=native_codec,
            sanitization_point=sanitization_point)
        return fn
    return deco


def get_aggregator(name: str) -> Aggregator:
    if name not in _REGISTRY:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(_REGISTRY)}"
                       " (the others are ROADMAP Queue 1 item 10)")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def describe() -> list[tuple[str, str]]:
    """(name, description) rows for every registered aggregator, sorted."""
    return [(n, _REGISTRY[n].description) for n in available()]


# ---------------------------------------------------------------------------
# helpers

def _num_workers(stacked) -> int:
    return tree_leaves(stacked)[0].shape[0]


def bottom_k_mask(scores, k):
    """{0,1} float mask selecting exactly the k smallest-score entries;
    stable argsort ranks break ties by index.  ``k`` may be an int or a
    0-d tensor."""
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    return (rank < k).to(torch.float32)


def _apply_grouping(stacked, grouping: Grouping):
    """Worker axis m -> k batch means, accumulated in f32 and cast back.

    Identity grouping (k = m, contiguous) returns the reports; an uneven
    grouping contracts with the (k, m) membership matrix; an even one
    orders workers by slot, reshapes to (k, b) and means over b."""
    k = grouping.num_batches
    if k == grouping.num_workers and \
            grouping.perm == tuple(range(grouping.num_workers)):
        return stacked
    if not grouping.is_even:
        def leaf_uneven(g):
            s = torch.as_tensor(assignment_matrix(grouping), device=g.device)
            sizes = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                                 device=g.device)
            sums = torch.einsum("km,m...->k...", s, g.to(torch.float32))
            means = sums / sizes.reshape((k,) + (1,) * (g.ndim - 1))
            return means.to(g.dtype)
        return tree_map(leaf_uneven, stacked)

    order = np.argsort(np.asarray(grouping.perm))
    b = grouping.batch_size

    def leaf(g):
        idx = torch.as_tensor(order, device=g.device)
        g = g.index_select(0, idx).reshape((k, b) + tuple(g.shape[1:]))
        return torch.mean(g.to(torch.float32), dim=1).to(g.dtype)

    return tree_map(leaf, stacked)


def batch_means(stacked_grads, num_batches: int, *,
                scheme: str = "contiguous"):
    """Public helper: stacked (m, ...) pytree -> (k, ...) pytree of means."""
    m = _num_workers(stacked_grads)
    return _apply_grouping(stacked_grads,
                           make_grouping(m, num_batches, scheme=scheme))


# ---------------------------------------------------------------------------
# aggregators

@register("mean", "plain average — the paper's Algorithm 1 (classical BGD), "
          "breakdown point 0: one Byzantine worker moves it arbitrarily",
          shard_contract="coordinate_wise")
def mean_aggregator(stacked_grads, **_kw):
    """Paper Algorithm 1: simple averaging."""
    return tree_map(
        lambda g: torch.mean(g.to(torch.float32), dim=0).to(g.dtype),
        stacked_grads)


def resolve_round_backend(round_backend: str | None, *, num_batches: int,
                          device: torch.device) -> str:
    """Map the ``round_backend`` switch to a concrete path.

    ``auto``/None picks the CUDA round kernel for CUDA tensors when k fits
    the kernel (<= ``round.MAX_BATCHES``) and ``reference`` otherwise.
    ``fused`` is the kernel and raises for CPU tensors or too many batches
    (no silent fallback); ``fused_interpret`` is the kernel's plain
    PyTorch version on any device."""
    from repro_torch.kernels.geomed import round as round_kernel
    if round_backend not in (None, "auto", "reference", "fused",
                             "fused_interpret"):
        raise ValueError(f"unknown round_backend {round_backend!r}")
    device = torch.device(device)
    fits = num_batches <= round_kernel.MAX_BATCHES
    if round_backend in (None, "auto"):
        return "fused" if device.type == "cuda" and fits else "reference"
    if round_backend == "fused":
        if device.type != "cuda":
            raise ValueError(
                "round_backend='fused' is the CUDA round kernel, but the "
                f"gradients are on {device}; use 'fused_interpret' for the "
                "kernel's plain version")
        if not fits:
            raise ValueError(
                f"round_backend='fused' takes at most "
                f"{round_kernel.MAX_BATCHES} batches, got {num_batches}")
    return round_backend


@register("gmom", "geometric median of means — the paper's Algorithm 2 "
          "(fused Pallas round kernel on TPU, jnp reference elsewhere)",
          needs_num_byzantine=True, needs_grouping=True,
          needs_shard_spec=True, shard_contract="norm_based",
          sanitization_point="weiszfeld")
def gmom_aggregator(stacked_grads, *, num_batches: int | None = None,
                    num_byzantine: int = 0, epsilon: float = 0.1,
                    grouping_scheme: str = "contiguous",
                    trim_multiplier: float | None = 3.0,
                    max_iters: int = 64, tol: float = 1e-8,
                    round_backend: str | None = "auto",
                    shard_spec=None, **_kw):
    """Paper Algorithm 2 step 4: A_k(g) = med{batch means}, with the
    Remark-2 norm trimming applied as zero Weiszfeld weights.  (The
    registry description is the reference's, unchanged; in the port the
    fused path is the CUDA round kernel.)"""
    if shard_spec is not None:
        raise NotImplementedError(
            "shard-local aggregation is ROADMAP Queue 1 item 13")
    m = _num_workers(stacked_grads)
    if num_batches is None:
        num_batches = choose_num_batches(m, num_byzantine, epsilon=epsilon)
    if num_batches == 1:    # GMoM reduces to the mean (paper §2.1)
        return mean_aggregator(stacked_grads)
    backend = resolve_round_backend(
        round_backend, num_batches=num_batches,
        device=tree_leaves(stacked_grads)[0].device)
    if backend != "reference":
        from repro_torch.kernels.geomed import round as round_kernel
        grouping = make_grouping(m, num_batches, scheme=grouping_scheme)
        return round_kernel.round_aggregate_pytree(
            stacked_grads, grouping, trim_multiplier=trim_multiplier,
            max_iters=max_iters, tol=tol,
            plain=(backend == "fused_interpret"))
    means = batch_means(stacked_grads, num_batches, scheme=grouping_scheme)
    weights = None
    if trim_multiplier is not None:
        weights = trim_weights(batch_mean_norms(means),
                               multiplier=trim_multiplier)
    return geometric_median_pytree(means, weights=weights,
                                   max_iters=max_iters, tol=tol)


@register("trimmed_mean", "coordinate-wise beta-trimmed mean "
          "[Yin et al. '18] — related-work baseline",
          needs_num_byzantine=True, shard_contract="coordinate_wise",
          sanitization_point="order_stat")
def trimmed_mean_aggregator(stacked_grads, *, trim_fraction: float = 0.1,
                            num_byzantine: int | None = None, **_kw):
    """Coordinate-wise mean after discarding the t largest and t smallest
    entries per coordinate (t = num_byzantine, else trim_fraction x m)."""
    m = _num_workers(stacked_grads)
    t = num_byzantine if num_byzantine is not None else int(trim_fraction * m)
    t = min(t, (m - 1) // 2)

    def leaf(g):
        s = torch.sort(g, dim=0).values
        if t > 0:
            s = s[t:m - t]
        return torch.mean(s.to(torch.float32), dim=0).to(g.dtype)

    return tree_map(leaf, stacked_grads)
