"""Robust gradient aggregation rules (PyTorch port of
``repro.core.aggregators``).

Every aggregator maps a *stacked* per-worker gradient pytree (leaves with a
leading worker axis ``m``) to one gradient pytree (no leading axis).  All
fifteen of the reference's rules are registered under its names, with its
registry metadata (``needs_*``, ``shard_contract``, ``native_codec``,
``sanitization_point``, descriptions) unchanged:

* ``gmom`` (the paper's Algorithm 2), ``mean`` (Algorithm 1), ``geomed``
  (k = m), ``gmom_per_leaf`` (one median per tensor);
* the related-work baselines ``trimmed_mean``, ``coordinate_median``,
  ``krum`` (the gram form) and ``norm_clip_mean``;
* the paper's §6 selection rules ``random_select`` and ``norm_select``,
  and the sound combined rules ``coord_median``, ``coord_trimmed_mean``
  and ``norm_filter_gmom``;
* the compressed-wire rules ``sign_sgd_majority`` (votes on the packed
  ``sign`` wire) and ``int8_gmom`` (dequantize, then gmom).

Every rule honours the shard-local contract
(``repro_torch.core.shard_aggregation``): coordinate-wise rules touch each
parameter shard on its own, and the norm-based rules take a ``shard_spec``
whose blocked reductions combine per-shard partial squared norms (one
(k,)-sized reduction a Weiszfeld iterate for GMoM, one (m, m) partial gram
for krum).

``gmom`` (and ``norm_filter_gmom`` and ``int8_gmom``, which end in it)
dispatches its hot path through ``round_backend``:

* ``"reference"``       — batch means -> Remark-2 trim -> pytree Weiszfeld
                          (the path the golden traces were recorded on).
* ``"fused"``           — the CUDA round kernel
                          (``repro_torch.kernels.geomed.round``); CUDA
                          tensors only.
* ``"fused_interpret"`` — the kernel's plain PyTorch version (the fused
                          formulation on the CPU tests).
* ``"auto"`` (default)  — ``fused`` for CUDA tensors (or a
                          ``ShardSpec.target_backend`` of ``"cuda"``) with
                          k <= the kernel's limit (64 batches) and
                          unpartitioned gradients, ``reference`` otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

from repro_torch import _device
from repro_torch import random as prng
from repro_torch.core import shard_aggregation as sa
from repro_torch.core.geometric_median import (
    batch_mean_norms, geometric_median, geometric_median_pytree, median,
    trim_weights)
from repro_torch.core.grouping import (Grouping, assignment_matrix,
                                       choose_num_batches, make_grouping,
                                       worker_batch_ids)

# repro_torch: robust-stat — reductions feeding the robust statistics below
# accumulate in float32 before casting back (repro_torch.verify RV105).

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
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(_REGISTRY)}")
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


def _bcast(v, g):
    """A (m,) per-worker vector shaped to broadcast against leaf (m, ...)."""
    return v.reshape((-1,) + (1,) * (g.ndim - 1))


def _masked_mean(stacked_grads, sel, count: int):
    """sum_j sel_j g_j / count in float32, cast back."""
    def leaf(g):
        acc = torch.sum(g.to(torch.float32) * _bcast(sel, g), dim=0)
        return (acc / count).to(g.dtype)
    return tree_map(leaf, stacked_grads)


def _resolve_k(stacked_grads, num_batches, num_byzantine, epsilon) -> int:
    if num_batches is not None:
        return num_batches
    return choose_num_batches(_num_workers(stacked_grads), num_byzantine,
                              epsilon=epsilon)


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
                          device: torch.device | str,
                          partitioned: bool = False,
                          target_backend: str | None = None) -> str:
    """Map the ``round_backend`` switch to a concrete path.

    ``auto``/None picks the CUDA round kernel when the gradients take the
    CUDA path (``device``: ``_device.device_type`` of a leaf, so that a
    fake trace under ``route_as`` resolves as the card would;
    ``target_backend``, where given, names the device type in place of
    ``device``'s), k fits the kernel (<= ``round.MAX_BATCHES``)
    and the gradients are not ``partitioned`` over param shards, and
    ``reference`` otherwise: the kernel concatenates every leaf into one
    (m, d) block, which on partitioned slices would be the gather the
    shard-local contract avoids.  ``fused`` is the kernel and raises for
    CPU tensors, too many batches or partitioned gradients;
    ``fused_interpret`` (the kernel's plain PyTorch version, any device)
    raises for partitioned gradients too.  The reference only warns on an
    explicit kernel backend with partitioned gradients and runs
    ``reference``; the port, as for CPU tensors, never falls back
    silently."""
    from repro_torch.kernels.geomed import round as round_kernel
    if round_backend not in (None, "auto", "reference", "fused",
                             "fused_interpret"):
        raise ValueError(f"unknown round_backend {round_backend!r}")
    device = torch.device(device)
    fits = num_batches <= round_kernel.MAX_BATCHES
    if round_backend in (None, "auto"):
        on_cuda = (target_backend or device.type) == "cuda"
        return ("fused" if on_cuda and fits and not partitioned
                else "reference")
    if round_backend != "reference" and partitioned:
        raise ValueError(
            f"round_backend={round_backend!r} concatenates every leaf into "
            "one block, but the gradients are partitioned over param "
            "shards; use 'reference' or 'auto'")
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
    fused path is the CUDA round kernel.)  A partitioned ``shard_spec``
    takes the ``reference`` path with blocked norm and distance
    reductions: one (k,) reduction a Weiszfeld iterate crosses shards."""
    m = _num_workers(stacked_grads)
    if num_batches is None:
        num_batches = choose_num_batches(m, num_byzantine, epsilon=epsilon)
    if num_batches == 1:    # GMoM reduces to the mean (paper §2.1)
        return mean_aggregator(stacked_grads)
    backend = resolve_round_backend(
        round_backend, num_batches=num_batches,
        device=_device.device_type(tree_leaves(stacked_grads)[0]),
        partitioned=sa.is_partitioned(shard_spec),
        target_backend=sa.target_backend_of(shard_spec))
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
        norms = batch_mean_norms(means, shard_spec=shard_spec)
        weights = trim_weights(norms, multiplier=trim_multiplier)
    return geometric_median_pytree(means, weights=weights,
                                   max_iters=max_iters, tol=tol,
                                   shard_spec=shard_spec)


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


@register("geomed", "geometric median of the raw worker gradients — the "
          "k = m special case of GMoM (paper §2.1)",
          needs_shard_spec=True, shard_contract="norm_based",
          sanitization_point="weiszfeld")
def geomed_aggregator(stacked_grads, *, max_iters: int = 64,
                      tol: float = 1e-8, shard_spec=None, **_kw):
    """GMoM with every worker its own batch (k = m, paper §2.1)."""
    return geometric_median_pytree(stacked_grads, max_iters=max_iters,
                                   tol=tol, shard_spec=shard_spec)


@register("coordinate_median", "coordinate-wise median — the marginal-"
          "median baseline of Yin et al. '18",
          shard_contract="coordinate_wise",
          sanitization_point="order_stat")
def coordinate_median_aggregator(stacked_grads, **_kw):
    """Per-coordinate median across workers (``jnp.median``'s even-length
    mean of the two middle values)."""
    return tree_map(median, stacked_grads)


@register("krum", "Krum selection rule [BMGS17] — the paper's closest "
          "related work; picks one whole gradient via the shard-local "
          "‖a‖²+‖b‖²−2a·b gram expansion (no flattened f32 copies)",
          needs_num_byzantine=True, needs_shard_spec=True,
          shard_contract="whole_gradient",
          sanitization_point="rank_select")
def krum_aggregator(stacked_grads, *, num_byzantine: int = 0,
                    shard_spec=None, **_kw):
    """Krum (Blanchard et al. '17): the worker gradient with the smallest
    sum of squared distances to its m - q - 2 nearest neighbours, from one
    (m, m) gram matrix accumulated leaf by leaf in float32 (per-shard
    partial grams under a blocked ``shard_spec``).  Raises unless
    m > q + 2."""
    m = _num_workers(stacked_grads)
    closest = m - num_byzantine - 2
    if closest < 1:
        raise ValueError(
            f"krum needs m > q + 2 workers (got m={m}, q={num_byzantine}): "
            "the m - q - 2 nearest-neighbour score is degenerate and the "
            "selection guarantee [BMGS17] is void")

    def leaf_gram(g):
        flat = g.reshape(m, -1).to(torch.float32)
        return flat @ flat.T

    gram = sa.blocked_partial_sum(shard_spec, tree_leaves(stacked_grads),
                                  leaf_gram, shape=(m, m), lead_axes=1)
    sq = torch.diagonal(gram)
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2 = d2 + torch.diag(torch.full((m,), torch.inf, dtype=torch.float32,
                                    device=gram.device))
    scores = torch.sum(torch.sort(d2, dim=1).values[:, :closest], dim=1)
    # the winner's row, gathered on the device: a 0-d tensor index would
    # read its value on the host (and a fake trace has none)
    winner = torch.argmin(scores).reshape(1)
    return tree_map(lambda g: torch.index_select(g, 0, winner)[0],
                    stacked_grads)


@register("norm_clip_mean",
          "mean of gradients clipped to the median norm — KNOWN-UNSOUND "
          "vs small-norm attacks (alie, norm_stealth, inner_product)",
          needs_shard_spec=True, shard_contract="norm_based")
def norm_clip_mean_aggregator(stacked_grads, *, clip_multiplier: float = 1.0,
                              shard_spec=None, **_kw):
    """Mean of gradients clipped to ``clip_multiplier x median`` norm.
    Known-unsound: a coordinated small-norm report passes unclipped."""
    norms = batch_mean_norms(stacked_grads, shard_spec=shard_spec)  # (m,)
    tau = clip_multiplier * median(norms)
    scale = torch.clamp(tau / torch.clamp(norms, min=1e-12), max=1.0)

    def leaf(g):
        return torch.mean(g.to(torch.float32) * _bcast(scale, g),
                          dim=0).to(g.dtype)

    return tree_map(leaf, stacked_grads)


@register("random_select",
          "paper §6 rule 1: average a random subset of the gradients "
          "(defends only the RELAXED adversary that cannot see the "
          "server's random bits — fails vs the paper's omniscient model)",
          needs_key=True, shard_contract="coordinate_wise")
def random_select_aggregator(stacked_grads, *, key=None,
                             subset_fraction: float = 0.5, **_kw):
    """Average a uniformly random subset (paper §6, rule 1); ``key`` is
    required, or the subset would be the same every round."""
    m = _num_workers(stacked_grads)
    n_sel = max(int(subset_fraction * m), 1)
    if key is None:
        raise ValueError(
            "random_select requires a PRNG key: without one the subset is "
            "identical every round (the aggregate_reported registry "
            "dispatch threads a fresh per-round key automatically)")
    sel = bottom_k_mask(prng.uniform(key, (m,)), n_sel)
    return _masked_mean(stacked_grads, sel, n_sel)


@register("norm_select",
          "paper §6 rule 2: average the gradients with the smallest l2 "
          "norms — KNOWN-UNSOUND vs small-norm attacks (alie, "
          "norm_stealth); see benchmarks/selection_rules",
          needs_num_byzantine=True, needs_shard_spec=True,
          shard_contract="norm_based")
def norm_select_aggregator(stacked_grads, *, num_byzantine: int = 0,
                           shard_spec=None, **_kw):
    """Average the ``m - q`` smallest-norm gradients (paper §6, rule 2).
    Known-unsound: a norm-minimizing adversary is selected first."""
    m = _num_workers(stacked_grads)
    keep = max(m - max(num_byzantine, 1), 1)
    sel = bottom_k_mask(batch_mean_norms(stacked_grads,
                                         shard_spec=shard_spec), keep)
    return _masked_mean(stacked_grads, sel, keep)


# ---------------------------------------------------------------------------
# the sound combined selection rules: per-coordinate order statistics over
# the k batch means [Yin et al. '18], and a two-sided norm envelope filter
# before GMoM [Su & Xu '18]

@register("coord_median",
          "coordinate-wise median of the k batch means [Yin et al. '18] — "
          "sound combined rule: per-coordinate order statistics are immune "
          "to the small-norm attacks that break norm_select",
          needs_num_byzantine=True, needs_grouping=True,
          shard_contract="coordinate_wise",
          sanitization_point="order_stat")
def coord_median_aggregator(stacked_grads, *, num_batches: int | None = None,
                            num_byzantine: int = 0, epsilon: float = 0.1,
                            grouping_scheme: str = "contiguous", **_kw):
    """Coordinate-wise median over the k batch means; raises unless
    2q < k (the median's breakdown point)."""
    num_batches = _resolve_k(stacked_grads, num_batches, num_byzantine,
                             epsilon)
    if 2 * num_byzantine >= num_batches:
        raise ValueError(
            f"coord_median needs 2q < k batches (got q={num_byzantine}, "
            f"k={num_batches}): the per-coordinate median's breakdown point "
            "is crossed and the Yin et al. '18 guarantee is void — "
            "increase num_batches or lower q")
    means = batch_means(stacked_grads, num_batches, scheme=grouping_scheme)
    return tree_map(median, means)


@register("coord_trimmed_mean",
          "coordinate-wise q-trimmed mean of the k batch means "
          "[Yin et al. '18] — sound combined rule; trims the q largest AND "
          "q smallest per coordinate, unlike norm_select's one-sided cut",
          needs_num_byzantine=True, needs_grouping=True,
          shard_contract="coordinate_wise",
          sanitization_point="order_stat")
def coord_trimmed_mean_aggregator(stacked_grads, *,
                                  num_batches: int | None = None,
                                  num_byzantine: int = 0,
                                  epsilon: float = 0.1,
                                  grouping_scheme: str = "contiguous",
                                  trim_count: int | None = None, **_kw):
    """Coordinate-wise trimmed mean over the k batch means, trimming
    t = ``trim_count`` (default q) from each end; raises unless
    0 <= 2t < k."""
    k = _resolve_k(stacked_grads, num_batches, num_byzantine, epsilon)
    t = num_byzantine if trim_count is None else trim_count
    if t < 0 or 2 * t >= k:
        raise ValueError(
            f"coord_trimmed_mean needs 0 <= 2·trim_count < k batches (got "
            f"trim_count={t}, k={k}): trimming cannot cover q Byzantine "
            "batch means and the Yin et al. '18 guarantee is void — "
            "increase num_batches or lower q")
    means = batch_means(stacked_grads, k, scheme=grouping_scheme)

    def leaf(z):
        s = torch.sort(z, dim=0).values
        if t > 0:
            s = s[t:k - t]
        return torch.mean(s.to(torch.float32), dim=0).to(z.dtype)

    return tree_map(leaf, means)


@register("norm_filter_gmom",
          "paper §6 combined rule [Su & Xu '18]: two-sided norm-envelope "
          "filter (drop reports whose norm sits outside median ± c·MAD — "
          "the huge AND the adversarially-small outliers), then GMoM on "
          "the surviving reports",
          needs_num_byzantine=True, needs_grouping=True,
          needs_shard_spec=True, shard_contract="norm_based",
          sanitization_point="weiszfeld")
def norm_filter_gmom_aggregator(stacked_grads, *,
                                num_batches: int | None = None,
                                num_byzantine: int = 0, epsilon: float = 0.1,
                                envelope_multiplier: float = 4.0,
                                grouping_scheme: str = "contiguous",
                                trim_multiplier: float | None = 3.0,
                                max_iters: int = 64, tol: float = 1e-8,
                                round_backend: str | None = "auto",
                                shard_spec=None, **_kw):
    """Two-sided norm filter, then GMoM on the survivors.

    A report survives iff its norm lies within ``envelope_multiplier x
    MAD`` (plus a small relative slack) of the median norm.  Each batch
    mean is re-averaged over its surviving members (a batch with none left
    keeps its unfiltered mean) by rescaling rows, and
    :func:`gmom_aggregator` runs on them with its ``round_backend``
    dispatch, so on the card this rule ends in the round kernel."""
    m = _num_workers(stacked_grads)
    k = _resolve_k(stacked_grads, num_batches, num_byzantine, epsilon)
    norms = batch_mean_norms(stacked_grads, shard_spec=shard_spec)  # (m,)
    med = median(norms)
    mad = median(torch.abs(norms - med))
    tau = envelope_multiplier * mad + 1e-3 * med + 1e-12
    keep = (torch.abs(norms - med) <= tau).to(torch.float32)     # (m,)

    grouping = make_grouping(m, k, scheme=grouping_scheme)
    dev = norms.device
    batch_id = torch.as_tensor(worker_batch_ids(grouping), device=dev)
    sizes = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                         device=dev)                              # (k,)
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=dev).index_add_(0, batch_id, keep)
    # a batch with every member filtered falls back to its unfiltered mean
    keep_eff = torch.where(counts[batch_id] > 0, keep, 1.0)
    counts_eff = torch.where(counts > 0, counts, sizes)
    # rows rescaled so the unweighted batch mean is the survivors' mean
    rescale = keep_eff * sizes[batch_id] / counts_eff[batch_id]   # (m,)
    filtered = tree_map(lambda g: g * _bcast(rescale.to(g.dtype), g),
                        stacked_grads)
    return gmom_aggregator(filtered, num_batches=k,
                           num_byzantine=num_byzantine, epsilon=epsilon,
                           grouping_scheme=grouping_scheme,
                           trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol,
                           round_backend=round_backend,
                           shard_spec=shard_spec)


@register("gmom_per_leaf",
          "GMoM applied independently per parameter tensor — beyond-paper "
          "blockwise variant (DESIGN.md §3)",
          needs_num_byzantine=True, needs_grouping=True,
          needs_shard_spec=True, shard_contract="norm_based",
          sanitization_point="weiszfeld")
def gmom_per_leaf_aggregator(stacked_grads, *, num_batches: int | None = None,
                             num_byzantine: int = 0, epsilon: float = 0.1,
                             grouping_scheme: str = "contiguous",
                             max_iters: int = 64, tol: float = 1e-8,
                             shard_spec=None, **_kw):
    """Blockwise GMoM: one geometric median per parameter tensor; under a
    blocked ``shard_spec`` each leaf's median runs through the pytree
    Weiszfeld with blocked reductions (no ``reshape(k, -1)``, whose flatten
    would mix the shards)."""
    num_batches = _resolve_k(stacked_grads, num_batches, num_byzantine,
                             epsilon)
    if num_batches == 1:
        return mean_aggregator(stacked_grads)
    means = batch_means(stacked_grads, num_batches, scheme=grouping_scheme)

    if shard_spec is not None and shard_spec.blocked:
        leaves, tspec = tree_flatten(means)
        return tree_unflatten(
            [geometric_median_pytree(
                {"x": z}, max_iters=max_iters, tol=tol,
                shard_spec=sa.leaf_spec(shard_spec, i))["x"]
             for i, z in enumerate(leaves)], tspec)

    def leaf(z):
        flat = z.reshape(z.shape[0], -1).to(torch.float32)
        med = geometric_median(flat, max_iters=max_iters, tol=tol)
        return med.to(z.dtype).reshape(z.shape[1:])

    return tree_map(leaf, means)


# ---------------------------------------------------------------------------
# communication-compressed rules (repro_torch.core.compression): when
# RobustConfig.compression matches the registered ``native_codec``,
# aggregate_reported hands them the payload and a ``like=`` template; with
# compression="none" they take raw stacked gradients

@register("sign_sgd_majority",
          "coordinate-wise majority vote over 1-bit sign gradients "
          "[Jin et al. '19] — consumes the packed `sign` wire natively "
          "(votes on uint8 words, never reconstructs float gradients); "
          "shard-local with zero cross-shard collectives",
          shard_contract="coordinate_wise", native_codec="sign",
          sanitization_point="sign_vote")
def sign_sgd_majority_aggregator(stacked_grads, *, like=None, **_kw):
    """signSGD with majority vote (Jin et al. '19): per coordinate -1 if a
    strict majority of the m sign bits are negative, else +1.  The raw and
    the packed vote count the same exact integers."""
    from repro_torch.core import compression
    if like is not None:
        return compression.majority_vote_packed(stacked_grads, like)
    return compression.majority_vote_signs(stacked_grads)


@register("int8_gmom",
          "GMoM on 8-bit stochastically-quantized reports: dequantizes the "
          "`int8_stochastic` wire (per-worker scales) then runs the full "
          "gmom pipeline incl. round_backend dispatch — 4× wire cut with "
          "the paper's Algorithm 2 guarantees on the dequantized reports",
          needs_num_byzantine=True, needs_grouping=True,
          needs_shard_spec=True, shard_contract="norm_based",
          native_codec="int8_stochastic",
          sanitization_point="weiszfeld")
def int8_gmom_aggregator(stacked_grads, *, like=None,
                         num_batches: int | None = None,
                         num_byzantine: int = 0, epsilon: float = 0.1,
                         grouping_scheme: str = "contiguous",
                         trim_multiplier: float | None = 3.0,
                         max_iters: int = 64, tol: float = 1e-8,
                         round_backend: str | None = "auto",
                         shard_spec=None, **_kw):
    """Dequantize-then-GMoM: the int8 payload is expanded back to
    ``like``'s dtype, then :func:`gmom_aggregator` runs (the round kernel
    on the card).  With ``like=None`` the reports are floats and this is
    gmom."""
    if like is not None:
        from repro_torch.core import compression
        stacked_grads = compression.get_codec("int8_stochastic").decode(
            stacked_grads, like)
    return gmom_aggregator(stacked_grads, num_batches=num_batches,
                           num_byzantine=num_byzantine, epsilon=epsilon,
                           grouping_scheme=grouping_scheme,
                           trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol,
                           round_backend=round_backend,
                           shard_spec=shard_spec)
