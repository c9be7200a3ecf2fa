"""Precision fixture for the port's Layer C taint tests.

This dummy READS report-tainted values everywhere (the median report
norm as a clip envelope, the coordinate median as the base value) but
only ever inside bounded ops, so a precise analysis must report it clean:
zero RV301 (the declared ``order_stat`` sanitizer is on every path) and
zero RV303 (the declaration is among the discovered kinds).  The
``norm_filter_gmom`` pattern reduced to its essence: a robust threshold
derived FROM the tainted reports is not a leak.
"""

import torch
from torch.utils._pytree import tree_map

from repro_torch.core import aggregators
from repro_torch.core.geometric_median import batch_mean_norms, median

NAME = "_clean_clip"


@aggregators.register(
    NAME,
    "test-only: coordinate median clamped into a median-norm envelope; "
    "tainted reads only inside bounded ops (taint-precision fixture)",
    needs_shard_spec=True, shard_contract="norm_based",
    sanitization_point="order_stat")
def _clean_clip_aggregator(stacked_grads, *, shard_spec=None, **_kw):
    norms = batch_mean_norms(stacked_grads, shard_spec=shard_spec)
    med = median(norms)   # tainted, but order-statistic bounded
    base = aggregators.coordinate_median_aggregator(stacked_grads)
    return tree_map(lambda g: torch.clamp(g, -med, med).to(g.dtype), base)


def unregister():
    aggregators._REGISTRY.pop(NAME, None)
