"""Deliberately leaky dummy aggregator for the port's Layer C taint tests.

It runs the full GMoM pipeline, so the Weiszfeld sanitizer IS on the
dataflow, and then adds a per-worker amax back onto the output: exactly
the "tainted codec scale applied after aggregation" bug class RV301
exists to reject.  Importing this module registers ``_leaky_scale``
(underscore-prefixed: the verify CLI skips it unless named); call
:func:`unregister` in a ``finally`` block.
"""

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import aggregators

NAME = "_leaky_scale"


@aggregators.register(
    NAME,
    "test-only: GMoM then adds a report-derived amax scale AFTER the "
    "Weiszfeld sanitizer (the RV301 bug class)",
    needs_num_byzantine=True, needs_grouping=True, needs_shard_spec=True,
    shard_contract="norm_based", sanitization_point="weiszfeld")
def _leaky_scale_aggregator(stacked_grads, **kw):
    agg = aggregators.gmom_aggregator(stacked_grads, **kw)
    # the leak: an int8-codec-style per-worker amax, derived from the raw
    # reports and mixed into the output after aggregation
    leak = sum(torch.amax(torch.abs(l.to(torch.float32)))
               for l in tree_leaves(stacked_grads))
    return tree_map(lambda g: (g + (1e-6 * leak).to(g.dtype)).to(g.dtype),
                    agg)


def unregister():
    aggregators._REGISTRY.pop(NAME, None)
