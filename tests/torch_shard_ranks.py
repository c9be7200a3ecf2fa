"""Rank bodies of the port's shard-local aggregation tests.

Rank processes (``repro_torch.launch.ranks``) import this module by name,
so it imports torch and the port only, never jax.  A case is a dict:

* ``kind``: ``"sharded"`` (``make_sharded_aggregate``: this rank holds the
  LAST-dim slice of every leaf with param dims, and the whole of a (m,)
  leaf) or ``"shardmap"`` (``make_shardmap_aggregate``: this rank is
  worker ``rank`` and holds its row of every leaf);
* ``cfg``: a ``RobustConfig``; ``stacked``: a tree of float32 numpy
  arrays with a leading worker axis; ``dtype``: the leaves' torch dtype
  name; ``seed``: the PRNG key's seed.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from repro_torch import random as prng
from repro_torch.core import make_sharded_aggregate, make_shardmap_aggregate
from repro_torch.core import shard_aggregation as sa
from repro_torch.kernels.geomed import round as round_kernel


def stacked_tensors(case, device="cpu"):
    """The case's stacked tree as torch tensors (insertion order kept)."""
    dtype = getattr(torch, case["dtype"])
    return tree_map(lambda a: torch.as_tensor(a).to(device=device,
                                                    dtype=dtype),
                    case["stacked"])


def local_part(stacked, rank: int, world: int, kind: str):
    """What rank ``rank`` of ``world`` holds of the whole stacked tree."""
    if kind == "shardmap":
        return tree_map(lambda x: x[rank], stacked)
    return tree_map(lambda x: x if x.ndim == 1
                    else sa.shard_slice(x, rank, world), stacked)


def run_cases(rank: int, world: int, cases: dict, device: str = "cpu"):
    """{case id: (this rank's result tree on the CPU, round-kernel
    launches)} for every case."""
    out = {}
    for cid, case in cases.items():
        local = local_part(stacked_tensors(case, device), rank, world,
                           case["kind"])
        round_kernel.round_aggregate_kernel.launches = 0
        if case["kind"] == "shardmap":
            result = make_shardmap_aggregate(case["cfg"])(local)
        else:
            key = prng.PRNGKey(case["seed"], device=device)
            result = make_sharded_aggregate(case["cfg"])(local, key)
        out[cid] = (tree_map(lambda t: t.cpu(), result),
                    round_kernel.round_aggregate_kernel.launches)
    return out
