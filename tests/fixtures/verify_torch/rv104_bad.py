"""Fixture: register calls with missing/invalid metadata (RV104 x3)."""
from repro_torch.core import aggregators


@aggregators.register("no_metadata")
def no_metadata(stacked, **_kw):            # missing description AND contract
    return stacked


@aggregators.register("bad_contract", "has a description",
                      shard_contract="shardwise")   # not a valid contract
def bad_contract(stacked, **_kw):
    return stacked
