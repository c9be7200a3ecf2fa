"""Fixture: fully declared register call (clean)."""
from repro_torch.core import aggregators


@aggregators.register("declared", "coordinate-wise mean with metadata",
                      shard_contract="coordinate_wise")
def declared(stacked, **_kw):
    return stacked
