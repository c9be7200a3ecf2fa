"""Fixture: suppression without justification: RV102 is dropped but the
RV100 meta-finding keeps the build red (no silent baseline)."""
from repro_torch import random as prng

FIXED = prng.PRNGKey(0)  # repro_torch: ignore[RV102]
