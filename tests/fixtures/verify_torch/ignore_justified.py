"""Fixture: a justified suppression (clean: finding dropped, no RV100)."""
from repro_torch import random as prng

# repro_torch: ignore[RV102] fixture demonstrates the escape hatch; key unused
FIXED = prng.PRNGKey(0)
