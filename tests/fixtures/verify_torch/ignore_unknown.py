"""Fixture: suppression naming an unknown rule ID (RV100; the RV102
finding survives because ignore[RV999] does not cover it)."""
from repro_torch import random as prng

FIXED = prng.PRNGKey(0)  # repro_torch: ignore[RV999] wrong rule id
