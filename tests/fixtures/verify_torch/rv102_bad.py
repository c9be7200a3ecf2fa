"""Fixture: literal seeds outside entry points (RV102 x2)."""
from repro_torch import random as prng

FIXED_KEY = prng.PRNGKey(0)


def helper(torch):
    return torch.Generator().manual_seed(42)
