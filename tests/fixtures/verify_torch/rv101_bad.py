# repro_torch: bit-stable
"""Fixture: member-axis torch.sum in a bit-stable module (one RV101).

The operand is visibly float32 (.to) so RV105 stays quiet: the fixture
isolates the summation-order rule from the accumulation rule."""
import torch


def bad_partial(parts):
    return torch.sum(parts.to(torch.float32), dim=0)
