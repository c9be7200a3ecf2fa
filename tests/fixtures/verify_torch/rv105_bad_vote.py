# repro_torch: robust-stat
"""Fixture: majority-vote accumulation without f32 counts (RV105 x2)."""
import torch


def negative_votes(stacked):
    return torch.sum(torch.signbit(stacked), dim=0)  # bool counts, no cast


def vote_margin(stacked):
    return stacked.sign().mean(0)                    # accumulates in g.dtype
