# repro_torch: robust-stat
"""Fixture: f32-accumulated majority-vote counts (clean)."""
import torch


def negative_votes(stacked):
    return torch.sum(torch.signbit(stacked), dim=0, dtype=torch.float32)


def vote_margin(stacked):
    return stacked.sign().to(torch.float32).mean(0)
