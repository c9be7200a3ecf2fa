# repro_torch: robust-stat
"""Fixture: robust-stat reductions without f32 accumulation (RV105 x2)."""
import torch


def batch_means(stacked):
    return torch.mean(stacked, dim=0)       # no visible float32 up-cast


def gram(a, b):
    return torch.matmul(a, b.T)             # no float32 operands
