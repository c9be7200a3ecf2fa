# repro_torch: robust-stat
"""Fixture: f32-accumulated robust-stat reductions (clean)."""
import torch


def batch_means(stacked):
    return torch.mean(stacked.to(torch.float32), dim=0)


def gram(a, b):
    return torch.matmul(a.float(), b.T.float())
