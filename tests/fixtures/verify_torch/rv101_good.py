# repro_torch: bit-stable
"""Fixture: bit-stable module with only fixed-order reductions (clean)."""
import torch


def chain_total(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def per_member_norms(stacked):
    # last-dim reduction: not the member axis; in scope but allowed
    return torch.sum(stacked.to(torch.float32) ** 2, dim=-1)
