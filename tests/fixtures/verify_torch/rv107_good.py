# repro_torch: train-scan
"""Fixture: StalenessBuffer with int32 ages everywhere (clean)."""
from typing import Any, NamedTuple

import torch


class StalenessBuffer(NamedTuple):
    grads: Any
    age: Any
    bound: Any


def make_buffer(grads, m, bound):
    return StalenessBuffer(grads, torch.full((m,), bound + 1,
                                             dtype=torch.int32),
                           torch.tensor(bound, dtype=torch.int32))


def tick(buf, fresh):
    return StalenessBuffer(
        buf.grads, torch.where(fresh, 0, buf.age + 1).to(torch.int32),
        buf.bound)
