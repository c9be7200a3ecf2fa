# repro_torch: train-scan
"""Fixture: StalenessBuffer built with float ages (RV107)."""
from typing import Any, NamedTuple

import torch


class StalenessBuffer(NamedTuple):
    grads: Any
    age: Any
    bound: Any


def make_buffer(grads, m, bound):
    # age starts as the float default dtype and is updated with float
    # arithmetic: drifts away from exact integers under accumulation
    return StalenessBuffer(grads, torch.zeros((m,)), torch.tensor(bound))


def tick(buf, fresh):
    return StalenessBuffer(buf.grads, torch.where(fresh, 0.0, buf.age + 1.0),
                           buf.bound)
