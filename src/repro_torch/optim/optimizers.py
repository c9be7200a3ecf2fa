"""Pytree SGD (the paper's gradient descent).

Interface (optax-like, as in ``repro.optim``):

    opt = sgd(lr)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = tree_map(lambda p, u: p + u, params, updates)

AdamW is not ported yet (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]   # step -> lr


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any   # pytree or () when momentum == 0


def sgd(learning_rate, *, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """Plain (momentum) SGD.  momentum=0 == the paper's gradient descent."""
    sched = _as_schedule(learning_rate)

    def init(params):
        mom = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params) if momentum else ())
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return SGDState(step=step, momentum=mom)

    def update(grads, state: SGDState, params=None):
        del params
        lr = sched(state.step)
        if momentum:
            new_mom = tree_map(lambda m, g: momentum * m + g.float(),
                               state.momentum, grads)
            vec = (tree_map(lambda m, g: momentum * m + g.float(),
                            new_mom, grads) if nesterov else new_mom)
            updates = tree_map(lambda v: -lr * v, vec)
            return updates, SGDState(step=state.step + 1, momentum=new_mom)
        updates = tree_map(lambda g: -lr * g.float(), grads)
        return updates, SGDState(step=state.step + 1, momentum=())

    return Optimizer(name="sgd", init=init, update=update)
