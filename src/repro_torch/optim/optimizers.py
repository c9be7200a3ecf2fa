"""Pytree optimizers: SGD (the paper's gradient descent) and AdamW (the
LM substrate's).

Interface (optax-like, as in ``repro.optim``):

    opt = sgd(lr)                        # or adamw(...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = tree_map(lambda p, u: p + u, params, updates)

Both update elementwise, so they run as they are on a rank's storage
blocks; under a layout (``shard_aggregation.use_layout``) AdamW's
global clip norm is the layout's blocked sum.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import shard_aggregation as sa

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


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw(learning_rate, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: float | None = None) -> Optimizer:
    """AdamW with optional global-norm gradient clipping.

    The moments are float32 whatever the param dtype (bf16 params, f32
    optimizer state); bias correction counts from ``step + 1``; the
    learning rate is ``sched(step)``; the updates are float32."""
    sched = _as_schedule(learning_rate)
    f32 = torch.float32

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=f32, device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return AdamState(step=step, mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state: AdamState, params):
        grads = tree_map(lambda g: g.to(f32), grads)
        if grad_clip_norm is not None:
            gnorm = torch.sqrt(sa.sq_norm(sa.current_layout(),
                                          tree_leaves(grads)))
            scale = torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        count = state.step + 1
        lr = sched(state.step)
        bc1 = 1.0 - b1 ** count.to(f32)
        bc2 = 1.0 - b2 ** count.to(f32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                      state.nu, grads)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(f32)
            return (-lr * step).to(f32)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=count, mu=mu, nu=nu)

    return Optimizer(name="adamw", init=init, update=update)
