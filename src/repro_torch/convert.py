"""Carry state and data across from the JAX package, through numpy.

The port imports nothing of ``repro`` or ``jax``: callers hand over
structures whose leaves are already numpy arrays (for example
``jax.tree.map(np.asarray, state)``), and these functions rebuild the
port's types on a device.  Named tuples are read by field name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.train_state import TrainState
from repro_torch.data.regression import RegressionDataset
from repro_torch.optim import SGDState


def _tensor(x, device):
    return torch.tensor(np.asarray(x), device=device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(_tree(v, device) for v in x)
    return _tensor(x, device)


def train_state_from_numpy(tree, *, device) -> TrainState:
    """A reference ``TrainState`` with numpy leaves -> the port's
    ``TrainState`` on ``device``: theta, ``SGDState``, ``attack_state``,
    ``round_index``, ``base_key`` (uint32 words -> the port's int64 key)
    and ``history`` (kept as float32 numpy arrays)."""
    if tree.stale_buffer != ():
        raise NotImplementedError("a staleness buffer is ROADMAP Queue 1 "
                                  "item 12")
    opt = tree.opt_state
    return TrainState(
        params=_tree(tree.params, device),
        opt_state=SGDState(step=_tensor(opt.step, device),
                           momentum=_tree(opt.momentum, device)),
        attack_state=_tree(tree.attack_state, device),
        round_index=_tensor(tree.round_index, device),
        base_key=_tensor(np.asarray(tree.base_key).astype(np.int64), device),
        history={k: np.asarray(v, np.float32)
                 for k, v in tree.history.items()})


def scenario_inputs_from_numpy(features, targets, theta_star, *,
                               device) -> RegressionDataset:
    """The reference's linreg arrays (X (m, N/m, d), y (m, N/m), theta*
    (d,)) -> the port's ``RegressionDataset`` on ``device``."""
    return RegressionDataset(
        features=_tensor(features, device).to(torch.float32),
        targets=_tensor(targets, device).to(torch.float32),
        theta_star=_tensor(theta_star, device).to(torch.float32))
