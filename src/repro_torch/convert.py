"""Carry state, data and model params across from the JAX package,
through numpy.

The port imports nothing of ``repro`` or ``jax``: callers hand over
structures whose leaves are already numpy arrays (for example
``jax.tree.map(np.asarray, state)``), and these functions rebuild the
port's types on a device.  Named tuples are read by field name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.train_state import TrainState
from repro_torch.data.regression import RegressionDataset
from repro_torch.optim import SGDState


def _tensor(x, device, dtype=None):
    """numpy -> tensor on ``device``; floating values cast to ``dtype``."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    else:
        t = torch.tensor(x, device=device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _tree(x, device, dtype=None):
    if isinstance(x, dict):
        return {k: _tree(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(_tree(v, device, dtype) for v in x)
    return _tensor(x, device, dtype)


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


def lm_params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's ``models.model.init`` params with numpy leaves ->
    the port's params on ``device`` (``None``: the CUDA card), leaf for
    leaf (the same keys and layouts, stacked layers included), floating
    leaves in ``cfg.param_dtype``."""
    dev = _device.resolve_device(device)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    want = {"embed": (V, D),
            "wq": (L, D, cfg.num_heads, cfg.head_dim),
            "w_gate": (L, D, cfg.d_ff)}
    got = {"embed": np.shape(tree["embed"]),
           "wq": np.shape(tree["layers"]["attn"]["wq"]),
           "w_gate": np.shape(tree["layers"]["mlp"]["w_gate"])}
    if got != want:
        raise ValueError(f"params of shapes {got} do not fit {cfg.name} "
                         f"({want})")
    return _tree(tree, dev, cfg.param_dtype)


def decode_state_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's ``init_decode_state`` (or a stepped state) with numpy
    leaves -> the port's decode state on ``device``, in ``cfg.dtype``."""
    dev = _device.resolve_device(device)
    cache = tree["cache"]["self"]
    return {"cache": {"self": {
        k: _tree(cache[k], dev, cfg.dtype) for k in ("k", "v")}}}
