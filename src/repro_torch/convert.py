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
from repro_torch.core.staleness import StalenessBuffer
from repro_torch.core.train_state import TrainState
from repro_torch.data.regression import RegressionDataset
from repro_torch.optim import AdamState, SGDState


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


def _opt_state(opt, device):
    """The reference's optimizer state, read by its field names:
    ``AdamState(step, mu, nu)`` or ``SGDState(step, momentum)``."""
    fields = tuple(getattr(opt, "_fields", ()))
    if fields == AdamState._fields:
        return AdamState(step=_tensor(opt.step, device),
                         mu=_tree(opt.mu, device), nu=_tree(opt.nu, device))
    if fields == SGDState._fields:
        return SGDState(step=_tensor(opt.step, device),
                        momentum=_tree(opt.momentum, device))
    raise ValueError(f"unknown optimizer state {type(opt).__name__} with "
                     f"fields {fields}")


def train_state_from_numpy(tree, *, device) -> TrainState:
    """A reference ``TrainState`` with numpy leaves -> the port's
    ``TrainState`` on ``device``: the params, the optimizer state
    (``AdamState`` or ``SGDState``, by its field names), ``attack_state``,
    ``round_index``, ``base_key`` (uint32 words -> the port's int64 key),
    ``history`` (kept as float32 numpy arrays) and the staleness buffer
    (its gradients, int32 ages and bound; ``()`` stays ``()``)."""
    buf = tree.stale_buffer
    if len(buf):
        buf = StalenessBuffer(grads=_tree(buf.grads, device),
                              age=_tensor(buf.age, device).to(torch.int32),
                              bound=_tensor(buf.bound, device))
    return TrainState(
        params=_tree(tree.params, device),
        opt_state=_opt_state(tree.opt_state, device),
        attack_state=_tree(tree.attack_state, device),
        round_index=_tensor(tree.round_index, device),
        base_key=_tensor(np.asarray(tree.base_key).astype(np.int64), device),
        history={k: np.asarray(v, np.float32)
                 for k, v in tree.history.items()},
        stale_buffer=buf)


def scenario_inputs_from_numpy(features, targets, theta_star, *,
                               device) -> RegressionDataset:
    """The reference's linreg arrays (X (m, N/m, d), y (m, N/m), theta*
    (d,)) -> the port's ``RegressionDataset`` on ``device``."""
    return RegressionDataset(
        features=_tensor(features, device).to(torch.float32),
        targets=_tensor(targets, device).to(torch.float32),
        theta_star=_tensor(theta_star, device).to(torch.float32))


def _param_shapes(cfg: ModelConfig, tree):
    """(want, got): the shapes of a few leaves that pin each layout."""
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size

    def at(*path):
        node = tree
        for key in path:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        return np.shape(node) if not isinstance(node, dict) else None

    want, got = {"embed": (V, D)}, {"embed": at("embed")}
    if cfg.family == "ssm":
        H, hd = D // cfg.ssm_head_dim, cfg.ssm_head_dim
        want.update(wr=(L, D, H, hd), u=(L, H, hd), w_lora_b=(L, 64, H, hd),
                    wk_cm=(L, D, cfg.d_ff), ln_tm=(L, D))
        got.update(wr=at("layers", "time_mix", "wr"),
                   u=at("layers", "time_mix", "u"),
                   w_lora_b=at("layers", "time_mix", "w_lora_b"),
                   wk_cm=at("layers", "channel_mix", "wk"),
                   ln_tm=at("layers", "ln_tm", "scale"))
        return want, got
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every or L
        G, per, din = L // every, every, 2 * D
        H = din // cfg.ssm_head_dim
        want.update(w_x=(G, per, D, din), w_B=(G, per, D, cfg.ssm_state),
                    A_log=(G, per, H), conv_x=(G, per, 4, din),
                    wq=(D, cfg.num_heads, cfg.head_dim),
                    w_gate=(D, cfg.d_ff))
        got.update(w_x=at("mamba", "w_x"), w_B=at("mamba", "w_B"),
                   A_log=at("mamba", "A_log"), conv_x=at("mamba", "conv_x"),
                   wq=at("shared", "attn", "wq"),
                   w_gate=at("shared", "mlp", "w_gate"))
        return want, got
    want["wq"] = (L, D, cfg.num_heads, cfg.head_dim)
    got["wq"] = at("layers", "attn", "wq")
    if cfg.family == "moe":
        E = cfg.num_experts
        want.update(router=(L, D, E), w_gate=(L, E, D, cfg.d_ff))
        got.update(router=at("layers", "moe", "router"),
                   w_gate=at("layers", "moe", "w_gate"))
    else:
        want.update(w_gate=(L, D, cfg.d_ff))
        got.update(w_gate=at("layers", "mlp", "w_gate"))
    if cfg.family == "audio":
        Le, H, hd = cfg.encoder_layers, cfg.num_heads, cfg.head_dim
        want.update(cross_wq=(L, D, H, hd), ln_cross=(L, D),
                    enc_wq=(Le, D, H, hd), enc_w_in=(Le, D, cfg.d_ff),
                    enc_b_in=(Le, cfg.d_ff), enc_ln=(D,))
        got.update(cross_wq=at("layers", "cross", "wq"),
                   ln_cross=at("layers", "ln_cross", "scale"),
                   enc_wq=at("encoder", "attn", "wq"),
                   enc_w_in=at("encoder", "mlp", "w_in"),
                   enc_b_in=at("encoder", "mlp", "b_in"),
                   enc_ln=at("enc_ln", "scale"))
    return want, got


def lm_params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's ``models.model.init`` params with numpy leaves ->
    the port's params on ``device`` (``None``: the CUDA card), leaf for
    leaf (the same keys and layouts, stacked layers included), each leaf
    in its own dtype (in a bf16 config the MoE router and Mamba2's
    ``A_log``, ``dt_bias`` and ``D`` stay float32).  The dense (and vlm)
    layout has ``layers.mlp``; the audio layout adds ``layers.ln_cross``,
    ``layers.cross``, the stacked ``encoder`` (LayerNorms, attention, GELU
    MLP with biases) and ``enc_ln``; the MoE layout ``layers.moe`` with
    (L, E, d_in, d_out) experts and an (L, D, E) router; RWKV6
    ``layers.time_mix`` and ``layers.channel_mix``; Zamba2 ``mamba``
    stacked (groups, per) and an unstacked ``shared`` decoder block."""
    dev = _device.resolve_device(device)
    want, got = _param_shapes(cfg, tree)
    if got != want:
        raise ValueError(f"params of shapes {got} do not fit {cfg.name} "
                         f"({want})")
    return _tree(tree, dev)


def decode_state_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's ``init_decode_state`` (or a stepped state) with numpy
    leaves -> the port's decode state on ``device``: the KV caches, the
    audio encoder's ``memory``, token shifts and conv states in
    ``cfg.dtype``, RWKV6's WKV states and Mamba2's SSM states in
    float32."""
    dev = _device.resolve_device(device)
    if cfg.family == "ssm":
        prev_tm, wkv, prev_cm = tree["states"]
        return {"states": (_tree(prev_tm, dev, cfg.dtype),
                           _tree(wkv, dev, torch.float32),
                           _tree(prev_cm, dev, cfg.dtype))}
    if cfg.family == "hybrid":
        return {"conv": _tree(tree["conv"], dev, cfg.dtype),
                "ssm": _tree(tree["ssm"], dev, torch.float32),
                "attn": {k: _tree(tree["attn"][k], dev, cfg.dtype)
                         for k in ("k", "v")}}
    cache = tree["cache"]["self"]
    state = {"cache": {"self": {
        k: _tree(cache[k], dev, cfg.dtype) for k in ("k", "v")}}}
    if cfg.family == "audio":
        state["memory"] = _tree(tree["memory"], dev, cfg.dtype)
    return state
