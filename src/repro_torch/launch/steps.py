"""Serve-side steps (port of ``repro.launch.steps``: ``make_prefill_step``
and ``make_serve_step``).  The train steps come with the training slice
(ROADMAP Queue 1 item 16).

A step runs under ``torch.no_grad`` with the port's matmul precision
(``_device.set_precision``) on whatever device its params lie on.
"""

from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


def make_prefill_step(cfg: ModelConfig, *, plain: bool = False):
    """(params, {"tokens": (B, T)}) -> hidden states (B, T, D).  On CUDA
    the attention core is the flash kernel; ``plain=True`` keeps the
    reference's plain path (``attention_core_blocked`` above 2048)."""
    def prefill_step(params, batch):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.prefill(params, cfg, batch, plain=plain)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens (B, 1), positions (B,)) -> (logits (B, 1, V),
    state); the KV cache is updated in place."""
    def serve_step(params, state, tokens, positions):
        _device.set_precision()
        with torch.no_grad():
            return model_lib.decode_step(params, cfg, state, tokens,
                                         positions)
    return serve_step
