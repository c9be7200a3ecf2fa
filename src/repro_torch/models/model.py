"""The language model: init / forward / prefill / decode (port of
``repro.models.model``, the dense family).

Batch formats (one worker's shard, as in the reference):

  prefill: {"tokens": (B, T) int}
  decode:  tokens (B, 1) int, positions (B,) int, state dict

The reference scans the layer stack; here a Python loop walks the stacked
params (``blocks.layer``).  ``init`` and ``init_decode_state`` are entry
points: ``device=None`` means the CUDA card and raises without one.  The
other families (vlm, moe, ssm, hybrid, audio) raise
``NotImplementedError`` until their code is ported (ROADMAP Queue 1 item
16).
"""

from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks, layers


# ---------------------------------------------------------------------------
# init

def init(seed: int, cfg: ModelConfig, *, device=None):
    """Random params from ``seed``, drawn leaf by leaf on the device (a
    float32 scratch of the largest leaf at a time) and stored in
    ``cfg.param_dtype``."""
    blocks.require_dense(cfg)
    dev = _device.enter(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_dtype
    params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   dtype=dt),
        "ln_f": layers.rmsnorm_init(cfg.d_model, dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, dtype=dt)
    # each leaf drawn whole with a leading L axis (the reference vmaps the
    # init over split keys)
    params["layers"] = blocks.init_decoder_block(gen, cfg,
                                                 stack=(cfg.num_layers,))
    return params


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)

def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens].to(cfg.dtype)


def _unembed_fn(params, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return lambda h: h @ w


def forward(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """Full-sequence hidden states (B, T, D) + aux loss.  ``plain=True``
    keeps the attention core off the CUDA kernel."""
    blocks.require_dense(cfg)
    x = _embed(params, cfg, batch["tokens"])
    for i in range(cfg.num_layers):
        x, _ = blocks.decoder_block(blocks.layer(params["layers"], i), cfg, x,
                                    plain=plain)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return h, 0.0


def logits(params, cfg: ModelConfig, batch):
    """Full logits (small-scale tests only: O(B·T·V) memory)."""
    h, _ = forward(params, cfg, batch)
    return _unembed_fn(params, cfg)(h)


def prefill(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """Score a full prompt and return the hidden states (B, T, D)."""
    h, _ = forward(params, cfg, batch, plain=plain)
    return h


# ---------------------------------------------------------------------------
# decode

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None):
    """The KV cache for single-token decoding against a ``max_len``
    context: {"cache": {"self": {"k", "v"}}}, each (L, B, phys, KV, hd)
    with phys = min(max_len, window) (a ring buffer under a window)."""
    blocks.require_dense(cfg)
    dev = _device.enter(device)
    shape = attention.cache_shape(blocks.attn_spec(cfg), batch, max_len)
    full = (cfg.num_layers, *shape)
    return {"cache": {"self": {
        "k": torch.zeros(full, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(full, dtype=cfg.dtype, device=dev)}}}


def decode_step(params, cfg: ModelConfig, state, tokens, positions):
    """One decode step.  tokens (B, 1), positions (B,).  Returns (logits
    (B, 1, V), state); the cache is updated in place, layer by layer."""
    blocks.require_dense(cfg)
    x = _embed(params, cfg, tokens)
    cache = state["cache"]
    for i in range(cfg.num_layers):
        x, _ = blocks.decoder_block_decode(
            blocks.layer(params["layers"], i), cfg, x,
            blocks.layer(cache, i), positions)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return _unembed_fn(params, cfg)(h), state
