"""The language model: init / forward / prefill / decode (port of
``repro.models.model``, the dense and MoE families).

Batch formats (one worker's shard, as in the reference):

  train:   {"tokens": (B, T) int, "labels": (B, T) int}
  prefill: {"tokens": (B, T) int}
  decode:  tokens (B, 1) int, positions (B,) int, state dict

The reference scans the layer stack; here a Python loop walks the stacked
params (``blocks.layer``), each block under ``blocks.maybe_remat``.
``loss_fn`` trains through the plain attention core (``plain=True``), as
the reference trains through its jnp core: the flash kernel has no
backward.  ``forward`` sums the blocks' aux losses (the MoE router's,
float32) in layer order, and ``loss_fn`` returns ``ce + aux``.  ``init`` and ``init_decode_state`` are entry
points: ``device=None`` means the CUDA card and raises without one.  The
other families (vlm, ssm, hybrid, audio) raise ``NotImplementedError``
until their code is ported (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks, layers


# ---------------------------------------------------------------------------
# init

def init(seed: int, cfg: ModelConfig, *, device=None):
    """Random params from ``seed``, drawn leaf by leaf on the device (a
    float32 scratch of the largest leaf at a time) and stored in
    ``cfg.param_dtype`` (the MoE router in float32)."""
    blocks.require_ported(cfg)
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
    """The reference's ``embed[tokens]``.  Through ``F.embedding``, whose
    backward sums each row's gradients in a fixed order; the backward of
    indexing (``index_put_`` with accumulation, under ``vmap`` too) adds
    them from several CPU threads at once, so two runs would differ in the
    last bits."""
    return F.embedding(tokens, params["embed"]).to(cfg.dtype)


def _unembed_fn(params, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return lambda h: h @ w


def forward(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """Full-sequence hidden states (B, T, D) + aux loss (a float32 scalar
    for MoE, 0.0 for dense).  ``plain=True`` keeps the attention core off
    the CUDA kernel.  Under remat the block returns its aux beside h, so
    the router's loss survives rematerialization."""
    blocks.require_ported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    block = blocks.maybe_remat(
        lambda p, h: blocks.decoder_block(p, cfg, h, plain=plain), cfg)
    aux = 0.0
    for i in range(cfg.num_layers):
        x, a = block(blocks.layer(params["layers"], i), x)
        aux = aux + a
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return h, aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy + the aux loss (the MoE router's, 0
    for dense), through the plain attention core on every device."""
    h, aux = forward(params, cfg, batch, plain=True)
    ce = layers.cross_entropy_loss(_unembed_fn(params, cfg), h,
                                   batch["labels"],
                                   vocab_chunk=cfg.loss_chunk)
    return ce + aux


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
    blocks.require_ported(cfg)
    dev = _device.enter(device)
    shape = attention.cache_shape(blocks.attn_spec(cfg), batch, max_len)
    full = (cfg.num_layers, *shape)
    return {"cache": {"self": {
        "k": torch.zeros(full, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(full, dtype=cfg.dtype, device=dev)}}}


def decode_step(params, cfg: ModelConfig, state, tokens, positions):
    """One decode step.  tokens (B, 1), positions (B,).  Returns (logits
    (B, 1, V), state); the cache is updated in place, layer by layer."""
    blocks.require_ported(cfg)
    x = _embed(params, cfg, tokens)
    cache = state["cache"]
    for i in range(cfg.num_layers):
        x, _ = blocks.decoder_block_decode(
            blocks.layer(params["layers"], i), cfg, x,
            blocks.layer(cache, i), positions)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return _unembed_fn(params, cfg)(h), state
