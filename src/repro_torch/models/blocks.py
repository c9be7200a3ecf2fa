"""Decoder blocks and their stack helpers (port of
``repro.models.blocks``, the dense and MoE families).

Stacked params carry a leading L axis; the reference scans the block over
it, the port loops over it in Python (``layer``).  ``maybe_remat`` is the
reference's activation rematerialization on ``torch.utils.checkpoint``.
The RWKV, Mamba and encoder blocks come with their families (ROADMAP
Queue 1 item 16).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.models import attention, layers, moe


def attn_spec(cfg: ModelConfig) -> attention.AttentionSpec:
    """The causal self-attention of a decoder block."""
    return attention.AttentionSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        sliding_window=cfg.sliding_window,
        rope_theta=cfg.rope_theta,
    )


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(
        d_model=cfg.d_model, d_ff=cfg.d_ff,
        num_experts=cfg.num_experts,
        experts_per_token=cfg.experts_per_token,
        capacity_factor=cfg.moe_capacity_factor)


def require_ported(cfg: ModelConfig):
    """Raise for a family whose blocks are not ported yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family's blocks come with ROADMAP Queue 1 "
            f"item 16; the port has the {' and '.join(PORTED_FAMILIES)} "
            "decoders")


# ---------------------------------------------------------------------------
# decoder block (dense / moe): pre-norm GQA + (SwiGLU | MoE)

def init_decoder_block(gen, cfg: ModelConfig, *, stack: tuple = ()):
    """One block's params, or ``stack=(L,)`` blocks stacked leaf by leaf."""
    require_ported(cfg)
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "ln_attn": layers.rmsnorm_init(cfg.d_model, dtype=dt, device=dev,
                                       stack=stack),
        "attn": attention.init(gen, attn_spec(cfg), dtype=dt, stack=stack),
        "ln_mlp": layers.rmsnorm_init(cfg.d_model, dtype=dt, device=dev,
                                      stack=stack),
    }
    if cfg.family == "moe":
        p["moe"] = moe.init(gen, moe_spec(cfg), dtype=dt, stack=stack)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dt,
                                      stack=stack)
    return p


def decoder_block(p, cfg: ModelConfig, x, *, plain: bool = False):
    """Full-sequence (train/prefill) block: (x (B, T, D)) -> (x, aux): the
    MoE router's loss, or 0.0 for the dense block."""
    h = attention.apply(p["attn"], attn_spec(cfg),
                        layers.rmsnorm(p["ln_attn"], x, eps=cfg.norm_eps),
                        plain=plain)
    x = x + h
    normed = layers.rmsnorm(p["ln_mlp"], x, eps=cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe.apply(p["moe"], moe_spec(cfg), normed)
        return x + h, aux
    return x + layers.swiglu(p["mlp"], normed), 0.0


def decoder_block_decode(p, cfg: ModelConfig, x, cache, position):
    """One-token decode through a block.  cache: {"self": attention cache},
    updated in place (``attention.decode_step``)."""
    h, new_cache = attention.decode_step(
        p["attn"], attn_spec(cfg),
        layers.rmsnorm(p["ln_attn"], x, eps=cfg.norm_eps),
        cache["self"], position)
    x = x + h
    normed = layers.rmsnorm(p["ln_mlp"], x, eps=cfg.norm_eps)
    if cfg.family == "moe":
        h, _ = moe.apply(p["moe"], moe_spec(cfg), normed)
    else:
        h = layers.swiglu(p["mlp"], normed)
    return x + h, {"self": new_cache}


# ---------------------------------------------------------------------------
# stack helper

def layer(params_stack, i: int):
    """Layer ``i`` of stacked params (views, no copy)."""
    if isinstance(params_stack, dict):
        return {k: layer(v, i) for k, v in params_stack.items()}
    return params_stack[i]


def _under_torch_func() -> bool:
    """True inside a ``torch.func`` transform (vmap, grad, ...)."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under activation rematerialization when ``cfg.remat``: the
    reference's ``jax.checkpoint`` as ``torch.utils.checkpoint`` (not
    reentrant).  Remat changes memory, not numbers, so it applies only
    where autograd records (never under ``no_grad``, as in prefill).

    ``torch.utils.checkpoint`` works through saved-tensor hooks, which
    ``torch.func``'s grad transforms refuse; under one (the worker-mode
    ``robust_train.per_worker_grads``, a ``vmap`` of ``grad``) a remat
    config raises ``ValueError`` rather than dropping remat silently:
    that path takes ``cfg.with_(remat=False)``."""
    if not cfg.remat:
        return fn

    def remat_fn(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if _under_torch_func():
            raise ValueError(
                f"{cfg.name}: cfg.remat=True under a torch.func transform "
                "(vmap/grad, e.g. robust_train.per_worker_grads): "
                "torch.utils.checkpoint's saved-tensor hooks do not compose "
                "with torch.func; pass cfg.with_(remat=False) on this path "
                "(the group-mode step, on plain autograd, honours remat)")
        return checkpoint(fn, *args, use_reentrant=False)

    return remat_fn
