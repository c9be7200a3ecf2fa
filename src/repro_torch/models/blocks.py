"""Decoder blocks and their stack helpers (port of
``repro.models.blocks``, the dense family).

Stacked params carry a leading L axis; the reference scans the block over
it, the port loops over it in Python (``layer``).  The MoE, RWKV, Mamba
and encoder blocks come with their families (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers


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


def require_dense(cfg: ModelConfig):
    """Raise for a family whose blocks are not ported yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family's blocks come with ROADMAP Queue 1 "
            "item 16; the port has the dense decoder")


# ---------------------------------------------------------------------------
# decoder block (dense): pre-norm GQA + SwiGLU

def init_decoder_block(gen, cfg: ModelConfig, *, stack: tuple = ()):
    """One block's params, or ``stack=(L,)`` blocks stacked leaf by leaf."""
    require_dense(cfg)
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln_attn": layers.rmsnorm_init(cfg.d_model, dtype=dt, device=dev,
                                       stack=stack),
        "attn": attention.init(gen, attn_spec(cfg), dtype=dt, stack=stack),
        "ln_mlp": layers.rmsnorm_init(cfg.d_model, dtype=dt, device=dev,
                                      stack=stack),
        "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dt,
                                  stack=stack),
    }


def decoder_block(p, cfg: ModelConfig, x, *, plain: bool = False):
    """Full-sequence (train/prefill) block: (x (B, T, D)) -> (x, aux)."""
    h = attention.apply(p["attn"], attn_spec(cfg),
                        layers.rmsnorm(p["ln_attn"], x, eps=cfg.norm_eps),
                        plain=plain)
    x = x + h
    normed = layers.rmsnorm(p["ln_mlp"], x, eps=cfg.norm_eps)
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
    return x + layers.swiglu(p["mlp"], normed), {"self": new_cache}


# ---------------------------------------------------------------------------
# stack helper

def layer(params_stack, i: int):
    """Layer ``i`` of stacked params (views, no copy)."""
    if isinstance(params_stack, dict):
        return {k: layer(v, i) for k, v in params_stack.items()}
    return params_stack[i]
