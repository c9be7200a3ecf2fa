"""Shared neural-net layers (port of ``repro.models.layers``).

Plain functions on tensors; params are nested dicts.  Params are stored in
``param_dtype``; matmuls run in the activation dtype; norms and RoPE
compute in float32 and round once to the input type, as the reference
does.  Initialisers draw from an explicit ``torch.Generator`` on the
generator's device: the values follow the reference's distributions, not
its bits (tests hand the JAX params across instead).

Not ported: the shard_map sequence-parallel SwiGLU region (ROADMAP Queue 1
items 13 and 17), the GELU MLP and LayerNorm (the audio family) and
``cross_entropy_loss`` (training).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# erf(-2/sqrt 2), erf(2/sqrt 2): the uniform range whose erfinv is a
# standard normal truncated to [-2, 2]
_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def truncated_normal_init(gen: torch.Generator, shape, scale: float, dtype):
    """A standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 on ``gen``'s device and rounded once to ``dtype``."""
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    x.uniform_(_TRUNC_LO, _TRUNC_HI, generator=gen)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(scale)
    return x.to(dtype)


def dense_init(gen, d_in: int, d_out, *, dtype, scale: float | None = None,
               stack: tuple = ()):
    """Weight matrix (*stack, d_in, *d_out) with fan-in scaling; ``stack``
    is a leading layer axis, drawn as one leaf."""
    if isinstance(d_out, int):
        d_out = (d_out,)
    scale = scale if scale is not None else d_in ** -0.5
    return truncated_normal_init(gen, (*stack, d_in, *d_out), scale, dtype)


def embed_init(gen, vocab: int, d_model: int, *, dtype):
    return truncated_normal_init(gen, (vocab, d_model), 1.0, dtype)


# ---------------------------------------------------------------------------
# norms

def rmsnorm_init(dim: int, *, dtype, device=None, stack: tuple = ()):
    return {"scale": torch.ones((*stack, dim), dtype=dtype, device=device)}


def rmsnorm(params, x, *, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings

def rope_frequencies(head_dim: int, *, theta: float = 1e4, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float = 1e4):
    """x: (..., T, H, head_dim); positions: broadcastable to (..., T).
    The two halves of head_dim rotate together (60 + 60 at hd = 120)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta=theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs

def swiglu_init(gen, d_model: int, d_ff: int, *, dtype, stack: tuple = ()):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack),
        "w_up": dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack),
        "w_down": dense_init(gen, d_ff, d_model, dtype=dtype, stack=stack),
    }


def swiglu(params, x):
    """SwiGLU MLP: silu in float32, rounded to the activation type, times
    the up projection (the reference's ``_swiglu_local``)."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return hidden @ params["w_down"]
