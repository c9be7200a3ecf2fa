"""Shared neural-net layers (port of ``repro.models.layers``).

Plain functions on tensors; params are nested dicts.  Params are stored in
``param_dtype``; matmuls run in the activation dtype; norms and RoPE
compute in float32 and round once to the input type, as the reference
does.  Initialisers draw from an explicit ``torch.Generator`` on the
generator's device: the values follow the reference's distributions, not
its bits (tests hand the JAX params across instead).

Under a model mesh (``meshctx.set_mesh``) ``swiglu`` runs the
reference's Megatron SP+TP region on the rank's block, with its
hand-written backward (``_SwigluRegion``), or, on a stream whose T is
whole on every model rank, the rank's F-slices and a psum over
``model``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import meshctx

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


def layernorm_init(dim: int, *, dtype, device=None, stack: tuple = ()):
    return {"scale": torch.ones((*stack, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*stack, dim), dtype=dtype, device=device)}


def layernorm(params, x, *, eps: float = 1e-5):
    """Mean and variance in float32, rounded once to the input type."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    centred = xf - mu
    var = torch.mean(centred * centred, dim=-1, keepdim=True)
    normed = centred * torch.rsqrt(var + eps)
    out = normed * params["scale"].to(torch.float32) \
        + params["bias"].to(torch.float32)
    return out.to(x.dtype)


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


def _swiglu_local(w_gate, w_up, w_down, x):
    """SwiGLU MLP: silu in float32, rounded to the activation type, times
    the up projection."""
    gate = x @ w_gate
    up = x @ w_up
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return hidden @ w_down


def _rows(t):
    """(..., n) -> (rows, n): every leading dim is a contracted one."""
    return t.reshape(-1, t.shape[-1])


class _SwigluRegion(torch.autograd.Function):
    """The Megatron SP+TP SwiGLU on one rank (the reference's
    ``_make_swiglu_sp_region``): all-gather the T-sharded block over
    ``model``, the SwiGLU against the rank's F-slices of the weights, and
    psum_scatter the partial output back to the block, in the block's
    type.  Its backward is the reference's hand-written one: the gathered
    activations re-gathered, not saved; the gather's transpose an explicit
    psum_scatter of the input gradient; the weight gradients psum'd over
    the data axes; every collective in the block's type."""

    @staticmethod
    def forward(ctx, w_gate, w_up, w_down, x_blk, mesh, data_axes):
        ctx.mesh, ctx.data_axes = mesh, data_axes
        ctx.save_for_backward(w_gate, w_up, w_down, x_blk)
        g = meshctx._all_gather(x_blk, mesh, ("model",), 1)
        out = _swiglu_local(w_gate, w_up, w_down, g)
        return meshctx._psum_scatter(out.to(x_blk.dtype), mesh, ("model",),
                                     1)

    @staticmethod
    def backward(ctx, grad_out):
        w_gate, w_up, w_down, x_blk = ctx.saved_tensors
        mesh = ctx.mesh
        g = meshctx._all_gather(x_blk, mesh, ("model",), 1)
        go = meshctx._all_gather(grad_out, mesh, ("model",), 1)
        gate = g @ w_gate
        up = g @ w_up
        gate32 = gate.to(torch.float32)
        sg = F.silu(gate32)
        h = sg.to(g.dtype) * up

        grad_h = go @ w_down.T
        grad_wd = _rows(h).T @ _rows(go)
        grad_up = grad_h * sg.to(grad_h.dtype)
        sig = torch.sigmoid(gate32)
        dsilu = sig * (1 + gate32 * (1 - sig))
        grad_gate = (grad_h.to(torch.float32) * up.to(torch.float32)
                     * dsilu).to(g.dtype)
        grad_g = grad_gate @ w_gate.T + grad_up @ w_up.T
        grad_x = meshctx._psum_scatter(grad_g.to(x_blk.dtype), mesh,
                                       ("model",), 1)
        grad_wg = _rows(g).T @ _rows(grad_gate)
        grad_wu = _rows(g).T @ _rows(grad_up)
        if ctx.data_axes:
            # the data-parallel weight-gradient sum, one collective
            grad_wg, grad_wu, grad_wd = meshctx._psum_many(
                [grad_wg, grad_wu, grad_wd], mesh, ctx.data_axes)
        return grad_wg, grad_wu, grad_wd, grad_x, None, None


def swiglu_region_applies(mesh, batch: int, seq: int, d_ff: int) -> bool:
    """The reference's test for the SP+TP region at global (B, T, F)."""
    return meshctx.sp_applicable(mesh, batch, seq) \
        and d_ff % meshctx.model_size(mesh) == 0


def swiglu(params, x, *, d_ff: int | None = None):
    """SwiGLU MLP (the reference's ``swiglu``).  Without a mesh,
    ``_swiglu_local``.  Under a model mesh x is the rank's stream and
    ``d_ff`` the global hidden width; where |model| divides it the
    weights are the rank's F-slices (``w_gate``/``w_up`` (D, F/model),
    ``w_down`` (F/model, D)).  On a stream cut over ``model`` in T
    (``meshctx.stream_is_cut``) the SP+TP region runs; on the data
    shard's whole rows the slices act on the stream and their partial
    outputs are psum'd over ``model`` in rank order, each rank's own copy
    of the sum (``pvary(psum(.))``: the backward sums the copies'
    cotangents).  Whole weights act on the stream as it is."""
    mesh = meshctx.current_mesh()
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], \
        params["w_down"]
    if x.ndim == 3 and mesh is not None:
        if d_ff is None:
            raise ValueError("swiglu under a mesh needs the global d_ff")
        if w_gate.shape[-1] != d_ff:
            if w_gate.shape[-1] * meshctx.model_size(mesh) != d_ff:
                raise ValueError(
                    f"swiglu: w_gate {tuple(w_gate.shape)} is not a "
                    f"model-axis slice of d_ff {d_ff}")
            if meshctx.stream_is_cut():
                return _SwigluRegion.apply(w_gate, w_up, w_down, x, mesh,
                                           meshctx.data_axes(mesh))
            out = meshctx.psum(_swiglu_local(w_gate, w_up, w_down, x),
                               "model", mesh=mesh)
            return meshctx.pvary(out, "model", mesh=mesh)
    return _swiglu_local(w_gate, w_up, w_down, x)


def gelu_mlp_init(gen, d_model: int, d_ff: int, *, dtype, stack: tuple = ()):
    """The encoder's GELU MLP: two matrices with fan-in scaling and zero
    biases."""
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype=dtype, stack=stack),
        "b_in": torch.zeros((*stack, d_ff), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, d_ff, d_model, dtype=dtype, stack=stack),
        "b_out": torch.zeros((*stack, d_model), dtype=dtype,
                             device=gen.device),
    }


def gelu_mlp(params, x):
    """GELU MLP: the tanh form of GELU (``jax.nn.gelu``'s default) in
    float32, rounded to the activation type."""
    h = x @ params["w_in"] + params["b_in"]
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# losses

def cross_entropy_loss(logits_fn, hidden, labels, *, vocab_chunk: int = 0,
                       ignore_index: int = -1):
    """Memory-frugal LM cross entropy.

    ``logits_fn(h_chunk) -> (..., V)`` is applied to sequence chunks of
    ``vocab_chunk`` positions (0: min(T, 512); T itself when the chunk does
    not divide T, as in the reference) in a loop, so the full (B, T, V)
    logits never exist at once.  Logits and ``logsumexp`` in float32.

    hidden: (B, T, D); labels: (B, T) int with ``ignore_index`` masked out.
    Returns the mean loss over unmasked positions."""
    total, count = cross_entropy_sums(logits_fn, hidden, labels,
                                      vocab_chunk=vocab_chunk,
                                      ignore_index=ignore_index)
    return total / torch.clamp(count, min=1.0)


def cross_entropy_sums(logits_fn, hidden, labels, *, vocab_chunk: int = 0,
                       ignore_index: int = -1):
    """``cross_entropy_loss``'s float32 (sum of the unmasked positions'
    losses, their count), before the division: a mesh rank's share.  At
    T = 0 (a vlm mesh rank whose block holds only patches) both are zero,
    still computed from ``hidden`` and ``logits_fn``'s weights, so that
    the rank's backward runs, and makes its collectives, as every other
    rank's does."""
    B, T = labels.shape
    chunk = vocab_chunk if vocab_chunk > 0 else min(T, 512)
    if chunk == 0 or T % chunk != 0:
        chunk = max(T, 1)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, max(T, 1), chunk):
        logits = logits_fn(hidden[:, s:s + chunk]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        yc = labels[:, s:s + chunk]
        mask = yc != ignore_index
        safe_y = torch.where(mask, yc, torch.zeros_like(yc))
        picked = torch.gather(logits, -1, safe_y[..., None].long())[..., 0]
        nll = torch.where(mask, lse - picked, torch.zeros_like(lse))
        total = total + torch.sum(nll)
        count = count + torch.sum(mask.to(torch.float32))
    return total, count
