"""Per-family blocks and their stack helpers (port of
``repro.models.blocks``: the decoder block of the dense, MoE and vlm
families and of Zamba2's shared block, with cross-attention in the audio
family's decoder; the audio encoder block; the RWKV6 block; the Mamba2
block).

Stacked params carry a leading L axis; the reference scans the block over
it, the port loops over it in Python (``unstack``).  ``maybe_remat`` is the
reference's activation rematerialization (``jax.checkpoint``) as a
``torch.autograd.Function`` that recomputes the block in its backward
and batches under ``torch.func``.
"""

from __future__ import annotations

import contextvars

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.models import attention, layers, mamba, moe, rwkv


def attn_spec(cfg: ModelConfig, *, causal=True, cross=False,
              sliding_window="cfg") -> attention.AttentionSpec:
    """A block's attention: by default the decoder's causal
    self-attention with the config's window; ``cross=True`` the audio
    decoder's cross-attention; ``causal=False, sliding_window=None`` the
    encoder's bidirectional self-attention."""
    return attention.AttentionSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        causal=causal,
        sliding_window=(cfg.sliding_window if sliding_window == "cfg"
                        else sliding_window),
        rope_theta=cfg.rope_theta,
        cross=cross,
    )


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(
        d_model=cfg.d_model, d_ff=cfg.d_ff,
        num_experts=cfg.num_experts,
        experts_per_token=cfg.experts_per_token,
        capacity_factor=cfg.moe_capacity_factor)


def rwkv_spec(cfg: ModelConfig) -> rwkv.RWKVSpec:
    return rwkv.RWKVSpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                         head_dim=cfg.ssm_head_dim)


def mamba_spec(cfg: ModelConfig) -> mamba.MambaSpec:
    return mamba.MambaSpec(d_model=cfg.d_model, d_state=cfg.ssm_state,
                           head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def require_ported(cfg: ModelConfig):
    """Raise for a family the reference does not have."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# decoder block (dense / moe / vlm / audio / hybrid's shared block):
# pre-norm GQA (+ cross-attention) + (SwiGLU | MoE)

def init_decoder_block(gen, cfg: ModelConfig, *, stack: tuple = (),
                       cross: bool = False):
    """One block's params, or ``stack=(L,)`` blocks stacked leaf by leaf;
    ``cross=True`` adds ``ln_cross`` and the cross-attention ``cross``."""
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
    if cross:
        p["ln_cross"] = layers.rmsnorm_init(cfg.d_model, dtype=dt,
                                            device=dev, stack=stack)
        p["cross"] = attention.init(gen, attn_spec(cfg, cross=True),
                                    dtype=dt, stack=stack)
    return p


def decoder_block(p, cfg: ModelConfig, x, *, memory=None,
                  plain: bool = False):
    """Full-sequence (train/prefill) block: (x (B, T, D)) -> (x, aux): the
    MoE router's loss, or 0.0 for a SwiGLU block.  A block with ``cross``
    attends to ``memory`` (B, S, D) after its self-attention."""
    h = attention.apply(p["attn"], attn_spec(cfg),
                        layers.rmsnorm(p["ln_attn"], x, eps=cfg.norm_eps),
                        plain=plain)
    x = x + h
    if "cross" in p:
        h = attention.apply(p["cross"], attn_spec(cfg, cross=True),
                            layers.rmsnorm(p["ln_cross"], x,
                                           eps=cfg.norm_eps),
                            memory=memory, plain=plain)
        x = x + h
    normed = layers.rmsnorm(p["ln_mlp"], x, eps=cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe.apply(p["moe"], moe_spec(cfg), normed)
        return x + h, aux
    return x + layers.swiglu(p["mlp"], normed, d_ff=cfg.d_ff), 0.0


def decoder_block_decode(p, cfg: ModelConfig, x, cache, position, *,
                         memory=None):
    """One-token decode through a block.  cache: {"self": attention cache},
    updated in place (``attention.decode_step``); a block with ``cross``
    attends to ``memory``, which it does not change.  Under a model mesh
    the cache and the memory are the rank's blocks, x the data shard's
    rows on every model rank: the attention combines the ranks' blocks,
    the SwiGLU psums its F-slices, the MoE runs its uncut branch (no
    router statistics: decode discards the aux loss)."""
    h, new_cache = attention.decode_step(
        p["attn"], attn_spec(cfg),
        layers.rmsnorm(p["ln_attn"], x, eps=cfg.norm_eps),
        cache["self"], position)
    x = x + h
    if "cross" in p:
        h, _ = attention.decode_step(
            p["cross"], attn_spec(cfg, cross=True),
            layers.rmsnorm(p["ln_cross"], x, eps=cfg.norm_eps),
            None, position, memory=memory)
        x = x + h
    normed = layers.rmsnorm(p["ln_mlp"], x, eps=cfg.norm_eps)
    if cfg.family == "moe":
        h, _ = moe.apply(p["moe"], moe_spec(cfg), normed, aux=False)
    else:
        h = layers.swiglu(p["mlp"], normed, d_ff=cfg.d_ff)
    return x + h, {"self": new_cache}


# ---------------------------------------------------------------------------
# encoder block (audio): pre-LayerNorm bidirectional self-attention (RoPE,
# no window) + GELU MLP

def encoder_attn_spec(cfg: ModelConfig) -> attention.AttentionSpec:
    return attn_spec(cfg, causal=False, sliding_window=None)


def init_encoder_block(gen, cfg: ModelConfig, *, stack: tuple = ()):
    dt, dev = cfg.param_dtype, gen.device
    return {
        "ln_attn": layers.layernorm_init(cfg.d_model, dtype=dt, device=dev,
                                         stack=stack),
        "attn": attention.init(gen, encoder_attn_spec(cfg), dtype=dt,
                               stack=stack),
        "ln_mlp": layers.layernorm_init(cfg.d_model, dtype=dt, device=dev,
                                        stack=stack),
        "mlp": layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt,
                                    stack=stack),
    }


def encoder_block(p, cfg: ModelConfig, x, *, plain: bool = False):
    """(x (B, S, D)) -> x: every frame attends to every frame."""
    x = x + attention.apply(
        p["attn"], encoder_attn_spec(cfg),
        layers.layernorm(p["ln_attn"], x, eps=cfg.norm_eps), plain=plain)
    return x + layers.gelu_mlp(
        p["mlp"], layers.layernorm(p["ln_mlp"], x, eps=cfg.norm_eps))


# ---------------------------------------------------------------------------
# rwkv block

def init_rwkv_block(gen, cfg: ModelConfig, *, stack: tuple = ()):
    dt, dev = cfg.param_dtype, gen.device
    p = rwkv.init(gen, rwkv_spec(cfg), dtype=dt, stack=stack)
    p["ln_tm"] = layers.layernorm_init(cfg.d_model, dtype=dt, device=dev,
                                       stack=stack)
    p["ln_cm"] = layers.layernorm_init(cfg.d_model, dtype=dt, device=dev,
                                       stack=stack)
    return p


def rwkv_block(p, cfg: ModelConfig, x, *, state=None):
    """state = (prev_tm, wkv, prev_cm), or None (a sequence's start).
    Returns (x, the new state)."""
    spec = rwkv_spec(cfg)
    prev_tm = wkv_state = prev_cm = None
    if state is not None:
        prev_tm, wkv_state, prev_cm = state
    h, (new_prev_tm, new_wkv) = rwkv.time_mix(
        p["time_mix"], spec, layers.layernorm(p["ln_tm"], x,
                                              eps=cfg.norm_eps),
        prev_token=prev_tm, wkv_state=wkv_state)
    x = x + h
    h, new_prev_cm = rwkv.channel_mix(
        p["channel_mix"], spec, layers.layernorm(p["ln_cm"], x,
                                                 eps=cfg.norm_eps),
        prev_token=prev_cm)
    return x + h, (new_prev_tm, new_wkv, new_prev_cm)


# ---------------------------------------------------------------------------
# mamba block (zamba2)

def init_mamba_block(gen, cfg: ModelConfig, *, stack: tuple = ()):
    p = mamba.init(gen, mamba_spec(cfg), dtype=cfg.param_dtype, stack=stack)
    p["ln"] = layers.rmsnorm_init(cfg.d_model, dtype=cfg.param_dtype,
                                  device=gen.device, stack=stack)
    return p


def mamba_block(p, cfg: ModelConfig, x, *, state=None):
    """state = (conv state, ssm state), or None (zeros).  Returns (x, the
    new state)."""
    conv_state = ssm_state = None
    if state is not None:
        conv_state, ssm_state = state
    h, new_state = mamba.apply(
        p, mamba_spec(cfg), layers.rmsnorm(p["ln"], x, eps=cfg.norm_eps),
        conv_state=conv_state, ssm_state=ssm_state)
    return x + h, new_state


def mamba_block_decode(p, cfg: ModelConfig, x, state):
    conv_state, ssm_state = state
    h, new_state = mamba.decode_step(
        p, mamba_spec(cfg), layers.rmsnorm(p["ln"], x, eps=cfg.norm_eps),
        conv_state, ssm_state)
    return x + h, new_state


# ---------------------------------------------------------------------------
# stack helper

def unstack(params_stack) -> list:
    """Every layer of stacked params (or stacked states), through one
    ``unbind`` a leaf: views, so an in-place write reaches the stack.  Its
    backward stacks the layers' gradients once, where indexing the stack
    layer by layer gives each layer's gradient a zero-filled copy of the
    whole stack (per worker under ``vmap``)."""
    leaves, spec = tree_flatten(params_stack)
    per_leaf = [torch.unbind(x) for x in leaves]
    return [tree_unflatten([u[i] for u in per_leaf], spec)
            for i in range(len(per_leaf[0]))]


class _Remat(torch.autograd.Function):
    """Activation rematerialization that ``torch.func`` accepts: the
    forward runs the block without recording and keeps only its inputs;
    the backward runs the block again and differentiates it (with
    ``torch.func.vjp`` under a transform, else plain autograd), one block's
    graph at a time.  ``generate_vmap_rule`` lets ``vmap`` batch the
    whole Function (the worker-mode ``per_worker_grads``, a ``vmap`` of
    ``grad``), where ``torch.utils.checkpoint``'s saved-tensor hooks are
    refused.

    ``apply(call, *tensors)``: ``call`` (a ``_RematCall``) rebuilds the
    block's arguments from the tensors and records the structure of its
    outputs; the Function returns the output tensors."""

    generate_vmap_rule = True

    @staticmethod
    def forward(call, *tensors):
        return call.run(tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        call, *tensors = inputs
        ctx.call = call
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        if _grad_levels() > 1:
            raise NotImplementedError(
                "remat supports first-order gradients only: its backward "
                "returns gradients with no graph of their own")
        call = ctx.call
        tensors = ctx.saved_tensors
        wrt = [i for i, t in enumerate(tensors) if t.is_floating_point()]
        with torch.enable_grad():
            if _under_torch_func():
                def f(*diff):
                    full = list(tensors)
                    for i, t in zip(wrt, diff):
                        full[i] = t
                    return call.run(full)

                _, vjp = torch.func.vjp(f, *(tensors[i] for i in wrt))
                # the enclosing grad transform differentiates with
                # create_graph, so the gradients come back carrying the
                # recomputed block's graph: detached, that graph is freed
                # here (else every block's activations stay alive to the
                # end of the backward, and remat saves nothing); the values
                # are the ones the block without remat gets
                got = [g.detach() for g in vjp(tuple(grads))]
            else:
                # plain autograd, as the block without remat differentiates
                # (matmul picks its backward's summation order by whether
                # its operands require grad, which functorch's wrappers
                # would change)
                full = [t.detach().requires_grad_(True) if i in wrt
                        else t for i, t in enumerate(tensors)]
                outs = call.run(full)
                live = [(o, g) for o, g in zip(outs, grads)
                        if o.requires_grad]
                got = torch.autograd.grad(
                    [o for o, _ in live], [full[i] for i in wrt],
                    [g for _, g in live], allow_unused=True)
        out = [None] * len(tensors)
        for i, g in zip(wrt, got):
            out[i] = g
        return (None, *out)


def _under_torch_func() -> bool:
    """True inside a ``torch.func`` transform (vmap, grad, ...)."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _grad_levels() -> int:
    """How many derivatives are being taken through a backward that runs
    now: the ``torch.func`` grad levels on the interpreter stack, or on
    plain autograd 1, 2 where the backward records (``create_graph``)."""
    stack = torch._C._functorch.get_interpreter_stack()
    if stack:
        return sum(i.key() == torch._C._functorch.TransformType.Grad
                   for i in stack)
    return 1 + torch.is_grad_enabled()


class _RematCall:
    """The block and the structure of its arguments and outputs: the
    tensor leaves pass through ``_Remat``, every other leaf (``None``
    states, a dense block's ``0.0`` aux) is kept here as it was.  The
    block runs in a copy of the context it was called in, the recompute
    too.  The
    output structure is recorded from the forward without its tensors:
    the Function's context keeps this object until the whole backward
    ends, and the backward's recomputed outputs, held here, would keep
    their block's recomputed graph alive that long."""

    def __init__(self, fn, args):
        leaves, self.in_spec = tree_flatten(args)
        self.fn = fn
        # the ambient context of the forward (the model mesh, deferred
        # entry sums): the backward's recompute may run on the autograd
        # engine's device thread, which sees none of it
        self.context = contextvars.copy_context()
        self.in_leaves = leaves
        self.in_slots = [i for i, x in enumerate(leaves)
                         if isinstance(x, torch.Tensor)]
        self.out_spec = self.out_consts = self.out_slots = None

    def tensors(self):
        return [self.in_leaves[i] for i in self.in_slots]

    def run(self, tensors):
        leaves = list(self.in_leaves)
        for i, t in zip(self.in_slots, tensors):
            leaves[i] = t
        out_leaves, spec = tree_flatten(self.context.run(
            self.fn, *tree_unflatten(leaves, self.in_spec)))
        slots = [i for i, x in enumerate(out_leaves)
                 if isinstance(x, torch.Tensor)]
        if self.out_spec is None:
            self.out_spec, self.out_slots = spec, slots
            self.out_consts = [None if i in slots else x
                               for i, x in enumerate(out_leaves)]
        return tuple(out_leaves[i] for i in slots)

    def rebuild(self, tensors):
        leaves = list(self.out_consts)
        for i, t in zip(self.out_slots, tensors):
            leaves[i] = t
        return tree_unflatten(leaves, self.out_spec)


def maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under activation rematerialization when ``cfg.remat``: the
    reference's ``jax.checkpoint`` as ``_Remat``, which saves the block's
    inputs and recomputes the block in the backward, on plain autograd
    (the group-mode step) and under ``torch.func`` transforms (the
    worker-mode ``per_worker_grads``) alike.  Remat changes memory, not
    numbers, so it applies only where autograd records (never under
    ``no_grad``, as in prefill).  First-order gradients only: a second
    derivative through a remat'd block (``grad`` of ``grad``, a backward
    with ``create_graph``) raises ``NotImplementedError``."""
    if not cfg.remat:
        return fn

    def remat_fn(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        call = _RematCall(fn, args)
        return call.rebuild(_Remat.apply(call, *call.tensors()))

    return remat_fn
