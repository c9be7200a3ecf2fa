"""The language model: init / forward / prefill / decode (port of
``repro.models.model``: the dense and MoE decoders, the vlm decoder (the
patch embeddings ahead of the tokens), the audio encoder-decoder (an
encoder over the frame embeddings, its output the memory of every decoder
layer's cross-attention), the RWKV6 stack (ssm) and Zamba2 (hybrid:
groups of Mamba2 blocks, each group after one application of a shared
attention block)).

Batch formats (one worker's shard, as in the reference):

  train:   {"tokens": (B, T) int, "labels": (B, T) int}
           + vlm: {"patches": (B, P, D)}   + audio: {"frames": (B, S, D)}
  prefill: the same without "labels"
  decode:  tokens (B, 1) int, positions (B,) int, state dict

The reference scans the layer stack; here a Python loop walks the stacked
params (``blocks.unstack``, whose backward stacks the layers' gradients
once), each block under ``blocks.maybe_remat``.
``loss_fn`` trains through the plain attention core (``plain=True``), as
the reference trains through its jnp core: the flash kernel has no
backward.  ``forward`` sums the blocks' aux losses (the MoE router's,
float32) in layer order, and ``loss_fn`` returns ``ce + aux``.  ``init``
and ``init_decode_state`` are entry points: ``device=None`` means the
CUDA card and raises without one.  Decode states are updated in place.

Under a model mesh (``meshctx.set_mesh``) ``forward``, ``loss_fn`` and
``prefill`` take the rank's block (``launch.sharding.local_batch``):

* dense, MoE: tokens (B/data, T/model), the residual stream staying
  (B/data, T/model, D) between the sequence-parallel regions;
* audio: the same, and the frames (B/data, S/model, D) through the
  encoder's sequence-parallel layers, its output all-gathered over
  ``model`` once a forward into the (B/data, S, D) memory every decoder
  layer's cross-attention reads;
* vlm: the patches and tokens of the data shard whole, joined, and the
  rank's block of the joined (P + T) stream cut from them; the rank's
  labels and hidden states are the text positions in its block (none on a
  rank whose block holds only patches);
* RWKV6 (ssm) and Zamba2 (hybrid): tokens (B/data, T), the stream the
  same on every model rank, the WKV head-sharded inside its region, the
  Mamba2 blocks channel-parallel (``mamba.apply``), and Zamba2's shared
  block on the rank's T block of the stream, gathered back after it.

A stream that every model rank holds whole is its copies: the loss counts
each rank's tokens, and a value's gradient is the sum of its copies'
cotangents (the slice into a T block and the gather out of it, the WKV's
heads, the Mamba2 psums keep that).  Params are the rank's layout
(``launch.sharding.local_params``); each leaf enters through
``meshctx.pvary`` over the axes it is replicated on, so its gradient
comes back summed over them (the transpose shard_map takes at a
replicated input), but where a region sums it itself (the SwiGLU
region's data-axis psum, the expert weights' FSDP gather) or it is cut
(Mamba2's channel TP).  Under ``meshctx.param_sums_deferred`` the leaves
enter as they are, and their gradients come back as the rank's partials:
the trainer's storage layout takes those sums (``launch.sharding``,
``_grad_sum_axes`` naming them).  ``loss_fn`` psums its token sums and
counts over every axis in rank order: every rank returns the global
mean.  Decode under a mesh, and attention below the sequence-parallel
threshold, are ROADMAP Queue 1 item 16.15.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks, layers, mamba, meshctx, moe


# ---------------------------------------------------------------------------
# init

def init(seed: int, cfg: ModelConfig, *, device=None):
    """Random params from ``seed``, drawn leaf by leaf on the device (a
    float32 scratch of the largest leaf at a time) and stored in
    ``cfg.param_dtype`` (the MoE router and Mamba2's ``A_log``,
    ``dt_bias`` and ``D`` in float32).  The layouts are the reference's:
    ``layers`` stacked (L, ...) for the decoders and RWKV6 (the audio
    decoder's with ``ln_cross`` and ``cross``, beside ``encoder`` stacked
    (encoder_layers, ...) and the encoder's final LayerNorm ``enc_ln``);
    for Zamba2 ``mamba`` stacked (groups, per, ...) and one unstacked
    ``shared`` decoder block."""
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
    # each leaf drawn whole with its leading layer axes (the reference
    # vmaps the init over split keys)
    if cfg.family == "ssm":
        params["layers"] = blocks.init_rwkv_block(gen, cfg,
                                                  stack=(cfg.num_layers,))
    elif cfg.family == "hybrid":
        params["mamba"] = blocks.init_mamba_block(
            gen, cfg, stack=_hybrid_shape(cfg))
        params["shared"] = blocks.init_decoder_block(gen, cfg)
    elif cfg.family == "audio":
        params["layers"] = blocks.init_decoder_block(
            gen, cfg, stack=(cfg.num_layers,), cross=True)
        params["encoder"] = blocks.init_encoder_block(
            gen, cfg, stack=(cfg.encoder_layers,))
        params["enc_ln"] = layers.layernorm_init(cfg.d_model, dtype=dt,
                                                 device=dev)
    else:
        params["layers"] = blocks.init_decoder_block(
            gen, cfg, stack=(cfg.num_layers,))
    return params


def _hybrid_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, Mamba2 blocks a group): one shared-block application a
    group."""
    every = cfg.shared_attn_every or cfg.num_layers
    if cfg.num_layers % every != 0:
        raise ValueError("num_layers must be divisible by shared_attn_every")
    return cfg.num_layers // every, every


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


def _run_encoder(params, cfg: ModelConfig, frames, *, plain):
    """The audio encoder over ``frames`` (B, S, D), then its LayerNorm:
    the decoder's memory (B, S, D) in ``cfg.dtype``."""
    x = frames.to(cfg.dtype)
    block = blocks.maybe_remat(
        lambda p, h: blocks.encoder_block(p, cfg, h, plain=plain), cfg)
    for p in blocks.unstack(params["encoder"]):
        x = block(p, x)
    return layers.layernorm(params["enc_ln"], x, eps=cfg.norm_eps)


def _run_decoder_stack(params_stack, cfg: ModelConfig, x, *, plain,
                       memory=None):
    """The decoder stack -> (x, the blocks' aux summed).  ``memory`` is an
    argument of the remat'd block, not closed over, so its gradient
    reaches the encoder."""
    block = blocks.maybe_remat(
        lambda p, h, mem: blocks.decoder_block(p, cfg, h, memory=mem,
                                               plain=plain), cfg)
    aux = 0.0
    for p in blocks.unstack(params_stack):
        x, a = block(p, x, memory)
        aux = aux + a
    return x, aux


def _run_rwkv_stack(params_stack, cfg: ModelConfig, x, *, states=None):
    """The RWKV6 stack from zero states (train / prefill: remat applies),
    or from ``states`` (``decode_step``'s, stacked (L, ...) as
    ``init_decode_state`` makes them), then -> (x, the new states
    stacked)."""
    if states is None:
        block = blocks.maybe_remat(
            lambda p, h: blocks.rwkv_block(p, cfg, h)[0], cfg)
        for p in blocks.unstack(params_stack):
            x = block(p, x)
        return x, None
    new = []
    for i, p in enumerate(blocks.unstack(params_stack)):
        x, s = blocks.rwkv_block(p, cfg, x,
                                 state=tuple(t[i] for t in states))
        new.append(s)
    return x, tuple(torch.stack(ts) for ts in zip(*new))


def _run_hybrid_stack(params, cfg: ModelConfig, x, *, plain, states=None):
    """Zamba2: [the shared block, then ``per`` Mamba2 blocks] x groups,
    each Mamba2 block from zero states.  The shared block's params are an
    argument of its remat, so its gradient reaches them."""
    if states is not None:
        raise NotImplementedError(
            "full-seq hybrid with states: use decode path")
    shared_fn = blocks.maybe_remat(
        lambda p, h: blocks.decoder_block(p, cfg, h, plain=plain)[0], cfg)
    mamba_fn = blocks.maybe_remat(
        lambda p, h: blocks.mamba_block(p, cfg, h)[0], cfg)
    mesh = meshctx.current_mesh()
    for group in blocks.unstack(params["mamba"]):
        if mesh is None:
            x = shared_fn(params["shared"], x)
        else:
            # the shared block sequence-parallel on the rank's T block of
            # the stream every model rank holds whole, gathered back after
            t = x.shape[1] // meshctx.model_size(mesh)
            blk = x.narrow(1, meshctx.axis_index("model") * t, t)
            x = meshctx.all_gather(shared_fn(params["shared"], blk),
                                   "model", 1, mesh=mesh)
        for p in blocks.unstack(group):
            x = mamba_fn(p, x)
    return x, None


_SWIGLU = ("w_gate", "w_up", "w_down")
# the families whose batch is cut over model in T as their stream is
# (ssm and hybrid hold the whole T on every model rank, vlm cuts its block
# from the joined patches and tokens)
T_CUT_FAMILIES = ("dense", "moe", "audio")


def stream_shape(cfg: ModelConfig, batch, mesh) -> tuple[int, int]:
    """The global (B, T) of the residual stream from a rank's block of the
    batch (``launch.sharding.local_batch``): the tokens' rows over the
    data axes; T over ``model`` (dense, MoE, audio), whole (ssm, hybrid),
    or the patches and tokens joined (vlm)."""
    B = batch["tokens"].shape[0] * meshctx.data_size(mesh)
    T = batch["tokens"].shape[1]
    if cfg.family == "vlm":
        T += batch["patches"].shape[1]
    elif cfg.family in T_CUT_FAMILIES:
        T *= meshctx.model_size(mesh)
    return B, T


def _grad_sum_axes(path, cfg: ModelConfig, mesh, batch: int, seq: int):
    """The axes a leaf's gradient is summed over on entering the mesh
    path: those it is replicated on, less those a region sums over or
    cuts it on."""
    every = meshctx.all_axes(mesh)
    name = path[-1]
    if "moe" in path and name in _SWIGLU:
        # E over model; the FSDP gather's transpose sums over data
        _, _, fsdp_ok = moe.fsdp_layout(blocks.moe_spec(cfg), mesh)
        return () if fsdp_ok else meshctx.data_axes(mesh)
    if "mlp" in path and name in _SWIGLU and layers.swiglu_region_applies(
            mesh, batch, seq, cfg.d_ff):
        return ()            # F over model; the region psums over data
    if path[0] == "mamba" and mamba.tp_dim(path) is not None \
            and mamba.tp_applies(mesh, blocks.mamba_spec(cfg)):
        return meshctx.data_axes(mesh)         # Din or H over model
    return every


def _enter_mesh(params, cfg: ModelConfig, batch, mesh):
    """Check that the mesh path takes (cfg, batch) and put every leaf
    through ``meshctx.pvary`` over its ``_grad_sum_axes``."""
    B, T = stream_shape(cfg, batch, mesh)
    seqs = {"tokens": T}
    if cfg.family == "audio":
        seqs["frames"] = batch["frames"].shape[1] * meshctx.model_size(mesh)
    if cfg.family != "ssm":
        for what, seq in seqs.items():
            if not meshctx.sp_applicable(mesh, B, seq):
                raise NotImplementedError(
                    f"{what} (B, T) = {(B, seq)} under the mesh "
                    f"{mesh.shape}: only the sequence-parallel layout is "
                    "ported (T >= 16 model ranks; ROADMAP Queue 1 item "
                    "16.15)")

    def enter(node, path):
        if isinstance(node, dict):
            return {k: enter(v, path + (k,)) for k, v in node.items()}
        axes = _grad_sum_axes(path, cfg, mesh, B, T)
        return meshctx.pvary(node, axes, mesh=mesh) if axes else node

    if meshctx.param_sums_are_deferred():
        return params
    return enter(params, ())


def forward(params, cfg: ModelConfig, batch, *, plain: bool = False):
    """Full-sequence hidden states (B, T, D) of the text positions + aux
    loss (a float32 scalar for MoE, 0.0 for the others).  ``plain=True``
    keeps the attention core off the CUDA kernel.  Under remat the block
    returns its aux beside h, so the router's loss survives
    rematerialization.  Under a model mesh: the rank's block (module
    docstring)."""
    blocks.require_ported(cfg)
    mesh = meshctx.current_mesh()
    if mesh is not None:
        params = _enter_mesh(params, cfg, batch, mesh)
    return _forward(params, cfg, batch, plain=plain)


def _vlm_block(batch, mesh) -> tuple[slice, slice]:
    """vlm: the patches and the text positions in the rank's block of the
    joined (P + T) stream (all of them without a mesh)."""
    P, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    if mesh is None:
        return slice(0, P), slice(0, T)
    t = (P + T) // meshctx.model_size(mesh)
    lo = meshctx.axis_index("model") * t
    return (slice(min(lo, P), min(lo + t, P)),
            slice(min(max(lo - P, 0), T), min(max(lo + t - P, 0), T)))


def _vlm_stream(params, cfg: ModelConfig, batch, mesh):
    """vlm: the patches ahead of the token embeddings, or under a mesh the
    rank's block of that joined stream -> (x, where its text starts)."""
    patches, text = _vlm_block(batch, mesh)
    x = _embed(params, cfg, batch["tokens"][:, text])
    p = batch["patches"][:, patches].to(cfg.dtype)
    return torch.cat([p, x], dim=1), p.shape[1]


def _forward(params, cfg: ModelConfig, batch, *, plain: bool):
    mesh = meshctx.current_mesh()
    if cfg.family == "vlm":
        x, start = _vlm_stream(params, cfg, batch, mesh)
    else:
        x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "ssm":
        x, _ = _run_rwkv_stack(params["layers"], cfg, x)
        aux = 0.0
    elif cfg.family == "hybrid":
        x, _ = _run_hybrid_stack(params, cfg, x, plain=plain)
        aux = 0.0
    elif cfg.family == "audio":
        memory = _run_encoder(params, cfg, batch["frames"], plain=plain)
        if mesh is not None:
            # the encoder's S blocks joined once a forward: every decoder
            # layer's cross-attention reads the whole memory; the gather's
            # transpose sums the layers' memory gradients over model once
            memory = meshctx.all_gather(memory, "model", 1, mesh=mesh)
        x, aux = _run_decoder_stack(params["layers"], cfg, x, plain=plain,
                                    memory=memory)
    else:
        x, aux = _run_decoder_stack(params["layers"], cfg, x, plain=plain)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    if cfg.family == "vlm":
        h = h[:, start:]                          # the text positions
    return h, aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross entropy + the aux loss (the MoE router's, 0
    for dense), through the plain attention core on every device.  Under
    a model mesh the token sums and counts are psum'd over every axis in
    rank order, so every rank returns the global mean."""
    blocks.require_ported(cfg)
    mesh = meshctx.current_mesh()
    if mesh is None:
        h, aux = _forward(params, cfg, batch, plain=True)
        ce = layers.cross_entropy_loss(_unembed_fn(params, cfg), h,
                                       batch["labels"],
                                       vocab_chunk=cfg.loss_chunk)
        return ce + aux
    params = _enter_mesh(params, cfg, batch, mesh)
    h, aux = _forward(params, cfg, batch, plain=True)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = labels[:, _vlm_block(batch, mesh)[1]]
    total, count = layers.cross_entropy_sums(
        _unembed_fn(params, cfg), h, labels, vocab_chunk=cfg.loss_chunk)
    # the token sum and count in one collective
    total, count = meshctx.psum(torch.stack([total, count.to(total.dtype)]),
                                meshctx.all_axes(mesh), mesh=mesh).unbind(0)
    return total / torch.clamp(count, min=1.0) + aux


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
    """The decode state against a ``max_len`` context.  Decoders: the KV
    cache {"cache": {"self": {"k", "v"}}}, each (L, B, phys, KV, hd) with
    phys = min(max_len, window) (a ring buffer under a window).  RWKV6:
    {"states": (prev_tm (L, B, D), wkv (L, B, H, hd, hd) float32, prev_cm
    (L, B, D))}.  Zamba2: {"conv": {"x", "B", "C"} (groups, per, B, K-1,
    C), "ssm": (groups, per, B, H, P, N) float32, "attn": {"k", "v"}
    (groups, B, max_len, KV, hd)}.  O(1) in context but for the caches."""
    blocks.require_ported(cfg)
    dev = _device.enter(device)
    if cfg.family == "ssm":
        spec = blocks.rwkv_spec(cfg)
        L, D = cfg.num_layers, cfg.d_model
        H, hd = spec.num_heads, spec.head_dim
        return {"states": (
            torch.zeros((L, batch, D), dtype=cfg.dtype, device=dev),
            torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                        device=dev),
            torch.zeros((L, batch, D), dtype=cfg.dtype, device=dev))}
    shape = attention.cache_shape(blocks.attn_spec(cfg), batch, max_len)
    if cfg.family == "hybrid":
        groups, per = _hybrid_shape(cfg)
        conv, ssm = mamba.init_states(blocks.mamba_spec(cfg), batch,
                                      dtype=cfg.dtype, device=dev,
                                      stack=(groups, per))
        full = (groups, *shape)
        return {"conv": conv, "ssm": ssm, "attn": {
            "k": torch.zeros(full, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(full, dtype=cfg.dtype, device=dev)}}
    full = (cfg.num_layers, *shape)
    state = {"cache": {"self": {
        "k": torch.zeros(full, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(full, dtype=cfg.dtype, device=dev)}}}
    if cfg.family == "audio":
        enc_len = min(max(max_len // cfg.encoder_seq_divisor, 1), 8192)
        state["memory"] = torch.zeros((batch, enc_len, cfg.d_model),
                                      dtype=cfg.dtype, device=dev)
    return state


def _write(dst, src):
    """Copy a tree of new states into the state tensors in place."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    else:
        dst.copy_(src)


def decode_step(params, cfg: ModelConfig, state, tokens, positions):
    """One decode step.  tokens (B, 1), positions (B,).  Returns (logits
    (B, 1, V), state); the state is updated in place (RWKV6's after the
    stack, from the stacked new states; the others layer by layer)."""
    blocks.require_ported(cfg)
    if meshctx.current_mesh() is not None:
        raise NotImplementedError(
            "decode under a model mesh, its caches sharded over model: "
            "ROADMAP Queue 1 item 16.15")
    x = _embed(params, cfg, tokens)
    if cfg.family == "ssm":
        x, new = _run_rwkv_stack(params["layers"], cfg, x,
                                 states=state["states"])
        _write(state["states"], new)
    elif cfg.family == "hybrid":
        caches = blocks.unstack(state["attn"])
        convs = blocks.unstack(state["conv"])
        for g, group in enumerate(blocks.unstack(params["mamba"])):
            x, _ = blocks.decoder_block_decode(
                params["shared"], cfg, x, {"self": caches[g]}, positions)
            conv_g = blocks.unstack(convs[g])
            for j, p in enumerate(blocks.unstack(group)):
                ssm = state["ssm"][g, j]
                x, (new_conv, new_ssm) = blocks.mamba_block_decode(
                    p, cfg, x, (conv_g[j], ssm))
                _write(conv_g[j], new_conv)
                ssm.copy_(new_ssm)
    else:
        memory = state.get("memory")
        for p, cache in zip(blocks.unstack(params["layers"]),
                            blocks.unstack(state["cache"])):
            x, _ = blocks.decoder_block_decode(p, cfg, x, cache, positions,
                                               memory=memory)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return _unembed_fn(params, cfg)(h), state
