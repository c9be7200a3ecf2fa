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
``prefill`` take the rank's block (``launch.sharding.local_batch``, a
``meshctx.Block`` that records which leaves it cut in T: the layout is
read from that record, never guessed from a shape):

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

Below the sequence-parallel threshold (``meshctx.sp_applicable`` fails:
T < 16 |model|, or T % |model| != 0) every family's stream is the data
shard's rows with T whole on every model rank, as the reference's dense
fallback computes it: ``_forward`` says so to the regions through
``meshctx.stream_layout`` (attention's dense path, on CUDA the flash
kernel's full launch; the SwiGLU's F-slices psum'd; the MoE's uncut
branch), and Zamba2's shared block runs on the whole stream.  Decode
(``decode_step``) takes the rank's rows and its block of the decode state
(``launch.sharding.local_decode_state``).  Rows the data axes do not
divide are whole on every data rank (the reference's ``serve_batch_spec``
``(None,)``): the stream is then below the threshold whatever T is
(``sp_applicable`` needs B % data == 0), every rank computes the whole
batch as one process does, and the block records it (``Block.rows_whole``:
``stream_shape`` reads the rows as the whole batch's).  Such a block
serves; the loss refuses it (a train batch's rows are cut).

A stream that every model rank holds whole is its copies: the loss counts
each rank's tokens, and a value's gradient is the sum of its copies'
cotangents (the slice into a T block and the gather out of it, the WKV's
heads, the Mamba2 and SwiGLU psums keep that).  Params are the rank's
layout (``launch.sharding.local_params``); each leaf enters through
``meshctx.pvary`` over the axes it is replicated on, so its gradient
comes back summed over them (the transpose shard_map takes at a
replicated input), but where a region sums it itself (the SwiGLU
region's data-axis psum, the expert weights' FSDP gather) or it is cut
(the SwiGLU's F, Mamba2's channel TP).  Under
``meshctx.param_sums_deferred`` the leaves enter as they are, and their
gradients come back as the rank's partials: the trainer's storage layout
takes those sums (``launch.sharding``, ``_grad_sum_axes`` naming them).
``loss_fn`` psums its token sums and counts over every axis in rank
order: every rank returns the global mean.
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


def _run_hybrid_stack(params, cfg: ModelConfig, x, *, plain, states=None,
                      sp: bool = False):
    """Zamba2: [the shared block, then ``per`` Mamba2 blocks] x groups,
    each Mamba2 block from zero states.  The shared block's params are an
    argument of its remat, so its gradient reaches them.  Under a mesh
    ``sp`` says whether the stream (whole on every model rank) passes the
    sequence-parallel threshold."""
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
        elif sp:
            # the shared block sequence-parallel on the rank's T block of
            # the stream every model rank holds whole, gathered back after
            t = x.shape[1] // meshctx.model_size(mesh)
            blk = x.narrow(1, meshctx.axis_index("model") * t, t)
            with meshctx.stream_layout(True):
                blk = shared_fn(params["shared"], blk)
            x = meshctx.all_gather(blk, "model", 1, mesh=mesh)
        else:
            # below the threshold: on the whole stream, as every model
            # rank holds it
            with meshctx.stream_layout(False):
                x = shared_fn(params["shared"], x)
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
    data axes, or the whole batch where the block records its rows whole;
    T over ``model`` where the block records its tokens cut (dense, MoE,
    audio above the threshold), else whole (below it, ssm, hybrid), or
    the patches and tokens joined (vlm)."""
    B = batch["tokens"].shape[0]
    if not _rows_whole(batch):
        B *= meshctx.data_size(mesh)
    t = batch["tokens"].shape[1]
    if cfg.family == "vlm":
        return B, t + batch["patches"].shape[1]
    if _seq_cut(cfg, batch, "tokens"):
        t *= meshctx.model_size(mesh)
    return B, t


def _rows_whole(batch) -> bool:
    """Whether a rank's block holds the whole batch's rows (rows the data
    axes do not divide, as ``launch.sharding.local_batch`` records it),
    not the data shard's."""
    return isinstance(batch, meshctx.Block) and batch.rows_whole


def _seq_cut(cfg: ModelConfig, batch, name: str) -> bool:
    """Whether the rank's block holds leaf ``name`` cut over ``model`` in
    its sequence dim, as the block records it (``meshctx.Block``): a dense,
    MoE or audio block of 16 or more positions has the same shape cut
    (above the threshold) or whole (below it), so under a mesh their
    batch must be a ``launch.sharding.local_batch`` block."""
    if cfg.family not in T_CUT_FAMILIES:
        return False
    if not isinstance(batch, meshctx.Block):
        raise TypeError(
            f"under a model mesh a batch of the {cfg.family} family is the "
            "rank's block from launch.sharding.local_batch (a "
            "meshctx.Block, which records whether its sequence is cut over "
            "model)")
    return name in batch.cut


def sequence_parallel(cfg: ModelConfig, batch, mesh) -> bool:
    """Whether the forward is sequence-parallel: the decoder's stream cut
    over ``model`` in T as the block records it (dense, MoE, audio), or
    where the global stream passes the threshold (vlm, which cuts its
    block from the whole patches and tokens; Zamba2, whose shared block
    runs on its T block of the whole stream).  RWKV6's never is."""
    if mesh is None or cfg.family == "ssm":
        return False
    if cfg.family in T_CUT_FAMILIES:
        return _seq_cut(cfg, batch, "tokens")
    return meshctx.sp_applicable(mesh, *stream_shape(cfg, batch, mesh))


def _grad_sum_axes(path, cfg: ModelConfig, mesh, batch: int, seq: int,
                   leaf=None):
    """The axes a leaf's gradient is summed over on entering the mesh
    path: those it is replicated on, less those a region sums over or
    cuts it on.  ``leaf`` (the rank's block) tells an expert leaf's
    serve layout from its compute layout (the compute layout without
    it)."""
    every = meshctx.all_axes(mesh)
    name = path[-1]
    if "moe" in path and name in _SWIGLU:
        # E over model; a cut FSDP dim's gather sums over data in its
        # transpose
        spec = blocks.moe_spec(cfg)
        cut = moe.fsdp_layout(spec, mesh)[2] if leaf is None \
            else moe.fsdp_cut(spec, leaf, name, mesh)
        return () if cut else meshctx.data_axes(mesh)
    if "mlp" in path and name in _SWIGLU \
            and cfg.d_ff % meshctx.model_size(mesh) == 0:
        # F over model: the region psums over data; off it, the slices'
        # gradients are summed over the data axes
        return () if layers.swiglu_region_applies(
            mesh, batch, seq, cfg.d_ff) else meshctx.data_axes(mesh)
    if path[0] == "mamba" and mamba.tp_dim(path) is not None \
            and mamba.tp_applies(mesh, blocks.mamba_spec(cfg)):
        return meshctx.data_axes(mesh)         # Din or H over model
    return every


def _enter_mesh(params, cfg: ModelConfig, batch, mesh):
    """Put every leaf through ``meshctx.pvary`` over its
    ``_grad_sum_axes`` for the stream of ``batch``: sequence-parallel, or
    below the threshold the data shard's rows with T whole (the copies on
    the model ranks sum their cotangents through the same entries)."""
    B, T = stream_shape(cfg, batch, mesh)

    def enter(node, path):
        if isinstance(node, dict):
            return {k: enter(v, path + (k,)) for k, v in node.items()}
        axes = _grad_sum_axes(path, cfg, mesh, B, T, node)
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


def _vlm_block(batch, mesh, cut: bool) -> tuple[slice, slice]:
    """vlm: the patches and the text positions in the rank's block of the
    joined (P + T) stream (all of them where the stream is not ``cut``)."""
    P, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    if not cut:
        return slice(0, P), slice(0, T)
    t = (P + T) // meshctx.model_size(mesh)
    lo = meshctx.axis_index("model") * t
    return (slice(min(lo, P), min(lo + t, P)),
            slice(min(max(lo - P, 0), T), min(max(lo + t - P, 0), T)))


def _vlm_stream(params, cfg: ModelConfig, batch, mesh, cut: bool):
    """vlm: the patches ahead of the token embeddings, or under a mesh the
    rank's block of that joined stream -> (x, where its text starts)."""
    patches, text = _vlm_block(batch, mesh, cut)
    x = _embed(params, cfg, batch["tokens"][:, text])
    p = batch["patches"][:, patches].to(cfg.dtype)
    return torch.cat([p, x], dim=1), p.shape[1]


def _forward(params, cfg: ModelConfig, batch, *, plain: bool):
    mesh = meshctx.current_mesh()
    # the decoder stream is cut over model in T (the dense, MoE, audio and
    # vlm families, sequence-parallel), or whole (below the threshold; and
    # Zamba2's, whose shared block cuts its own T block)
    cut = sequence_parallel(cfg, batch, mesh)
    if cfg.family == "vlm":
        x, start = _vlm_stream(params, cfg, batch, mesh, cut)
    else:
        x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "ssm":
        x, _ = _run_rwkv_stack(params["layers"], cfg, x)
        aux = 0.0
    elif cfg.family == "hybrid":
        x, _ = _run_hybrid_stack(params, cfg, x, plain=plain, sp=cut)
        aux = 0.0
    elif cfg.family == "audio":
        frames_cut = mesh is not None and _seq_cut(cfg, batch, "frames")
        with meshctx.stream_layout(frames_cut):
            memory = _run_encoder(params, cfg, batch["frames"], plain=plain)
        if frames_cut:
            # the encoder's S blocks joined once a forward: every decoder
            # layer's cross-attention reads the whole memory; the gather's
            # transpose sums the layers' memory gradients over model once
            memory = meshctx.all_gather(memory, "model", 1, mesh=mesh)
        with meshctx.stream_layout(cut):
            x, aux = _run_decoder_stack(params["layers"], cfg, x,
                                        plain=plain, memory=memory)
    else:
        with meshctx.stream_layout(cut):
            x, aux = _run_decoder_stack(params["layers"], cfg, x,
                                        plain=plain)
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
    if _rows_whole(batch):
        raise NotImplementedError(
            "a loss on rows whole on every data rank: the reference's "
            "train_batch_spec cuts a train batch's rows over the data axes "
            "(launch.sharding.local_train_batch); whole rows serve")
    params = _enter_mesh(params, cfg, batch, mesh)
    h, aux = _forward(params, cfg, batch, plain=True)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = labels[:, _vlm_block(batch, mesh,
                                      sequence_parallel(cfg, batch,
                                                        mesh))[1]]
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
    stack, from the stacked new states; the others layer by layer).

    Under a model mesh tokens and positions are the data shard's rows,
    ``params`` the rank's (``launch.sharding.local_params``) and ``state``
    the rank's block of the global state (``launch.sharding
    .local_decode_state``): the KV caches' slots and the audio memory's S
    over ``model`` (``attention.decode_step`` combines the ranks'
    blocks), RWKV6's token shifts on D/|model| channels (gathered whole
    for the step, the rank's block written back) and its WKV state on its
    heads, Zamba2's conv and SSM states on its channels and heads
    (``mamba.decode_step``).  The stream is the rows' whole on every model
    rank, and so are the logits."""
    blocks.require_ported(cfg)
    mesh = meshctx.current_mesh()
    with meshctx.stream_layout(False):
        x = _decode_stack(params, cfg, state, positions,
                          _embed(params, cfg, tokens), mesh)
    h = layers.rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    return _unembed_fn(params, cfg)(h), state


def _decode_stack(params, cfg: ModelConfig, state, positions, x, mesh):
    """The decode step's blocks on the embedded tokens ``x``: the stream
    after them; the state written in place."""
    if cfg.family == "ssm":
        prev_tm, wkv, prev_cm = state["states"]
        if mesh is not None:
            # the token shifts' D blocks of every layer gathered in one
            # collective: the lerps and projections take the whole x
            prev_tm, prev_cm = meshctx.all_gather_many(
                [prev_tm, prev_cm], "model", -1, mesh=mesh)
        x, new = _run_rwkv_stack(params["layers"], cfg, x,
                                 states=(prev_tm, wkv, prev_cm))
        if mesh is not None:
            d = state["states"][0].shape[-1]
            lo = meshctx.axis_index("model") * d
            new = (new[0][..., lo:lo + d], new[1], new[2][..., lo:lo + d])
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
    return x

