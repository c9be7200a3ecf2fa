"""Grouped-query attention (port of ``repro.models.attention``).

GQA (num_kv_heads <= num_heads), optional QKV bias (Qwen2), optional q/k
RMSNorm (Qwen3), RoPE, causal masking, sliding-window attention (H2O
Danube3), bidirectional attention (the audio encoder), cross-attention
over an encoder memory (SeamlessM4T's decoder: no RoPE, no mask, no
window) and a single-token decode path against a KV cache.

The score/softmax/value computation is ``attention_core``, the flash
kernel's oracle (``kernels/attention/ref.py``).  ``apply`` on CPU tensors
follows the reference line for line (``attention_core``, or, for
self-attention, ``attention_core_blocked`` above
``BLOCKED_ATTENTION_THRESHOLD`` query positions); on CUDA tensors the
core goes through the CUDA kernel (``kernels.attention.ops.attention``;
causal or not, Tq = Tk or not), unless the caller asks for the plain path
with ``plain=True``.  The decode step has no kernel in the reference and
stays plain PyTorch; its cross-attention projects K and V from the memory
at every step, as the reference's does, and caches nothing.

Under a model mesh (``meshctx.set_mesh``) ``apply`` runs
``apply_sequence_parallel`` on the rank's block of a sequence-parallel
stream: its queries at their global positions, k and v projected from
its block and all-gathered over ``model``, the core through the flash
kernel at that query offset on CUDA (one launch), the plain online
softmax over kv blocks on the CPU and with ``plain=True``.  Below the
threshold the stream is the data shard's rows with T whole, and the
dense path runs on them (the flash kernel's full launch on CUDA).  The
decode step scores the rank's block of the KV cache (or of the encoder
memory) and combines the blocks' softmax parts over ``model``
(``meshctx.softmax_combine``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers, meshctx

# sentinel position of an empty cache slot (never inside a window)
EMPTY_SLOT = 1 << 30


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    sliding_window: int | None = None
    rope_theta: float = 1e4
    cross: bool = False        # cross-attention: kv from encoder memory

    @property
    def group_size(self) -> int:
        return self.num_heads // self.num_kv_heads


def init(gen, spec: AttentionSpec, *, dtype, stack: tuple = ()):
    """Params drawn on ``gen``'s device, each (*stack, ...) as one leaf."""
    H, KV, hd, D = (spec.num_heads, spec.num_kv_heads, spec.head_dim,
                    spec.d_model)
    dev = gen.device
    p = {
        "wq": layers.dense_init(gen, D, (H, hd), dtype=dtype, stack=stack),
        "wk": layers.dense_init(gen, D, (KV, hd), dtype=dtype, stack=stack),
        "wv": layers.dense_init(gen, D, (KV, hd), dtype=dtype, stack=stack),
        "wo": layers.dense_init(gen, H * hd, D, dtype=dtype,
                                scale=(H * hd) ** -0.5, stack=stack),
    }
    if spec.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((*stack, heads, hd), dtype=dtype,
                                  device=dev)
    if spec.qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, dtype=dtype, device=dev,
                                          stack=stack)
        p["k_norm"] = layers.rmsnorm_init(hd, dtype=dtype, device=dev,
                                          stack=stack)
    return p


def _project(x, w):
    """einsum("btd,dhk->bthk") as one matmul."""
    D, heads, hd = w.shape
    return (x @ w.reshape(D, heads * hd)).reshape(*x.shape[:-1], heads, hd)


def _project_q(params, spec: AttentionSpec, x, positions):
    q = _project(x, params["wq"])
    if spec.qkv_bias:
        q = q + params["bq"]
    if spec.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q)
    if not spec.cross:
        q = layers.apply_rope(q, positions, theta=spec.rope_theta)
    return q


def _project_kv(params, spec: AttentionSpec, x, positions):
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if spec.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.qk_norm:
        k = layers.rmsnorm(params["k_norm"], k)
    if not spec.cross:
        k = layers.apply_rope(k, positions, theta=spec.rope_theta)
    return k, v


def _arange(n: int, batch: int, device, start: int = 0):
    return torch.arange(start, start + n, device=device)[None].expand(batch, n)


def _visible(q_positions, kv_positions, *, causal: bool,
             sliding_window: int | None):
    """Which keys each query sees: (B, 1, 1, Tq, Tk) bool from the
    positions (B, Tq) and (B, Tk)."""
    qp = q_positions[:, None, None, :, None]                 # (B,1,1,Tq,1)
    kp = kv_positions[:, None, None, None, :]                # (B,1,1,1,Tk)
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=kp.device)
    if causal:
        mask = mask & (kp <= qp)
    if sliding_window is not None:
        mask = mask & (kp > qp - sliding_window)
    return mask


def attention_core(q, k, v, *, causal: bool, sliding_window: int | None,
                   q_positions=None, kv_positions=None, kv_valid_len=None):
    """Scores/softmax/values for GQA.

    q: (B, Tq, H, hd);  k, v: (B, Tk, KV, hd).  Head grouping reshapes q to
    (B, Tq, KV, G, hd): no repeat of kv.  ``q_positions``/``kv_positions``
    (B, T) default to arange (prefill); decode passes explicit positions.
    ``kv_valid_len`` (B,) masks the cache tail.  The score and value
    products run in the input type, the softmax in float32, as the
    reference's einsums do.
    """
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd)
    scale = hd ** -0.5

    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    scores = scores * scale                                  # (B,KV,G,Tq,Tk)

    if q_positions is None:
        q_positions = _arange(Tq, B, q.device)
    if kv_positions is None:
        kv_positions = _arange(Tk, B, q.device)
    mask = _visible(q_positions, kv_positions, causal=causal,
                    sliding_window=sliding_window)
    if kv_valid_len is not None:
        valid = kv_positions < kv_valid_len[:, None]
        mask = mask & valid[:, None, None, None, :]

    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Tq, H, hd)


def attention_core_blocked(q, k, v, *, causal: bool,
                           sliding_window: int | None, q_block: int = 512):
    """Memory-bounded attention: a loop over q blocks, each attending only
    to its causal/window kv slice, so the (Tq, Tk) score matrix never
    exists.  Requires default positions (q_pos == kv_pos == arange)."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    if Tq != Tk:
        raise ValueError("blocked path assumes self-attention prefill layout")
    q_block = min(q_block, Tq)
    n_blocks = (Tq + q_block - 1) // q_block
    outs = []
    for i in range(n_blocks):
        qs, qe = i * q_block, min((i + 1) * q_block, Tq)
        ks = 0
        ke = qe if causal else Tk
        if sliding_window is not None:
            ks = max(0, qs - sliding_window + 1)
        outs.append(attention_core(
            q[:, qs:qe], k[:, ks:ke], v[:, ks:ke], causal=causal,
            sliding_window=sliding_window,
            q_positions=_arange(qe - qs, B, q.device, qs),
            kv_positions=_arange(ke - ks, B, q.device, ks)))
    return torch.cat(outs, dim=1)


# blocked path kicks in above this many query positions (train/prefill)
BLOCKED_ATTENTION_THRESHOLD = 2048


def _online_softmax_attention(q, k, v, *, causal, window, q_pos, kv_block):
    """Flash-style online softmax over kv blocks of ``kv_block`` keys in
    order (the reference's, line for line; its ``kv_len`` mask, which no
    caller sets, is left out).  q: (B, Tq, H, hd) a query block; k, v:
    (B, Tk, KV, hd) whole; q_pos: (B, Tq) absolute positions.  Returns
    (B, Tq, H, hd) float32."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Tq, KV, G, hd)
    scale = hd ** -0.5
    dev = q.device
    m = torch.full((B, KV, G, Tq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tq, KV, G, hd), dtype=torch.float32, device=dev)
    qp = q_pos[:, None, None, :, None]
    for ks_ in range(0, Tk, kv_block):
        ke_ = min(ks_ + kv_block, Tk)
        kb, vb = k[:, ks_:ke_], v[:, ks_:ke_]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kb).to(torch.float32)
        s = s * scale
        kp = torch.arange(ks_, ke_, device=dev)[None, None, None, None, :]
        mask = torch.ones((B, 1, 1, Tq, ke_ - ks_), dtype=torch.bool,
                          device=dev)
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), vb)
        acc = acc * torch.movedim(alpha, 3, 1)[..., None] \
            + pv.to(torch.float32)
        m = m_new
    denom = torch.clamp(torch.movedim(l, 3, 1), min=1e-30)[..., None]
    return (acc / denom).reshape(B, Tq, H, hd)


def apply_sequence_parallel(params, spec: AttentionSpec, x, *, memory=None,
                            q_block: int = 256, kv_block: int = 1024,
                            plain: bool = False):
    """Sequence-parallel attention on this rank's block (the reference's
    shard_map body).  x: (B/data, T/model, D), the rank's batch shard and
    its model-axis block of the sequence -> (B/data, T/model, D).

    The queries sit at positions r T/model + i (r the rank's model
    coordinate); k and v are projected from the block and all-gathered
    over ``model`` (the region's one collective); cross-attention takes k
    and v from ``memory`` (B/data, S, D), the batch shard, not gathered.
    On CUDA (``plain=False``) the core is one launch of the flash kernel
    at query offset r T/model; otherwise the reference's plain online
    softmax over kv blocks, in query blocks of ``q_block``."""
    mesh = meshctx.current_mesh()
    B, t_loc, _ = x.shape
    offset = meshctx.axis_index("model") * t_loc
    causal = spec.causal and not spec.cross
    window = None if spec.cross else spec.sliding_window
    pos = _arange(t_loc, B, x.device, offset)
    q = _project_q(params, spec, x, pos)
    if spec.cross:
        k, v = _project_kv(params, spec, memory, None)
    else:
        k_loc, v_loc = _project_kv(params, spec, x, pos)
        k, v = meshctx.all_gather_many([k_loc, v_loc], "model", 1,
                                       mesh=mesh)
    if x.device.type == "cuda" and not plain:
        from repro_torch.kernels.attention import ops
        out = ops.attention(q, k, v, causal=causal, sliding_window=window,
                            q_offset=offset)
    else:
        outs = []
        for qs in range(0, t_loc, q_block):
            qe = min(qs + q_block, t_loc)
            outs.append(_online_softmax_attention(
                q[:, qs:qe], k, v, causal=causal, window=window,
                q_pos=_arange(qe - qs, B, x.device, offset + qs),
                kv_block=kv_block))
        out = torch.cat(outs, dim=1).to(x.dtype)
    out = out.reshape(B, t_loc, spec.num_heads * spec.head_dim)
    return out @ params["wo"]


def apply(params, spec: AttentionSpec, x, *, memory=None,
          plain: bool = False):
    """Full-sequence attention (train / prefill), queries at positions
    0..T-1.  x: (B, T, D) -> (B, T, D); ``memory`` (B, S, D) supplies k
    and v for cross-attention (``spec.cross``: no RoPE, no mask, no
    window).  On CUDA the core is the CUDA kernel; ``plain=True`` keeps the
    reference's plain path there, whose blocked core serves self-attention
    only (cross-attention above the threshold takes the unblocked core, as
    in the reference).  Under a model mesh x is the rank's block: where
    the stream is cut over ``model`` (``meshctx.stream_is_cut``), the
    (B/data, T/model, D) block and the sequence-parallel path; else the
    data shard's rows (B/data, T, D) with T whole on every model rank, and
    the dense path above on them (the reference's fallback below the
    threshold: on CUDA the flash kernel's full launch), ``memory`` the
    same rows of the encoder's output."""
    mesh = meshctx.current_mesh()
    if mesh is not None and meshctx.stream_is_cut():
        return apply_sequence_parallel(params, spec, x, memory=memory,
                                       plain=plain)
    B, T, _ = x.shape
    positions = _arange(T, B, x.device)
    # a view of the memory for this layer alone: autograd sums this
    # layer's k and v gradients in it before adding them to the other
    # layers', the order a remat'd block (which returns them summed) gives
    kv_src = memory.view_as(memory) if spec.cross else x
    kv_pos = (_arange(kv_src.shape[1], B, x.device) if spec.cross
              else positions)
    q = _project_q(params, spec, x, positions)
    k, v = _project_kv(params, spec, kv_src, kv_pos)
    causal = spec.causal and not spec.cross
    window = None if spec.cross else spec.sliding_window
    if x.device.type == "cuda" and not plain:
        from repro_torch.kernels.attention import ops
        out = ops.attention(q, k, v, causal=causal, sliding_window=window)
    elif not spec.cross and T > BLOCKED_ATTENTION_THRESHOLD:
        out = attention_core_blocked(q, k, v, causal=causal,
                                     sliding_window=window)
    else:
        out = attention_core(q, k, v, causal=causal, sliding_window=window,
                             q_positions=positions, kv_positions=kv_pos)
    out = out.reshape(B, T, spec.num_heads * spec.head_dim)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# decode path

def cache_shape(spec: AttentionSpec, batch: int, max_len: int):
    """Physical cache length: a sliding window needs only ``window`` slots
    (a ring buffer)."""
    phys = max_len if spec.sliding_window is None \
        else min(max_len, spec.sliding_window)
    return (batch, phys, spec.num_kv_heads, spec.head_dim)


def init_cache(spec: AttentionSpec, batch: int, max_len: int, *, dtype,
               device=None):
    shape = cache_shape(spec, batch, max_len)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _block_softmax(q, k, v, *, causal: bool, sliding_window, q_positions,
                   kv_positions):
    """One query a row against a block of keys: (row max (B, 1, KV, G),
    sum of exp(s - max) (B, 1, KV, G), unnormalised output (B, 1, KV, G,
    hd)), float32.  The scores and their mask (``_visible``) are
    ``attention_core``'s (masked to -1e30; ``kv_positions`` None: no
    mask), the value product in the input type."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    s = s * hd ** -0.5                                       # (B,KV,G,1,S)
    if kv_positions is not None:
        s = s.masked_fill(~_visible(q_positions, kv_positions, causal=causal,
                                    sliding_window=sliding_window), -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return (torch.movedim(m, 3, 1), torch.movedim(p.sum(-1), 3, 1),
            o.to(torch.float32))


def _decode_softmax(q, k, v, mesh, **mask):
    """The decode's softmax over the keys: this rank's block
    (``_block_softmax``) divided by its sum, or under a mesh combined
    over ``model`` (``softmax_combine``: rescaled by the global max,
    summed in rank order) -> (B, 1, H, hd) in q's type."""
    m, l, o = _block_softmax(q, k, v, **mask)
    if mesh is None:
        out = o / l[..., None]
    else:
        out = meshctx.softmax_combine(m, l, o, "model", mesh=mesh)
    return out.reshape(q.shape).to(q.dtype)


def decode_step(params, spec: AttentionSpec, x, cache, position, *,
                memory=None):
    """One-token decode.  x: (B, 1, D); position: (B,) int — the absolute
    position of this token.  Returns (out (B, 1, D), cache).  Unlike the
    reference's functional update, the cache tensors are written in place
    (one slot per row), so a step moves no more than the new token's k and
    v; the returned cache is the one passed in.  Cross-attention
    (``spec.cross``) reads k and v from ``memory`` (B, S, D), projected
    again at every step, and leaves ``cache`` as it is.

    Under a model mesh x is the data shard's rows, the same on every model
    rank, and ``cache`` and ``memory`` are the rank's blocks
    (``launch.sharding.local_decode_state``): rank r holds slots
    [r S/m, (r+1) S/m) of the physical cache (S/m = the block's length; a
    window's ring too) and the same block of the memory's S.  Only the
    rank that holds slot ``position % S`` writes the new k and v; each
    rank scores its block (the ring-aware positions, empty slots masked)
    and the blocks are combined over ``model`` (``_decode_softmax``)."""
    B = x.shape[0]
    mesh = meshctx.current_mesh()
    if spec.cross:
        k, v = _project_kv(params, spec, memory, None)
        q = _project_q(params, spec, x, position[:, None])
        out = _decode_softmax(q, k, v, mesh, causal=False,
                              sliding_window=None, q_positions=None,
                              kv_positions=None)
        out = out.reshape(B, 1, spec.num_heads * spec.head_dim)
        return out @ params["wo"], cache
    q = _project_q(params, spec, x, position[:, None])
    k_new, v_new = _project_kv(params, spec, x, position[:, None])

    block = cache["k"].shape[1]
    lo = 0 if mesh is None else meshctx.axis_index("model") * block
    phys = block * (1 if mesh is None else meshctx.model_size(mesh))
    slot = position % phys                                    # ring for SWA
    bidx = torch.arange(B, device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    if mesh is None:
        k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)
    else:
        # the rows whose slot lies in this rank's block write it; the
        # others write back what the slot they index holds
        local = slot - lo
        mine = ((local >= 0) & (local < block))[:, None, None]
        at = local.clamp(0, block - 1)
        k_cache[bidx, at] = torch.where(mine, k_new[:, 0].to(k_cache.dtype),
                                        k_cache[bidx, at])
        v_cache[bidx, at] = torch.where(mine, v_new[:, 0].to(v_cache.dtype),
                                        v_cache[bidx, at])

    # absolute position of every physical slot (ring-aware): slot s holds
    # the most recent token congruent to s mod phys that is <= position
    slots = torch.arange(lo, lo + block, device=x.device)[None, :]
    pos_col = position[:, None]
    kv_positions = pos_col - torch.remainder(pos_col - slots, phys)
    valid = kv_positions >= 0
    if spec.sliding_window is not None:
        valid = valid & (kv_positions > pos_col - spec.sliding_window)
    kv_positions = torch.where(valid, kv_positions,
                               torch.full_like(kv_positions, EMPTY_SLOT))

    out = _decode_softmax(q, k_cache, v_cache, mesh, causal=True,
                          sliding_window=spec.sliding_window,
                          q_positions=position[:, None],
                          kv_positions=kv_positions)
    out = out.reshape(B, 1, spec.num_heads * spec.head_dim)
    return out @ params["wo"], {"k": k_cache, "v": v_cache}
