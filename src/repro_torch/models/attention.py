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

Not ported: ``apply_sequence_parallel``, which needs ``models/meshctx.py``
and a model mesh (ROADMAP Queue 1 item 16.10).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers

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
    qp = q_positions[:, None, None, :, None]                 # (B,1,1,Tq,1)
    kp = kv_positions[:, None, None, None, :]                # (B,1,1,1,Tk)

    mask = torch.ones((B, 1, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if sliding_window is not None:
        mask = mask & (kp > qp - sliding_window)
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


def apply_sequence_parallel(*args, **kwargs):
    raise NotImplementedError(
        "sequence-parallel attention needs models/meshctx.py and a model "
        "mesh: ROADMAP Queue 1 item 16.10")


def apply(params, spec: AttentionSpec, x, *, memory=None,
          plain: bool = False):
    """Full-sequence attention (train / prefill), queries at positions
    0..T-1.  x: (B, T, D) -> (B, T, D); ``memory`` (B, S, D) supplies k
    and v for cross-attention (``spec.cross``: no RoPE, no mask, no
    window).  On CUDA the core is the CUDA kernel; ``plain=True`` keeps the
    reference's plain path there, whose blocked core serves self-attention
    only (cross-attention above the threshold takes the unblocked core, as
    in the reference)."""
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


def decode_step(params, spec: AttentionSpec, x, cache, position, *,
                memory=None):
    """One-token decode.  x: (B, 1, D); position: (B,) int — the absolute
    position of this token.  Returns (out (B, 1, D), cache).  Unlike the
    reference's functional update, the cache tensors are written in place
    (one slot per row), so a step moves no more than the new token's k and
    v; the returned cache is the one passed in.  Cross-attention
    (``spec.cross``) reads k and v from ``memory`` (B, S, D), projected
    again at every step, and leaves ``cache`` as it is."""
    B = x.shape[0]
    if spec.cross:
        k, v = _project_kv(params, spec, memory, None)
        q = _project_q(params, spec, x, position[:, None])
        out = attention_core(q, k, v, causal=False, sliding_window=None,
                             q_positions=position[:, None])
        out = out.reshape(B, 1, spec.num_heads * spec.head_dim)
        return out @ params["wo"], cache
    q = _project_q(params, spec, x, position[:, None])
    k_new, v_new = _project_kv(params, spec, x, position[:, None])

    phys = cache["k"].shape[1]
    slot = position % phys                                    # ring for SWA
    bidx = torch.arange(B, device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)

    # absolute position of every physical slot (ring-aware): slot s holds
    # the most recent token congruent to s mod phys that is <= position
    slots = torch.arange(phys, device=x.device)[None, :]      # (1, phys)
    pos_col = position[:, None]
    kv_positions = pos_col - torch.remainder(pos_col - slots, phys)
    valid = kv_positions >= 0
    if spec.sliding_window is not None:
        valid = valid & (kv_positions > pos_col - spec.sliding_window)

    out = attention_core(
        q, k_cache, v_cache, causal=True,
        sliding_window=spec.sliding_window,
        q_positions=position[:, None],
        kv_positions=torch.where(valid, kv_positions,
                                 torch.full_like(kv_positions, EMPTY_SLOT)))
    out = out.reshape(B, 1, spec.num_heads * spec.head_dim)
    return out @ params["wo"], {"k": k_cache, "v": v_cache}
