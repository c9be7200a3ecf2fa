"""Plain PyTorch versions of the flash-attention kernels (port of
``repro.kernels.attention.ref``).

The oracle IS the model's attention path
(``repro_torch.models.attention.attention_core``), so kernel == model
semantics by construction.  ``flash_attention_tiled_ref`` is the
tensor-core route's arithmetic written out plainly, for the tests.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import _arange, attention_core

NEG = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int | None = None,
                        q_offset: int = 0):
    """q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd) -> (B, Tq, H, hd); query
    row i at position ``q_offset + i``, keys at their index."""
    B, Tq = q.shape[:2]
    return attention_core(q, k, v, causal=causal,
                          sliding_window=sliding_window,
                          q_positions=_arange(Tq, B, q.device, q_offset))


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              sliding_window: int | None = None,
                              block_k: int | None = None,
                              q_offset: int = 0):
    """The tensor-core kernel's arithmetic: products of the (bf16) inputs
    summed in f32, an online softmax in f32 over kv tiles of ``block_k``
    keys in order (the kernel's BK: 128 up to hd 128, else 64), P rounded
    to q's type before P V with f32 sums, l summed from the unrounded p,
    and acc / max(l, 1e-30) in q's type.  q: (B, Tq, H, hd); k, v: (B, Tk,
    KV, hd) -> (B, Tq, H, hd); query row i at position ``q_offset + i``."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    bk = block_k or (128 if hd <= 128 else 64)
    qf = q.float().reshape(B, Tq, KV, G, hd)
    kf, vf = k.float(), v.float()
    qpos = torch.arange(q_offset, q_offset + Tq, device=q.device)[:, None]
    m = torch.full((B, KV, G, Tq), NEG, device=q.device)
    l = torch.zeros((B, KV, G, Tq), device=q.device)
    acc = torch.zeros((B, KV, G, Tq, hd), device=q.device)
    for k0 in range(0, Tk, bk):
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf[:, k0:k0 + bk])
        s = s * hd ** -0.5
        kpos = torch.arange(k0, min(k0 + bk, Tk), device=q.device)[None]
        live = torch.ones((Tq, kpos.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            live = live & (kpos <= qpos)
        if sliding_window is not None:
            live = live & (kpos > qpos - sliding_window)
        s = s.masked_fill(~live, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(q.dtype).float(), vf[:, k0:k0 + bk])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)
