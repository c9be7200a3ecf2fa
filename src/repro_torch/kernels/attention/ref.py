"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.attention.ref``).

The oracle IS the model's attention path
(``repro_torch.models.attention.attention_core``), so kernel == model
semantics by construction.
"""

from __future__ import annotations

from repro_torch.models.attention import attention_core


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int | None = None):
    """q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd) -> (B, Tq, H, hd)."""
    return attention_core(q, k, v, causal=causal,
                          sliding_window=sliding_window)
