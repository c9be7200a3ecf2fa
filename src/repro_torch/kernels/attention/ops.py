"""Public entry of the flash-attention kernel (port of
``repro.kernels.attention.ops``).

``attention(...)`` runs the plain version (``ref.flash_attention_ref``) on
CPU tensors, and only there; on CUDA tensors it launches the CUDA kernel
(``flash.flash_attention``, whose ``launches`` counts the kernel's
launches), which raises on what it does not take.
"""

from __future__ import annotations

from repro_torch.kernels.attention import flash, ref


def attention(q, k, v, *, causal: bool = True,
              sliding_window: int | None = None):
    """q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd) -> (B, Tq, H, hd)."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=sliding_window)
    return flash.flash_attention(q, k, v, causal=causal,
                                 sliding_window=sliding_window)
