"""Public entry of the flash-attention kernel (port of
``repro.kernels.attention.ops``).

``attention(...)`` runs the plain version (``ref.flash_attention_ref``) on
CPU tensors, and only there; on CUDA tensors it launches the CUDA kernel
(``flash.flash_attention``, whose ``launches`` counts the kernel's
launches), which raises on what it does not take.
"""

from __future__ import annotations

from repro_torch import _device
from repro_torch.kernels.attention import flash, ref


def attention(q, k, v, *, causal: bool = True,
              sliding_window: int | None = None, q_offset: int = 0):
    """q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd) -> (B, Tq, H, hd); query
    row i at position ``q_offset + i``, keys at their index."""
    if all(_device.device_type(t) == "cpu" for t in (q, k, v)):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=sliding_window,
                                       q_offset=q_offset)
    return flash.flash_attention(q, k, v, causal=causal,
                                 sliding_window=sliding_window,
                                 q_offset=q_offset)
