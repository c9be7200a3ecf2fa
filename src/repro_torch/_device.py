"""Device resolution for the port's entry points.

An entry point takes ``device=None``, which means the CUDA card.  Without
a card it raises instead of quietly running on the CPU; the caller asks
for the CPU explicitly with ``device="cpu"`` (the CPU tests do).

The reference computes in float32 everywhere, so TF32 matmuls are refused.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def enter(device=None) -> torch.device:
    """Entry-point preamble: full-f32 matmuls, then the resolved device."""
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the reference is "
            "float32 throughout and TF32 matmuls would drift from it")
    return resolve_device(device)
