"""Device resolution for the port's entry points.

An entry point takes ``device=None``, which means the CUDA card.  Without
a card it raises instead of quietly running on the CPU; the caller asks
for the CPU explicitly with ``device="cpu"`` (the CPU tests do).

The reference computes in float32 everywhere, so TF32 matmuls are refused,
and bf16 matmuls reduce in float32.
"""

from __future__ import annotations

import os

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


def set_precision() -> None:
    """Full-f32 matmuls, and bf16 matmuls that reduce in float32 (cuBLAS may
    otherwise split the reduction in bf16); set when an entry point or a
    step runs, never at import."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the reference is "
            "float32 throughout and TF32 matmuls would drift from it")


def expandable_segments() -> None:
    """Let the CUDA caching allocator grow its segments in place.  At LM
    width a round holds (m, P) and (k, P) float32 blocks of tens of GB,
    which a cache fragmented by earlier allocations may otherwise refuse.
    CUDA reads the setting when it first initialises, so it is set only
    while CUDA is not yet initialised (a caller's own setting wins)."""
    if not torch.cuda.is_initialized():
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")


def enter(device=None) -> torch.device:
    """Entry-point preamble: ``set_precision``, then the resolved device."""
    set_precision()
    return resolve_device(device)
