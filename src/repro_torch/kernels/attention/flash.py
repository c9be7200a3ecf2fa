"""Flash attention (forward) as CUDA kernels on Hopper.

Port of the Pallas TPU kernel ``repro.kernels.attention.flash``
(``flash_attention`` / ``_flash_kernel``): causal and sliding-window GQA
attention with an f32 online softmax, q (B, Tq, H, hd) and k, v (B, Tk,
KV, hd) in float32 or bfloat16, the output in q's type.  The kernels
read these layouts in place: the TPU wrapper's head-major copies and
block padding are layout steps, not part of the function; ragged edges
are masked in the kernel, including keys at ``k_pos >= Tk`` (which the
TPU kernel lets in when ``causal=False``).  ``q_offset`` places query row
i at position ``q_offset + i`` for the causal and window masks (keys stay
at their index): a sequence-parallel rank's queries against the whole
sequence's keys (``models.attention.apply_sequence_parallel``).  The TPU
kernel has no offset; at 0 the launch is the one without it.

Two routes, chosen by ``route`` from the type and the head width alone,
with no fallback between them (both live in one library,
``csrc/flash_attention.cu``):

* ``"tensor_core"``: bf16 with ``hd % 8 == 0`` and ``hd <= 256``, the
  wgmma kernel fed by TMA (``csrc/flash_attention_tc.cuh``).  It rounds
  P to bf16 before P V, as the plain bf16 path does;
* ``"cuda_core"``: float32, and bf16 of any other width, the f32-FMA
  kernel (the reference computes in f32 throughout; no TF32).

``flash_attention`` takes CUDA tensors only and raises on anything else;
``flash_attention.launches`` counts its kernel launches and
``flash_attention.route_launches`` counts them by route.
``ops.attention`` is the public entry that runs the plain version on CPU
tensors.  It is forward only, as the TPU kernel is: a call on a tensor
that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"cuda_core": 0, "tensor_core": 1}


def route(dtype, head_dim: int) -> str:
    """The kernel that serves (dtype, head_dim): ``"tensor_core"`` for bf16
    with head_dim % 8 == 0 (TMA's 16-byte strides) up to 256,
    ``"cuda_core"`` for float32 and the other bf16 widths; raises on a type
    or width that no route takes."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: no route takes head_dim "
                         f"{head_dim} (1..{MAX_HEAD_DIM})")
    if dtype == torch.bfloat16 and head_dim % 8 == 0:
        return "tensor_core"
    if dtype in _DTYPES:
        return "cuda_core"
    raise ValueError(f"flash_attention: no route takes {dtype} (float32 or "
                     "bfloat16)")


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, ctypes.c_float, i32, ptr]
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, sliding_window, q_offset=0):
    if not (q.device.type == k.device.type == v.device.type == "cuda"
            and q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, Tq, H, hd) and k, v "
                         f"(B, Tk, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    Bk, Tk, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV < 1 or H % KV != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} (H a multiple of KV)")
    if not 1 <= hd <= MAX_HEAD_DIM or Tq < 1 or Tk < 1 or B < 1:
        raise ValueError(f"flash_attention: head_dim {hd} (1..{MAX_HEAD_DIM})"
                         f", Tq {Tq}, Tk {Tk}, B {B} must be positive")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window {sliding_window} must be >= 1")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention is forward only (the TPU kernel "
                           "has no VJP either); call it under no_grad")


def _aligned(x):
    """``x`` contiguous at a 16-byte aligned address (TMA's rule): a view
    into another tensor at an odd offset is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: int | None = None, q_offset: int = 0):
    """q: (B, Tq, H, hd); k, v: (B, Tk, KV, hd) -> (B, Tq, H, hd), one
    launch of the route's CUDA kernel on q's current stream; query row i
    at position ``q_offset + i``."""
    q_offset = int(q_offset)
    _check(q, k, v, sliding_window, q_offset)
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    name = route(q.dtype, hd)
    q, k, v = map(_aligned, (q, k, v))
    out = torch.empty_like(q)
    lib = _library()
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, Tq, Tk, H, KV, hd, int(bool(causal)),
        int(sliding_window or 0), q_offset, hd ** -0.5, ROUTES[name],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed ({name} route): CUDA "
            f"error {rc} ({lib.flash_attention_error_string(rc).decode()})")
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1
    return out


def reset_launches() -> None:
    """Zero the launch count and the counts by route."""
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


reset_launches()
