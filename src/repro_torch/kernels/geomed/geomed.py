"""The two passes of one Weiszfeld step as CUDA kernels on Hopper.

Port of ``repro.kernels.geomed.geomed`` (the Pallas TPU kernels
``sqdist`` and ``reweight`` and the step ``weiszfeld_step`` built from
them):

* ``sqdist(points, y)`` — ||z_i - y||^2 per row, (k, d) x (d,) -> (k,);
* ``reweight(points, w)`` — sum_i w_i z_i, (k, d) x (k,) -> (d,);
* ``weiszfeld_step(points, y, weights)`` — sqdist, the O(k) glue
  (eps-smoothed distances, ``max(sum inv, eps)`` denominator), reweight.

Inputs are cast to contiguous float32 first, as the reference casts before
its ``pallas_call``.  On a CUDA tensor the wrappers launch the hand-written
kernels of ``csrc/geomed.cu`` (or raise); on a CPU tensor, and only there,
they run the plain versions of ``ref.py``.  ``sqdist.launches`` and
``reweight.launches`` count the kernel launches.  ``tile_d`` is accepted
for the reference's signature and has no meaning for the CUDA kernels.
The kernels sum in other orders than the plain versions, so the two agree
to float tolerance; each kernel is bitwise identical run to run.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.geomed import ref
from repro_torch.kernels.geomed._common import as_f32, num_blocks, stream

TILE_D = 512
SOURCE = Path(__file__).resolve().parent / "csrc" / "geomed.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(SOURCE)
    ptr = ctypes.c_void_p
    lib.gmom_sqdist.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_longlong,
                                ptr, ptr, ctypes.c_int, ptr]
    lib.gmom_sqdist.restype = ctypes.c_int
    lib.gmom_reweight.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_longlong,
                                  ptr, ctypes.c_int, ptr]
    lib.gmom_reweight.restype = ctypes.c_int
    lib.gmom_geomed_row_chunk.argtypes = []
    lib.gmom_geomed_row_chunk.restype = ctypes.c_int
    lib.gmom_geomed_error_string.argtypes = [ctypes.c_int]
    lib.gmom_geomed_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(name, points, other):
    if points.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {points.device}")
    if points.ndim != 2 or other.device != points.device:
        raise ValueError(f"{name} takes (k, d) points and a vector on the "
                         f"same device, got {tuple(points.shape)} on "
                         f"{points.device} and {tuple(other.shape)} on "
                         f"{other.device}")


def _raise_on(rc: int, lib, name: str):
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_geomed_error_string(rc).decode()})")


def sqdist(points, y, *, tile_d: int = TILE_D):
    """||z_i - y||^2 for each row.  points: (k, d), y: (d,) -> (k,) f32."""
    del tile_d
    points, y = as_f32(points), as_f32(y)
    if points.device.type == "cpu" and y.device.type == "cpu":
        return ref.weiszfeld_distances_ref(points, y)
    _check_cuda("sqdist", points, y)
    k, d = points.shape
    if y.shape != (d,):
        raise ValueError(f"sqdist: y of shape {tuple(y.shape)} for points "
                         f"of width {d}")
    lib = _library()
    nb = num_blocks(d)
    part = torch.empty((nb, min(k, lib.gmom_geomed_row_chunk())),
                       dtype=torch.float32, device=points.device)
    out = torch.empty((k,), dtype=torch.float32, device=points.device)
    _raise_on(lib.gmom_sqdist(points.data_ptr(), y.data_ptr(), k, d,
                              part.data_ptr(), out.data_ptr(), nb,
                              stream(points)), lib, "sqdist")
    sqdist.launches += 1
    return out


sqdist.launches = 0


def reweight(points, inv_weights, *, tile_d: int = TILE_D):
    """sum_i w_i z_i.  points: (k, d), inv_weights: (k,) -> (d,) f32."""
    del tile_d
    points, w = as_f32(points), as_f32(inv_weights)
    if points.device.type == "cpu" and w.device.type == "cpu":
        return ref.weiszfeld_reweight_ref(points, w)
    _check_cuda("reweight", points, w)
    k, d = points.shape
    if w.shape != (k,):
        raise ValueError(f"reweight: {tuple(w.shape)} weights for {k} "
                         "points")
    lib = _library()
    out = torch.empty((d,), dtype=torch.float32, device=points.device)
    _raise_on(lib.gmom_reweight(points.data_ptr(), w.data_ptr(), k, d,
                                out.data_ptr(), num_blocks(d),
                                stream(points)), lib, "reweight")
    reweight.launches += 1
    return out


reweight.launches = 0


def weiszfeld_step(points, y, weights, *, eps: float = 1e-12,
                   tile_d: int = TILE_D):
    """One Weiszfeld step through the two kernels; the same ops as
    ``ref.weiszfeld_step_ref``."""
    sq = sqdist(points, y, tile_d=tile_d)
    dist = torch.sqrt(sq + eps * eps)
    inv = weights.to(torch.float32) / dist
    denom = torch.clamp(torch.sum(inv), min=eps)
    return reweight(points, inv, tile_d=tile_d) / denom
