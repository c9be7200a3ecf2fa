"""The Weiszfeld kernels as CUDA kernels on Hopper.

Port of ``repro.kernels.geomed.geomed`` (the Pallas TPU kernels
``sqdist`` and ``reweight`` and the step ``weiszfeld_step`` built from
them), and of the loop over them in ``repro.kernels.geomed.ops``:

* ``sqdist(points, y)`` — ||z_i - y||^2 per row, (k, d) x (d,) -> (k,);
* ``reweight(points, w)`` — sum_i w_i z_i, (k, d) x (k,) -> (d,);
* ``weiszfeld_step(points, y, weights)`` — sqdist, the O(k) glue
  (eps-smoothed distances, ``max(sum inv, eps)`` denominator), reweight;
* ``weiszfeld_loop(points, weights)`` — the whole loop of
  ``ops.geometric_median_kernel`` (weighted-mean init, steps until the
  norm of the move is <= tol or ``max_iters``) in one launch, for
  k <= ``MAX_BATCHES`` -> ((d,), iterations); the kernel by k
  (``loop_kernel``): ``"regs"`` (k <= ``REGS_MAX_K``: each thread holds a
  column's k values in registers, sqdist's stream) or ``"tiles"`` (Z's
  tiles through shared memory).

Inputs are cast to contiguous float32 first, as the reference casts before
its ``pallas_call``.  On a CUDA tensor the wrappers launch the hand-written
kernels of ``csrc/geomed.cu`` (or raise); on a CPU tensor, and only there,
they run the plain versions of ``ref.py``.  ``sqdist.launches``,
``reweight.launches`` and ``weiszfeld_loop.launches`` count the kernel
launches.  ``tile_d`` is accepted for the reference's signature and has no
meaning for the CUDA kernels.  The kernels sum in other orders than the
plain versions, so the two agree to float tolerance; each kernel is
bitwise identical run to run, and ``ref.weiszfeld_distances_blocked`` /
``ops.geometric_median_blocked`` replay ``sqdist`` / ``weiszfeld_loop``
bit for bit on the plan the wrapper launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.geometric_median import f32_threshold
from repro_torch.kernels.geomed import ref
from repro_torch.kernels.geomed import round as rk
from repro_torch.kernels.geomed._common import (THREADS, as_f32, num_blocks,
                                                stream)

TILE_D = 512
SOURCE = Path(__file__).resolve().parent / "csrc" / "geomed.cu"
# the largest k the loop kernels take (``gmom_weiszfeld_max_batches``),
# and the largest k of the register-streamed one
# (``gmom_weiszfeld_regs_max_k``)
MAX_BATCHES = rk.MAX_BATCHES
REGS_MAX_K = 16
LOOP_KERNELS = ("regs", "tiles")


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(SOURCE)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.gmom_sqdist.argtypes = [ptr, ptr, i32, i64, i32, ptr, ptr, ptr, i32,
                                ptr]
    lib.gmom_sqdist.restype = i32
    lib.gmom_sqdist_blocks_per_sm.argtypes = [i32]
    lib.gmom_sqdist_blocks_per_sm.restype = i32
    lib.gmom_reweight.argtypes = [ptr, ptr, i32, i64, ptr, i32, ptr]
    lib.gmom_reweight.restype = i32
    lib.gmom_weiszfeld.argtypes = [ptr, ptr, i32, i64, i32, i32, f32, f32,
                                   f32, ptr, ptr, ptr, i32, ptr]
    lib.gmom_weiszfeld.restype = i32
    for name in ("max_batches", "tile", "regs_max_k", "blocks_per_sm"):
        getattr(lib, f"gmom_weiszfeld_{name}").restype = i32
    lib.gmom_weiszfeld_blocks_per_sm.argtypes = [i32]
    lib.gmom_geomed_error_string.argtypes = [i32]
    lib.gmom_geomed_error_string.restype = ctypes.c_char_p
    if (lib.gmom_weiszfeld_max_batches() != MAX_BATCHES
            or lib.gmom_weiszfeld_tile() != rk.TILE
            or lib.gmom_weiszfeld_regs_max_k() != REGS_MAX_K):
        raise RuntimeError("geomed.cu and geomed.py disagree on the largest "
                           "k, the tile width or the loop kernels' k")
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


def _occupancy(fn, key: int, what: str) -> int:
    n = fn(key)
    if n <= 0:
        raise RuntimeError(f"{what}: no block fits on an SM at {key} "
                           f"(CUDA error {-n})")
    return n


def vector_width(d: int, *tensors) -> int:
    """4 where every row of the tensors starts on 16 bytes (d % 4 == 0 and
    aligned data: the float4 loads), else 1."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if d % 4 == 0 and aligned else 1


def sqdist_blocks(d: int, vec: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of the sqdist kernel: one wave (the occupancy times the SM
    count), and no more than its units of ``vec`` columns need."""
    return max(1, min(blocks_per_sm * sms, -(-(d // vec) // THREADS)))


@functools.lru_cache(maxsize=None)
def _sqdist_blocks_per_sm(vec: int) -> int:
    lib = _library()
    return _occupancy(lib.gmom_sqdist_blocks_per_sm, vec, "sqdist")


@functools.lru_cache(maxsize=64)
def _sqdist_scratch(k: int, d: int, vec: int, device, cuda_stream: int):
    """(n_blocks, the partials (n_blocks, k), the zeroed ticket) of the
    sqdist launches of one stream (every launch leaves the ticket at
    zero): one lookup a call."""
    del cuda_stream
    nb = sqdist_blocks(d, vec, _sqdist_blocks_per_sm(vec),
                       rk._sm_count(device))
    return (nb, torch.empty((nb, k), dtype=torch.float32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))


def sqdist_plan(points, y) -> tuple[int, int]:
    """(n_blocks, vec) of the sqdist launch on CUDA tensors (the plan
    ``ref.weiszfeld_distances_blocked`` replays)."""
    k, d = points.shape
    vec = vector_width(d, points, y)
    return _sqdist_scratch(k, d, vec, points.device, stream(points))[0], vec


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
    vec = vector_width(d, points, y)
    st = stream(points)
    nb, part, ticket = _sqdist_scratch(k, d, vec, points.device, st)
    out = torch.empty((k,), dtype=torch.float32, device=points.device)
    _raise_on(lib.gmom_sqdist(points.data_ptr(), y.data_ptr(), k, d, vec,
                              part.data_ptr(), ticket.data_ptr(),
                              out.data_ptr(), nb, st), lib, "sqdist")
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


def loop_kernel(k: int) -> str:
    """The loop kernel for k points: ``"regs"`` while a column's k values
    fit in a thread's registers (k <= ``REGS_MAX_K``), else ``"tiles"``."""
    return "regs" if k <= REGS_MAX_K else "tiles"


def loop_grid(k: int, d: int, vec: int, blocks_per_sm: int,
              sms: int) -> int:
    """Blocks of the loop kernel's cooperative grid: as many as the card
    holds at once, and no more than the work: the units of ``vec`` columns
    (``sqdist_blocks``) for ``"regs"``, the tiles of d
    (``round.persistent_blocks``) for ``"tiles"``."""
    if loop_kernel(k) == "regs":
        return sqdist_blocks(d, vec, blocks_per_sm, sms)
    return rk.persistent_blocks(d, blocks_per_sm, sms)


@functools.lru_cache(maxsize=None)
def _loop_blocks_per_sm(k: int) -> int:
    lib = _library()
    return _occupancy(lib.gmom_weiszfeld_blocks_per_sm, k, "weiszfeld_loop")


def loop_blocks(k: int, d: int, vec: int, device) -> int:
    """Blocks of the loop kernel's grid on ``device`` (``loop_grid``)."""
    return loop_grid(k, d, vec, _loop_blocks_per_sm(k), rk._sm_count(device))


@functools.lru_cache(maxsize=64)
def _loop_scratch(k: int, n_blocks: int, device, cuda_stream: int):
    """The partial halves (2, n_blocks, k + 1) of one stream's loops."""
    del cuda_stream
    return torch.empty((2, n_blocks, k + 1), dtype=torch.float32,
                       device=device)


def weiszfeld_loop(points, weights=None, *, max_iters: int = 64,
                   tol: float = 1e-8, eps: float = 1e-12):
    """The Weiszfeld loop of ``ops.geometric_median_kernel`` for k <=
    ``MAX_BATCHES``: points (k, d), weights (k,) or None for unit weights
    -> ((d,) f32, iterations, a 0-d int32 tensor on the input's device).

    On CUDA tensors one cooperative launch of the kernel ``loop_kernel(k)``
    names runs it from the init to the stop (unit weights are the kernel's
    own: no fill); nothing synchronises the host.  Launches count in
    ``launches`` and by kernel in ``kernel_launches``.  CPU tensors run
    ``ref.geometric_median_ref``."""
    points = as_f32(points)
    w = None if weights is None else as_f32(weights)
    if points.device.type == "cpu" and (w is None or w.device.type == "cpu"):
        if w is None:
            w = torch.ones((points.shape[0],), dtype=torch.float32)
        return ref.geometric_median_ref(points, w, max_iters=max_iters,
                                        tol=tol, eps=eps)
    _check_cuda("weiszfeld_loop", points, points if w is None else w)
    k, d = points.shape
    if not 1 <= k <= MAX_BATCHES:
        raise ValueError(f"weiszfeld_loop takes 1 <= k <= {MAX_BATCHES} "
                         f"points, got {k}")
    if w is not None and w.shape != (k,):
        raise ValueError(f"weiszfeld_loop: {tuple(w.shape)} weights for {k} "
                         "points")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    lib = _library()
    vec = vector_width(d, points)
    nb = loop_blocks(k, d, vec, points.device)
    st = stream(points)
    part = _loop_scratch(k, nb, points.device, st)
    y = torch.empty((d,), dtype=torch.float32, device=points.device)
    iters = torch.empty((1,), dtype=torch.int32, device=points.device)
    _raise_on(lib.gmom_weiszfeld(
        points.data_ptr(), None if w is None else w.data_ptr(), k, d,
        int(vec == 4), int(max_iters),
        f32_threshold(tol), float(eps), f32_threshold(eps * eps),
        part.data_ptr(), iters.data_ptr(), y.data_ptr(), nb, st),
        lib, "weiszfeld_loop")
    weiszfeld_loop.launches += 1
    weiszfeld_loop.kernel_launches[loop_kernel(k)] += 1
    return y, iters[0]


def reset_loop_launches() -> None:
    """Zero ``weiszfeld_loop.launches`` and its counts by kernel."""
    weiszfeld_loop.launches = 0
    weiszfeld_loop.kernel_launches = dict.fromkeys(LOOP_KERNELS, 0)


reset_loop_launches()
