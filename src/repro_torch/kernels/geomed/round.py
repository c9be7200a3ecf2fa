"""GMoM server round: stacked gradients -> batch means -> Remark-2 trim ->
Weiszfeld geometric median, as one CUDA kernel pipeline on Hopper; and the
whole linreg round, raw worker batches in, in one such pipeline.

Port of ``repro.kernels.geomed.round`` ``round_aggregate_kernel`` (the
Pallas TPU kernel) and its jnp twin ``round_aggregate_ref``:

* ``round_aggregate_kernel`` — the wrapper.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/round_aggregate.cu`` (or raises); on a
  CPU tensor, and only there, it runs the plain PyTorch version.  It
  counts its launches in ``round_aggregate_kernel.launches``.
* ``round_aggregate_ref`` — the plain PyTorch version, built from the same
  building blocks as the reference (``_median_small``,
  ``_trim_weights_resident``, ``_weiszfeld_init``, ``_weiszfeld_step_vals``,
  ``_weiszfeld_resident``).  The CPU tests hold it against JAX, and the
  chip check holds the kernel against it on the card.

and of ``linreg_round_kernel`` (one failure-free round of Algorithm 2 from
X (m, n, d), y (m, n) and theta (d,): residual, per-worker gradients
(1/n) X_j^T (X_j theta - y_j), then the same means/trim/Weiszfeld tail)
with its twins ``linreg_round_ref`` (replays the reference's d-tile loop
and partial-sum chaining) and ``linreg_round_fused`` (flat):

* ``linreg_round_kernel`` launches ``csrc/linreg_round.cu`` on CUDA
  tensors (or raises) and runs ``linreg_round_ref`` on CPU tensors; it
  counts its launches in ``linreg_round_kernel.launches``.

All return ``(y, iters)``: the (d,) aggregate and the number of Weiszfeld
iterations executed (early exit when the squared move is <= tol^2, capped
at ``max_iters``), a 0-d int tensor on the input's device.  The kernel
sums in other orders than the plain version (per-column member sums,
per-block partials reduced in a fixed order), so the two agree to float
tolerance, and the kernel is bitwise identical run to run.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.geometric_median import f32_threshold
from repro_torch.core.grouping import (Grouping, assignment_matrix,
                                       batch_members_csr)
from repro_torch.kernels.geomed._common import (THREADS, as_f32, num_blocks,
                                                stream)

# The kernel keeps a column's k batch means in registers; the largest
# register file it is compiled for is 64 (``gmom_round_max_batches``).
MAX_BATCHES = 64
SOURCE = Path(__file__).resolve().parent / "csrc" / "round_aggregate.cu"
LINREG_SOURCE = SOURCE.parent / "linreg_round.cu"
# the linreg kernel splits the sample axis until its gradient grid has
# about this many blocks (a wave of 256-thread blocks on an H100)
LINREG_TARGET_BLOCKS = 1024


# ---------------------------------------------------------------------------
# plain PyTorch building blocks (mirroring the reference's op sequence)

def _median_small(x):
    """``jnp.median`` of a small 1-D vector by rank-select: every element is
    ranked against every other (ties broken by index, so ranks are a
    permutation) and the middle order statistic(s) picked by mask; even
    length averages the two middle values."""
    k = x.shape[0]
    ii = torch.arange(k, device=x.device)[:, None]
    jj = torch.arange(k, device=x.device)[None, :]
    xi, xj = x[:, None], x[None, :]
    rank = torch.sum((xj < xi) | ((xj == xi) & (jj < ii)), dim=1)

    def order_stat(r):
        return torch.sum(torch.where(rank == r, x, torch.zeros_like(x)))

    if k % 2 == 1:
        return order_stat(k // 2)
    return 0.5 * (order_stat(k // 2 - 1) + order_stat(k // 2))


def _trim_weights_resident(z, *, trim_multiplier, k):
    """Paper Remark-2 trim weights from the (k, d) batch means."""
    if trim_multiplier is None:
        return torch.ones((k,), dtype=torch.float32, device=z.device)
    norms = torch.sqrt(torch.sum(z * z, dim=1))
    tau = trim_multiplier * _median_small(norms) + 1e-12
    w = (norms <= tau).to(torch.float32)
    return torch.where(torch.sum(w) > 0, w, torch.ones_like(w))


def _weiszfeld_init(z, w, eps):
    """Weighted-mean initial iterate, shape (1, d)."""
    w_sum = torch.clamp(torch.sum(w), min=eps)
    return (w.reshape(1, z.shape[0]) @ z) / w_sum


def _weiszfeld_step_vals(z, w, y, *, eps):
    """One Weiszfeld update: (y_new, squared move)."""
    diff = z - y
    sq = torch.sum(diff * diff, dim=1)
    dist = torch.sqrt(sq + eps * eps)
    inv = w / dist
    denom = torch.clamp(torch.sum(inv), min=eps)
    y_new = (inv / denom).reshape(1, z.shape[0]) @ z
    return y_new, torch.sum((y_new - y) ** 2)


def _weiszfeld_resident(z, w, *, max_iters, tol, eps):
    """Weiszfeld loop on a (k, d) block -> ((1, d) median, iterations).
    Stops when the squared move is <= tol^2 or after ``max_iters`` steps;
    the test reads one scalar back per iteration."""
    y = _weiszfeld_init(z, w, eps)
    it, delta2 = 0, float("inf")
    while it < max_iters and delta2 > f32_threshold(tol * tol):
        y, d2 = _weiszfeld_step_vals(z, w, y, eps=eps)
        delta2 = float(d2)
        it += 1
    return y, it


def _membership(grouping: Grouping, device):
    """(S (k, m) 0/1 membership matrix, batch sizes (k, 1)), float32."""
    s = torch.as_tensor(assignment_matrix(grouping), device=device)
    bsz = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                       device=device).reshape(grouping.num_batches, 1)
    return s, bsz


def _means(stacked_grads, grouping: Grouping):
    s, bsz = _membership(grouping, stacked_grads.device)
    return (s @ stacked_grads.to(torch.float32)) / bsz


def _trim_weiszfeld(z, d: int, *, trim_multiplier, max_iters, tol, eps):
    """The round's tail on the (k, d_pad) means -> ((d,), iterations)."""
    w = _trim_weights_resident(z, trim_multiplier=trim_multiplier,
                               k=z.shape[0])
    y, it = _weiszfeld_resident(z, w, max_iters=max_iters, tol=tol, eps=eps)
    return y[0, :d], torch.tensor(it, dtype=torch.int32, device=z.device)


def _pad_axis(x, tile: int, axis: int):
    pad = (-x.shape[axis]) % tile
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def round_aggregate_ref(stacked_grads, grouping: Grouping, *,
                        trim_multiplier: float | None = 3.0,
                        max_iters: int = 64, tol: float = 1e-8,
                        eps: float = 1e-12):
    """Plain PyTorch GMoM round: (m, d) -> ((d,) aggregate, iterations)."""
    z = _means(stacked_grads, grouping)
    return _trim_weiszfeld(z, z.shape[1], trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol, eps=eps)


def linreg_round_ref(features, targets, theta, grouping: Grouping, *,
                     trim_multiplier: float | None = 3.0,
                     max_iters: int = 64, tol: float = 1e-8,
                     eps: float = 1e-12, tile_d: int = 256):
    """Plain PyTorch linreg round that replays the reference kernel's
    d-tile loop: the residual accumulates tile by tile onto -y, then each
    tile's gradients feed its means; the means are zero-padded to whole
    tiles, as in the reference.  -> ((d,) aggregate, iterations)."""
    _, n, d = features.shape
    x = _pad_axis(features.to(torch.float32), tile_d, 2)
    n_tiles = x.shape[2] // tile_d
    theta_p = _pad_axis(theta.to(torch.float32), tile_d, 0)
    s, bsz = _membership(grouping, x.device)
    inv_n = 1.0 / n
    tiles = [slice(i * tile_d, (i + 1) * tile_d) for i in range(n_tiles)]
    r = -targets.to(torch.float32)
    for t in tiles:
        r = r + x[:, :, t] @ theta_p[t]
    z = torch.cat([(s @ (torch.bmm(r[:, None, :], x[:, :, t])[:, 0, :]
                         * inv_n)) / bsz for t in tiles], dim=1)
    return _trim_weiszfeld(z, d, trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol, eps=eps)


def linreg_round_fused(features, targets, theta, grouping: Grouping, *,
                       trim_multiplier: float | None = 3.0,
                       max_iters: int = 64, tol: float = 1e-8,
                       eps: float = 1e-12):
    """Plain PyTorch linreg round without the tile structure: residual,
    per-worker gradients by one batched product, membership-matmul means,
    the tail.  -> ((d,) aggregate, iterations)."""
    _, n, d = features.shape
    x = features.to(torch.float32)
    s, bsz = _membership(grouping, x.device)
    r = x @ theta.to(torch.float32) - targets.to(torch.float32)   # (m, n)
    g = torch.bmm(r[:, None, :], x)[:, 0, :] * (1.0 / n)         # (m, d)
    z = (s @ g) / bsz
    return _trim_weiszfeld(z, d, trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol, eps=eps)


# ---------------------------------------------------------------------------
# the CUDA kernel

@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(SOURCE)
    ptr = ctypes.c_void_p
    lib.gmom_round_aggregate.argtypes = [
        ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
    lib.gmom_round_aggregate.restype = ctypes.c_int
    lib.gmom_round_max_batches.argtypes = []
    lib.gmom_round_max_batches.restype = ctypes.c_int
    lib.gmom_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gmom_cuda_error_string.restype = ctypes.c_char_p
    if lib.gmom_round_max_batches() != MAX_BATCHES:
        raise RuntimeError("round_aggregate.cu and round.py disagree on the "
                           "largest number of batches")
    return lib


@functools.lru_cache(maxsize=32)
def _grouping_tensors(grouping: Grouping, device: torch.device):
    offsets, members = batch_members_csr(grouping)
    bsz = np.asarray(grouping.batch_sizes, np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (offsets, members, bsz))


def round_aggregate_kernel(stacked_grads, grouping: Grouping, *,
                           trim_multiplier: float | None = 3.0,
                           max_iters: int = 64, tol: float = 1e-8,
                           eps: float = 1e-12):
    """GMoM round on the card: f32 contiguous (m, d) -> ((d,), iterations).

    Launches the CUDA kernel for a CUDA tensor; a CPU tensor runs
    ``round_aggregate_ref``.  Enqueues at most ``max_iters`` Weiszfeld
    iterations without synchronising; the early exit is a device flag."""
    g = stacked_grads
    if g.device.type == "cpu":
        return round_aggregate_ref(g, grouping,
                                   trim_multiplier=trim_multiplier,
                                   max_iters=max_iters, tol=tol, eps=eps)
    if g.device.type != "cuda":
        raise ValueError(f"round_aggregate_kernel: unsupported device "
                         f"{g.device}")
    if g.dtype != torch.float32 or g.ndim != 2 or not g.is_contiguous():
        raise ValueError("round_aggregate_kernel takes a contiguous float32 "
                         f"(m, d) tensor, got {g.dtype} {tuple(g.shape)}")
    m, d = g.shape
    k = grouping.num_batches
    if m != grouping.num_workers:
        raise ValueError(f"{m} gradient rows for a grouping of "
                         f"{grouping.num_workers} workers")
    if not 1 <= k <= MAX_BATCHES:
        raise ValueError(f"round_aggregate_kernel takes 1 <= k <= "
                         f"{MAX_BATCHES} batches, got {k}")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    lib = _library()
    offsets, members, bsz = _grouping_tensors(grouping, g.device)
    nb = num_blocks(d)
    f32 = dict(dtype=torch.float32, device=g.device)
    z = torch.empty((k, d), **f32)
    y = torch.empty((d,), **f32)
    part = torch.empty((nb, k), **f32)
    dpart = torch.empty((nb,), **f32)
    state = torch.empty((2 * k + 1,), **f32)
    flags = torch.zeros((2,), dtype=torch.int32, device=g.device)
    use_trim = trim_multiplier is not None
    rc = lib.gmom_round_aggregate(
        g.data_ptr(), offsets.data_ptr(), members.data_ptr(), bsz.data_ptr(),
        k, d, int(use_trim), float(trim_multiplier if use_trim else 0.0),
        int(max_iters), f32_threshold(tol * tol), float(eps),
        f32_threshold(eps * eps), z.data_ptr(), part.data_ptr(),
        dpart.data_ptr(), state.data_ptr(), flags.data_ptr(), y.data_ptr(),
        nb, stream(g))
    if rc != 0:
        raise RuntimeError(
            f"round_aggregate kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_cuda_error_string(rc).decode()})")
    round_aggregate_kernel.launches += 1
    return y, flags[1]


round_aggregate_kernel.launches = 0


@functools.cache
def _linreg_library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(LINREG_SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gmom_linreg_round.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ctypes.c_longlong, i32,
        f32, i32, f32, f32, f32, f32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, i32, ptr]
    lib.gmom_linreg_round.restype = ctypes.c_int
    lib.gmom_linreg_max_batches.argtypes = []
    lib.gmom_linreg_max_batches.restype = ctypes.c_int
    lib.gmom_linreg_error_string.argtypes = [ctypes.c_int]
    lib.gmom_linreg_error_string.restype = ctypes.c_char_p
    if lib.gmom_linreg_max_batches() != MAX_BATCHES:
        raise RuntimeError("linreg_round.cu and round.py disagree on the "
                           "largest number of batches")
    return lib


def linreg_split(m: int, n: int, d: int) -> int:
    """How many chunks the kernel cuts the sample axis into: enough that
    its (d-tile, worker, chunk) gradient grid fills the card."""
    base = -(-d // THREADS) * m
    want = min(n, 65535, max(1, -(-LINREG_TARGET_BLOCKS // base)))
    chunk = -(-n // want)
    return -(-n // chunk)


def linreg_round_kernel(features, targets, theta, grouping: Grouping, *,
                        trim_multiplier: float | None = 3.0,
                        max_iters: int = 64, tol: float = 1e-8,
                        eps: float = 1e-12, tile_d: int = 256):
    """One failure-free round of Algorithm 2 on the linreg testbed:
    (X (m, n, d), y (m, n), theta (d,)) -> ((d,) aggregate, iterations).

    Inputs are cast to contiguous float32.  Launches the CUDA kernel for
    CUDA tensors; CPU tensors run ``linreg_round_ref`` (``tile_d`` is the
    reference's tile and matters only there).  Enqueues at most
    ``max_iters`` Weiszfeld iterations without synchronising."""
    x, t, th = as_f32(features), as_f32(targets), as_f32(theta)
    if x.ndim != 3 or t.shape != x.shape[:2] or th.shape != x.shape[2:]:
        raise ValueError(
            f"linreg_round_kernel takes X (m, n, d), y (m, n), theta (d,); "
            f"got {tuple(x.shape)}, {tuple(t.shape)}, {tuple(th.shape)}")
    m, n, d = x.shape
    k = grouping.num_batches
    if m != grouping.num_workers:
        raise ValueError(f"{m} worker batches for a grouping of "
                         f"{grouping.num_workers} workers")
    if {x.device.type, t.device.type, th.device.type} == {"cpu"}:
        return linreg_round_ref(x, t, th, grouping,
                                trim_multiplier=trim_multiplier,
                                max_iters=max_iters, tol=tol, eps=eps,
                                tile_d=tile_d)
    if x.device.type != "cuda" or t.device != x.device \
            or th.device != x.device:
        raise ValueError(f"linreg_round_kernel: unsupported devices "
                         f"{x.device}, {t.device}, {th.device}")
    if not 1 <= k <= MAX_BATCHES:
        raise ValueError(f"linreg_round_kernel takes 1 <= k <= "
                         f"{MAX_BATCHES} batches, got {k}")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    lib = _linreg_library()
    offsets, members, bsz = _grouping_tensors(grouping, x.device)
    n_split = linreg_split(m, n, d)
    nb = num_blocks(d)
    f32 = dict(dtype=torch.float32, device=x.device)
    r = torch.empty((m, n), **f32)
    p = torch.empty((n_split, m, d), **f32)
    z = torch.empty((k, d), **f32)
    y = torch.empty((d,), **f32)
    part = torch.empty((nb, k), **f32)
    dpart = torch.empty((nb,), **f32)
    state = torch.empty((2 * k + 1,), **f32)
    flags = torch.zeros((2,), dtype=torch.int32, device=x.device)
    use_trim = trim_multiplier is not None
    rc = lib.gmom_linreg_round(
        x.data_ptr(), t.data_ptr(), th.data_ptr(), offsets.data_ptr(),
        members.data_ptr(), bsz.data_ptr(), m, n, k, d, int(use_trim),
        float(trim_multiplier if use_trim else 0.0), int(max_iters),
        f32_threshold(tol * tol), float(eps), f32_threshold(eps * eps),
        f32_threshold(1.0 / n), n_split, r.data_ptr(), p.data_ptr(),
        z.data_ptr(), part.data_ptr(), dpart.data_ptr(), state.data_ptr(),
        flags.data_ptr(), y.data_ptr(), nb, stream(x))
    if rc != 0:
        raise RuntimeError(
            f"linreg_round kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_linreg_error_string(rc).decode()})")
    linreg_round_kernel.launches += 1
    return y, flags[1]


linreg_round_kernel.launches = 0


def round_aggregate_pytree(stacked_grads, grouping: Grouping, *,
                           trim_multiplier: float | None = 3.0,
                           max_iters: int = 64, tol: float = 1e-8,
                           eps: float = 1e-12, plain: bool = False):
    """Pytree front door: stacked (m, ...) gradient pytree -> aggregate.

    Leaves are flattened and concatenated into one (m, D) f32 block (the
    median is taken in the concatenated R^D) and the result is split back,
    cast to each leaf's dtype.  ``plain=True`` runs the plain PyTorch
    version on any device (the ``fused_interpret`` backend)."""
    leaves, spec = tree_flatten(stacked_grads)
    m = leaves[0].shape[0]
    flat = [leaf.reshape(m, -1).to(torch.float32) for leaf in leaves]
    block = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    fn = round_aggregate_ref if plain else round_aggregate_kernel
    y, _ = fn(block.contiguous(), grouping, trim_multiplier=trim_multiplier,
              max_iters=max_iters, tol=tol, eps=eps)
    out, offset = [], 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape[1:], dtype=np.int64))
        out.append(y[offset:offset + size].reshape(leaf.shape[1:])
                   .to(leaf.dtype))
        offset += size
    return tree_unflatten(out, spec)
