"""GMoM server round: stacked gradients -> batch means -> Remark-2 trim ->
Weiszfeld geometric median, as one CUDA kernel pipeline on Hopper.

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

Both return ``(y, iters)``: the (d,) aggregate and the number of Weiszfeld
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

# The kernel keeps a column's k batch means in registers; the largest
# register file it is compiled for is 64 (``gmom_round_max_batches``).
MAX_BATCHES = 64
THREADS = 256
MAX_BLOCKS = 1024
SOURCE = Path(__file__).resolve().parent / "csrc" / "round_aggregate.cu"


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


def _means(stacked_grads, grouping: Grouping):
    k = grouping.num_batches
    dev = stacked_grads.device
    s = torch.as_tensor(assignment_matrix(grouping), device=dev)
    bsz = torch.tensor(grouping.batch_sizes, dtype=torch.float32,
                       device=dev).reshape(k, 1)
    return (s @ stacked_grads.to(torch.float32)) / bsz


def round_aggregate_ref(stacked_grads, grouping: Grouping, *,
                        trim_multiplier: float | None = 3.0,
                        max_iters: int = 64, tol: float = 1e-8,
                        eps: float = 1e-12):
    """Plain PyTorch GMoM round: (m, d) -> ((d,) aggregate, iterations)."""
    z = _means(stacked_grads, grouping)
    w = _trim_weights_resident(z, trim_multiplier=trim_multiplier,
                               k=grouping.num_batches)
    y, it = _weiszfeld_resident(z, w, max_iters=max_iters, tol=tol, eps=eps)
    return y[0], torch.tensor(it, dtype=torch.int32, device=z.device)


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


def _num_blocks(d: int) -> int:
    return max(1, min(-(-d // THREADS), MAX_BLOCKS))


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
    nb = _num_blocks(d)
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
        nb, torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"round_aggregate kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_cuda_error_string(rc).decode()})")
    round_aggregate_kernel.launches += 1
    return y, flags[1]


round_aggregate_kernel.launches = 0


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
