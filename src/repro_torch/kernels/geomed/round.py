"""GMoM server round: stacked gradients -> batch means -> Remark-2 trim ->
Weiszfeld geometric median, as one persistent CUDA kernel on Hopper; and
the whole linreg round, raw worker batches in, as a front kernel and the
same persistent kernel.

Port of ``repro.kernels.geomed.round`` ``round_aggregate_kernel`` (the
Pallas TPU kernel) and its jnp twin ``round_aggregate_ref``:

* ``round_aggregate_kernel`` — the wrapper.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/round_aggregate.cu`` (one cooperative
  launch, or raises) through the custom op ``repro_torch::gmom_round``
  (CUDA only; its fake gives a fake trace the outputs, and registering
  it builds nothing); on a CPU tensor, and only there, it runs the plain
  PyTorch version.  It counts its launches in
  ``round_aggregate_kernel.launches``.
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
  tensors (or raises) through the route ``linreg_route(d)`` picks — the
  one-pass front that reads X once, or the two-pass front — and runs
  ``linreg_round_ref`` on CPU tensors; it counts its launches in
  ``linreg_round_kernel.launches`` and by route in
  ``linreg_round_kernel.route_launches``.

The launch plan (``persistent_blocks``, ``block_tiles``, ``linreg_route``,
``onepass_split``, ``sample_chunks``, ...) is plain Python, and
``round_aggregate_blocked`` / ``linreg_round_blocked`` are plain PyTorch
twins of the kernels' arithmetic on a given grid, bit for bit (the same
float32 operations in the same order, per-block partials reduced by every
block in one fixed order, each fused multiply-add emulated); the CPU tests
hold them against JAX, the card tests hold the kernels to them bit for
bit.

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
import math
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import register_flop_formula

from repro_torch import _device
from repro_torch.core.geometric_median import f32_threshold
from repro_torch.core.grouping import (Grouping, assignment_matrix,
                                       batch_members_csr)
from repro_torch.kernels.geomed._common import THREADS, as_f32, stream
from repro_torch.kernels.geomed.twin import (block_moves, block_partials,
                                             butterfly, fma, fma_chain,
                                             reduce_partials, sequential,
                                             sqrt_rn)

# repro_torch: bit-stable — the twins replay the kernels bit for bit on
# their grid (tests/test_torch_round_kernel.py): keep the op sequence, no
# torch.sum/.mean over the member axis (repro_torch.verify RV101/RV105).

# The largest k the round kernels take (``gmom_round_max_batches``).
MAX_BATCHES = 64
SOURCE = Path(__file__).resolve().parent / "csrc" / "round_aggregate.cu"
LINREG_SOURCE = SOURCE.parent / "linreg_round.cu"
# columns of a tile of the persistent grid, one per thread
# (``gmom_round_tile``)
TILE = THREADS
# the one-pass linreg front: threads of a block, float4 chunks of a row a
# thread owns, bytes of a ring stage; d it takes at most
# (``gmom_linreg_onepass_max_d``)
ONEPASS_THREADS = 512
ONEPASS_CHUNKS = 4
ONEPASS_STAGE_BYTES = 16384
D_ONEPASS = 4 * ONEPASS_CHUNKS * ONEPASS_THREADS
ROUTES = ("one_pass", "two_pass")
# the share of whole waves the one-pass front's blocks must fill
WAVE_FILL = 0.9
# the two-pass route splits the sample axis until its gradient grid has
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
        delta2 = _device.host_value(d2, traced=math.inf)
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
    # repro_torch: ignore[RV105] r and x are float32 (cast above)
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
    # repro_torch: ignore[RV105] r and x are float32 (cast above)
    g = torch.bmm(r[:, None, :], x)[:, 0, :] * (1.0 / n)         # (m, d)
    z = (s @ g) / bsz
    return _trim_weiszfeld(z, d, trim_multiplier=trim_multiplier,
                           max_iters=max_iters, tol=tol, eps=eps)


# ---------------------------------------------------------------------------
# the launch plan of the CUDA kernels (plain Python, tested on the CPU)

def persistent_blocks(d: int, blocks_per_sm: int, sms: int) -> int:
    """Blocks of the persistent round kernel: as many as the card holds at
    once (``blocks_per_sm`` from the occupancy calculator, times the SM
    count), and no more than there are tiles of ``TILE`` columns."""
    return max(1, min(blocks_per_sm * sms, -(-d // TILE)))


def block_tiles(d: int, n_blocks: int) -> list[list[tuple[int, int]]]:
    """The columns of each block of the persistent grid, as the [c0, c1)
    ranges of its tiles in the order it walks them: tile t belongs to block
    t % n_blocks in every stage of the round."""
    out: list[list[tuple[int, int]]] = [[] for _ in range(n_blocks)]
    for t in range(-(-d // TILE)):
        out[t % n_blocks].append((t * TILE, min(d, (t + 1) * TILE)))
    return out


def linreg_route(d: int) -> str:
    """The linreg round's route, by d alone: ``"one_pass"`` (X read once
    through the TMA ring) needs whole 16-byte rows (d % 4 == 0, the bulk
    copy's rule) and d <= ``D_ONEPASS`` (16 columns a thread of a
    512-thread block); every other d takes ``"two_pass"``."""
    return "one_pass" if d % 4 == 0 and d <= D_ONEPASS else "two_pass"


def onepass_row_threads(d: int) -> int:
    """Threads of the one-pass block that share one row of X: the least
    power of two from 32 up that covers the row at 16 columns a thread."""
    need = -(-(d // 4) // ONEPASS_CHUNKS)
    tpr = 32
    while tpr < need:
        tpr *= 2
    return tpr


def onepass_rows_per_stage(d: int) -> int:
    """Rows of X in one stage of the one-pass ring: a whole number of row
    groups (``ONEPASS_THREADS // onepass_row_threads(d)``), about
    ``ONEPASS_STAGE_BYTES``."""
    groups = ONEPASS_THREADS // onepass_row_threads(d)
    return max(groups, ONEPASS_STAGE_BYTES // (4 * d) // groups * groups)


def _effective_split(n: int, want: int) -> int:
    """Chunks of ceil(n / want) samples: no chunk left empty."""
    chunk = -(-n // want)
    return -(-n // chunk)


@functools.lru_cache(maxsize=256)
def onepass_split(m: int, n: int, sms: int) -> int:
    """How many sample chunks the one-pass front cuts each worker into: the
    fewest for which its m * n_split blocks (one per (chunk, worker), each
    streaming its rows at its SM's share of the bandwidth) fill whole waves
    of ``sms`` SMs to ``WAVE_FILL`` or better (m = 50 on 132 SMs: 5, 250
    blocks in two waves, 95 %).  Fewer chunks keep the partials P the tail
    sums small.  A problem too small for one wave takes one sample a
    chunk."""
    top = min(n, 65535)
    for want in range(1, top + 1):
        split = _effective_split(n, want)
        blocks = m * split
        waves = -(-blocks // sms)
        if blocks >= sms and blocks >= WAVE_FILL * waves * sms:
            return split
    return _effective_split(n, top)


def sample_chunks(m: int, n: int, n_split: int) -> list[tuple[int, int, int]]:
    """The (worker, s0, s1) rows of each linreg front block, in block order
    (chunk q, worker j): chunks of ceil(n / n_split) samples, each inside
    one worker."""
    chunk = -(-n // n_split)
    return [(j, q * chunk, min(n, (q + 1) * chunk))
            for q in range(n_split) for j in range(m)]


def linreg_split(m: int, n: int, d: int) -> int:
    """How many chunks the two-pass route's gradient kernel cuts the sample
    axis into: enough that its (d-tile, worker, chunk) grid fills the
    card."""
    base = -(-d // THREADS) * m
    want = min(n, 65535, max(1, -(-LINREG_TARGET_BLOCKS // base)))
    return _effective_split(n, want)


# ---------------------------------------------------------------------------
# plain PyTorch twins of the kernels' arithmetic, bit for bit (``twin``'s
# summation orders)

def _means_ordered(rows, grouping: Grouping):
    """Batch means (k, d) as the kernel sums them: each batch's members in
    ascending order from 0, then / batch size."""
    offsets, members = batch_members_csr(grouping)
    bsz = torch.as_tensor(np.asarray(grouping.batch_sizes, np.float32))
    return torch.stack([
        sequential([rows[int(i)] for i in members[offsets[l]:offsets[l + 1]]])
        / bsz[l] for l in range(grouping.num_batches)])


def _round_tail_blocked(z, *, n_blocks, trim_multiplier, max_iters, tol,
                        eps):
    """The persistent kernel's trim, init and Weiszfeld on the means z
    (k, d), every cross-block sum through per-block partials reduced in
    ``reduce_partials``' order -> ((d,), iterations)."""
    k = z.shape[0]
    f32 = torch.float32
    if trim_multiplier is None:
        w = torch.ones((k,), dtype=f32)
    else:
        norms = sqrt_rn(reduce_partials(block_partials(z, n_blocks)))
        tau = (torch.tensor(trim_multiplier, dtype=f32) * _median_small(norms)
               + torch.tensor(1e-12, dtype=f32))
        w = (norms <= tau).to(f32)
        w = torch.where(sequential(list(w)) > 0, w, torch.ones_like(w))
    wsum = torch.clamp(sequential(list(w)), min=eps)
    y = fma_chain((w[l], z[l]) for l in range(k)) / wsum
    part = block_partials(z - y, n_blocks)
    tol2, eps2 = f32_threshold(tol * tol), f32_threshold(eps * eps)
    it = 0
    while it < max_iters:
        inv = w / sqrt_rn(reduce_partials(part) + eps2)
        coef = inv / torch.clamp(sequential(list(inv)), min=eps)
        y_new = fma_chain((coef[l], z[l]) for l in range(k))
        move = reduce_partials(block_moves(y_new - y, n_blocks)[:, None])[0]
        part = block_partials(z - y_new, n_blocks)
        y = y_new
        it += 1
        if not float(move) > tol2:
            break
    return y, torch.tensor(it, dtype=torch.int32)


def round_aggregate_blocked(stacked_grads, grouping: Grouping, *,
                            n_blocks: int,
                            trim_multiplier: float | None = 3.0,
                            max_iters: int = 64, tol: float = 1e-8,
                            eps: float = 1e-12):
    """Plain PyTorch twin of the round kernel on a grid of ``n_blocks``,
    bit for bit: member sums in order, per-block partials of the norms,
    distances and moves, each reduced in the fixed order every block
    uses.  CPU, float32.  -> ((d,) aggregate, iterations)."""
    g = stacked_grads.to(torch.float32).cpu()
    return _round_tail_blocked(_means_ordered(g, grouping),
                               n_blocks=n_blocks,
                               trim_multiplier=trim_multiplier,
                               max_iters=max_iters, tol=tol, eps=eps)


def _onepass_partials(x, t, theta, n_split: int):
    """The one-pass front: residuals by row groups (a thread's 16 columns
    fma-chained in order, warp butterflies, the group's warps in order),
    each group's rows fma-accumulated in sample order, groups summed in
    order -> P (n_split, m, d)."""
    m, n, d = x.shape
    tpr = onepass_row_threads(d)
    groups = ONEPASS_THREADS // tpr
    width = ONEPASS_CHUNKS * tpr * 4
    # column 4 (gt + i tpr) + c lies at [i, gt, c]
    xs = _pad_axis(x, width, 2)[..., :width].reshape(m, n, ONEPASS_CHUNKS,
                                                     tpr, 4)
    ts = _pad_axis(theta, width, 0)[:width].reshape(ONEPASS_CHUNKS, tpr, 4)
    part = fma_chain((xs[..., i, :, c], ts[i, :, c])
                      for i in range(ONEPASS_CHUNKS) for c in range(4))
    warps = butterfly(part.reshape(m, n, tpr // 32, 32))
    r = sequential(list(warps.permute(2, 0, 1))) - t
    out = []
    for _, s0, s1 in sample_chunks(1, n, n_split):
        acc = [torch.zeros((m, d)) for _ in range(groups)]
        for s in range(s0, s1):
            g = (s - s0) % groups
            acc[g] = fma(x[:, s], r[:, s, None], acc[g])
        total = acc[0]
        for a in acc[1:]:
            total = total + a
        out.append(total)
    return torch.stack(out)


def _twopass_partials(x, t, theta, n_split: int):
    """residual_kernel (lane i fma-chains columns i, i + 32, ... in order,
    then the butterfly) and grad_kernel (a column's samples of a chunk
    fma-chained in order) -> P (n_split, m, d)."""
    m, n, d = x.shape
    xp, tp = _pad_axis(x, 32, 2), _pad_axis(theta, 32, 0)
    r = butterfly(fma_chain(
        (xp[..., c:c + 32], tp[c:c + 32])
        for c in range(0, xp.shape[2], 32))) - t
    return torch.stack([
        fma_chain((x[:, s], r[:, s, None]) for s in range(s0, s1))
        for _, s0, s1 in sample_chunks(1, n, n_split)])


def linreg_round_blocked(features, targets, theta, grouping: Grouping, *,
                         n_blocks: int, n_split: int,
                         route: str | None = None,
                         trim_multiplier: float | None = 3.0,
                         max_iters: int = 64, tol: float = 1e-8,
                         eps: float = 1e-12):
    """Plain PyTorch twin of the linreg kernel on a grid of ``n_blocks``
    with ``n_split`` sample chunks, bit for bit: the front of ``route``
    (default ``linreg_route(d)``) into chunk partials P, each worker's
    chunks summed in order times f32(1/n), then
    ``round_aggregate_blocked``'s tail.  CPU, float32.
    -> ((d,), iterations)."""
    x = features.to(torch.float32).cpu()
    t = targets.to(torch.float32).cpu()
    th = theta.to(torch.float32).cpu()
    n = x.shape[1]
    front = (_onepass_partials if (route or linreg_route(x.shape[2]))
             == "one_pass" else _twopass_partials)
    g = sequential(list(front(x, t, th, n_split))) * f32_threshold(1.0 / n)
    return _round_tail_blocked(_means_ordered(g, grouping), n_blocks=n_blocks,
                               trim_multiplier=trim_multiplier,
                               max_iters=max_iters, tol=tol, eps=eps)


# ---------------------------------------------------------------------------
# the CUDA kernels

def _bind_round(lib, prefix: str, entry: str, argtypes) -> ctypes.CDLL:
    """Declare a GMoM library's C interface and check that it was built
    with this module's constants."""
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for name in ("max_batches", "tile", "blocks_per_sm"):
        getattr(lib, f"{prefix}_{name}").restype = ctypes.c_int
    getattr(lib, f"{prefix}_blocks_per_sm").argtypes = [ctypes.c_int]
    if (getattr(lib, f"{prefix}_max_batches")() != MAX_BATCHES
            or getattr(lib, f"{prefix}_tile")() != TILE):
        raise RuntimeError(f"{entry}: the CUDA source and round.py disagree "
                           "on the largest k or the tile width")
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _bind_round(_build.load(SOURCE), "gmom_round",
                      "gmom_round_aggregate",
                      [ptr, ptr, ptr, ptr, i32, ctypes.c_longlong, i32, f32,
                       i32, f32, f32, f32, ptr, ptr, ptr, ptr, i32, ptr])
    lib.gmom_cuda_error_string.argtypes = [i32]
    lib.gmom_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _linreg_library() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _bind_round(_build.load(LINREG_SOURCE), "gmom_linreg",
                      "gmom_linreg_round",
                      [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                       ctypes.c_longlong, i32, f32, i32, f32, f32, f32, f32,
                       i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr])
    lib.gmom_linreg_onepass_max_d.restype = i32
    lib.gmom_linreg_error_string.argtypes = [i32]
    lib.gmom_linreg_error_string.restype = ctypes.c_char_p
    if lib.gmom_linreg_onepass_max_d() != D_ONEPASS:
        raise RuntimeError("linreg_round.cu and round.py disagree on "
                           "D_ONEPASS")
    return lib


def _grouping_arrays(grouping: Grouping):
    offsets, members = batch_members_csr(grouping)
    return offsets, members, np.asarray(grouping.batch_sizes, np.float32)


@functools.lru_cache(maxsize=32)
def _grouping_tensors(grouping: Grouping, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _grouping_arrays(grouping))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lib, prefix: str, k: int) -> int:
    n = getattr(lib, f"{prefix}_blocks_per_sm")(k)
    if n <= 0:
        raise RuntimeError(f"{prefix}: the round kernel fits no block on an "
                           f"SM at k={k} (CUDA error {-n})")
    return n


def _grouping_on(grouping: Grouping, device: torch.device):
    """``_grouping_tensors``, uncached under a fake trace (a fake tensor
    must never reach a real call through the cache) and copied there on
    any device: the card holds a copy of each array, which ``as_tensor``
    on the CPU does not make, so that a trace routed as CUDA counts the
    card's bytes."""
    if _device.tracing():
        return tuple(torch.as_tensor(a).to(device, copy=True)
                     for a in _grouping_arrays(grouping))
    return _grouping_tensors(grouping, device)


# the card a dry trace reckons the round's scratch for: the H100 SXM's
# 132 SMs (NVIDIA H100 data sheet), one block of the persistent grid each
RECKONED_SMS = 132


def scratch_bytes(k: int, d: int) -> int:
    """Bytes of the round kernel's scratch beyond its outputs on the
    persistent grid of ``RECKONED_SMS`` blocks: z (k, d padded to tiles)
    f32 where the tiles outnumber the blocks, and the (2, nb, k + 1)
    partials."""
    n_tiles = -(-d // TILE)
    nb = persistent_blocks(d, 1, RECKONED_SMS)
    z = k * n_tiles * TILE if n_tiles > nb else 0
    return 4 * (z + 2 * nb * (k + 1))


def _round_scratch(lib, prefix: str, k: int, d: int, device):
    """(n_blocks, z or None, partials (2, nb, k + 1), y, iters) of one
    round on the persistent grid."""
    nb = persistent_blocks(d, _blocks_per_sm(lib, prefix, k),
                           _sm_count(device))
    f32 = dict(dtype=torch.float32, device=device)
    n_tiles = -(-d // TILE)
    z = torch.empty((k, n_tiles * TILE), **f32) if n_tiles > nb else None
    return (nb, z, torch.empty((2, nb, k + 1), **f32),
            torch.empty((d,), **f32),
            torch.empty((1,), dtype=torch.int32, device=device))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _round_args(k, trim_multiplier, max_iters, tol, eps):
    if not 1 <= k <= MAX_BATCHES:
        raise ValueError(f"the round kernels take 1 <= k <= {MAX_BATCHES} "
                         f"batches, got {k}")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    use_trim = trim_multiplier is not None
    return (int(use_trim), float(trim_multiplier if use_trim else 0.0),
            int(max_iters), f32_threshold(tol * tol), float(eps),
            f32_threshold(eps * eps))


def _launch(g, offsets, members, bsz, use_trim, trim_multiplier, max_iters,
            tol2, eps, eps2):
    """One cooperative launch of the persistent round kernel on g's
    current stream -> ((d,) f32, (1,) int32 iterations) (the op's CUDA
    implementation)."""
    k, d = bsz.shape[0], g.shape[1]
    lib = _library()
    nb, z, part, y, iters = _round_scratch(lib, "gmom_round", k, d,
                                           g.device)
    rc = lib.gmom_round_aggregate(
        g.data_ptr(), offsets.data_ptr(), members.data_ptr(), bsz.data_ptr(),
        k, d, use_trim, trim_multiplier, max_iters, tol2, eps, eps2,
        _ptr(z), part.data_ptr(), iters.data_ptr(), y.data_ptr(), nb,
        stream(g))
    if rc != 0:
        raise RuntimeError(
            f"round_aggregate kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_cuda_error_string(rc).decode()})")
    round_aggregate_kernel.launches += 1
    return y, iters


@torch.library.custom_op("repro_torch::gmom_round", mutates_args=(),
                         device_types="cuda")
def _round_op(g: torch.Tensor, offsets: torch.Tensor, members: torch.Tensor,
              bsz: torch.Tensor, use_trim: int, trim_multiplier: float,
              max_iters: int, tol2: float, eps: float,
              eps2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(g, offsets, members, bsz, use_trim, trim_multiplier,
                   max_iters, tol2, eps, eps2)


@_round_op.register_fake
def _(g, offsets, members, bsz, use_trim, trim_multiplier, max_iters,
      tol2, eps, eps2):
    return (g.new_empty((g.shape[1],), dtype=torch.float32),
            g.new_empty((1,), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.gmom_round)
def flops(*args, out_shape=None, **kwargs) -> int:
    """No dot products: the reference's dot count gives a custom call
    none (its means, distances and sums are vector work)."""
    return 0


def round_aggregate_kernel(stacked_grads, grouping: Grouping, *,
                           trim_multiplier: float | None = 3.0,
                           max_iters: int = 64, tol: float = 1e-8,
                           eps: float = 1e-12):
    """GMoM round on the card: f32 contiguous (m, d) -> ((d,), iterations).

    Launches the persistent CUDA kernel (one cooperative launch, the op
    ``repro_torch::gmom_round``, whose fake gives a fake trace its
    outputs) for a CUDA tensor; a CPU tensor runs ``round_aggregate_ref``.
    The early exit is taken on the device; nothing synchronises the
    host."""
    g = stacked_grads
    if _device.device_type(g) == "cpu":
        return round_aggregate_ref(g, grouping,
                                   trim_multiplier=trim_multiplier,
                                   max_iters=max_iters, tol=tol, eps=eps)
    if _device.device_type(g) != "cuda":
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
    args = _round_args(k, trim_multiplier, max_iters, tol, eps)
    offsets, members, bsz = _grouping_on(grouping, g.device)
    y, iters = torch.ops.repro_torch.gmom_round(g, offsets, members, bsz,
                                                *args)
    return y, iters.squeeze(0)


round_aggregate_kernel.launches = 0


def _aligned(t):
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    bulk copy's rule)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _linreg_launch(x, t, th, grouping: Grouping, route: str, *,
                   trim_multiplier, max_iters, tol, eps):
    """One linreg round on the card through ``route``; counts the launch
    (and its route) -> ((d,), iterations)."""
    m, n, d = x.shape
    k = grouping.num_batches
    args = _round_args(k, trim_multiplier, max_iters, tol, eps)
    one_pass = route == "one_pass"
    if one_pass and linreg_route(d) != "one_pass":
        raise ValueError(f"the one-pass route takes d % 4 == 0 and d <= "
                         f"{D_ONEPASS}, got d={d}")
    lib = _linreg_library()
    offsets, members, bsz = _grouping_tensors(grouping, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    if one_pass:
        x, th = _aligned(x), _aligned(th)
        n_split, r = onepass_split(m, n, _sm_count(x.device)), None
    else:
        n_split = linreg_split(m, n, d)
        r = torch.empty((m, n), **f32)
    p = torch.empty((n_split, m, d), **f32)
    nb, z, part, y, iters = _round_scratch(lib, "gmom_linreg", k, d,
                                           x.device)
    rc = lib.gmom_linreg_round(
        x.data_ptr(), t.data_ptr(), th.data_ptr(), offsets.data_ptr(),
        members.data_ptr(), bsz.data_ptr(), m, n, k, d, *args,
        f32_threshold(1.0 / n), int(one_pass), n_split, _ptr(r),
        p.data_ptr(), _ptr(z), part.data_ptr(), iters.data_ptr(),
        y.data_ptr(), nb, stream(x))
    if rc != 0:
        raise RuntimeError(
            f"linreg_round kernel launch failed: CUDA error {rc} "
            f"({lib.gmom_linreg_error_string(rc).decode()})")
    linreg_round_kernel.launches += 1
    linreg_round_kernel.route_launches[route] += 1
    return y, iters.squeeze(0)


def linreg_round_kernel(features, targets, theta, grouping: Grouping, *,
                        trim_multiplier: float | None = 3.0,
                        max_iters: int = 64, tol: float = 1e-8,
                        eps: float = 1e-12, tile_d: int = 256):
    """One failure-free round of Algorithm 2 on the linreg testbed:
    (X (m, n, d), y (m, n), theta (d,)) -> ((d,) aggregate, iterations).

    Inputs are cast to contiguous float32.  CUDA tensors go through the
    CUDA kernels of ``linreg_route(d)`` (counted in ``launches`` and
    ``route_launches``); CPU tensors run ``linreg_round_ref`` (``tile_d``
    is the reference's tile and matters only there).  The early exit is
    taken on the device; nothing synchronises the host."""
    x, t, th = as_f32(features), as_f32(targets), as_f32(theta)
    if x.ndim != 3 or t.shape != x.shape[:2] or th.shape != x.shape[2:]:
        raise ValueError(
            f"linreg_round_kernel takes X (m, n, d), y (m, n), theta (d,); "
            f"got {tuple(x.shape)}, {tuple(t.shape)}, {tuple(th.shape)}")
    m, n, d = x.shape
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
    return _linreg_launch(x, t, th, grouping, linreg_route(d),
                          trim_multiplier=trim_multiplier,
                          max_iters=max_iters, tol=tol, eps=eps)


def reset_linreg_launches() -> None:
    """Zero ``linreg_round_kernel.launches`` and its per-route counts."""
    linreg_round_kernel.launches = 0
    linreg_round_kernel.route_launches = dict.fromkeys(ROUTES, 0)


reset_linreg_launches()


def concat_block(stacked_grads):
    """Stacked (m, ...) gradient pytree -> ((m, D) float32 block, split):
    each leaf flattened and cast into its columns of one block (no f32
    copy of a leaf beside it: at LM width the block alone is m x P x 4
    bytes), and ``split(y)`` the (D,) result back as the tree, each leaf
    in its own dtype."""
    leaves, spec = tree_flatten(stacked_grads)
    m = leaves[0].shape[0]
    shapes = [(leaf.shape[1:], leaf.dtype) for leaf in leaves]
    sizes = [int(np.prod(shape, dtype=np.int64)) for shape, _ in shapes]
    block = torch.empty((m, sum(sizes)), dtype=torch.float32,
                        device=leaves[0].device)
    offset = 0
    for leaf, size in zip(leaves, sizes):
        block[:, offset:offset + size].copy_(leaf.reshape(m, size))
        offset += size

    def split(y):
        out, offset = [], 0
        for (shape, dtype), size in zip(shapes, sizes):
            out.append(y[offset:offset + size].reshape(shape).to(dtype))
            offset += size
        return tree_unflatten(out, spec)

    return block, split


def round_aggregate_pytree(stacked_grads, grouping: Grouping, *,
                           trim_multiplier: float | None = 3.0,
                           max_iters: int = 64, tol: float = 1e-8,
                           eps: float = 1e-12, plain: bool = False):
    """Pytree front door: stacked (m, ...) gradient pytree -> aggregate.

    Leaves are flattened and concatenated into one (m, D) f32 block
    (``concat_block``: the median is taken in the concatenated R^D) and
    the result is split back, cast to each leaf's dtype.  ``plain=True``
    runs the plain PyTorch version on any device (the ``fused_interpret``
    backend)."""
    block, split = concat_block(stacked_grads)
    fn = round_aggregate_ref if plain else round_aggregate_kernel
    y, _ = fn(block, grouping, trim_multiplier=trim_multiplier,
              max_iters=max_iters, tol=tol, eps=eps)
    del block
    return split(y)
