"""Plain PyTorch emulation of the GMoM kernels' float32 arithmetic, bit for
bit: the same operations in the same order, every fused multiply-add of
the CUDA sources (``__fmaf_rn``) as ``fma``, every root (``__fsqrt_rn``)
as ``sqrt_rn``, and the kernels' summation orders over threads, warps and
blocks.  The twins of the kernels (``round.round_aggregate_blocked``,
``round.linreg_round_blocked``, ``ref.weiszfeld_distances_blocked``,
``ops.geometric_median_blocked``) are built from these pieces; the card
tests hold each kernel to its twin with ``torch.equal``.

A tile of the persistent grid is ``THREADS`` columns, one a thread
(``round.TILE``); tile t belongs to block t % n_blocks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.geomed._common import THREADS


def fma(a, b, c):
    """``fmaf(a, b, c)`` of float32 tensors, rounded once: a * b is exact in
    float64, the float64 sum s is off the exact a * b + c by e (TwoSum),
    and e decides only where s lies on a float32 tie."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    r64 = r.double()
    other = torch.nextafter(r, torch.where(s > r64, torch.inf, -torch.inf))
    tie = (s != r64) & (s == (r64 + other.double()) * 0.5) & (e != 0)
    up = torch.where(e > 0, torch.maximum(r, other), torch.minimum(r, other))
    return torch.where(tie, up, r)


def sqrt_rn(x):
    """``__fsqrt_rn``: float32 square roots rounded once (through float64,
    where the second rounding is harmless; the CPU's float32 ``torch.sqrt``
    is off by one ulp on some inputs)."""
    return torch.sqrt(x.double()).float()


def butterfly(v):
    """Lane 0 after ``warp_sum``'s shfl_down butterfly (16, 8, 4, 2, 1)
    over the last axis of 32 lanes."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def sequential(terms):
    """0 + t_0 + t_1 + ... in order (a float loop in one thread)."""
    total = torch.zeros_like(terms[0])
    for t in terms:
        total = total + t
    return total


def fma_chain(pairs):
    """s = fma(a, b, s) from s = 0 over the (a, b) pairs in order."""
    pairs = list(pairs)
    s = torch.zeros_like(pairs[0][0] * pairs[0][1])
    for a, b in pairs:
        s = fma(a, b, s)
    return s


def reduce_partials(part):
    """``reduce_partials`` over a (n_blocks, k) buffer -> (k,): lane i sums
    rows i, i + 32, ... in order, then the butterfly.  Every block of a
    persistent grid runs it on the same buffer."""
    nb, k = part.shape
    rows = -(-nb // 32) * 32
    padded = torch.cat([part, part.new_zeros((rows - nb, k))])
    return butterfly(sequential(list(padded.reshape(rows // 32, 32, k))).T)


def tiles(values, n_blocks: int):
    """(..., d) -> (..., steps, n_blocks, THREADS): tile t of block t %
    n_blocks at step t // n_blocks, zero past d (a dead column adds 0)."""
    d = values.shape[-1]
    n_tiles = -(-d // THREADS)
    steps = -(-n_tiles // n_blocks)
    pad = steps * n_blocks * THREADS - d
    v = torch.cat([values, values.new_zeros(values.shape[:-1] + (pad,))], -1)
    return v.reshape(values.shape[:-1] + (steps, n_blocks, THREADS))


def block_partials(e, n_blocks: int):
    """Per-block partials (n_blocks, k) of sum_c e[l, c]^2 over tiles.  A
    block that owns one tile squares its column in each thread, sums each
    warp's 32 columns by the butterfly and then its warps in order; a
    block that owns more gives batch l to one warp, whose lane i
    fma-accumulates columns i, i + 32, ... of each tile in tile order, then
    the butterfly."""
    k, d = e.shape
    t = tiles(e, n_blocks)
    steps = t.shape[1]
    one = t[:, 0].reshape(k, n_blocks, THREADS // 32, 32)
    resident = sequential(list(butterfly(one * one).permute(2, 0, 1)))
    lanes = t.reshape(k, steps, n_blocks, THREADS // 32, 32)
    streamed = butterfly(fma_chain(
        (lanes[:, i, :, q], lanes[:, i, :, q])
        for i in range(steps) for q in range(THREADS // 32)))
    n_tiles = -(-d // THREADS)
    owned = torch.tensor([len(range(b, n_tiles, n_blocks))
                          for b in range(n_blocks)])
    return torch.where(owned == 1, resident, streamed).T


def block_moves(mv, n_blocks: int):
    """``block_sum_scalar`` of each block's squared moves over tiles ->
    (n_blocks,): each thread fma-accumulates its column of every tile,
    then the warp butterflies, then the warps in order."""
    t = tiles(mv, n_blocks)
    acc = fma_chain((row, row) for row in t)
    return sequential(list(
        butterfly(acc.reshape(n_blocks, THREADS // 32, 32)).T))


def unit_partials(e, n_blocks: int, vec: int):
    """Per-block partials (n_blocks, r) of sum_c e[l, c]^2, e (r, d), in
    the order of the kernels that stream units of ``vec`` columns (sqdist,
    the register-streamed loop): thread t of block b fma-accumulates e^2
    over the units u = b * THREADS + t + i * n_blocks * THREADS in order,
    the columns of a unit in order; then the warp butterflies and the
    warps in order."""
    r, d = e.shape
    span = n_blocks * THREADS
    steps = -(-(d // vec) // span)
    e = torch.cat([e, e.new_zeros((r, steps * span * vec - d))], dim=1)
    e = e.reshape(r, steps, n_blocks, THREADS, vec)
    acc = fma_chain((e[:, s, ..., i], e[:, s, ..., i])
                    for s in range(steps) for i in range(vec))
    warps = butterfly(acc.reshape(r, n_blocks, THREADS // 32, 32))
    return sequential(list(warps.permute(2, 0, 1))).T
