"""``jax.random`` on threefry2x32, bit for bit, in PyTorch.

The system's output is a seeded trajectory, so the port draws exactly the
bits the reference draws: the threefry2x32 hash with JAX's
*non-partitionable* key derivation (``jax_threefry_partitionable=False``,
the scheme the golden traces were recorded with).  Mirrors
``jax/_src/prng.py`` (``threefry_2x32``, ``_threefry_split_original``,
``_threefry_fold_in``, ``_threefry_random_bits_original``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real``, ``_randint``,
``_bernoulli``).

A key is a (2,) int64 tensor holding two uint32 words; every intermediate
is masked to 32 bits, so the hash is exact integer arithmetic and gives
the same bits on the CPU and on the card.  Draws land on the key's device.
``uniform``, ``randint`` and ``bernoulli`` are bit-exact; ``normal`` goes through ``torch.erfinv``, which
differs from XLA's ``erf_inv`` by a few ulps.

``bits_at``, ``uniform_at`` and ``normal_at`` give the words (or the
uniforms, the normals) at given flat indices of a draw of the whole
shape, without the whole draw: word i of ``bits(key, (n,))`` is one
output of the hash of one pair of counters (``_words_at``), so a rank's
block of a sharded draw costs its own size.  They work ``DRAW_CHUNK``
indices at a time, and whole draws ``DRAW_CHUNK`` pairs of counters at a
time, which bounds their int64 temporaries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) on int64 tensors of uint32s."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def threefry_2x32(key, count):
    """Hash a flat int64 ``count`` tensor (uint32 values) under ``key``.

    Counter i is paired with counter i + n/2; an odd count is padded with
    one zero that is dropped from the output."""
    n = count.numel()
    flat = count.reshape(-1)
    odd = n % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    y0, y1 = _threefry2x32(key[0], key[1], flat[:half], flat[half:])
    out = torch.cat([y0, y1])
    return out[:n] if odd else out


def PRNGKey(seed: int, *, device=None):
    """``jax.random.PRNGKey(seed)`` (32-bit seeds, as with x64 disabled)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _iota(n: int, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` is an int or an integer 0-d tensor."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    return threefry_2x32(key, torch.stack([torch.zeros_like(d), d]))


def split(key, num: int = 2):
    """``jax.random.split`` -> (num, 2) keys."""
    return threefry_2x32(key, _iota(2 * num, key.device)).reshape(num, 2)


# pairs of counters (whole draws) or indices (``*_at``) a chunk: each
# int64 temporary of the hash is 32 MiB, a dozen of them live at once
DRAW_CHUNK = 1 << 22


# the most words one counter run draws: a draw of n >= _BLOCK_WORDS words
# is, as in JAX's original threefry scheme, blocks of _BLOCK_WORDS words,
# block j from key j of split(key, blocks + 1), the remainder from the
# last key
_BLOCK_WORDS = _MASK


def _draw(key, shape, fn):
    """``fn(words)`` of ``bits(key, shape)``: the whole count's draw, or
    its blocks (``_BLOCK_WORDS``) side by side."""
    shape = tuple(shape)
    n = math.prod(shape)
    nblocks, rem = divmod(n, _BLOCK_WORDS)
    if not nblocks:
        return _draw_run(key, n, fn).reshape(shape)
    keys = split(key, nblocks + 1)
    parts = [_draw_run(keys[j], _BLOCK_WORDS, fn) for j in range(nblocks)]
    if rem:
        parts.append(_draw_run(keys[nblocks], rem, fn))
    return torch.cat(parts).reshape(shape)


def _draw_run(key, n: int, fn):
    """``fn(words)`` of one counter run of ``n`` words, ``DRAW_CHUNK``
    pairs of counters at a time: ``threefry_2x32``'s pair j (counters j
    and j + h, h = ceil(n / 2), a partner equal to n the odd count's zero
    pad) gives words j and j + h, so a draw holds its output and one
    chunk's temporaries, never the whole count's."""
    half = (n + 1) // 2
    out = None
    for lo in range(0, half, DRAW_CHUNK):
        hi = min(lo + DRAW_CHUNK, half)
        x0 = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
        x1 = x0 + half
        x1 = torch.where(x1 == n, torch.zeros_like(x1), x1)
        y0, y1 = _threefry2x32(key[0], key[1], x0, x1)
        first, second = fn(y0), fn(y1[:n - half - lo])
        if out is None:
            out = torch.empty(n, dtype=first.dtype, device=first.device)
        out[lo:hi] = first
        out[half + lo:half + lo + second.numel()] = second
    if out is None:
        out = fn(torch.zeros(0, dtype=torch.int64, device=key.device))
    return out


def bits(key, shape):
    """``jax.random.bits`` with 32-bit width: int64 tensor of uint32s."""
    return _draw(key, shape, lambda w: w)


def _words_at(key, n: int, index):
    """Words ``index`` (flat int64, all below ``n``) of ``bits(key,
    (n,))``.  ``threefry_2x32`` pairs counter j with counter j + h (h =
    ceil(n / 2); a partner equal to n is the odd count's zero pad): word
    i < h is output 0 of the pair (i, i + h), word i >= h output 1 of the
    pair (i - h, i)."""
    half = (n + 1) // 2
    first = index < half
    x0 = torch.where(first, index, index - half)
    x1 = torch.where(first, index + half, index)
    x1 = torch.where(x1 == n, torch.zeros_like(x1), x1)
    y0, y1 = _threefry2x32(key[0], key[1], x0, x1)
    return torch.where(first, y0, y1)


def _block_words_at(key, n: int, index):
    """``_words_at`` of a draw of ``n`` words that may be blocks
    (``_BLOCK_WORDS``): each index's word from its block's key."""
    nblocks, rem = divmod(n, _BLOCK_WORDS)
    if not nblocks:
        return _words_at(key, n, index)
    keys = split(key, nblocks + 1)
    block = torch.div(index, _BLOCK_WORDS, rounding_mode="floor")
    at = index - block * _BLOCK_WORDS
    out = torch.zeros_like(index)
    for j in range(nblocks + (1 if rem else 0)):
        sel = block == j
        words = _words_at(keys[j], _BLOCK_WORDS if j < nblocks else rem,
                          torch.where(sel, at, torch.zeros_like(at)))
        out = torch.where(sel, words, out)
    return out


def _draw_at(key, shape, index, fn):
    """``fn(words)`` at the flat ``index`` of a draw of ``shape``, taken
    ``DRAW_CHUNK`` indices at a time into an output of ``index``'s
    shape."""
    n = math.prod(tuple(shape))
    flat = index.reshape(-1).to(torch.int64)
    out = None
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        part = fn(_block_words_at(key, n, flat[lo:lo + DRAW_CHUNK]))
        if out is None:
            out = torch.empty(flat.numel(), dtype=part.dtype,
                              device=part.device)
        out[lo:lo + part.numel()] = part
    if out is None:
        out = fn(flat)
    return out.reshape(index.shape)


def bits_at(key, shape, index):
    """``bits(key, shape)`` at the flat (row-major) ``index`` (an int64
    tensor; the result has its shape), without the whole draw."""
    return _draw_at(key, shape, index, lambda w: w)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _uniform_of(words, minval, maxval):
    """Uniform float32s in [minval, maxval) from 32-bit words: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled."""
    word = (words >> 9) | 0x3F800000
    floats = word.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, words.device), _f32(maxval, words.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32."""
    return _draw(key, shape, lambda w: _uniform_of(w, minval, maxval))


def uniform_at(key, shape, index, minval=0.0, maxval=1.0):
    """``uniform(key, shape, ...)`` at the flat ``index``, without the
    whole draw."""
    return _draw_at(key, shape, index,
                    lambda w: _uniform_of(w, minval, maxval))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _normal_of(words):
    u = _uniform_of(words, _NORMAL_LO, 1.0)
    return _f32(_SQRT2, words.device) * torch.erfinv(u)


def normal(key, shape):
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(U(-1+ulp, 1))."""
    return _draw(key, shape, _normal_of)


def normal_at(key, shape, index):
    """``normal(key, shape)`` at the flat ``index``, without the whole
    draw."""
    return _draw_at(key, shape, index, _normal_of)


def _wrap_int32(x):
    """int64 -> int32 with two's-complement wraparound (XLA's int32 add)."""
    return (((x + 2 ** 31) & _MASK) - 2 ** 31).to(torch.int32)


def randint(key, shape, minval, maxval):
    """``jax.random.randint`` in int32 (x64 disabled): uniform integers in
    [minval, maxval), broadcast to ``shape``.

    Two 32-bit draws from ``split(key)`` (high and low words), each reduced
    mod ``span = maxval - minval`` (as uint32, 1 where maxval <= minval);
    the high word is scaled by ``(2**16 % span)**2 % span``, every product
    and sum wrapping in uint32 as the reference's do (so the scale is 0,
    not 2**32 mod span, once span > 2**16), and the sum is reduced
    again.  Bounds are
    clipped to int32 as the reference clips them; a bound outside int32
    cannot reach the reference with x64 disabled."""
    shape = tuple(shape)
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev).clamp(
        -2 ** 31, 2 ** 31 - 1)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev).clamp(
        -2 ** 31, 2 ** 31 - 1)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return _wrap_int32(lo + offset)


def bernoulli(key, p=0.5, shape=None):
    """``jax.random.bernoulli`` (mode "low"): ``uniform(key, shape) < p`` in
    float32; ``shape`` defaults to ``p``'s."""
    p = _f32(p, key.device)
    shape = tuple(p.shape) if shape is None else tuple(shape)
    return uniform(key, shape) < p
