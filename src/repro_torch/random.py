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


def bits(key, shape):
    """``jax.random.bits`` with 32-bit width: int64 tensor of uint32s."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= _MASK:
        raise NotImplementedError(
            "more than 2**32 - 1 random words in one draw")
    return threefry_2x32(key, _iota(size, key.device)).reshape(shape)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    word = (bits(key, shape) >> 9) | 0x3F800000
    floats = word.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval, key.device), _f32(maxval, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key, shape):
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(U(-1+ulp, 1))."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _f32(_SQRT2, key.device) * torch.erfinv(u)


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
