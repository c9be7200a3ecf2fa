"""Gradient compression codecs for the worker -> server report wire
(PyTorch port of ``repro.core.compression``).

Workers *encode* their stacked reports, the wire carries the payload, and
the server either *decodes* it back to floats before a generic robust rule
or, for an aggregator whose ``native_codec`` matches
(``sign_sgd_majority``), consumes the payload directly.

Registered codecs:

* ``none``            — identity passthrough (the default wire).
* ``sign``            — 1 bit a coordinate: the IEEE sign bit
                        (``torch.signbit``: -0.0 and negative subnormals
                        count as negative, +0.0 as positive), packed
                        LSB-first into uint8 words along each leaf's last
                        dim.  Deterministic and dtype-independent.
* ``int8_stochastic`` — 8 bits a coordinate plus one float32 scale per
                        (worker, leaf): ``amax * (1/127)`` scaling and
                        keyed stochastic rounding, unbiased.

Every step is exact on both devices (integer vote counts, threefry bits,
an exact max, a constant multiply, an IEEE division and a floor), so the
int8 payload is the same bits on the CPU and on the card, and the same as
the JAX package's for the same key.  Leaf i of the int8 wire draws from
``fold_in(key, i)`` with leaves in JAX's order (``repro_torch.tree``);
under a blocked 1-D ``shard_spec`` shard j of a leaf draws from
``fold_in(fold_in(key, i), j)`` and its scale is the ordered max of the
per-shard maxima, so each shard's payload is the same on a rank and in
the virtual oracle.  On the 2D layout (a ``shard_spec`` with ``layout``,
the mesh step's) the payload is the reference's unsharded one, as GSPMD
computes it: each rank's ``q`` block is its cut of the unsharded ``q``
(its block of the whole leaf's draw, ``shard_aggregation.draw_block``)
and every scale is the unsharded one (the blocks' maxima chain-maxed
over the whole mesh).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch
from torch.utils._pytree import tree_map

from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.core import shard_aggregation as sa
from repro_torch.models import meshctx

EncodeFn = Callable[..., object]   # stacked pytree -> payload pytree
DecodeFn = Callable[..., object]   # (payload, like) -> stacked pytree

_REGISTRY: dict[str, "Codec"] = {}


@dataclasses.dataclass(frozen=True)
class Codec:
    """Registry entry for one wire format: ``encode(stacked, key=None,
    shard_spec=None)`` -> payload, ``decode(payload, like)`` -> a stacked
    pytree with ``like``'s shapes and dtypes (only ``.shape``, ``.ndim``
    and ``.dtype`` are read), whether it needs a key, and its nominal
    width."""
    name: str
    description: str
    encode: EncodeFn
    decode: DecodeFn
    needs_key: bool = False
    bits_per_coordinate: float = 32.0


def register(name: str, description: str, *, encode: EncodeFn,
             decode: DecodeFn, needs_key: bool = False,
             bits_per_coordinate: float = 32.0) -> Codec:
    codec = Codec(name=name, description=description, encode=encode,
                  decode=decode, needs_key=needs_key,
                  bits_per_coordinate=bits_per_coordinate)
    _REGISTRY[name] = codec
    return codec


def get_codec(name: str) -> Codec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def describe() -> list[tuple[str, str]]:
    """(name, description) rows for every registered codec, sorted."""
    return [(n, _REGISTRY[n].description) for n in available()]


# ---------------------------------------------------------------------------
# sign: 1-bit packing of the last dim

def packed_words(d: int) -> int:
    """uint8 words needed for d sign bits (last-dim padding to 8)."""
    return -(-d // 8)


def _with_param_dim(leaf):
    """A stacked leaf with no param dims (shape (m,)) packs as (m, 1)."""
    return leaf[:, None] if leaf.ndim == 1 else leaf


def pack_signs(x):
    """Sign bits of ``x`` packed LSB-first into uint8 along the last dim;
    bit 1 means ``torch.signbit``.  The last dim is zero-padded to a
    multiple of 8."""
    d = x.shape[-1]
    words = packed_words(d)
    bits = torch.signbit(x).to(torch.uint8)
    pad = words * 8 - d
    if pad:
        bits = torch.cat([bits, bits.new_zeros(tuple(x.shape[:-1]) + (pad,))],
                         dim=-1)
    bits = bits.reshape(tuple(x.shape[:-1]) + (words, 8))
    word = bits[..., 0]
    for b in range(1, 8):
        word = word | (bits[..., b] << b)
    return word


def unpack_signs(packed, d: int):
    """Inverse of :func:`pack_signs`: (..., words) uint8 -> (..., d) {0,1}
    uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(tuple(packed.shape[:-1]) + (packed.shape[-1] * 8,))
    return bits[..., :d]


def _sign_encode(stacked, *, key=None, shard_spec=None):
    del key, shard_spec   # deterministic; packing is shard-local by design
    return {"packed": tree_map(lambda g: pack_signs(_with_param_dim(g)),
                               stacked)}


def _sign_decode(payload, like):
    def leaf(p, g):
        d = g.shape[-1] if g.ndim > 1 else 1
        bits = unpack_signs(p, d)
        signs = (1 - 2 * bits.to(torch.int8)).to(g.dtype)
        return signs[..., 0] if g.ndim == 1 else signs
    return tree_map(leaf, payload["packed"], like)


# ---------------------------------------------------------------------------
# coordinate-wise majority vote (the sign_sgd_majority server rule)
#
# Both entry points count the negative votes of a coordinate as an exact
# int32 sum of {0,1}, so the raw path (compression="none") and the packed
# wire (compression="sign") agree bit for bit; ties (2 n_neg == m) go to +1.

def _vote(n_neg, m: int, dtype):
    return torch.where(2 * n_neg > m, -1, 1).to(dtype)


def majority_vote_signs(stacked):
    """Vote on raw stacked reports: leaf (m, ...) -> ±1 of (...)."""
    def leaf(g):
        n_neg = torch.sum(torch.signbit(g).to(torch.int32), dim=0)
        return _vote(n_neg, g.shape[0], g.dtype)
    return tree_map(leaf, stacked)


def majority_vote_packed(payload, like):
    """Vote on the packed sign payload without reconstructing gradients."""
    def leaf(p, g):
        d = g.shape[-1] if g.ndim > 1 else 1
        bits = unpack_signs(p, d)                               # (m, ..., d)
        vote = _vote(torch.sum(bits.to(torch.int32), dim=0), g.shape[0],
                     g.dtype)
        return vote[..., 0] if g.ndim == 1 else vote
    return tree_map(leaf, payload["packed"], like)


# ---------------------------------------------------------------------------
# int8_stochastic: per-(worker, leaf) scale + keyed stochastic rounding

def _chain_max(parts):
    """Ordered maximum over the leading axis (max is exact, so this equals
    ``torch.amax(dim=0)``; the chain keeps both blocked modes alike)."""
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = torch.maximum(acc, parts[i])
    return acc


def _layout_amax(gf, spec: "sa.ShardSpec"):
    """(m,) maxima of |g| over a leaf's whole coordinates from its blocks
    on the 2D layout: each rank's maxima of its block, gathered over the
    whole mesh in rank order and chain-maxed (``shard_map``), or the same
    rank by rank on the whole leaf (``virtual``).  Max is exact, so
    either is the unsharded maximum bit for bit, replicas and all."""
    dims = tuple(range(1, gf.ndim))
    ps = spec.layout[0][1:]
    if spec.mode == "virtual":
        sizes = dict(spec.mesh_shape)
        names = [a for a, _ in spec.mesh_shape]
        return _chain_max(torch.stack([
            torch.amax(torch.abs(meshctx.cut(
                gf, ps, dict(zip(names, c)), sizes)), dim=dims)
            for c in itertools.product(*(range(n)
                                         for _, n in spec.mesh_shape))]))
    mesh = sa._layout_mesh(spec)
    return _chain_max(sa.all_gather(torch.amax(torch.abs(gf), dim=dims),
                                    mesh.group(mesh.axis_names)[0]))


def _int8_encode(stacked, *, key=None, shard_spec=None):
    if key is None:
        raise ValueError(
            "int8_stochastic requires a PRNG key for stochastic rounding "
            "(aggregate_reported threads a per-round key automatically)")
    layout = shard_spec is not None and shard_spec.layout is not None
    blocked = shard_spec is not None and shard_spec.blocked and not layout
    q_leaves, s_leaves = [], []
    lspecs = sa.leaf_specs(shard_spec if layout else None, stacked)
    for i, (g, lspec) in enumerate(zip(jtree.leaves(stacked), lspecs)):
        kleaf = prng.fold_in(key, i)
        gf = g.to(torch.float32)
        # 1-D shard modes: leaves with param dims are split on their last
        # dim, with a key a shard; (m,) leaves are replicated
        mode = shard_spec.mode if blocked and g.ndim > 1 else None
        dims = tuple(range(1, g.ndim))
        if g.ndim == 1:
            amax = torch.abs(gf)                                   # (m,)
        elif layout:
            amax = _layout_amax(gf, lspec)
        elif mode == "shard_map":
            amax = _chain_max(sa.all_gather(
                torch.amax(torch.abs(gf), dim=dims),
                sa.shard_group(shard_spec)))
        elif mode == "virtual":
            s = shard_spec.num_shards
            amax = _chain_max(torch.stack([
                torch.amax(torch.abs(sa.shard_slice(gf, j, s)), dim=dims)
                for j in range(s)]))
        else:
            amax = torch.amax(torch.abs(gf), dim=dims)
        # a constant multiply, as the reference scales (one exactly
        # rounded float32 op), not a division by 127
        inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32,
                              device=g.device)
        scale = torch.where(amax > 0.0, amax * inv127,
                            torch.ones_like(amax))                 # (m,)
        y = gf / scale.reshape((-1,) + (1,) * (g.ndim - 1))        # |y|<=127
        if mode == "shard_map":
            u = prng.uniform(
                prng.fold_in(kleaf, sa.shard_index(shard_spec)),
                tuple(g.shape))
        elif mode == "virtual":
            s = shard_spec.num_shards
            c = g.shape[-1] // s
            u = torch.cat([
                prng.uniform(prng.fold_in(kleaf, j),
                             tuple(g.shape[:-1]) + (c,))
                for j in range(s)], dim=-1)
        else:
            # the unsharded draw of the whole leaf (the reference's plain
            # and gspmd branches); on the 2D layout the rank's block of it
            u = sa.draw_block(lspec, g, prng.fold_in(kleaf, 0), "uniform")
        # jnp.clip's form, a max then a min: a guard of a range |y| <= 127
        # already keeps, which repro_torch.verify's taint engine must not
        # credit as a clip of the report (it credits two-sided clamps)
        qv = torch.floor(y + u).clamp_min_(-127.0).clamp_max_(127.0).to(
            torch.int8)
        q_leaves.append(qv)
        s_leaves.append(scale)
    return {"q": jtree.unflatten(stacked, q_leaves),
            "scale": jtree.unflatten(stacked, s_leaves)}


def _int8_decode(payload, like):
    def leaf(qv, s, g):
        sb = s.reshape((-1,) + (1,) * (qv.ndim - 1))
        return (qv.to(torch.float32) * sb).to(g.dtype)
    return tree_map(leaf, payload["q"], payload["scale"], like)


# ---------------------------------------------------------------------------
# none: identity passthrough

def _none_encode(stacked, *, key=None, shard_spec=None):
    del key, shard_spec
    return stacked


def _none_decode(payload, like):
    del like
    return payload


register("none",
         "identity passthrough — full-precision reports, the paper's "
         "O(md log N)-bit wire (§1.4)",
         encode=_none_encode, decode=_none_decode,
         bits_per_coordinate=32.0)

register("sign",
         "1-bit sign compression [Jin et al. '19]: the IEEE sign bit of "
         "every coordinate, packed LSB-first into uint8 words along each "
         "leaf's last (shard-partitioned) dim — deterministic and "
         "dtype-independent",
         encode=_sign_encode, decode=_sign_decode,
         bits_per_coordinate=1.0)

register("int8_stochastic",
         "8-bit stochastic quantization: per-(worker, leaf) amax/127 scale "
         "+ PRNG-keyed stochastic rounding — unbiased, worst-case "
         "per-coordinate error below one scale step; per-worker scales "
         "close the quantization-range attack",
         encode=_int8_encode, decode=_int8_decode, needs_key=True,
         bits_per_coordinate=8.0)
