"""The port's report wire (repro_torch.core.compression) against the JAX
package's, on the same numpy inputs.

Every codec output here is exact arithmetic, so it must be equal bit for
bit: the packed sign words (−0.0, subnormals, infs, d not a multiple of
8), the vote counts and ties, and the int8 payload's ``q`` and ``scale``
for the same key on a multi-leaf tree whose dict insertion order is not
sorted (leaf i draws from ``fold_in(key, i)`` in JAX's leaf order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro.core import compression as jc
from repro.core import robust_train as jrt
from repro.core import shard_aggregation as jsa
from repro_torch import tree as jtree
from repro_torch.core import compression as tc
from repro_torch.core import robust_train as trt
from repro_torch.core import shard_aggregation as tsa


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _tree(seed, m=6):
    """A multi-leaf stacked tree, dict keys inserted out of sorted order,
    with a (m,) leaf, an odd last dim and a 3-d leaf."""
    rng = np.random.default_rng(seed)
    return {"z": rng.normal(size=(m, 13)).astype(np.float32),
            "a": {"y": (rng.normal(size=(m, 2, 9)) * 3).astype(np.float32),
                  "b": rng.normal(size=(m,)).astype(np.float32)},
            "m": (rng.normal(size=(m, 8)) * 1e-3).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    """The port's tree, keeping the dicts' insertion order."""
    return tree_map(torch.as_tensor, tree)


def _pairs(got, want):
    """Leaf pairs in JAX's order (the port's tree walked the same way)."""
    return list(zip(jtree.leaves(got), jax.tree.leaves(want)))


def test_tree_order_is_jax_order():
    tree = _tree(0)
    assert list(tree) == ["z", "a", "m"]      # not sorted on insertion
    for got, want in _pairs(tree, tree):
        assert got is want
    rebuilt = jtree.unflatten(tree, list(range(4)))
    assert list(rebuilt) == ["z", "a", "m"]
    assert rebuilt == {"z": 3, "a": {"y": 1, "b": 0}, "m": 2}


def test_unflatten_holds_no_leaf_once_dropped():
    """The rebuilt tree's leaves are freed with it, by reference count:
    nothing of the walk keeps ``new_leaves`` in a reference cycle."""
    import gc
    import weakref
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        rebuilt = jtree.unflatten(_tree(0), [leaf] + [torch.ones(1)] * 3)
        del rebuilt, leaf
        freed = ref() is None
    finally:
        gc.enable()
    assert freed


EDGE = np.array([[0.0, -0.0, 1e-45, -1e-45, np.inf, -np.inf, 1e38,
                  -1e-38, 5e-324, -5e-324, 3.0]], np.float32)


@pytest.mark.parametrize("d", [1, 7, 8, 9, 13, 16, 64, 100])
def test_packed_words_equal(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(5, 3, d)).astype(np.float32)
    x[0, 0, : min(d, 4)] = [-0.0, 0.0, -1e-45, 1e-45][: min(d, 4)]
    want = np.asarray(jc.pack_signs(jnp.asarray(x)))
    got = tc.pack_signs(torch.as_tensor(x))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tc.unpack_signs(got, d).numpy(),
                                  np.asarray(jc.unpack_signs(want, d)))
    np.testing.assert_array_equal(tc.unpack_signs(got, d).numpy(),
                                  np.signbit(x).astype(np.uint8))


def test_edge_values_pack_and_decode_like_jax():
    """−0.0 and negative subnormals are negative, +0.0 positive (signbit);
    the CPU's flush of float32 subnormals must not change a sign."""
    jcodec, tcodec = jc.get_codec("sign"), tc.get_codec("sign")
    jp = jcodec.encode(jnp.asarray(EDGE))
    tp = tcodec.encode(torch.as_tensor(EDGE))
    np.testing.assert_array_equal(tp["packed"].numpy(),
                                  np.asarray(jp["packed"]))
    dec = tcodec.decode(tp, torch.as_tensor(EDGE)).numpy()
    np.testing.assert_array_equal(
        dec, np.asarray(jcodec.decode(jp, jnp.asarray(EDGE))))
    assert dec[0, 1] == -1.0 and dec[0, 0] == 1.0 and dec[0, 3] == -1.0


def test_unpack_exhaustive_word_patterns():
    words = np.arange(256, dtype=np.uint8).reshape(256, 1)
    got = tc.unpack_signs(torch.as_tensor(words), 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jc.unpack_signs(jnp.asarray(words), 8)))
    np.testing.assert_array_equal(
        tc.pack_signs(torch.as_tensor(1.0 - 2.0 * got)).numpy(), words)


def test_sign_codec_on_a_tree_with_bf16():
    tree = _tree(1)
    jcodec, tcodec = jc.get_codec("sign"), tc.get_codec("sign")
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        tt = tree_map(lambda x: torch.as_tensor(x).to(dtype), tree)
        jt = jax.tree.map(lambda x: jnp.asarray(x, jdt), tree)
        tp, jp = tcodec.encode(tt), jcodec.encode(jt)
        for got, want in _pairs(tp, jp):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in _pairs(tcodec.decode(tp, tt),
                                jcodec.decode(jp, jt)):
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("m", [2, 4, 5, 12])
@pytest.mark.parametrize("seed", range(3))
def test_vote_counts_and_ties_equal(m, seed):
    """Raw and packed votes equal JAX's, including exact ties (even m with
    half the rows negated) going to +1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, 3, 11)).astype(np.float32)
    if m % 2 == 0:
        x[m // 2:, 0] = -np.abs(x[: m // 2, 0])
        x[: m // 2, 0] = np.abs(x[: m // 2, 0])
    tree = {"x": x, "v": rng.normal(size=(m,)).astype(np.float32)}
    want = jc.majority_vote_signs(_j(tree))
    raw = tc.majority_vote_signs(_t(tree))
    packed = tc.majority_vote_packed(tc.get_codec("sign").encode(_t(tree)),
                                     _t(tree))
    for got in (raw, packed):
        for g, w in _pairs(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if m % 2 == 0:
        assert np.all(raw["x"][0].numpy() == 1.0)


@pytest.mark.parametrize("seed", range(5))
def test_int8_payload_bit_equal(seed):
    tree = _tree(seed + 10)
    jk, tk = _keys(seed)
    jp = jc.get_codec("int8_stochastic").encode(_j(tree), key=jk)
    tp = tc.get_codec("int8_stochastic").encode(_t(tree), key=tk)
    assert list(tp["q"]) == ["z", "a", "m"]
    for part in ("q", "scale"):
        for got, want in _pairs(tp[part], jp[part]):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in _pairs(
            tc.get_codec("int8_stochastic").decode(tp, _t(tree)),
            jc.get_codec("int8_stochastic").decode(jp, _j(tree))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_zero_rows_unit_scale_and_key_required():
    x = np.zeros((3, 4), np.float32)
    x[1] = [1.0, -2.0, 0.5, 127.0]
    jk, tk = _keys(3)
    tp = tc.get_codec("int8_stochastic").encode(torch.as_tensor(x), key=tk)
    jp = jc.get_codec("int8_stochastic").encode(jnp.asarray(x), key=jk)
    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"]))
    assert tp["scale"][0] == 1.0 and tp["scale"][2] == 1.0
    with pytest.raises(ValueError, match="PRNG key"):
        tc.get_codec("int8_stochastic").encode(torch.as_tensor(x))
    # shard-local encoding: a virtual spec's
    # payload is the reference's, bit for bit
    tp = tc.get_codec("int8_stochastic").encode(
        torch.as_tensor(x), key=tk,
        shard_spec=tsa.ShardSpec(num_shards=2, mode="virtual"))
    jp = jc.get_codec("int8_stochastic").encode(
        jnp.asarray(x), key=jk,
        shard_spec=jsa.ShardSpec(num_shards=2, mode="virtual"))
    for part in ("q", "scale"):
        np.testing.assert_array_equal(tp[part].numpy(), np.asarray(jp[part]))


def test_registry_carries_the_reference_codecs():
    assert tc.available() == jc.available()
    assert tc.describe() == jc.describe()
    for name in tc.available():
        j, t = jc.get_codec(name), tc.get_codec(name)
        assert (t.needs_key, t.bits_per_coordinate) == \
            (j.needs_key, j.bits_per_coordinate)
    with pytest.raises(KeyError, match="unknown codec"):
        tc.get_codec("fp4")


@pytest.mark.parametrize("rule,codec", [("sign_sgd_majority", "sign"),
                                        ("int8_gmom", "int8_stochastic"),
                                        ("gmom", "int8_stochastic"),
                                        ("mean", "sign")])
def test_aggregate_reported_wire_matches_jax(rule, codec):
    """Native (payload + like=) and decoded dispatch through
    aggregate_reported, keyed by fold_in(key, 29), on a stale-weighted
    tree as in a round of the stale campaign."""
    tree = _tree(4, m=12)
    age = np.array([0, 1, 0, 2, 0, 0, 3, 0, 1, 0, 0, 0], np.int32)
    kw = dict(num_workers=12, num_byzantine=2, num_batches=6,
              aggregator=rule, compression=codec)
    jk, tk = _keys(8)
    want = jrt.aggregate_reported(
        _j(tree), jrt.RobustConfig(**kw), key=jk,
        staleness=(jnp.asarray(age), jnp.int32(2), 0.7))
    got = trt.aggregate_reported(
        _t(tree), trt.RobustConfig(**kw), key=tk,
        staleness=(torch.as_tensor(age), torch.tensor(2, dtype=torch.int32),
                   0.7))
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    if rule == "sign_sgd_majority":
        raw = trt.aggregate_reported(
            _t(tree), dataclasses.replace(trt.RobustConfig(**kw),
                                          compression="none"), key=tk,
            staleness=(torch.as_tensor(age),
                       torch.tensor(2, dtype=torch.int32), 0.7))
        for g, r in zip(jtree.leaves(got), jtree.leaves(raw)):
            assert torch.equal(g, r)
