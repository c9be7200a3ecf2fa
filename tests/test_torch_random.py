"""The port's threefry PRNG (repro_torch.random) against jax.random.

Keys, folds, splits, raw bits and uniforms must equal JAX bit for bit
under the non-partitionable threefry scheme the goldens were recorded
with; normals go through erfinv, whose torch and XLA versions differ by a
few ulps (atol 1e-5)."""

import jax
import numpy as np
import pytest
import torch

from repro_torch import random as tr

SEEDS = [0, 1, 42, 123456, -5, 2**31 - 1]
SHAPES = [(1,), (2,), (7,), (20,), (3, 5), (4, 6, 3)]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for data in (0, 7, 13, 999, 2**31 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(jk, data)),
                                      tr.fold_in(tk, data).numpy())
    np.testing.assert_array_equal(
        _np(jax.random.fold_in(jk, 5)),
        tr.fold_in(tk, torch.tensor(5, dtype=torch.int32)).numpy())
    for n in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(_np(jax.random.split(jk, n)),
                                      tr.split(tk, n).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniform_bit_exact(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(_np(jax.random.bits(jk, shape)),
                                  tr.bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = tr.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    ju = np.asarray(jax.random.uniform(jk, shape, minval=-1.0, maxval=1.0))
    tu = tr.uniform(tk, shape, -1.0, 1.0).numpy()
    np.testing.assert_array_equal(ju, tu)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_within_ulps(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_allclose(tr.normal(tk, shape).numpy(),
                               np.asarray(jax.random.normal(jk, shape)),
                               rtol=0, atol=1e-5)


def test_draws_follow_the_key_device_and_chain():
    """A derived key chain (the engine's split -> fold_in -> uniform) stays
    bit-exact end to end."""
    jk, tk = jax.random.PRNGKey(3), tr.PRNGKey(3)
    jks, tks = jax.random.split(jk, 4), tr.split(tk, 4)
    for i in range(4):
        jf = jax.random.fold_in(jks[i], 17)
        tf = tr.fold_in(tks[i], 17)
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jf, (9,))).view(np.int32),
            tr.uniform(tf, (9,)).numpy().view(np.int32))
    assert tr.uniform(tk, (3,)).device == tk.device


def test_seed_outside_int32_rejected():
    with pytest.raises(OverflowError):
        tr.PRNGKey(2**31)
