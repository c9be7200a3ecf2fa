"""The port's threefry PRNG (repro_torch.random) against jax.random.

Keys, folds, splits, raw bits and uniforms must equal JAX bit for bit
under the non-partitionable threefry scheme the goldens were recorded
with; normals go through erfinv, whose torch and XLA versions differ by a
few ulps (atol 1e-5)."""

import jax
import jax.numpy as jnp
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


# ---------------------------------------------------------------------------
# draws at given flat indices (``bits_at``, ``uniform_at``, ``normal_at``)

class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor an op returns inside the mode."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


AT_SIZES = [1, 2, 7, 8, 1001, 4096]


@pytest.mark.parametrize("n", AT_SIZES)
@pytest.mark.parametrize("seed", [0, 42])
def test_draws_at_indices_are_the_whole_draw(seed, n):
    """Odd and even n, every index and a random subset (repeats and any
    order): the words, uniforms and normals of the whole draw there, and
    ``jax.random.bits`` / ``uniform`` of the whole shape."""
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    rng = np.random.default_rng(n + seed)
    whole = tr.bits(tk, (n,))
    jbits = _np(jax.random.bits(jk, (n,)))
    juni = np.asarray(jax.random.uniform(jk, (n,))).view(np.int32)
    for idx in (np.arange(n), rng.integers(0, n, size=max(1, n // 3))):
        i = torch.as_tensor(idx)
        got = tr.bits_at(tk, (n,), i)
        assert torch.equal(got, whole[i])
        np.testing.assert_array_equal(got.numpy(), jbits[idx])
        np.testing.assert_array_equal(
            tr.uniform_at(tk, (n,), i).numpy().view(np.int32), juni[idx])
        assert torch.equal(tr.normal_at(tk, (n,), i), tr.normal(tk, (n,))[i])


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_draws_at_indices_across_chunk_edges(monkeypatch, chunk):
    """Indices that straddle the chunks' edges, of a multi-dim shape (the
    flat row-major index), and an index tensor of two dims."""
    monkeypatch.setattr(tr, "DRAW_CHUNK", chunk)
    shape = (7, 11, 13)
    n = 7 * 11 * 13
    tk = tr.PRNGKey(9)
    whole = tr.bits(tk, shape).reshape(-1)
    edges = sorted({min(max(e + d, 0), n - 1)
                    for e in range(0, n + chunk, chunk) for d in (-1, 0, 1)})
    i = torch.as_tensor(edges)
    assert torch.equal(tr.bits_at(tk, shape, i), whole[i])
    i2 = torch.arange(n - 40, n).reshape(4, 10)
    assert torch.equal(tr.uniform_at(tk, shape, i2),
                       tr.uniform(tk, shape).reshape(-1)[i2])
    np.testing.assert_array_equal(
        tr.bits_at(tk, shape, i2).numpy(),
        _np(jax.random.bits(jax.random.PRNGKey(9), shape)).reshape(-1)[
            i2.numpy()])


def test_draws_at_indices_never_allocate_the_whole_draw(monkeypatch):
    """A draw of 2**20 words at 1000 indices, 64 at a time: no tensor the
    draw makes holds more than the index's 1000 elements."""
    monkeypatch.setattr(tr, "DRAW_CHUNK", 64)
    tk = tr.PRNGKey(1)
    idx = torch.arange(0, 1 << 20, (1 << 20) // 1000)[:1000]
    with _Largest() as seen:
        got = tr.uniform_at(tk, (1 << 10, 1 << 10), idx)
    assert got.shape == (1000,)
    assert seen.numel <= 1000
    assert torch.equal(got, tr.uniform(tk, (1 << 20,))[idx])


@pytest.mark.parametrize("n", [7, 20, 21, 22])
def test_draws_at_indices_refuse_what_bits_refuses(monkeypatch, n):
    """``bits_at`` refuses what ``bits`` refuses, which past one counter
    run is nothing now: at a block of 7 words (JAX's is 2**32 - 1), both
    draw it, ``bits`` as the blocks of ``split(key, blocks + 1)``'s keys
    side by side, the remainder from the last, and ``bits_at`` as
    ``bits`` at every index (the real block size against JAX:
    ``test_draws_past_one_counter_run_are_jax_blocks``)."""
    monkeypatch.setattr(tr, "_BLOCK_WORDS", 7)
    tk = tr.PRNGKey(n)
    nblocks, rem = divmod(n, 7)
    keys = tr.split(tk, nblocks + 1)
    want = torch.cat([tr._draw_run(keys[j], 7, lambda w: w)
                      for j in range(nblocks)]
                     + [tr._draw_run(keys[nblocks], rem, lambda w: w)])
    whole = tr.bits(tk, (n,))
    assert torch.equal(whole, want)
    idx = torch.arange(n - 1, -1, -1)
    assert torch.equal(tr.bits_at(tk, (n,), idx), whole[idx])
    assert torch.equal(tr.uniform_at(tk, (n,), idx),
                       tr.uniform(tk, (n,))[idx])


def test_draws_past_one_counter_run_are_jax_blocks():
    """Words of a draw of 2**32 - 1 + 5 words at the real block size,
    against JAX's original scheme's pieces: the first block's words from
    ``threefry_2x32`` of split key 0 at their counter pairs, the
    remainder's from the last key's run of 5."""
    from jax._src import prng as jprng
    block = 2 ** 32 - 1
    n = block + 5
    jk, tk = jax.random.PRNGKey(3), tr.PRNGKey(3)
    jkeys = jprng.threefry_split(jk, (2,))
    half = (block + 1) // 2

    def pair(i):
        # word i's counter pair; the odd run's last partner is its zero pad
        return ([i, i + half if i + half < block else 0] if i < half
                else [i - half, i])

    first = [int(jprng.threefry_2x32(jkeys[0], jnp.asarray(
        pair(i), jnp.uint32))[0 if i < half else 1])
        for i in (0, 5, half - 1, half, block - 1)]
    last = _np(jprng.threefry_2x32(jkeys[1],
                                   jnp.arange(5, dtype=jnp.uint32)))
    idx = torch.tensor([0, 5, half - 1, half, block - 1]
                       + [block + i for i in range(5)])
    got = tr.bits_at(tk, (n,), idx).tolist()
    assert got == first + [int(x) for x in last]


@pytest.mark.parametrize("chunk", [1, 5, 64])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 1001])
def test_whole_draws_in_chunks_are_jax_bits(monkeypatch, chunk, n):
    """``bits``, ``uniform`` and ``normal`` draw ``DRAW_CHUNK`` pairs of
    counters at a time: the same bits as ``jax.random`` of the whole
    shape at any chunk (odd and even counts), and no temporary larger
    than a chunk beside the output."""
    monkeypatch.setattr(tr, "DRAW_CHUNK", chunk)
    jk, tk = jax.random.PRNGKey(n), tr.PRNGKey(n)
    np.testing.assert_array_equal(tr.bits(tk, (n,)).numpy(),
                                  _np(jax.random.bits(jk, (n,))))
    np.testing.assert_array_equal(
        tr.uniform(tk, (n,)).numpy().view(np.int32),
        np.asarray(jax.random.uniform(jk, (n,))).view(np.int32))
    monkeypatch.setattr(tr, "DRAW_CHUNK", 1 << 22)
    want = tr.normal(tk, (n,))
    monkeypatch.setattr(tr, "DRAW_CHUNK", chunk)
    with _Largest() as seen:
        got = tr.normal(tk, (n,))
    assert torch.equal(got, want)
    assert seen.numel <= max(n, chunk)
