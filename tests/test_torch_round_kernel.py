"""The port's GMoM round (repro_torch.kernels.geomed.round) against the
JAX package's.

The port's plain PyTorch version, and the twin of the CUDA kernel's
summation order (``round_aggregate_blocked``), are held against JAX
``round_aggregate_ref`` on the tier-1 (m, k, d) matrix x grouping schemes x
trim settings (rtol 1e-4, atol 1e-5: the sums run in other orders); the
kernel's launch plan is checked here too.  The CUDA kernel itself runs
only on a card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grouping import make_grouping as jax_make_grouping
from repro.kernels.geomed import round as jround
from repro_torch.core import aggregators as tagg
from repro_torch.core.grouping import batch_members_csr, make_grouping
from repro_torch.kernels.geomed import round as tround
from repro_torch.kernels.geomed import twin
from test_round_kernel import MKD_MATRIX, SCHEMES

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _stacked(m, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, d)).astype(np.float32) + 1.0


@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mkd", MKD_MATRIX)
def test_round_ref_matches_jax(mkd, scheme, trim):
    m, k, d = mkd
    g = _stacked(m, d, seed=m * d)
    if trim == 1.0:
        g[0] *= 100.0            # an outlier row so the trim zeroes a batch
    want = jround.round_aggregate_ref(
        jnp.asarray(g), jax_make_grouping(m, k, scheme=scheme),
        trim_multiplier=trim, max_iters=16)
    got, iters = tround.round_aggregate_ref(
        torch.as_tensor(g), make_grouping(m, k, scheme=scheme),
        trim_multiplier=trim, max_iters=16)
    assert 1 <= int(iters) <= 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [4, 5, 10, 11])
def test_median_small_ties_and_even_k(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 3, size=k).astype(np.float32)      # many ties
    got = tround._median_small(torch.as_tensor(x))
    assert float(got) == float(jround._median_small(jnp.asarray(x)))
    assert float(got) == float(np.median(x))


def test_median_small_even_averages_middle_pair():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tround._median_small(x)) == 2.5
    assert float(torch.median(x)) == 2.0      # torch's lower median differs


def test_trim_weights_resident_matches_jax():
    z = _stacked(10, 33, seed=5)
    z[3] *= 50.0
    for trim in (None, 1.0, 3.0):
        want = jround._trim_weights_resident(jnp.asarray(z),
                                              trim_multiplier=trim, k=10)
        got = tround._trim_weights_resident(torch.as_tensor(z),
                                            trim_multiplier=trim, k=10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_on_cpu_runs_the_plain_version():
    g = torch.as_tensor(_stacked(12, 64, seed=1))
    grouping = make_grouping(12, 6, scheme="strided")
    before = tround.round_aggregate_kernel.launches
    y, it = tround.round_aggregate_kernel(g, grouping, max_iters=8)
    y_ref, it_ref = tround.round_aggregate_ref(g, grouping, max_iters=8)
    assert torch.equal(y, y_ref) and int(it) == int(it_ref)
    assert tround.round_aggregate_kernel.launches == before


def test_round_aggregate_pytree_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(20, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(20, 7)).astype(np.float32)}
    want = jround.round_aggregate_pytree(
        {k: jnp.asarray(v) for k, v in tree.items()},
        jax_make_grouping(20, 10), max_iters=16, use_pallas=False)
    got = tround.round_aggregate_pytree(
        {k: torch.as_tensor(v) for k, v in tree.items()},
        make_grouping(20, 10), max_iters=16)
    for name in tree:
        assert got[name].shape == tuple(want[name].shape)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=RTOL, atol=ATOL)


def test_batch_members_csr_is_the_assignment_matrix():
    from repro_torch.core.grouping import assignment_matrix
    for scheme in SCHEMES:
        grouping = make_grouping(50, 11, scheme=scheme)
        offsets, members = batch_members_csr(grouping)
        s = assignment_matrix(grouping)
        for l in range(11):
            batch = members[offsets[l]:offsets[l + 1]]
            assert list(batch) == sorted(batch)
            assert list(batch) == list(np.flatnonzero(s[l]))


def test_resolve_round_backend_on_cpu():
    cpu = torch.device("cpu")
    assert tagg.resolve_round_backend("auto", num_batches=10,
                                      device=cpu) == "reference"
    assert tagg.resolve_round_backend(None, num_batches=10,
                                      device=cpu) == "reference"
    assert tagg.resolve_round_backend("fused_interpret", num_batches=10,
                                      device=cpu) == "fused_interpret"
    assert tagg.resolve_round_backend("reference", num_batches=10,
                                      device=cpu) == "reference"
    with pytest.raises(ValueError, match="fused"):
        tagg.resolve_round_backend("fused", num_batches=10, device=cpu)
    with pytest.raises(ValueError, match="unknown"):
        tagg.resolve_round_backend("pallas", num_batches=10, device=cpu)


def test_resolve_round_backend_cuda_branch():
    """The CUDA branch is decided from the tensors' device alone."""
    cuda = torch.device("cuda")
    assert tagg.resolve_round_backend("auto", num_batches=11,
                                      device=cuda) == "fused"
    assert tagg.resolve_round_backend("auto", num_batches=65,
                                      device=cuda) == "reference"
    with pytest.raises(ValueError, match="at most"):
        tagg.resolve_round_backend("fused", num_batches=65, device=cuda)


def test_gmom_fused_on_cpu_tensors_raises():
    g = torch.as_tensor(_stacked(20, 8))
    with pytest.raises(ValueError, match="fused"):
        tagg.gmom_aggregator(g, num_batches=10, round_backend="fused")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# ---------------------------------------------------------------------------
# the persistent kernel's launch plan and its plain twin

@pytest.mark.parametrize("d,per_sm,sms,want", [
    (100, 2, 132, 1),              # the paper's d: one tile, one block
    (256, 2, 132, 1), (257, 2, 132, 2),
    (8192, 2, 132, 32),            # 32 tiles of 256 columns
    (25_557_032, 2, 132, 264),     # every SM, as many as fit at once
    (25_557_032, 1, 132, 132), (1, 1, 1, 1), (10 ** 6, 0, 132, 1)])
def test_persistent_blocks_fill_the_card_up_to_the_tiles(d, per_sm, sms,
                                                         want):
    assert tround.persistent_blocks(d, per_sm, sms) == want


@pytest.mark.parametrize("d", [1, 100, 255, 256, 257, 8192, 10_000])
@pytest.mark.parametrize("n_blocks", [1, 2, 3, 32, 132])
def test_block_tiles_cover_every_column_once(d, n_blocks):
    tiles = tround.block_tiles(d, n_blocks)
    assert len(tiles) == n_blocks
    cols = sorted(c for block in tiles for c0, c1 in block
                  for c in range(c0, c1))
    assert cols == list(range(d))
    for b, block in enumerate(tiles):
        for i, (c0, c1) in enumerate(block):
            assert c0 == (b + i * n_blocks) * tround.TILE    # tile t -> t % nb
            assert 0 < c1 - c0 <= tround.TILE
    # the kernel keeps a block's tile resident exactly when it owns one
    counts = [len(block) for block in tiles]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mkd", MKD_MATRIX)
def test_round_blocked_matches_jax(mkd, scheme, trim, n_blocks):
    """The twin of the persistent kernel's summation order (per-block
    partials, reduced by every block in one fixed order) against JAX
    ``round_aggregate_ref`` (rtol 1e-4, atol 1e-5: other orders)."""
    m, k, d = mkd
    g = _stacked(m, d, seed=m * d)
    if trim == 1.0:
        g[0] *= 100.0
    want = jround.round_aggregate_ref(
        jnp.asarray(g), jax_make_grouping(m, k, scheme=scheme),
        trim_multiplier=trim, max_iters=16)
    got, iters = tround.round_aggregate_blocked(
        torch.as_tensor(g), make_grouping(m, k, scheme=scheme),
        n_blocks=n_blocks, trim_multiplier=trim, max_iters=16)
    assert 1 <= int(iters) <= 16
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_round_blocked_zero_and_three_iterations():
    g = torch.as_tensor(_stacked(20, 1000, seed=3))
    grouping = make_grouping(20, 10, scheme="strided")
    y0, it0 = tround.round_aggregate_blocked(g, grouping, n_blocks=2,
                                             max_iters=0)
    want0, _ = tround.round_aggregate_ref(g, grouping, max_iters=0)
    assert int(it0) == 0
    np.testing.assert_allclose(y0.numpy(), want0.numpy(), rtol=RTOL,
                               atol=ATOL)
    y3, it3 = tround.round_aggregate_blocked(g, grouping, n_blocks=4,
                                             max_iters=3, tol=0.0)
    want3, itp = tround.round_aggregate_ref(g, grouping, max_iters=3, tol=0.0)
    assert int(it3) == int(itp) == 3
    np.testing.assert_allclose(y3.numpy(), want3.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_reduce_partials_twin_is_the_fixed_lane_order():
    """Lane i sums rows i, i + 32, ... in order, then the butterfly: on
    values whose float sums depend on the order, the twin follows it."""
    rng = np.random.default_rng(0)
    part = (rng.normal(size=(70, 3)) * 10.0 ** rng.integers(
        -6, 6, size=(70, 3))).astype(np.float32)
    lanes = np.zeros((32, 3), np.float32)
    for b in range(70):
        lanes[b % 32] += part[b]
    for o in (16, 8, 4, 2, 1):
        lanes[:o] = lanes[:o] + lanes[o:2 * o]
    got = twin.reduce_partials(torch.as_tensor(part))
    np.testing.assert_array_equal(got.numpy(), lanes[0])


def _exact_f32(value):
    """The float32 nearest to a Fraction, ties to even."""
    from fractions import Fraction
    x = np.float32(float(value))
    cands = [x, np.nextafter(x, np.float32(np.inf)),
             np.nextafter(x, np.float32(-np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - value),
                                     int(c.view(np.uint32)) & 1))


def test_fma_twin_rounds_once():
    """``twin.fma`` is fmaf: a * b + c rounded once to float32, also where a
    float64 sum would land on a float32 tie (double rounding)."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    n = 2000
    a = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n))
    b = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n))
    c = (rng.normal(size=n) * 10.0 ** rng.integers(-9, 3, n))
    # (1 + 2^-12)^2 is a float32 tie; 2^-70 moves the exact value off it
    a = np.append(a, [1 + 2 ** -12, 1 + 2 ** -12, -(1 + 2 ** -12)])
    b = np.append(b, [1 + 2 ** -12, 1 + 2 ** -12, 1 + 2 ** -12])
    c = np.append(c, [2.0 ** -70, -2.0 ** -70, -2.0 ** -70])
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    got = twin.fma(*map(torch.as_tensor, (a, b, c))).numpy()
    want = np.array([_exact_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[-3] == np.float32(1 + 2 ** -11 + 2 ** -23)     # not the tie
    assert got[-2] == np.float32(1 + 2 ** -11)


def test_sqrt_twin_rounds_once():
    """``twin.sqrt_rn`` is ``__fsqrt_rn``: the float32 nearest to the root (held
    against exact rational arithmetic)."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    x = (rng.random(3000) * 10.0 ** rng.integers(-6, 6, 3000)).astype(
        np.float32)
    got = twin.sqrt_rn(torch.as_tensor(x)).numpy()
    for xi, r in zip(x, got):
        lo, hi = (np.nextafter(r, np.float32(-np.inf)),
                  np.nextafter(r, np.float32(np.inf)))
        # r is nearest iff the midpoints to its neighbours bracket sqrt(x)
        fx = Fraction(float(xi))
        assert (Fraction(float(lo)) + Fraction(float(r))) ** 2 / 4 <= fx
        assert fx <= (Fraction(float(r)) + Fraction(float(hi))) ** 2 / 4


def test_block_partials_twin_orders():
    """Per-block partials on a grid of two blocks over three tiles: block
    0 streams tiles 0 and 2 (lane i fma-accumulates columns i, i + 32, ...
    of each tile, then the butterfly), block 1 keeps tile 1 (each column
    squared, each warp's 32 columns by the butterfly, then the warps in
    order).  Written out element by element here."""
    rng = np.random.default_rng(2)
    k, d, tile = 2, 600, tround.TILE
    e = (rng.normal(size=(k, d)) * 10.0 ** rng.integers(-4, 4, (k, d))
         ).astype(np.float32)
    t = torch.as_tensor(e)

    def butterfly(v):
        v = list(v)
        for o in (16, 8, 4, 2, 1):
            v = [np.float32(v[i] + v[i + o]) for i in range(o)]
        return v[0]

    want = np.zeros((2, k), np.float32)
    for l in range(k):
        lanes = [np.float32(0)] * 32
        for t0 in (0, 2 * tile):
            for q in range(tile // 32):
                for i in range(32):
                    c = t0 + 32 * q + i
                    v = e[l, c] if c < d else np.float32(0)
                    lanes[i] = twin.fma(*(torch.tensor([x]) for x in
                                          (v, v, lanes[i]))).numpy()[0]
        want[0, l] = butterfly(lanes)
        s = np.float32(0)
        for w in range(tile // 32):
            cols = e[l, tile + 32 * w:tile + 32 * (w + 1)]
            s = np.float32(s + butterfly(cols * cols))
        want[1, l] = s
    np.testing.assert_array_equal(twin.block_partials(t, 2).numpy(), want)
