"""The port's Weiszfeld kernels (repro_torch.kernels.geomed.geomed, ref
and ops) against the JAX package's.

On the CPU the wrappers run their plain versions; these, and the twins of
the CUDA kernels' summation orders (``ref.weiszfeld_distances_blocked``
for sqdist, ``ops.geometric_median_blocked`` for the loop kernel) on
several launch plans, are held against the JAX Pallas kernels in
interpret mode and against the JAX oracle ``ref.py`` on the non-slow grid
of tests/test_kernels.py.  Inputs come from numpy seeds.  Tolerances:
``sqdist`` rtol 1e-5 (a sum of k-row squares, summed in other orders), the
step and ``reweight`` rtol 1e-4 / atol 1e-5, the full Weiszfeld loop rtol
1e-4 / atol 1e-5 (it may stop an iteration apart; exact counts where
neither can stop early).  The CUDA kernels run only on a card:
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.geomed import geomed as jgeomed
from repro.kernels.geomed import ops as jops
from repro.kernels.geomed import ref as jref
from repro_torch.core.geometric_median import geometric_median
from repro_torch.kernels import _build
from repro_torch.kernels.geomed import geomed, ops, ref

RTOL, ATOL = 1e-4, 1e-5
SQDIST_RTOL = 1e-5
GRID = [(2, 64), (8, 1000), (5, 777)]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _inputs(k, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(k, d)).astype(np.float32)
    y = rng.normal(size=(d,)).astype(np.float32)
    w = (rng.uniform(size=(k,)) + 0.1).astype(np.float32)
    return z, y, w


def _both(x, dtype):
    """The same values in both frameworks (bf16 rounds identically)."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,d", GRID)
def test_sqdist_matches_jax(k, d, dtype):
    z, y, _ = _inputs(k, d, k * d)
    jz, tz = _both(z, dtype)
    jy, ty = _both(y, dtype)
    got = geomed.sqdist(tz, ty)
    assert got.dtype == torch.float32 and got.shape == (k,)
    want_kernel = np.asarray(jgeomed.sqdist(jz, jy, interpret=True))
    want_ref = np.asarray(jref.weiszfeld_distances_ref(jz, jy))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=SQDIST_RTOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=SQDIST_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,d", GRID)
def test_reweight_matches_jax(k, d, dtype):
    z, _, w = _inputs(k, d, k + d)
    jz, tz = _both(z, dtype)
    got = geomed.reweight(tz, torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == (d,)
    want_kernel = np.asarray(jgeomed.reweight(jz, jnp.asarray(w),
                                              interpret=True))
    want_ref = np.asarray(jref.weiszfeld_reweight_ref(jz, jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,d", [(4, 512), (8, 1000), (32, 2048)])
def test_weiszfeld_step_matches_jax(k, d):
    z, y, w = _inputs(k, d, d)
    args = [jnp.asarray(a) for a in (z, y, w)]
    targs = [torch.as_tensor(a) for a in (z, y, w)]
    got = geomed.weiszfeld_step(*targs)
    plain = ref.weiszfeld_step_ref(*targs)
    want_kernel = np.asarray(jgeomed.weiszfeld_step(*args, interpret=True))
    want_ref = np.asarray(jref.weiszfeld_step_ref(*args))
    for a in (got, plain):
        np.testing.assert_allclose(a.numpy(), want_kernel, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(a.numpy(), want_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("k,d,seed", [(2, 1, 0), (3, 17, 1), (8, 64, 2),
                                      (12, 200, 3), (5, 100, 4)])
def test_geometric_median_kernel_matches_jax(k, d, seed, plain):
    z = np.random.default_rng(seed).normal(size=(k, d)).astype(np.float32)
    want = np.asarray(jops.geometric_median_kernel(
        jnp.asarray(z), interpret=True, max_iters=64))
    got = ops.geometric_median_kernel(torch.as_tensor(z), max_iters=64,
                                      plain=plain)
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    core = geometric_median(torch.as_tensor(z), max_iters=64)
    np.testing.assert_allclose(got.numpy(), core.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_geometric_median_kernel_weights_and_stopping():
    """Weighted init, and the stopping rule on the NORM of the move: with
    max_iters=1 exactly one step is taken."""
    z, _, w = _inputs(6, 50, 9)
    want = np.asarray(jops.geometric_median_kernel(
        jnp.asarray(z), jnp.asarray(w), interpret=True, max_iters=1))
    got = ops.geometric_median_kernel(torch.as_tensor(z), torch.as_tensor(w),
                                      max_iters=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    zero = ops.geometric_median_kernel(torch.as_tensor(z),
                                       torch.as_tensor(w), max_iters=0)
    mean = (w @ z) / w.sum()
    np.testing.assert_allclose(zero.numpy(), mean, rtol=1e-6, atol=1e-7)


def test_wrappers_on_cpu_run_the_plain_versions():
    z, y, w = (torch.as_tensor(a) for a in _inputs(7, 300, 4))
    before = (geomed.sqdist.launches, geomed.reweight.launches)
    assert torch.equal(geomed.sqdist(z, y),
                       ref.weiszfeld_distances_ref(z, y))
    assert torch.equal(geomed.reweight(z, w),
                       ref.weiszfeld_reweight_ref(z, w))
    assert torch.equal(geomed.weiszfeld_step(z, y, w),
                       ref.weiszfeld_step_ref(z, y, w))
    ops.geometric_median_kernel(z, max_iters=4)
    assert (geomed.sqdist.launches, geomed.reweight.launches) == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither a CPU fallback nor a silent plain path off the CPU."""
    z = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        geomed.sqdist(z, torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        geomed.reweight(z, torch.empty((3,), device="meta"))


def test_library_hash_covers_the_headers(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    first = _build.library_path(src)
    header.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.library_path(src).name.startswith("k-")


# ---------------------------------------------------------------------------
# the twins of the CUDA kernels' orders, and the loop's routes

@pytest.mark.parametrize("n_blocks,vec", [(1, 1), (2, 4), (3, 1), (7, 4)])
@pytest.mark.parametrize("k,d", [(2, 64), (8, 1000), (5, 777), (17, 300),
                                 (70, 1001)])
def test_sqdist_twin_matches_jax(k, d, n_blocks, vec):
    """The sqdist kernel's order (units of 4 columns where d % 4 == 0, or
    single columns; k > 16 in row chunks) against JAX ``sqdist``."""
    vec = vec if d % 4 == 0 else 1
    z, y, _ = _inputs(k, d, k * d + n_blocks)
    got = ref.weiszfeld_distances_blocked(torch.as_tensor(z),
                                          torch.as_tensor(y),
                                          n_blocks=n_blocks, vec=vec)
    assert got.dtype == torch.float32 and got.shape == (k,)
    want = np.asarray(jgeomed.sqdist(jnp.asarray(z), jnp.asarray(y),
                                     interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=SQDIST_RTOL)
    np.testing.assert_allclose(
        got.numpy(), ref.weiszfeld_distances_ref(torch.as_tensor(z),
                                                 torch.as_tensor(y)).numpy(),
        rtol=SQDIST_RTOL)


@pytest.mark.parametrize("layout", ["one", "many"])
@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 11, 16, 17, 64])
def test_geometric_median_blocked_matches_jax(k, n_blocks, layout):
    """The loop kernels' orders, with a zero weight, against JAX
    ``geometric_median_kernel`` (interpret) and the plain loop: for k <= 16
    the register-streamed kernel's (units of 4 columns; a thread owns one
    unit or several), above it the tile kernel's (a block owns one tile of
    Z, resident, or several, streamed); the iteration counts equal the
    plain loop's at max_iters 0, 1 and 3."""
    regs = geomed.loop_kernel(k) == "regs"
    vec = 4 if regs else 1
    span = 256 * n_blocks * vec
    d = span - 20 if layout == "one" else 2 * span + 76
    z, _, w = _inputs(k, d, 100 * k + d)
    if k > 1:
        w[0] = 0.0
    tz, tw = torch.as_tensor(z), torch.as_tensor(w)
    for max_iters in (0, 1, 3, 64):
        got, it = ops.geometric_median_blocked(tz, tw, n_blocks=n_blocks,
                                               vec=vec, max_iters=max_iters)
        plain, itp = ref.geometric_median_ref(tz, tw, max_iters=max_iters)
        want = np.asarray(jops.geometric_median_kernel(
            jnp.asarray(z), jnp.asarray(w), interpret=True,
            max_iters=max_iters))
        assert got.shape == (d,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                                   atol=ATOL)
        if max_iters <= 3:
            assert int(it) == int(itp)
            assert k == 1 or int(it) == max_iters


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_register_loop_twin_in_single_columns(n_blocks):
    """The register-streamed kernel's order in units of one column (d % 4
    != 0, or a view off 16 bytes) against JAX and the plain loop."""
    z, _, w = _inputs(11, 1001, 7)
    tz, tw = torch.as_tensor(z), torch.as_tensor(w)
    got, _ = ops.geometric_median_blocked(tz, tw, n_blocks=n_blocks, vec=1)
    want = np.asarray(jops.geometric_median_kernel(
        jnp.asarray(z), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain, _ = ref.geometric_median_ref(tz, tw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k,d,vec,want", [
    (11, 25_557_032, 4, 132),      # regs: one block an SM, one wave
    (11, 8192, 4, 8), (11, 8193, 1, 33), (16, 100, 1, 1),
    (17, 25_557_032, 1, 396),      # tiles: three blocks an SM
    (64, 1000, 1, 4)])             # tiles: no more blocks than tiles
def test_loop_grid(k, d, vec, want):
    bps = 1 if geomed.loop_kernel(k) == "regs" else 3
    assert geomed.loop_grid(k, d, vec, bps, 132) == want


@pytest.mark.parametrize("d,vec,want", [
    (25_557_032, 4, 792),          # one wave: 6 blocks an SM x 132
    (25_557_032, 1, 792), (8192, 4, 8), (8192, 1, 32), (1, 1, 1),
    (100_003, 1, 391)])
def test_sqdist_grid_is_one_wave_at_most(d, vec, want):
    assert geomed.sqdist_blocks(d, vec, 6, 132) == want


@pytest.mark.parametrize("k,want,kernel", [
    (1, "device_loop", "regs"), (16, "device_loop", "regs"),
    (17, "device_loop", "tiles"), (64, "device_loop", "tiles"),
    (65, "step_kernels", None), (100, "step_kernels", None)])
def test_loop_route_by_k(k, want, kernel):
    assert geomed.MAX_BATCHES == 64 and geomed.REGS_MAX_K == 16
    assert ops.loop_route(k) == want
    if kernel is not None:
        assert geomed.loop_kernel(k) == kernel


def test_loop_on_cpu_runs_the_plain_loop_and_counts_nothing():
    z, _, w = (torch.as_tensor(a) for a in _inputs(7, 300, 5))
    before = (geomed.weiszfeld_loop.launches, geomed.sqdist.launches,
              dict(ops.geometric_median_kernel.route_launches),
              dict(geomed.weiszfeld_loop.kernel_launches))
    y, it = geomed.weiszfeld_loop(z, w, max_iters=5)
    y_ref, it_ref = ref.geometric_median_ref(z, w, max_iters=5)
    assert torch.equal(y, y_ref) and int(it) == int(it_ref)
    y1, it1 = geomed.weiszfeld_loop(z)
    y2, it2 = ops._geometric_median(z)
    assert torch.equal(y1, y2) and int(it1) == int(it2)
    assert torch.equal(ops.geometric_median_kernel(z), y2)
    assert (geomed.weiszfeld_loop.launches, geomed.sqdist.launches,
            ops.geometric_median_kernel.route_launches,
            geomed.weiszfeld_loop.kernel_launches) == before


def test_loop_refuses_devices_without_a_kernel():
    z = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        geomed.weiszfeld_loop(z)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.geometric_median_kernel(z)
