"""The port's GMoM round (repro_torch.kernels.geomed.round) against the
JAX package's.

The port's plain PyTorch version is held against JAX
``round_aggregate_ref`` on the tier-1 (m, k, d) matrix x grouping schemes x
trim settings (rtol 1e-4, atol 1e-5: the sums run in other orders).  The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py."""

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
