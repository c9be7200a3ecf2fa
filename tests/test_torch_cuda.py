"""The port's CUDA kernels on the card (``cuda`` marker; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it runs on a
machine that has only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel sums in other orders than its plain PyTorch version
(rtol 1e-4, atol 1e-5 against max|y|); run to run it is bitwise equal."""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.grouping import make_grouping
from repro_torch.kernels import _build
from repro_torch.kernels.geomed import round as rk

RTOL, ATOL = 1e-4, 1e-5
SCHEMES = ("contiguous", "strided", "seeded")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _stacked(m, d, seed, device):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, d)).astype(np.float32) + 1.0
    return torch.as_tensor(g, device=device)


def _close(y, y_ref):
    return float((y - y_ref).abs().max()) <= \
        ATOL + RTOL * float(y_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mkd", [(20, 10, 20), (50, 11, 777), (8, 4, 2048),
                                 (64, 16, 4096), (40, 33, 300),
                                 (64, 64, 513)])
def test_kernel_matches_plain_and_is_deterministic(cuda, mkd, scheme, trim):
    m, k, d = mkd
    g = _stacked(m, d, m * d, cuda)
    if trim == 1.0:
        g[0] *= 100.0
    grouping = make_grouping(m, k, scheme=scheme)
    kw = dict(trim_multiplier=trim, tol=0.0, max_iters=3)
    before = rk.round_aggregate_kernel.launches
    y1, it1 = rk.round_aggregate_kernel(g, grouping, **kw)
    y2, it2 = rk.round_aggregate_kernel(g, grouping, **kw)
    yp, itp = rk.round_aggregate_ref(g, grouping, **kw)
    assert rk.round_aggregate_kernel.launches == before + 2
    # tol=0 still stops at an exact float32 fixed point (squared move 0),
    # which the two summation orders may reach at different iterations
    # (two kept batches: the weighted mean is one after a single step)
    assert int(it1) == int(it2) and 1 <= int(it1) <= 3 and 1 <= int(itp) <= 3
    assert torch.equal(y1, y2)
    assert _close(y1, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("mkd", [(20, 10, 20), (50, 11, 8192)])
def test_early_exit_agrees_with_plain(cuda, mkd):
    m, k, d = mkd
    g = _stacked(m, d, 1, cuda)
    grouping = make_grouping(m, k)
    y, it = rk.round_aggregate_kernel(g, grouping)
    yp, itp = rk.round_aggregate_ref(g, grouping)
    assert _close(y, yp)
    assert (int(it) < 64) == (int(itp) < 64)


@pytest.mark.cuda
def test_zero_iterations_is_the_weighted_mean(cuda):
    g = _stacked(12, 100, 2, cuda)
    grouping = make_grouping(12, 6)
    y, it = rk.round_aggregate_kernel(g, grouping, max_iters=0)
    yp, itp = rk.round_aggregate_ref(g, grouping, max_iters=0)
    assert int(it) == int(itp) == 0
    assert _close(y, yp)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = _stacked(20, 30, 3, cuda)
    grouping = make_grouping(20, 10)
    with pytest.raises(ValueError, match="contiguous float32"):
        rk.round_aggregate_kernel(g.t().contiguous().t(), grouping)
    with pytest.raises(ValueError, match="contiguous float32"):
        rk.round_aggregate_kernel(g.double(), grouping)
    with pytest.raises(ValueError, match="rows"):
        rk.round_aggregate_kernel(g[:10], grouping)
    with pytest.raises(ValueError, match="batches"):
        rk.round_aggregate_kernel(_stacked(80, 5, 0, cuda),
                                  make_grouping(80, 65))


@pytest.mark.cuda
def test_failed_launch_raises(cuda, monkeypatch):
    lib = rk._library()
    assert lib.gmom_round_aggregate(
        None, None, None, None, 0, 1, 0, 0.0, 1, 0.0, 1e-12, 0.0, None,
        None, None, None, None, None, 1, None) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def gmom_round_aggregate(*args):
            return 9                     # cudaErrorInvalidConfiguration

    monkeypatch.setattr(rk, "_library", lambda: Refusing())
    with pytest.raises(RuntimeError, match="launch failed"):
        rk.round_aggregate_kernel(_stacked(20, 30, 3, cuda),
                                  make_grouping(20, 10))


@pytest.mark.cuda
def test_failed_build_raises(cuda, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cu"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(bad)


@pytest.mark.cuda
def test_engine_goes_through_the_kernel_every_gmom_round(cuda):
    from repro_torch.sim import engine, goldens
    name = "linreg/gmom/sign_flip/rotating"
    rk.round_aggregate_kernel.launches = 0
    trace = engine.run_scenario(name, device=cuda)
    assert rk.round_aggregate_kernel.launches == trace["rounds"]
    assert goldens.compare_traces(trace, goldens.load_golden(name)) == []


@pytest.mark.cuda
def test_library_is_a_plain_c_interface(cuda):
    lib = rk._library()
    assert isinstance(lib, ctypes.CDLL)
    assert lib.gmom_round_max_batches() == rk.MAX_BATCHES
