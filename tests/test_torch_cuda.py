"""The port's CUDA kernels on the card (``cuda`` marker; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel sums in other orders than its plain PyTorch version
(rtol 1e-4, atol 1e-5 against max|y|); run to run it is bitwise equal."""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core.geometric_median import geometric_median
from repro_torch.core.grouping import make_grouping
from repro_torch.kernels import _build
from repro_torch.kernels.geomed import geomed, ops, ref
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


# ---------------------------------------------------------------------------
# the full linreg round

def _linreg_data(m, n, d, seed, device, outlier=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n, d)).astype(np.float32)
    t = rng.normal(size=(m, n)).astype(np.float32)
    theta = rng.normal(size=(d,)).astype(np.float32)
    if outlier:
        t[0] *= 100.0
    return tuple(torch.as_tensor(a, device=device) for a in (x, t, theta))


@pytest.mark.cuda
@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mndk", [(12, 16, 300, 6), (20, 16, 400, 10),
                                  (50, 8, 100, 11), (50, 1000, 100, 10),
                                  (40, 3, 777, 33)])
def test_linreg_kernel_matches_plain_and_is_deterministic(cuda, mndk, scheme,
                                                          trim):
    m, n, d, k = mndk
    x, t, theta = _linreg_data(m, n, d, m * d, cuda, trim == 1.0)
    grouping = make_grouping(m, k, scheme=scheme)
    kw = dict(trim_multiplier=trim, tol=0.0, max_iters=3)
    before = rk.linreg_round_kernel.launches
    y1, it1 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    y2, it2 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    yp, itp = rk.linreg_round_fused(x, t, theta, grouping, **kw)
    yr, _ = rk.linreg_round_ref(x, t, theta, grouping, **kw)
    assert rk.linreg_round_kernel.launches == before + 2
    assert int(it1) == int(it2) and 1 <= int(it1) <= 3 and 1 <= int(itp) <= 3
    assert torch.equal(y1, y2)
    assert _close(y1, yp) and _close(y1, yr)


@pytest.mark.cuda
@pytest.mark.parametrize("mndk", [(50, 1000, 100, 11), (50, 1000, 8192, 11)])
def test_linreg_default_stopping_agrees_with_plain(cuda, mndk):
    """With the default tol each version stops on its own test: one order
    may run to the cap in a 1-ulp limit cycle where the other reaches an
    exact fixed point, so only the aggregates are compared."""
    m, n, d, k = mndk
    x, t, theta = _linreg_data(m, n, d, 1, cuda)
    grouping = make_grouping(m, k)
    y, it = rk.linreg_round_kernel(x, t, theta, grouping)
    yp, itp = rk.linreg_round_fused(x, t, theta, grouping)
    assert _close(y, yp)
    assert 1 <= int(it) <= 64 and 1 <= int(itp) <= 64


@pytest.mark.cuda
def test_failure_free_path_goes_through_the_linreg_kernel_every_round(cuda):
    from repro_torch.sim import engine, goldens
    from repro_torch.sim.scenarios import Scenario
    sc = Scenario(name="linreg/gmom/none/static", attack="none",
                  schedule="static")
    rk.linreg_round_kernel.launches = 0
    got = engine.run_failure_free(sc, device=cuda)
    assert rk.linreg_round_kernel.launches == sc.rounds
    want = engine.run_scenario(sc, device=cuda)
    assert goldens.compare_traces(got, {k: want[k] for k in got}) == []
    assert got["final_est_error"] < sc.paper_floor


@pytest.mark.cuda
def test_linreg_zero_iterations_is_the_weighted_mean_of_the_means(cuda):
    x, t, theta = _linreg_data(12, 16, 300, 2, cuda, outlier=True)
    grouping = make_grouping(12, 6)
    y, it = rk.linreg_round_kernel(x, t, theta, grouping, max_iters=0,
                                   trim_multiplier=1.0)
    g = torch.bmm((x @ theta - t)[:, None, :], x)[:, 0, :] / 16
    z = rk._means(g, grouping)
    w = rk._trim_weights_resident(z, trim_multiplier=1.0, k=6)
    assert float(w.sum()) < 6          # the outlier's batch is trimmed
    assert int(it) == 0
    assert _close(y, (w @ z) / w.sum())


@pytest.mark.cuda
def test_linreg_goes_through_the_round_tail_of_the_gradients(cuda):
    """The in-round gradients fed to the round kernel give the same
    aggregate as the linreg kernel."""
    x, t, theta = _linreg_data(50, 1000, 8192, 3, cuda)
    grouping = make_grouping(50, 11, scheme="seeded")
    g = torch.bmm((x @ theta - t)[:, None, :], x)[:, 0, :] / 1000
    y, _ = rk.linreg_round_kernel(x, t, theta, grouping, max_iters=3,
                                  tol=0.0)
    want, _ = rk.round_aggregate_kernel(g.contiguous(), grouping,
                                        max_iters=3, tol=0.0)
    assert _close(y, want)


@pytest.mark.cuda
def test_linreg_failed_launch_raises(cuda, monkeypatch):
    lib = rk._linreg_library()
    assert lib.gmom_linreg_round(
        None, None, None, None, None, None, 1, 1, 0, 1, 0, 0.0, 1, 0.0,
        1e-12, 0.0, 1.0, 1, None, None, None, None, None, None, None, None,
        1, None) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def gmom_linreg_round(*args):
            return 9                     # cudaErrorInvalidConfiguration

    monkeypatch.setattr(rk, "_linreg_library", lambda: Refusing())
    with pytest.raises(RuntimeError, match="launch failed"):
        rk.linreg_round_kernel(*_linreg_data(12, 16, 30, 3, cuda),
                               make_grouping(12, 6))


def _broken_source(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cu"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return bad


@pytest.mark.cuda
def test_linreg_failed_build_raises(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(rk, "LINREG_SOURCE",
                        _broken_source(tmp_path, monkeypatch))
    rk._linreg_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            rk.linreg_round_kernel(*_linreg_data(12, 16, 30, 3, cuda),
                                   make_grouping(12, 6))
    finally:
        rk._linreg_library.cache_clear()


# ---------------------------------------------------------------------------
# the Weiszfeld-step kernels

def _points(k, d, seed, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(k, d)).astype(np.float32) + 1.0
    y = rng.normal(size=(d,)).astype(np.float32)
    w = (rng.uniform(size=(k,)) + 0.1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (z, y, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kd", [(2, 64), (8, 1000), (16, 4096), (64, 512),
                                (5, 777), (32, 2048), (11, 8192), (70, 300),
                                (1, 1)])
def test_geomed_kernels_match_plain_and_are_deterministic(cuda, kd):
    k, d = kd
    z, y, w = _points(k, d, k * d, cuda)
    before = (geomed.sqdist.launches, geomed.reweight.launches)
    s1, s2 = geomed.sqdist(z, y), geomed.sqdist(z, y)
    r1, r2 = geomed.reweight(z, w), geomed.reweight(z, w)
    st1, st2 = (geomed.weiszfeld_step(z, y, w),
                geomed.weiszfeld_step(z, y, w))
    assert (geomed.sqdist.launches, geomed.reweight.launches) == \
        (before[0] + 4, before[1] + 4)
    for a, b in ((s1, s2), (r1, r2), (st1, st2)):
        assert torch.equal(a, b)
    assert _close(s1, ref.weiszfeld_distances_ref(z, y))
    assert _close(r1, ref.weiszfeld_reweight_ref(z, w))
    assert _close(st1, ref.weiszfeld_step_ref(z, y, w))


@pytest.mark.cuda
def test_geomed_kernels_cast_bf16_to_f32(cuda):
    z, y, w = _points(8, 1000, 5, cuda)
    zb, yb = z.bfloat16(), y.bfloat16()
    assert geomed.sqdist(zb, yb).dtype == torch.float32
    assert torch.equal(geomed.sqdist(zb, yb),
                       geomed.sqdist(zb.float(), yb.float()))
    assert torch.equal(geomed.reweight(zb, w), geomed.reweight(zb.float(), w))


@pytest.mark.cuda
@pytest.mark.parametrize("kd", [(11, 8192), (5, 100), (2, 1)])
def test_geometric_median_kernel_matches_core(cuda, kd):
    k, d = kd
    z, _, _ = _points(k, d, 7, cuda)
    before = geomed.sqdist.launches
    got = ops.geometric_median_kernel(z)
    assert geomed.sqdist.launches > before
    assert _close(got, geometric_median(z))
    assert _close(got, ops.geometric_median_kernel(z, plain=True))


@pytest.mark.cuda
def test_geomed_failed_launch_raises(cuda, monkeypatch):
    lib = geomed._library()
    assert lib.gmom_sqdist(None, None, 0, 1, None, None, 1, None) != 0
    assert lib.gmom_reweight(None, None, 1, 0, None, 1, None) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def gmom_sqdist(*args):
            return 9

        @staticmethod
        def gmom_reweight(*args):
            return 9

    monkeypatch.setattr(geomed, "_library", lambda: Refusing())
    z, y, w = _points(4, 64, 1, cuda)
    with pytest.raises(RuntimeError, match="sqdist kernel launch failed"):
        geomed.sqdist(z, y)
    with pytest.raises(RuntimeError, match="reweight kernel launch failed"):
        geomed.reweight(z, w)


@pytest.mark.cuda
def test_geomed_failed_build_raises(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(geomed, "SOURCE",
                        _broken_source(tmp_path, monkeypatch))
    geomed._library.cache_clear()
    try:
        z, y, _ = _points(4, 64, 1, cuda)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            geomed.sqdist(z, y)
    finally:
        geomed._library.cache_clear()


@pytest.mark.cuda
def test_geomed_wrappers_reject_mismatched_shapes(cuda):
    z, y, w = _points(4, 64, 1, cuda)
    with pytest.raises(ValueError, match="width"):
        geomed.sqdist(z, y[:10])
    with pytest.raises(ValueError, match="weights"):
        geomed.reweight(z, w[:2])
    with pytest.raises(ValueError, match="same device"):
        geomed.sqdist(z, y.cpu())
