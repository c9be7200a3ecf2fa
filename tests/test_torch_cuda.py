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

import torch_shard_ranks
from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.core import aggregators, robust_train
from repro_torch.core import shard_aggregation as sa
from repro_torch.core.geometric_median import geometric_median
from repro_torch.core.grouping import make_grouping
from repro_torch.kernels import _build
from repro_torch.kernels.geomed import geomed, ops, ref
from repro_torch.kernels.geomed import round as rk
from repro_torch.launch import ranks

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
        None, None, None, 1, None) != 0

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


# Weiszfeld stopping modes of chip_smoke.py: tol=0 still stops at an exact
# float32 fixed point, so "fixed32" runs up to 32 iterations; "few" runs
# exactly 3 in both versions where no batch is trimmed to a fixed point;
# "early_exit" is the default tol=1e-8, cap 64
MODES = {"fixed32": dict(tol=0.0, max_iters=32),
         "few": dict(tol=0.0, max_iters=3), "early_exit": {}}
ROUND_SHAPES = [(20, 10, 20), (50, 11, 777), (8, 4, 2048), (64, 16, 4096),
                (40, 33, 300), (64, 64, 513), (50, 11, 8192)]


def _round_grid(k, d, device):
    """The persistent grid the round kernel's wrapper launches."""
    lib = rk._library()
    return rk.persistent_blocks(d, rk._blocks_per_sm(lib, "gmom_round", k),
                                rk._sm_count(device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mkd", ROUND_SHAPES)
def test_kernel_matches_plain_in_every_mode(cuda, mkd, scheme, trim, mode):
    """The persistent kernel against round_aggregate_ref: within tolerance,
    bitwise repeatable; at max_iters=3 without a planted outlier the
    iteration counts agree exactly."""
    m, k, d = mkd
    g = _stacked(m, d, m * d + 1, cuda)
    if trim == 1.0:
        g[0] *= 100.0
    grouping = make_grouping(m, k, scheme=scheme)
    kw = dict(MODES[mode], trim_multiplier=trim)
    cap = kw.get("max_iters", 64)
    y1, it1 = rk.round_aggregate_kernel(g, grouping, **kw)
    y2, it2 = rk.round_aggregate_kernel(g, grouping, **kw)
    yp, itp = rk.round_aggregate_ref(g, grouping, **kw)
    assert torch.equal(y1, y2) and int(it1) == int(it2)
    assert _close(y1, yp)
    assert 1 <= int(it1) <= cap
    if mode == "few" and trim != 1.0:
        assert int(it1) == int(itp) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mkd,n_blocks", [
    ((20, 10, 20), None), ((50, 11, 777), None), ((64, 64, 513), None),
    ((50, 11, 8192), None),            # the wrapper's grid: one tile a block
    ((50, 11, 3000), 3),               # every block streams four tiles
    ((50, 11, 3000), 8),               # blocks of two tiles and of one
    ((64, 64, 3000), 2), ((40, 33, 5000), 4)])
def test_kernel_matches_its_blocked_twin(cuda, mkd, n_blocks, mode,
                                         monkeypatch):
    """round_aggregate_blocked on the kernel's grid replays the kernel's
    arithmetic bit for bit, the iteration count included, in every
    stopping mode; a grid forced smaller than the tiles makes blocks
    stream Z."""
    m, k, d = mkd
    if n_blocks is None:
        n_blocks = _round_grid(k, d, cuda)
    else:
        monkeypatch.setattr(rk, "persistent_blocks", lambda *a: n_blocks)
    g = _stacked(m, d, 4, cuda)
    grouping = make_grouping(m, k, scheme="seeded")
    kw = MODES[mode]
    y, it = rk.round_aggregate_kernel(g, grouping, **kw)
    yt, itt = rk.round_aggregate_blocked(g.cpu(), grouping,
                                         n_blocks=n_blocks, **kw)
    assert int(it) == int(itt)
    assert torch.equal(y.cpu(), yt)


@pytest.mark.cuda
def test_one_block_reaches_a_fixed_point_at_the_papers_d(cuda):
    """chip_smoke.py's input at (50, 11, 100): on one block the kernel
    reaches an exact float32 fixed point well below the cap, as the plain
    version does on the card, and the twin replays it bit for bit (a
    block that streams its tiles sums in another order, which settles
    into a 1-ulp cycle on this input)."""
    gen = torch.Generator(device=cuda).manual_seed(50 * 7 + 11)
    g = torch.randn((50, 100), generator=gen, device=cuda) + 1.0
    grouping = make_grouping(50, 11)
    for mode in ("fixed32", "early_exit"):
        kw = MODES[mode]
        cap = kw.get("max_iters", 64)
        y, it = rk.round_aggregate_kernel(g, grouping, **kw)
        _, itp = rk.round_aggregate_ref(g, grouping, **kw)
        yt, itt = rk.round_aggregate_blocked(g.cpu(), grouping, n_blocks=1,
                                             **kw)
        assert int(it) < cap and int(itp) < cap, (mode, int(it), int(itp))
        assert int(it) == int(itt) and torch.equal(y.cpu(), yt)


@pytest.mark.cuda
def test_exact_iteration_counts_at_three(cuda):
    for m, k, d in ROUND_SHAPES:
        g = _stacked(m, d, 9, cuda)
        for scheme in SCHEMES:
            grouping = make_grouping(m, k, scheme=scheme)
            _, it = rk.round_aggregate_kernel(g, grouping, tol=0.0,
                                              max_iters=3)
            _, itp = rk.round_aggregate_ref(g, grouping, tol=0.0,
                                            max_iters=3)
            assert int(it) == int(itp) == 3, (m, k, d, scheme)


@pytest.mark.cuda
def test_k64_streams_z_through_the_ring(cuda):
    """k = 64 with more tiles than the grid holds: blocks stream their
    tiles of Z through the ring instead of keeping one resident."""
    m, k = 64, 64
    d = 2 * rk.TILE * _round_grid(k, 10 ** 9, cuda) + 77
    g = _stacked(m, d, 5, cuda)
    grouping = make_grouping(m, k, scheme="strided")
    for kw in (dict(tol=0.0, max_iters=3), {}):
        y1, it1 = rk.round_aggregate_kernel(g, grouping, **kw)
        y2, it2 = rk.round_aggregate_kernel(g, grouping, **kw)
        yp, _ = rk.round_aggregate_ref(g, grouping, **kw)
        assert torch.equal(y1, y2) and int(it1) == int(it2)
        assert _close(y1, yp)


@pytest.mark.cuda
def test_one_device_kernel_per_call(cuda):
    """The round is one cooperative launch and nothing else (no fill
    kernel, no copy); a linreg round is the one-pass front and the
    persistent tail, or on the two-pass route the residual, the gradients
    and the tail; sqdist is one launch (no reduction kernel), and so is a
    geometric median (a loop kernel by k, unit weights of its own).  The
    session records CPU activity too: a CUDA-only session can close before
    a short kernel's record arrives."""
    g = _stacked(50, 8192, 6, cuda)
    grouping = make_grouping(50, 11)
    linreg = [(_linreg_data(16, 64, d, 7, cuda), make_grouping(16, 8))
              for d in (8192, 8196)]
    z, y, _ = _points(11, 100_000, 3, cuda)
    z64 = _points(64, 100_000, 3, cuda)[0]
    calls = [lambda: rk.round_aggregate_kernel(g, grouping)] + [
        (lambda a=args, gr=gr: rk.linreg_round_kernel(*a, gr))
        for args, gr in linreg] + [
        lambda: geomed.sqdist(z, y), lambda: ops.geometric_median_kernel(z),
        lambda: ops.geometric_median_kernel(z64)]
    for call in calls:                                  # build and warm up
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for call in calls:
            call()
            torch.cuda.synchronize()
    names = [ev.name for ev in sorted(
        (ev for ev in prof.events()
         if ev.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda ev: ev.time_range.start)]
    kernels = [next((k for k in ("gmom_round_kernel", "linreg_onepass_kernel",
                                 "residual_kernel", "grad_kernel",
                                 "sqdist_kernel", "weiszfeld_regs_kernel",
                                 "weiszfeld_tiles_kernel")
                     if k in name), name) for name in names]
    assert kernels == ["gmom_round_kernel",
                       "linreg_onepass_kernel", "gmom_round_kernel",
                       "residual_kernel", "grad_kernel", "gmom_round_kernel",
                       "sqdist_kernel", "weiszfeld_regs_kernel",
                       "weiszfeld_tiles_kernel"]


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


LINREG_SHAPES = [(12, 16, 300, 6), (20, 16, 400, 10), (50, 8, 100, 11),
                 (50, 1000, 100, 10), (40, 3, 777, 33), (64, 20, 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("trim", [None, 1.0, 3.0])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mndk", LINREG_SHAPES)
def test_linreg_kernel_matches_plain_in_every_mode(cuda, mndk, scheme, trim,
                                                   mode):
    m, n, d, k = mndk
    x, t, theta = _linreg_data(m, n, d, m * d + 1, cuda, trim == 1.0)
    grouping = make_grouping(m, k, scheme=scheme)
    kw = dict(MODES[mode], trim_multiplier=trim)
    route = rk.linreg_route(d)
    before = dict(rk.linreg_round_kernel.route_launches)
    y1, it1 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    y2, it2 = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    yp, itp = rk.linreg_round_fused(x, t, theta, grouping, **kw)
    moved = {r: v - before[r]
             for r, v in rk.linreg_round_kernel.route_launches.items()}
    assert moved == {r: 2 * (r == route) for r in rk.ROUTES}
    assert torch.equal(y1, y2) and int(it1) == int(it2)
    assert _close(y1, yp)
    assert 1 <= int(it1) <= kw.get("max_iters", 64)
    if mode == "few" and trim != 1.0:
        assert int(it1) == int(itp) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8188, 8192, 8190, 8193, 8196, 4])
def test_linreg_routes_at_their_boundary(cuda, d):
    """d % 4 == 0 up to D_ONEPASS takes the one-pass route, every other d
    the two-pass one; both match the plain version and the blocked twin
    of their route."""
    m, n, k = 8, 24, 4
    x, t, theta = _linreg_data(m, n, d, d, cuda)
    grouping = make_grouping(m, k, scheme="seeded")
    route = rk.linreg_route(d)
    assert route == ("one_pass" if d % 4 == 0 and d <= rk.D_ONEPASS
                     else "two_pass")
    before = dict(rk.linreg_round_kernel.route_launches)
    kw = dict(tol=0.0, max_iters=3)
    y, it = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    assert rk.linreg_round_kernel.route_launches[route] == before[route] + 1
    yp, _ = rk.linreg_round_fused(x, t, theta, grouping, **kw)
    sms = rk._sm_count(cuda)
    split = (rk.onepass_split(m, n, sms) if route == "one_pass"
             else rk.linreg_split(m, n, d))
    lib = rk._linreg_library()
    nb = rk.persistent_blocks(d, rk._blocks_per_sm(lib, "gmom_linreg", k),
                              sms)
    yt, _ = rk.linreg_round_blocked(x.cpu(), t.cpu(), theta.cpu(), grouping,
                                    route=route, n_split=split, n_blocks=nb,
                                    **kw)
    assert _close(y, yp) and torch.equal(y.cpu(), yt)
    assert int(it) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["few", "early_exit"])
@pytest.mark.parametrize("mndk", [(50, 1000, 100, 11), (12, 16, 302, 6),
                                  (16, 64, 8192, 8), (20, 16, 400, 10)])
def test_linreg_kernel_matches_its_blocked_twin(cuda, mndk, mode):
    """linreg_round_blocked with the wrapper's plan replays the kernel's
    arithmetic bit for bit on the route d takes."""
    m, n, d, k = mndk
    x, t, theta = _linreg_data(m, n, d, m * d, cuda)
    grouping = make_grouping(m, k, scheme="seeded")
    kw = MODES[mode]
    y, it = rk.linreg_round_kernel(x, t, theta, grouping, **kw)
    sms = rk._sm_count(cuda)
    split = (rk.onepass_split(m, n, sms) if rk.linreg_route(d) == "one_pass"
             else rk.linreg_split(m, n, d))
    nb = rk.persistent_blocks(
        d, rk._blocks_per_sm(rk._linreg_library(), "gmom_linreg", k), sms)
    yt, itt = rk.linreg_round_blocked(x.cpu(), t.cpu(), theta.cpu(), grouping,
                                      n_blocks=nb, n_split=split, **kw)
    assert int(it) == int(itt)
    assert torch.equal(y.cpu(), yt)


@pytest.mark.cuda
def test_linreg_both_routes_agree_on_one_input(cuda):
    """The two-pass front, forced at a d the one-pass route takes, gives
    the same aggregate within tolerance."""
    x, t, theta = _linreg_data(50, 200, 1024, 8, cuda)
    grouping = make_grouping(50, 11)
    kw = dict(trim_multiplier=3.0, max_iters=3, tol=0.0, eps=1e-12)
    y1, _ = rk._linreg_launch(x, t, theta, grouping, "one_pass", **kw)
    y2, _ = rk._linreg_launch(x, t, theta, grouping, "two_pass", **kw)
    assert _close(y1, y2)
    with pytest.raises(ValueError, match="one-pass route"):
        rk._linreg_launch(x[..., :1022].contiguous(), t,
                          theta[:1022].contiguous(), grouping, "one_pass",
                          **kw)


@pytest.mark.cuda
def test_linreg_takes_a_misaligned_view(cuda):
    """X whose data does not start on 16 bytes is copied for the bulk
    copy, not refused."""
    x, t, theta = _linreg_data(12, 17, 300, 8, cuda)
    grouping = make_grouping(12, 6)
    xs = x.reshape(-1)[1:12 * 16 * 300 + 1].reshape(12, 16, 300)
    assert xs.data_ptr() % 16 != 0
    y, _ = rk.linreg_round_kernel(xs, t[:, :16], theta, grouping)
    yp, _ = rk.linreg_round_fused(xs, t[:, :16], theta, grouping)
    assert _close(y, yp)


@pytest.mark.cuda
def test_linreg_failed_launch_raises(cuda, monkeypatch):
    lib = rk._linreg_library()
    assert lib.gmom_linreg_round(
        None, None, None, None, None, None, 1, 1, 0, 1, 0, 0.0, 1, 0.0,
        1e-12, 0.0, 1.0, 1, 1, None, None, None, None, None, None, 1,
        None) != 0

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
    before = geomed.weiszfeld_loop.launches
    got = ops.geometric_median_kernel(z)
    assert geomed.weiszfeld_loop.launches > before
    assert _close(got, geometric_median(z))
    assert _close(got, ops.geometric_median_kernel(z, plain=True))


@pytest.mark.cuda
def test_geomed_failed_launch_raises(cuda, monkeypatch):
    lib = geomed._library()
    assert lib.gmom_sqdist(None, None, 0, 1, 4, None, None, None, 1,
                           None) != 0
    assert lib.gmom_reweight(None, None, 1, 0, None, 1, None) != 0
    assert lib.gmom_weiszfeld(None, None, 65, 1, 0, 1, 1e-8, 1e-12, 0.0,
                              None, None, None, 1, None) != 0

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def gmom_sqdist(*args):
            return 9

        @staticmethod
        def gmom_reweight(*args):
            return 9

        @staticmethod
        def gmom_weiszfeld(*args):
            return 9

    monkeypatch.setattr(geomed, "_library", lambda: Refusing())
    z, y, w = _points(4, 64, 1, cuda)
    with pytest.raises(RuntimeError, match="sqdist kernel launch failed"):
        geomed.sqdist(z, y)
    with pytest.raises(RuntimeError, match="reweight kernel launch failed"):
        geomed.reweight(z, w)
    with pytest.raises(RuntimeError,
                       match="weiszfeld_loop kernel launch failed"):
        ops.geometric_median_kernel(z)


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


def _misaligned(t):
    """The same values in a contiguous view whose data starts 4 bytes past
    a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].reshape(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["aligned", "misaligned"])
@pytest.mark.parametrize("kd", [(2, 64), (8, 1000), (16, 4096), (17, 512),
                                (64, 512), (70, 300), (5, 777), (1, 1),
                                (11, 100_003), (11, 1_000_000)])
def test_sqdist_matches_its_blocked_twin(cuda, kd, view):
    """ref.weiszfeld_distances_blocked on the wrapper's plan (one wave of
    blocks, float4 loads where the rows are 16-byte aligned, else single
    columns; k > 16 in row chunks) replays the kernel bit for bit."""
    k, d = kd
    z, y, _ = _points(k, d, k + d, cuda)
    if view == "misaligned":
        z = _misaligned(z)
    n_blocks, vec = geomed.sqdist_plan(z, y)
    assert vec == (4 if d % 4 == 0 and view == "aligned" else 1)
    assert n_blocks <= geomed._sqdist_blocks_per_sm(vec) * rk._sm_count(cuda)
    got = geomed.sqdist(z, y)
    want = ref.weiszfeld_distances_blocked(z, y, n_blocks=n_blocks, vec=vec)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(geomed.sqdist(z, y), got)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters,tol", [(0, 1e-8), (1, 1e-8), (3, 0.0),
                                           (64, 1e-8)])
@pytest.mark.parametrize("kd,n_blocks", [
    ((11, 8192), None),               # regs: the wrapper's grid
    ((5, 100), None), ((1, 50), None), ((16, 4096), None),
    ((11, 100_000), None), ((11, 3001), None),
    ((11, 100_000), 7),               # regs: several units a thread
    ((64, 512), None), ((17, 1000), None),   # tiles: one tile a block
    ((64, 3000), 2),                  # tiles: every block streams six
    ((33, 3000), 5),                  # tiles: blocks of three and of two
    ((17, 3001), 4)])
def test_weiszfeld_loop_matches_its_blocked_twin(cuda, kd, n_blocks,
                                                 max_iters, tol, monkeypatch):
    """ops.geometric_median_blocked on the kernel's grid replays the loop
    kernel for k (``geomed.loop_kernel``) bit for bit, the iteration count
    included, with a zero weight: the register-streamed kernel in units of
    4 columns or 1, the tile kernel on resident and streaming blocks,
    aligned or not."""
    k, d = kd
    z, _, w = _points(k, d, 7 + k, cuda)
    w[0] = 0.0
    if n_blocks is not None:
        monkeypatch.setattr(geomed, "loop_blocks", lambda *a: n_blocks)
    for points in (z, _misaligned(z)):
        vec = geomed.vector_width(d, points)
        assert vec == (4 if d % 4 == 0 and points is z else 1)
        nb = geomed.loop_blocks(k, d, vec, cuda)
        y, it = geomed.weiszfeld_loop(points, w, max_iters=max_iters, tol=tol)
        yt, itt = ops.geometric_median_blocked(points, w, n_blocks=nb,
                                               vec=vec, max_iters=max_iters,
                                               tol=tol)
        assert int(it) == int(itt)
        assert torch.equal(y.cpu(), yt)
    if max_iters <= 3 and k > 1:
        _, itp = ops._geometric_median(z, w, max_iters=max_iters, tol=tol,
                                       plain=True)
        assert int(it) == int(itp) == max_iters


@pytest.mark.cuda
def test_weiszfeld_loop_unit_weights_are_its_own(cuda):
    """No weights means unit weights, taken inside the kernel."""
    z, _, _ = _points(11, 3000, 2, cuda)
    y, it = geomed.weiszfeld_loop(z)
    y1, it1 = geomed.weiszfeld_loop(z, torch.ones(11, device=cuda))
    assert torch.equal(y, y1) and int(it) == int(it1)


@pytest.mark.cuda
def test_geometric_median_routes_by_k(cuda):
    """k <= 16: one launch of the register-streamed loop kernel; k <= 64:
    one of the tile kernel; k > 64: the step kernels, one sqdist and one
    reweight launch an iteration; counted by route and by kernel."""
    for k, route, kernel in ((16, "device_loop", "regs"),
                             (17, "device_loop", "tiles"),
                             (64, "device_loop", "tiles"),
                             (70, "step_kernels", None)):
        z, _, _ = _points(k, 1000, k, cuda)
        ops.reset_launches()
        geomed.reset_loop_launches()
        before = (geomed.weiszfeld_loop.launches, geomed.sqdist.launches,
                  geomed.reweight.launches)
        y, it = ops._geometric_median(z)
        after = (geomed.weiszfeld_loop.launches, geomed.sqdist.launches,
                 geomed.reweight.launches)
        assert ops.geometric_median_kernel.route_launches == {
            r: int(r == route) for r in ops.ROUTES}
        assert geomed.weiszfeld_loop.kernel_launches == {
            n: int(n == kernel) for n in geomed.LOOP_KERNELS}
        steps = int(it) if route == "step_kernels" else 0
        assert [a - b for a, b in zip(after, before)] == \
            [int(route == "device_loop"), steps, steps]
        yp, _ = ops._geometric_median(z, plain=True)
        assert _close(y, yp)
    with pytest.raises(ValueError, match="1 <= k <= 64"):
        geomed.weiszfeld_loop(_points(65, 100, 1, cuda)[0])


@pytest.mark.cuda
def test_weiszfeld_loop_refuses_a_grid_the_card_cannot_hold(cuda,
                                                            monkeypatch):
    """A cooperative grid larger than the card holds at once is refused by
    the launch (an error, never a hang), and the wrapper raises, for
    either loop kernel."""
    for k in (11, 64):
        too_many = 2 * geomed._loop_blocks_per_sm(k) * rk._sm_count(cuda)
        z, _, _ = _points(k, too_many * rk.TILE, 1, cuda)
        monkeypatch.setattr(geomed, "loop_blocks", lambda *a, n=too_many: n)
        with pytest.raises(RuntimeError,
                           match="weiszfeld_loop kernel launch"):
            geomed.weiszfeld_loop(z)


# ---------------------------------------------------------------------------
# flash attention and the dense LM's serve path

# (B, Tq, Tk, H, KV, hd, causal, window): tests/test_kernels.py's grid, an
# H2O-width head (hd 120, GQA 4), a ragged Tq < Tk and a non-causal ragged
# Tk (keys past Tk are masked in the kernel); hd 16 and 256 over several
# kv tiles (zero padding to 64 and BK = 64), Tq not a multiple of 128; and
# hd 20, which bf16 takes to the CUDA-core route (hd % 8 != 0)
ATTN_CASES = [(2, 64, 64, 4, 2, 32, True, None),
              (1, 128, 128, 8, 8, 64, True, None),
              (2, 100, 100, 4, 1, 32, True, None),
              (1, 256, 256, 4, 2, 64, True, 64),
              (2, 64, 64, 4, 4, 32, False, None),
              (1, 96, 96, 6, 2, 16, True, 32),
              (1, 333, 333, 8, 2, 120, True, 100),
              (2, 77, 200, 4, 2, 128, True, None),
              (1, 20, 20, 2, 1, 16, False, None),
              (1, 70, 150, 4, 1, 256, False, 50),
              (1, 300, 300, 4, 4, 16, True, None),
              (2, 300, 300, 2, 1, 256, True, 130),
              (1, 150, 150, 4, 2, 20, True, 64)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _restated_bound(q, k, v, causal, window):
    """(y32, allowed): the plain version in f32 on bf16 q, k, v, and the
    bound of the bf16 kernels against it, elementwise
        |d| <= 2**-8 |y32| + 2**-8 (P|V|) + 2 ATTN_TOL[f32]:
    the output's rounding; the rounding of P to bf16 before P V (relative
    error <= 2**-9 a term, doubled for l being summed from the unrounded
    p), with P|V| the plain version in f32 with |v| in place of v; the f32
    tolerance."""
    from repro_torch.kernels.attention import ref
    q, k, v = q.float(), k.float(), v.float()
    want32 = ref.flash_attention_ref(q, k, v, causal=causal,
                                     sliding_window=window)
    pv = ref.flash_attention_ref(q, k, v.abs(), causal=causal,
                                 sliding_window=window)
    return want32, (2.0 ** -8 * (want32.abs() + pv)
                    + 2 * ATTN_TOL[torch.float32])


def _qkv(case, dtype, device, seed=0):
    B, Tq, Tk, H, KV, hd = case[:6]
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(          # noqa: E731
        rng.normal(size=s).astype(np.float32), device=device).to(dtype)
    return mk(B, Tq, H, hd), mk(B, Tk, KV, hd), mk(B, Tk, KV, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_kernel_matches_plain_and_is_deterministic(cuda, case, dtype):
    from repro_torch.kernels.attention import flash, ops, ref
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, dtype, cuda)
    route = flash.route(dtype, case[5])
    assert route == ("tensor_core" if dtype == torch.bfloat16
                     and case[5] % 8 == 0 else "cuda_core")
    before = flash.flash_attention.launches
    by_route = dict(flash.flash_attention.route_launches)
    a = ops.attention(q, k, v, causal=causal, sliding_window=window)
    b = ops.attention(q, k, v, causal=causal, sliding_window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=window)
    assert flash.flash_attention.launches == before + 2
    assert flash.flash_attention.route_launches == {
        r: n + 2 * (r == route) for r, n in by_route.items()}
    assert a.dtype == dtype and a.shape == q.shape
    assert torch.equal(a, b)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        want32, allowed = _restated_bound(q, k, v, causal, window)
        assert bool(((a.float() - want32).abs() <= allowed).all())


# (B, T, H, KV, hd, window, block): a rank's block of queries at offsets
# block r against all T keys; the last has a block and offsets that are no
# multiple of a tile
OFFSET_CASES = [(1, 512, 4, 2, 64, None, 128), (2, 640, 8, 2, 120, 100, 160),
                (1, 700, 4, 1, 32, 64, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OFFSET_CASES)
def test_flash_q_offset_rows_are_the_full_launch_rows(cuda, case, dtype):
    """A launch at query offset o on q[:, o:o + n] equals rows o..o + n of
    the launch over all queries (every row is owned by one CTA and walks
    its live kv tiles in one order; a masked tile adds exact zeros, or
    junk the first live tile multiplies by 0), on both routes, and is
    held to the route's plain twin; offset 0 is the launch without it."""
    from repro_torch.kernels.attention import flash, ops, ref
    B, T, H, KV, hd, window, n = case
    q, k, v = _qkv((B, T, T, H, KV, hd), dtype, cuda, seed=3)
    full = ops.attention(q, k, v, causal=True, sliding_window=window)
    assert torch.equal(flash.flash_attention(
        q, k, v, causal=True, sliding_window=window, q_offset=0), full)
    twin = (ref.flash_attention_ref if dtype == torch.float32
            else ref.flash_attention_tiled_ref)
    for o in range(0, T, n):
        qo = q[:, o:o + n]
        got = ops.attention(qo, k, v, causal=True, sliding_window=window,
                            q_offset=o)
        assert torch.equal(got, full[:, o:o + n]), o
        want = twin(qo, k, v, causal=True, sliding_window=window,
                    q_offset=o)
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, k, v, q_offset=-1)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.attention import flash, ops
    q, k, v = _qkv((1, 16, 16, 4, 2, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(*_qkv((1, 8, 8, 2, 1, 272), torch.float32, cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="sliding_window"):
        flash.flash_attention(q, k, v, sliding_window=0)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.attention(q.requires_grad_(), k, v)


@pytest.mark.cuda
def test_flash_tensor_core_route_fails_the_no_window_fault(cuda):
    """The restated bound against f32 must fail the kernel run without
    its window, on a shape where the window is live."""
    from repro_torch.kernels.attention import ops
    case = (1, 512, 512, 8, 2, 120, True, 128)
    q, k, v = _qkv(case, torch.bfloat16, cuda)
    want32, allowed = _restated_bound(q, k, v, True, 128)
    good = ops.attention(q, k, v, causal=True, sliding_window=128)
    bad = ops.attention(q, k, v, causal=True, sliding_window=None)
    assert bool(((good.float() - want32).abs() <= allowed).all())
    assert not bool(((bad.float() - want32).abs() <= allowed).all())


@pytest.mark.cuda
def test_flash_tensor_core_route_reads_views_at_any_offset(cuda):
    """TMA wants 16-byte aligned bases: a contiguous view that starts 2
    bytes into its storage is copied, not refused or misread."""
    from repro_torch.kernels.attention import flash, ops
    case = (1, 200, 200, 4, 2, 64, True, None)
    q, k, v = _qkv(case, torch.bfloat16, cuda)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.data_ptr() % 16 != 0 and q_odd.is_contiguous()
    before = flash.flash_attention.route_launches["tensor_core"]
    assert torch.equal(ops.attention(q_odd, k, v), ops.attention(q, k, v))
    assert flash.flash_attention.route_launches["tensor_core"] == before + 2


@pytest.mark.cuda
def test_flash_routes_refuse_each_others_inputs(cuda):
    """The C entry takes the route it is given and refuses inputs that
    route does not take: f32 or hd % 8 != 0 on the tensor-core route."""
    from repro_torch.kernels.attention import flash
    lib = flash._library()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 20)):
        q, k, v = _qkv((1, 16, 16, 2, 1, hd), dtype, cuda)
        out = torch.empty_like(q)
        rc = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            flash._DTYPES[dtype], 1, 16, 16, 2, 1, hd, 1, 0, 0, hd ** -0.5,
            flash.ROUTES["tensor_core"], stream)
        assert rc == 1                   # cudaErrorInvalidValue


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_failed_launch_raises(cuda, monkeypatch, dtype):
    from repro_torch.kernels.attention import flash, ops
    lib = flash._library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def flash_attention_forward(*args):
            return 9                     # cudaErrorInvalidConfiguration

    monkeypatch.setattr(flash, "_library", lambda: Refusing())
    before = flash.flash_attention.launches
    by_route = dict(flash.flash_attention.route_launches)
    with pytest.raises(RuntimeError, match="flash_attention kernel launch"):
        ops.attention(*_qkv((1, 16, 16, 4, 2, 32), dtype, cuda))
    assert flash.flash_attention.launches == before
    assert flash.flash_attention.route_launches == by_route


@pytest.mark.cuda
def test_flash_failed_build_raises(cuda, tmp_path, monkeypatch):
    from repro_torch.kernels.attention import flash
    monkeypatch.setattr(flash, "SOURCE",
                        _broken_source(tmp_path, monkeypatch))
    flash._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            flash.flash_attention(*_qkv((1, 16, 16, 4, 2, 32),
                                        torch.float32, cuda))
    finally:
        flash._library.cache_clear()


def _reduced_lm(device):
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config("h2o-danube-3-4b").reduced()
    return cfg, model.init(0, cfg, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [80, 2100])
def test_prefill_goes_through_the_kernel_once_per_layer(cuda, T):
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    cfg, params = _reduced_lm(cuda)
    tokens = torch.as_tensor(
        np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T)),
        device=cuda)
    flash.reset_launches()
    h = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert flash.flash_attention.launches == cfg.num_layers
    assert flash.flash_attention.route_launches["cuda_core"] == \
        cfg.num_layers                   # f32
    h_plain = steps.make_prefill_step(cfg, plain=True)(params,
                                                       {"tokens": tokens})
    assert flash.flash_attention.launches == cfg.num_layers
    scale = float(h_plain.abs().max())
    assert float((h - h_plain).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("T", [80, 2100])
def test_bf16_prefill_goes_through_the_tensor_cores(cuda, T):
    """The reduced model in bf16 (hd 64): every layer's attention on the
    tensor-core route, within chip_smoke.py's bf16 prefill bound (5e-2 of
    max|h|) of the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = get_config("h2o-danube-3-4b").reduced().with_(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = model.init(0, cfg, device=cuda)
    tokens = torch.as_tensor(
        np.random.default_rng(T).integers(0, cfg.vocab_size, (2, T)),
        device=cuda)
    flash.reset_launches()
    h = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert flash.flash_attention.route_launches == {
        "tensor_core": cfg.num_layers, "cuda_core": 0}
    h_plain = steps.make_prefill_step(cfg, plain=True)(params,
                                                       {"tokens": tokens})
    scale = float(h_plain.float().abs().max())
    assert float((h.float() - h_plain.float()).abs().max()) <= 5e-2 * scale


@pytest.mark.cuda
def test_serve_on_the_card_matches_the_cpu(cuda):
    from repro_torch.launch import serve
    cfg, params = _reduced_lm(cuda)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    cpu_params = to_cpu(params)
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 80)))
    tok, logits, _ = serve.generate(params, cfg, prompts.to(cuda), 8)
    tok_cpu, logits_cpu, _ = serve.generate(cpu_params, cfg, prompts, 8)
    assert tok.shape == (2, 8)
    torch.testing.assert_close(logits.cpu(), logits_cpu, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_too_large_cooperative_grid_raises(cuda, monkeypatch):
    """A grid the card cannot hold at once is refused by the launch (a
    grid barrier in it would hang), and the wrapper raises."""
    g = _stacked(20, 30, 3, cuda)
    grouping = make_grouping(20, 10)
    lib = rk._library()
    too_many = 100 * rk._sm_count(cuda) * lib.gmom_round_blocks_per_sm(10)
    monkeypatch.setattr(rk, "persistent_blocks", lambda *args: too_many)
    with pytest.raises(RuntimeError, match="launch failed.*720"):
        rk.round_aggregate_kernel(g, grouping)
    x, t, theta = _linreg_data(12, 16, 300, 3, cuda)
    with pytest.raises(RuntimeError, match="launch failed.*720"):
        rk.linreg_round_kernel(x, t, theta, make_grouping(12, 6))


# ---------------------------------------------------------------------------
# the report wire and the staleness buffer on the card

def _wire_tree(m, seed, device):
    """A multi-leaf stacked tree (dict keys inserted out of sorted order),
    with an odd last dim, a (m,) leaf, -0.0 and a subnormal in it."""
    rng = np.random.default_rng(seed)
    tree = {"z": rng.normal(size=(m, 8193)).astype(np.float32),
            "a": {"y": (rng.normal(size=(m, 3, 100)) * 7).astype(np.float32),
                  "b": rng.normal(size=(m,)).astype(np.float32)}}
    tree["z"][0, :3] = [-0.0, -1e-45, 0.0]
    return {"z": torch.as_tensor(tree["z"], device=device),
            "a": {"y": torch.as_tensor(tree["a"]["y"], device=device),
                  "b": torch.as_tensor(tree["a"]["b"], device=device)}}


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_payload_on_the_card_equals_the_cpu_payload(cuda, seed):
    """Threefry bits, the exact max, the constant multiply, the IEEE
    division and the floor: q and scale are the same bits on both."""
    from repro_torch import random as prng
    from repro_torch import tree as jtree
    from repro_torch.core import compression
    codec = compression.get_codec("int8_stochastic")
    g = _wire_tree(50, seed, cuda)
    key = prng.fold_in(prng.PRNGKey(seed), 29)
    on_card = codec.encode(g, key=key.to(cuda))
    on_cpu = codec.encode(_cpu(g), key=key)
    for part in ("q", "scale"):
        for a, b in zip(jtree.leaves(on_card[part]),
                        jtree.leaves(on_cpu[part])):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b), part


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 50, 51])
def test_packed_and_raw_votes_equal_on_the_card(cuda, m):
    from repro_torch import tree as jtree
    from repro_torch.core import compression
    g = _wire_tree(m, m, cuda)
    payload = compression.get_codec("sign").encode(g)
    packed = compression.majority_vote_packed(payload, g)
    raw = compression.majority_vote_signs(g)
    cpu_words = compression.get_codec("sign").encode(_cpu(g))
    for a, b in zip(jtree.leaves(payload), jtree.leaves(cpu_words)):
        assert torch.equal(a.cpu(), b)
    for a, b, c in zip(jtree.leaves(packed), jtree.leaves(raw),
                       jtree.leaves(compression.majority_vote_signs(
                           _cpu(g)))):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["linreg/gmom/sign_flip/rotating/stale",
                                  "linreg/sign_majority_static"])
def test_stale_and_sign_goldens_replay_on_the_card(cuda, name):
    """Through the round kernel for the stale campaign (one launch a
    round), and the resume interrupted at round 19 byte for byte."""
    from repro_torch.sim import engine, goldens
    rk.round_aggregate_kernel.launches = 0
    trace = engine.run_scenario(name, device=cuda)
    if "gmom" in name:
        assert rk.round_aggregate_kernel.launches == trace["rounds"]
    assert goldens.compare_traces(trace, goldens.load_golden(name)) == []
    assert goldens.check_resume_bit_exact(name, device=cuda) == []


# ---------------------------------------------------------------------------
# shard-local aggregation on rank processes over gloo, CUDA tensors

def _shard_cases(m, k, width, kind="sharded", **cfg_kw):
    rng = np.random.default_rng(11)
    stacked = {"w": rng.normal(size=(m, width)).astype(np.float32),
               "s": rng.normal(size=(m,)).astype(np.float32)}
    rules = [(n, c) for n in aggregators.available()
             for c in ("none",) + tuple(
                 x for x in [aggregators.get_aggregator(n).native_codec] if x)]
    if kind == "shardmap":
        rules = [("gmom", "none")]
    return {f"{n}-{c}": {
        "kind": kind, "stacked": stacked, "dtype": "float32", "seed": 3,
        "cfg": robust_train.RobustConfig(
            num_workers=m, num_byzantine=1, num_batches=k, aggregator=n,
            compression=c, **cfg_kw)}
        for n, c in rules}


@pytest.fixture(scope="module")
def two_rank_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks hold CUDA tensors")
    cases = _shard_cases(8, 3, 2 * 4096)
    return cases, ranks.run(torch_shard_ranks.run_cases, 2, cases, "cuda",
                            timeout=600.0)


@pytest.mark.cuda
def test_two_gloo_ranks_on_cuda_tensors_equal_virtual_mode(two_rank_run):
    """Every rule x codec on 2 gloo ranks holding CUDA tensors (partials
    staged through the host): each rank's result is its slice of the
    virtual-mode result on the card, bit for bit."""
    cases, results = two_rank_run
    assert len(cases) == 17
    for cid, case in cases.items():
        want = robust_train.aggregate_reported(
            torch_shard_ranks.stacked_tensors(case, "cuda"), case["cfg"],
            key=prng.PRNGKey(case["seed"], device="cuda"),
            shard_spec=sa.ShardSpec(num_shards=2, mode="virtual"))
        for r, res in enumerate(results):
            got, launches = res[cid]
            assert launches == 0, cid      # partitioned: never the kernel
            for w, g in zip(jtree.leaves(want), jtree.leaves(got)):
                w = w.cpu() if w.ndim == 0 else sa.shard_slice(w, r, 2).cpu()
                assert torch.equal(g, w), (cid, r)


@pytest.mark.cuda
def test_shardmap_aggregate_launches_the_round_kernel_once_per_rank(cuda):
    """make_shardmap_aggregate on 4 ranks (m = 4 workers, k = 2) with
    round_backend="auto" on CUDA tensors: one round-kernel launch per rank
    per call, every rank the same y, within 1e-5 of gmom_aggregator on the
    gathered stack through the kernel and through the reference path."""
    cases = _shard_cases(4, 2, 8192, kind="shardmap", gmom_max_iters=32,
                         gmom_tol=1e-7)
    results = ranks.run(torch_shard_ranks.run_cases, 4, cases, "cuda",
                        timeout=600.0)
    stacked = torch_shard_ranks.stacked_tensors(cases["gmom-none"], "cuda")
    first = results[0]["gmom-none"][0]
    for backend in ("auto", "reference"):
        want = aggregators.gmom_aggregator(
            stacked, num_batches=2, num_byzantine=1, max_iters=32, tol=1e-7,
            round_backend=backend)
        for res in results:
            got, launches = res["gmom-none"]
            assert launches == 1
            for key in want:
                assert torch.equal(got[key], first[key])
                assert float((got[key] - want[key].cpu()).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# the group train step on the model mesh: 4 gloo ranks of the card

@pytest.mark.cuda
def test_mesh_train_step_on_four_ranks_of_the_card(cuda):
    """make_group_train_step on a (2, 2) mesh of 4 ranks holding CUDA
    tensors (reduced minitron-4b, k = 4, gmom under sign_flip, SGD, two
    steps): shard-local never launches the round kernel, the gathered
    variant once a rank a step; every rank gathers the same params, both
    within 1e-4 of the unsharded step on the card (the gathered one through
    the kernel, the shard-local one on the reference round)."""
    import torch_mesh_train_ranks as mtr
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch import configs, convert, optim
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = configs.get_config("minitron-4b").reduced()
    params = tree_map(lambda t: t.numpy(), model.init(7, cfg, device="cpu"))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, (4, 2, 64)) for _ in range(2)]
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    base = dict(kind="step", arch="minitron-4b", params=params,
                batches=toks, seed=10, opt="sgd", lr=0.1, microbatches=1,
                rc=rc, min_fsdp_elems=1 << 12, target_backend="cuda",
                device="cuda", mesh="2x2")
    cases = {v: dict(base, variant=v) for v in ("shard_local", "gathered")}
    per_rank = ranks.run(mtr.run_cases, 4, cases,
                         {"2x2": ((2, 2), ("data", "model"))},
                         timeout=600.0)
    for variant, backend, launches in (("shard_local", "reference", 0),
                                       ("gathered", "auto", 2)):
        step = steps.make_group_train_step(
            cfg, robust_train.RobustConfig(**dict(rc, round_backend=backend)),
            optim.sgd(0.1))
        p = convert.lm_params_from_numpy(cfg, params, cuda)
        s = optim.sgd(0.1).init(p)
        rows = []
        for t, tok in enumerate(toks):
            tok = torch.as_tensor(tok, device=cuda).long()
            p, s, m = step(p, s, {"tokens": tok,
                                  "labels": torch.roll(tok, -1, -1)},
                           prng.PRNGKey(10 + t, device=cuda), t)
            rows.append({k: float(v) for k, v in m.items()})
        got = per_rank[0][variant]
        assert all(res[variant]["launches"] == launches for res in per_rank)
        assert all(res[variant]["same_everywhere"] for res in per_rank)
        assert all(res[variant]["repeat_equal"] for res in per_rank)
        for t, row in enumerate(rows):
            for k, v in row.items():
                assert float(got["metrics"][t][k]) == pytest.approx(
                    v, rel=1e-4), (variant, t, k)
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(p)):
            b = b.cpu()
            assert float((a - b).abs().max()) <= \
                1e-4 * float(b.abs().max()) + 1e-7, variant


# ---------------------------------------------------------------------------
# the hybrid, audio and vlm families on the model mesh

# a rank's block of queries on the mesh each family runs on
# (B, Tq a rank, Tk, H, KV, hd, causal, |model|): Zamba2's shared block and
# InternVL2 on (1, 4), SeamlessM4T's encoder, decoder and cross-attention on
# (2, 2)
FAMILY_SP_CASES = {
    "zamba2_shared": (1, 2048, 8192, 32, 32, 80, True, 4),
    "seamless_encoder": (1, 1024, 2048, 16, 16, 64, False, 2),
    "seamless_decoder": (1, 4096, 8192, 16, 16, 64, True, 2),
    "seamless_cross": (1, 4096, 2048, 16, 16, 64, False, 2),
    "internvl2": (1, 2048, 8192, 48, 8, 128, True, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FAMILY_SP_CASES))
def test_flash_offset_rows_at_the_mesh_families_shapes(cuda, name, dtype):
    """Each of |model| ranks' blocks at query offset Tq r equals the
    matching rows of the one launch over all |model| Tq queries, on the
    dtype's route (bf16: the tensor cores; f32: the CUDA cores), non-causal
    ones included."""
    from repro_torch.kernels.attention import flash, ops
    B, Tq, Tk, H, KV, hd, causal, n = FAMILY_SP_CASES[name]
    q, k, v = _qkv((B, n * Tq, Tk, H, KV, hd), dtype, cuda, seed=14)
    route = flash.route(dtype, hd)
    full = ops.attention(q, k, v, causal=causal, sliding_window=None)
    by_route = dict(flash.flash_attention.route_launches)
    for r in range(n):
        o = r * Tq
        got = ops.attention(q[:, o:o + Tq], k, v, causal=causal,
                            sliding_window=None, q_offset=o)
        assert torch.equal(got, full[:, o:o + Tq]), (name, o)
    assert flash.flash_attention.route_launches == {
        rt: c + n * (rt == route) for rt, c in by_route.items()}


@pytest.mark.cuda
def test_channel_parallel_mamba_block_on_two_ranks_of_the_card(cuda):
    """One Mamba2 block at Zamba2's head width and state (d_model 256, 8
    heads of 64, state 64, chunks of 128, T = 512) channel-parallel on a
    (1, 2) mesh of 2 gloo ranks holding CUDA tensors, against one process
    on the card: the output the same bits on both ranks and within 1e-5
    of max|out| of one process, every gradient within 1e-4 of its max."""
    import torch_mesh_family_ranks as fr
    case = dict(kind="mamba", mesh="1x2", device="cuda",
                **fr.mamba_inputs(dict(d_model=256, d_state=64, head_dim=64,
                                       chunk=128), batch=2, seq=512))
    per_rank = ranks.run(fr.run_cases, 2, {"mamba": case},
                         {"1x2": ((1, 2), ("data", "model"))}, timeout=600.0)
    out, x_grad, grads = fr.mamba_one_process(case, device=cuda)
    got = per_rank[0]["mamba"]
    assert torch.equal(per_rank[1]["mamba"]["out"], got["out"])

    def close(a, b, rtol):
        return float((a - b).abs().max()) <= rtol * float(b.abs().max())

    assert close(got["out"], out, 1e-5)
    assert close(got["x_grad"], x_grad, 1e-4)
    for a, b in zip(jtree.leaves(got["grads"]), jtree.leaves(grads)):
        assert a.shape == b.shape and close(a, b, 1e-4)


# ---------------------------------------------------------------------------
# Byzantine-robust LM training on the card (reduced config)

def _train_rows(metrics):
    n = metrics["loss_median"].shape[0]
    return {"history": [{k: float(v[i]) for k, v in metrics.items()}
                        for i in range(n)]}


@pytest.mark.cuda
def test_lm_rounds_kernel_matches_plain_backend(cuda):
    """Three worker-mode LM rounds (H2O-Danube3-4B reduced, m = 4, k = 4,
    gmom under sign_flip, AdamW) through round_backend "auto" (one
    round-kernel launch a round) and "fused_interpret" (none) agree under
    compare_traces; two kernel runs are bitwise equal."""
    from torch.utils._pytree import tree_map

    from repro_torch import configs, optim
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model
    from repro_torch.sim.goldens import compare_traces
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=80,
                         global_batch=8, num_workers=4, device=cuda)
    batches = tree_map(lambda *xs: torch.stack(xs),
                       *[stream.batch(i) for i in range(3)])
    rows, launches = [], []
    for backend in ("auto", "auto", "fused_interpret"):
        rc = robust_train.RobustConfig(
            num_workers=4, num_byzantine=1, num_batches=4,
            aggregator="gmom", attack="sign_flip", round_backend=backend)
        opt = optim.adamw(1e-3)
        run = robust_train.make_run_rounds(
            lambda p, b: model.loss_fn(p, b, cfg), opt, rc, device=cuda)
        params = model.init(0, cfg, device=cuda)
        rk.round_aggregate_kernel.launches = 0
        *_, metrics = run(params, opt.init(params), batches,
                          prng.PRNGKey(3, device=cuda),
                          per_round_batches=True)
        launches.append(rk.round_aggregate_kernel.launches)
        rows.append(_train_rows(metrics))
    assert launches == [3, 3, 0]
    assert rows[0] == rows[1]
    assert compare_traces(rows[0], rows[2]) == []


@pytest.mark.cuda
def test_group_step_kernel_matches_plain_backend(cuda):
    """make_group_train_step with remat and two microbatches on the card:
    one round-kernel launch a step on "auto", the same metrics as on
    "fused_interpret" under compare_traces."""
    from repro_torch import configs, optim
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.sim.goldens import compare_traces
    cfg = configs.get_config("minitron-4b").reduced().with_(remat=True)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=16, num_workers=4, device=cuda)
    traces, launches = {}, {}
    for backend in ("auto", "fused_interpret"):
        rc = robust_train.RobustConfig(
            num_workers=4, num_byzantine=1, num_batches=4,
            aggregator="gmom", attack="sign_flip", round_backend=backend)
        opt = optim.adamw(1e-3)
        step = steps.make_group_train_step(cfg, rc, opt, microbatches=2)
        params = model.init(1, cfg, device=cuda)
        opt_state = opt.init(params)
        rk.round_aggregate_kernel.launches = 0
        hist = []
        for t in range(3):
            params, opt_state, met = step(params, opt_state, stream.batch(t),
                                          prng.PRNGKey(t, device=cuda), t)
            hist.append({k: float(v) for k, v in met.items()})
        launches[backend] = rk.round_aggregate_kernel.launches
        traces[backend] = {"history": hist}
    assert launches == {"auto": 3, "fused_interpret": 0}
    assert compare_traces(traces["auto"], traces["fused_interpret"]) == []


@pytest.mark.cuda
def test_loss_fn_never_launches_flash(cuda):
    """Training runs the plain attention core, as the reference trains
    through its jnp core: loss_fn and its gradient launch no flash kernel,
    while the prefill step on the same params launches one a layer."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import steps
    from repro_torch.models import model
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    params = model.init(0, cfg, device=cuda)
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=80,
                        global_batch=2, num_workers=1,
                        device=cuda).batch(0)
    one = {k: v[0] for k, v in batch.items()}
    flash.reset_launches()
    loss = model.loss_fn(params, one, cfg)
    grads, _ = robust_train.per_worker_grads(
        lambda p, b: model.loss_fn(p, b, cfg), params, batch)
    assert bool(torch.isfinite(loss)) and flash.flash_attention.launches == 0
    assert all(bool(torch.isfinite(g).all()) for g in jtree.leaves(grads))
    steps.make_prefill_step(cfg)(params, {"tokens": one["tokens"]})
    assert flash.flash_attention.launches == cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("ekn", [(32, 8, 2048, 256), (384, 8, 1024, 512)])
def test_moe_dispatch_on_the_card_equals_the_cpu(cuda, ekn):
    """Granite's 32 experts of top-8 and Kimi-K2's 384: on the CPU's
    top_ids/top_w the card's expert buffers, slots, experts and weights
    are bitwise the CPU's, at the configured capacity and at one that
    drops; the card's own top_ids equal the CPU's except at near ties (the
    swapped experts' probabilities within 4 float32 ulps)."""
    from repro_torch.models import moe
    E, K, N, D = ekn
    spec = moe.MoESpec(d_model=D, d_ff=64, num_experts=E,
                       experts_per_token=K)
    gen = torch.Generator().manual_seed(E)
    params = {"router": torch.randn(D, E, generator=gen) * D ** -0.5}
    x = torch.randn(N, D, generator=gen)
    ids, w, _, _ = moe.route(params, spec, x)
    on_card = {"router": params["router"].to(cuda)}
    cids, cw, _, _ = moe.route(on_card, spec, x.to(cuda))
    probs = torch.softmax(x @ params["router"], dim=-1)
    diff = (cids.cpu() != ids)
    for n, j in diff.nonzero().tolist():
        a, b = int(ids[n, j]), int(cids[n, j])
        gap = float((probs[n, a] - probs[n, b]).abs())
        assert gap <= 4 * float(np.spacing(np.float32(probs[n, a]))), \
            (n, a, b, gap)
    for capacity in (moe._capacity(spec, N), N * K // (4 * E)):
        want_in, want = moe._dispatch_local(
            spec, x, ids, w, expert_lo=0, num_local=E, capacity=capacity)
        got_in, got = moe._dispatch_local(
            spec, x.to(cuda), ids.to(cuda), w.to(cuda), expert_lo=0,
            num_local=E, capacity=capacity)
        assert torch.equal(got_in.cpu(), want_in)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_moe_per_worker_grads_repeat_bitwise(cuda):
    """Worker-mode gradients (torch.func.vmap of grad) of a bf16 Granite
    at reduced width through the dispatch, twice on the card: bitwise
    equal, the router's gradient float32."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model
    cfg = configs.get_config("granite-moe-1b-a400m").reduced().with_(
        num_experts=32, experts_per_token=8, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16)
    params = model.init(0, cfg, device=cuda)
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=128,
                        global_batch=8, num_workers=4, device=cuda).batch(0)
    runs = [robust_train.per_worker_grads(
        lambda p, b: model.loss_fn(p, b, cfg), params, batch)
        for _ in range(2)]
    (g1, l1), (g2, l2) = runs
    assert torch.equal(l1, l2) and bool(torch.isfinite(l1).all())
    assert g1["layers"]["moe"]["router"].dtype == torch.float32
    for a, b in zip(jtree.leaves(g1), jtree.leaves(g2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the recurrent families (RWKV6, Zamba2) and worker-mode remat

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_zamba2_head_width(cuda, dtype):
    """Zamba2's shared attention: 32 heads over 32 KV heads of 80, causal,
    no window; bf16 takes the tensor-core route (the 128-column instance,
    48 padded columns), f32 the CUDA-core route."""
    from repro_torch.kernels.attention import flash, ops, ref
    case = (1, 512, 512, 32, 32, 80, True, None)
    q, k, v = _qkv(case, dtype, cuda, seed=80)
    route = flash.route(dtype, 80)
    assert route == ("tensor_core" if dtype == torch.bfloat16
                     else "cuda_core")
    by_route = dict(flash.flash_attention.route_launches)
    a = ops.attention(q, k, v, causal=True, sliding_window=None)
    b = ops.attention(q, k, v, causal=True, sliding_window=None)
    assert flash.flash_attention.route_launches == {
        r: n + 2 * (r == route) for r, n in by_route.items()}
    assert torch.equal(a, b)
    want = ref.flash_attention_ref(q, k, v, causal=True, sliding_window=None)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        want32, allowed = _restated_bound(q, k, v, True, None)
        assert bool(((a.float() - want32).abs() <= allowed).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 100])
def test_wkv_chunked_on_the_card_equals_the_cpu(cuda, T):
    """The chunked WKV (two chunks; and a ragged T, the scan) on the card
    against the same call on the CPU, at rtol 1e-5 of max|y| (float32
    matmuls summed in other orders)."""
    from repro_torch.models import rwkv
    rng = np.random.default_rng(T)
    mk = lambda *s, scale=1.0: torch.as_tensor(       # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32))
    r, k, v = mk(2, T, 4, 16), mk(2, T, 4, 16), mk(2, T, 4, 16)
    w = torch.exp(-torch.exp(mk(2, T, 4, 16, scale=0.5) - 0.6))
    u, S = mk(4, 16, scale=0.1), mk(2, 4, 16, 16, scale=0.1)
    args = (r, k, v, w, u, S)
    y, s = rwkv.wkv_chunked(*args)
    yc, sc = rwkv.wkv_chunked(*(a.to(cuda) for a in args))
    for got, want in ((yc, y), (sc, s)):
        assert float((got.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_chunked_on_the_card_equals_the_cpu(cuda, chunk):
    from repro_torch.models import mamba
    spec = mamba.MambaSpec(d_model=64, d_state=16, head_dim=16, chunk=chunk)
    rng = np.random.default_rng(chunk)
    mk = lambda *s: torch.as_tensor(                  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    x, Bm, Cm = mk(2, 256, 8, 16), mk(2, 256, 16), mk(2, 256, 16)
    dt = torch.nn.functional.softplus(mk(2, 256, 8))
    A = torch.exp(mk(8) * 0.5)
    S0 = mk(2, 8, 16, 16)
    args = (x, dt, A, Bm, Cm)
    y, s = mamba._ssd_chunked(*args, spec, init_state=S0)
    yc, sc = mamba._ssd_chunked(*(a.to(cuda) for a in args), spec,
                                init_state=S0.to(cuda))
    for got, want in ((yc, y), (sc, s)):
        assert float((got.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-2.7b"])
def test_remat_under_vmap_of_grad_on_the_card(cuda, arch):
    """Worker-mode gradients (torch.func.vmap of grad) with remat on the
    card's torch: torch.equal to those without remat."""
    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import model
    cfg = configs.get_config(arch).reduced()
    params = model.init(0, cfg, device=cuda)
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8, num_workers=4, device=cuda).batch(0)
    runs = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        runs.append(robust_train.per_worker_grads(
            lambda p, b: model.loss_fn(p, b, c), params, batch))
    for a, b in zip(jtree.leaves(runs[0]), jtree.leaves(runs[1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_recurrent_serve_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced RWKV6 and Zamba2: the prefill (Zamba2's shared block through
    the flash kernel) and decode on the card against the CPU."""
    from torch.utils._pytree import tree_map
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    cfg = configs.get_config(arch).reduced()
    params = model.init(0, cfg, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64)))
    h = steps.make_prefill_step(cfg)(on_card, {"tokens": tokens.to(cuda)})
    h_cpu = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert float((h.cpu() - h_cpu).abs().max()) <= \
        1e-4 * float(h_cpu.abs().max())
    tok, logits, _ = serve.generate(on_card, cfg, tokens[:, :16].to(cuda), 4)
    tok_cpu, logits_cpu, _ = serve.generate(params, cfg, tokens[:, :16], 4)
    torch.testing.assert_close(logits.cpu(), logits_cpu, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 333, 84, 4, 2, 64, False, None),
                                  (1, 1024, 256, 16, 16, 64, False, None),
                                  (1, 256, 256, 16, 16, 64, False, None)])
def test_flash_non_causal_with_more_queries_than_keys(cuda, case, dtype):
    """SeamlessM4T's shapes scaled down: the decoder's cross-attention
    (Tq > Tk, ragged and not) and the encoder's bidirectional
    self-attention, on the dtype's route, against the plain version."""
    from repro_torch.kernels.attention import flash, ops, ref
    q, k, v = _qkv(case, dtype, cuda, seed=case[1])
    route = flash.route(dtype, case[5])
    by_route = dict(flash.flash_attention.route_launches)
    a = ops.attention(q, k, v, causal=False)
    b = ops.attention(q, k, v, causal=False)
    assert flash.flash_attention.route_launches == {
        r: n + 2 * (r == route) for r, n in by_route.items()}
    assert torch.equal(a, b)
    want = ref.flash_attention_ref(q, k, v, causal=False, sliding_window=None)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        want32, allowed = _restated_bound(q, k, v, False, None)
        assert bool(((a.float() - want32).abs() <= allowed).all())
    # the causal kernel on the same inputs is another function
    assert not torch.allclose(ops.attention(q, k, v, causal=True).float(),
                              want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_audio_and_vlm_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced SeamlessM4T (2 encoder, 2 decoder layers: 6 flash launches
    a prefill, the encoder's and the cross-attention's non-causal) and
    InternVL2 (2 layers behind 16 patches: 2 launches): the kernel path on
    the card against the CPU; then decode on the card against the CPU."""
    from torch.utils._pytree import tree_map
    from repro_torch import configs
    from repro_torch.kernels.attention import flash
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    cfg = configs.get_config(arch).reduced()
    params = model.init(0, cfg, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (2, 64)))}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    else:
        batch["patches"] = torch.as_tensor(
            rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    flash.reset_launches()
    h = steps.make_prefill_step(cfg)(
        on_card, {n: x.to(cuda) for n, x in batch.items()})
    want_launches = 3 * cfg.num_layers if cfg.family == "audio" \
        else cfg.num_layers
    assert flash.flash_attention.launches == want_launches
    h_cpu = steps.make_prefill_step(cfg)(params, batch)
    assert float((h.cpu() - h_cpu).abs().max()) <= \
        1e-4 * float(h_cpu.abs().max())
    tok, logits, _ = serve.generate(on_card, cfg,
                                    batch["tokens"][:, :16].to(cuda), 4)
    _, logits_cpu, _ = serve.generate(params, cfg, batch["tokens"][:, :16],
                                      4)
    torch.testing.assert_close(logits.cpu(), logits_cpu, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4096, 1_000_003])
def test_draws_at_indices_on_the_card_are_the_cpu_bits(cuda, n):
    """``random.bits_at`` / ``uniform_at`` on the card at random indices
    (a chunk edge among them) are the CPU's whole draw there, bit for
    bit: the hash is exact integer arithmetic on either device."""
    gen = np.random.default_rng(n)
    idx = torch.as_tensor(gen.integers(0, n, size=min(n, 5000)))
    key = prng.PRNGKey(n % 97)
    whole = prng.bits(key, (n,))
    on_card = prng.bits_at(key.to(cuda), (n,), idx.to(cuda))
    assert torch.equal(on_card.cpu(), whole[idx])
    assert torch.equal(prng.uniform_at(key.to(cuda), (n,), idx.to(cuda)).cpu(),
                       prng.uniform(key, (n,))[idx])
