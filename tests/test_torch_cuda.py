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
            flash._DTYPES[dtype], 1, 16, 16, 2, 1, hd, 1, 0, hd ** -0.5,
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
