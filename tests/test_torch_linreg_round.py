"""The port's full linreg round (repro_torch.kernels.geomed.round
``linreg_round_*``) against the JAX package's, and the slice's path —
failure-free rounds of Algorithm 2 through it — against JAX.

The port's plain versions (``linreg_round_ref``, which replays the
reference's d-tile loop, and the flat ``linreg_round_fused``) and the twin
of the CUDA kernel's summation order on either route
(``linreg_round_blocked``) are held against JAX ``linreg_round_kernel`` in
interpret mode, JAX ``linreg_round_ref`` and JAX ``linreg_round_fused``
with rtol 1e-4 / atol 1e-5 (the sums run in other orders); the kernel's
routes and launch plan are checked here too.  Inputs come from numpy seeds;
the slice test hands the reference's generated data across with
``convert.scenario_inputs_from_numpy``.  The CUDA kernel itself runs only
on a card: tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.grouping import make_grouping as jax_make_grouping
from repro.data import regression as jregression
from repro.kernels.geomed import round as jround
from repro_torch import convert
from repro_torch.core.grouping import make_grouping
from repro_torch.core.robust_train import per_worker_grads
from repro_torch.data import regression
from repro_torch.kernels.geomed import round as tround
from repro_torch.sim import engine, goldens
from repro_torch.sim.scenarios import Scenario

RTOL, ATOL = 1e-4, 1e-5
SCHEMES = ("contiguous", "strided", "seeded")
# (m, n, d, k): the reference tests' geometry, and an uneven paper-like k
SHAPES = [(12, 16, 300, 6), (20, 16, 400, 10), (50, 8, 100, 11)]
CASES = [(s, scheme, trim) for s in SHAPES for scheme in SCHEMES
         for trim in (None, 1.0, 3.0)]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _data(m, n, d, seed, outlier=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n, d)).astype(np.float32)
    t = rng.normal(size=(m, n)).astype(np.float32)
    theta = rng.normal(size=(d,)).astype(np.float32)
    if outlier:
        t[0] *= 100.0            # one worker far out so the trim drops it
    return x, t, theta


@functools.cache
def _jax_results(shape, scheme, trim):
    m, n, d, k = shape
    x, t, theta = (jnp.asarray(a) for a in _data(m, n, d, m * d,
                                                   trim == 1.0))
    grouping = jax_make_grouping(m, k, scheme=scheme)
    kw = dict(trim_multiplier=trim, max_iters=16)
    return {
        "kernel": np.asarray(jround.linreg_round_kernel(
            x, t, theta, grouping, interpret=True, **kw)),
        "ref": np.asarray(jround.linreg_round_ref(x, t, theta, grouping,
                                                  **kw)),
        "fused": np.asarray(jround.linreg_round_fused(x, t, theta, grouping,
                                                      **kw)),
    }


def _port(fn, shape, scheme, trim):
    m, n, d, k = shape
    x, t, theta = (torch.as_tensor(a) for a in _data(m, n, d, m * d,
                                                     trim == 1.0))
    y, iters = fn(x, t, theta, make_grouping(m, k, scheme=scheme),
                  trim_multiplier=trim, max_iters=16)
    assert y.shape == (d,) and y.dtype == torch.float32
    assert 1 <= int(iters) <= 16
    return y.numpy()


@pytest.mark.parametrize("shape,scheme,trim", CASES)
def test_linreg_round_ref_matches_jax(shape, scheme, trim):
    got = _port(tround.linreg_round_ref, shape, scheme, trim)
    want = _jax_results(shape, scheme, trim)
    for name in ("kernel", "ref"):
        np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape,scheme,trim", CASES)
def test_linreg_round_fused_matches_jax(shape, scheme, trim):
    got = _port(tround.linreg_round_fused, shape, scheme, trim)
    want = _jax_results(shape, scheme, trim)
    for name in ("kernel", "fused"):
        np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_linreg_round_matches_per_worker_grads_and_round(scheme):
    """The in-round gradients equal autograd's per-worker gradients fed
    to the GMoM round (tests/test_round_kernel.py's check, in the port)."""
    m, n, d, k = 20, 16, 400, 10
    x, t, theta = (torch.as_tensor(a) for a in _data(m, n, d, 5))
    grouping = make_grouping(m, k, scheme=scheme)
    grads, _ = per_worker_grads(regression.squared_loss, theta, (x, t))
    want, _ = tround.round_aggregate_ref(grads, grouping, max_iters=16)
    for fn in (tround.linreg_round_ref, tround.linreg_round_fused):
        got, _ = fn(x, t, theta, grouping, max_iters=16)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("dim,total,m,k", [(20, 4000, 20, 10),
                                           (100, 2000, 50, 11)])
def test_failure_free_rounds_match_jax(dim, total, m, k):
    """The slice's path: theta <- theta - eta * linreg_round(X, y, theta)
    for 5 rounds in both packages on the reference's data; the port's
    rounds go through the engine's ``failure_free_step``, the reference's
    take the RobustConfig defaults (trim 3, max_iters 32, tol 1e-7)."""
    eta, rounds = 0.5, 5
    kw = dict(trim_multiplier=3.0, max_iters=32, tol=1e-7)
    ds = jregression.generate(jax.random.PRNGKey(0), dim=dim,
                              total_samples=total, num_workers=m)
    tds = convert.scenario_inputs_from_numpy(
        np.asarray(ds.features), np.asarray(ds.targets),
        np.asarray(ds.theta_star), device="cpu")
    sc = Scenario(name="linreg/gmom/none/static", attack="none",
                  schedule="static", dim=dim, total_samples=total,
                  num_workers=m, num_batches=k, step_size=eta)
    step, _ = engine.failure_free_step(sc, device="cpu", dataset=tds)
    jgroup = jax_make_grouping(m, k)
    jtheta = jnp.zeros((dim,), jnp.float32)
    ttheta = torch.zeros((dim,), dtype=torch.float32)
    for _ in range(rounds):
        jtheta = jtheta - eta * jround.linreg_round_kernel(
            ds.features, ds.targets, jtheta, jgroup, interpret=True, **kw)
        ttheta = step(ttheta)
        np.testing.assert_allclose(ttheta.numpy(), np.asarray(jtheta),
                                   rtol=RTOL, atol=ATOL)
    err = float(torch.linalg.norm(ttheta - tds.theta_star))
    assert err < float(torch.linalg.norm(tds.theta_star))


@pytest.mark.parametrize("plain", [False, True])
def test_run_failure_free_matches_the_engines_failure_free_run(plain):
    """The driver of the slice's path against the engine's failure-free
    run (per-worker autograd + the GMoM round) under compare_traces."""
    sc = Scenario(name="linreg/gmom/none/static", attack="none",
                  schedule="static", rounds=12)
    got = engine.run_failure_free(sc, device="cpu", plain=plain)
    want = engine.run_scenario(sc, device="cpu")
    assert len(got["est_error"]) == sc.rounds
    assert goldens.compare_traces(got, {k: want[k] for k in got}) == []
    assert got["final_est_error"] < sc.paper_floor


def test_wrapper_on_cpu_runs_the_plain_version():
    x, t, theta = (torch.as_tensor(a) for a in _data(12, 16, 300, 1))
    grouping = make_grouping(12, 6, scheme="strided")
    before = tround.linreg_round_kernel.launches
    y, it = tround.linreg_round_kernel(x, t, theta, grouping, max_iters=8)
    y_ref, it_ref = tround.linreg_round_ref(x, t, theta, grouping,
                                            max_iters=8)
    assert torch.equal(y, y_ref) and int(it) == int(it_ref)
    assert tround.linreg_round_kernel.launches == before


def test_wrapper_casts_to_float32():
    x, t, theta = (torch.as_tensor(a) for a in _data(12, 16, 40, 2))
    grouping = make_grouping(12, 6)
    y, _ = tround.linreg_round_kernel(x.double(), t.double(), theta.double(),
                                      grouping, max_iters=4)
    want, _ = tround.linreg_round_ref(x, t, theta, grouping, max_iters=4)
    assert y.dtype == torch.float32 and torch.equal(y, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, t, theta = (torch.as_tensor(a) for a in _data(12, 16, 30, 3))
    grouping = make_grouping(12, 6)
    with pytest.raises(ValueError, match="X \\(m, n, d\\)"):
        tround.linreg_round_kernel(x, t[:, :5], theta, grouping)
    with pytest.raises(ValueError, match="X \\(m, n, d\\)"):
        tround.linreg_round_kernel(x, t, theta[:7], grouping)
    with pytest.raises(ValueError, match="worker batches"):
        tround.linreg_round_kernel(x[:10], t[:10], theta, grouping)
    meta = [torch.empty(a.shape, device="meta") for a in (x, t, theta)]
    with pytest.raises(ValueError, match="unsupported devices"):
        tround.linreg_round_kernel(*meta, grouping)


@pytest.mark.parametrize("m,n,d,want", [
    (50, 1000, 8192, 1),      # 32 d-tiles x 50 workers fill the card
    (50, 1000, 100, 21),      # chunks of 48 samples
    (12, 16, 300, 16),        # one sample per chunk
    (1, 7, 1, 7), (3, 10, 1, 10), (50, 100, 100, 20)])
def test_linreg_split_fills_the_grid_without_empty_chunks(m, n, d, want):
    split = tround.linreg_split(m, n, d)
    chunk = -(-n // split)
    assert split == want
    assert (split - 1) * chunk < n <= split * chunk


# ---------------------------------------------------------------------------
# the linreg kernel's routes, launch plan and the twin of its order

@pytest.mark.parametrize("d,want", [
    (4, "one_pass"), (100, "one_pass"), (300, "one_pass"),
    (8188, "one_pass"), (8192, "one_pass"),     # D_ONEPASS
    (8193, "two_pass"),                          # D_ONEPASS + 1
    (8191, "two_pass"),                          # D_ONEPASS - 1, d % 4 != 0
    (8196, "two_pass"), (302, "two_pass"), (1, "two_pass"),
    (25_557_032, "two_pass")])
def test_linreg_route_by_d(d, want):
    assert tround.D_ONEPASS == 8192
    assert tround.linreg_route(d) == want


@pytest.mark.parametrize("d", [4, 100, 300, 512, 516, 1024, 2048, 4096,
                               8188, 8192])
def test_onepass_plan_fits_a_block(d):
    """A row group of power-of-two threads holds the row at 16 columns a
    thread; a ring stage holds whole row groups; three stages fit in the
    227 KB of shared memory a block may use."""
    tpr = tround.onepass_row_threads(d)
    groups = tround.ONEPASS_THREADS // tpr
    rps = tround.onepass_rows_per_stage(d)
    assert tpr in (32, 64, 128, 256, 512)
    assert 4 * tround.ONEPASS_CHUNKS * tpr >= d
    assert tpr == 32 or 4 * tround.ONEPASS_CHUNKS * tpr // 2 < d
    assert rps % groups == 0 and rps >= groups
    assert 3 * rps * d * 4 <= 227 * 1024
    assert rps == groups or rps * d * 4 <= tround.ONEPASS_STAGE_BYTES


@pytest.mark.parametrize("m,n,sms,want", [
    (50, 1000, 132, 5),       # 250 blocks: two waves of 132, 95 % full
    (50, 1000, 114, 9),       # 450 blocks: four waves of 114, 99 % full
    (12, 16, 132, 16),        # too small to fill: one sample a chunk
    (50, 8, 132, 8), (1, 7, 132, 7),
    (64, 20, 132, 4)])        # 256 blocks on 264 slots
def test_onepass_split_fills_whole_waves(m, n, sms, want):
    split = tround.onepass_split(m, n, sms)
    assert split == want
    chunk = -(-n // split)
    assert (split - 1) * chunk < n <= split * chunk       # no empty chunk
    blocks = m * split
    waves = -(-blocks // sms)
    assert split == n or blocks >= tround.WAVE_FILL * waves * sms


@pytest.mark.parametrize("m,n,split", [(1, 7, 7), (3, 10, 4), (50, 1000, 5),
                                       (12, 16, 16), (5, 9, 1)])
def test_sample_chunks_cover_every_row_once_within_a_worker(m, n, split):
    blocks = tround.sample_chunks(m, n, split)
    assert len(blocks) == m * split
    rows = sorted((j, s) for j, s0, s1 in blocks for s in range(s0, s1))
    assert rows == [(j, s) for j in range(m) for s in range(n)]
    for j, s0, s1 in blocks:
        assert 0 <= j < m and 0 <= s0 < s1 <= n           # inside worker j


@pytest.mark.parametrize("route", ["one_pass", "two_pass"])
@pytest.mark.parametrize("shape,scheme,trim", CASES)
def test_linreg_round_blocked_matches_jax(shape, scheme, trim, route):
    """The twin of the CUDA kernel's summation order, on either route, with
    three sample chunks and a grid of two blocks, against JAX
    ``linreg_round_kernel`` (interpret) and ``linreg_round_fused``."""
    got = _port(functools.partial(tround.linreg_round_blocked, route=route,
                                  n_split=3, n_blocks=2),
                shape, scheme, trim)
    want = _jax_results(shape, scheme, trim)
    for name in ("kernel", "fused"):
        np.testing.assert_allclose(got, want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_linreg_round_blocked_default_plan_matches_fused():
    """With the plan the wrapper makes on an H100 (132 SMs, two blocks of
    the round kernel an SM: the route by d and its split) on a d of each
    route."""
    for d in (300, 302):
        x, t, theta = (torch.as_tensor(a) for a in _data(12, 16, d, d))
        grouping = make_grouping(12, 6, scheme="seeded")
        n_split = (tround.onepass_split(12, 16, 132)
                   if tround.linreg_route(d) == "one_pass"
                   else tround.linreg_split(12, 16, d))
        got, it = tround.linreg_round_blocked(
            x, t, theta, grouping, n_blocks=tround.persistent_blocks(d, 2, 132),
            n_split=n_split, max_iters=3, tol=0.0)
        want, itp = tround.linreg_round_fused(x, t, theta, grouping,
                                              max_iters=3, tol=0.0)
        assert int(it) == int(itp) == 3
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


# where the linreg round stops: a float32 Weiszfeld loop reaches an exact
# fixed point or settles into a 1-ulp cycle depending on its summation
# order, in the reference too (PERF.md, open questions): (m, n, d, k),
# numpy seed, grouping -> the iterations of the kernel's twin on the H100
# plan at tol=0, max_iters=32 (32: it cycled to the cap)
STOPS = [((12, 16, 300, 6), 0, "contiguous", 13),
         ((20, 16, 400, 10), 2, "strided", 11),
         ((50, 1000, 100, 10), 0, "strided", 15),
         ((50, 1000, 100, 10), 0, "contiguous", 32)]


@pytest.mark.parametrize("shape,seed,scheme,want", STOPS)
def test_linreg_stop_on_the_h100_plan_is_pinned(shape, seed, scheme, want):
    """The twin replays the kernel bit for bit on the plan the wrapper
    makes on an H100 (132 SMs, two round-kernel blocks an SM), so its
    count is the kernel's; whether it stops below the cap is a property of
    the order, not of the algorithm: whatever the count, the aggregate
    agrees with JAX ``linreg_round_fused``."""
    m, n, d, k = shape
    x, t, theta = _data(m, n, d, seed)
    y, it = tround.linreg_round_blocked(
        *(torch.as_tensor(a) for a in (x, t, theta)),
        make_grouping(m, k, scheme=scheme),
        n_blocks=tround.persistent_blocks(d, 2, 132),
        n_split=tround.onepass_split(m, n, 132), max_iters=32, tol=0.0)
    assert int(it) == want
    jy = np.asarray(jround.linreg_round_fused(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(theta),
        jax_make_grouping(m, k, scheme=scheme), max_iters=32, tol=0.0))
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL, atol=ATOL)
