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
