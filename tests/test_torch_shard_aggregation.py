"""Shard-local aggregation in the port (repro_torch.core.shard_aggregation)
against the JAX package's, and the port's ranks against its own oracle.

* The port's ``"virtual"`` mode against the reference's ``"virtual"``
  mode, for every registered rule x (``none`` and its native codec) x
  k in {4, 3} x {f32, bf16} at (m, S) = (8, 8) on the reference test's
  pytree (tests/test_shardmap_aggregate.py), at rtol 1e-4 / atol 1e-5;
  the int8 and sign payloads bit for bit.
* The port's ``"shard_map"`` mode on 8 gloo ranks (one spawn for the
  module) bit-identical to its own virtual mode, on the same cases and at
  4096 coordinates a shard.
* ``make_shardmap_aggregate`` on the ``reference`` and ``fused_interpret``
  backends within 1e-5 of the reference's single-device
  ``gmom_aggregator``; it raises unless k | m.
* ``theory`` and ``configs.linreg_paper`` equal the reference's.

The reference runs with ``jax_threefry_partitionable=False`` (the scheme
the port's PRNG reproduces)."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import linreg_paper as jlinreg_paper
from repro.core import aggregators as jagg
from repro.core import compression as jc
from repro.core import robust_train as jrt
from repro.core import shard_aggregation as jsa
from repro.core import theory as jtheory
from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.configs import linreg_paper
from repro_torch.core import aggregators, compression, robust_train
from repro_torch.core import shard_aggregation as sa
from repro_torch.core import theory
from repro_torch.launch import ranks

import torch_shard_ranks

M, S, SEED = 8, 8, 7
RTOL, ATOL = 1e-4, 1e-5
# bf16 results against the reference: the pytree Weiszfeld rounds its
# weights to bf16 (``_wsum`` in the leaf dtype, in both packages), and the
# f32 distance sums run in XLA's order there and torch's here, so an ulp
# in a distance can flip a weight's bf16 rounding and move y by a bf16
# step of max|z|; four bf16 steps (2**-6) of max|y| bound it (measured: up
# to 1.6 steps, gmom_per_leaf and int8_gmom; every other rule is exact)
BF16_STEPS = 2.0 ** -6
WIDE = 4096          # coordinates a shard in the wide case
RULE_CODECS = [(name, codec) for name in jagg.available()
               for codec in ("none",) + tuple(
                   c for c in [jagg.get_aggregator(name).native_codec] if c)]
CASES = [(name, codec, k, dt) for (name, codec) in RULE_CODECS
         for k in (4, 3) for dt in ("float32", "bfloat16")]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _np_stacked(width=16, seed=0):
    """The reference test's pytree (dict insertion order unsorted), from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, width)).astype(np.float32),
            "b": {"x": rng.normal(size=(M, 4, 8)).astype(np.float32)},
            "s": rng.normal(size=(M,)).astype(np.float32)}


def _cfg(cls, name, codec, k, **kw):
    return cls(num_workers=M, num_byzantine=1, num_batches=k, attack="none",
               aggregator=name, compression=codec, gmom_max_iters=8,
               gmom_tol=1e-7, **kw)


def _case(name, codec, k, dt, width=16, kind="sharded"):
    return {"kind": kind, "cfg": _cfg(robust_train.RobustConfig, name, codec,
                                      k),
            "stacked": _np_stacked(width), "dtype": dt, "seed": SEED}


def _cid(name, codec, k, dt):
    return f"{name}-{codec}-{k}-{dt}"


def _virtual(case):
    stacked = torch_shard_ranks.stacked_tensors(case)
    spec = sa.ShardSpec(num_shards=S, mode="virtual")
    return robust_train.aggregate_reported(
        stacked, case["cfg"], key=prng.PRNGKey(case["seed"]),
        shard_spec=spec)


def _j(tree, dt):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dt), tree)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# one spawn of 8 gloo ranks runs every shard_map case of the module

def _rank_cases():
    cases = {_cid(*c): _case(*c) for c in CASES}
    for name, codec in RULE_CODECS:
        cases[f"wide-{name}-{codec}"] = _case(name, codec, 4, "float32",
                                              width=S * WIDE)
    for backend in ("reference", "fused_interpret"):
        case = _case("gmom", "none", 4, "float32", kind="shardmap")
        case["cfg"] = dataclasses.replace(case["cfg"], gmom_max_iters=32,
                                          round_backend=backend)
        cases[f"shardmap-{backend}"] = case
    return cases


@pytest.fixture(scope="module")
def gloo_run():
    cases = _rank_cases()
    return cases, ranks.run(torch_shard_ranks.run_cases, S, cases,
                            timeout=900.0)


def _assert_rank_slices_equal(virtual, per_rank):
    """Rank r's result is the r-th last-dim slice of the virtual result,
    bit for bit (a (m,)-leaf result, replicated, whole on every rank)."""
    for r, got in enumerate(per_rank):
        for want, g in zip(jtree.leaves(virtual), jtree.leaves(got)):
            w = want if want.ndim == 0 else sa.shard_slice(want, r, S)
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), (r, float((g.float() - w.float())
                                                .abs().max()))


@pytest.mark.parametrize("name,codec,k,dt", CASES)
def test_shard_map_bit_identical_to_virtual(gloo_run, name, codec, k, dt):
    cases, results = gloo_run
    cid = _cid(name, codec, k, dt)
    _assert_rank_slices_equal(_virtual(cases[cid]),
                              [res[cid][0] for res in results])


@pytest.mark.parametrize("name,codec", RULE_CODECS)
def test_shard_map_bit_identical_at_4096_a_shard(gloo_run, name, codec):
    """Each rank reduces a contiguous (8, 4096) slice, the virtual oracle
    a contiguous copy of the same view: the same bits."""
    cases, results = gloo_run
    cid = f"wide-{name}-{codec}"
    _assert_rank_slices_equal(_virtual(cases[cid]),
                              [res[cid][0] for res in results])


@pytest.mark.parametrize("backend", ["reference", "fused_interpret"])
def test_make_shardmap_aggregate_matches_reference_gmom(gloo_run, backend):
    cases, results = gloo_run
    case = cases[f"shardmap-{backend}"]
    cfg = case["cfg"]
    want = jagg.gmom_aggregator(
        _j(case["stacked"], jnp.float32), num_batches=cfg.num_batches,
        num_byzantine=cfg.num_byzantine,
        trim_multiplier=cfg.trim_multiplier, max_iters=cfg.gmom_max_iters,
        tol=cfg.gmom_tol)
    first = results[0][f"shardmap-{backend}"][0]
    for res in results:
        got, launches = res[f"shardmap-{backend}"]
        assert launches == 0    # no CUDA tensor: the kernel never launches
        for g, f, w in zip(jtree.leaves(got), jtree.leaves(first),
                           jax.tree.leaves(want)):
            assert g.shape == tuple(w.shape)
            assert torch.equal(g, f)        # every rank holds the same y
            assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) < 1e-5


def test_make_shardmap_aggregate_needs_k_dividing_m():
    cfg = robust_train.RobustConfig(num_workers=8, num_byzantine=1,
                                    num_batches=3)
    with pytest.raises(ValueError, match="k \\| m"):
        robust_train.make_shardmap_aggregate(cfg)


# ---------------------------------------------------------------------------
# the port's virtual mode against the reference's

@pytest.mark.parametrize("name,codec,k,dt", CASES)
def test_virtual_mode_matches_reference(name, codec, k, dt):
    case = _case(name, codec, k, dt)
    got = _virtual(case)
    jcfg = _cfg(jrt.RobustConfig, name, codec, k)
    want = jrt.aggregate_reported(
        _j(case["stacked"], getattr(jnp, dt)), jcfg,
        key=jax.random.PRNGKey(SEED),
        shard_spec=jsa.ShardSpec(num_shards=S, mode="virtual"))
    for g, w in zip(jtree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == tuple(w.shape) and str(g.dtype)[6:] == str(w.dtype)
        if dt == "float32":
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL,
                                       atol=ATOL)
        else:
            err = np.max(np.abs(_f32(g) - _f32(w)), initial=0.0)
            assert err <= BF16_STEPS * np.max(np.abs(_f32(w))), err


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["int8_stochastic", "sign"])
def test_wire_payloads_bit_equal_in_virtual_mode(codec, dt):
    stacked = _np_stacked()
    tk = prng.fold_in(prng.PRNGKey(SEED), 29)
    jk = jax.random.fold_in(jax.random.PRNGKey(SEED), 29)
    got = compression.get_codec(codec).encode(
        torch_shard_ranks.stacked_tensors(
            {"stacked": stacked, "dtype": dt}),
        key=tk, shard_spec=sa.ShardSpec(num_shards=S, mode="virtual"))
    want = jc.get_codec(codec).encode(
        _j(stacked, getattr(jnp, dt)), key=jk,
        shard_spec=jsa.ShardSpec(num_shards=S, mode="virtual"))
    for g, w in zip(jtree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_virtual_scales_equal_unsharded_and_q_within_a_step():
    stacked = torch_shard_ranks.stacked_tensors(
        {"stacked": _np_stacked(), "dtype": "float32"})
    codec = compression.get_codec("int8_stochastic")
    key = prng.PRNGKey(SEED)
    plain = codec.encode(stacked, key=key)
    virt = codec.encode(stacked, key=key,
                        shard_spec=sa.ShardSpec(num_shards=S, mode="virtual"))
    for a, b in zip(jtree.leaves(plain["scale"]),
                    jtree.leaves(virt["scale"])):
        assert torch.equal(a, b)
    for a, b in zip(jtree.leaves(plain["q"]), jtree.leaves(virt["q"])):
        assert int((a.int() - b.int()).abs().max()) <= 1


@pytest.mark.parametrize("mode", [None, "gspmd", "virtual"])
def test_blocked_partial_sum_matches_reference(mode):
    stacked = _np_stacked(width=S * 32)
    leaves_t = jtree.leaves(torch_shard_ranks.stacked_tensors(
        {"stacked": stacked, "dtype": "float32"}))
    leaves_j = jax.tree.leaves(_j(stacked, jnp.float32))
    tspec = None if mode is None else sa.ShardSpec(num_shards=S, mode=mode)
    jspec = None if mode is None else jsa.ShardSpec(num_shards=S, mode=mode)
    got = sa.blocked_partial_sum(
        tspec, leaves_t, lambda x: torch.sum(
            (x * x).reshape(M, -1), dim=1), shape=(M,))
    want = jsa.blocked_partial_sum(
        jspec, leaves_j, lambda x: jnp.sum(
            x * x, axis=tuple(range(1, x.ndim))), shape=(M,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_shard_slice_and_spec_match_reference():
    x = np.arange(2 * 3 * 16, dtype=np.float32).reshape(2, 3, 16)
    for i in range(4):
        got = sa.shard_slice(torch.as_tensor(x), i, 4)
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsa.shard_slice(jnp.asarray(x), i, 4)))
    with pytest.raises(ValueError, match="does not divide"):
        sa.shard_slice(torch.as_tensor(x), 0, 3)
    for n, mode in itertools.product((1, 2), ("gspmd", "shard_map",
                                              "virtual")):
        t, j = sa.ShardSpec(n, mode), jsa.ShardSpec(n, mode)
        assert (t.partitioned, t.blocked) == (j.partitioned, j.blocked)
    for bad in (dict(mode="mesh"), dict(num_shards=0)):
        with pytest.raises(ValueError):
            sa.ShardSpec(**bad)
    with pytest.raises(ValueError, match="divide into num_shards"):
        sa.blocked_partial_sum(sa.ShardSpec(3, "virtual"),
                               [torch.ones(2, 4)], torch.sum)


def test_round_backend_dispatch_with_shard_specs():
    resolve = aggregators.resolve_round_backend
    cpu = torch.device("cpu")
    assert resolve("auto", num_batches=4, device=cpu,
                   target_backend="cuda") == "fused"
    assert resolve("auto", num_batches=4, device=cpu,
                   target_backend="cuda", partitioned=True) == "reference"
    assert resolve("auto", num_batches=4, device="cuda",
                   target_backend="cpu") == "reference"
    for backend in ("fused", "fused_interpret"):
        with pytest.raises(ValueError, match="partitioned"):
            resolve(backend, num_batches=4, device=cpu, partitioned=True)
    spec = sa.ShardSpec(num_shards=2, mode="gspmd")
    s = {"w": torch.ones(4, 6)}
    got = aggregators.gmom_aggregator(s, num_batches=2, shard_spec=spec)
    assert torch.equal(got["w"], torch.ones(6))
    with pytest.raises(ValueError, match="partitioned"):
        aggregators.gmom_aggregator(s, num_batches=2, shard_spec=spec,
                                    round_backend="fused_interpret")


# ---------------------------------------------------------------------------
# the paper's theory module and config

def test_theory_matches_reference():
    for L, Mg in [(1.0, 1.0), (0.5, 2.0), (0.9, 1.3)]:
        t = theory.ProblemConstants(L, Mg)
        j = jtheory.ProblemConstants(L, Mg)
        assert (t.step_size, t.population_contraction,
                t.theorem1_contraction) == (
            j.step_size, j.population_contraction, j.theorem1_contraction)
        for xi2 in (0.0, 0.1, 0.3):
            assert t.rho(xi2) == j.rho(xi2)
    assert dataclasses.asdict(theory.LINEAR_REGRESSION) == \
        dataclasses.asdict(jtheory.LINEAR_REGRESSION)
    for alpha in (0.0, 0.1, 0.3, 0.49):
        assert theory.c_alpha(alpha) == jtheory.c_alpha(alpha)
        assert theory.error_floor(100, 50_000, 10, alpha=alpha) == \
            jtheory.error_floor(100, 50_000, 10, alpha=alpha)
    with pytest.raises(ValueError):
        theory.c_alpha(0.5)
    for m, k, q in itertools.product((10, 50), (4, 10, 11), (0, 1, 4)):
        assert theory.tolerance_ok(m, k, q) == jtheory.tolerance_ok(m, k, q)
        for alpha, delta in ((0.3, 0.05), (0.45, 0.1)):
            assert theory.success_probability_lower_bound(
                k, q, alpha, delta) == \
                jtheory.success_probability_lower_bound(k, q, alpha, delta)
    for p, q in ((0.0, 0.3), (1.0, 0.3), (0.2, 0.4)):
        assert theory.binary_divergence(p, q) == \
            jtheory.binary_divergence(p, q)


def test_linreg_paper_config_matches_reference():
    assert dataclasses.asdict(linreg_paper.CONFIG) == \
        dataclasses.asdict(jlinreg_paper.CONFIG)
