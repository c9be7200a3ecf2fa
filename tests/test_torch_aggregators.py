"""The port's aggregation rules (repro_torch.core.aggregators and
geometric_median) against the JAX package's, on the same numpy inputs.

Tolerances: the reductions run in other orders (rtol 1e-4, atol 1e-5);
order statistics, masks and trim weights must be equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro_torch.core import aggregators as tagg

# the packages re-export the function geometric_median under the module's
# own name, so import the modules by path
jgm = importlib.import_module("repro.core.geometric_median")
tgm = importlib.import_module("repro_torch.core.geometric_median")

RTOL, ATOL = 1e-4, 1e-5
PORTED = ("gmom", "mean", "trimmed_mean")


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _grads(m, d, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, d)).astype(np.float32)
    g[: max(1, m // 10)] *= -10.0        # a few sign-flipped rows
    return g


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", PORTED)
def test_registry_metadata_carried_over(name):
    j, t = jagg.get_aggregator(name), tagg.get_aggregator(name)
    for field in ("description", "needs_num_byzantine", "needs_key",
                  "needs_grouping", "needs_shard_spec", "shard_contract",
                  "native_codec", "sanitization_point"):
        assert getattr(t, field) == getattr(j, field), field


def test_unported_rule_names_its_queue_item():
    """Every rule of the reference is ported now: an unknown name raises
    and lists the fifteen registered ones, and names no queue item."""
    assert tagg.available() == jagg.available()
    with pytest.raises(KeyError, match="unknown aggregator") as err:
        tagg.get_aggregator("bulyan")
    assert "krum" in str(err.value) and "item" not in str(err.value)


@pytest.mark.parametrize("m,d", [(20, 20), (7, 5), (50, 100)])
def test_mean_matches_jax(m, d):
    g = _grads(m, d, seed=m)
    _close(tagg.mean_aggregator(torch.as_tensor(g)),
           jagg.mean_aggregator(jnp.asarray(g)))


@pytest.mark.parametrize("q", [None, 0, 3, 30])
def test_trimmed_mean_matches_jax(q):
    g = _grads(20, 13, seed=3)
    _close(tagg.trimmed_mean_aggregator(torch.as_tensor(g), num_byzantine=q),
           jagg.trimmed_mean_aggregator(jnp.asarray(g), num_byzantine=q))


@pytest.mark.parametrize("trim", [None, 3.0])
@pytest.mark.parametrize("scheme", ["contiguous", "strided", "seeded"])
@pytest.mark.parametrize("m,k,d", [(20, 10, 20), (50, 11, 31), (12, 4, 9),
                                   (6, 6, 5)])
def test_gmom_reference_matches_jax(m, k, d, scheme, trim):
    g = _grads(m, d, seed=m * k)
    kw = dict(num_batches=k, grouping_scheme=scheme, trim_multiplier=trim,
              max_iters=32, tol=1e-7)
    _close(tagg.gmom_aggregator(torch.as_tensor(g), round_backend="reference",
                                **kw),
           jagg.gmom_aggregator(jnp.asarray(g), round_backend="reference",
                                **kw))


def test_gmom_fused_interpret_matches_reference_path():
    g = torch.as_tensor(_grads(50, 40, seed=9))
    kw = dict(num_batches=11, max_iters=64, tol=1e-8)
    _close(tagg.gmom_aggregator(g, round_backend="fused_interpret", **kw),
           tagg.gmom_aggregator(g, round_backend="reference", **kw))


def test_gmom_single_batch_is_the_mean():
    g = torch.as_tensor(_grads(8, 6, seed=1))
    assert torch.equal(tagg.gmom_aggregator(g, num_batches=1),
                       tagg.mean_aggregator(g))


@pytest.mark.parametrize("scheme", ["contiguous", "strided", "seeded"])
@pytest.mark.parametrize("m,k", [(20, 10), (50, 11), (12, 12)])
def test_batch_means_matches_jax(m, k, scheme):
    rng = np.random.default_rng(m + k)
    tree = {"w": rng.normal(size=(m, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(m,)).astype(np.float32)}
    got = tagg.batch_means({n: torch.as_tensor(v) for n, v in tree.items()},
                           k, scheme=scheme)
    want = jagg.batch_means({n: jnp.asarray(v) for n, v in tree.items()},
                            k, scheme=scheme)
    for n in tree:
        _close(got[n], want[n])


def test_bottom_k_mask_ties_and_tensor_k():
    scores = np.array([0.5, 0.1, 0.5, 0.1, 0.9, 0.5], np.float32)
    for k in range(7):
        want = np.asarray(jagg.bottom_k_mask(jnp.asarray(scores), k))
        got = tagg.bottom_k_mask(torch.as_tensor(scores), k).numpy()
        np.testing.assert_array_equal(got, want)
        got_t = tagg.bottom_k_mask(torch.as_tensor(scores),
                                   torch.tensor(k, dtype=torch.int32))
        np.testing.assert_array_equal(got_t.numpy(), want)
        assert got.sum() == k


@pytest.mark.parametrize("n", [4, 5, 10, 11, 20])
def test_median_and_trim_weights_even_and_odd(n):
    rng = np.random.default_rng(n)
    norms = np.abs(rng.normal(size=n)).astype(np.float32)
    norms[0] = 40.0
    assert float(tgm.median(torch.as_tensor(norms))) == \
        float(jnp.median(jnp.asarray(norms)))
    for mult in (1.0, 3.0):
        np.testing.assert_array_equal(
            tgm.trim_weights(torch.as_tensor(norms), multiplier=mult).numpy(),
            np.asarray(jgm.trim_weights(jnp.asarray(norms), multiplier=mult)))


def test_median_nan_propagates():
    assert torch.isnan(tgm.median(torch.tensor([1.0, float("nan"), 2.0])))


@pytest.mark.parametrize("weighted", [False, True])
def test_geometric_median_pytree_matches_jax(weighted):
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(10, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(10, 5)).astype(np.float32) + 2.0}
    w = (rng.uniform(size=10) > 0.3).astype(np.float32) if weighted else None
    got = tgm.geometric_median_pytree(
        {n: torch.as_tensor(v) for n, v in tree.items()},
        weights=None if w is None else torch.as_tensor(w), max_iters=32)
    want = jgm.geometric_median_pytree(
        {n: jnp.asarray(v) for n, v in tree.items()},
        weights=None if w is None else jnp.asarray(w), max_iters=32)
    for n in tree:
        _close(got[n], want[n])


def test_geometric_median_norm_rule_matches_jax():
    pts = _grads(15, 6, seed=8)
    for tol in (1e-8, 1e-2):
        _close(tgm.geometric_median(torch.as_tensor(pts), tol=tol),
               jgm.geometric_median(jnp.asarray(pts), tol=tol))


def test_weiszfeld_step_and_batch_mean_norms_match_jax():
    pts = _grads(9, 7, seed=2)
    y = pts.mean(0)
    w = np.linspace(0.5, 1.5, 9).astype(np.float32)
    _close(tgm.weiszfeld_step(torch.as_tensor(pts), torch.as_tensor(y),
                              torch.as_tensor(w), 1e-12),
           jgm.weiszfeld_step(jnp.asarray(pts), jnp.asarray(y),
                              jnp.asarray(w), 1e-12))
    tree = {"x": pts, "s": pts[:, 0]}
    _close(tgm.batch_mean_norms({n: torch.as_tensor(v)
                                 for n, v in tree.items()}),
           jgm.batch_mean_norms({n: jnp.asarray(v) for n, v in tree.items()}))
