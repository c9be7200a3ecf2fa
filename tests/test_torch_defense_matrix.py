"""The port's defense matrix: every aggregation rule and attack of the
port held against the JAX package's on the same numpy inputs, and the
reference's envelopes (tests/test_defense_matrix.py) re-asserted on the
port's own outputs.

Parity: rtol 1e-4, atol 1e-5 (the reductions run in other orders; the
attacks that draw normals go through ``torch.erfinv``), while order
statistics (the coordinate medians) and selections (krum's winner, the
selection masks) must be equal exactly.

Envelopes, as in the reference: every ROBUST rule stays within 0.75 of the
honest mean under every attack; ``mean`` is dragged past 5; the
KNOWN-UNSOUND rules escape the envelope under the small-norm attacks; the
vote is correct under the attack suite and breaks at q* = 4 of m = 12
under ``sign_flip_targeted``; under ``byzantine_max_stale`` gmom holds
through τ = 2 and breaks at τ* = 3, geomed a notch earlier at τ = 2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro.core import aggregate as jaggregate
from repro.core import aggregators as jagg
from repro.core import byzantine as jbyz
from repro.core import robust_train as jrt
from repro.core import shard_aggregation as jsa
from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.core import aggregate, aggregate_reported, aggregators
from repro_torch.core import byzantine, staleness
from repro_torch.core.robust_train import RobustConfig
from repro_torch.core.shard_aggregation import ShardSpec

M, Q, K, LOC = 12, 2, 6, 1.0
RTOL, ATOL = 1e-4, 1e-5

SOUND_COMBINED = ("coord_median", "coord_trimmed_mean", "norm_filter_gmom")
ROBUST = ("gmom", "gmom_per_leaf", "geomed", "coordinate_median",
          "trimmed_mean", "krum", "int8_gmom") + SOUND_COMBINED
KNOWN_UNSOUND = ("norm_select", "norm_clip_mean")
SMALL_NORM_ATTACKS = ("alie", "norm_stealth", "inner_product")
SIGN_VOTE_ATTACKS = ("sign_flip", "sign_flip_targeted", "alie",
                     "norm_stealth")

NEW_RULES = ("geomed", "coordinate_median", "krum", "norm_clip_mean",
             "random_select", "norm_select", "coord_median",
             "coord_trimmed_mean", "norm_filter_gmom", "gmom_per_leaf",
             "sign_sgd_majority", "int8_gmom")
NEW_ATTACKS = ("zero", "random_noise", "mean_shift", "colluding_mimic",
               "anti_aggregation", "label_flip", "sign_flip_targeted")
EXACT_RULES = ("coordinate_median", "coord_median", "sign_sgd_majority",
               "krum")


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _np_stacked(m=M, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(m, 5)) * 0.05 + LOC).astype(np.float32),
            "b": {"x": (rng.normal(size=(m, 2, 3)) * 0.05
                        + LOC).astype(np.float32)}}


def _t(tree):
    return tree_map(torch.as_tensor, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tkey(seed):
    return prng.PRNGKey(seed)


def _cfg(aggregator, attack, cls=RobustConfig, **kw):
    return cls(num_workers=M, num_byzantine=Q, num_batches=K,
               aggregator=aggregator, attack=attack, gmom_max_iters=20,
               gmom_tol=1e-6, **kw)


def _dist(out, honest_mean):
    return float(torch.sqrt(sum(
        torch.sum(torch.square(a.float() - b.float()))
        for a, b in zip(jtree.leaves(out), jtree.leaves(honest_mean)))))


def _close(got, want, exact=False):
    for g, w in zip(jtree.leaves(got), jax.tree.leaves(want)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# parity with the JAX package

def test_registries_equal_the_references():
    assert aggregators.available() == jagg.available()
    assert byzantine.available() == jbyz.available()
    assert len(aggregators.available()) == 15
    assert len(byzantine.available()) == 12


@pytest.mark.parametrize("attack", ["sign_flip", "alie", "norm_stealth"])
@pytest.mark.parametrize("rule", NEW_RULES)
def test_new_rules_match_jax(rule, attack):
    s = _np_stacked(seed=3)
    cfg = dict(aggregator=rule, attack=attack)
    want = jaggregate(_j(s), _cfg(cls=jrt.RobustConfig, **cfg),
                      key=jax.random.PRNGKey(1), round_index=2)
    got = aggregate(_t(s), _cfg(**cfg), key=_tkey(1), round_index=2)
    # sign_flip's reports (-10 g) are exact in both, so an order statistic
    # or a selection of them is too; the other attacks' means differ by ulps
    _close(got, want, exact=rule in EXACT_RULES and attack == "sign_flip")


def test_krum_selects_the_same_worker_as_jax():
    s = _np_stacked(seed=5)
    for q in (0, 1, 3):
        want = jagg.krum_aggregator(_j(s), num_byzantine=q)
        got = aggregators.krum_aggregator(_t(s), num_byzantine=q)
        row = [i for i in range(M) if np.array_equal(s["w"][i],
                                                     got["w"].numpy())]
        assert len(row) == 1
        _close(got, want, exact=True)
    with pytest.raises(ValueError, match="m > q \\+ 2"):
        aggregators.krum_aggregator(_t(s), num_byzantine=M - 2)


@pytest.mark.parametrize("m", [5, 6, 11, 12])
def test_coordinate_medians_are_jnp_median(m):
    """Order statistics equal exactly, at odd and even length (the mean of
    the two middle values, as jnp.median)."""
    s = _np_stacked(m=m, seed=m)
    _close(aggregators.coordinate_median_aggregator(_t(s)),
           jagg.coordinate_median_aggregator(_j(s)), exact=True)
    k = 3 if m % 3 == 0 else 5 if m % 5 == 0 else m
    _close(aggregators.coord_median_aggregator(_t(s), num_batches=k,
                                               num_byzantine=1),
           jagg.coord_median_aggregator(_j(s), num_batches=k,
                                        num_byzantine=1))


def test_selection_masks_equal_jax():
    """random_select's subset (keyed uniforms, stable ranks) and
    norm_select's bottom-k: the selected rows are the reference's."""
    s = _np_stacked(seed=9)
    for seed in range(5):
        np.testing.assert_array_equal(
            aggregators.bottom_k_mask(prng.uniform(_tkey(seed), (M,)),
                                      M // 2).numpy(),
            np.asarray(jagg.bottom_k_mask(
                jax.random.uniform(jax.random.PRNGKey(seed), (M,)), M // 2)))
        want = jagg.random_select_aggregator(_j(s),
                                             key=jax.random.PRNGKey(seed))
        got = aggregators.random_select_aggregator(_t(s), key=_tkey(seed))
        _close(got, want)
    norms = np.sqrt((s["w"] ** 2).sum(1) + (s["b"]["x"] ** 2).sum((1, 2)))
    np.testing.assert_array_equal(
        aggregators.bottom_k_mask(torch.as_tensor(norms), M - 3).numpy(),
        np.asarray(jagg.bottom_k_mask(jnp.asarray(norms), M - 3)))
    _close(aggregators.norm_select_aggregator(_t(s), num_byzantine=3),
           jagg.norm_select_aggregator(_j(s), num_byzantine=3))
    with pytest.raises(ValueError, match="PRNG key"):
        aggregators.random_select_aggregator(_t(s))


@pytest.mark.parametrize("rule", ["coord_median", "coord_trimmed_mean"])
def test_out_of_guarantee_configurations_raise(rule):
    s = _t(_np_stacked())
    with pytest.raises(ValueError, match="2"):
        aggregators.get_aggregator(rule)(s, num_batches=4, num_byzantine=2)


@pytest.mark.parametrize("rule", ["geomed", "krum", "norm_clip_mean",
                                  "norm_select", "norm_filter_gmom",
                                  "gmom_per_leaf", "int8_gmom"])
def test_shard_spec_is_item_13(rule):
    """Every rule that takes a ``shard_spec`` (shard-local aggregation)
    runs in virtual mode: equal to the reference's virtual mode (krum's
    selection exactly), and to its own unsharded path within f32
    rounding."""
    rng = np.random.default_rng(5)
    s = {"w": (rng.normal(size=(M, 6)) * 0.05 + LOC).astype(np.float32),
         "b": {"x": (rng.normal(size=(M, 2, 4)) * 0.05
                     + LOC).astype(np.float32)}}
    kw = dict(num_batches=K, num_byzantine=Q)
    got = aggregators.get_aggregator(rule)(
        _t(s), shard_spec=ShardSpec(num_shards=2, mode="virtual"), **kw)
    want = jagg.get_aggregator(rule)(
        _j(s), shard_spec=jsa.ShardSpec(num_shards=2, mode="virtual"), **kw)
    _close(got, want, exact=rule == "krum")
    plain = aggregators.get_aggregator(rule)(_t(s), **kw)
    for g, p in zip(jtree.leaves(got), jtree.leaves(plain)):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("q", [1, 3, 5])
@pytest.mark.parametrize("attack", NEW_ATTACKS)
def test_new_attacks_match_jax(attack, q):
    s = _np_stacked(seed=q)
    mask = np.zeros(M, bool)
    mask[np.random.default_rng(q).permutation(M)[:q]] = True
    want = jbyz.get_attack(attack)(_j(s), jnp.asarray(mask),
                                   jax.random.PRNGKey(q))
    got = byzantine.get_attack(attack)(_t(s), torch.as_tensor(mask),
                                       _tkey(q))
    _close(got, want)
    for g, h in zip(jtree.leaves(got), jax.tree.leaves(s)):
        np.testing.assert_array_equal(g.numpy()[~mask], h[~mask])


def test_random_attacks_draw_per_leaf_in_jax_order():
    """A tree inserted out of sorted order: leaf i still draws split key i
    of JAX's sorted order."""
    rng = np.random.default_rng(0)
    s = {"z": rng.normal(size=(M, 4)).astype(np.float32),
         "a": rng.normal(size=(M, 3)).astype(np.float32)}
    mask = np.arange(M) < 3
    for attack in ("random_noise", "colluding_mimic"):
        want = jbyz.get_attack(attack)(_j(s), jnp.asarray(mask),
                                       jax.random.PRNGKey(4))
        got = byzantine.get_attack(attack)(_t(s), torch.as_tensor(mask),
                                           _tkey(4))
        assert list(got) == ["z", "a"]
        _close(got, want)


@pytest.mark.parametrize("rule", NEW_RULES)
def test_registry_metadata_carried_over(rule):
    j, t = jagg.get_aggregator(rule), aggregators.get_aggregator(rule)
    for field in ("description", "needs_num_byzantine", "needs_key",
                  "needs_grouping", "needs_shard_spec", "shard_contract",
                  "native_codec", "sanitization_point"):
        assert getattr(t, field) == getattr(j, field), field


# ---------------------------------------------------------------------------
# the reference's envelopes, on the port's outputs

@pytest.mark.parametrize("attack", byzantine.available())
@pytest.mark.parametrize("aggregator", aggregators.available())
def test_shapes_dtypes_preserved(aggregator, attack):
    s = _t(_np_stacked())
    out = aggregate(s, _cfg(aggregator, attack), key=_tkey(0), round_index=0)
    assert list(out) == list(s) and list(out["b"]) == ["x"]
    for o, i in zip(jtree.leaves(out), jtree.leaves(s)):
        assert o.shape == i.shape[1:] and o.dtype == i.dtype
        assert bool(torch.all(torch.isfinite(o)))


@pytest.mark.parametrize("attack", byzantine.available())
@pytest.mark.parametrize("aggregator", ROBUST)
def test_robust_aggregators_stay_bounded(aggregator, attack):
    s = _t(_np_stacked())
    honest = aggregators.mean_aggregator(s)
    out = aggregate(s, _cfg(aggregator, attack), key=_tkey(1), round_index=0)
    assert _dist(out, honest) < 0.75


@pytest.mark.parametrize("attack", ["sign_flip", "mean_shift",
                                    "random_noise"])
def test_mean_breaks(attack):
    s = _t(_np_stacked())
    out = aggregate(s, _cfg("mean", attack), key=_tkey(2), round_index=0)
    assert _dist(out, aggregators.mean_aggregator(s)) > 5.0


@pytest.mark.parametrize("schedule", ["static", "rotating"])
@pytest.mark.parametrize("attack", SMALL_NORM_ATTACKS)
@pytest.mark.parametrize("aggregator", SOUND_COMBINED)
def test_selection_rules_bounded_under_small_norm_attacks(aggregator,
                                                          attack, schedule):
    s = _t(_np_stacked())
    honest = aggregators.mean_aggregator(s)
    cfg = dataclasses.replace(_cfg(aggregator, attack),
                              rotate_byzantine=(schedule == "rotating"))
    for round_index in range(3):
        out = aggregate(s, cfg, key=_tkey(1), round_index=round_index)
        assert _dist(out, honest) < 0.75


@pytest.mark.parametrize("aggregator", KNOWN_UNSOUND)
def test_legacy_selection_rules_stay_unsound(aggregator):
    assert aggregator not in ROBUST
    agg = aggregators.get_aggregator(aggregator)
    assert "known-unsound" in (agg.fn.__doc__ or "").lower()
    assert "KNOWN-UNSOUND" in agg.description
    s = _t(_np_stacked())
    honest = aggregators.mean_aggregator(s)
    worst = max(_dist(aggregate(s, _cfg(aggregator, attack), key=_tkey(1),
                                round_index=0), honest)
                for attack in SMALL_NORM_ATTACKS)
    assert worst > 0.75


def _assert_all_plus_one(out):
    for leaf in jtree.leaves(out):
        assert bool(torch.all(leaf == 1.0)), leaf


@pytest.mark.parametrize("schedule", ["static", "rotating"])
@pytest.mark.parametrize("attack", SIGN_VOTE_ATTACKS)
def test_sign_majority_vote_correct_under_attack(attack, schedule):
    s = _t(_np_stacked())
    for compression in ("none", "sign"):
        cfg = dataclasses.replace(_cfg("sign_sgd_majority", attack),
                                  rotate_byzantine=(schedule == "rotating"),
                                  compression=compression)
        for round_index in range(3):
            _assert_all_plus_one(aggregate(s, cfg, key=_tkey(1),
                                           round_index=round_index))


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
def test_sign_majority_tolerates_up_to_half_sign_flippers(q):
    s = _t(_np_stacked())
    reported = byzantine.get_attack("sign_flip")(
        s, torch.arange(M) < q, _tkey(5))
    _assert_all_plus_one(aggregators.sign_sgd_majority_aggregator(reported))


def test_sign_flip_targeted_break_point_pinned():
    """9 positive / 3 negative votes on a thin coordinate at m = 12: the
    targeted adversary flips it exactly from q* = 4; the thick coordinate
    (12 positive) holds at every q."""
    thin = [1.0] * 9 + [-1.0] * 3
    s = {"w": torch.tensor(np.stack([thin, [1.0] * M], axis=1),
                           dtype=torch.float32)}
    attack = byzantine.get_attack("sign_flip_targeted")
    for q in range(1, 6):
        reported = attack(s, torch.arange(M) < q, _tkey(6))
        for wire in ("none", "sign"):
            cfg = RobustConfig(num_workers=M, num_byzantine=q,
                               aggregator="sign_sgd_majority",
                               compression=wire)
            vote = aggregate_reported(reported, cfg, key=_tkey(6))["w"]
            assert float(vote[0]) == (-1.0 if q >= 4 else 1.0), (q, wire)
            assert float(vote[1]) == 1.0


def test_sign_flip_targeted_hides_in_honest_norm_envelope():
    s = _t(_np_stacked())
    mask = torch.arange(M) < Q
    rep_t = byzantine.get_attack("sign_flip_targeted")(s, mask, _tkey(7))
    rep_f = byzantine.get_attack("sign_flip")(s, mask, _tkey(7))

    def row_norm(tree, i):
        return float(torch.sqrt(sum(torch.sum(torch.square(leaf[i]))
                                    for leaf in jtree.leaves(tree))))

    honest = float(np.mean([row_norm(s, i) for i in range(Q, M)]))
    assert abs(row_norm(rep_t, 0) - honest) < 0.25 * honest
    assert row_norm(rep_f, 0) > 5.0 * honest


def test_int8_gmom_bounded_on_quantized_wire():
    s = _t(_np_stacked())
    cfg = dataclasses.replace(_cfg("int8_gmom", "sign_flip"),
                              compression="int8_stochastic")
    out = aggregate(s, cfg, key=_tkey(1), round_index=0)
    assert _dist(out, aggregators.mean_aggregator(s)) < 0.75


# ---------------------------------------------------------------------------
# the timing adversary: byzantine_max_stale over the real multi-round merge

def _stale_campaign_worst_dist(aggregator, tau, *, attack="sign_flip",
                               rounds=8):
    """Worst steady-state distance from the honest mean over a
    byzantine_max_stale campaign (the first tau + 1 rounds excluded), the
    reference's campaign step for step."""
    cfg = dataclasses.replace(
        _cfg(aggregator, attack), arrival="byzantine_max_stale",
        staleness_bound=tau, staleness_discount=0.7)
    arr = staleness.arrival_from_config(cfg)
    buf = staleness.init_buffer(tree_map(lambda x: x[0],
                                         _t(_np_stacked(seed=0))), M, tau)
    atk = byzantine.get_attack(attack)
    worst = 0.0
    for t in range(tau + 1 + rounds):
        key = _tkey(100 + t)
        s = _t(_np_stacked(seed=t))
        mask = byzantine.sample_byzantine_mask(key, M, Q, rotate=False,
                                               round_index=t)
        merged, buf = staleness.merge_reports(buf, atk(s, mask, key),
                                              arr.arrive(key, t, mask))
        out = aggregate_reported(
            merged, cfg, key=key,
            staleness=(buf.age, buf.bound, cfg.staleness_discount))
        if t > tau:
            worst = max(worst, _dist(out, aggregators.mean_aggregator(s)))
    return worst


@pytest.mark.parametrize("tau", [0, 1])
@pytest.mark.parametrize("aggregator", ROBUST)
def test_robust_aggregators_bounded_under_byzantine_max_stale(aggregator,
                                                              tau):
    assert _stale_campaign_worst_dist(aggregator, tau) < 0.75


def test_byzantine_max_stale_break_point_pinned():
    """gmom holds through τ = 2 and breaks at τ* = 3; geomed (k = m, no
    batch-mean dilution) breaks a notch earlier, at τ = 2."""
    assert _stale_campaign_worst_dist("gmom", 2) < 0.75
    assert _stale_campaign_worst_dist("gmom", 3) > 1.0
    assert _stale_campaign_worst_dist("geomed", 2) > 0.75


@pytest.mark.parametrize("tau", [1, 2, 3])
@pytest.mark.parametrize("aggregator", ["gmom", "geomed"])
def test_stale_campaign_matches_jax(aggregator, tau):
    """The campaign's merged, weighted and aggregated rounds follow the
    reference's within tolerance, round by round."""
    from repro.core import staleness as jst
    jcfg = dataclasses.replace(
        _cfg(aggregator, "sign_flip", cls=jrt.RobustConfig),
        arrival="byzantine_max_stale", staleness_bound=tau)
    tcfg = dataclasses.replace(
        _cfg(aggregator, "sign_flip"), arrival="byzantine_max_stale",
        staleness_bound=tau)
    ja, ta = jst.arrival_from_config(jcfg), staleness.arrival_from_config(tcfg)
    p0 = _np_stacked(seed=0)
    jbuf = jst.init_buffer(jax.tree.map(lambda x: jnp.asarray(x[0]), p0),
                           M, tau)
    tbuf = staleness.init_buffer(tree_map(lambda x: torch.as_tensor(x[0]),
                                          p0), M, tau)
    for t in range(tau + 4):
        jk, tk = jax.random.PRNGKey(100 + t), _tkey(100 + t)
        s = _np_stacked(seed=t)
        jmask = jbyz.sample_byzantine_mask(jk, M, Q, rotate=False,
                                           round_index=t)
        tmask = byzantine.sample_byzantine_mask(tk, M, Q, rotate=False,
                                                round_index=t)
        jrep = jbyz.get_attack("sign_flip")(_j(s), jmask, jk)
        trep = byzantine.get_attack("sign_flip")(_t(s), tmask, tk)
        jm, jbuf = jst.merge_reports(jbuf, jrep, ja.arrive(jk, t, jmask))
        tm, tbuf = staleness.merge_reports(tbuf, trep,
                                           ta.arrive(tk, t, tmask))
        np.testing.assert_array_equal(tbuf.age.numpy(), np.asarray(jbuf.age))
        want = jrt.aggregate_reported(jm, jcfg, key=jk, staleness=(
            jbuf.age, jbuf.bound, 0.7))
        got = aggregate_reported(tm, tcfg, key=tk, staleness=(
            tbuf.age, tbuf.bound, 0.7))
        _close(got, want)
