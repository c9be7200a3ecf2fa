"""The port's bounded-staleness layer (repro_torch.core.staleness) against
the JAX package's, on the same numpy inputs.

Merged rows, ages and every arrival's fresh mask must be equal exactly;
the weights ``discount**age`` go through ``torch.pow`` against XLA's power
(rtol 1e-6); the all-fresh scaling is a bit-exact identity and dropped
rows are exactly zero.  A checkpoint the JAX package wrote mid-run with a
non-empty buffer is resumed by the port on the golden trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import staleness as jst
from repro.sim import engine as jengine
from repro_torch import convert, optim
from repro_torch import random as prng
from repro_torch.core import RobustConfig, make_run_rounds
from repro_torch.core import staleness as tst
from repro_torch.core.train_state import advance, init_train_state
from repro_torch.data import regression
from repro_torch.sim import engine, goldens, scenarios

STALE = "linreg/gmom/sign_flip/rotating/stale"


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _case(seed):
    """(m, bound, ages, buffered rows, reported rows, fresh) as numpy."""
    rng = np.random.default_rng(seed)
    m, d, bound = int(rng.integers(2, 9)), int(rng.integers(1, 13)), \
        int(rng.integers(0, 5))
    tree = lambda: {"w": rng.normal(size=(m, d)).astype(np.float32),  # noqa
                    "b": {"x": rng.normal(size=(m, 3)).astype(np.float32)}}
    age = rng.integers(0, bound + 3, size=(m,)).astype(np.int32)
    return m, bound, age, tree(), tree(), rng.random(m) < 0.5


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


@pytest.mark.parametrize("seed", range(6))
def test_merge_and_ages_exact(seed):
    m, bound, age, old, rep, fresh = _case(seed)
    jbuf = jst.StalenessBuffer(_j(old), jnp.asarray(age), jnp.int32(bound))
    tbuf = tst.StalenessBuffer(_t(old), torch.as_tensor(age),
                               torch.tensor(bound, dtype=torch.int32))
    jm, jnew = jst.merge_reports(jbuf, _j(rep), jnp.asarray(fresh))
    tm, tnew = tst.merge_reports(tbuf, _t(rep), torch.as_tensor(fresh))
    for path in (("w",), ("b", "x")):
        want, got = jm, tm
        for p in path:
            want, got = want[p], got[p]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tnew.age.numpy(), np.asarray(jnew.age))
    assert tnew.age.dtype == torch.int32 and int(tnew.bound) == bound
    assert tm["w"] is tnew.grads["w"]      # the buffer stores the raw union


@pytest.mark.parametrize("discount", [0.7, 0.5, 0.93])
@pytest.mark.parametrize("seed", range(4))
def test_weights_within_rtol(seed, discount):
    _, bound, age, _, _, _ = _case(seed)
    want = np.asarray(jst.staleness_weights(jnp.asarray(age),
                                            jnp.int32(bound),
                                            discount=discount))
    got = tst.staleness_weights(torch.as_tensor(age),
                                torch.tensor(bound, dtype=torch.int32),
                                discount=discount).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[age == 0] == 1.0) and np.all(got[age > bound] == 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_apply_staleness_matches_jax(seed):
    _, bound, age, _, rep, _ = _case(seed)
    want = jst.apply_staleness(_j(rep), jnp.asarray(age), jnp.int32(bound),
                               discount=0.7)
    got = tst.apply_staleness(_t(rep), torch.as_tensor(age),
                              torch.tensor(bound, dtype=torch.int32),
                              discount=0.7)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["b"]["x"].numpy(),
                               np.asarray(want["b"]["x"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("seed", range(4))
def test_all_fresh_identity_bit_exact(seed):
    m, bound, _, _, rep, _ = _case(seed)
    got = tst.apply_staleness(_t(rep), torch.zeros(m, dtype=torch.int32),
                              torch.tensor(bound, dtype=torch.int32),
                              discount=0.7)
    assert torch.equal(got["w"], torch.as_tensor(rep["w"]))
    assert torch.equal(got["b"]["x"], torch.as_tensor(rep["b"]["x"]))


def test_dropped_rows_exactly_zero():
    rows = torch.as_tensor(np.random.default_rng(0).normal(
        size=(5, 4)).astype(np.float32))
    age = torch.tensor([0, 1, 3, 2, 7], dtype=torch.int32)
    out = tst.apply_staleness(rows, age, torch.tensor(2, dtype=torch.int32),
                              discount=0.7)
    assert torch.all(out[2] == 0.0) and torch.all(out[4] == 0.0)
    assert torch.all(out[[0, 1, 3]] != 0.0)


def test_init_buffer_matches_jax():
    params = {"w": np.zeros((3,), np.float32), "v": np.zeros((2, 2),
                                                               np.float32)}
    jb = jst.init_buffer(_j(params), 4, 2)
    tb = tst.init_buffer(_t(params), 4, 2)
    np.testing.assert_array_equal(tb.age.numpy(), np.asarray(jb.age))
    assert tb.age.dtype == torch.int32 and tb.bound.dtype == torch.int32
    assert tb.grads["v"].shape == (4, 2, 2)
    assert not torch.any(tb.grads["w"])


def test_arrival_registry_carries_the_reference_descriptions():
    assert tst.available_arrivals() == jst.available_arrivals()
    assert tst.describe() == jst.describe()
    with pytest.raises(KeyError, match="unknown arrival"):
        tst.make_arrival("nope", num_workers=4, staleness_bound=1)


ARRIVALS = [("all_sync", {}), ("straggler_fixed", {}),
            ("straggler_fixed", {"num_stragglers": 3, "period": 2}),
            ("straggler_rotating", {}),
            ("straggler_rotating", {"num_stragglers": 5}),
            ("partition", {}),
            ("partition", {"block_start": 4, "block_size": 3,
                           "start_round": 2, "length": 6}),
            ("byzantine_max_stale", {})]


@pytest.mark.parametrize("tau", [1, 2, 3])
@pytest.mark.parametrize("name,kw", ARRIVALS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ARRIVALS)])
def test_fresh_masks_equal_over_40_rounds(name, kw, tau):
    m = 12
    ja = jst.make_arrival(name, num_workers=m, staleness_bound=tau, **kw)
    ta = tst.make_arrival(name, num_workers=m, staleness_bound=tau, **kw)
    jbase, tbase = _keys(tau * 7)
    rng = np.random.default_rng(tau)
    for t in range(40):
        jk, tk = jax.random.fold_in(jbase, t), prng.fold_in(tbase, t)
        byz = np.zeros(m, bool)
        byz[rng.permutation(m)[:3]] = True
        want = np.asarray(ja.arrive(jk, t, jnp.asarray(byz)))
        got = ta.arrive(tk, t, torch.as_tensor(byz))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        if name == "byzantine_max_stale":
            assert got.numpy()[byz].all()


def test_arrival_from_config_disabled_only_for_sync_tau0():
    assert tst.arrival_from_config(RobustConfig(num_workers=4)) is None
    a = tst.arrival_from_config(RobustConfig(num_workers=4,
                                             staleness_bound=2))
    assert a.name == "all_sync" and a.staleness_bound == 2


def _run(cfg, rounds, *, seed=0, dim=6):
    key = prng.PRNGKey(seed)
    ds = regression.generate(key, dim=dim, total_samples=240,
                             num_workers=cfg.num_workers, device="cpu")
    opt = optim.sgd(0.5)
    run = make_run_rounds(regression.squared_loss, opt, cfg, device="cpu")
    theta0 = torch.zeros((dim,))
    state = init_train_state(theta0, opt.init(theta0), key,
                             arrival=tst.arrival_from_config(cfg))
    state, _ = advance(run, state, regression.worker_batches(ds),
                       num_rounds=rounds)
    return state


def test_all_sync_any_tau_bit_identical_to_sync_trainer():
    base = dict(num_workers=12, num_byzantine=2, num_batches=6,
                attack="sign_flip")
    sync = _run(RobustConfig(**base), 6)
    assert sync.stale_buffer == ()
    for tau in (1, 3):
        st = _run(RobustConfig(**base, staleness_bound=tau), 6)
        assert torch.equal(st.params, sync.params)
        for k in sync.history:
            np.testing.assert_array_equal(st.history[k], sync.history[k])
        assert not st.history["stale_count"].any()


def test_stale_run_counts_stale_workers_like_jax():
    """The stale golden's per-round stale_count (every count a straggler
    pair can leave) through the port's runner."""
    trace = engine.run_scenario(STALE, device="cpu")
    want = goldens.load_golden(STALE)
    assert trace["stale_count"] == want["stale_count"]
    assert trace["arrival"] == "straggler_rotating"
    assert trace["staleness_bound"] == 2
    assert any(c > 0 for c in trace["stale_count"])


def test_resume_jax_checkpoint_with_nonempty_buffer(tmp_path):
    """JAX runs the stale campaign to round 19 and checkpoints with workers
    mid-decay; the port restores the buffer (rows, int32 ages, bound) and
    finishes on the golden trajectory."""
    ckpt = str(tmp_path / "ckpt")
    jengine.replay_scenario(STALE, ckpt, rounds=19, ckpt_every=7)
    jstate = jengine.restore_scenario_state(STALE, ckpt)
    assert bool(jnp.any(jstate.stale_buffer.age > 0))
    tstate = engine.restore_scenario_state(STALE, ckpt, device="cpu")
    np.testing.assert_array_equal(tstate.stale_buffer.age.numpy(),
                                  np.asarray(jstate.stale_buffer.age))
    np.testing.assert_array_equal(tstate.stale_buffer.grads.numpy(),
                                  np.asarray(jstate.stale_buffer.grads))
    trace = engine.replay_scenario(STALE, ckpt, ckpt_every=7, device="cpu")
    assert goldens.compare_traces(trace, goldens.load_golden(STALE)) == []


def test_train_state_from_numpy_carries_the_buffer():
    sc = scenarios.get_scenario(STALE)
    run, state, batches, _, _, _ = jengine._build_run(sc)
    state, _ = jengine.advance(run, state, batches, num_rounds=20)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, state), device="cpu")
    assert isinstance(tstate.stale_buffer, tst.StalenessBuffer)
    assert tstate.stale_buffer.age.dtype == torch.int32
    trun, _, tbatches, rc, _ = engine._build_run(sc, device="cpu")
    tstate, _ = advance(trun, tstate, tbatches, num_rounds=20)
    trace = engine._trace(sc, rc, 40, tstate.history)
    assert goldens.compare_traces(trace, goldens.load_golden(STALE)) == []
