"""The port's attacks and schedules (repro_torch.core.byzantine) against
the JAX package's.

Byzantine masks come from threefry uniforms and stable ranks, so they must
be equal exactly; attacked reports and carried attack state agree within
float tolerance (rtol 1e-5, atol 1e-6: the means run in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import byzantine as jbyz
from repro_torch.core import byzantine as tbyz

ATTACKS = ("none", "sign_flip", "inner_product", "alie", "norm_stealth")
SCHEDULES = ("static", "rotating", "ramp_up", "coordinated_switch",
             "stealth_then_strike")


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _grads(m, d, seed):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("q", [0, 1, 3, 10])
def test_masks_equal_exactly(seed, q):
    jk, tk = _keys(seed)
    for rotate in (True, False):
        for t in (0, 1, 5, 39):
            want = np.asarray(jbyz.sample_byzantine_mask(
                jk, 20, q, rotate=rotate, round_index=t))
            got = tbyz.sample_byzantine_mask(tk, 20, q, rotate=rotate,
                                             round_index=t).numpy()
            np.testing.assert_array_equal(got, want)
            assert got.sum() == q


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("q", [1, 3, 9])
def test_attacks_match_jax(attack, q):
    g = _grads(20, 12, seed=q)
    jk, tk = _keys(q)
    mask = np.zeros(20, bool)
    mask[np.random.default_rng(q).permutation(20)[:q]] = True
    want = jbyz.get_attack(attack)(jnp.asarray(g), jnp.asarray(mask), jk)
    got = tbyz.get_attack(attack)(torch.as_tensor(g), torch.as_tensor(mask),
                                  tk)
    _close(got, want)
    honest = ~mask
    np.testing.assert_array_equal(got.numpy()[honest], g[honest])


def test_alie_explicit_z_and_pytree_leaves():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(10, 3)).astype(np.float32),
            "b": rng.normal(size=(10, 2, 2)).astype(np.float32)}
    mask = np.arange(10) < 3
    jk, tk = _keys(5)
    for name in ("alie", "norm_stealth", "sign_flip"):
        kw = {"z_max": 1.5} if name == "alie" else {}
        want = jbyz.get_attack(name)(
            {n: jnp.asarray(v) for n, v in tree.items()}, jnp.asarray(mask),
            jk, **kw)
        got = tbyz.get_attack(name)(
            {n: torch.as_tensor(v) for n, v in tree.items()},
            torch.as_tensor(mask), tk, **kw)
        for n in tree:
            _close(got[n], want[n])


def _state_np(state):
    if state == ():
        return {}
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_jax_over_rounds(schedule):
    m, q = 20, 3
    kw = dict(num_workers=m, num_byzantine=q, attack="sign_flip")
    jsch = jbyz.make_schedule(schedule, **kw)
    tsch = tbyz.make_schedule(schedule, **kw)
    jstate = jsch.init_state()
    tstate = tsch.init_state(torch.device("cpu"))
    assert _state_np(tstate).keys() == _state_np(jstate).keys()
    jbase, tbase = _keys(11)
    rng = np.random.default_rng(0)
    scale = 1.0
    for t in range(14):
        scale *= 0.6                 # decaying gradients trip the strike
        g = (rng.normal(size=(m, 6)) * scale + scale).astype(np.float32)
        jkt = jax.random.fold_in(jbase, t)
        tkt = torch.as_tensor(np.asarray(jkt).astype(np.int64))
        jrep, jmask, jstate = jsch.apply(jnp.asarray(g), jkt, t, jstate)
        trep, tmask, tstate = tsch.apply(torch.as_tensor(g), tkt, t, tstate)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        _close(trep, jrep)
        js, ts = _state_np(jstate), _state_np(tstate)
        for k in js:
            assert ts[k].dtype == js[k].dtype, k
            _close(ts[k], js[k])
    if schedule == "stealth_then_strike":
        assert bool(tstate["struck"])


def test_ramp_up_counts_grow_like_jax():
    jsch = jbyz.make_schedule("ramp_up", num_workers=20, num_byzantine=3)
    tsch = tbyz.make_schedule("ramp_up", num_workers=20, num_byzantine=3)
    g = _grads(20, 4, seed=0)
    jk, tk = _keys(2)
    for t in range(25):
        _, jmask, _ = jsch.apply(jnp.asarray(g), jk, t, ())
        _, tmask, _ = tsch.apply(torch.as_tensor(g), tk, t, ())
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_registries_carry_the_reference_descriptions():
    jatk, jsch = dict(jbyz.describe()), dict(jbyz.describe_schedules())
    for name, desc in tbyz.describe():
        assert jatk[name] == desc
    assert dict(tbyz.describe_schedules()) == jsch
    assert tbyz.available() == jbyz.available()
    with pytest.raises(KeyError, match="unknown attack"):
        tbyz.get_attack("gaussian_blur")
