"""The port's engine end to end (repro_torch.sim) against the JAX
package's goldens, checkpoints and data.

All eleven goldens replay on the CPU through both gmom lowerings within
``compare_traces`` (rtol 1e-3, atol 1e-6), the sign golden also on the
reference's own arrays; the compressed and the staleness campaigns resume
byte for byte; a checkpoint the JAX package wrote mid-run is resumed by
the port; the data model, gradients and SGD step agree with JAX; the
entry points refuse to fall back to the CPU silently."""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import robust_train as jrt
from repro.data import regression as jreg
from repro.sim import engine as jengine
from repro.sim import goldens as jgoldens
from repro.sim import scenarios as jscenarios
from repro_torch import convert, optim
from repro_torch import random as prng
from repro_torch.core import compression
from repro_torch.core import robust_train as trt
from repro_torch.core.shard_aggregation import ShardSpec
from repro_torch.core.train_state import advance
from repro_torch.data import regression
from repro_torch.sim import engine, goldens, scenarios

GOLDENS = [sc.name for sc in scenarios.golden_scenarios()]
STEALTH = "linreg/gmom/sign_flip/stealth_then_strike"
SIGN = "linreg/sign_majority_static"
STALE = "linreg/gmom/sign_flip/rotating/stale"


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def test_nine_float_goldens_registered():
    """The nine synchronous float-wire goldens, and with the sign wire and
    the staleness buffer ported, the two others: eleven, in a registry
    equal to the reference's 29 scenarios, field for field."""
    sync = [n for n in GOLDENS if n not in (SIGN, STALE)]
    assert len(sync) == 9 and len(GOLDENS) == 11
    assert GOLDENS == [sc.name for sc in jscenarios.golden_scenarios()]
    assert scenarios.available() == jscenarios.available()
    assert len(scenarios.available()) == 29
    for name in scenarios.available():
        assert dataclasses.asdict(scenarios.get_scenario(name)) == \
            dataclasses.asdict(jscenarios.get_scenario(name))


@pytest.mark.parametrize("backend", ["reference", "fused_interpret"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_replays_on_cpu(name, backend):
    trace = engine.run_scenario(name, round_backend=backend, device="cpu")
    assert goldens.compare_traces(trace, goldens.load_golden(name)) == []


@pytest.mark.parametrize("name", [SIGN, STALE])
def test_golden_replays_on_jax_data(name):
    """With the reference's arrays handed across, the sign and stale
    goldens replay too: any difference is then in the vote or the buffer,
    not in the data."""
    sc = scenarios.get_scenario(name)
    ds = jreg.generate(jax.random.PRNGKey(sc.seed), dim=sc.dim,
                       total_samples=sc.total_samples,
                       num_workers=sc.num_workers, noise_std=sc.noise_std)
    tds = convert.scenario_inputs_from_numpy(
        np.asarray(ds.features), np.asarray(ds.targets),
        np.asarray(ds.theta_star), device="cpu")
    trace = engine.run_scenario(name, device="cpu", dataset=tds)
    assert goldens.compare_traces(trace, goldens.load_golden(name)) == []


@pytest.mark.parametrize("name", goldens.BIT_EXACT_RESUME_SCENARIOS)
def test_bit_exact_resume_replay_on_cpu(name):
    """Interrupted at round 19, resumed with checkpoints every 7 rounds:
    byte-identical to the straight run, and on the golden."""
    assert goldens.check_resume_bit_exact(name, device="cpu") == []


def test_trace_bytes_is_the_golden_format():
    for name in GOLDENS:
        with open(goldens.golden_path(name), "rb") as f:
            raw = f.read()
        assert goldens.trace_bytes(goldens.load_golden(name)) == raw
        assert goldens.trace_bytes(goldens.load_golden(name)) == \
            jgoldens.trace_bytes(jgoldens.load_golden(name))


def test_synchronous_traces_do_not_grow_the_new_keys():
    trace = engine.run_scenario(STEALTH, rounds=2, device="cpu")
    for key in ("compression", "arrival", "staleness_bound", "stale_count"):
        assert key not in trace
    sign = engine.run_scenario(SIGN, rounds=2, device="cpu")
    assert sign["compression"] == "sign" and "arrival" not in sign


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_copies_byte_identical(name):
    assert filecmp.cmp(goldens.golden_path(name),
                       jgoldens.golden_path(name), shallow=False)


def test_interrupted_resume_replay_on_cpu():
    assert goldens.check_resume_replay(device="cpu") == []


def test_resume_from_jax_checkpoint(tmp_path):
    """JAX runs stealth_then_strike to round 20 and checkpoints; the port
    restores that TrainState (adversary EMA/latch included) and finishes
    the campaign on the golden trajectory."""
    ckpt = str(tmp_path / "ckpt")
    jengine.replay_scenario(STEALTH, ckpt, rounds=20, ckpt_every=10)
    trace = engine.replay_scenario(STEALTH, ckpt, ckpt_every=10,
                                   device="cpu")
    assert goldens.compare_traces(trace, goldens.load_golden(STEALTH)) == []


def test_jax_restores_port_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    engine.replay_scenario(STEALTH, ckpt, rounds=20, ckpt_every=10,
                           device="cpu")
    trace = jengine.replay_scenario(STEALTH, ckpt, ckpt_every=10)
    assert goldens.compare_traces(trace, goldens.load_golden(STEALTH)) == []


def test_train_state_from_numpy_continues_a_jax_run():
    sc = scenarios.get_scenario(STEALTH)
    run, state, batches, _, _, _ = jengine._build_run(sc)
    state, _ = jengine.advance(run, state, batches, num_rounds=20)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, state), device="cpu")
    trun, _, tbatches, rc, _ = engine._build_run(sc, device="cpu")
    tstate, _ = advance(trun, tstate, tbatches, num_rounds=20)
    trace = engine._trace(sc, rc, 40, tstate.history)
    assert goldens.compare_traces(trace, goldens.load_golden(STEALTH)) == []


def test_scenario_on_jax_data_matches_jax_engine():
    """With the reference's own arrays handed across, the port's trajectory
    follows the JAX engine's for a scenario that has no golden."""
    sc = scenarios.Scenario(name="linreg/gmom/alie/rotating-k5", attack="alie",
                            num_batches=5, rounds=15, seed=3)
    ds = jreg.generate(jax.random.PRNGKey(sc.seed), dim=sc.dim,
                       total_samples=sc.total_samples,
                       num_workers=sc.num_workers)
    tds = convert.scenario_inputs_from_numpy(
        np.asarray(ds.features), np.asarray(ds.targets),
        np.asarray(ds.theta_star), device="cpu")
    got = engine.run_scenario(sc, device="cpu", dataset=tds)
    want = jengine.run_scenario(sc)
    assert goldens.compare_traces(got, want) == []


def test_generate_matches_jax():
    jds = jreg.generate(jax.random.PRNGKey(7), dim=6, total_samples=60,
                        num_workers=4, heterogeneity=0.3)
    tds = regression.generate(prng.PRNGKey(7), dim=6, total_samples=60,
                              num_workers=4, heterogeneity=0.3, device="cpu")
    assert tds.features.shape == (4, 15, 6)
    for got, want in ((tds.features, jds.features),
                      (tds.targets, jds.targets),
                      (tds.theta_star, jds.theta_star)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        regression.generate(prng.PRNGKey(0), dim=2, total_samples=10,
                            num_workers=3, device="cpu")


def test_per_worker_grads_and_sgd_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 8, 3)).astype(np.float32)
    y = rng.normal(size=(5, 8)).astype(np.float32)
    theta = rng.normal(size=(3,)).astype(np.float32)
    jg, jl = jrt.per_worker_grads(jreg.squared_loss, jnp.asarray(theta),
                                  (jnp.asarray(x), jnp.asarray(y)))
    tg, tl = trt.per_worker_grads(regression.squared_loss,
                                  torch.as_tensor(theta),
                                  (torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for momentum, nesterov in ((0.0, False), (0.9, False), (0.9, True)):
        jopt = joptim.sgd(0.5, momentum=momentum, nesterov=nesterov)
        topt = optim.sgd(0.5, momentum=momentum, nesterov=nesterov)
        js = jopt.init(jnp.asarray(theta))
        ts = topt.init(torch.as_tensor(theta))
        for _ in range(3):
            ju, js = jopt.update(jnp.asarray(theta), js)
            tu, ts = topt.update(torch.as_tensor(theta), ts)
            np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6)
        assert int(ts.step) == int(js.step) == 3


def test_lr_schedules_match_jax():
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule as tsched
    pairs = [(jsched.constant(0.3), tsched.constant(0.3)),
             (jsched.warmup_cosine(1.0, warmup_steps=5, total_steps=40),
              tsched.warmup_cosine(1.0, warmup_steps=5, total_steps=40)),
             (jsched.inverse_sqrt(0.5, warmup_steps=10),
              tsched.inverse_sqrt(0.5, warmup_steps=10))]
    for jfn, tfn in pairs:
        for step in (0, 1, 4, 5, 17, 39, 60):
            want = float(jfn(jnp.asarray(step, jnp.int32)))
            got = float(tfn(torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("aggregator,attack", [("gmom", "sign_flip"),
                                               ("mean", "inner_product"),
                                               ("trimmed_mean", "alie")])
def test_robust_train_step_matches_jax(aggregator, attack):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, 6, 5)).astype(np.float32)
    y = rng.normal(size=(20, 6)).astype(np.float32)
    theta = rng.normal(size=(5,)).astype(np.float32)
    kw = dict(num_workers=20, num_byzantine=3, num_batches=10,
              aggregator=aggregator, attack=attack)
    jstep = jrt.make_robust_train_step(jreg.squared_loss, joptim.sgd(0.5),
                                       jrt.RobustConfig(**kw))
    tstep = trt.make_robust_train_step(regression.squared_loss,
                                       optim.sgd(0.5), trt.RobustConfig(**kw))
    jk = jax.random.PRNGKey(9)
    tk = torch.as_tensor(np.asarray(jk).astype(np.int64))
    jp, _, jm = jstep(jnp.asarray(theta), joptim.sgd(0.5).init(
        jnp.asarray(theta)), (jnp.asarray(x), jnp.asarray(y)), jk, 3)
    tp, _, tm = tstep(torch.as_tensor(theta), optim.sgd(0.5).init(
        torch.as_tensor(theta)), (torch.as_tensor(x), torch.as_tensor(y)),
        tk, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    for name in jm:
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-5)


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.run_scenario(GOLDENS[0], rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.replay_scenario(GOLDENS[0], os.devnull, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        regression.generate(prng.PRNGKey(0), dim=2, total_samples=4,
                            num_workers=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.make_run_rounds(regression.squared_loss, optim.sgd(0.5),
                            trt.RobustConfig(num_workers=4))


@pytest.mark.parametrize("field,value,item", [
    ("compression", "int8_stochastic", "item 13"),
    ("arrival", "straggler_rotating", "item 13"),
    ("staleness_bound", 2, "item 13")])
def test_unported_features_raise(field, value, item):
    """The wire and the staleness path run, and under them shard-local
    aggregation (ROADMAP Queue 1 ``item``, once the port's last gap here)
    runs now too: with a virtual ShardSpec the aggregate equals the
    unsharded one within f32 rounding, and the int8 wire's scales are the
    unsharded ones bit for bit (its uniforms are keyed per shard)."""
    assert item == "item 13"
    cfg = trt.RobustConfig(num_workers=4, num_batches=2, **{field: value})
    run = trt.make_run_rounds(regression.squared_loss, optim.sgd(0.5), cfg,
                              device="cpu")
    x = torch.ones((4, 3, 2))
    *_, metrics = run(torch.zeros(2), optim.sgd(0.5).init(torch.zeros(2)),
                      (x, torch.ones((4, 3))), prng.PRNGKey(0), num_rounds=2)
    assert metrics["loss_mean"].shape == (2,)
    g = torch.as_tensor(
        np.random.default_rng(0).normal(size=(4, 3, 2)).astype(np.float32))
    spec = ShardSpec(num_shards=2, mode="virtual")
    key = prng.PRNGKey(0)
    plain = trt.aggregate_reported(g, cfg, key=key)
    sharded = trt.aggregate_reported(g, cfg, key=key, shard_spec=spec)
    assert sharded.shape == plain.shape and bool(torch.isfinite(sharded).all())
    if field == "compression":
        codec = compression.get_codec(value)
        assert torch.equal(codec.encode(g, key=key)["scale"],
                           codec.encode(g, key=key, shard_spec=spec)["scale"])
    else:
        torch.testing.assert_close(sharded, plain, rtol=1e-5, atol=1e-6)
