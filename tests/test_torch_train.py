"""The port's LM training path (models.layers.cross_entropy_loss,
models.model.loss_fn, optim.adamw, launch.steps' group-mode and mean
steps, launch.train, the checkpointed AdamW TrainState, convert) against
the JAX package's.

The JAX params are handed across with ``convert.lm_params_from_numpy``
(the port's initialiser draws other bits), at minitron-4b and
h2o-danube-3-4b reduced (f32, sequences of 80 tokens, past H2O's reduced
window of 64).  Tolerances: the loss and AdamW at rtol 1e-5; gradients at
1e-4 of each leaf's max|g|; metrics of a step at rtol 1e-5; params after
AdamW steps at 1e-4 of each leaf's max|p| plus a tenth of the learning
rate (``STEP_ATOL``): AdamW's first update is lr g / (|g| + eps), whose
slope at g = 0 is lr / eps, so a coordinate whose gradient is near eps
moves by a share of lr on the last bits of g; histories under
``compare_traces`` (rtol 1e-3, atol 1e-6).  The CUDA path runs only on a
card: tests/test_torch_cuda.py."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import robust_train as jrt
from repro.core import train_state as jts
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import checkpoint, configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import byzantine
from repro_torch.core import robust_train as trt
from repro_torch.core import train_state as tts
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import layers, model
from repro_torch.sim.goldens import compare_traces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("minitron-4b", "h2o-danube-3-4b")
SEQ = 80
LR = 1e-3
STEP_ATOL = 0.1 * LR


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _models(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, the same params in the port)."""
    jcfg = jconfigs.get_config(arch).reduced().with_(**kw)
    cfg = configs.get_config(arch).reduced().with_(**kw)
    jp = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      "cpu")
    return jcfg, cfg, jp, tp


def _streams(cfg, m, batch, seq=SEQ, seed=0):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              num_workers=m, seed=seed)
    return JTokenStream(**kw), TokenStream(**kw, device="cpu")


def _node(tree, entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            sub = getattr(entry, attr)
            return getattr(tree, sub) if attr == "name" else tree[sub]
    raise TypeError(entry)


def _leaf_pairs(jtree, ttree):
    """[(path, jax leaf, port leaf)] over the JAX tree's leaves."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        t = ttree
        for entry in path:
            t = _node(t, entry)
        out.append((jax.tree_util.keystr(path), np.asarray(leaf, np.float32),
                    t.float().numpy()))
    return out


def _close_leaves(jtree, ttree, rtol, atol=1e-12):
    for path, want, got in _leaf_pairs(jtree, ttree):
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max())
        assert err <= rtol * float(np.abs(want).max()) + atol, (path, err)


def _rows(metrics):
    keys = sorted(metrics)
    n = len(np.atleast_1d(np.asarray(metrics[keys[0]])))
    return {"history": [{k: float(np.atleast_1d(np.asarray(
        metrics[k].cpu() if torch.is_tensor(metrics[k])
        else metrics[k]))[i]) for k in keys} for i in range(n)]}


# ---------------------------------------------------------------------------
# the loss

@pytest.mark.parametrize("chunk", [0, 8, 10])
def test_cross_entropy_loss_matches_jax(chunk):
    """chunk 0 (min(T, 512)), 8 (three chunks) and 10 (does not divide T:
    one chunk of T), with masked labels."""
    rng = np.random.default_rng(chunk)
    h = rng.normal(size=(2, 24, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    y = rng.integers(0, 40, size=(2, 24)).astype(np.int32)
    y[0, 3] = y[1, 0] = y[1, 17] = -1
    want = float(jlayers.cross_entropy_loss(
        lambda x: x @ jnp.asarray(w), jnp.asarray(h), jnp.asarray(y),
        vocab_chunk=chunk))
    widths = []

    def logits_fn(x):
        widths.append(x.shape[1])
        return x @ torch.as_tensor(w)

    got = layers.cross_entropy_loss(logits_fn, torch.as_tensor(h),
                                    torch.as_tensor(y), vocab_chunk=chunk)
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert widths == ([8, 8, 8] if chunk == 8 else [24])


def test_cross_entropy_loss_all_masked_is_zero():
    h = torch.ones((1, 4, 3))
    y = torch.full((1, 4), -1, dtype=torch.int32)
    assert float(layers.cross_entropy_loss(lambda x: x, h, y)) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, cfg, jp, tp = _models(arch)
    jstream, tstream = _streams(cfg, 1, 2)
    jb = {k: v[0] for k, v in jstream.batch(0).items()}
    tb = {k: v[0] for k, v in tstream.batch(0).items()}
    want = float(jmodel.loss_fn(jp, jb, jcfg))
    assert float(model.loss_fn(tp, tb, cfg)) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_per_worker_grads_match_jax(arch):
    jcfg, cfg, jp, tp = _models(arch)
    jstream, tstream = _streams(cfg, 4, 8)
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, jstream.batch(0))
    tg, tl = trt.per_worker_grads(lambda p, b: model.loss_fn(p, b, cfg), tp,
                                  tstream.batch(0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    _close_leaves(jg, tg, 1e-4)


def test_worker_mode_refuses_remat():
    """torch.func's grad refuses checkpoint's saved-tensor hooks: a remat
    config on the vmap-of-grad path raises, naming the cause."""
    _, cfg, _, tp = _models("minitron-4b", remat=True)
    _, tstream = _streams(cfg, 2, 2, seq=8)
    with pytest.raises(ValueError, match="remat=True under a torch.func"):
        trt.per_worker_grads(lambda p, b: model.loss_fn(p, b, cfg), tp,
                             tstream.batch(0))
    # under no_grad (prefill) remat is a no-op and the forward runs
    with torch.no_grad():
        h, _ = model.forward(tp, cfg, {"tokens": tstream.batch(0)["tokens"][0]})
    assert h.shape == (1, 8, cfg.d_model)


# ---------------------------------------------------------------------------
# AdamW

@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1,
                                     "grad_clip_norm": 1.0}])
def test_adamw_matches_jax(kw):
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [tree_map(lambda p: (rng.normal(size=p.shape) * 3).astype(
        np.float32), params) for _ in range(3)]
    jsched = joptim.schedule.warmup_cosine(1e-2, warmup_steps=2,
                                           total_steps=10)
    tsched = optim.schedule.warmup_cosine(1e-2, warmup_steps=2,
                                          total_steps=10)
    jopt, topt = joptim.adamw(jsched, **kw), optim.adamw(tsched, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.as_tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(tree_map(torch.as_tensor, g), ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        for want, got in ((ju, tu), (js.mu, ts.mu), (js.nu, ts.nu)):
            for _, w, t in _leaf_pairs(want, got):
                np.testing.assert_allclose(t, w, rtol=1e-5, atol=1e-9)
    assert isinstance(ts, optim.AdamState) and int(ts.step) == 3


def test_adamw_moments_are_f32_for_bf16_params():
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    opt = optim.adamw(LR)
    s = opt.init(p)
    assert s.mu["w"].dtype == s.nu["w"].dtype == torch.float32
    u, s = opt.update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, s,
                      p)
    assert u["w"].dtype == torch.float32
    torch.testing.assert_close(u["w"], torch.full((4,), -LR))


# ---------------------------------------------------------------------------
# worker mode: one step, a multi-round history

def test_robust_train_step_lm_matches_jax():
    jcfg, cfg, jp, tp = _models("h2o-danube-3-4b")
    jstream, tstream = _streams(cfg, 4, 8)
    kw = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jstep = jrt.make_robust_train_step(
        lambda p, b: jmodel.loss_fn(p, b, jcfg), joptim.adamw(LR),
        jrt.RobustConfig(**kw))
    tstep = trt.make_robust_train_step(
        lambda p, b: model.loss_fn(p, b, cfg), optim.adamw(LR),
        trt.RobustConfig(**kw))
    jp2, _, jm = jstep(jp, joptim.adamw(LR).init(jp), jstream.batch(0),
                       jax.random.PRNGKey(7), 0)
    tp2, _, tm = tstep(tp, optim.adamw(LR).init(tp), tstream.batch(0),
                       prng.PRNGKey(7), 0)
    for name in jm:
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-5)
    _close_leaves(jp2, tp2, 1e-4, STEP_ATOL)


def test_run_rounds_lm_history_matches_jax():
    """Six rounds of the LM through make_run_rounds (gmom under sign_flip
    with the rotating schedule, AdamW), per-round batches."""
    jcfg, cfg, jp, tp = _models("minitron-4b")
    jstream, tstream = _streams(cfg, 4, 8, seq=32)
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jrun = jrt.make_run_rounds(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                               joptim.adamw(LR), jrt.RobustConfig(**rc))
    trun = trt.make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg),
                               optim.adamw(LR), trt.RobustConfig(**rc),
                               device="cpu")
    jb = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jstream.batch(i) for i in range(6)])
    tb = tree_map(lambda *xs: torch.stack(xs),
                  *[tstream.batch(i) for i in range(6)])
    *_, jm = jrun(jp, joptim.adamw(LR).init(jp), jb,
                  jax.random.PRNGKey(3), per_round_batches=True)
    *_, tm = trun(tp, optim.adamw(LR).init(tp), tb, prng.PRNGKey(3),
                  per_round_batches=True)
    assert compare_traces(_rows(tm), _rows(jm)) == []


def test_adamw_train_state_from_jax_steps_on():
    """A reference TrainState carrying AdamW's state, taken two rounds in,
    is carried across and stepped once on both sides."""
    jcfg, cfg, jp, _ = _models("minitron-4b")
    jstream, tstream = _streams(cfg, 4, 8, seq=24)
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jopt, topt = joptim.adamw(LR, weight_decay=0.01), \
        optim.adamw(LR, weight_decay=0.01)
    jrun = jrt.make_run_rounds(lambda p, b: jmodel.loss_fn(p, b, jcfg), jopt,
                               jrt.RobustConfig(**rc))
    trun = trt.make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg), topt,
                               trt.RobustConfig(**rc), device="cpu")

    def jbatch(i0, n):
        return jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[jstream.batch(i) for i in range(i0, i0 + n)])

    jstate = jts.init_train_state(jp, jopt.init(jp), jax.random.PRNGKey(5))
    jstate, _ = jts.advance(jrun, jstate, jbatch(0, 2),
                            per_round_batches=True)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    assert isinstance(tstate.opt_state, optim.AdamState)
    assert int(tstate.opt_state.step) == 2
    jstate, _ = jts.advance(jrun, jstate, jbatch(2, 1),
                            per_round_batches=True)
    tstate, _ = tts.advance(trun, tstate, tree_map(
        lambda x: x[None], tstream.batch(2)), per_round_batches=True)
    assert int(tstate.opt_state.step) == 3
    assert compare_traces(_rows(tstate.history), _rows(jstate.history)) == []
    _close_leaves(jstate.params, tstate.params, 1e-4, STEP_ATOL)


# ---------------------------------------------------------------------------
# group mode

def _group_pair(jcfg, cfg, rc, schedule, microbatches):
    jrc, trc = jrt.RobustConfig(**rc), trt.RobustConfig(**rc)
    jsched = tsched = None
    if schedule:
        kw = dict(num_workers=rc["num_workers"],
                  num_byzantine=rc["num_byzantine"], attack=rc["attack"])
        from repro.core import byzantine as jbyz
        jsched = jbyz.make_schedule(schedule, **kw)
        tsched = byzantine.make_schedule(schedule, **kw)
    jstep = jsteps.make_group_train_step(jcfg, jrc, joptim.adamw(LR),
                                         microbatches=microbatches,
                                         schedule=jsched)
    tstep = steps.make_group_train_step(cfg, trc, optim.adamw(LR),
                                        microbatches=microbatches,
                                        schedule=tsched)
    return jstep, tstep, jsched, tsched


@pytest.mark.parametrize("schedule,microbatches,remat", [
    (None, 1, False), (None, 2, True), ("rotating", 1, True),
    ("stealth_then_strike", 2, False)])
def test_group_train_step_matches_jax(schedule, microbatches, remat):
    """Two steps of make_group_train_step (k = 4 groups of 2 sequences,
    gmom under sign_flip), with and without an AttackSchedule, one or two
    microbatches, remat on and off."""
    jcfg, cfg, jp, tp = _models("h2o-danube-3-4b", remat=remat)
    jstream, tstream = _streams(cfg, 4, 8)
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jstep, tstep, jsched, tsched = _group_pair(jcfg, cfg, rc, schedule,
                                               microbatches)
    js, ts = joptim.adamw(LR).init(jp), optim.adamw(LR).init(tp)
    jstate = jsched.init_state() if jsched else None
    tstate = tsched.init_state(torch.device("cpu")) if tsched else None
    for t in range(2):
        jkey, tkey = jax.random.PRNGKey(10 + t), prng.PRNGKey(10 + t)
        if schedule:
            jp, js, jm, jstate = jstep(jp, js, jstream.batch(t), jkey, t,
                                       jstate)
            tp, ts, tm, tstate = tstep(tp, ts, tstream.batch(t), tkey, t,
                                       tstate)
        else:
            jp, js, jm = jstep(jp, js, jstream.batch(t), jkey, t)
            tp, ts, tm = tstep(tp, ts, tstream.batch(t), tkey, t)
        assert set(tm) == {"loss_mean", "loss_median", "agg_grad_norm",
                           "byz_count"}
        for name in jm:
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), name
    _close_leaves(jp, tp, 1e-4, STEP_ATOL)


def test_group_step_remat_changes_no_number():
    _, cfg, _, tp = _models("minitron-4b")
    _, tstream = _streams(cfg, 2, 4, seq=16)
    rc = trt.RobustConfig(num_workers=2, num_batches=2, aggregator="mean")
    out = []
    for remat in (False, True):
        step = steps.make_group_train_step(cfg.with_(remat=remat), rc,
                                           optim.sgd(0.1))
        p, _, m = step(tp, optim.sgd(0.1).init(tp), tstream.batch(0),
                       prng.PRNGKey(0), 0)
        out.append((p, m))
    for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(out[1])):
        assert torch.equal(a, b)


def test_mean_train_step_matches_jax():
    jcfg, cfg, jp, tp = _models("minitron-4b")
    jstream, tstream = _streams(cfg, 1, 4)
    jstep = jsteps.make_mean_train_step(jcfg, joptim.adamw(LR))
    tstep = steps.make_mean_train_step(cfg, optim.adamw(LR))
    js, ts = joptim.adamw(LR).init(jp), optim.adamw(LR).init(tp)
    for t in range(2):
        jp, js, jm = jstep(jp, js, jstream.batch(t), jax.random.PRNGKey(0), t)
        tp, ts, tm = tstep(tp, ts, tstream.batch(t), prng.PRNGKey(0), t)
        for name in jm:
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), name
        assert float(tm["byz_count"]) == 0.0
    _close_leaves(jp, tp, 1e-4, STEP_ATOL)


def test_group_step_refuses_grad_shardings():
    cfg = configs.get_config("minitron-4b").reduced()
    with pytest.raises(NotImplementedError, match="item 16.10"):
        steps.make_group_train_step(cfg, trt.RobustConfig(num_workers=2),
                                    optim.sgd(0.1), grad_shardings={})


# ---------------------------------------------------------------------------
# the checkpoint of an LM TrainState

def test_checkpoint_keeps_bf16_params_and_adam_state(tmp_path):
    cfg = configs.get_config("h2o-danube-3-4b").reduced().with_(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = model.init(3, cfg, device="cpu")
    opt = optim.adamw(LR)
    grads = tree_map(lambda p: torch.full(p.shape, 0.25), params)
    _, opt_state = opt.update(grads, opt.init(params), params)
    state = tts.init_train_state(params, opt_state, prng.PRNGKey(1))
    tts.save_train_state(str(tmp_path), state)
    back = tts.restore_train_state(str(tmp_path), 0, params,
                                   opt.init(params))
    assert isinstance(back.opt_state, optim.AdamState)
    for a, b in zip(jax.tree.leaves((state.params, state.opt_state)),
                    jax.tree.leaves((back.params, back.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a bf16 leaf is written as the reference writes it (its raw words,
    # |V2 in the archive, manifest dtype "bfloat16"), and the reference's
    # file is read back bit for bit (the reference's own restore cannot
    # cast |V2 to bfloat16)
    mine, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    checkpoint.save(mine, 4, {"params": params})
    jcheckpoint.save(jdir, 4, {"params": tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
        params)})
    assert checkpoint.read_manifest(mine, 4)["leaves"] == \
        jcheckpoint.read_manifest(jdir, 4)["leaves"]
    with np.load(os.path.join(mine, "step_00000004", "arrays.npz")) as a, \
            np.load(os.path.join(jdir, "step_00000004", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype == np.dtype("V2")
            assert a[name].tobytes() == b[name].tobytes()
    back = checkpoint.restore(jdir, 4, {"params": params})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": params})):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# launch/train.py

def _args(**kw):
    base = dict(scale="cpu", arch="minitron-4b", steps=6, workers=4,
                byzantine=1, num_batches=4, attack="sign_flip",
                schedule="stealth_then_strike", scan_chunk=3,
                round_backend="auto", aggregator="gmom", arrival="all_sync",
                staleness_bound=0, batch=8, seq_len=16, lr=LR, seed=0,
                log_every=100, ckpt_dir=None, ckpt_every=4, out=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_train_driver_resume_bit_identical(tmp_path):
    """Interrupted at a misaligned checkpoint (3 is not a multiple of
    ckpt_every) and resumed: the exact uninterrupted history, the
    stateful stealth_then_strike adversary included; resuming a finished
    run changes nothing."""
    straight = train_lib.train(_args())
    ckpt = str(tmp_path / "ckpt")
    train_lib.train(_args(steps=3, ckpt_dir=ckpt))
    resumed = train_lib.train(_args(ckpt_dir=ckpt))
    assert resumed["resumed_from"] == 3
    assert resumed["history"] == straight["history"]
    assert resumed["first_loss"] == straight["first_loss"]
    assert resumed["final_loss"] == straight["final_loss"]
    done = train_lib.train(_args(ckpt_dir=ckpt))
    assert done["resumed_from"] == 6
    assert done["history"] == straight["history"]


def test_train_cli_learns(tmp_path):
    out = tmp_path / "result.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--scale", "cpu",
         "--steps", "6", "--workers", "4", "--byzantine", "1", "--attack",
         "sign_flip", "--aggregator", "gmom", "--batch", "8", "--seq-len",
         "32", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    data = json.loads(out.read_text())
    assert data["arch"] == "minitron-4b"
    assert np.isfinite(data["final_loss"])
    assert data["final_loss"] < data["first_loss"]


def test_train_scales(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 17"):
        train_lib.train(train_lib.parse_args(["--scale", "pod"]))
    args = train_lib.parse_args([])
    assert (args.scale, args.arch) == ("gpu", "h2o-danube-3-4b")
    assert train_lib.parse_args(["--scale", "cpu"]).arch == "minitron-4b"
    cfg = train_lib.train_config("h2o-danube-3-4b", "gpu")
    full = configs.get_config("h2o-danube-3-4b")
    assert cfg == full.with_(num_layers=2, remat=False)
    assert cfg.param_count() == 555_417_600     # the reference's count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lib.train(args)


def test_build_cpu_batch_is_dense_only():
    cfg = configs.get_config("minitron-4b").reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=8,
                         global_batch=4, num_workers=2, device="cpu")
    assert train_lib.build_cpu_batch(cfg, stream, 0, None)["tokens"].shape \
        == (2, 2, 8)
    with pytest.raises(NotImplementedError, match="item 16"):
        train_lib.build_cpu_batch(cfg.with_(family="vlm"), stream, 0, None)
