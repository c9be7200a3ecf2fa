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
from repro_torch.models import blocks, layers, model
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


REMAT_ARCHS = ("minitron-4b", "granite-moe-1b-a400m", "zamba2-2.7b")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_worker_mode_remat_matches_no_remat_and_jax(arch):
    """``per_worker_grads`` (a vmap of grad) on a remat config: the remat
    Function recomputes each block in its backward, so the gradients and
    losses are torch.equal to the config without remat, and match the
    reference's ``per_worker_grads`` with remat (``jax.checkpoint``) at
    the LM tolerance.  Under no_grad (prefill) remat is a no-op."""
    jcfg, cfg, jp, tp = _models(arch, remat=True)
    jstream, tstream = _streams(cfg, 2, 4, seq=16)
    got = {}
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        got[remat] = trt.per_worker_grads(
            lambda p, b: model.loss_fn(p, b, c), tp, tstream.batch(0))
    for a, b in zip(jax.tree.leaves(got[True]), jax.tree.leaves(got[False])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, jstream.batch(0))
    np.testing.assert_allclose(got[True][1].numpy(), np.asarray(jl),
                               rtol=1e-5)
    _close_leaves(jg, got[True][0], 1e-4)
    with torch.no_grad():
        h, _ = model.forward(tp, cfg, {"tokens": tstream.batch(0)["tokens"][0]})
    assert h.shape == (2, 16, cfg.d_model)


_REMAT_RSS = """
import sys, torch
from repro_torch import configs
from repro_torch.models import blocks
torch.set_num_threads(1)
cfg = configs.get_config("minitron-4b").reduced().with_(remat=sys.argv[1] == "1")
def block(p, x):
    h = torch.tanh(x @ p["w"])
    return (torch.sin(h) * h) @ p["v"] + x
f = blocks.maybe_remat(block, cfg)
def loss(p, x):
    for _ in range(12):
        x = f(p, x)
    return (x * x).sum()
p = {"w": torch.randn(64, 1024) * 0.1, "v": torch.randn(1024, 64) * 0.01}
xs = torch.randn(4, 1024, 64)
def status(field):
    with open("/proc/self/status") as fh:
        return next(int(line.split()[1]) for line in fh
                    if line.startswith(field + ":"))
with open("/proc/self/clear_refs", "w") as fh:
    fh.write("5")           # the peak (VmHWM) restarts from the current RSS
before = status("VmRSS")
torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(p, xs)
print(status("VmHWM") - before)
"""


def test_remat_frees_each_block_under_vmap_of_grad():
    """Twelve blocks of 4 MB activations, 4 workers, under vmap(grad):
    with remat the peak resident memory grows by less than half of what
    it grows by without (each block's recomputed graph is freed when its
    backward ends; a gradient that kept it would hold all twelve to the
    end).  One thread and one malloc arena, so that the peak
    is the tensors' and not the allocator's per-thread caches.  The peak
    is the process's own high-water mark (VmHWM, reset before the call):
    ``ru_maxrss`` also carries the peak of the process that spawned it."""
    grown = {}
    for remat in ("0", "1"):
        res = subprocess.run([sys.executable, "-c", _REMAT_RSS, remat],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=300, env=dict(
                                 os.environ, MALLOC_ARENA_MAX="1",
                                 PYTHONPATH=os.path.join(REPO, "src")))
        assert res.returncode == 0, res.stderr[-2000:]
        grown[remat] = int(res.stdout.split()[-1])
    assert grown["1"] < 0.5 * grown["0"], grown


def test_remat_function_batches_under_vmap_of_grad():
    """The remat Function alone on a block with a tuple output and a dict
    of params, under vmap(grad): torch.equal to the plain block."""
    cfg = configs.get_config("minitron-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(6, 6, generator=gen),
              "b": torch.randn(6, generator=gen)}
    xs = torch.randn(3, 4, 6, generator=gen)

    def block(p, x):
        h = torch.tanh(x @ p["w"] + p["b"])
        return x + h, torch.sum(h * h), 0.0

    def loss(p, x, remat):
        f = blocks.maybe_remat(block, cfg.with_(remat=remat))
        y, aux, zero = f(p, x)
        assert zero == 0.0
        return torch.sum(y * y) + aux

    out = [torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                           in_dims=(None, 0, None))(params, xs, remat)
           for remat in (False, True)]
    for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(out[1])):
        assert torch.equal(a, b)


def test_remat_refuses_second_order_gradients():
    """A second derivative through a remat'd block raises, under
    ``torch.func`` (grad of grad) and on plain autograd (a backward with
    create_graph), where its backward's gradients would carry no graph;
    the first derivative of either runs."""
    cfg = configs.get_config("minitron-4b").reduced().with_(remat=True)
    f = blocks.maybe_remat(lambda w, x: torch.tanh(x * w), cfg)
    w, x = torch.tensor(0.5), torch.randn(5)

    def loss(w):
        return torch.sum(f(w, x) ** 2)

    torch.func.grad(loss)(w)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.func.grad(torch.func.grad(loss))(w)
    wg = w.clone().requires_grad_(True)
    torch.autograd.grad(loss(wg), wg)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(loss(wg), wg, create_graph=True)


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
    """grad_shardings lays the stacked gradients out on a model mesh: the
    step refuses it outside one."""
    cfg = configs.get_config("minitron-4b").reduced()
    with pytest.raises(ValueError, match="meshctx.set_mesh"):
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
    # --scale pod is the dry run of one train_4k step of a rank of the
    # production mesh (tests/test_torch_dryrun.py traces it whole)
    from repro_torch.launch import dryrun
    seen = {}

    class Record:
        def to_dict(self):
            return {"shape": "train_4k"}

    def pair(arch, shape, **kw):
        seen.update(kw, arch=arch, shape=shape)
        return Record()

    monkeypatch.setattr(dryrun, "dryrun_pair", pair)
    pod = train_lib.parse_args(["--scale", "pod", "--multi-pod", "--rank",
                                "7", "--num-batches", "8"])
    assert train_lib.train(pod) == {"shape": "train_4k"}
    assert seen == dict(arch="minitron-4b", shape="train_4k",
                        multi_pod=True, rank=7, num_groups=8,
                        microbatches=1)
    assert train_lib.train_config("qwen2-72b", "pod") == \
        configs.get_config("qwen2-72b")
    monkeypatch.undo()
    args = train_lib.parse_args([])
    assert (args.scale, args.arch) == ("gpu", "h2o-danube-3-4b")
    assert train_lib.parse_args(["--scale", "cpu"]).arch == "minitron-4b"
    cfg = train_lib.train_config("h2o-danube-3-4b", "gpu")
    full = configs.get_config("h2o-danube-3-4b")
    assert cfg == full.with_(num_layers=2)
    assert cfg.remat    # the config's own remat, worker mode included
    assert cfg.param_count() == 555_417_600     # the reference's count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lib.train(args)


def test_build_cpu_batch_is_dense_only():
    """The dense, MoE, SSM and hybrid families' batches are the stream's
    (they need only tokens); the vlm batch (tokens cut to T - 16 patches,
    the patches) and the audio batch (T // 4 frames) are the reference's
    ``build_cpu_batch`` on the same stream and key: tokens exactly, the
    float32 stubs up to the ulps of torch's erfinv."""
    cfg = configs.get_config("minitron-4b").reduced()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=40,
                         global_batch=4, num_workers=2, device="cpu")
    assert train_lib.build_cpu_batch(cfg, stream, 0, None)["tokens"].shape \
        == (2, 2, 40)
    for arch in ("granite-moe-1b-a400m", "rwkv6-7b", "zamba2-2.7b"):
        other = configs.get_config(arch).reduced()
        batch = train_lib.build_cpu_batch(other, stream, 0, None)
        for name, leaf in stream.batch(0).items():
            assert torch.equal(batch[name], leaf)
    from repro.launch import train as jtrain
    jstream = JTokenStream(vocab_size=cfg.vocab_size, seq_len=40,
                           global_batch=4, num_workers=2)
    for arch, stub, shape in (("internvl2-26b", "patches", (2, 2, 16, 256)),
                              ("seamless-m4t-medium", "frames",
                               (2, 2, 10, 256))):
        other = configs.get_config(arch).reduced()
        key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
        want = jtrain.build_cpu_batch(jconfigs.get_config(arch).reduced(),
                                      jstream, 3, key)
        got = train_lib.build_cpu_batch(
            other, stream, 3, prng.fold_in(prng.PRNGKey(0, device="cpu"), 3))
        assert set(got) == set(want) == {"tokens", "labels", stub}
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        assert got["tokens"].shape[-1] == (24 if stub == "patches" else 40)
        assert got[stub].shape == shape and got[stub].dtype == torch.float32
        np.testing.assert_allclose(got[stub].numpy(), np.asarray(want[stub]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE family (Granite reduced: 2 layers, 4 experts of top-2)

MOE_ARCH = "granite-moe-1b-a400m"


def test_moe_run_rounds_lm_history_matches_jax():
    """Four rounds of reduced Granite through make_run_rounds (gmom under
    sign_flip with the rotating schedule, AdamW), per-round batches."""
    jcfg, cfg, jp, tp = _models(MOE_ARCH)
    jstream, tstream = _streams(cfg, 4, 8, seq=24)
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jrun = jrt.make_run_rounds(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                               joptim.adamw(LR), jrt.RobustConfig(**rc))
    trun = trt.make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg),
                               optim.adamw(LR), trt.RobustConfig(**rc),
                               device="cpu")
    jb = jax.tree.map(lambda *xs: jnp.stack(xs),
                      *[jstream.batch(i) for i in range(4)])
    tb = tree_map(lambda *xs: torch.stack(xs),
                  *[tstream.batch(i) for i in range(4)])
    jp2, *_, jm = jrun(jp, joptim.adamw(LR).init(jp), jb,
                       jax.random.PRNGKey(3), per_round_batches=True)
    tp2, *_, tm = trun(tp, optim.adamw(LR).init(tp), tb, prng.PRNGKey(3),
                       per_round_batches=True)
    assert compare_traces(_rows(tm), _rows(jm)) == []
    _close_leaves(jp2, tp2, 1e-4, STEP_ATOL)


def _recording(lib, inner):
    """``inner`` whose state also carries the last aggregated gradient the
    step handed it: ``(inner state, grads)``."""
    def update(grads, state, params):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)
    return lib.Optimizer(name=f"recording {inner.name}", update=update,
                         init=lambda params: (inner.init(params), None))


def test_moe_group_step_remat_keeps_the_aux_loss():
    """Under remat the block hands its router loss back beside h: the loss
    with grad recorded (checkpoint live) equals the loss without remat and
    includes the aux term; the group-mode step (two microbatches, so the
    capacity is a microbatch's) with remat gives the same numbers as
    without, and as the reference's step with remat: the metrics at rel
    1e-5, the first step's aggregated gradient at 1e-5 of each leaf's
    max|g|, the params after two AdamW steps at ``STEP_ATOL`` where the
    reference's aggregated gradient has |g| >= 100 eps in both steps.
    There AdamW's update lr g / (|g| + eps) has slope at most
    lr / (1e4 eps), so a gradient within 1e-5 max|g| (<= 3.2e-6 here)
    moves it by at most 0.032 lr (over 99 % of every leaf's coordinates
    are held so).  Below 100 eps it turns on the last
    bits of g: wo[0, 28, 14] has g = 1.61e-9 in the reference and
    -1.75e-9 in the port (an f32 sum order, 1e-7 of the leaf's max|g|),
    and their first updates differ by 0.287 lr."""
    jcfg, cfg, jp, tp = _models(MOE_ARCH)
    jstream, tstream = _streams(cfg, 4, 8, seq=16)
    b0 = {k: v[0] for k, v in tstream.batch(0).items()}
    losses = []
    for remat in (False, True):
        with torch.enable_grad():
            leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
            losses.append(model.loss_fn(leaves, b0, cfg.with_(remat=remat)))
    assert torch.equal(losses[0], losses[1])
    _, aux = model.forward(tp, cfg, b0)
    assert float(aux) > 0
    rc = dict(num_workers=4, num_byzantine=1, num_batches=4,
              aggregator="gmom", attack="sign_flip")
    jopt = _recording(joptim, joptim.adamw(LR))
    jstep = jsteps.make_group_train_step(
        jcfg.with_(remat=True), jrt.RobustConfig(**rc), jopt, microbatches=2)
    js = jopt.init(jp)
    jms, jaggs = [], []
    for t in range(2):
        jp, js, jm = jstep(jp, js, jstream.batch(t),
                           jax.random.PRNGKey(10 + t), t)
        jms.append(jm)
        jaggs.append(js[1])
    out = {}
    for remat in (False, True):
        topt = _recording(optim, optim.adamw(LR))
        tstep = steps.make_group_train_step(
            cfg.with_(remat=remat), trt.RobustConfig(**rc), topt,
            microbatches=2)
        tp_, ts = tp, topt.init(tp)
        for t in range(2):
            tp_, ts, tm = tstep(tp_, ts, tstream.batch(t),
                                prng.PRNGKey(10 + t), t)
            for name in jms[t]:
                assert float(tm[name]) == pytest.approx(
                    float(jms[t][name]), rel=1e-5), name
            if t == 0:
                _close_leaves(jaggs[0], ts[1], 1e-5)
        out[remat] = (tp_, tm)
        # coordinates away from eps (or at an exact 0: a token that is in
        # neither step's batch leaves its embedding row unmoved)
        conditioned = [
            ((np.abs(g0) >= 100 * 1e-8) | (g0 == 0))
            & ((np.abs(g1) >= 100 * 1e-8) | (g1 == 0))
            for (_, g0, _), (_, g1, _) in zip(_leaf_pairs(jaggs[0], ts[1]),
                                              _leaf_pairs(jaggs[1], ts[1]))]
        for (path, want, got), keep in zip(_leaf_pairs(jp, tp_),
                                           conditioned):
            assert keep.mean() > 0.99, path
            err = float(np.abs(got - want)[keep].max())
            assert err <= 1e-4 * float(np.abs(want).max()) + STEP_ATOL, \
                (path, err)
    for a, b in zip(jax.tree.leaves(out[False]), jax.tree.leaves(out[True])):
        assert torch.equal(a, b)


def test_bf16_moe_rounds_keep_the_router_f32(tmp_path):
    """A bf16 Granite config through two rounds of make_run_rounds (the
    per-worker gradients, sign_flip, the gmom round's f32 block and its
    split, AdamW, the update) and a checkpoint: the router leaf is
    float32 in the gradients, the params and after a restore, every other
    param bf16."""
    cfg = configs.get_config(MOE_ARCH).reduced().with_(
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = model.init(0, cfg, device="cpu")
    _, tstream = _streams(cfg, 4, 8, seq=16)
    grads, _ = trt.per_worker_grads(lambda p, b: model.loss_fn(p, b, cfg),
                                    params, tstream.batch(0))
    assert grads["layers"]["moe"]["router"].dtype == torch.float32
    assert grads["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    rc = trt.RobustConfig(num_workers=4, num_byzantine=1, num_batches=4,
                          aggregator="gmom", attack="sign_flip")
    opt = optim.adamw(LR)
    run = trt.make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg), opt,
                              rc, device="cpu")
    state = tts.init_train_state(params, opt.init(params), prng.PRNGKey(2))
    state, _ = tts.advance(run, state, tree_map(
        lambda *xs: torch.stack(xs), *[tstream.batch(i) for i in range(2)]),
        per_round_batches=True)
    assert np.isfinite(state.history["loss_median"]).all()

    def dtypes(tree):
        return {k: v.dtype for k, v in tree["layers"]["moe"].items()}

    want = {"router": torch.float32, "w_gate": torch.bfloat16,
            "w_up": torch.bfloat16, "w_down": torch.bfloat16}
    assert dtypes(state.params) == want
    assert not torch.equal(state.params["layers"]["moe"]["router"],
                           params["layers"]["moe"]["router"])
    tts.save_train_state(str(tmp_path), state)
    back = tts.restore_train_state(str(tmp_path), 2, params,
                                   opt.init(params))
    assert dtypes(back.params) == want
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(back.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_moe_train_driver_resume_bit_identical(tmp_path):
    """launch/train.py on reduced Granite, interrupted at round 3 and
    resumed: the exact uninterrupted history."""
    kw = dict(arch=MOE_ARCH, steps=5, seq_len=12)
    straight = train_lib.train(_args(**kw))
    ckpt = str(tmp_path / "ckpt")
    train_lib.train(_args(**dict(kw, steps=3), ckpt_dir=ckpt))
    resumed = train_lib.train(_args(**kw, ckpt_dir=ckpt))
    assert resumed["resumed_from"] == 3
    assert resumed["history"] == straight["history"]
    assert np.isfinite(straight["final_loss"])


def test_moe_train_config_fits_the_card():
    """The depth rule keeps the recorded cut: Granite at 8 of its 24
    layers (P = 528.8 M, 58.7 GB reckoned; 9 layers would reckon 64.6 GB);
    an architecture whose embeddings alone pass the budget raises."""
    cfg = train_lib.train_config(MOE_ARCH, "gpu")
    full = configs.get_config(MOE_ARCH)
    assert cfg == full.with_(num_layers=8)
    assert cfg.param_count() == 528_750_592     # the reference's count
    nine = full.with_(num_layers=9).param_count()
    assert train_lib.GPU_TRAIN_BYTES_PER_PARAM * nine \
        > train_lib.GPU_TRAIN_BUDGET_BYTES
    for arch in ("minitron-4b", "qwen3-14b", "qwen2-72b", "kimi-k2-1t-a32b"):
        with pytest.raises(NotImplementedError, match="item 16.13"):
            train_lib.train_config(arch, "gpu")


def test_gpu_train_layers_rule():
    """The most layers that fit, up to the config's own depth."""
    cfg = configs.get_config("h2o-danube-3-4b")
    per = train_lib.GPU_TRAIN_BYTES_PER_PARAM
    budget = train_lib.GPU_TRAIN_BUDGET_BYTES
    assert train_lib.gpu_train_layers(cfg) == 2
    assert per * cfg.with_(num_layers=3).param_count() > budget
    small = configs.get_config(MOE_ARCH).with_(num_layers=4)
    assert train_lib.gpu_train_layers(small) == 4


def test_gpu_train_layers_keeps_whole_hybrid_groups():
    """Zamba2 trains at 6 layers, one group (507.8 M parameters, 56.4 GB
    reckoned; 7 layers would fit the budget but not _hybrid_shape, and 12
    do not fit); RWKV6 at one layer reckons 83.8 GB and raises."""
    cfg = train_lib.train_config("zamba2-2.7b", "gpu")
    full = configs.get_config("zamba2-2.7b")
    assert cfg == full.with_(num_layers=6)
    assert cfg.param_count() == 507_822_080
    assert model._hybrid_shape(cfg) == (1, 6)
    per = train_lib.GPU_TRAIN_BYTES_PER_PARAM
    assert per * full.with_(num_layers=12).param_count() \
        > train_lib.GPU_TRAIN_BUDGET_BYTES
    with pytest.raises(NotImplementedError, match="item 16.13"):
        train_lib.train_config("rwkv6-7b", "gpu")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_recurrent_group_step_remat_changes_no_number(arch):
    """The group-mode step (plain autograd) on reduced Zamba2 and RWKV6:
    remat on and off give the same params and metrics bit for bit."""
    cfg = configs.get_config(arch).reduced()
    tp = model.init(0, cfg, device="cpu")
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


def test_hybrid_train_driver_resume_bit_identical(tmp_path):
    """launch/train.py on reduced Zamba2, interrupted at round 2
    and resumed: the exact uninterrupted history."""
    kw = dict(arch="zamba2-2.7b", steps=3, seq_len=16)
    straight = train_lib.train(_args(**kw))
    ckpt = str(tmp_path / "ckpt")
    train_lib.train(_args(**dict(kw, steps=2), ckpt_dir=ckpt, ckpt_every=2))
    resumed = train_lib.train(_args(**kw, ckpt_dir=ckpt, ckpt_every=2))
    assert resumed["resumed_from"] == 2
    assert resumed["history"] == straight["history"]
    assert np.isfinite(straight["final_loss"])
