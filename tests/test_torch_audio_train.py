"""The port's audio family in training (reduced SeamlessM4T: 2 encoder
and 2 decoder layers, 256 wide) against the JAX package's: per-worker
gradients through every decoder layer's cross-attention into the
encoder, remat changing no number, the group step's microbatches of the
frames, launch/train.py's audio depth rule, the train rounds' history on
launch/train.py's batches and its resume.

Tolerances: ``per_worker_grads`` at 1e-4 of each leaf's max|g| and the
losses at rel 1e-5; histories under ``compare_traces`` (rtol 1e-3, atol
1e-6); remat and resume bit for bit."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro import optim as joptim
from repro.core import robust_train as jrt
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import configs, optim
from repro_torch import random as prng
from repro_torch.core import robust_train as trt
from repro_torch.data import tokens
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import model
from repro_torch.sim.goldens import compare_traces
from torch_lm_parity import (  # noqa: F401
    _close, _one_thread, _rows, _t, _threefry_original, _tokens, _x,
    reduced_models)

ARCH = "seamless-m4t-medium"
LR = 1e-3


@pytest.fixture(scope="module")
def lm():
    return reduced_models(ARCH)


def test_per_worker_grads_through_the_encoder_match_jax(lm):
    """m = 2 workers of 2 sequences of 32 tokens and 8 frames: gradients
    reach the encoder through every decoder layer's cross-attention; with
    remat on, the port's are torch.equal to remat off (the memory is an
    argument of the remat'd block, not closed over)."""
    jcfg, cfg, jp, tp = lm
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
              num_workers=2, seed=0)
    jb = dict(jtokens.TokenStream(**kw).batch(0),
              frames=jnp.asarray(_x((2, 2, 8, cfg.d_model), 60)))
    tb = {k: _t(v) for k, v in jb.items()}
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, jb)
    runs = []
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        runs.append(trt.per_worker_grads(
            lambda p, b: model.loss_fn(p, b, c), tp, tb))
    tg, tl = runs[0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tg
        for key in path:
            node = node[key.key]
        _close(node, leaf)
    assert float(tg["encoder"]["attn"]["wq"].abs().max()) > 0
    for a, b in zip(jax.tree.leaves(runs[0]), jax.tree.leaves(runs[1])):
        assert torch.equal(a, b)


def test_group_step_splits_the_frames_into_microbatches(lm):
    """The group-mode step with 2 microbatches: every leaf of a group's
    batch, the frames included, is split as the reference splits it."""
    jcfg, cfg, jp, tp = lm
    k = 2
    batch = {"tokens": _tokens(cfg, (k, 4, 16), 70),
             "labels": _tokens(cfg, (k, 4, 16), 71),
             "frames": _x((k, 4, 4, cfg.d_model), 72)}
    rc = dict(num_workers=k, num_byzantine=0, num_batches=k,
              aggregator="mean", attack="none")
    jstep = jsteps.make_group_train_step(jcfg, jrt.RobustConfig(**rc),
                                         joptim.sgd(0.1), microbatches=2)
    tstep = steps.make_group_train_step(cfg, trt.RobustConfig(**rc),
                                        optim.sgd(0.1), microbatches=2)
    jp2, _, jm = jstep(jp, joptim.sgd(0.1).init(jp),
                       {n: jnp.asarray(v) for n, v in batch.items()},
                       jax.random.PRNGKey(0), 0)
    tp2, _, tm = tstep(tp, optim.sgd(0.1).init(tp),
                       {n: _t(v) for n, v in batch.items()},
                       prng.PRNGKey(0, device="cpu"), 0)
    for name in ("loss_mean", "agg_grad_norm"):
        assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp2)[0]:
        node = tp2
        for key in path:
            node = node[key.key]
        _close(node, leaf)


def test_gpu_train_layers_cuts_encoder_and_decoder_together():
    """One common depth n <= min(encoder, decoder layers): the reference's
    count reckons n = 1 at 62.43 GB and n = 2 at 66.62 GB against the 64
    GB budget, so the card's scale trains 1 + 1 layers."""
    full = configs.get_config(ARCH)
    assert train_lib.gpu_train_layers(full) == 1
    cfg = train_lib.train_config(ARCH, "gpu")
    assert cfg == full.with_(num_layers=1, encoder_layers=1)
    per = train_lib.GPU_TRAIN_BYTES_PER_PARAM
    assert per * cfg.param_count() == 62_432_907_264
    two = full.with_(num_layers=2, encoder_layers=2)
    assert per * two.param_count() == 66_623_016_960
    # the common count never passes the smaller stack
    small = full.with_(vocab_size=512, encoder_layers=3)
    assert train_lib.gpu_train_layers(small) == 3


def test_run_rounds_history_matches_jax(lm):
    """Three rounds of launch/train.py's path (make_run_rounds, gmom
    under sign_flip, AdamW) on each side's own ``build_cpu_batch`` (the
    frames drawn on the same keys), from the same params."""
    jcfg, cfg, jp, tp = lm
    m, seq = 4, 16
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=8,
              num_workers=m, seed=0)
    jstream = jtokens.TokenStream(**kw)
    tstream = tokens.TokenStream(**kw, device="cpu")
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, device="cpu")
    jb = [jtrain.build_cpu_batch(jcfg, jstream, i,
                                 jax.random.fold_in(jkey, i))
          for i in range(3)]
    tb = [train_lib.build_cpu_batch(cfg, tstream, i, prng.fold_in(tkey, i))
          for i in range(3)]
    assert tb[0]["frames"].shape == (m, 2, seq // 4, cfg.d_model)
    rc = dict(num_workers=m, num_byzantine=1, num_batches=m,
              aggregator="gmom", attack="sign_flip")
    jrun = jrt.make_run_rounds(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                               joptim.adamw(LR), jrt.RobustConfig(**rc))
    trun = trt.make_run_rounds(lambda p, b: model.loss_fn(p, b, cfg),
                               optim.adamw(LR), trt.RobustConfig(**rc),
                               device="cpu")
    *_, jm = jrun(jp, joptim.adamw(LR).init(jp),
                  jax.tree.map(lambda *xs: jnp.stack(xs), *jb),
                  jax.random.PRNGKey(3), per_round_batches=True)
    *_, tm = trun(tp, optim.adamw(LR).init(tp),
                  tree_map(lambda *xs: torch.stack(xs), *tb),
                  prng.PRNGKey(3), per_round_batches=True)
    assert compare_traces(_rows(tm), _rows(jm)) == []


def test_train_runs_and_resumes(tmp_path):
    """launch/train.py on reduced SeamlessM4T: finite history, and
    interrupted at round 1 and resumed, the exact uninterrupted one."""
    base = dict(scale="cpu", arch=ARCH, steps=2, workers=4, byzantine=1,
                num_batches=4, attack="sign_flip", schedule=None,
                scan_chunk=2, round_backend="auto", aggregator="gmom",
                arrival="all_sync", staleness_bound=0, batch=8, seq_len=16,
                lr=LR, seed=0, log_every=100, ckpt_dir=None, ckpt_every=1,
                out=None)
    straight = train_lib.train(types.SimpleNamespace(**base))
    assert np.isfinite(straight["final_loss"])
    ckpt = str(tmp_path / "ckpt")
    train_lib.train(types.SimpleNamespace(**dict(base, steps=1,
                                                 ckpt_dir=ckpt)))
    resumed = train_lib.train(types.SimpleNamespace(**dict(
        base, ckpt_dir=ckpt)))
    assert resumed["resumed_from"] == 1
    assert resumed["history"] == straight["history"]


def test_group_step_remat_changes_no_number(lm):
    """The group-mode step (plain autograd) on reduced SeamlessM4T: remat
    on and off give the same params and metrics bit for bit, the
    encoder's gradients (summed over the decoder layers' cross-attention)
    included."""
    _, cfg, _, tp = lm
    batch = {"tokens": _t(_tokens(cfg, (2, 2, 16), 80)),
             "labels": _t(_tokens(cfg, (2, 2, 16), 81)),
             "frames": _t(_x((2, 2, 4, cfg.d_model), 82))}
    rc = trt.RobustConfig(num_workers=2, num_batches=2, aggregator="mean")
    out = []
    for remat in (False, True):
        step = steps.make_group_train_step(cfg.with_(remat=remat), rc,
                                           optim.sgd(0.1))
        p, _, m = step(tp, optim.sgd(0.1).init(tp), batch,
                       prng.PRNGKey(0, device="cpu"), 0)
        out.append((p, m))
    for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(out[1])):
        assert torch.equal(a, b)
