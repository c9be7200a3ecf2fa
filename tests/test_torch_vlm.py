"""The port's vlm family (InternVL2's decoder with the vision encoder's
patch embeddings as a prefix: models.model's concat and slice,
data.tokens.patch_embeddings, launch.train's vlm batches and depth)
against the JAX package's.

Inputs come from numpy seeds; the reference's params are handed across
with ``convert.lm_params_from_numpy``, and both sides run in float32
(internvl2-26b reduced: 2 layers, 256 wide, 4/2 heads of 64, 16
patches).  Tolerances: hidden states and logits at rtol 1e-4 of max|y|
(float32 matmuls summed in other orders), the loss at rel 1e-5,
``per_worker_grads`` at 1e-4 of each leaf's max|g|, histories under
``compare_traces`` (rtol 1e-3, atol 1e-6).  The CUDA path runs only on
a card: tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import robust_train as jrt
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import configs, convert, optim
from repro_torch import random as prng
from repro_torch.core import robust_train as trt
from repro_torch.data import tokens
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import attention, model
from repro_torch.sim.goldens import compare_traces
from torch_lm_parity import (  # noqa: F401
    _close, _one_thread, _rows, _t, _threefry_original, _tokens, _x,
    reduced_models)

ARCH = "internvl2-26b"
LR = 1e-3


@pytest.fixture(scope="module")
def lm():
    return reduced_models(ARCH)


def _batch(cfg, B, T, seed, labels=False, patches=None):
    P = cfg.num_patches if patches is None else patches
    out = {"tokens": _tokens(cfg, (B, T), seed),
           "patches": _x((B, P, cfg.d_model), seed + 1)}
    if labels:
        out["labels"] = _tokens(cfg, (B, T), seed + 2)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# configs

def test_config_and_param_count_equal_the_reference():
    mine, ref_cfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    for cfg, jcfg in ((mine, ref_cfg), (mine.reduced(), ref_cfg.reduced())):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        for key in ("dtype", "param_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        assert a == b
        assert cfg.param_count() == jcfg.param_count()
    assert (mine.num_layers, mine.d_model, mine.num_heads,
            mine.num_kv_heads, mine.head_dim, mine.d_ff, mine.vocab_size,
            mine.num_patches, mine.frontend) == \
        (48, 6144, 48, 8, 128, 16384, 92553, 256, "vision")
    # 19.86 G parameters: 39.7 GB of bf16 weights
    assert mine.param_count() == 19_860_664_320
    assert mine.reduced().num_patches == 16


def test_gpu_train_layers_refuses_naming_the_model_mesh():
    """One layer of InternVL2 reckons 169.5 GB a round: --scale gpu
    raises, naming item 16.13 (several cards), as RWKV6's does."""
    full = configs.get_config(ARCH)
    one = full.with_(num_layers=1).param_count()
    assert train_lib.GPU_TRAIN_BYTES_PER_PARAM * one / 1e9 == \
        pytest.approx(169.5, abs=0.05)
    with pytest.raises(NotImplementedError, match="item 16.13"):
        train_lib.gpu_train_layers(full)
    with pytest.raises(NotImplementedError, match="169.5 GB"):
        train_lib.train_config(ARCH, "gpu")


# ---------------------------------------------------------------------------
# the reduced model

def test_params_cross_leaf_for_leaf(lm):
    jcfg, cfg, jp, tp = lm
    mine = model.init(0, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, other = tp, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(other.shape), path
        assert node.dtype == other.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(jax.tree.leaves(mine)) == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("T", [48, 20])
def test_forward_logits_and_prefill_match_jax(lm, T):
    """16 patches ahead of T tokens; the hidden states of the text
    positions alone come back."""
    jcfg, cfg, jp, tp = lm
    jb, tb = _both(_batch(cfg, 2, T, T))
    jh, _ = jmodel.forward(jp, jcfg, jb)
    h, aux = model.forward(tp, cfg, tb)
    assert h.shape == (2, T, cfg.d_model) and float(aux) == 0.0
    _close(h, jh)
    _close(model.logits(tp, cfg, tb), jmodel.logits(jp, jcfg, jb))
    _close(steps.make_prefill_step(cfg)(tp, tb),
           jmodel.prefill(jp, jcfg, jb))
    # the patches shape the text: other patches, other hidden states
    other = dict(tb, patches=tb["patches"] + 1.0)
    assert not torch.allclose(model.prefill(tp, cfg, other), h)


def test_blocked_prefill_above_the_threshold_matches_jax():
    """16 patches + 2040 tokens = 2056 positions: past
    BLOCKED_ATTENTION_THRESHOLD the plain path takes the blocked core, as
    the reference does; one layer."""
    jcfg, cfg, jp, tp = reduced_models(ARCH, seed=9, num_layers=1)
    T = attention.BLOCKED_ATTENTION_THRESHOLD - 8
    jb, tb = _both(_batch(cfg, 1, T, 7))
    _close(model.prefill(tp, cfg, tb), jmodel.prefill(jp, jcfg, jb))


def test_loss_matches_jax(lm):
    jcfg, cfg, jp, tp = lm
    jb, tb = _both(_batch(cfg, 2, 32, 3, labels=True))
    want = float(jmodel.loss_fn(jp, jb, jcfg))
    assert float(model.loss_fn(tp, tb, cfg)) == pytest.approx(want,
                                                              rel=1e-5)


def test_decode_matches_jax_and_the_text_prefill(lm):
    """The decode state is the dense one (no memory); 20 text tokens
    through decode steps against the reference's, and the last logits
    against the prefill of the same tokens behind an empty patch prefix
    (the reference's serve path decodes text alone)."""
    jcfg, cfg, jp, tp = lm
    B, T = 2, 20
    toks = _tokens(cfg, (B, T), 11)
    jstate = jmodel.init_decode_state(jcfg, B, T)
    state = model.init_decode_state(cfg, B, T, device="cpu")
    assert set(state) == set(jstate) == {"cache"}
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        jl, jstate = jmodel.decode_step(jp, jcfg, jstate,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.asarray(pos))
        tl, state = model.decode_step(tp, cfg, state, _t(toks[:, t:t + 1]),
                                      _t(pos))
        _close(tl, jl)
    crossed = convert.decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    for name in ("k", "v"):
        _close(state["cache"]["self"][name], crossed["cache"]["self"][name])
    empty = {"tokens": _t(toks), "patches": torch.zeros(B, 0, cfg.d_model)}
    h = model.prefill(tp, cfg, empty)
    _close(tl, model._unembed_fn(tp, cfg)(h[:, -1:]).numpy())


def test_per_worker_grads_match_jax(lm):
    """m = 2 workers of 2 sequences of 16 patches and 24 tokens."""
    jcfg, cfg, jp, tp = lm
    kw = dict(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4,
              num_workers=2, seed=0)
    jb = dict(jtokens.TokenStream(**kw).batch(0),
              patches=jnp.asarray(_x((2, 2, 16, cfg.d_model), 5)))
    tb = {k: _t(v) for k, v in jb.items()}
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, jb)
    tg, tl = trt.per_worker_grads(lambda p, b: model.loss_fn(p, b, cfg), tp,
                                  tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tg
        for key in path:
            node = node[key.key]
        _close(node, leaf)


def test_group_step_splits_the_patches_into_microbatches(lm):
    jcfg, cfg, jp, tp = lm
    k = 2
    batch = {"tokens": _tokens(cfg, (k, 4, 12), 20),
             "labels": _tokens(cfg, (k, 4, 12), 21),
             "patches": _x((k, 4, 16, cfg.d_model), 22)}
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


# ---------------------------------------------------------------------------
# data and launch/train.py

def test_patch_embeddings_shape_dtype_and_values():
    key = prng.fold_in(prng.PRNGKey(4, device="cpu"), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(4), 2)
    kw = dict(num_workers=3, per_worker=2, num_patches=16, d_model=8)
    got = tokens.patch_embeddings(key, **kw)
    assert got.shape == (3, 2, 16, 8) and got.dtype == torch.bfloat16
    f32 = tokens.patch_embeddings(key, **kw, dtype=torch.float32)
    want = jtokens.patch_embeddings(jkey, **kw, dtype=jnp.float32)
    np.testing.assert_allclose(f32.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_run_rounds_history_matches_jax(lm):
    """Three rounds of launch/train.py's path (make_run_rounds, gmom
    under sign_flip, AdamW) on each side's own ``build_cpu_batch`` (24 of
    40 token positions after 16 patches drawn on the same keys), from the
    same params."""
    jcfg, cfg, jp, tp = lm
    m = 4
    kw = dict(vocab_size=cfg.vocab_size, seq_len=40, global_batch=8,
              num_workers=m, seed=0)
    jstream = jtokens.TokenStream(**kw)
    tstream = tokens.TokenStream(**kw, device="cpu")
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, device="cpu")
    jb = [jtrain.build_cpu_batch(jcfg, jstream, i,
                                 jax.random.fold_in(jkey, i))
          for i in range(3)]
    tb = [train_lib.build_cpu_batch(cfg, tstream, i, prng.fold_in(tkey, i))
          for i in range(3)]
    assert tb[0]["tokens"].shape == (m, 2, 24)
    assert tb[0]["patches"].shape == (m, 2, 16, cfg.d_model)
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


def test_entry_points_want_the_card_by_default():
    """``device=None`` means the CUDA card: the entry points raise here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    cfg = configs.get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_state(cfg, 1, 8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH])
