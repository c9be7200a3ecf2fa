"""The port's Mamba2 block and the Zamba2 hybrid (repro_torch.models.mamba,
the hybrid stack of models.model) against the JAX package's
(repro.models.mamba, model).

Inputs come from numpy seeds; the reference's params are handed across
as numpy arrays (``convert.lm_params_from_numpy`` for the model), and the
reference runs in float32.  Tolerances:

* ``_causal_conv``, ``_ssd_chunked``, ``apply``, ``decode_step``:
  outputs and carried states at rtol 1e-5 of max|out| (float32 products
  and matmuls summed in other orders);
* the model (reduced zamba2-2.7b: 2 Mamba2 blocks in one group behind the
  shared block, 256 wide, SSM state 16, heads of 32): hidden states and
  decode logits at 1e-4 of max|out|, the loss at rel 1e-5,
  ``per_worker_grads`` at 1e-4 of each leaf's max|g| (the dense LM's
  tolerances, tests/test_torch_models.py and test_torch_train.py).

The CUDA path runs only on a card: tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import robust_train as jrt
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import blocks as jblocks
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.core import robust_train as trt
from repro_torch.data.tokens import TokenStream
from repro_torch.models import blocks, mamba, model

ARCH = "zamba2-2.7b"
MODULE_RTOL = 1e-5
MODEL_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _close(got, want, rtol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _t(x):
    return torch.as_tensor(np.array(x))


SPEC = dict(d_model=32, d_state=8, head_dim=8, chunk=8)


def _specs(**kw):
    kw = {**SPEC, **kw}
    return jmamba.MambaSpec(**kw), mamba.MambaSpec(**kw)


def _params(jspec, seed=0):
    jp = jmamba.init(jax.random.PRNGKey(seed), jspec, dtype=jnp.float32)
    # A_log, dt_bias and D away from their constant inits, so each enters
    jp = dict(jp, A_log=jnp.asarray(_x(jp["A_log"].shape, seed + 50, 0.5)),
              dt_bias=jnp.asarray(_x(jp["dt_bias"].shape, seed + 51, 0.5)
                                  - 2.0),
              D=jnp.asarray(_x(jp["D"].shape, seed + 52)))
    return jp, jax.tree.map(_t, jp)


# ---------------------------------------------------------------------------
# the causal conv

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax_and_its_decode(carried):
    """A sequence at once against the reference, and against the same
    sequence a token at a time, each step from the last one's state."""
    x, w, b = _x((2, 12, 6), 1), _x((4, 6), 2, 0.3), _x((6,), 3, 0.1)
    state = _x((2, 3, 6), 4) if carried else None
    y, s = mamba._causal_conv(_t(x), _t(w), _t(b),
                              state=None if state is None else _t(state))
    jy, js = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), state=None if state is None
                                 else jnp.asarray(state))
    _close(y, jy, MODULE_RTOL)
    _close(s, js, MODULE_RTOL)
    st = torch.zeros(2, 3, 6) if state is None else _t(state)
    steps = []
    for t in range(12):
        yt, st = mamba._causal_conv(_t(x[:, t:t + 1]), _t(w), _t(b),
                                    state=st)
        steps.append(yt)
    _close(torch.cat(steps, dim=1), y.numpy(), MODULE_RTOL)
    _close(st, s.numpy(), MODULE_RTOL)


# ---------------------------------------------------------------------------
# the chunked SSD

@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_jax(chunk, carried):
    jspec, spec = _specs(chunk=chunk)
    B, T, H, P, N = 2, 32, 3, 4, 5
    x = _x((B, T, H, P), 10)
    dt = np.log1p(np.exp(_x((B, T, H), 11))).astype(np.float32)
    A = np.exp(_x((H,), 12, 0.5)).astype(np.float32)
    Bm, Cm = _x((B, T, N), 13), _x((B, T, N), 14)
    init = _x((B, H, P, N), 15) if carried else None
    y, S = mamba._ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), spec,
                              init_state=None if init is None else _t(init))
    jy, jS = jmamba._ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), jspec,
        init_state=None if init is None else jnp.asarray(init))
    assert y.dtype == S.dtype == torch.float32
    _close(y, jy, MODULE_RTOL)
    _close(S, jS, MODULE_RTOL)


def test_ssd_chunked_refuses_a_ragged_length():
    _, spec = _specs(chunk=8)
    with pytest.raises(ValueError, match="divisible"):
        mamba._ssd_chunked(torch.zeros(1, 12, 1, 2), torch.zeros(1, 12, 1),
                           torch.ones(1), torch.zeros(1, 12, 2),
                           torch.zeros(1, 12, 2), spec)


def test_softplus_is_logaddexp():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 20.0, 25.0, 80.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(mamba._softplus(x).numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the block

@pytest.mark.parametrize("carried", [False, True])
def test_apply_matches_jax(carried):
    jspec, spec = _specs()
    jp, tp = _params(jspec, 1)
    x = _x((2, 16, 32), 20)
    kw, jkw = {}, {}
    if carried:
        conv = {"x": _x((2, 3, 64), 21), "B": _x((2, 3, 8), 22),
                "C": _x((2, 3, 8), 23)}
        ssm = _x((2, 8, 8, 8), 24, 0.3)
        kw = {"conv_state": {k: _t(v) for k, v in conv.items()},
              "ssm_state": _t(ssm)}
        jkw = {"conv_state": {k: jnp.asarray(v) for k, v in conv.items()},
               "ssm_state": jnp.asarray(ssm)}
    out, (conv_new, ssm_new) = mamba.apply(tp, spec, _t(x), **kw)
    jout, (jconv, jssm) = jmamba.apply(jp, jspec, jnp.asarray(x), **jkw)
    _close(out, jout, MODULE_RTOL)
    _close(ssm_new, jssm, MODULE_RTOL)
    for name in ("x", "B", "C"):
        _close(conv_new[name], jconv[name], MODULE_RTOL)


def test_decode_step_matches_jax_and_apply():
    """Eight tokens through ``decode_step`` against the reference's steps,
    and against ``apply`` over the same eight."""
    jspec, spec = _specs()
    jp, tp = _params(jspec, 2)
    x = _x((2, 8, 32), 30)
    conv, ssm = mamba.init_states(spec, 2, dtype=torch.float32)
    jconv, jssm = jmamba.init_states(jspec, 2, dtype=jnp.float32)
    outs = []
    for t in range(8):
        out, (conv, ssm) = mamba.decode_step(tp, spec, _t(x[:, t:t + 1]),
                                             conv, ssm)
        jout, (jconv, jssm) = jmamba.decode_step(
            jp, jspec, jnp.asarray(x[:, t:t + 1]), jconv, jssm)
        _close(out, jout, MODULE_RTOL)
        outs.append(out)
    _close(ssm, jssm, MODULE_RTOL)
    full, (_, ssm_full) = mamba.apply(tp, spec, _t(x))
    _close(torch.cat(outs, dim=1), full.numpy(), MODULE_RTOL)
    _close(ssm, ssm_full.numpy(), MODULE_RTOL)


def test_init_keeps_the_ssm_scalars_f32():
    _, spec = _specs()
    p = mamba.init(torch.Generator().manual_seed(0), spec,
                   dtype=torch.bfloat16, stack=(2, 3))
    for name, leaf in p.items():
        leaf = leaf["scale"] if name == "norm" else leaf
        want = torch.float32 if name in ("A_log", "dt_bias", "D") \
            else torch.bfloat16
        assert leaf.dtype == want and leaf.shape[:2] == (2, 3), name
    conv, ssm = mamba.init_states(spec, 4, dtype=torch.bfloat16,
                                  stack=(2, 3))
    assert ssm.dtype == torch.float32 and ssm.shape == (2, 3, 4, 8, 8, 8)
    assert conv["x"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the model (reduced zamba2-2.7b)

@pytest.fixture(scope="module")
def lm():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        jcfg = jconfigs.get_config(ARCH).reduced()
        cfg = configs.get_config(ARCH).reduced()
        jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
        tp = convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), "cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return jcfg, cfg, jp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def test_param_counts_equal_the_reference():
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == jconfigs.get_config(ARCH).param_count() \
        == 2_420_817_920
    assert cfg.reduced().param_count() == \
        jconfigs.get_config(ARCH).reduced().param_count()


def test_config_and_spec_equal_the_reference():
    for cfg, jcfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                      (configs.get_config(ARCH).reduced(),
                       jconfigs.get_config(ARCH).reduced())):
        assert dataclasses.asdict(blocks.mamba_spec(cfg)) == \
            dataclasses.asdict(jblocks.mamba_spec(jcfg))
        assert (cfg.shared_attn_every, cfg.ssm_chunk, cfg.ssm_state) == \
            (jcfg.shared_attn_every, jcfg.ssm_chunk, jcfg.ssm_state)
        assert model._hybrid_shape(cfg) == jmodel._hybrid_shape(jcfg)
    with pytest.raises(ValueError, match="divisible"):
        model._hybrid_shape(configs.get_config(ARCH).with_(num_layers=7))


def test_params_cross_leaf_for_leaf(lm):
    """Every leaf of the reference's layout, in its own dtype: Mamba2's
    A_log, dt_bias and D stay float32 in a bf16 config."""
    jcfg, cfg, jp, tp = lm
    mine = model.init(0, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, other = tp, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(other.shape), path
    bf = cfg.with_(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jbf = jcfg.with_(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    back = convert.lm_params_from_numpy(
        bf, jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                 jbf)), "cpu")
    mine = model.init(0, bf, device="cpu")
    for tree in (back, mine):
        for name, leaf in tree["mamba"].items():
            leaf = leaf["scale"] if isinstance(leaf, dict) else leaf
            want = torch.float32 if name in ("A_log", "dt_bias", "D") \
                else torch.bfloat16
            assert leaf.dtype == want, name
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params_from_numpy(cfg.with_(ssm_state=8),
                                     jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("T", [32, 8])
def test_forward_matches_jax(lm, T):
    """Two SSD chunks of 16, and one chunk of 8."""
    jcfg, cfg, jp, tp = lm
    tokens = _tokens(cfg, (2, T), T)
    jh, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    h, aux = model.forward(tp, cfg, {"tokens": _t(tokens)})
    assert float(aux) == 0.0
    _close(h, jh, MODEL_RTOL)
    with pytest.raises(NotImplementedError, match="decode path"):
        model._run_hybrid_stack(tp, cfg, torch.zeros(1, 8, cfg.d_model),
                                plain=True, states={})


def test_loss_matches_jax(lm):
    jcfg, cfg, jp, tp = lm
    batch = {"tokens": _tokens(cfg, (2, 32), 1),
             "labels": _tokens(cfg, (2, 32), 2)}
    want = float(jmodel.loss_fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg))
    got = float(model.loss_fn(tp, {k: _t(v) for k, v in batch.items()},
                              cfg))
    assert got == pytest.approx(want, rel=1e-5)


def test_decode_matches_jax_and_the_prefill(lm):
    """Eight tokens through decode steps (conv, SSM and KV states updated
    in place) against the reference's decode steps, and the last logits
    against the port's full-sequence forward."""
    jcfg, cfg, jp, tp = lm
    tokens = _tokens(cfg, (2, 8), 5)
    jstate = jmodel.init_decode_state(jcfg, 2, 8)
    state = model.init_decode_state(cfg, 2, 8, device="cpu")
    back = convert.decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert state["ssm"].dtype == torch.float32
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        jlogits, jstate = jmodel.decode_step(
            jp, jcfg, jstate, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos))
        logits, state = model.decode_step(tp, cfg, state,
                                          _t(tokens[:, t:t + 1]),
                                          _t(pos).long())
        _close(logits, jlogits, MODEL_RTOL)
    _close(state["ssm"], jstate["ssm"], MODEL_RTOL)
    h, _ = model.forward(tp, cfg.with_(ssm_chunk=8), {"tokens": _t(tokens)})
    full = model._unembed_fn(tp, cfg)(h[:, -1:])
    _close(logits, full.numpy(), MODEL_RTOL)


def test_per_worker_grads_match_jax(lm):
    """m = 2 workers of 2 sequences of 32 tokens (two SSD chunks); the
    shared block's params get the gradient of every application."""
    jcfg, cfg, jp, tp = lm
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
              num_workers=2, seed=0)
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, JTokenStream(**kw).batch(0))
    tg, tl = trt.per_worker_grads(lambda p, b: model.loss_fn(p, b, cfg), tp,
                                  TokenStream(**kw, device="cpu").batch(0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tg
        for key in path:
            node = node[key.key]
        _close(node, leaf, MODEL_RTOL)


def test_ssd_gradient_stays_finite_past_exp_overflow():
    """dt_bias of 5 makes a chunk's decay sum pass float32's exp range:
    the reference's gradient (exp of every difference, masked after) is
    NaN for w_dt, A_log and dt_bias; the port's (masked in the exponent)
    is finite, and its output equals the reference's."""
    spec_kw = dict(d_model=16, d_state=4, head_dim=8, chunk=32)
    jspec, spec = jmamba.MambaSpec(**spec_kw), mamba.MambaSpec(**spec_kw)
    jp = jmamba.init(jax.random.PRNGKey(0), jspec, dtype=jnp.float32)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 5.0))
    x = _x((1, 32, 16), 60)
    jg = jax.grad(lambda p: jnp.sum(
        jmamba.apply(p, jspec, jnp.asarray(x))[0]))(jp)
    assert bool(jnp.isnan(jg["dt_bias"]).any())
    tp = jax.tree.map(lambda a: _t(a).requires_grad_(True), jp)
    out, _ = mamba.apply(tp, spec, _t(x))
    _close(out, jmamba.apply(jp, jspec, jnp.asarray(x))[0], MODULE_RTOL)
    out.sum().backward()
    for name, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        assert bool(torch.isfinite(leaf.grad).all()), name
    for name in ("w_x", "w_out", "conv_x"):
        _close(tp[name].grad, jg[name], MODULE_RTOL)
