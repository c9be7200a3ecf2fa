"""The port's RWKV6 family (repro_torch.models.rwkv, the ssm stack of
models.model) against the JAX package's (repro.models.rwkv, model).

Inputs come from numpy seeds; the reference's params are handed across
as numpy arrays (``convert.lm_params_from_numpy`` for the model), and the
reference runs in float32.  Tolerances:

* ``wkv_scan``, ``wkv_chunked``, ``time_mix``, ``channel_mix``: outputs
  and carried states at rtol 1e-5 of max|out| (float32 products and
  matmuls summed in other orders);
* the model (reduced rwkv6-7b: 2 layers, 256 wide, heads of 32): hidden
  states and decode logits at 1e-4 of max|out|, the loss at rel 1e-5,
  ``per_worker_grads`` at 1e-4 of each leaf's max|g| (the dense LM's
  tolerances, tests/test_torch_models.py and test_torch_train.py).

The CUDA path runs only on a card: tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import robust_train as jrt
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro_torch import configs, convert
from repro_torch.core import robust_train as trt
from repro_torch.data.tokens import TokenStream
from repro_torch.models import blocks, model, rwkv

ARCH = "rwkv6-7b"
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
    return torch.as_tensor(np.asarray(x))


def _wkv_inputs(B, T, H, hd, seed):
    r, k, v = (_x((B, T, H, hd), seed + i) for i in range(3))
    # decays as the model makes them: exp(-exp(w0 + lora))
    w = np.exp(-np.exp(_x((B, T, H, hd), seed + 3, 0.5) - 0.6)) \
        .astype(np.float32)
    u = _x((H, hd), seed + 4, 0.1)
    state = _x((B, H, hd, hd), seed + 5, 0.1)
    return r, k, v, w, u, state


# ---------------------------------------------------------------------------
# the recurrence

@pytest.mark.parametrize("T", [128, 64, 40, 100])
def test_wkv_matches_jax(T):
    """T a multiple of the chunk (two chunks, one), shorter than a chunk
    (one chunk of T), and ragged past it (the chunked form falls back to
    the scan)."""
    args = _wkv_inputs(2, T, 2, 8, seed=T)
    for mine, ref in ((rwkv.wkv_scan, jrwkv.wkv_scan),
                      (rwkv.wkv_chunked, jrwkv.wkv_chunked)):
        y, S = mine(*(torch.as_tensor(a) for a in args))
        jy, jS = ref(*(jnp.asarray(a) for a in args))
        assert y.dtype == S.dtype == torch.float32
        _close(y, jy, MODULE_RTOL)
        _close(S, jS, MODULE_RTOL)


def test_wkv_chunked_equals_the_scan():
    args = [torch.as_tensor(a) for a in _wkv_inputs(1, 192, 3, 16, seed=9)]
    y, S = rwkv.wkv_chunked(*args)
    ys, Ss = rwkv.wkv_scan(*args)
    _close(y, ys.numpy(), 1e-4)
    _close(S, Ss.numpy(), 1e-4)


def test_wkv_chunked_survives_strong_decay():
    """w near 0 (log clamped at 1e-30): every exponent stays <= 0, so
    nothing overflows.  The exponents are differences of cumulative sums
    near 64 log(1e-30) = -4421, whose float32 ulp (5e-4) both versions
    carry into exp: held at 1e-3 of max|y|."""
    r, k, v, w, u, state = _wkv_inputs(1, 64, 1, 8, seed=3)
    w = np.full_like(w, 1e-38)
    y, S = rwkv.wkv_chunked(*(torch.as_tensor(a)
                              for a in (r, k, v, w, u, state)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    jy, _ = jrwkv.wkv_chunked(*(jnp.asarray(a)
                                for a in (r, k, v, w, u, state)))
    _close(y, jy, 1e-3)


# ---------------------------------------------------------------------------
# time mix and channel mix

SPEC = dict(d_model=32, d_ff=64, head_dim=8, decay_lora_rank=16)


def _params(seed=0):
    jspec = jrwkv.RWKVSpec(**SPEC)
    jp = jrwkv.init(jax.random.PRNGKey(seed), jspec, dtype=jnp.float32)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.asarray(a)), jp)
    return jspec, rwkv.RWKVSpec(**SPEC), jp, tp


@pytest.mark.parametrize("T", [64, 1, 24])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_jax(T, carried):
    jspec, spec, jp, tp = _params(1)
    x = _x((2, T, 32), 10 + T)
    kw = {}
    if carried:
        kw = {"prev_token": _x((2, 32), 11), "wkv_state":
              _x((2, 4, 8, 8), 12, 0.1)}
    out, (prev, S) = rwkv.time_mix(tp["time_mix"], spec, _t(x),
                                   **{k: _t(v) for k, v in kw.items()})
    jout, (jprev, jS) = jrwkv.time_mix(
        jp["time_mix"], jspec, jnp.asarray(x),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(out, jout, MODULE_RTOL)
    _close(prev, jprev, MODULE_RTOL)
    _close(S, jS, MODULE_RTOL)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_jax(carried):
    jspec, spec, jp, tp = _params(2)
    x = _x((2, 16, 32), 20)
    prev = _x((2, 32), 21) if carried else None
    out, last = rwkv.channel_mix(tp["channel_mix"], spec, _t(x),
                                 prev_token=None if prev is None
                                 else _t(prev))
    jout, jlast = jrwkv.channel_mix(jp["channel_mix"], jspec,
                                    jnp.asarray(x),
                                    prev_token=None if prev is None
                                    else jnp.asarray(prev))
    _close(out, jout, MODULE_RTOL)
    _close(last, jlast, MODULE_RTOL)


def test_split_sequence_continues_from_the_state():
    """The second half, from the first half's carried token and WKV state,
    gives what the whole sequence gives there."""
    jspec, spec, jp, tp = _params(3)
    x = _x((1, 128, 32), 30)
    whole, (_, S_whole) = rwkv.time_mix(tp["time_mix"], spec, _t(x))
    first, (prev, S) = rwkv.time_mix(tp["time_mix"], spec, _t(x[:, :64]))
    second, (_, S2) = rwkv.time_mix(tp["time_mix"], spec, _t(x[:, 64:]),
                                    prev_token=prev, wkv_state=S)
    jwhole, _ = jrwkv.time_mix(jp["time_mix"], jspec, jnp.asarray(x))
    _close(torch.cat([first, second], dim=1), jwhole, MODULE_RTOL)
    _close(second, whole[:, 64:].numpy(), MODULE_RTOL)
    _close(S2, S_whole.numpy(), MODULE_RTOL)


# ---------------------------------------------------------------------------
# the model (reduced rwkv6-7b)

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
        == 7_532_969_984
    assert cfg.reduced().param_count() == \
        jconfigs.get_config(ARCH).reduced().param_count()


def test_params_cross_leaf_for_leaf(lm):
    jcfg, cfg, jp, tp = lm
    mine = model.init(0, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, other = tp, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(other.shape), path
        assert node.dtype == other.dtype == torch.float32
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params_from_numpy(cfg.with_(d_ff=128),
                                     jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("T", [128, 40])
def test_forward_matches_jax(lm, T):
    """Two chunks of 64, and a ragged length (the scan)."""
    jcfg, cfg, jp, tp = lm
    tokens = _tokens(cfg, (2, T), T)
    jh, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    h, aux = model.forward(tp, cfg, {"tokens": _t(tokens)})
    assert float(aux) == 0.0
    _close(h, jh, MODEL_RTOL)


def test_loss_matches_jax(lm):
    jcfg, cfg, jp, tp = lm
    batch = {"tokens": _tokens(cfg, (2, 64), 1),
             "labels": _tokens(cfg, (2, 64), 2)}
    want = float(jmodel.loss_fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg))
    got = float(model.loss_fn(tp, {k: _t(v) for k, v in batch.items()},
                              cfg))
    assert got == pytest.approx(want, rel=1e-5)


def test_decode_matches_jax_and_the_prefill(lm):
    """Eight tokens through decode steps (the states carried in place)
    against the reference's decode steps, and the last logits against the
    port's full-sequence forward."""
    jcfg, cfg, jp, tp = lm
    tokens = _tokens(cfg, (2, 8), 5)
    jstate = jmodel.init_decode_state(jcfg, 2, 8)
    state = model.init_decode_state(cfg, 2, 8, device="cpu")
    back = convert.decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    for a, b in zip(state["states"], back["states"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert state["states"][1].dtype == torch.float32
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        jlogits, jstate = jmodel.decode_step(
            jp, jcfg, jstate, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos))
        logits, state = model.decode_step(tp, cfg, state,
                                          _t(tokens[:, t:t + 1]), _t(pos))
        _close(logits, jlogits, MODEL_RTOL)
    for got, want in zip(state["states"], jstate["states"]):
        _close(got, want, MODEL_RTOL)
    h, _ = model.forward(tp, cfg, {"tokens": _t(tokens)})
    full = model._unembed_fn(tp, cfg)(h[:, -1:])
    _close(logits, full.numpy(), MODEL_RTOL)


def test_full_sequence_with_states_matches_jax(lm):
    """The stack over a sequence from carried states (the reference's
    ``_run_rwkv_stack`` with states)."""
    jcfg, cfg, jp, tp = lm
    x = _x((1, 64, cfg.d_model), 40)
    L, H, hd = cfg.num_layers, cfg.d_model // cfg.ssm_head_dim, \
        cfg.ssm_head_dim
    states = (_x((L, 1, cfg.d_model), 41), _x((L, 1, H, hd, hd), 42, 0.1),
              _x((L, 1, cfg.d_model), 43))
    jh, jnew = jmodel._run_rwkv_stack(
        jp["layers"], jcfg, jnp.asarray(x),
        states=tuple(jnp.asarray(s) for s in states))
    h, new = model._run_rwkv_stack(tp["layers"], cfg, _t(x),
                                   states=tuple(_t(s) for s in states))
    _close(h, jh, MODEL_RTOL)
    for got, want in zip(new, jnew):
        _close(got, want, MODEL_RTOL)


def test_per_worker_grads_match_jax(lm):
    """m = 2 workers of 2 sequences of 64 tokens (one WKV chunk)."""
    jcfg, cfg, jp, tp = lm
    kw = dict(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
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


def test_rwkv_spec_matches_jax():
    from repro.models import blocks as jblocks
    for cfg, jcfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                      (configs.get_config(ARCH).reduced(),
                       jconfigs.get_config(ARCH).reduced())):
        assert blocks.rwkv_spec(cfg).__dict__ == \
            jblocks.rwkv_spec(jcfg).__dict__


def test_wkv_chunked_gradient_stays_finite_past_exp_overflow():
    """Decays near 1e-20 make the masked pairs' exponents pass float32's
    exp range: the reference's gradient in w (exp, then mask) is NaN, the
    port's (masked in the exponent) finite, its output the reference's."""
    r, k, v, w, u, state = _wkv_inputs(1, 64, 1, 8, seed=5)
    w = np.full_like(w, 1e-20)
    jg = jax.grad(lambda ww: jnp.sum(jrwkv.wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v)), ww,
        *(jnp.asarray(a) for a in (u, state)))[0]))(jnp.asarray(w))
    assert bool(jnp.isnan(jg).any())
    wt = torch.tensor(w, requires_grad=True)
    y, _ = rwkv.wkv_chunked(*(torch.as_tensor(a) for a in (r, k, v)), wt,
                            *(torch.as_tensor(a) for a in (u, state)))
    jy, _ = jrwkv.wkv_chunked(*(jnp.asarray(a)
                                for a in (r, k, v, w, u, state)))
    _close(y, jy, 1e-3)
    y.sum().backward()
    assert bool(torch.isfinite(wt.grad).all())
