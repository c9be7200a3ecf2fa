"""The port's audio family (SeamlessM4T's encoder-decoder:
models.layers.gelu_mlp, cross-attention in models.attention, the encoder
and cross-attending decoder blocks, the audio stack of models.model,
data.tokens.frame_embeddings) against the JAX package's; its training
path is tests/test_torch_audio_train.py.

Inputs come from numpy seeds; the reference's params are handed across
with ``convert.lm_params_from_numpy`` (the port's initialiser draws
other bits), and both sides run in float32.  Tolerances: ``gelu_mlp`` at
1e-5 of max|y|; attention, the encoder block and the reduced model
(seamless-m4t-medium reduced: 2 encoder and 2 decoder layers, 256 wide,
4/2 heads of 64) at rtol 1e-4 of max|y| (float32 matmuls summed in other
orders); the loss at rel 1e-5.  The CUDA path runs only on a card:
tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import tokens as jtokens
from repro.kernels.attention import ref as jref
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch import random as prng
from repro_torch.data import tokens
from repro_torch.kernels.attention import ops, ref
from repro_torch.launch import steps
from repro_torch.models import attention, blocks, layers, model
from torch_lm_parity import (  # noqa: F401
    _close, _crossed, _one_thread, _t, _threefry_original, _tokens, _x,
    reduced_models)

ARCH = "seamless-m4t-medium"


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
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert (mine.num_layers, mine.encoder_layers, mine.d_model,
            mine.num_heads, mine.num_kv_heads, mine.head_dim, mine.d_ff,
            mine.vocab_size, mine.encoder_seq_divisor, mine.frontend) == \
        (12, 12, 1024, 16, 16, 64, 4096, 256206, 4, "audio")
    assert mine.reduced().encoder_layers == 2


def test_param_count_overcounts_the_encoder_mlp():
    """Known condition of the reference: ``param_count`` counts the
    encoder's GELU MLP as 3 D F where its leaves hold 2 D F + F + D, so
    SeamlessM4T-medium counts 977 694 720 against 927 513 600 leaves;
    the port keeps the reference's count (launch/train.py's depth rule
    reads it)."""
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 977_694_720
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jconfigs.get_config(ARCH)))
    leaves = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert leaves == 927_513_600
    D, F, Le = cfg.d_model, cfg.d_ff, cfg.encoder_layers
    norms = 3 * D * cfg.num_layers + 4 * D * Le + 2 * D + D
    assert cfg.param_count() - leaves == Le * (D * F - F - D) - norms
    one = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jconfigs.get_config(ARCH).with_(
            num_layers=1, encoder_layers=1)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(one)) \
        == 558_279_680


# ---------------------------------------------------------------------------
# layers and attention

@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 64)])
def test_gelu_mlp_matches_jax(shape):
    """The tanh form of GELU, as ``jax.nn.gelu`` computes by default."""
    D, F = shape[-1], 96
    jp = jlayers.gelu_mlp_init(jax.random.PRNGKey(1), D, F,
                               dtype=jnp.float32)
    jp = dict(jp, b_in=jnp.asarray(_x((F,), 2)),
              b_out=jnp.asarray(_x((D,), 3)))
    x = _x(shape, 4, 2.0)
    want = jlayers.gelu_mlp(jp, jnp.asarray(x))
    got = layers.gelu_mlp(_crossed(jp), _t(x))
    _close(got, want, 1e-5)
    mine = layers.gelu_mlp_init(torch.Generator().manual_seed(0), D, F,
                                dtype=torch.float32, stack=(3,))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        "w_in": (3, D, F), "b_in": (3, F), "w_out": (3, F, D),
        "b_out": (3, D)}


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("tq,tk", [(24, 10), (7, 33)])
def test_cross_attention_apply_matches_jax(heads, tq, tk):
    """Queries from x, keys and values from the memory: no RoPE, no
    mask, no window (the spec's window is dropped)."""
    H, KV = heads
    spec = attention.AttentionSpec(d_model=64, num_heads=H,
                                   num_kv_heads=KV, head_dim=16,
                                   sliding_window=4, cross=True)
    jspec = jattn.AttentionSpec(**dataclasses.asdict(spec))
    jp = jattn.init(jax.random.PRNGKey(tq + tk), jspec, dtype=jnp.float32)
    x, mem = _x((2, tq, 64), 5), _x((2, tk, 64), 6)
    want = jattn.apply(jp, jspec, jnp.asarray(x), memory=jnp.asarray(mem))
    got = attention.apply(_crossed(jp), spec, _t(x), memory=_t(mem))
    _close(got, want)
    # one decode step at position tq - 1 is the last row of the sequence
    step, cache = attention.decode_step(
        _crossed(jp), spec, _t(x[:, -1:]), None, torch.full((2,), tq - 1),
        memory=_t(mem))
    assert cache is None
    _close(step, np.asarray(want)[:, -1:])


def test_cross_attention_above_the_blocked_threshold_matches_jax():
    """2100 queries over 40 memory positions: cross-attention takes the
    unblocked core above BLOCKED_ATTENTION_THRESHOLD, as the reference's
    condition does."""
    spec = attention.AttentionSpec(d_model=32, num_heads=2, num_kv_heads=1,
                                   head_dim=16, cross=True)
    jspec = jattn.AttentionSpec(**dataclasses.asdict(spec))
    jp = jattn.init(jax.random.PRNGKey(0), jspec, dtype=jnp.float32)
    T = attention.BLOCKED_ATTENTION_THRESHOLD + 52
    x, mem = _x((1, T, 32), 7), _x((1, 40, 32), 8)
    want = jattn.apply(jp, jspec, jnp.asarray(x), memory=jnp.asarray(mem))
    _close(attention.apply(_crossed(jp), spec, _t(x), memory=_t(mem)), want)


@pytest.mark.parametrize("case", [(2, 96, 40, 4, 2, 32), (1, 333, 84, 4, 2,
                                                          64)])
def test_noncausal_attention_with_more_queries_than_keys(case):
    """``ops.attention(causal=False)`` at Tq > Tk (the decoder's
    cross-attention shape) on the CPU against JAX's
    ``flash_attention_ref`` and the tensor-core route's plain twin."""
    B, Tq, Tk, H, KV, hd = case
    q, k, v = (_x((B, T, n, hd), s) for T, n, s in
               ((Tq, H, 9), (Tk, KV, 10), (Tk, KV, 11)))
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False,
                                    sliding_window=None)
    got = ops.attention(_t(q), _t(k), _t(v), causal=False)
    _close(got, want)
    twin = ref.flash_attention_tiled_ref(_t(q), _t(k), _t(v), causal=False)
    _close(twin, want)


def test_encoder_block_matches_jax():
    """LayerNorm, bidirectional self-attention with RoPE and no window,
    GELU MLP; 70 frames."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = configs.get_config(ARCH).reduced()
    jp = jblocks.init_encoder_block(jax.random.PRNGKey(2), jcfg)
    p = _crossed(jp)
    x = _x((2, 70, cfg.d_model), 12)
    _close(blocks.encoder_block(p, cfg, _t(x)),
           jblocks.encoder_block(jp, jcfg, jnp.asarray(x)))
    spec = blocks.attn_spec(cfg, causal=False, sliding_window=None)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jblocks.attn_spec(jcfg, causal=False, sliding_window=None))
    assert dataclasses.asdict(blocks.attn_spec(cfg, cross=True)) == \
        dataclasses.asdict(jblocks.attn_spec(jcfg, cross=True))
    mine = blocks.init_encoder_block(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)


# ---------------------------------------------------------------------------
# the reduced model, end to end

@pytest.fixture(scope="module")
def lm():
    return reduced_models(ARCH)


def _batch(cfg, B, T, seed, labels=False):
    out = {"tokens": _tokens(cfg, (B, T), seed),
           "frames": _x((B, max(T // cfg.encoder_seq_divisor, 1),
                         cfg.d_model), seed + 1)}
    if labels:
        out["labels"] = _tokens(cfg, (B, T), seed + 2)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def test_params_cross_leaf_for_leaf(lm):
    jcfg, cfg, jp, tp = lm
    mine = model.init(0, cfg, device="cpu")
    assert {"encoder", "enc_ln"} <= set(mine)
    assert {"ln_cross", "cross"} <= set(mine["layers"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node, other = tp, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(other.shape), path
        assert node.dtype == other.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(jax.tree.leaves(mine)) == len(jax.tree.leaves(jp))
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params_from_numpy(cfg.with_(encoder_layers=1),
                                     jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("T", [64, 30])
def test_forward_logits_and_prefill_match_jax(lm, T):
    jcfg, cfg, jp, tp = lm
    jb, tb = _both(_batch(cfg, 2, T, T))
    jh, _ = jmodel.forward(jp, jcfg, jb)
    h, aux = model.forward(tp, cfg, tb)
    assert float(aux) == 0.0
    _close(h, jh)
    _close(model.logits(tp, cfg, tb), jmodel.logits(jp, jcfg, jb))
    _close(steps.make_prefill_step(cfg)(tp, tb), jmodel.prefill(jp, jcfg,
                                                                  jb))


def test_loss_matches_jax(lm):
    jcfg, cfg, jp, tp = lm
    jb, tb = _both(_batch(cfg, 2, 48, 20, labels=True))
    want = float(jmodel.loss_fn(jp, jb, jcfg))
    assert float(model.loss_fn(tp, tb, cfg)) == pytest.approx(want,
                                                              rel=1e-5)


def test_decode_against_the_zero_memory_matches_jax(lm):
    """The state of ``init_decode_state``: a KV cache and a zero memory
    of max_len // 4 frames; 12 decode steps against the reference's."""
    jcfg, cfg, jp, tp = lm
    B, N = 2, 12
    toks = _tokens(cfg, (B, N), 30)
    jstate = jmodel.init_decode_state(jcfg, B, 40)
    state = model.init_decode_state(cfg, B, 40, device="cpu")
    assert state["memory"].shape == (B, 10, cfg.d_model)
    assert not bool(state["memory"].any())
    back = convert.decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    assert torch.equal(back["memory"], state["memory"])
    for t in range(N):
        pos = np.full((B,), t, np.int32)
        jl, jstate = jmodel.decode_step(jp, jcfg, jstate,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.asarray(pos))
        tl, state = model.decode_step(tp, cfg, state, _t(toks[:, t:t + 1]),
                                      _t(pos))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(state["cache"]["self"][name], jstate["cache"]["self"][name])


def test_decode_against_the_encoder_memory_matches_jax_and_prefill(lm):
    """``state["memory"]`` set to the encoder's output for the frames:
    decode steps match the reference's, and the last step's logits match
    the prefill's last position on the same tokens and frames."""
    jcfg, cfg, jp, tp = lm
    B, T = 2, 24
    batch = _batch(cfg, B, T, 40)
    jb, tb = _both(batch)
    jmem = jmodel._run_encoder(jp, jcfg, jb["frames"])
    mem = model._run_encoder(tp, cfg, tb["frames"], plain=True)
    _close(mem, jmem)
    jstate = dict(jmodel.init_decode_state(jcfg, B, T), memory=jmem)
    state = model.init_decode_state(cfg, B, T, device="cpu")
    state["memory"] = mem
    toks = batch["tokens"]
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        jl, jstate = jmodel.decode_step(jp, jcfg, jstate,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.asarray(pos))
        tl, state = model.decode_step(tp, cfg, state, _t(toks[:, t:t + 1]),
                                      _t(pos))
        _close(tl, jl)
    h = model.prefill(tp, cfg, tb)
    _close(tl, model._unembed_fn(tp, cfg)(h[:, -1:]).numpy())


def test_serve_cross_attention_adds_zero(lm):
    """Known condition of the reference: ``serve`` decodes the audio
    family against the zero memory of ``init_decode_state``, so its
    cross-attention adds exactly 0 and the decoder steps as if it had
    none; pinned on both sides."""
    jcfg, cfg, jp, tp = lm
    toks = _tokens(cfg, (2, 6), 50)
    state = model.init_decode_state(cfg, 2, 6, device="cpu")
    jstate = jmodel.init_decode_state(jcfg, 2, 6)
    x = model._embed(tp, cfg, _t(toks[:, :1]))
    p = blocks.unstack(tp["layers"])[0]
    normed = layers.rmsnorm(p["ln_cross"], x, eps=cfg.norm_eps)
    out, _ = attention.decode_step(p["cross"], blocks.attn_spec(cfg,
                                                                cross=True),
                                   normed, None, torch.zeros(2),
                                   memory=state["memory"])
    assert torch.equal(out, torch.zeros_like(out))
    jx = jmodel._embed(jp, jcfg, jnp.asarray(toks[:, :1]))
    jpl = jax.tree.map(lambda a: a[0], jp["layers"])
    jout, _ = jattn.decode_step(
        jpl["cross"], jblocks.attn_spec(jcfg, cross=True),
        jlayers.rmsnorm(jpl["ln_cross"], jx, eps=jcfg.norm_eps), None,
        jnp.zeros((2,), jnp.int32), memory=jstate["memory"])
    assert not np.asarray(jout).any()
    # the whole decode equals a decoder with the cross blocks removed
    plain = {k: v for k, v in tp.items() if k not in ("encoder", "enc_ln")}
    plain["layers"] = {k: v for k, v in tp["layers"].items()
                       if k not in ("cross", "ln_cross")}
    dense = cfg.with_(family="dense")
    dstate = model.init_decode_state(dense, 2, 6, device="cpu")
    for t in range(6):
        pos = torch.full((2,), t)
        a, state = model.decode_step(tp, cfg, state, _t(toks[:, t:t + 1]),
                                     pos)
        b, dstate = model.decode_step(plain, dense, dstate,
                                      _t(toks[:, t:t + 1]), pos)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# data and the entry points

def test_frame_embeddings_shape_dtype_and_values():
    key = prng.fold_in(prng.PRNGKey(3, device="cpu"), 5)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    kw = dict(num_workers=2, per_worker=3, num_frames=7, d_model=16)
    got = tokens.frame_embeddings(key, **kw)
    assert got.shape == (2, 3, 7, 16) and got.dtype == torch.bfloat16
    f32 = tokens.frame_embeddings(key, **kw, dtype=torch.float32)
    want = jtokens.frame_embeddings(jkey, **kw, dtype=jnp.float32)
    np.testing.assert_allclose(f32.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, f32.to(torch.bfloat16))


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
