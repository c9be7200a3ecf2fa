"""The port's dense LM (repro_torch.configs, models.layers / attention /
blocks / model, convert) against the JAX package's.

Inputs come from numpy seeds; the whole-model checks hand the JAX params
(``repro.models.model.init``) across through
``convert.lm_params_from_numpy``, since the port's initialiser draws other
bits.  Tolerances: the layers at 1e-6 (float32, the same ops); the
reduced H2O-Danube3 model at rtol 1e-4 against max|y| (two layers of
float32 matmuls summed in other orders).  The CUDA path runs only on a
card: tests/test_torch_cuda.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.configs import shapes
from repro_torch.launch import steps
from repro_torch.models import attention, blocks, layers, model

DENSE = ("h2o-danube-3-4b", "minitron-4b", "qwen3-14b", "qwen2-72b")
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _close(got, want, rtol=RTOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# configs

UNPORTED_FIELDS = {"num_experts", "experts_per_token", "moe_capacity_factor",
                   "ssm_state", "ssm_head_dim", "ssm_chunk",
                   "shared_attn_every", "encoder_layers",
                   "encoder_seq_divisor", "frontend", "num_patches", "remat",
                   "loss_chunk"}

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_the_reference(arch):
    mine, ref = configs.get_config(arch), jconfigs.get_config(arch)
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        for key in ("dtype", "param_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        # the port has every field the dense family reads; the others come
        # with their families' model code
        assert set(b) - set(a) == UNPORTED_FIELDS
        assert a == {key: b[key] for key in a}
        assert cfg.param_count() == jcfg.param_count()


def test_registry_and_shapes():
    assert configs.ARCHITECTURES == jconfigs.ARCHITECTURES
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.get_shape("prefill_32k").seq_len == 32_768
    for arch in set(configs.ARCHITECTURES) - set(DENSE):
        with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
            configs.get_config(arch)
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


def test_h2o_full_width():
    cfg = configs.get_config("h2o-danube-3-4b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (24, 3840, 32, 8, 120, 10240, 32000, 4096)
    assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    assert 3.9e9 < cfg.param_count() < 4.0e9


# ---------------------------------------------------------------------------
# layers

def test_rmsnorm_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 24)).astype(np.float32)
    scale = np.random.default_rng(1).uniform(0.5, 1.5, 24).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           eps=1e-5)
    got = layers.rmsnorm({"scale": torch.as_tensor(scale)},
                         torch.as_tensor(x), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                            theta=theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # the two halves of head_dim rotate as pairs: norms are kept
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    p = {n: rng.normal(size=s).astype(np.float32) * 0.3 for n, s in
         (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    want = jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    got = layers.swiglu({k: torch.as_tensor(v) for k, v in p.items()},
                        torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_truncated_normal_init():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 400, (3, 50), dtype=torch.bfloat16,
                          stack=(2,))
    assert w.shape == (2, 400, 3, 50) and w.dtype == torch.bfloat16
    z = w.float() * math.sqrt(400)
    assert float(z.abs().max()) <= 2.0 + 1e-2
    # a standard normal truncated to [-2, 2] has variance 0.7737
    assert abs(float(z.var()) - 0.7737) < 0.02
    again = layers.dense_init(torch.Generator().manual_seed(0), 400,
                              (3, 50), dtype=torch.bfloat16, stack=(2,))
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# the reduced H2O-Danube3 model, end to end

@pytest.fixture(scope="module")
def lm():
    """Reduced H2O-Danube3 (2 layers, d 256, 4/2 heads of 64, window 64):
    JAX params and the same params in the port."""
    jax.config.update("jax_threefry_partitionable", False)
    jcfg = jconfigs.get_config("h2o-danube-3-4b").reduced()
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    jparams = jmodel.init(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, convert.lm_params_from_numpy(cfg, tree, "cpu")


def test_params_cross_leaf_for_leaf(lm):
    jcfg, jparams, cfg, params = lm
    mine = model.init(0, cfg, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        node, other = params, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        assert tuple(node.shape) == leaf.shape == tuple(other.shape)
        assert node.dtype == other.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params_from_numpy(
            configs.get_config("h2o-danube-3-4b"),
            jax.tree.map(np.asarray, jparams), "cpu")


def test_prefill_matches_jax(lm):
    jcfg, jparams, cfg, params = lm
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 80))
    want = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.as_tensor(tokens)})
    _close(got, want)
    jlogits = jmodel.logits(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    _close(model.logits(params, cfg, {"tokens": torch.as_tensor(tokens)}),
           jlogits)


def test_decode_steps_match_jax_through_the_ring(lm):
    """80 prompt tokens and 24 more through decode steps: the cache holds
    min(104, window 64) slots, so the ring wraps and the 1 << 30 sentinel
    marks slots outside the window."""
    jcfg, jparams, cfg, params = lm
    B, P, N = 2, 80, 24
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (B, P + N))
    jstate = jmodel.init_decode_state(jcfg, B, P + N)
    state = model.init_decode_state(cfg, B, P + N, device="cpu")
    assert state["cache"]["self"]["k"].shape == (2, B, 64, 2, 64)
    jstep = jax.jit(lambda s, t, p: jmodel.decode_step(jparams, jcfg, s, t,
                                                       p))
    step = steps.make_serve_step(cfg)
    for t in range(P + N):
        pos = np.full((B,), t, np.int32)
        jl, jstate = jstep(jstate, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.asarray(pos))
        lg, state = step(params, state, torch.as_tensor(tokens[:, t:t + 1]),
                         torch.as_tensor(pos))
        if t >= P:
            _close(lg, jl)
    crossed = convert.decode_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate), "cpu")
    for name in ("k", "v"):
        _close(state["cache"]["self"][name], crossed["cache"]["self"][name])


def test_prefill_matches_decode_at_the_last_prompt_position(lm):
    _, _, cfg, params = lm
    tokens = torch.as_tensor(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 70)))
    h = model.prefill(params, cfg, {"tokens": tokens})
    want = model._unembed_fn(params, cfg)(h[:, -1:])
    state = model.init_decode_state(cfg, 2, 70, device="cpu")
    for t in range(70):
        lg, state = model.decode_step(params, cfg, state, tokens[:, t:t + 1],
                                      torch.full((2,), t))
    _close(lg, want.numpy())


def test_blocked_prefill_above_the_threshold_matches_jax():
    """Above 2048 query positions ``apply`` takes the blocked core, as the
    reference does; one layer, one sequence of 2100 tokens."""
    jcfg = jconfigs.get_config("h2o-danube-3-4b").reduced().with_(
        num_layers=1)
    cfg = configs.get_config("h2o-danube-3-4b").reduced().with_(num_layers=1)
    jparams = jmodel.init(jax.random.PRNGKey(9), jcfg)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    T = attention.BLOCKED_ATTENTION_THRESHOLD + 52
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, T))
    want = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got = model.prefill(params, cfg, {"tokens": torch.as_tensor(tokens)})
    _close(got, want)


def test_attention_spec_and_cache_shape_match_jax():
    for arch in DENSE:
        cfg = configs.get_config(arch)
        spec = blocks.attn_spec(cfg)
        jspec = jblocks.attn_spec(jconfigs.get_config(arch))
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        for max_len in (48, 32_768):
            assert attention.cache_shape(spec, 4, max_len) == \
                jattn.cache_shape(jspec, 4, max_len)


def test_entry_points_want_the_card_by_default():
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.lm_params_from_numpy(cfg, {}, None)


def test_unported_families_raise():
    cfg = configs.get_config("h2o-danube-3-4b").reduced().with_(family="moe")
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        model.init(0, cfg, device="cpu")
    spec = dataclasses.replace(
        blocks.attn_spec(configs.get_config("h2o-danube-3-4b")), cross=True)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        attention.apply({}, spec, torch.zeros(1, 2, 3840))
    with pytest.raises(NotImplementedError, match="item 13"):
        attention.apply_sequence_parallel()
