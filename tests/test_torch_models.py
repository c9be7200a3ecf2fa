"""The port's LM (repro_torch.configs, models.layers / attention / blocks
/ model, convert), dense and MoE, against the JAX package's.

Inputs come from numpy seeds; the whole-model checks hand the JAX params
(``repro.models.model.init``) across through
``convert.lm_params_from_numpy``, since the port's initialiser draws other
bits.  Tolerances: the layers at 1e-6 (float32, the same ops); the
reduced H2O-Danube3, Granite and Kimi models at rtol 1e-4 against
max|y| (two layers of float32 matmuls summed in other orders).  The CUDA path runs only on a
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
from repro_torch.launch import sharding, steps
from repro_torch.models import attention, blocks, layers, model

import torch_mesh_ranks

DENSE = ("h2o-danube-3-4b", "minitron-4b", "qwen3-14b", "qwen2-72b")
MOE = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
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

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_equal_the_reference(arch):
    mine, ref = configs.get_config(arch), jconfigs.get_config(arch)
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        for key in ("dtype", "param_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        # the port has every field of the reference, the audio and vlm
        # families' included
        assert set(a) == set(b)
        assert a == {key: b[key] for key in a}
        assert cfg.param_count() == jcfg.param_count()


def test_registry_and_shapes():
    """Every architecture of the reference resolves, to a config of the
    same name and family."""
    assert configs.ARCHITECTURES == jconfigs.ARCHITECTURES
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.get_shape("prefill_32k").seq_len == 32_768
    for arch in configs.ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert (cfg.name, cfg.family) == (jcfg.name, jcfg.family) == \
            (arch, jcfg.family)
    assert {configs.get_config(a).family for a in configs.ARCHITECTURES} \
        == {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


def test_h2o_full_width():
    cfg = configs.get_config("h2o-danube-3-4b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.sliding_window) == \
        (24, 3840, 32, 8, 120, 10240, 32000, 4096)
    assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    assert 3.9e9 < cfg.param_count() < 4.0e9


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_equal_the_reference(arch):
    mine, ref = configs.get_config(arch), jconfigs.get_config(arch)
    for cfg, jcfg in ((mine, ref), (mine.reduced(), ref.reduced())):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        for key in ("dtype", "param_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                jnp.dtype(b.pop(key)).name
        assert set(a) == set(b)
        assert a == {key: b[key] for key in a}
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert (mine.reduced().num_experts,
            mine.reduced().experts_per_token) == (4, 2)


def test_granite_full_width():
    cfg = configs.get_config("granite-moe-1b-a400m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.num_experts,
            cfg.experts_per_token, cfg.tie_embeddings) == \
        (24, 1024, 16, 8, 64, 512, 49155, 32, 8, False)
    assert 1.38e9 < cfg.param_count() < 1.39e9
    # the embeddings (100.7 M) and 24 layers of attention and top-8 experts
    assert cfg.active_param_count() == 478_943_232
    # the dense family's active count is its count
    dense = configs.get_config("h2o-danube-3-4b")
    assert dense.active_param_count() == dense.param_count()


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
    """The audio and vlm families, once unported, now init, count and
    (audio) cross-attend; an unknown family raises; under a model mesh
    the hybrid, audio and vlm families, once refused there, give one
    process's loss on a one-rank mesh (the batch its
    ``sharding.local_batch`` block)."""
    for arch in ("seamless-m4t-medium", "internvl2-26b"):
        cfg = configs.get_config(arch).reduced()
        params = model.init(0, cfg, device="cpu")
        assert cfg.param_count() == jconfigs.get_config(arch).reduced() \
            .param_count()
        assert ("encoder" in params) == ("cross" in params["layers"]) == \
            (cfg.family == "audio")
    cfg = configs.get_config("seamless-m4t-medium").reduced()
    spec = blocks.attn_spec(cfg, cross=True)
    p = attention.init(torch.Generator().manual_seed(0), spec,
                       dtype=torch.float32)
    x, mem = torch.randn(2, 5, cfg.d_model), torch.randn(2, 3, cfg.d_model)
    assert attention.apply(p, spec, x, memory=mem).shape == (2, 5, 256)
    with pytest.raises(ValueError, match="unknown family"):
        model.init(0, cfg.with_(family="speech"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        cfg.with_(family="speech").param_count()
    tok = torch.arange(32)[None] % 7
    for arch in ("zamba2-2.7b", "seamless-m4t-medium", "internvl2-26b"):
        cfg = configs.get_config(arch).reduced()
        params = model.init(0, cfg, device="cpu")
        batch = {"tokens": tok, "labels": tok.roll(-1, -1)}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn((1, 16, cfg.d_model))
        if cfg.family == "audio":
            batch["frames"] = torch.randn((1, 16, cfg.d_model))
        want = model.loss_fn(params, batch, cfg)
        with torch_mesh_ranks.one_rank_mesh() as mesh:
            got = model.loss_fn(params, sharding.local_batch(batch, mesh, cfg),
                                cfg)
        assert abs(float(got) - float(want)) <= 1e-6 * float(want), arch


# ---------------------------------------------------------------------------
# the reduced MoE models (Granite, Kimi): 2 layers, 4 experts of top-2

def _moe_lm(arch, seed=3, **kw):
    jcfg = jconfigs.get_config(arch).reduced().with_(**kw)
    cfg = configs.get_config(arch).reduced().with_(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_logits_match_jax(arch):
    jcfg, jparams, cfg, params = _moe_lm(arch)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 48))
    labels = rng.integers(0, cfg.vocab_size, (2, 48))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    want = float(jmodel.loss_fn(jparams, jb, jcfg))
    got = model.loss_fn(params, tb, cfg)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)
    # the aux term is in the loss: forward's aux, summed over the layers
    _, jaux = jmodel.forward(jparams, jcfg, jb)
    _, aux = model.forward(params, cfg, tb)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(aux) > 0
    _close(model.logits(params, cfg, tb), jmodel.logits(jparams, jcfg, jb))


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_with_slack_capacity(arch):
    """The reference's test of the same name on the port (no token drops
    with slack capacity, so the decode loop reproduces the forward), and
    the decode logits against the reference's decode."""
    jcfg, jparams, cfg, params = _moe_lm(arch, seed=1,
                                         moe_capacity_factor=100.0)
    B, T = 2, 8
    tok = np.random.default_rng(12).integers(0, cfg.vocab_size, (B, T))
    full = model.logits(params, cfg, {"tokens": torch.as_tensor(tok)})
    state = model.init_decode_state(cfg, B, T, device="cpu")
    jstate = jmodel.init_decode_state(jcfg, B, T)
    step = steps.make_serve_step(cfg)
    outs = []
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        lg, state = step(params, state, torch.as_tensor(tok[:, t:t + 1]),
                         torch.as_tensor(pos))
        jl, jstate = jmodel.decode_step(jparams, jcfg, jstate,
                                        jnp.asarray(tok[:, t:t + 1]),
                                        jnp.asarray(pos))
        _close(lg, jl)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((full - dec).abs().max()) < 1e-3


def test_moe_params_cross_keeping_the_router_f32():
    """A bf16 Granite config: the reference's params cross leaf for leaf,
    each in its own dtype (the router float32, the rest bf16)."""
    arch = "granite-moe-1b-a400m"
    kw = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jcfg = jconfigs.get_config(arch).reduced().with_(
        dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    cfg = configs.get_config(arch).reduced().with_(**kw)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    mine = model.init(0, cfg, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node, other = params, mine
        for key in path:
            node, other = node[key.key], other[key.key]
        want = torch.float32 if path[-1].key == "router" else torch.bfloat16
        assert node.dtype == other.dtype == want, path
        assert tuple(node.shape) == leaf.shape == tuple(other.shape)
        np.testing.assert_array_equal(
            node.float().numpy(), np.asarray(leaf, np.float32))
    with pytest.raises(ValueError, match="do not fit"):
        convert.lm_params_from_numpy(
            configs.get_config("h2o-danube-3-4b").reduced(),
            jax.tree.map(np.asarray, jparams), "cpu")
    # a bf16 prefill through the port keeps bf16 activations
    h = model.prefill(params, cfg, {"tokens": torch.zeros((1, 8),
                                                          dtype=torch.int64)})
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())
