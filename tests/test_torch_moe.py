"""The port's MoE layer (repro_torch.models.moe) against the JAX
package's (repro.models.moe).

Inputs come from numpy seeds; the reference's params (``moe.init``) are
handed across as numpy arrays.  Tolerances:

* ``route``: the top-k ids equal the reference's except at near ties,
  where the two swapped experts' probabilities (the reference's softmax)
  lie within ``TIE_ULPS`` float32 ulps of each other; weights, aux and z
  at rtol 1e-5 (float32 router products in other orders);
* dispatch on the reference's own ``top_ids``/``top_w``: the expert
  buffers, slots, experts, weights and tokens exactly equal;
* ``_apply_dense`` in float32: output at rtol 1e-5 of max|out|, aux at
  rtol 1e-5; gradients at 1e-5 of each leaf's max|g|;
* ``per_worker_grads`` on reduced Granite: against the reference at 1e-4
  of each leaf's max|g| (two layers, the tolerance of the dense LM's
  test), against a Python loop over workers at 1e-6 (the same ops,
  batched or not).

The CUDA path runs only on a card: tests/test_torch_cuda.py."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import robust_train as jrt
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.core import robust_train as trt
from repro_torch.data.tokens import TokenStream
from repro_torch.models import blocks, model, moe

import torch_mesh_ranks

TIE_ULPS = 4
# (E, K, N, D): the reference unit tests' (4 experts of top-2), reduced
# Granite's, Granite's own 32 of top-8, and a wider router
ROUTERS = [(4, 2, 10, 16), (4, 2, 64, 32), (32, 8, 96, 48), (64, 6, 40, 24)]


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _specs(**kw):
    base = dict(d_model=16, d_ff=32, num_experts=4, experts_per_token=2,
                capacity_factor=1.25)
    base.update(kw)
    return jmoe.MoESpec(**base), moe.MoESpec(**base)


def _params(jspec, seed=0):
    jp = jmoe.init(jax.random.PRNGKey(seed), jspec, dtype=jnp.float32)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


# ---------------------------------------------------------------------------
# router

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ekn", ROUTERS)
def test_route_matches_jax(ekn, seed):
    E, K, N, D = ekn
    jspec, spec = _specs(d_model=D, num_experts=E, experts_per_token=K)
    jp, tp = _params(jspec, seed)
    x = _x((N, D), 100 + seed)
    jids, jw, jaux, jz = jmoe.route(jp, jspec, jnp.asarray(x))
    ids, w, aux, z = moe.route(tp, spec, torch.as_tensor(x))
    jids, jw = np.asarray(jids), np.asarray(jw)
    assert ids.shape == w.shape == (N, K) and w.dtype == torch.float32
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], axis=-1))
    rows = np.nonzero((ids.numpy() != jids).any(-1))[0]
    for n in rows:
        for a, b in zip(jids[n], ids.numpy()[n]):
            if a != b:
                gap = abs(probs[n, a] - probs[n, b])
                assert gap <= TIE_ULPS * _ulp(probs[n, a]), (n, a, b, gap)
    same = np.setdiff1d(np.arange(N), rows)
    np.testing.assert_allclose(w.numpy()[same], jw[same], rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(z) == pytest.approx(float(jz), rel=1e-5)


@pytest.mark.parametrize("tie", ["uniform", "duplicate_columns"])
def test_route_breaks_exact_ties_as_the_reference(tie):
    """A zero router (every expert ties) and a router whose columns come
    in equal pairs: the lower expert id wins, as in ``lax.top_k``."""
    jspec, spec = _specs(num_experts=8, experts_per_token=3)
    jp, tp = _params(jspec)
    router = np.zeros((16, 8), np.float32)
    if tie == "duplicate_columns":
        half = _x((16, 4), 5)
        router = np.repeat(half, 2, axis=1)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = _x((12, 16), 6)
    jids, jw, jaux, jz = jmoe.route(jp, jspec, jnp.asarray(x))
    ids, w, aux, z = moe.route(tp, spec, torch.as_tensor(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


# ---------------------------------------------------------------------------
# dispatch on the reference's own routing

@pytest.mark.parametrize("capacity", ["default", "drops", "minimum"])
@pytest.mark.parametrize("local", [None, (1, 2), (0, 3)])
@pytest.mark.parametrize("ekn", ROUTERS)
def test_dispatch_on_the_reference_routing_is_exact(ekn, local, capacity):
    E, K, N, D = ekn
    jspec, spec = _specs(d_model=D, num_experts=E, experts_per_token=K)
    jp, _ = _params(jspec, 1)
    x = _x((N, D), 7)
    jids, jw, _, _ = jmoe.route(jp, jspec, jnp.asarray(x))
    C = {"default": jmoe._capacity(jspec, N),
         "drops": max(N * K // (3 * E), 1), "minimum": 1}[capacity]
    assert moe._capacity(spec, N) == jmoe._capacity(jspec, N)
    lo, n_local = (0, E) if local is None else (local[0] * E // 4,
                                                local[1] * E // 4)
    want_in, want = jmoe._dispatch_local(
        jspec, jnp.asarray(x), jids, jw, expert_lo=lo, num_local=n_local,
        capacity=C)
    got_in, got = moe._dispatch_local(
        spec, torch.as_tensor(x), torch.tensor(np.asarray(jids)),
        torch.tensor(np.asarray(jw)), expert_lo=lo, num_local=n_local,
        capacity=C)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    keep = got[3].numpy() != 0
    if capacity != "default":
        assert not keep.all()           # these capacities drop
    # an expert never holds more than C assignments, the earlier first
    kept_e, kept_s = got[1].numpy()[keep], got[2].numpy()[keep]
    assert len(set(zip(kept_e, kept_s))) == int(keep.sum())
    assert (kept_s < C).all()


def test_ranks_rank_by_token_order():
    ids = torch.tensor([2, 0, 2, 1, 0, 2, 3, 2])
    order, counts, first, slots = moe._ranks(ids, 4)
    assert counts.tolist() == [2, 1, 4, 1]
    assert first.tolist() == [0, 2, 3, 7]
    assert slots.tolist() == [0, 0, 1, 0, 1, 2, 0, 3]
    assert ids[order].tolist() == [0, 0, 1, 2, 2, 2, 2, 3]


# ---------------------------------------------------------------------------
# the layer

@pytest.mark.parametrize("factor", [1.25, 0.3, 100.0])
@pytest.mark.parametrize("shape", [(2, 12, 16), (1, 33, 16)])
def test_apply_dense_matches_jax(shape, factor):
    """At the default capacity, at one that drops (0.3), and with slack."""
    jspec, spec = _specs(capacity_factor=factor)
    jp, tp = _params(jspec, 2)
    x = _x(shape, 8)
    jout, jaux = jmoe._apply_dense(jp, jspec, jnp.asarray(x))
    out, aux = moe.apply(tp, spec, torch.as_tensor(x))
    jout = np.asarray(jout)
    assert out.shape == jout.shape and out.dtype == torch.float32
    err = float(np.abs(out.numpy() - jout).max())
    assert err <= 1e-5 * float(np.abs(jout).max()), err
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_apply_keeps_bf16_activations_and_f32_aux():
    _, spec = _specs()
    gen = torch.Generator().manual_seed(0)
    p = moe.init(gen, spec, dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("w_gate", "w_up", "w_down")} == \
        {torch.bfloat16}
    out, aux = moe.apply(p, spec, torch.randn(2, 5, 16, generator=gen)
                         .to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


@pytest.mark.parametrize("factor", [1.25, 0.3])
def test_apply_dense_gradients_match_jax(factor):
    """d/d(params, x) of sum(out * r) + aux, torch.autograd vs jax.grad."""
    jspec, spec = _specs(capacity_factor=factor)
    jp, tp = _params(jspec, 3)
    x, r = _x((2, 10, 16), 9), _x((2, 10, 16), 10)

    def jloss(p, xx):
        out, aux = jmoe._apply_dense(p, jspec, xx)
        return jnp.sum(out * jnp.asarray(r)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe._apply_dense(leaves, spec, xt)
    (torch.sum(out * torch.as_tensor(r)) + aux).backward()
    for name, want in list(jg.items()) + [("x", jgx)]:
        got = (xt if name == "x" else leaves[name]).grad.numpy()
        want = np.asarray(want)
        err = float(np.abs(got - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (name, err)


def test_expert_parallel_on_one_rank_is_the_dense_layer():
    """On a (1, 1) mesh every collective is the identity and the rank
    holds every expert: ``apply`` takes the expert-parallel path, whose
    output is the dense layer's bit for bit and whose aux (global sums
    over the token count, against the dense means) is within 1e-6."""
    jspec, spec = _specs()
    _, p = _params(jspec)
    x = torch.tensor(_x((2, 24, 16), 3))
    want, waux = moe._apply_dense(p, spec, x)
    with torch_mesh_ranks.one_rank_mesh() as mesh:
        assert moe._ep_applicable(spec, x, mesh)
        got, aux = moe.apply(p, spec, x)
    assert torch.equal(got, want)
    assert float(aux) == pytest.approx(float(waux), rel=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_moe_spec_matches_jax(arch):
    for cfg, jcfg in ((configs.get_config(arch),
                       jconfigs.get_config(arch)),
                      (configs.get_config(arch).reduced(),
                       jconfigs.get_config(arch).reduced())):
        assert dataclasses.asdict(blocks.moe_spec(cfg)) == \
            dataclasses.asdict(jblocks.moe_spec(jcfg))


# ---------------------------------------------------------------------------
# the reference's unit properties (tests/test_blocks_units.py), on the port

def _own(spec_kw, seed=0):
    _, spec = _specs(**{"capacity_factor": 4.0, **spec_kw})
    gen = torch.Generator().manual_seed(seed)
    return spec, moe.init(gen, spec, dtype=torch.float32), gen


def test_moe_router_topk_and_renorm():
    spec, params, gen = _own({})
    x = torch.randn(10, 16, generator=gen)
    ids, w, aux, z = moe.route(params, spec, x)
    assert ids.shape == (10, 2) and w.shape == (10, 2)
    torch.testing.assert_close(w.sum(-1), torch.ones(10), atol=1e-5,
                               rtol=0)
    assert float(aux) > 0 and float(z) >= 0


def test_moe_full_capacity_equals_dense_mixture():
    """With no drops, MoE output == sum_k w_k * FFN_{e_k}(x) per token."""
    spec, params, gen = _own({"capacity_factor": 100.0})
    x = torch.randn(1, 6, 16, generator=gen)
    out, _ = moe._apply_dense(params, spec, x)
    ids, w, _, _ = moe.route(params, spec, x.reshape(-1, 16))

    def ffn(e, h):
        g = h @ params["w_gate"][e]
        u = h @ params["w_up"][e]
        return (torch.nn.functional.silu(g) * u) @ params["w_down"][e]

    for t in range(6):
        expected = sum(float(w[t, j]) * ffn(int(ids[t, j]), x[0, t])
                       for j in range(2))
        torch.testing.assert_close(out[0, t], expected, atol=1e-4, rtol=0)


def test_moe_capacity_drops_tokens():
    spec, params, gen = _own({"capacity_factor": 0.01})   # C = K
    x = torch.randn(1, 32, 16, generator=gen)
    out, _ = moe._apply_dense(params, spec, x)
    assert bool(torch.isfinite(out).all())
    # some token outputs must be exactly zero (fully dropped)
    assert float(out[0].norm(dim=-1).min()) == 0.0


def test_moe_aux_loss_uniform_router_is_one():
    """Switch aux loss == 1 under perfectly uniform routing (its minimum)."""
    spec, params, gen = _own({})
    params = dict(params, router=torch.zeros_like(params["router"]))
    _, _, aux, _ = moe.route(params, spec, torch.randn(64, 16,
                                                       generator=gen))
    assert 0.9 < float(aux) < 1.4


# ---------------------------------------------------------------------------
# per-worker gradients (torch.func.vmap of grad) through the dispatch

def test_per_worker_grads_match_jax_and_a_loop():
    """Reduced Granite (2 layers, 4 experts of top-2), m = 4 workers of 2
    sequences of 40 tokens: C = 40 a worker."""
    arch = "granite-moe-1b-a400m"
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      "cpu")
    kw = dict(vocab_size=cfg.vocab_size, seq_len=40, global_batch=8,
              num_workers=4, seed=0)
    jb = JTokenStream(**kw).batch(0)
    tb = TokenStream(**kw, device="cpu").batch(0)
    jg, jl = jrt.per_worker_grads(lambda p, b: jmodel.loss_fn(p, b, jcfg),
                                  jp, jb)
    # no op of the layer falls back to a per-sample loop under vmap
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tg, tl = trt.per_worker_grads(
                lambda p, b: model.loss_fn(p, b, cfg), tp, tb)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert not [str(w.message) for w in caught
                if "batching rule" in str(w.message)]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tg
        for entry in path:
            node = node[entry.key]
        want = np.asarray(leaf)
        err = float(np.abs(node.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (path, err)
    for i in range(4):
        gi = torch.func.grad(lambda p: model.loss_fn(
            p, {k: v[i] for k, v in tb.items()}, cfg))(tp)
        for a, b in zip(jax.tree.leaves(gi), jax.tree.leaves(
                jax.tree.map(lambda t: t[i], tg))):
            assert float((a - b).abs().max()) <= \
                1e-6 * float(a.abs().max())
